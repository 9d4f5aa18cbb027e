"""The port's dispatch layer (``holo_tpu``'s ``pipeline``):

- :mod:`holo_tpu_torch.pipeline.dispatch`: the bounded dispatch queue and
  its worker, which runs the SPF and FRR dispatches in two phases (launch,
  finish), in order per delta chain with one entry in flight per chain,
  with what-if coalescing, the breaker-open skip, priority classes,
  shedding and the watchdog hooks;
- :mod:`holo_tpu_torch.pipeline.tuner`: the per-shape engine tuner.

Both are off until armed (``configure_process_pipeline``,
``configure_engine_tuner``); ``wrap_spf_backend`` and ``wrap_frr_engine``
then route the port's backends through the process pipeline.
"""

from holo_tpu_torch.pipeline.dispatch import (
    AsyncFrrEngine,
    AsyncSpfBackend,
    DispatchPipeline,
    LazyBackupTable,
    LazySpfResult,
    PipelineClosed,
    PipelineTicket,
    configure_process_pipeline,
    process_pipeline,
    reset_process_pipeline,
    wrap_frr_engine,
    wrap_spf_backend,
)
from holo_tpu_torch.pipeline.tuner import (
    ENGINES,
    MP_ENGINES,
    EngineTuner,
    active_tuner,
    bgp_shape_bucket,
    configure_engine_tuner,
    reset_engine_tuner,
    shape_bucket,
)

__all__ = [
    "AsyncFrrEngine",
    "AsyncSpfBackend",
    "DispatchPipeline",
    "ENGINES",
    "EngineTuner",
    "LazyBackupTable",
    "LazySpfResult",
    "MP_ENGINES",
    "PipelineClosed",
    "PipelineTicket",
    "active_tuner",
    "bgp_shape_bucket",
    "configure_engine_tuner",
    "configure_process_pipeline",
    "process_pipeline",
    "reset_engine_tuner",
    "reset_process_pipeline",
    "shape_bucket",
    "wrap_frr_engine",
    "wrap_spf_backend",
]
