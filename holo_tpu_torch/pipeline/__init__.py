"""The port's dispatch layer: the per-shape engine tuner (``holo_tpu``'s
``pipeline.tuner``).  The async dispatch pipeline is ROADMAP A3."""

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
    "ENGINES",
    "MP_ENGINES",
    "EngineTuner",
    "active_tuner",
    "bgp_shape_bucket",
    "configure_engine_tuner",
    "reset_engine_tuner",
    "shape_bucket",
]
