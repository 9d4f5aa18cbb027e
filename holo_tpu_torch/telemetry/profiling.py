"""Per-dispatch stage timing (``holo_tpu.telemetry.profiling`` on the card).

Each dispatch of the port splits into the phases that matter for the
incremental-SPF work, under ``holo_tpu``'s site and stage names:

- **marshal** (or **delta** for a DeltaPath dispatch, **solve** on the
  partitioned path): the graph lookup, marshal or in-place update, and the
  uploads;
- **device**: the device program's time, from **CUDA events**: one
  recorded on the dispatch's stream before its first launch
  (:func:`device_clock`) and one after its last (:func:`sync`).  Their
  ``elapsed_time`` is read once the readback has waited (:func:`settle`), so
  arming adds no host sync.  The stage keeps its host wall in its sub-span:
  the program's launches and per-round flag reads on a one-phase dispatch,
  the wait on the host copies in a split dispatch's finish (the port's
  fixpoints run to their end in the launch).  On the CPU there are no events
  and the stage observes its host wall;
- **readback**: the device-to-host copies and the result's host planes.

Each phase records a nested trace sub-span and a
``holo_profile_stage_seconds{site,stage,device}`` observation whose
OpenMetrics exemplar ``{span_id=...}`` links the bucket to the sub-span;
``device="-"`` is the whole dispatch, ``device=<index>`` a shard of a mesh
dispatch (:func:`device_stages`).  While armed, each stage is also a
``torch.profiler.record_function`` range (:func:`annotation`), so the stages
land in ``torch.profiler`` timelines beside the kernels.

Everything is off by default (:func:`set_device_profiling`).  Disarmed,
:func:`stage` costs one module-global check, no CUDA event is recorded and
:func:`sync` does nothing.  The observer and phase hooks
(:func:`set_observer`, :func:`set_phase_hook`) are warn-only, as in
``holo_tpu``: a hook that raises never fails the dispatch it times, while an
error of the dispatch itself propagates through the stage unchanged.

``holo_tpu``'s ``record_cost`` / ``cost_table`` and the
``holo_profile_cost_*`` gauges read XLA's compile-time cost analysis, which
has no torch counterpart; the observatory's roofline join is their reader,
and they come with it.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from contextlib import contextmanager, nullcontext

from holo_tpu_torch import telemetry

log = logging.getLogger("holo_tpu_torch.telemetry")

_STAGE_SECONDS = telemetry.histogram(
    "holo_profile_stage_seconds",
    "Per-dispatch sub-span time (marshal / device / readback); "
    "device=<id> rows are the per-device completion split of a "
    "mesh-sharded dispatch ('-' = host-side / whole-dispatch span)",
    ("site", "stage", "device"),
)

_enabled = False
# The stage observer (a dispatch observatory) and the stage-edge hook (a
# critical-path waterfall): one module global each, the disarmed cost is the
# None check.
_OBSERVER = None
_PHASE_HOOK = None
_timer = time.perf_counter
_ctx_local = threading.local()
_NULLCTX = nullcontext()
# CUDA events this module recorded in the process: a disarmed dispatch adds
# none (chip_smoke reads the count).
_EVENT_RECORDS = [0]
# (site, device, device seconds, device-stage host wall, dispatch wall) of
# the last settled device stages, newest last.
_SETTLED: deque = deque(maxlen=4096)


def set_device_profiling(on: bool) -> None:
    """Arm/disarm the per-dispatch breakdown."""
    global _enabled
    _enabled = bool(on)


def device_profiling() -> bool:
    return _enabled


def set_observer(fn) -> None:
    """Install/remove the stage observer: ``fn(site, stage, device,
    seconds)`` runs after every completed stage observation (a device stage
    once its events are read); ``None`` disarms."""
    global _OBSERVER
    _OBSERVER = fn


def observing() -> bool:
    return _OBSERVER is not None


def set_phase_hook(fn) -> None:
    """Install/remove the stage-edge hook: ``fn(site, stage, device, edge)``
    at every stage begin (``'b'``) and clean-exit end (``'e'``)."""
    global _PHASE_HOOK
    _PHASE_HOOK = fn


def set_stage_timer(fn) -> None:
    """Swap the stage timer (``None`` restores ``time.perf_counter``): a
    deterministic timer makes two seeded runs byte-identical."""
    global _timer
    _timer = fn if fn is not None else time.perf_counter


def clock() -> float:
    """The stage timer.  Dispatch walls that feed the engine tuner read this,
    so a deterministic timer makes deterministic tuner decisions."""
    return _timer()


def dispatch_ctx() -> dict | None:
    """The active dispatch context (observer keying), or None."""
    return getattr(_ctx_local, "ctx", None)


@contextmanager
def _dispatch_context(kw: dict):
    prev = getattr(_ctx_local, "ctx", None)
    _ctx_local.ctx = kw
    try:
        yield
    finally:
        _ctx_local.ctx = prev


def dispatch_context(**kw):
    """Label the enclosed dispatch (kind, engine, shape bucket) for the
    observer; a shared null context while no observer is armed."""
    if _OBSERVER is None:
        return _NULLCTX
    return _dispatch_context(kw)


class DeviceClock:
    """The device phase of one dispatch, or of one shard of a mesh dispatch,
    on CUDA events: ``start`` recorded before the first launch
    (:func:`device_clock`), ``end`` by :func:`sync` after the last; both on
    the stream the launches run on.  The device stage (:func:`stage` with the
    clock) adds its host wall; on the CPU the events stay None and the phase
    is that wall.  A split dispatch carries the clock from its launch to its
    finish, across threads."""

    __slots__ = ("site", "device", "start", "end", "stream", "span_id", "host_s",
                 "settled")

    def __init__(self, site: str, device: str, stream=None):
        self.site = site
        self.device = device
        self.stream = stream
        self.start = self.end = None
        self.span_id = None
        self.host_s = None
        self.settled = False
        if stream is not None:
            self.start = _record(stream)

    def device_seconds(self) -> float | None:
        """The events' elapsed time (call once the readback has waited), else
        the stage's host wall."""
        if self.start is not None and self.end is not None:
            return self.start.elapsed_time(self.end) / 1e3
        return self.host_s


def _record(stream):
    import torch

    ev = torch.cuda.Event(enable_timing=True)
    ev.record(stream)
    _EVENT_RECORDS[0] += 1
    return ev


def _stream_of(on):
    """The current CUDA stream of torch device ``on``, or None (no device, or
    the CPU)."""
    if on is None:
        return None
    import torch

    on = torch.device(on)
    if on.type != "cuda":
        return None
    return torch.cuda.current_stream(on)


def device_clock(site: str, on=None, device: str = "-") -> DeviceClock | None:
    """Armed: the :class:`DeviceClock` of a dispatch's device phase, its
    start event recorded now on the current stream of ``on`` (the torch
    device the dispatch runs on; none on the CPU).  Disarmed: None, and no
    event.  Create it right before the dispatch's first launch."""
    if not _enabled:
        return None
    return DeviceClock(site, device, _stream_of(on))


@contextmanager
def stage(site: str, name: str, device: str = "-", clock=None):
    """One dispatch phase: a nested trace sub-span, a
    ``torch.profiler.record_function`` range and a
    ``holo_profile_stage_seconds`` observation whose exemplar links the
    bucket to the sub-span.  ``site`` is the dispatch site (``spf.one``,
    ``spf.whatif``, ``frr.batch``, ...), ``name`` the phase, ``device`` the
    shard label of a mesh dispatch ('-' = whole dispatch).

    With a ``clock`` (:func:`device_clock`; the device phase) the stage
    hands its sub-span id and host wall to the clock, and the observation
    waits for :func:`settle`, which reads the clock's events after the
    readback.  Otherwise it observes its host wall at exit.  Observations
    are made on a clean exit only.  Disarmed it yields None (an armed
    observer still gets the host wall)."""
    obs = _OBSERVER
    ph = _PHASE_HOOK
    if ph is not None:
        _phase_guarded(ph, site, name, device, "b")
    if not _enabled:
        if obs is None:
            yield None
        else:
            t0 = _timer()
            yield None
            _observe_guarded(obs, site, name, device, _timer() - t0)
        if ph is not None:
            _phase_guarded(ph, site, name, device, "e")
        return
    t0 = _timer()
    with telemetry.span(f"{site}.{name}", stage=name, device=device) as sid, \
            annotation(f"{site}.{name}"):
        yield sid
    dt = _timer() - t0
    if isinstance(clock, DeviceClock):
        clock.span_id, clock.host_s = sid, dt
    else:
        _STAGE_SECONDS.labels(site=site, stage=name, device=device).observe(
            dt, exemplar={"span_id": sid})
        if obs is not None:
            _observe_guarded(obs, site, name, device, dt)
    if ph is not None:
        _phase_guarded(ph, site, name, device, "e")


def sync(clock) -> None:
    """Close a device stage's event window: record its end event after the
    dispatch's last launch.  It never blocks.  A no-op for ``None`` (the
    stage was disarmed: no event, no sync) and on the CPU."""
    if isinstance(clock, DeviceClock) and clock.stream is not None and clock.end is None:
        clock.end = _record(clock.stream)


def settle(clock, wall: float | None = None) -> float | None:
    """Observe a device stage once the dispatch's readback has waited: the
    events' elapsed time (no sync: both have completed), or the host wall on
    the CPU.  ``wall`` is the whole dispatch's wall, kept beside it in
    :func:`settled` (chip_smoke holds each device time to it).  Returns the
    observed seconds; None for a disarmed stage."""
    if not isinstance(clock, DeviceClock) or clock.settled or clock.host_s is None:
        return None
    clock.settled = True
    dt = clock.device_seconds()
    _STAGE_SECONDS.labels(site=clock.site, stage="device", device=clock.device).observe(
        dt, exemplar={"span_id": clock.span_id})
    _SETTLED.append((clock.site, clock.device, dt, clock.host_s, wall))
    obs = _OBSERVER
    if obs is not None:
        _observe_guarded(obs, clock.site, "device", clock.device, dt)
    return dt


def device_stages(site: str, clocks) -> bool:
    """Settle the per-shard device stages of a mesh dispatch: one
    ``device=<index>`` row per shard, from that shard's own events (the
    shards' ``stage(site, "device", device=<index>)`` windows).  The port's
    mesh runs its shards one after another on the caller's thread, so each
    row is that shard's own device time, where ``holo_tpu``'s rows after the
    first are the residual skew past the earlier devices.  False, recording
    nothing, when disarmed or with fewer than two shards."""
    clocks = [c for c in clocks if isinstance(c, DeviceClock)]
    if not _enabled or len(clocks) < 2:
        return False
    for c in clocks:
        settle(c)
    return True


def settled() -> list:
    """The last settled device stages, oldest first: (site, device, device
    seconds, stage host wall, dispatch wall)."""
    return list(_SETTLED)


def event_records() -> int:
    """CUDA events this module has recorded in the process."""
    return _EVENT_RECORDS[0]


def annotation(name: str):
    """A ``torch.profiler.record_function`` range while armed (the phases
    then appear in ``torch.profiler`` timelines), a null context otherwise."""
    if not _enabled:
        return _NULLCTX
    import torch

    return torch.profiler.record_function(name)


def _observe_guarded(obs, site, name, device, dt) -> None:
    """An observer is warn-only by contract: its failure never reaches the
    dispatch, where the breaker would count it as a device failure."""
    try:
        obs(site, name, device, dt)
    except Exception:  # noqa: BLE001 -- see the contract above
        log.debug("stage observer failed", exc_info=True)


def _phase_guarded(ph, site, name, device, edge) -> None:
    """The same warn-only contract for the stage-edge hook."""
    try:
        ph(site, name, device, edge)
    except Exception:  # noqa: BLE001 -- see the contract above
        log.debug("stage phase hook failed", exc_info=True)


def stage_median(site: str, stage: str, device: str = "-") -> float | None:
    """Approximate median of ``holo_profile_stage_seconds{site,stage}``: the
    upper boundary of the bucket that holds the median (a <= 2x
    overestimate on the log-spaced ladder).  None with no observations.
    The engine tuner's fallback for a shape bucket with no samples."""
    child = _STAGE_SECONDS.labels(site=site, stage=stage, device=device)
    total = child.count
    if not total:
        return None
    half = (total + 1) // 2
    for le, cum in child.cumulative():
        if cum >= half:
            return float(le)
    return None


def capture_device_trace(trace_dir, n_routers: int = 48, seed: int = 3) -> dict:
    """One ``torch.profiler`` trace (CPU and CUDA activities) of a warm seeded
    ``TorchSpfBackend().compute()`` on the card, with profiling armed, as a
    chrome trace ``trace.json`` in ``trace_dir``.  With no CUDA device it
    returns an explicit row, never a CPU trace."""
    from pathlib import Path

    import torch

    row: dict = {"captured": False, "trace_dir": str(trace_dir)}
    if not torch.cuda.is_available():
        row["reason"] = "no CUDA device"
        return row
    from holo_tpu_torch.spf.backend import TorchSpfBackend
    from holo_tpu_torch.spf.synth import random_ospf_topology

    topo = random_ospf_topology(n_routers=n_routers, n_networks=max(n_routers // 8, 4),
                                extra_p2p=max(n_routers // 2, 16), seed=seed)
    backend = TorchSpfBackend(incremental=False)
    backend.compute(topo)  # warm: the kernel library and the marshal outside
    out = Path(trace_dir)
    out.mkdir(parents=True, exist_ok=True)
    was = _enabled
    set_device_profiling(True)
    try:
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            backend.compute(topo)
        torch.cuda.synchronize()
    finally:
        set_device_profiling(was)
    path = out / "trace.json"
    prof.export_chrome_trace(str(path))
    row.update(captured=True, platform="cuda", device=torch.cuda.get_device_name(0),
               n_vertices=int(topo.n_vertices), path=str(path),
               files=sum(1 for p in out.rglob("*") if p.is_file()))
    return row
