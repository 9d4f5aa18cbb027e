"""Deterministic fault injection at the dispatch seams (the port's copy of
the dispatch part of ``holo_tpu.resilience.faults``).

Every injection decision comes from a per-site random stream derived from
``(plan.seed, site)``, so a failing chaos run replays exactly.  The seams:

- ``crashpoint(site)`` raises :class:`InjectedFault` (forced counts in
  ``dispatch_fail``, or ``dispatch_fail_prob``): ``spf.dispatch``,
  ``frr.dispatch``, ``bgp.dispatch`` in the device paths, ``spf.shard`` and
  ``frr.shard`` in the dispatches a mesh serves (``parallel/mesh.py``) and
  ``pipeline.dispatch`` inside the pipeline's breaker guard;
- ``delaypoint(site)`` stalls a dispatch that still succeeds
  (``dispatch_delay``);
- ``hangpoint(site)`` wedges the pipeline worker inside a launch or finish
  phase (``dispatch_hang``) until the cap elapses or
  :meth:`FaultInjector.release_hangs`, for the watchdog;
- ``killpoint(site)`` raises outside any breaker guard (``worker_kill``),
  taking the pipeline worker thread down.

``holo_tpu``'s network, TCP, ibus, clock and actor seams (``FaultyNetIo``,
``_DelayedSendLoop``, drop, reset and partial-write probabilities) serve the
protocol actors, which the port does not carry, so they are not copied.
Each injection counts in ``holo_resilience_faults_injected_total{site}``
and in the injector's ``injected`` (site -> count).  With nothing armed each seam
costs one module-global ``None`` check.
"""

from __future__ import annotations

import hashlib
import random
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field

from holo_tpu_torch import telemetry

_INJECTED = telemetry.counter(
    "holo_resilience_faults_injected_total", "Faults injected by the chaos harness, by seam site",
    ("site",))


class InjectedFault(RuntimeError):
    """Raised by an armed crashpoint or killpoint (chaos testing only)."""


@dataclass
class FaultPlan:
    """One seeded chaos scenario.  ``dispatch_fail`` ({site: count}) burns
    down deterministically: ``{"spf.dispatch": 3}`` fails exactly the next
    three dispatches there.  ``dispatch_delay`` ({site: seconds}) stalls a
    dispatch that still succeeds; ``dispatch_hang`` ({site: max seconds})
    wedges the thread, one shot per site; ``worker_kill`` ({site: count})
    kills the traversing thread.  ``drop_prob`` is the share of wire
    arrivals the convergence storm (``spf/synth_storm.py``) loses and
    retransmits."""

    seed: int = 0
    drop_prob: float = 0.0
    dispatch_fail: dict = field(default_factory=dict)
    dispatch_fail_prob: float = 0.0
    dispatch_delay: dict = field(default_factory=dict)
    dispatch_hang: dict = field(default_factory=dict)
    worker_kill: dict = field(default_factory=dict)

    def rng(self, site: str) -> random.Random:
        """Independent deterministic stream for one seam site."""
        h = hashlib.sha256(f"{self.seed}:{site}".encode()).digest()
        return random.Random(int.from_bytes(h[:8], "big"))


class FaultInjector:
    """Applies one :class:`FaultPlan`; ``injected`` counts what fired."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.injected: dict[str, int] = {}
        self._rngs: dict[str, random.Random] = {}
        self._forced = dict(plan.dispatch_fail)
        self._hangs = dict(plan.dispatch_hang)  # site -> max seconds
        self._kills = dict(plan.worker_kill)  # site -> remaining count
        self._hang_release = threading.Event()
        self._lock = threading.Lock()  # seams fire from the worker and callers

    def _rng(self, site: str) -> random.Random:
        rng = self._rngs.get(site)
        if rng is None:
            rng = self._rngs[site] = self.plan.rng(site)
        return rng

    def _record(self, site: str) -> None:
        self.injected[site] = self.injected.get(site, 0) + 1
        _INJECTED.labels(site=site).inc()

    def crashpoint(self, site: str) -> None:
        with self._lock:
            n = self._forced.get(site, 0)
            if n > 0:
                self._forced[site] = n - 1
                self._record(site)
                raise InjectedFault(f"forced dispatch failure at {site}")
            p = self.plan.dispatch_fail_prob
            if p and self._rng(f"dispatch:{site}").random() < p:
                self._record(site)
                raise InjectedFault(f"random dispatch failure at {site}")

    def delaypoint(self, site: str) -> None:
        """Slow (never fail) the dispatch at ``site`` by the planned stall."""
        d = self.plan.dispatch_delay.get(site, 0.0)
        if d:
            with self._lock:
                self._record(f"delay:{site}")
            time.sleep(d)

    def hangpoint(self, site: str) -> None:
        """Wedge the calling thread at ``site`` for up to the planned seconds
        (or until :meth:`release_hangs`).  One shot per site: the respawned
        worker's next pass through the site runs clean."""
        with self._lock:
            d = self._hangs.pop(site, 0.0)
            if d:
                self._record(f"hang:{site}")
        if d:
            self._hang_release.wait(d)

    def release_hangs(self) -> None:
        """Free every thread wedged in a hangpoint (teardown helper)."""
        self._hang_release.set()

    def killpoint(self, site: str) -> None:
        """Raise through the calling thread's frame at ``site``, outside any
        breaker guard, so the pipeline worker itself dies."""
        with self._lock:
            n = self._kills.get(site, 0)
            if n > 0:
                self._kills[site] = n - 1
                self._record(f"kill:{site}")
                raise InjectedFault(f"forced worker kill at {site}")


_active: FaultInjector | None = None


def active() -> FaultInjector | None:
    return _active


def crashpoint(site: str) -> None:
    """Dispatch-failure seam: a no-op unless a plan is armed via inject()."""
    if _active is not None:
        _active.crashpoint(site)


def delaypoint(site: str) -> None:
    """Dispatch-stall seam: a no-op unless a plan is armed via inject()."""
    if _active is not None:
        _active.delaypoint(site)


def hangpoint(site: str) -> None:
    """Hung-dispatch seam: a no-op unless a plan is armed via inject()."""
    if _active is not None:
        _active.hangpoint(site)


def killpoint(site: str) -> None:
    """Worker-kill seam: a no-op unless a plan is armed via inject()."""
    if _active is not None:
        _active.killpoint(site)


@contextmanager
def inject(plan_or_injector):
    """Arm a plan (or a prebuilt injector) for the dynamic extent."""
    global _active
    inj = (plan_or_injector if isinstance(plan_or_injector, FaultInjector)
           else FaultInjector(plan_or_injector))
    prev = _active
    _active = inj
    try:
        yield inj
    finally:
        _active = prev
