"""Convergence tracker: causal event-to-FIB tracing (the port's copy of
``holo_tpu.telemetry.convergence``).

Every topology-changing event is stamped with a causal ``event_id`` at its
origin (:func:`begin`) and rides it through the chain:

    origin                          convergence.begin(trigger)
      -> SPF-delay FSM + dispatch   pend_schedule / spf_run, note_dispatch
      -> RIB route ops              observe("rib")
      -> FIB install / FRR flip     fib_commit() -> observe("fib")

Each phase records a ``holo_convergence_seconds{trigger,phase}`` observation
with an OpenMetrics exemplar (the active span id when there is one, the event
id otherwise); the per-event causal **timeline** (origin, marks, the dispatch
sites with their span ids, the closing FIB commit) lands in the flight
recorder's ring when the event closes.

Dispatch attribution: the port's SPF and FRR dispatch sites call
:func:`note_dispatch` with the mode that served the computation (``device``,
``scalar`` or ``fallback``); an event a fallback served closes with
``phase="fallback"`` in place of ``"fib"``.

The critical-path ledger (:mod:`holo_tpu_torch.telemetry.critpath`) and the
SLO engine (:mod:`holo_tpu_torch.telemetry.slo`) hook in through
:func:`set_critpath_hook` and :func:`set_slo_hook`.

Off by default: disarmed, each seam costs one module-global ``None`` check.
:func:`configure` arms the tracker and installs the delivery hook of the
port's event loop (``holo_tpu_torch.utils.runtime``), which re-activates a
message's event ids on the actor that handles it: the port's OSPFv2
instance, RIB and storm (``spf/synth_storm.py``) carry their events through
it as ``holo_tpu``'s do, and so does the port's daemon
(``holo_tpu_torch.daemon``), whose ``[telemetry] convergence-events`` arms
this tracker on its loop clock.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from contextlib import contextmanager, nullcontext

from holo_tpu_torch import telemetry
from holo_tpu_torch.telemetry import flight

#: trigger classes (an open set; these are the documented ones)
TRIGGER_LSA = "lsa"  # OSPF LSA arrival/change
TRIGGER_LSP = "lsp"  # IS-IS LSP arrival/change
TRIGGER_BFD = "bfd"  # BFD session state change
TRIGGER_CARRIER = "carrier"  # interface operational/carrier change
TRIGGER_IFCONFIG = "ifconfig"  # interface/instance config change

#: phases observed on holo_convergence_seconds (origin -> phase end)
PHASE_SPF = "spf"  # SPF/route computation finished
PHASE_RIB = "rib"  # first RIB route operation applied
PHASE_FIB = "fib"  # first FIB commit (event complete)
PHASE_FALLBACK = "fallback"  # FIB commit served by a fallback

_CONV_SECONDS = telemetry.histogram(
    "holo_convergence_seconds",
    "Topology-event to FIB convergence latency, by causal phase",
    ("trigger", "phase"),
)
_CONV_EVENTS = telemetry.counter(
    "holo_convergence_events_total",
    "Causal convergence events, by trigger class and outcome",
    ("trigger", "outcome"),
)

#: per-event timeline entries kept before the tail is dropped
TIMELINE_LIMIT = 64

# The critical-path ledger: while armed, the event lifecycle (begin,
# spf-scheduled, phase observed, finish) is also stamped into its
# cross-thread waterfall.  Installed only by critpath.configure; the
# disarmed cost at every seam is this None check.  The ledger keeps its own
# clock (profiling.clock): the tracker's may be virtual.
_CP_HOOK = None


def set_critpath_hook(ledger) -> None:
    """Install/remove the critical-path ledger (``critpath.configure`` is
    the only caller); ``None`` disarms."""
    global _CP_HOOK
    _CP_HOOK = ledger


# The SLO engine: while armed, every fib_commit close also grades the
# event's end-cut latency.  Installed only by slo.configure; the clock is
# read only under a non-None hook.
_SLO_HOOK = None


def set_slo_hook(engine) -> None:
    """Install/remove the SLO engine (``slo.configure`` is the only
    caller); ``None`` disarms."""
    global _SLO_HOOK
    _SLO_HOOK = engine


class _Event:
    """One open causal event (mutated only under the tracker lock)."""

    __slots__ = ("eid", "trigger", "t0", "attrs", "observed", "dispatch", "fallback",
                 "timeline", "truncated")

    def __init__(self, eid: int, trigger: str, t0: float, attrs: dict):
        self.eid = eid
        self.trigger = trigger
        self.t0 = t0
        self.attrs = attrs
        self.observed: set[str] = set()
        self.dispatch: dict[str, str] = {}  # site -> device | scalar | fallback
        self.fallback = False
        self.timeline: list = []
        self.truncated = 0


class ConvergenceTracker:
    """Process-wide causal event tracker (module singleton via
    :func:`configure`).

    Open events live in a bounded insertion-ordered map: the oldest open
    event is closed as ``outcome="evicted"`` when a new one would exceed
    ``capacity``; completed timelines keep the most recent ``capacity``.
    """

    def __init__(self, capacity: int = 512, clock=time.monotonic):
        self.capacity = int(capacity)
        self._clock = clock
        self._lock = threading.Lock()
        self._next = 1
        self._open: "OrderedDict[int, _Event]" = OrderedDict()
        self._done: deque = deque(maxlen=self.capacity)
        self._tls = threading.local()
        self._completed = 0

    # -- context (thread-local active-event stack)

    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def current(self) -> tuple[int, ...]:
        st = getattr(self._tls, "stack", None)
        return st[-1] if st else ()

    @contextmanager
    def activation(self, eids: tuple[int, ...]):
        """Make ``eids`` the active causal context for the dynamic extent
        (nested activations stack; the dispatch pipeline's worker uses this
        to carry a ticket's events onto its thread)."""
        st = self._stack()
        st.append(tuple(eids))
        try:
            yield
        finally:
            st.pop()

    # -- recording

    def begin(self, trigger: str, **attrs) -> int:
        """Stamp a new causal event at its origin; returns its id."""
        t = self._clock()
        clean = {str(k): str(v) for k, v in sorted(attrs.items())}
        evicted: _Event | None = None
        with self._lock:
            eid = self._next
            self._next += 1
            ev = _Event(eid, str(trigger), t, clean)
            ev.timeline.append(("origin", 0.0, clean))
            self._open[eid] = ev
            if len(self._open) > self.capacity:
                _, evicted = self._open.popitem(last=False)
        cp = _CP_HOOK
        if cp is not None:
            cp.ev_begin(eid, str(trigger))
        if evicted is not None:
            self._finish(evicted, "evicted")
        _CONV_EVENTS.labels(trigger=trigger, outcome="begun").inc()
        return eid

    def _events(self, eids) -> list[_Event]:
        with self._lock:
            return [ev for e in eids if (ev := self._open.get(e)) is not None]

    def active_triggers(self) -> tuple[str, ...]:
        """Trigger names of the currently active causal events."""
        return tuple(ev.trigger for ev in self._events(self.current()))

    def _entry(self, ev: _Event, step: str, attrs: dict) -> None:
        """Append one timeline entry (the caller holds no lock)."""
        t = round(self._clock() - ev.t0, 9)
        with self._lock:
            if len(ev.timeline) >= TIMELINE_LIMIT:
                ev.truncated += 1
                return
            ev.timeline.append((step, t, attrs))

    def mark(self, step: str, eids=None, **attrs) -> None:
        """Timeline-only entry for the active (or given) events."""
        clean = {str(k): str(v) for k, v in sorted(attrs.items())}
        for ev in self._events(eids if eids is not None else self.current()):
            self._entry(ev, step, clean)

    def note_dispatch(self, site: str, mode: str) -> None:
        """Record which engine served a dispatch for the active events
        (``device`` / ``scalar`` / ``fallback``), joined to the profiling
        sub-spans by the enclosing dispatch span id."""
        eids = self.current()
        if not eids:
            return
        sid = telemetry.current_span_id()
        attrs = {"site": site, "mode": mode}
        if sid is not None:
            attrs["span_id"] = str(sid)
        for ev in self._events(eids):
            with self._lock:
                ev.dispatch[site] = mode
                if mode == "fallback":
                    ev.fallback = True
            self._entry(ev, "dispatch", attrs)

    def observe(self, phase: str, eids=None, **attrs) -> None:
        """Observe ``now - origin`` for each event that has not seen
        ``phase`` yet, with a span or event exemplar."""
        now = self._clock()
        clean = {str(k): str(v) for k, v in sorted(attrs.items())}
        sid = telemetry.current_span_id()
        for ev in self._events(eids if eids is not None else self.current()):
            with self._lock:
                if phase in ev.observed:
                    fresh = False
                else:
                    ev.observed.add(phase)
                    fresh = True
            if not fresh:
                continue
            cp = _CP_HOOK
            if cp is not None:
                cp.ev_phase(ev.eid, phase)
            exemplar = {"span_id": sid} if sid is not None else {"event_id": ev.eid}
            _CONV_SECONDS.labels(trigger=ev.trigger, phase=phase).observe(
                max(now - ev.t0, 0.0), exemplar=exemplar)
            self._entry(ev, phase, clean)

    def fib_commit(self, op: str = "install", eids=None, **attrs) -> None:
        """The FIB moment: observe the event-to-FIB total (phase ``fib``, or
        ``fallback`` when a fallback served the computation) and complete
        the event; its timeline is flushed to the flight recorder's ring."""
        to_close: list[_Event] = []
        use = eids if eids is not None else self.current()
        for ev in self._events(use):
            with self._lock:
                phase = PHASE_FALLBACK if ev.fallback else PHASE_FIB
            self.observe(phase, eids=(ev.eid,), op=op, **attrs)
            sl = _SLO_HOOK
            if sl is not None:
                # The end cut on the tracker's clock: the latency the
                # convergence histogram itself records.
                sl.note_endcut(ev.trigger, max(self._clock() - ev.t0, 0.0), ev.fallback)
            with self._lock:
                if self._open.pop(ev.eid, None) is not None:
                    to_close.append(ev)
        for ev in to_close:
            self._finish(ev, "converged")

    def sweep(self) -> int:
        """Close every still-open event (settle or shutdown) with no
        histogram observation; the timelines still flush.  Returns the
        count closed."""
        with self._lock:
            evs = list(self._open.values())
            self._open.clear()
        for ev in evs:
            self._finish(ev, "no-fib")
        return len(evs)

    def _finish(self, ev: _Event, outcome: str) -> None:
        with self._lock:
            record = {
                "eid": ev.eid,
                "trigger": ev.trigger,
                "outcome": outcome,
                "fallback": ev.fallback,
                "dispatch": dict(ev.dispatch),
                "timeline": list(ev.timeline),
                "truncated": ev.truncated,
            }
            self._done.append(record)
            self._completed += 1
        cp = _CP_HOOK
        if cp is not None:
            cp.ev_done(ev.eid, outcome, ev.fallback)
        _CONV_EVENTS.labels(trigger=ev.trigger, outcome=outcome).inc()
        # The ring entry outside our lock (the recorder locks its own ring);
        # a disarmed recorder makes this a no-op.
        flight.event("convergence", eid=ev.eid, trigger=ev.trigger, outcome=outcome,
                     fallback=ev.fallback,
                     phases=",".join(f"{s}@{t}" for s, t, _ in record["timeline"][:TIMELINE_LIMIT]))

    # -- queries

    def timelines(self) -> list[dict]:
        """Completed event records, oldest first."""
        with self._lock:
            return [dict(r) for r in self._done]

    def stats(self) -> dict:
        with self._lock:
            return {"open": len(self._open), "completed": self._completed,
                    "capacity": self.capacity}


# -- process-wide singleton + module-level seams ------------------------

_TRACKER: ConvergenceTracker | None = None


def _delivery_context(msg):
    """Event-loop delivery hook: re-establish the causal context of a
    message stamped with ``event_id`` (ibus envelopes, marshalled
    callbacks, storm-harness messages) for the handler's extent."""
    t = _TRACKER
    if t is None:
        return None
    eids = getattr(msg, "event_id", None)
    if not eids:
        return None
    if isinstance(eids, int):
        eids = (eids,)
    return t.activation(tuple(eids))


def configure(capacity: int = 0, clock=None) -> ConvergenceTracker | None:
    """Arm (``capacity`` > 0) or disarm (0) the process-wide tracker and
    (un)install the port's event-loop delivery hook.  Tests and the storm
    pass the loop clock for deterministic timelines."""
    global _TRACKER
    from holo_tpu_torch.utils import runtime as _runtime

    if capacity and int(capacity) > 0:
        _TRACKER = ConvergenceTracker(int(capacity), clock or time.monotonic)
        _runtime.set_delivery_context(_delivery_context)
    else:
        _TRACKER = None
        _runtime.set_delivery_context(None)
    return _TRACKER


def tracker() -> ConvergenceTracker | None:
    return _TRACKER


def enabled() -> bool:
    return _TRACKER is not None


def begin(trigger: str, **attrs) -> int | None:
    """Origin stamp (a no-op while disarmed)."""
    t = _TRACKER
    if t is None:
        return None
    return t.begin(trigger, **attrs)


def current() -> tuple[int, ...]:
    t = _TRACKER
    return t.current() if t is not None else ()


def active_triggers() -> tuple[str, ...]:
    t = _TRACKER
    return t.active_triggers() if t is not None else ()


def activation(eids):
    """Context manager activating ``eids`` (accepts None or empty)."""
    t = _TRACKER
    if t is None or not eids:
        return nullcontext()
    if isinstance(eids, int):
        eids = (eids,)
    return t.activation(tuple(eids))


def mark(step: str, eids=None, **attrs) -> None:
    t = _TRACKER
    if t is not None:
        t.mark(step, eids=eids, **attrs)


def note_dispatch(site: str, mode: str) -> None:
    t = _TRACKER
    if t is not None:
        t.note_dispatch(site, mode)


def observe(phase: str, eids=None, **attrs) -> None:
    t = _TRACKER
    if t is not None:
        t.observe(phase, eids=eids, **attrs)


def fib_commit(op: str = "install", eids=None, **attrs) -> None:
    t = _TRACKER
    if t is not None:
        t.fib_commit(op=op, eids=eids, **attrs)


def sweep() -> int:
    t = _TRACKER
    return t.sweep() if t is not None else 0


# -- protocol-instance helpers (the shared pend/drain contract) ---------

#: per-instance bound on causal ids pending on the next SPF run
PENDING_LIMIT = 256


def pend_schedule(pending: list, default_trigger: str, instance: str = "") -> None:
    """The SPF-schedule origin stamp: inherit the active causal ids or begin
    a fresh event of ``default_trigger`` class, then park the ids on
    ``pending`` (a bounded list) for the SPF run the delay FSM coalesces
    them into.  A no-op while disarmed."""
    t = _TRACKER
    if t is None:
        return
    eids = t.current()
    if not eids:
        eids = (t.begin(default_trigger, instance=instance),)
    for e in eids:
        if e not in pending and len(pending) < PENDING_LIMIT:
            pending.append(e)
    t.mark("spf-scheduled", eids=eids, instance=instance)
    cp = _CP_HOOK
    if cp is not None:
        for e in eids:
            cp.ev_sched(e)


@contextmanager
def spf_run(pending: list, instance: str = ""):
    """Drain ``pending`` into an active causal context around one SPF run
    and observe the ``spf`` phase on normal completion.  Yields the drained
    ids."""
    eids = tuple(pending)
    del pending[:]
    with activation(eids):
        yield eids
        if eids:
            observe(PHASE_SPF, eids=eids, instance=instance)
