"""Critical-path ledger: cross-thread trigger-to-FIB waterfalls (the port's
copy of ``holo_tpu.telemetry.critpath``).

The convergence tracker measures the trigger-to-FIB path end to end and the
dispatch observatory the device slice; this ledger says which phase owns
each millisecond between them.  It joins the per-event causal ids of
:mod:`holo_tpu_torch.telemetry.convergence`, the profiling stages (marshal /
device / readback) of :mod:`holo_tpu_torch.telemetry.profiling` and the
dispatch pipeline's queue stamps (enqueue, launch, finish, force wait,
per-key ordering stalls) into one waterfall per event, then splits every
completed event into a gap-free phase vector whose sum is the event's wall
by construction.

The cut model
-------------
Stamps are reads of :func:`profiling.clock` (``time.perf_counter``, or the
observatory's ``DeterministicTimer``).  Per event they become an ordered
sequence of cuts, each clamped monotonically into ``[t_begin, t_end]``;
phases are the differences of consecutive cuts, so they telescope to the
wall exactly:

    begin --wake--> spf-scheduled --coalesce_wait--> enqueue
      --queue_wait--> marshal-begin --marshal--> marshal-end
      --device--> device-end --force_wait--> force-end
      --rib--> spf-observed --rib--> rib-observed
      --fib_commit--> fib/fallback-observed
      --unattributed--> event-closed

A missing stamp collapses its phase to zero: a dispatch outside the
pipeline has no enqueue or force stamps, so ``coalesce_wait`` absorbs the
hold before the marshal and ``queue_wait`` / ``force_wait`` read zero.  When
a fallback served the event, the device segment and the derivation slice
become ``fallback``.  The residual no stamp explains is reported as
``unattributed``, never hidden.

Aggregation and verdicts
------------------------
Per-phase walls stream into DDSketches keyed ``(trigger, phase, engine,
shape bucket, kind)`` (the engine and bucket come from
:func:`profiling.dispatch_ctx`, as the observatory's do).  Every event gets a
**bound verdict**: ``host``, ``queue`` or ``device``, the largest share
wins, ties break host > queue > device.  With an observatory armed, every
``check_every`` completions the phase sketches run through its regression
sentinel under ``critpath.<trigger>/<phase>|...`` ledger keys.

Off by default; disarmed, every seam costs one module-global ``None``
check.  No locks on the dispatch thread: records are plain objects mutated
under the GIL.
"""

from __future__ import annotations

import logging
from collections import deque

from holo_tpu_torch import telemetry
from holo_tpu_torch.telemetry import convergence, profiling
from holo_tpu_torch.telemetry.observatory import DDSketch

log = logging.getLogger("holo_tpu_torch.telemetry")

#: the exhaustive phase vector, in cut order (``fallback`` is the relabel of
#: device + route derivation under a fallback verdict)
PHASES = ("wake", "coalesce_wait", "queue_wait", "marshal", "device", "force_wait", "rib",
          "fib_commit", "unattributed", "fallback")
#: the verdict partition (host > queue > device on ties)
HOST_PHASES = ("wake", "coalesce_wait", "marshal", "rib", "fib_commit", "unattributed")
QUEUE_PHASES = ("queue_wait", "force_wait")
DEVICE_PHASES = ("device", "fallback")

#: profiling stage names folded into the marshal / device cuts (``delta``
#: is the in-place incremental update, host marshal work; ``solve`` the
#: partitioned solve, device work)
_MARSHAL_STAGES = frozenset(("marshal", "delta"))
_DEVICE_STAGES = frozenset(("device", "readback", "solve"))

_VERDICTS = telemetry.counter(
    "holo_critpath_verdicts_total",
    "Completed trigger→FIB events by critical-path bound verdict",
    ("verdict",),
)
_OPEN = telemetry.gauge(
    "holo_critpath_open_events",
    "Causal events with an open critical-path record",
    stamped=False,
)
_SKETCHES_G = telemetry.gauge(
    "holo_critpath_sketches",
    "Live (trigger, phase, engine, shape-bucket, kind) phase sketches",
    stamped=False,
)


class _Rec:
    """One open event's stamp set.  Each field is written by one logical
    stage of the event's life; a racing duplicate stamp resolves min- or
    max-wards."""

    __slots__ = ("trigger", "t0", "sched", "enqueue", "launch0", "marshal0", "marshal1",
                 "device_end", "force0", "force1", "spf", "rib", "t_end", "stalls", "engine",
                 "kind", "bucket")

    def __init__(self, trigger: str, t0: float):
        self.trigger = trigger
        self.t0 = t0
        self.sched = None
        self.enqueue = None
        self.launch0 = None
        self.marshal0 = None
        self.marshal1 = None
        self.device_end = None
        self.force0 = None
        self.force1 = None
        self.spf = None
        self.rib = None
        self.t_end = None
        self.stalls = 0
        self.engine = "-"
        self.kind = "-"
        self.bucket = "-"


def _decompose(rec: _Rec, t_done: float, fallback: bool) -> dict:
    """The cut model: clamped-monotone cuts to a telescoping phase dict.
    Every cut is forced into ``[previous cut, t_done]``, so the phases are
    non-negative and sum to ``t_done - t0`` exactly."""
    mb = rec.marshal0 if rec.marshal0 is not None else rec.launch0
    cuts = (
        ("wake", rec.sched),
        # No pipeline: no enqueue stamp, and the hold before the marshal is
        # the SPF delay FSM coalescing triggers.
        ("coalesce_wait", rec.enqueue if rec.enqueue is not None else mb),
        ("queue_wait", mb),
        ("marshal", rec.marshal1),
        ("device", rec.device_end),
        ("force_wait", rec.force1),
        # rib spans both slices of the RIB sync: route derivation from the
        # ready result (-> spf-observed) and publish + apply (-> rib).
        ("rib", rec.spf),
        ("rib", rec.rib),
        ("fib_commit", rec.t_end),
        # The closing segment past the last stamp.
        ("unattributed", t_done),
    )
    prev = rec.t0
    phases = dict.fromkeys(PHASES, 0.0)
    derive = 0.0  # the -> spf-observed slice (the fallback relabel below)
    for i, (name, c) in enumerate(cuts):
        c = prev if c is None else min(max(c, prev), t_done)
        phases[name] += c - prev
        if i == 6:  # the first rib slice: route derivation
            derive = c - prev
        prev = c
    if fallback:
        phases["fallback"] = phases["device"] + derive
        phases["device"] = 0.0
        phases["rib"] -= derive
    return phases


def _verdict(phases: dict) -> str:
    host = sum(phases[p] for p in HOST_PHASES)
    queue = sum(phases[p] for p in QUEUE_PHASES)
    device = sum(phases[p] for p in DEVICE_PHASES)
    if host >= queue and host >= device:
        return "host"
    if queue >= device:
        return "queue"
    return "device"


class CritPathLedger:
    """Process-wide critical-path instrument (module singleton via
    :func:`configure`).  The hot path is the stamp methods, fed by the
    convergence, profiling and dispatch hooks."""

    def __init__(self, capacity: int = 1024, check_every: int = 64, alpha: float = 0.01,
                 max_bins: int = 512, waterfalls: int = 64):
        self.capacity = int(capacity)
        self.check_every = int(check_every)
        self.alpha = float(alpha)
        self.max_bins = int(max_bins)
        self._recs: dict[int, _Rec] = {}
        self._sketches: dict[tuple, DDSketch] = {}
        self._water: deque = deque(maxlen=int(waterfalls))
        self._verdicts = {"host": 0, "queue": 0, "device": 0}
        self._completed = 0
        self._dropped = 0
        self._sheds = 0

    # -- hot path: stamps ------------------------------------------------

    def ev_begin(self, eid: int, trigger: str) -> None:
        rec = _Rec(trigger, profiling.clock())
        self._recs[eid] = rec
        while len(self._recs) > self.capacity:
            try:
                self._recs.pop(next(iter(self._recs)))
                self._dropped += 1
            except (StopIteration, KeyError):  # a racing pop emptied it
                break

    def ev_sched(self, eid: int) -> None:
        rec = self._recs.get(eid)
        if rec is not None and rec.sched is None:
            rec.sched = profiling.clock()

    def ev_phase(self, eid: int, phase: str) -> None:
        rec = self._recs.get(eid)
        if rec is None:
            return
        now = profiling.clock()
        if phase == convergence.PHASE_SPF:
            if rec.spf is None:
                rec.spf = now
        elif phase == convergence.PHASE_RIB:
            if rec.rib is None:
                rec.rib = now
        elif rec.t_end is None:  # fib / fallback: the closing cut
            rec.t_end = now

    def ev_done(self, eid: int, outcome: str, fallback: bool) -> None:
        rec = self._recs.pop(eid, None)
        if rec is None:
            return
        if outcome != "converged":
            self._dropped += 1
            return
        # The wall is trigger -> fib-observed; the close-time read serves as
        # the end only when the fib stamp is missing.
        t_done = rec.t_end
        if t_done is None:
            t_done = profiling.clock()
        t_done = max(t_done, rec.t0)
        phases = _decompose(rec, t_done, fallback)
        verdict = _verdict(phases)
        self._verdicts[verdict] += 1
        _VERDICTS.labels(verdict=verdict).inc()
        key4 = (rec.trigger, rec.engine, rec.bucket, rec.kind)
        for phase in PHASES:
            self._sketch(phase, key4).observe(phases[phase])
        self._sketch("wall", key4).observe(t_done - rec.t0)
        self._water.append({
            "trigger": rec.trigger,
            "wall": round(t_done - rec.t0, 9),
            "phases": {p: round(phases[p], 9) for p in PHASES},
            "verdict": verdict,
            "engine": rec.engine,
            "kind": rec.kind,
            "bucket": rec.bucket,
            "stalls": rec.stalls,
            "fallback": bool(fallback),
        })
        self._completed += 1
        _OPEN.set(len(self._recs))
        if self.check_every and self._completed % self.check_every == 0:
            self._sentinel_pass()

    def _sketch(self, phase: str, key4: tuple) -> DDSketch:
        trigger, engine, bucket, kind = key4
        key = (trigger, phase, engine, bucket, kind)
        sk = self._sketches.get(key)
        if sk is None:
            sk = self._sketches.setdefault(key, DDSketch(self.alpha, self.max_bins))
        return sk

    def _on_stage(self, site: str, name: str, device: str, edge: str) -> None:
        """The profiling phase hook: every stage begin / end edge while
        armed.  ``device != "-"`` rows are the per-shard split of one
        already-stamped mesh dispatch."""
        if device != "-":
            return
        if name in _MARSHAL_STAGES:
            eids = convergence.current()
            if not eids:
                return
            now = profiling.clock()
            for eid in eids:
                rec = self._recs.get(eid)
                if rec is None:
                    continue
                if edge == "b":
                    if rec.marshal0 is None:
                        rec.marshal0 = now
                elif rec.marshal1 is None or now > rec.marshal1:
                    rec.marshal1 = now
        elif name in _DEVICE_STAGES:
            eids = convergence.current()
            if not eids:
                return
            now = profiling.clock()
            ctx = profiling.dispatch_ctx() if edge == "b" else None
            for eid in eids:
                rec = self._recs.get(eid)
                if rec is None:
                    continue
                if edge == "e":
                    if rec.device_end is None or now > rec.device_end:
                        rec.device_end = now
                elif ctx is not None and rec.engine == "-":
                    rec.engine = str(ctx.get("engine", "-"))
                    rec.kind = str(ctx.get("kind", "-"))
                    rec.bucket = ctx.get("bucket") or "-"

    # dispatch queue stamps (the module seams below fan in here)
    def note_enqueue(self, eids) -> None:
        now = profiling.clock()
        for eid in eids:
            rec = self._recs.get(eid)
            if rec is not None and rec.enqueue is None:
                rec.enqueue = now

    def note_launch(self, eids, edge: str) -> None:
        if edge != "b":
            return
        now = profiling.clock()
        for eid in eids:
            rec = self._recs.get(eid)
            if rec is not None and rec.launch0 is None:
                rec.launch0 = now

    def note_finish(self, eids, edge: str) -> None:
        if edge != "e":
            return
        now = profiling.clock()
        for eid in eids:
            rec = self._recs.get(eid)
            if rec is not None and (rec.device_end is None or now > rec.device_end):
                rec.device_end = now

    def note_force(self, eids, edge: str) -> None:
        now = profiling.clock()
        for eid in eids:
            rec = self._recs.get(eid)
            if rec is None:
                continue
            if edge == "b":
                if rec.force0 is None:
                    rec.force0 = now
            elif rec.force1 is None or now > rec.force1:
                rec.force1 = now

    def note_stall(self, eids) -> None:
        for eid in eids:
            rec = self._recs.get(eid)
            if rec is not None:
                rec.stalls += 1

    def note_shed(self, eids) -> None:
        """An overload shed: the dispatch never ran, so the open records are
        discarded rather than decomposed, and the shed counts on its own
        line (``sheds``, not ``dropped``)."""
        self._sheds += 1
        for eid in eids:
            self._recs.pop(eid, None)

    # -- the sentinel (the dispatch observatory's) -----------------------

    def _sentinel_pass(self) -> None:
        from holo_tpu_torch.telemetry import observatory

        obs = observatory.active()
        if obs is None:
            return
        for (trigger, phase, engine, bucket, kind), sk in list(self._sketches.items()):
            if phase == "wall" or not sk.count:
                continue
            try:
                obs._sentinel_check((f"critpath.{trigger}", phase, engine, bucket, kind), sk)
            except Exception:  # noqa: BLE001 -- warn-only: never into fib_commit
                log.debug("critpath sentinel pass failed", exc_info=True)
        _SKETCHES_G.set(len(self._sketches))

    def checkpoint(self) -> None:
        """One sentinel pass now."""
        self._sentinel_pass()

    # -- cold reporting --------------------------------------------------

    def _merged_phase(self, phase: str) -> DDSketch:
        out = DDSketch(self.alpha, self.max_bins)
        for (_t, p, _e, _b, _k), sk in list(self._sketches.items()):
            if p == phase and sk.count:
                out.merge(sk)
        return out

    def phase_quantiles(self) -> dict:
        """{phase: {p50, p99, mean}} merged across all sketch keys (and the
        ``wall`` pseudo-phase), rounded canonically."""
        out = {}
        for phase in (*PHASES, "wall"):
            sk = self._merged_phase(phase)
            if not sk.count:
                continue
            out[phase] = {"p50": round(sk.quantile(0.5), 9), "p99": round(sk.quantile(0.99), 9),
                          "mean": round(sk.total / sk.count, 9)}
        return out

    def host_fraction_p99(self) -> float | None:
        """The sum of the host phases' p99 over the sum of all phases'."""
        q = self.phase_quantiles()
        total = sum(q[p]["p99"] for p in PHASES if p in q)
        if total <= 0.0:
            return None
        host = sum(q[p]["p99"] for p in HOST_PHASES if p in q)
        return round(host / total, 6)

    def unattributed_frac_p50(self) -> float | None:
        """The unattributed p50 as a fraction of the wall p50."""
        q = self.phase_quantiles()
        wall = q.get("wall")
        if not wall or wall["p50"] <= 0.0:
            return None
        un = q.get("unattributed", {"p50": 0.0})
        return round(un["p50"] / wall["p50"], 6)

    def waterfalls(self) -> list[dict]:
        """The most recent completed waterfalls, oldest first."""
        return [dict(w) for w in self._water]

    def stats(self) -> dict:
        out = {
            "open": len(self._recs),
            "completed": self._completed,
            "dropped": self._dropped,
            "sheds": self._sheds,
            "capacity": self.capacity,
            "sketches": len(self._sketches),
            "verdicts": dict(self._verdicts),
            "phases": self.phase_quantiles(),
        }
        hf = self.host_fraction_p99()
        if hf is not None:
            out["host-fraction-p99"] = hf
        uf = self.unattributed_frac_p50()
        if uf is not None:
            out["unattributed-frac-p50"] = uf
        return out

    def report(self, top: int = 8) -> dict:
        """The deterministic report document: the phase table in cut order,
        the verdict tally and the last ``top`` waterfalls, numbered by
        completion order within the report (raw event ids are process-wide
        counters)."""
        phases = self.phase_quantiles()
        rows = [{"phase": p, **phases[p]} for p in PHASES if p in phases]
        total_p99 = sum(r["p99"] for r in rows)
        for r in rows:
            r["share_p99"] = round(r["p99"] / total_p99, 6) if total_p99 > 0 else 0.0
        water = self.waterfalls()[-int(top):] if int(top) > 0 else []
        return {
            "completed": self._completed,
            "dropped": self._dropped,
            "sheds": self._sheds,
            "verdicts": dict(self._verdicts),
            "phases": rows,
            "wall": phases.get("wall"),
            "host-fraction-p99": self.host_fraction_p99(),
            "unattributed-frac-p50": self.unattributed_frac_p50(),
            "events": [{"n": i, **w} for i, w in enumerate(water)],
        }


# -- process-wide singleton + one-global-check seams ---------------------

_CP: CritPathLedger | None = None


def configure(capacity: int = 1024, check_every: int = 64,
              waterfalls: int = 64) -> CritPathLedger | None:
    """Arm (``capacity`` > 0) or disarm (0) the process-wide ledger and
    (un)install the convergence and profiling hooks.  It sees events only
    with a convergence tracker armed (the causal ids are the join key); the
    observatory is optional (without it only the sentinel pass is
    skipped)."""
    global _CP
    if capacity and int(capacity) > 0:
        _CP = CritPathLedger(int(capacity), check_every=check_every, waterfalls=waterfalls)
        profiling.set_phase_hook(_CP._on_stage)
        convergence.set_critpath_hook(_CP)
    else:
        _CP = None
        profiling.set_phase_hook(None)
        convergence.set_critpath_hook(None)
    return _CP


def active() -> CritPathLedger | None:
    return _CP


def enabled() -> bool:
    return _CP is not None


def note_enqueue(eids) -> None:
    """Dispatch-queue admission stamp (a no-op while disarmed)."""
    cp = _CP
    if cp is None or not eids:
        return
    cp.note_enqueue(eids)


def note_launch(eids, edge: str) -> None:
    """Worker launch begin / end stamp (``edge`` 'b' | 'e')."""
    cp = _CP
    if cp is None or not eids:
        return
    cp.note_launch(eids, edge)


def note_finish(eids, edge: str) -> None:
    """Worker finish begin / end stamp (``edge`` 'b' | 'e')."""
    cp = _CP
    if cp is None or not eids:
        return
    cp.note_finish(eids, edge)


def note_force(eids, edge: str) -> None:
    """Ticket result wait begin / end stamp."""
    cp = _CP
    if cp is None or not eids:
        return
    cp.note_force(eids, edge)


def note_stall(eids) -> None:
    """Per-key ordering stall: a launchable item skipped because an earlier
    generation of its key is still in flight."""
    cp = _CP
    if cp is None or not eids:
        return
    cp.note_stall(eids)


def note_shed(eids) -> None:
    """Overload shed disposition.  No ``eids`` gate: a ticket with no
    events still lands in the ledger's tally."""
    cp = _CP
    if cp is None:
        return
    cp.note_shed(eids)
