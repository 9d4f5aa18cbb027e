"""The port's convergence tracker against holo_tpu's on the CPU.

- the same scripted events (begin, activation, mark, dispatch notes, phase
  observations, FIB commits, a fallback, an eviction, a sweep, the SPF
  delay FSM's pend / drain) under one injected clock give equal completed
  timelines and stats in both packages;
- the port's dispatch sites note the path that served them: the backend's
  device path, the breaker's fallback (after the oracle's ``scalar``) and
  FRR; a pipelined dispatch notes on the caller's events from the worker;
- disarmed, every seam is a no-op that reads no clock.

Tolerance: exact equality.
"""

from __future__ import annotations

import pytest

from holo_tpu.spf import synth as jsynth
from holo_tpu.spf.backend import TpuSpfBackend
from holo_tpu.telemetry import convergence as jconv
from holo_tpu_torch.frr.manager import FrrEngine
from holo_tpu_torch.pipeline import AsyncSpfBackend, DispatchPipeline
from holo_tpu_torch.resilience import faults
from holo_tpu_torch.spf import synth as tsynth
from holo_tpu_torch.spf.backend import TorchSpfBackend
from holo_tpu_torch.telemetry import convergence, profiling


class _Clock:
    def __init__(self):
        self.t = 10.0

    def __call__(self):
        self.t += 0.125
        return self.t


@pytest.fixture(autouse=True)
def _disarm():
    yield
    convergence.configure(0)
    jconv.configure(0)


def _script(mod) -> tuple:
    """One event story through ``mod``'s tracker (capacity 3)."""
    tr = mod.configure(capacity=3, clock=_Clock())
    a = mod.begin("lsa", area="0.0.0.0", lsa=7)
    with mod.activation(a):
        assert mod.current() == (a,)
        assert mod.active_triggers() == ("lsa",)
        mod.mark("flood", peers=2)
        mod.note_dispatch("spf", "device")
        mod.observe(mod.PHASE_SPF)
        mod.observe(mod.PHASE_SPF)  # once a phase
        mod.observe(mod.PHASE_RIB, routes=3)
        mod.fib_commit(op="install")
    b = mod.begin("bfd")
    with mod.activation((b,)):
        mod.note_dispatch("spf", "scalar")
        mod.note_dispatch("spf", "fallback")
        mod.fib_commit(op="replace")
    pending: list = []
    mod.pend_schedule(pending, "carrier", instance="ospf-1")
    with mod.spf_run(pending, instance="ospf-1") as eids:
        drained = eids
        mod.fib_commit(eids=eids)
    converged = tr.timelines()
    for trig in ("lsp", "ifconfig", "lsa", "lsa"):  # the first is evicted at 4 open
        mod.begin(trig)
    evicted = tr.timelines()[-1]
    swept = mod.sweep()
    return converged, evicted, tr.timelines(), tr.stats(), len(drained), swept, pending


def test_tracker_script_matches_holo_tpu():
    got, want = _script(convergence), _script(jconv)
    assert got == want
    converged, evicted, done, stats, drained, swept, pending = got
    assert [r["outcome"] for r in converged] == ["converged"] * 3
    assert [r["fallback"] for r in converged] == [False, True, False]
    assert [s for s, _t, _a in converged[0]["timeline"]] == [
        "origin", "flood", "dispatch", "spf", "rib", "fib"]
    assert evicted["outcome"] == "evicted" and evicted["trigger"] == "lsp"
    assert [r["outcome"] for r in done] == ["no-fib"] * 3
    assert drained == 1 and swept == 3 and pending == []
    assert stats == {"open": 0, "completed": 7, "capacity": 3}


def _served(be_factory, topo, **kw) -> dict:
    convergence.configure(capacity=8, clock=_Clock())
    eid = convergence.begin("lsa")
    with convergence.activation(eid):
        be_factory().compute(topo, **kw)
        convergence.fib_commit()
    (rec,) = convergence.tracker().timelines()
    return rec


def test_dispatch_sites_note_their_path_as_holo_tpu():
    tt = tsynth.random_ospf_topology(16, 3, 8, seed=3)
    jt = jsynth.random_ospf_topology(16, 3, 8, seed=3)
    rec = _served(lambda: TorchSpfBackend(device="cpu"), tt)
    assert rec["dispatch"] == {"spf": "device"} and rec["fallback"] is False
    plan = faults.FaultPlan(dispatch_fail={"spf.dispatch": 1})
    with faults.inject(plan):
        rec = _served(lambda: TorchSpfBackend(device="cpu"), tt)
    steps = [(s, a.get("mode")) for s, _t, a in rec["timeline"]]
    # holo_tpu's backend under the same fault: the oracle's note, then the
    # sticky fallback, and the event closes under the fallback phase.
    from holo_tpu.resilience import faults as jfaults

    jconv.configure(capacity=8, clock=_Clock())
    e = jconv.begin("lsa")
    with jfaults.inject(jfaults.FaultPlan(dispatch_fail={"spf.dispatch": 1})), \
            jconv.activation(e):
        TpuSpfBackend().compute(jt)
        jconv.fib_commit()
    (jrec,) = jconv.tracker().timelines()
    assert steps == [(s, a.get("mode")) for s, _t, a in jrec["timeline"]]
    assert steps == [("origin", None), ("dispatch", "scalar"), ("dispatch", "fallback"),
                     ("fallback", None)]
    assert rec["fallback"] is True
    rec = _served(lambda: FrrEngine("torch", device="cpu"), tt)
    assert rec["dispatch"] == {"frr": "device"}


def test_pipelined_dispatch_notes_on_the_callers_events():
    convergence.configure(capacity=8, clock=_Clock())
    tt = tsynth.random_ospf_topology(16, 3, 8, seed=4)
    pipe = DispatchPipeline(depth=2, name="conv-test")
    try:
        abe = AsyncSpfBackend(TorchSpfBackend(device="cpu"), pipe)
        eid = convergence.begin("lsa")
        with convergence.activation(eid):
            lazy = abe.compute(tt)
        lazy.wait()
        convergence.fib_commit(eids=(eid,))
    finally:
        pipe.close()
    (rec,) = convergence.tracker().timelines()
    assert rec["dispatch"] == {"spf": "device"} and rec["outcome"] == "converged"


def test_disarmed_seams_are_noops_that_read_no_clock(monkeypatch):
    assert convergence.tracker() is None

    def boom():
        raise AssertionError("a disarmed seam read a clock")

    monkeypatch.setattr(profiling, "clock", boom)
    assert convergence.begin("lsa") is None
    assert convergence.current() == () and convergence.active_triggers() == ()
    with convergence.activation(None), convergence.activation(7):
        pass
    convergence.mark("x")
    convergence.note_dispatch("spf", "device")
    convergence.observe("spf")
    convergence.fib_commit()
    pending: list = []
    convergence.pend_schedule(pending, "lsa")
    with convergence.spf_run(pending) as eids:
        assert eids == ()
    assert convergence.sweep() == 0 and pending == []
    assert convergence._CP_HOOK is None and convergence._SLO_HOOK is None
