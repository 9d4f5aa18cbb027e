"""The port's critical-path ledger against holo_tpu's on the CPU.

- the cut model: random stamp sets (any subset, in or out of order) give the
  same phase vectors and verdicts in both packages, every phase
  non-negative and the vector summing to the wall;
- one scripted sequence, ``convergence.begin`` -> a dispatch through each
  package's ``AsyncSpfBackend`` -> ``fib_commit``, under each package's
  ``DeterministicTimer``, with a counted fault delay on one event (the
  delay advances the timer, nothing sleeps), gives the same verdict counts
  and the same phase sketch keys; the delayed event books its delay to
  ``device`` and is device-bound;
- an ordering stall (two dispatches of one key) books to ``queue_wait``;
- a fallback-served event relabels to ``fallback``;
- the port's report is byte-identical across two runs;
- disarmed, every seam is one global check and reads no clock.

Tolerance: exact equality (phase vectors compared as floats of the same
stamps).
"""

from __future__ import annotations

import json
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from holo_tpu.pipeline import dispatch as jdispatch
from holo_tpu.resilience import faults as jfaults
from holo_tpu.spf import synth as jsynth
from holo_tpu.spf.backend import TpuSpfBackend
from holo_tpu.telemetry import convergence as jconv
from holo_tpu.telemetry import critpath as jcp
from holo_tpu.telemetry import observatory as jobs
from holo_tpu.telemetry import profiling as jprof
from holo_tpu_torch.pipeline import dispatch as tdispatch
from holo_tpu_torch.resilience import faults as tfaults
from holo_tpu_torch.spf import synth as tsynth
from holo_tpu_torch.spf.backend import TorchSpfBackend
from holo_tpu_torch.telemetry import convergence, critpath, observatory, profiling
from holo_tpu_torch.telemetry.critpath import PHASES, CritPathLedger, _decompose, _Rec, _verdict

_STAMPS = ("sched", "enqueue", "launch0", "marshal0", "marshal1", "device_end", "force0",
           "force1", "spf", "rib", "t_end")

PKGS = {
    "torch": SimpleNamespace(conv=convergence, cp=critpath, obs=observatory, prof=profiling,
                             faults=tfaults, dispatch=tdispatch, synth=tsynth,
                             backend=lambda: TorchSpfBackend(device="cpu")),
    "jax": SimpleNamespace(conv=jconv, cp=jcp, obs=jobs, prof=jprof, faults=jfaults,
                           dispatch=jdispatch, synth=jsynth, backend=TpuSpfBackend),
}


@pytest.fixture(autouse=True)
def _disarm():
    yield
    for p in PKGS.values():
        p.cp.configure(0)
        p.conv.configure(0)
        p.obs.configure(enabled=False)
        p.prof.set_stage_timer(None)


@pytest.mark.parametrize("seed", [0, 1])
def test_cut_model_matches_holo_tpu_fuzzed(seed):
    rng = np.random.default_rng(seed)
    for _ in range(500):
        t0 = float(rng.uniform(0.0, 2.0))
        recs = (_Rec("lsa", t0), jcp._Rec("lsa", t0))
        for stamp in _STAMPS:
            if rng.random() < 0.7:
                v = float(rng.uniform(0.0, 10.0))
                for r in recs:
                    setattr(r, stamp, v)
        t_done = max(float(rng.uniform(0.0, 10.0)), t0)
        fallback = bool(rng.random() < 0.3)
        got = _decompose(recs[0], t_done, fallback)
        assert got == jcp._decompose(recs[1], t_done, fallback)
        assert _verdict(got) == jcp._verdict(got)
        assert set(got) == set(PHASES) and min(got.values()) >= 0.0
        assert abs(sum(got.values()) - (t_done - t0)) < 1e-9
        if fallback:
            assert got["device"] == 0.0


def test_cut_model_edges():
    assert _decompose(_Rec("bfd", 1.0), 3.0, False)["unattributed"] == 2.0
    rec = _Rec("lsa", 0.0)
    rec.sched, rec.marshal0, rec.marshal1, rec.t_end = 0.1, 0.5, 0.6, 0.7
    phases = _decompose(rec, 0.7, False)  # no pipeline: the hold is coalescing
    assert phases["coalesce_wait"] == pytest.approx(0.4) and phases["queue_wait"] == 0.0
    zero = dict.fromkeys(PHASES, 0.0)
    assert _verdict(zero) == "host"
    assert _verdict(dict(zero, queue_wait=1.0)) == "queue"
    assert _verdict(dict(zero, device=1.0, queue_wait=0.5)) == "device"


class _Shim:
    """The faults module's ``time`` with a ``sleep`` that advances the
    deterministic timer instead of sleeping: a counted delay."""

    def __init__(self, timer):
        self._timer = timer

    def sleep(self, seconds):
        self._timer.t += seconds

    def __getattr__(self, name):
        return getattr(time, name)


DELAY_S = 0.05  # 500 quanta of the DeterministicTimer


def _scripted(side: str, monkeypatch) -> tuple:
    """Three events, each one pipelined compute() of its own topology; the
    second delayed at spf.dispatch (device), the third's route derivation
    delayed on the caller (host).  The caller drains the pipeline before it
    forces, so every stamp of a dispatch is the worker's, in order."""
    p = PKGS[side]
    timer = p.obs.DeterministicTimer()
    p.prof.set_stage_timer(timer)
    monkeypatch.setattr(p.faults, "time", _Shim(timer))
    p.obs.configure(check_every=0)
    p.conv.configure(64, clock=timer)
    cp = p.cp.configure(check_every=0)
    pipe = p.dispatch.DispatchPipeline(depth=2, name=f"cp-{side}")
    try:
        abe = p.dispatch.AsyncSpfBackend(p.backend(), pipe)
        for i, delay in enumerate((0.0, DELAY_S, 0.0)):
            topo = p.synth.random_ospf_topology(16, 3, 8, max_cost=5, seed=20 + i)
            plan = p.faults.FaultPlan(dispatch_delay={"spf.dispatch": delay} if delay else {})
            eid = p.conv.begin("lsa")
            with p.faults.inject(plan), p.conv.activation(eid):
                lazy = abe.compute(topo)
                assert pipe.drain(30.0)
                lazy.wait()
            if i == 2:
                timer.t += DELAY_S  # host work before the first route op
            p.conv.observe(p.conv.PHASE_SPF, eids=(eid,))
            p.conv.observe(p.conv.PHASE_RIB, eids=(eid,))
            p.conv.fib_commit(eids=(eid,))
    finally:
        pipe.close()
    return cp.stats()["verdicts"], set(cp._sketches), cp.waterfalls(), cp.report()


def test_scripted_verdicts_and_phase_keys_match_holo_tpu(monkeypatch):
    got = _scripted("torch", monkeypatch)
    want = _scripted("jax", monkeypatch)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[0] == {"host": 1, "queue": 0, "device": 2}
    clean, slow, host = got[2]
    assert slow["verdict"] == "device" and host["verdict"] == "host"
    assert slow["phases"]["device"] >= clean["phases"]["device"] + DELAY_S - 1e-9
    assert host["phases"]["rib"] >= DELAY_S
    for w in got[2]:
        assert abs(sum(w["phases"].values()) - w["wall"]) < 1e-9
        assert w["engine"] == "seq" and w["kind"] == "one"


def test_port_report_byte_identical_across_runs(monkeypatch):
    a = json.dumps(_scripted("torch", monkeypatch)[3], sort_keys=True)
    b = json.dumps(_scripted("torch", monkeypatch)[3], sort_keys=True)
    assert a == b


def test_ordering_stall_books_to_queue_wait():
    """Two dispatches of one key, submitted while the worker is held off:
    the second is skipped once while the first is in flight (a stall) and
    its wait books to queue_wait."""
    profiling.set_stage_timer(observatory.DeterministicTimer())
    convergence.configure(64)
    cp = critpath.configure(check_every=0)
    pipe = tdispatch.DispatchPipeline(depth=2, name="cp-stall")
    gate = threading.Event()
    try:
        with pipe._cv:  # the worker starts, and waits for the lock
            e1 = convergence.begin("lsa")
            with convergence.activation(e1):
                t1 = pipe.submit("k", "spf", launch=lambda: "h",
                                 finish=lambda h: gate.wait(30.0) and "v1")
            e2 = convergence.begin("lsa")
            with convergence.activation(e2):
                t2 = pipe.submit("k", "spf", run=lambda: "v2")
        gate.set()
        assert pipe.drain(30.0)
        assert (t1.result(), t2.result()) == ("v1", "v2")
        for e in (e1, e2):
            convergence.fib_commit(eids=(e,))
    finally:
        gate.set()
        pipe.close()
    w1, w2 = cp.waterfalls()
    assert (w1["stalls"], w2["stalls"]) == (0, 1)
    assert w2["phases"]["queue_wait"] > 0.0
    assert abs(sum(w2["phases"].values()) - w2["wall"]) < 1e-9


def test_fallback_served_event_relabels_to_fallback():
    profiling.set_stage_timer(observatory.DeterministicTimer())
    convergence.configure(64)
    cp = critpath.configure(check_every=0)
    topo = tsynth.random_ospf_topology(16, 3, 8, seed=3)
    eid = convergence.begin("lsa")
    with tfaults.inject(tfaults.FaultPlan(dispatch_fail={"spf.dispatch": 1})), \
            convergence.activation(eid):
        TorchSpfBackend(device="cpu").compute(topo)
        convergence.observe(convergence.PHASE_SPF)
        convergence.fib_commit()
    (w,) = cp.waterfalls()
    assert w["fallback"] is True and w["phases"]["device"] == 0.0
    assert w["phases"]["fallback"] > 0.0
    assert abs(sum(w["phases"].values()) - w["wall"]) < 1e-9


def test_disarmed_seams_are_one_global_check(monkeypatch):
    assert critpath.active() is None

    def boom():
        raise AssertionError("a disarmed seam read the clock")

    monkeypatch.setattr(profiling, "clock", boom)
    critpath.note_enqueue((1, 2))
    critpath.note_launch((1,), "b")
    critpath.note_finish((1,), "e")
    critpath.note_force((1,), "b")
    critpath.note_stall((1,))
    critpath.note_shed((1,))
    assert profiling._PHASE_HOOK is None and convergence._CP_HOOK is None
    with profiling.stage("x.y", "marshal"):
        pass


def test_configure_installs_and_removes_the_hooks_and_bounds_records():
    cp = critpath.configure(check_every=0)
    assert profiling._PHASE_HOOK is not None and convergence._CP_HOOK is cp
    critpath.configure(0)
    assert profiling._PHASE_HOOK is None and convergence._CP_HOOK is None
    led = CritPathLedger(capacity=4, check_every=0)
    for eid in range(8):
        led.ev_begin(eid, "lsa")
    assert set(led._recs) == {4, 5, 6, 7} and led.stats()["dropped"] == 4
