"""The port's SLO engine against holo_tpu's on the CPU.

- objectives: the same declarations validate and parse alike;
- one seeded ``note_*`` sequence (end cuts by trigger, fallbacks, canary
  end cuts and probes, served and shed tickets by class, relay flips), each
  note at an explicit time on an injected clock, gives equal ``report()``
  and ``stats()`` documents, sentinel fires included, in both packages;
- the burn and budget arithmetic by hand;
- the seams: the convergence tracker's ``fib_commit`` grades the end cut;
  the dispatch pipeline's served and shed tickets grade the delivery
  objective; a checkpoint seeds ``slo.<objective>`` rows in the
  observatory's ledger;
- disarmed, no seam reads a clock.

Tolerance: exact equality.
"""

from __future__ import annotations

import numpy as np
import pytest

from holo_tpu.telemetry import slo as jslo
from holo_tpu_torch.pipeline.dispatch import DispatchPipeline
from holo_tpu_torch.telemetry import convergence, observatory, profiling, slo
from holo_tpu_torch.telemetry.slo import Objective, SloEngine


@pytest.fixture(autouse=True)
def _disarm():
    yield
    slo.configure(False)
    convergence.configure(0)
    observatory.configure(enabled=False)


class _Now:
    """An injected clock the test sets before each note."""

    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self):
        return self.t


@pytest.mark.parametrize("raw", [
    {"name": "a", "kind": "latency", "threshold-ms": 250, "target": 0.99},
    {"name": "b", "kind": "delivery", "source": "background"},
    {"name": "c", "kind": "availability", "source": "relay", "quantile": 0.95},
])
def test_objectives_parse_as_holo_tpu(raw):
    assert vars(Objective.from_config(raw)) == vars(jslo.Objective.from_config(raw))


@pytest.mark.parametrize("kw", [
    {"kind": "nope"}, {"target": 1.0}, {"quantile": 0.0}, {"threshold_s": 0.0},
])
def test_objective_validation_as_holo_tpu(kw):
    with pytest.raises(ValueError) as got:
        Objective("x", **kw)
    with pytest.raises(ValueError) as want:
        jslo.Objective("x", **kw)
    assert str(got.value) == str(want.value)


def _drive(mod, seed: int) -> tuple:
    """One seeded note sequence at explicit times through ``mod``'s engine
    (tight windows and burn limits, so the sentinels latch and re-arm)."""
    now = _Now(1000.0)
    objs = (*mod.default_objectives(),
            mod.Objective("lsa-fast", "latency", "lsa", 0.99, 0.05, 0.9))
    eng = mod.SloEngine(objectives=objs, clock=now, fast_window=60.0, slow_window=600.0,
                        fast_burn=2.0, slow_burn=1.5, check_every=4)
    rng = np.random.default_rng(seed)
    for _ in range(300):
        now.t += float(rng.exponential(3.0))
        roll = rng.random()
        if roll < 0.45:
            trig = ("lsa", "bfd", "lsp", "canary")[int(rng.integers(0, 4))]
            eng.note_endcut(trig, float(rng.lognormal(-3.0, 1.2)), bool(rng.random() < 0.1))
        elif roll < 0.55:
            eng.note_probe(bool(rng.random() < 0.9),
                           None if rng.random() < 0.2 else float(rng.lognormal(-2.0, 1.0)))
        elif roll < 0.75:
            eng.note_served(("background", "advisory", "correctness")[int(rng.integers(0, 3))])
        elif roll < 0.9:
            eng.note_shed(("background", "advisory")[int(rng.integers(0, 2))],
                          ("capacity", "expired")[int(rng.integers(0, 2))])
        else:
            eng.note_relay(bool(rng.random() < 0.6))
        if rng.random() < 0.02:
            eng.checkpoint()
    return eng.report(), eng.stats()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reports_match_holo_tpu(seed):
    got, want = _drive(slo, seed), _drive(jslo, seed)
    assert got == want
    rows = {r["objective"]: r for r in got[0]["objectives"]}
    assert rows["lsa-fast"]["sentinel_fires_fast"] >= 1
    assert rows["background-delivery"]["bad_slow"] > 0 and got[0]["sheds"]


def test_burn_and_budget_by_hand():
    now = _Now(1000.0)
    eng = SloEngine(objectives=(Objective("o", "latency", "*", 0.99, 1.0, 0.9),), clock=now,
                    fast_window=60.0, slow_window=600.0, check_every=0)
    for _ in range(19):
        eng.note_endcut("lsa", 0.5, False)
    eng.note_endcut("lsa", 2.0, False)
    st = eng.objective("o")
    assert eng._bad_frac(st, now.t, 60.0) == (pytest.approx(0.05), 19, 1)
    assert eng.burn(st, now.t, 60.0) == pytest.approx(0.5)  # 0.05 / (1 - 0.9)
    assert eng.budget_remaining(st, now.t) == pytest.approx(0.5)
    now.t += 10_000.0
    assert eng.burn(st, now.t, 60.0) is None
    with pytest.raises(ValueError):
        SloEngine(objectives=(Objective("o"), Objective("o")))
    with pytest.raises(ValueError):
        SloEngine(fast_window=60.0, slow_window=30.0)


def test_fib_commit_grades_the_end_cut():
    now = _Now(5.0)
    convergence.configure(16, clock=now)
    eng = slo.configure(objectives=(Objective("t", "latency", "*", 0.99, 1.0, 0.9),),
                        clock=now, check_every=0)
    for latency in (0.25, 3.0):
        eid = convergence.begin("lsa")
        now.t += latency
        convergence.fib_commit(eids=(eid,))
    row = eng.report()["objectives"][0]
    assert (row["good_fast"], row["bad_fast"], row["events"]) == (1, 1, 2)
    assert row["measured_ms"]["p50"] == pytest.approx(250.0, rel=0.02)


def test_pipeline_served_and_shed_tickets_grade_delivery():
    eng = slo.configure(clock=_Now(100.0), check_every=0)
    pipe = DispatchPipeline(depth=1, capacity=1, name="slo-shed")
    try:
        with pipe._cv:  # the worker waits: the queue fills
            tickets = [pipe.submit(f"k{i}", "whatif", run=lambda: "v", cls="background")
                       for i in range(3)]
        assert pipe.drain(30.0)
        results = [t.result() for t in tickets]
    finally:
        pipe.close()
    assert results == [None, None, "v"] and [t.shed for t in tickets] == ["capacity",
                                                                            "capacity", None]
    row = next(r for r in eng.report()["objectives"] if r["objective"] == "background-delivery")
    assert (row["good_fast"], row["bad_fast"]) == (1, 2)
    assert eng.report()["sheds"] == {"background/capacity": 2}


def test_checkpoint_seeds_observatory_ledger_rows():
    obs = observatory.configure(check_every=0)
    eng = slo.configure(clock=_Now(1.0), check_every=0)
    eng.note_endcut("lsa", 0.2, False)
    eng.checkpoint()
    assert "slo.trigger-fib/latency|-|-|-" in obs._ledger


def test_disarmed_seams_read_no_clock(monkeypatch):
    assert slo.active() is None

    def boom():
        raise AssertionError("a disarmed SLO seam read the clock")

    monkeypatch.setattr(profiling, "clock", boom)
    slo.note_probe(True, 0.01)
    slo.note_served("background")
    slo.note_shed("background", "expired")
    slo.note_relay(True)
    assert convergence._SLO_HOOK is None
    pipe = DispatchPipeline(depth=2, name="slo-off")
    try:
        assert pipe.submit("k", "spf", run=lambda: "v", cls="background").result(30.0) == "v"
    finally:
        pipe.close()
