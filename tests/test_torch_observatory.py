"""The port's dispatch observatory and flight recorder against holo_tpu's on
the CPU.

- sketches: the same values (zeros and negatives included, from a numpy
  seed) give byte-identical ``DDSketch.serialize()``, equal quantiles and
  equal merges in both packages;
- the observatory: one seeded workload through ``TpuSpfBackend`` on JAX-CPU
  and ``TorchSpfBackend(device="cpu")`` (``compute``, a masked ``compute``,
  ``multipath_k=4``, a 4-mask what-if, a 4-root multi-root, a 3-step
  DeltaPath chain) and one FRR compute, each under its own package's
  observatory and ``DeterministicTimer``, gives the same sketch keys, the same
  observation count per key and the same roofline verdict per cost bucket;
  the port's ``serialize()`` and ``report()`` are byte-identical across two
  runs of itself.  The numerators differ by design (XLA's cost analysis
  against the port's kernel work tallies);
- the cost source: every armed bucket's entry reaches ``record_cost``'s
  table and gauges, the observatory and an armed tuner's ``cost_prior``;
- the roofline join, the regression sentinel and the watchdog's budget from
  a site's p99, on injected observations (no wall clock anywhere);
- the flight recorder: the same events under one injected clock give equal
  scrubbed rings; a breaker opening writes one postmortem bundle;
- disarmed, a stage reads no timer and the dispatch context is the shared
  null context.

Tolerance: exact equality (bytes, counts, quantiles).
"""

from __future__ import annotations

import json
import threading
import time

import numpy as np
import pytest

from holo_tpu.frr.manager import FrrEngine as JFrrEngine
from holo_tpu.resilience.watchdog import DispatchWatchdog as JWatchdog
from holo_tpu.spf import synth as jsynth
from holo_tpu.spf.backend import TpuSpfBackend
from holo_tpu.telemetry import flight as jflight
from holo_tpu.telemetry import observatory as jobs
from holo_tpu.telemetry import profiling as jprof
from holo_tpu_torch import telemetry
from holo_tpu_torch.frr.manager import FrrEngine
from holo_tpu_torch.pipeline import tuner as ttuner
from holo_tpu_torch.resilience.breaker import CircuitBreaker, CircuitOpen
from holo_tpu_torch.resilience.watchdog import DispatchWatchdog
from holo_tpu_torch.spf import synth as tsynth
from holo_tpu_torch.spf.backend import TorchSpfBackend
from holo_tpu_torch.telemetry import flight, observatory, profiling, prometheus
from holo_tpu_torch.telemetry.observatory import DDSketch, DeterministicTimer, Observatory
from test_torch_delta import _step


@pytest.fixture(autouse=True)
def _disarm():
    yield
    for obs, prof in ((observatory, profiling), (jobs, jprof)):
        obs.configure(enabled=False)
        prof.set_device_profiling(False)
        prof.set_stage_timer(None)
    flight.configure(entries=0)
    jflight.configure(entries=0)
    ttuner.reset_engine_tuner()


# -- sketches


def _values(seed: int) -> np.ndarray:
    """Durations with exact zeros, negatives (clamped to 0) and a wide
    log-normal body."""
    rng = np.random.default_rng(seed)
    v = rng.lognormal(-7.0, 2.5, 400)
    v[::17] = 0.0
    v[5::23] = -rng.random(len(v[5::23]))
    return v


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("max_bins", [512, 16])
def test_sketch_matches_holo_tpu(seed, max_bins):
    vals = _values(seed)
    half = len(vals) // 2
    t_a, j_a = DDSketch(0.01, max_bins), jobs.DDSketch(0.01, max_bins)
    t_b, j_b = DDSketch(0.01, max_bins), jobs.DDSketch(0.01, max_bins)
    for v in vals[:half]:
        t_a.observe(float(v))
        j_a.observe(float(v))
    for v in vals[half:]:
        t_b.observe(float(v))
        j_b.observe(float(v))
    for t, j in ((t_a, j_a), (t_b, j_b)):
        assert t.serialize() == j.serialize()
    qs = (0.0, 0.01, 0.25, 0.5, 0.9, 0.99, 1.0)
    t_a.merge(t_b)
    j_a.merge(j_b)
    assert t_a.serialize() == j_a.serialize()
    assert [t_a.quantile(q) for q in qs] == [j_a.quantile(q) for q in qs]
    back = DDSketch.from_doc(json.loads(t_a.serialize()), max_bins)
    assert back.serialize() == t_a.serialize()
    with pytest.raises(ValueError):
        t_a.merge(DDSketch(0.02))


# -- the observatory over one seeded workload


def _workload(side: str) -> None:
    """compute, a masked compute, multipath_k=4, a 4-mask what-if, a 4-root
    multi-root, a 3-step DeltaPath chain, one FRR compute."""
    tt = tsynth.random_ospf_topology(24, 4, 12, max_cost=6, seed=5)
    jt = jsynth.random_ospf_topology(24, 4, 12, max_cost=6, seed=5)
    topo = tt if side == "torch" else jt
    be = TorchSpfBackend(device="cpu") if side == "torch" else TpuSpfBackend()
    masks = tsynth.whatif_link_failure_masks(tt, 4, seed=6)
    be.compute(topo)
    be.compute(topo, masks[1])
    be.compute(topo, multipath_k=4)
    be.compute_whatif(topo, masks)
    be.compute_multiroot(topo, np.array([0, 3, 7, 11], np.int32))
    rng = np.random.default_rng(7)
    for _ in range(3):
        e = int(rng.integers(0, tt.n_edges))
        tt, jt, _, _ = _step(tt, jt, cost={e: int(rng.integers(1, 64))})
        be.compute(tt if side == "torch" else jt)
    ft = tsynth.random_ospf_topology(10, 3, seed=0)
    fj = jsynth.random_ospf_topology(10, 3, seed=0)
    if side == "torch":
        FrrEngine("torch", device="cpu").compute(ft)
    else:
        JFrrEngine("tpu").compute(fj)


def _quiesce(timeout: float = 20.0) -> None:
    """Wait (up to ``timeout`` in all) for the dispatch pipelines' worker
    threads that earlier tests left running.  A worker the watchdog abandoned
    mid-launch goes on once its hang is released (``tests/test_overload.py``'s
    storm does so at its end); its dispatch, landing while this workload's
    observatory is armed, adds a cost bucket of its own topology to that
    package's roofline."""
    deadline = time.monotonic() + timeout
    for t in threading.enumerate():
        if t.name.startswith("holo-pipeline-") and t is not threading.current_thread():
            t.join(max(0.0, deadline - time.monotonic()))


def _observed(side: str):
    mod, prof = (observatory, profiling) if side == "torch" else (jobs, jprof)
    obs = mod.configure(check_every=0)
    prof.set_stage_timer(mod.DeterministicTimer())
    try:
        _workload(side)
        return (obs.serialize(), json.dumps(obs.report(), sort_keys=True),
                {k: sk.count for k, sk in obs._sketches.items()},
                {(r["site"], r["engine"], r["kind"], str(r["bucket"])): r["verdict"]
                 for r in obs.roofline()},
                {(r["site"], r["engine"], r["kind"], str(r["bucket"])): (r["flops"], r["bytes"])
                 for r in obs.roofline()})
    finally:
        mod.configure(enabled=False)
        prof.set_stage_timer(None)


@pytest.fixture(scope="module")
def runs():
    _quiesce()
    return {"jax": _observed("jax"), "torch": _observed("torch"), "torch2": _observed("torch")}


def test_sketch_keys_and_counts_match_holo_tpu(runs):
    want, got = runs["jax"][2], runs["torch"][2]
    assert got == want
    assert {k[1] for k in got} == {"marshal", "delta", "device", "readback"}
    assert {k[0] for k in got} == {"spf.one", "spf.whatif", "spf.multiroot", "frr.batch"}


def test_roofline_verdicts_match_holo_tpu(runs):
    want, got = runs["jax"][3], runs["torch"][3]
    # On a mismatch, name each side's cost entries (the verdicts' numerators).
    assert got == want, {"jax": runs["jax"][4], "torch": runs["torch"][4]}
    assert ("spf.one", "incr", "delta", str(list(next(
        k[3] for k in runs["torch"][2] if k[4] == "delta")))) in got


def test_a_stray_dispatch_thread_is_waited_out_before_the_workload(runs):
    """The state that broke the verdicts' equality: a dispatch of another
    topology, on a pipeline worker thread still running when the workload
    arms holo_tpu's observatory, added its bucket to holo_tpu's roofline
    alone.  After ``_quiesce`` the workload's keys are its own."""
    topo = jsynth.random_ospf_topology(40, 5, 20, seed=13)

    def stray():
        time.sleep(0.3)
        TpuSpfBackend(64).compute(topo)

    t = threading.Thread(target=stray, name="holo-pipeline-stray", daemon=True)
    t.start()
    _quiesce()
    assert not t.is_alive()
    assert _observed("jax")[3] == runs["jax"][3]


def test_port_serialization_byte_identical_across_runs(runs):
    assert runs["torch"][0] == runs["torch2"][0]
    assert runs["torch"][1] == runs["torch2"][1]
    assert json.loads(runs["torch"][1])["timing"] == "deterministic"


# -- the cost source


def test_cost_entries_reach_the_table_the_observatory_and_the_tuner():
    obs = observatory.configure(check_every=0)
    profiling.clear_cost_table()
    topo = tsynth.random_ospf_topology(16, 3, 8, max_cost=5, seed=2)
    be = TorchSpfBackend(device="cpu")
    be.compute(topo)
    be.compute(topo)  # the same bucket and engine: no second entry
    assert [(site, sig[:2]) for site, sig in profiling.cost_table()] == [("spf.one",
                                                                        ("one", "seq"))]
    tuner = ttuner.configure_engine_tuner(explore_rounds=100)
    be = TorchSpfBackend(device="cpu")
    for _ in range(2):  # explores two engines
        be.compute(topo)
    be.compute_whatif(topo, tsynth.whatif_link_failure_masks(topo, 3, seed=1))
    table = {(site, *sig[:2]): e for (site, sig), e in profiling.cost_table().items()}
    assert set(table) == {("spf.one", "one", "seq"), ("spf.one", "one", "fused"),
                          ("spf.whatif", "whatif", "seq")}
    for entry in table.values():
        assert entry["flops"] > 0 and entry["bytes"] > 0
    costs = {(site, kind, engine): c for (site, engine, _b, kind), c in obs._costs.items()}
    assert costs == table
    # The tuner's priors, under its own buckets.
    priors = {(key[0], engine): c for key, st in tuner._table.items()
              for engine, c in st.cost.items()}
    assert priors == {(kind, engine): c for (_s, kind, engine), c in table.items()}
    text = prometheus.render_text(telemetry.registry())
    assert 'holo_profile_cost_flops{site="spf.one"}' in text
    assert 'holo_profile_cost_bytes{site="spf.whatif"}' in text


def test_partitioned_and_frr_dispatches_are_costed():
    """The partitioned and FRR dispatches give cost entries too (the
    partitioned one has no holo_tpu counterpart: XLA's capture skips it)."""
    obs = observatory.configure(check_every=0)
    TorchSpfBackend(device="cpu", partition_threshold=1).compute(
        tsynth.multiarea_topology(3, 5, 5, seed=3))
    FrrEngine("torch", device="cpu").compute(tsynth.grid_topology(5, 5, seed=3))
    sites = {(site, engine, kind) for site, engine, _b, kind in obs._costs}
    assert sites == {("spf.partitioned", "partitioned", "partitioned"),
                     ("frr.batch", "frr", "frr")}
    assert all(c["flops"] > 0 and c["bytes"] > 0 for c in obs._costs.values())


def test_disarmed_dispatch_records_no_cost():
    profiling.clear_cost_table()
    topo = tsynth.random_ospf_topology(12, 3, 6, seed=4)
    TorchSpfBackend(device="cpu").compute(topo)
    assert profiling.work_mark() is None
    assert profiling.cost_table() == {}


# -- the roofline join and the sentinel (injected observations)


def test_roofline_join_matches_holo_tpu():
    peaks = {"flops": 33.45e12, "bytes": 3.35e12, "name": "card"}
    got, want = Observatory(peaks=peaks, check_every=0), jobs.Observatory(peaks=peaks,
                                                                          check_every=0)
    key = ("spf.one", "device", "seq", ("b",), "one")
    for obs, mod in ((got, observatory), (want, jobs)):
        sk = obs._sketches.setdefault(key, mod.DDSketch())
        for v in _values(3)[:50]:
            sk.observe(abs(float(v)) + 1e-4)
        obs.note_cost("spf.one", "one", "seq", ("b",), {"flops": 3e6, "bytes": 1e7})
        obs.note_cost("spf.one", "one", "tropical", ("b",), {"flops": 9e8, "bytes": 1e7})
    assert got.roofline() == want.roofline()
    rows = {r["engine"]: r for r in got.roofline()}
    assert rows["seq"]["verdict"] == "memory-bound"
    assert rows["tropical"]["verdict"] == "compute-bound"
    assert rows["seq"]["achieved_bytes_per_sec"] == pytest.approx(1e7 / rows["seq"]["device_p50_s"])


def test_sentinel_seeds_flags_and_ratchets_as_holo_tpu(tmp_path):
    key = ("spf.one", "device", "seq", "-", "one")
    out = {}
    for name, mod in (("torch", observatory), ("jax", jobs)):
        obs = mod.Observatory(check_every=0, ledger_path=tmp_path / f"{name}.json")
        sk = mod.DDSketch()
        for _ in range(20):
            sk.observe(0.010)
        obs._sentinel_check(key, sk)  # seeds
        slow = mod.DDSketch()
        for _ in range(20):
            slow.observe(0.050)
        obs._sentinel_check(key, slow)  # flags once
        obs._sentinel_check(key, slow)  # latched: no second flag
        fast = mod.DDSketch()
        for _ in range(20):
            fast.observe(0.001)
        obs._sentinel_check(key, fast)  # back under, ratchets
        obs.checkpoint()
        out[name] = (obs.sentinel() | {"path": None},
                     json.loads((tmp_path / f"{name}.json").read_text()))
    assert out["torch"] == out["jax"]
    # p50 and p99 each flag once, then ratchet.
    assert out["torch"][0]["flags"] == 2 and out["torch"][0]["seeded"] == 1
    assert out["torch"][0]["ratcheted"] == 2


def test_watchdog_budget_from_the_site_p99_matches_holo_tpu():
    class _Pipe:
        name = "p"

    vals = [abs(float(v)) for v in _values(4)]
    budgets = {}
    for name, mod, wd in (("torch", observatory, DispatchWatchdog(_Pipe(), floor=0.001)),
                          ("jax", jobs, JWatchdog(_Pipe(), floor=0.001))):
        obs = mod.configure(check_every=0)
        for stage, scale in (("marshal", 1.0), ("device", 3.0)):
            key = ("spf.one", stage, "seq", "-", "one")
            sk = obs._sketches.setdefault(key, mod.DDSketch())
            for v in vals:
                sk.observe(v * scale)
        budgets[name] = (wd.budget("spf.one"), wd.budget("frr.batch"))
        mod.configure(enabled=False)
    assert budgets["torch"] == budgets["jax"]
    p99 = max(sk.quantile(0.99) for sk in (_sk(vals, 1.0), _sk(vals, 3.0)))
    assert budgets["torch"][0] == max(p99 * 4.0, 0.001)
    # Cold site or no observatory: the port's fixed values serve.
    assert budgets["torch"][1] == 0.001
    wd = DispatchWatchdog(_Pipe(), floor=2.0, budgets={"spf.one": 0.5})
    assert wd.budget("spf.one") == 0.5 and wd.budget("x") == 2.0


def _sk(vals, scale) -> DDSketch:
    sk = DDSketch()
    for v in vals:
        sk.observe(v * scale)
    return sk


# -- the flight recorder


class _Clock:
    def __init__(self):
        self.t = 50.0

    def __call__(self):
        self.t += 0.25
        return self.t


def _flight_events(mod) -> list:
    rec = mod.configure(entries=16, clock=_Clock())
    mod.event("breaker", breaker="spf-dispatch#3", to="open")
    mod.journal_mark(7, "ospf")
    mod.event("pipeline-shed", pipeline="p", dispatch="whatif", cls="advisory",
              reason="capacity", obj="<x at 0x7f00aa>")
    for i in range(8):
        mod.event("tick", n=i)
    ring = rec.snapshot_ring()
    mod.configure(entries=0)
    return ring


def test_flight_ring_matches_holo_tpu():
    got, want = _flight_events(flight), _flight_events(jflight)
    assert got == want
    assert len(got) == 11
    assert got[0][2]["breaker"] == "spf-dispatch" and got[2][2]["obj"] == "<x at 0x?>"


def test_breaker_open_writes_one_postmortem(tmp_path):
    rec = flight.configure(entries=64, postmortem_dir=tmp_path, clock=_Clock())
    br = CircuitBreaker("pm-test", failure_threshold=2)

    def boom():
        raise RuntimeError("device lost")

    for _ in range(2):
        with pytest.raises(RuntimeError):
            br.call(boom, None, "spf.one")
    with pytest.raises(CircuitOpen):
        br.call(boom, None, "spf.one")
    files = sorted(tmp_path.glob("postmortem-*.json"))
    assert [f.name for f in files] == ["postmortem-001-breaker-open-pm-test.json"]
    bundle = json.loads(files[0].read_text())
    assert bundle["schema"] == "holo-postmortem/1"
    assert bundle["health"]["breakers"]["pm-test"]["state"] == "open"
    kinds = [e[1] for e in bundle["ring"] if e[0] == "event"]
    assert kinds == ["breaker", "postmortem-trigger"]
    assert rec.stats()["dumps"] == 1
    # A repeat within the debounce window lands in the ring only.
    assert flight.trigger("breaker-open:pm-test") is None
    assert rec.stats()["dumps"] == 1


# -- the disarmed contract


def test_disarmed_stage_reads_no_timer_and_shares_the_null_context():
    assert observatory.active() is None and not profiling.observing()

    def boom():
        raise AssertionError("a disarmed stage read the timer")

    profiling.set_stage_timer(boom)
    try:
        with profiling.stage("x.y", "marshal"):
            pass
    finally:
        profiling.set_stage_timer(None)
    assert profiling.dispatch_context(kind="one") is profiling.dispatch_context(kind="whatif")
    observatory.note_cost("s", "k", "e", "-", {"flops": 1.0, "bytes": 1.0})  # a no-op
    flight.event("x", a=1)
    assert flight.recorder() is None and flight.trigger("x") is None
