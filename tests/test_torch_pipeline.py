"""The port's dispatch pipeline (``holo_tpu_torch.pipeline.dispatch``) against
``holo_tpu``'s, bit for bit (tolerance: exact equality everywhere; the
computation is integer-only).

- the queue contract of ``tests/test_pipeline.py``: per-key order, split
  phases overlapping across keys with one entry in flight per key,
  coalescing, the breaker-open skip, a bug re-raised at force time, a
  crashpoint mid-chain, the wrap helpers;
- parity: ``AsyncSpfBackend(TorchSpfBackend(device="cpu"))`` against
  ``holo_tpu``'s ``AsyncSpfBackend(TpuSpfBackend())`` on JAX-CPU and the
  scalar oracle on three seeded ``random_ospf_topology`` shapes, for the
  five ``one_engine`` formulations, ``multipath_k`` 1 and 4, a masked
  ``compute``, delta chains of 8 storm mutations submitted ahead, and
  ``max_iters`` None and 3 (a truncated run held to JAX's same engine);
  the same for ``launch_one`` / ``finish_one`` called directly, and for
  ``AsyncFrrEngine`` on a seeded topology and the OSPF backup flip;
- the card rule on the CPU: with ``max_iters`` set no fallback serves, so a
  failure in either phase re-raises at force time, counted, and an open
  circuit raises ``CircuitOpen``; with no cap the oracle serves;
- the shared graph cache and the kernel library's first build under
  concurrent threads.
"""

import threading
import time

import numpy as np
import pytest

from holo_tpu import pipeline as jpipeline
from holo_tpu.frr.manager import FrrEngine as JFrrEngine
from holo_tpu.ops import graph as jgraph
from holo_tpu.spf import synth as jsynth
from holo_tpu.spf.backend import ScalarSpfBackend as JScalar
from holo_tpu.spf.backend import TpuSpfBackend
from holo_tpu_torch import pipeline
from holo_tpu_torch.frr.kernel import TABLE_PLANES
from holo_tpu_torch.frr.manager import FrrEngine
from holo_tpu_torch.kernels import build
from holo_tpu_torch.ops import graph as tgraph
from holo_tpu_torch.ops import spf_engine as te
from holo_tpu_torch.pipeline.dispatch import (
    AsyncFrrEngine,
    AsyncSpfBackend,
    DispatchPipeline,
)
from holo_tpu_torch.resilience.breaker import CircuitBreaker, CircuitOpen
from holo_tpu_torch.resilience.faults import FaultInjector, FaultPlan, InjectedFault, inject
from holo_tpu_torch.spf import synth as tsynth
from holo_tpu_torch.spf.backend import ScalarSpfBackend, TorchSpfBackend
from test_torch_delta import _mutation

FIELDS = ("dist", "parent", "hops", "nexthop_words")
MP_FIELDS = ("parents", "pdist", "pweight", "npaths", "nh_weights")
KW = dict(n_routers=24, n_networks=6, extra_p2p=30)
SEEDS = (1, 2, 3)
ENGINES = ("seq", "fused", "packed", "hybrid", "tropical")
WAIT = 60.0  # every force carries a timeout


@pytest.fixture(autouse=True)
def _clean_process_state():
    yield
    pipeline.reset_process_pipeline()
    pipeline.reset_engine_tuner()


@pytest.fixture
def pipe():
    p = DispatchPipeline(depth=2)
    yield p
    p.close()


@pytest.fixture(scope="module")
def jax_ref():
    """(engine, max_iters) -> holo_tpu's pipelined backend, one per module
    (its jit caches are per instance), over one JAX pipeline."""
    jpipe = jpipeline.DispatchPipeline(depth=2, name="jax-reference")
    made = {}

    def get(engine="seq", max_iters=None):
        if (engine, max_iters) not in made:
            made[(engine, max_iters)] = jpipeline.AsyncSpfBackend(
                TpuSpfBackend(one_engine=engine, max_iters=max_iters), jpipe)
        return made[(engine, max_iters)]

    yield get
    jpipe.close()


def _force(lazy):
    return lazy._ticket.result(timeout=WAIT)


def _same(a, b, label, kp=1):
    for f in FIELDS + (MP_FIELDS if kp > 1 else ()):
        x, y = getattr(a, f), getattr(b, f)
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=f"{label} {f}")
        assert np.asarray(x).dtype == np.asarray(y).dtype, (label, f)


def _pair(seed):
    return tsynth.random_ospf_topology(seed=seed, **KW), jsynth.random_ospf_topology(seed=seed, **KW)


def _step(tt, jt, spec):
    """One mutation on both packages' topologies, each linked to its base."""
    tn, jn = tsynth.clone_topology(tt, **spec), jsynth.clone_topology(jt, **spec)
    td, jd = tgraph.diff_topologies(tt, tn), jgraph.diff_topologies(jt, jn)
    if td is not None:
        tn.link_delta(td)
        jn.link_delta(jd)
    return tn, jn


def _tstep(tt, spec):
    """One mutation on a port topology, linked to its base."""
    tn = tsynth.clone_topology(tt, **spec)
    td = tgraph.diff_topologies(tt, tn)
    if td is not None:
        tn.link_delta(td)
    return tn


def _calls(tt, seed):
    """(args, kwargs) of the held dispatches: plain, masked, multipath."""
    mask = tsynth.whatif_link_failure_masks(tt, 1, seed=seed + 10)[0]
    return [((), {}), ((mask,), {}), ((), {"multipath_k": 4})]


# -- parity with holo_tpu's pipelined path and the oracle


@pytest.mark.parametrize("max_iters", [None, 3])
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("engine", ENGINES)
def test_async_compute_matches_jax_pipeline_and_oracle(jax_ref, pipe, engine, seed, max_iters):
    tt, jt = _pair(seed)
    calls = _calls(tt, seed)
    inner = TorchSpfBackend(one_engine=engine, device="cpu", max_iters=max_iters)
    be = AsyncSpfBackend(inner, pipe)
    # Truncated runs differ by engine: each is held to JAX's own engine.
    jbe = jax_ref(engine if max_iters is not None else "seq", max_iters)
    got = [be.compute(tt, *a, **k) for a, k in calls]  # all submitted ahead
    want = [jbe.compute(jt, *a, **k) for a, k in calls]
    sync = TorchSpfBackend(one_engine=engine, device="cpu", max_iters=max_iters)
    for (a, k), g, w in zip(calls, got, want):
        kp = k.get("multipath_k", 1)
        label = f"{engine} {a and 'masked'} kp={kp}"
        g = _force(g)
        _same(g, _force(w), f"{label} jax", kp)
        _same(g, sync.compute(tt, *a, **k), f"{label} sync", kp)
        if max_iters is None:
            _same(g, ScalarSpfBackend().compute(tt, *a, **k), f"{label} oracle", kp)
            _same(g, JScalar().compute(jt, *a, **k), f"{label} jax oracle", kp)
    st = pipe.stats()
    assert st["max-inflight-per-key"] <= 1 and st["completed"] == len(calls)
    assert not inner.breaker.snapshot()["failures"]


@pytest.mark.parametrize("max_iters", [None, 3])
@pytest.mark.parametrize("engine", ENGINES)
def test_launch_finish_matches_jax_and_compute(jax_ref, engine, max_iters):
    tt, jt = _pair(1)  # the first parity shape: JAX's programs are compiled
    be = TorchSpfBackend(one_engine=engine, device="cpu", max_iters=max_iters)
    jbe = jax_ref(engine if max_iters is not None else "seq", max_iters).inner
    sync = TorchSpfBackend(one_engine=engine, device="cpu", max_iters=max_iters)
    for a, k in _calls(tt, 1):
        kp = k.get("multipath_k", 1)
        got = be.finish_one(be.launch_one(tt, *a, **k))
        _same(got, jbe.finish_one(jbe.launch_one(jt, *a, **k)), f"{engine} kp={kp} jax", kp)
        _same(got, sync.compute(tt, *a, **k), f"{engine} kp={kp} compute", kp)
        if max_iters is None:
            _same(got, ScalarSpfBackend().compute(tt, *a, **k), f"{engine} kp={kp} oracle", kp)
    # Two linked deltas, each launched after the previous finish.
    rng = np.random.default_rng(1)
    for i in range(2):
        spec = {"cost": {int(rng.integers(0, tt.n_edges)): int(rng.integers(1, 64))}}
        tt, jt = _step(tt, jt, spec)
        got = be.finish_one(be.launch_one(tt))
        _same(got, jbe.finish_one(jbe.launch_one(jt)), f"{engine} delta {i} jax")
        _same(got, sync.compute(tt), f"{engine} delta {i} compute")
    assert be.delta_paths[("weight", "incremental")] == 2


@pytest.mark.parametrize("engine,max_iters,kp", [
    ("seq", None, 1), ("seq", 3, 1), ("tropical", None, 1), ("seq", None, 4),
])
def test_async_delta_chain_matches_jax_pipeline_and_oracle(jax_ref, pipe, engine, max_iters, kp):
    """8 storm mutations submitted back to back: each delta launches only
    after the previous step's finish put its run back (one in flight per
    chain), and every step equals JAX's pipelined chain and the oracle."""
    tt, jt = _pair(7)
    inner = TorchSpfBackend(one_engine=engine, device="cpu", max_iters=max_iters)
    be = AsyncSpfBackend(inner, pipe)
    jbe = jax_ref(engine, max_iters)
    steps = [(tt, jt, be.compute(tt, multipath_k=kp), jbe.compute(jt, multipath_k=kp))]
    rng = np.random.default_rng(7)
    for _ in range(8):
        tt, jt = _step(tt, jt, _mutation(tt, rng))
        steps.append((tt, jt, be.compute(tt, multipath_k=kp), jbe.compute(jt, multipath_k=kp)))
    for i, (t, j, g, w) in enumerate(steps):
        g = _force(g)
        _same(g, _force(w), f"step {i} jax", kp)
        if max_iters is None:
            _same(g, ScalarSpfBackend().compute(t, multipath_k=kp), f"step {i} oracle", kp)
    assert sum(v for (_, path), v in inner.delta_paths.items() if path == "incremental") >= 4
    assert pipe.stats()["max-inflight-per-key"] <= 1
    assert len({be._key(t) for t, *_ in steps}) == 1  # one chain, one key


def _frr_same(a, b, label):
    for f in TABLE_PLANES:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f"{label} {f}")


def test_async_frr_matches_jax_pipeline_and_overlaps_spf(pipe):
    jt = jsynth.random_ospf_topology(n_routers=18, n_networks=6, extra_p2p=10, seed=5)
    jpipe = jpipeline.DispatchPipeline(depth=2, name="jax-frr")
    try:
        want = jpipeline.AsyncFrrEngine(JFrrEngine("tpu"), jpipe).compute(jt)
        want = want._ticket.result(timeout=WAIT)
    finally:
        jpipe.close()
    eng = AsyncFrrEngine(FrrEngine("torch", device="cpu"), pipe)
    be = AsyncSpfBackend(TorchSpfBackend(device="cpu"), pipe)
    spf = be.compute(jt)  # SPF and FRR of one topology: two keys, both ahead
    table = eng.compute(jt)
    assert table.pending() in (True, False)
    _frr_same(table.wait(), want, "jax")
    _frr_same(table, JFrrEngine("scalar").compute(jt), "oracle")
    _same(_force(spf), ScalarSpfBackend().compute(jt), "spf")
    assert eng.inner.dispatches["device"] == 1 and pipe.stats()["dispatches"]["frr"] == 1
    direct = FrrEngine("torch", device="cpu")
    _frr_same(direct._finish_device(direct._launch_device(jt, direct.marshal_inputs(jt))),
              want, "launch/finish")


def test_async_frr_ospf_backup_flip_matches_jax_pipeline():
    """The OSPF backup flip (tests/test_torch_frr.py's triangle) with r1's
    FRR engine pipelined: the port's AsyncFrrEngine against holo_tpu's."""
    from holo_tpu.frr.manager import FrrConfig as JConfig
    from test_torch_frr import DEST, _fib, _triangle

    from holo_tpu.utils.ibus import TOPIC_BFD_STATE, BfdStateUpd
    from ipaddress import IPv4Address as A

    def flip(cfg, engine, pipe):
        loop, fabric, buses, kernels, ribs, routers = _triangle(cfg, engine)

        def settle():
            pipe.drain(timeout=WAIT)
            loop.run_until_idle()  # the deferred FRR attach hops back here

        k1 = kernels["r1"]
        settle()
        steps = [(_fib(k1), {p: {(str(a.addr), str(b.addr)) for a, b in m.items()}
                             for p, m in k1.backups.items()})]
        buses["r1"].publish(TOPIC_BFD_STATE,
                            BfdStateUpd(key=("e0", A("10.0.12.2")), state="down"))
        loop.run_until_idle()
        settle()
        steps.append((_fib(k1), set(ribs["r1"].repaired)))
        fabric.set_link_up("l12", False)
        loop.advance(60)
        settle()
        steps.append((_fib(k1), set(ribs["r1"].repaired)))
        return steps

    pipe, jpipe = DispatchPipeline(depth=2), jpipeline.DispatchPipeline(depth=2, name="jax-flip")
    try:
        eng = AsyncFrrEngine(FrrEngine("torch", device="cpu"), pipe)
        got = flip(JConfig(enabled=True, engine="torch"), eng, pipe)
        want = flip(JConfig(enabled=True, engine="tpu"),
                    jpipeline.AsyncFrrEngine(JFrrEngine("tpu"), jpipe), jpipe)
    finally:
        pipe.close()
        jpipe.close()
    assert got == want
    assert eng.inner.dispatches["device"] > 0 and pipe.stats()["dispatches"].get("frr", 0) > 0
    (fib0, backups0), (fib1, repaired1), _ = got
    assert backups0[DEST] == {("10.0.12.2", "10.0.13.2")} and DEST in repaired1


# -- the queue contract (tests/test_pipeline.py)


def test_per_key_ordering_and_cross_key_progress(pipe):
    done, lock = [], threading.Lock()

    def work(key, i, delay):
        def run():
            time.sleep(delay)
            with lock:
                done.append((key, i))
            return key, i
        return run

    tickets = []
    for i in range(4):
        tickets.append(pipe.submit(("a", 0), "one", run=work("a", i, 0.01)))
        tickets.append(pipe.submit(("b", 0), "one", run=work("b", i, 0.0)))
    for t in tickets:
        t.result(timeout=WAIT)
    for key in ("a", "b"):
        seq = [i for k, i in done if k == key]
        assert seq == sorted(seq), f"per-key order violated for {key}: {seq}"


def test_split_phase_overlap_and_single_inflight_per_key(pipe):
    events, lock = [], threading.Lock()

    def mk(key, i):
        def launch():
            with lock:
                events.append(("launch", key, i))
            return key, i

        def finish(h):
            time.sleep(0.02)
            with lock:
                events.append(("finish", key, i))
            return h
        return launch, finish

    tickets = []
    for i in range(3):
        for key in ("k1", "k2"):
            la, fi = mk(key, i)
            tickets.append(pipe.submit((key,), "one", launch=la, finish=fi))
    for t in tickets:
        t.result(timeout=WAIT)
    st = pipe.stats()
    assert st["max-inflight-per-key"] <= 1, st
    for key in ("k1", "k2"):
        seq = [(ev, i) for ev, k, i in events if k == key]
        for i in range(2):
            assert seq.index(("finish", i)) < seq.index(("launch", i + 1))
    assert st["overlap-seconds"] > 0.0


def test_whatif_coalescing_shared_and_superseded():
    pipe = DispatchPipeline(depth=1)
    release, ran = threading.Event(), []

    def batch(gen):
        def run():
            ran.append(gen)
            return f"batch-{gen}"
        return run

    try:
        t0 = pipe.submit(("x",), "one", run=lambda: release.wait(5) and "blocker")
        t1 = pipe.submit(("w",), "whatif", run=batch(1), generation=1, coalesce=True)
        assert pipe.submit(("w",), "whatif", run=batch(1), generation=1, coalesce=True) is t1
        t2 = pipe.submit(("w",), "whatif", run=batch(2), generation=2, coalesce=True)
        release.set()
        assert t0.result(timeout=WAIT) == "blocker"
        assert t2.result(timeout=WAIT) == "batch-2"
        assert t1.result(timeout=WAIT) is None and t1.superseded
        st = pipe.stats()
    finally:
        release.set()
        pipe.close()
    assert ran == [2]
    assert st["coalesced"] == 2 and st["coalesced-by-reason"] == {"shared": 1, "superseded": 1}


def _open(name):
    br = CircuitBreaker(name, failure_threshold=1, recovery_timeout=1e9)
    with pytest.raises(RuntimeError):
        br.call(lambda: (_ for _ in ()).throw(RuntimeError("boom")), None)
    assert br.state == "open"
    return br


def test_breaker_open_skips_advisory_batch_entirely(pipe):
    br = _open("pipeline-skip-test")
    ran = []
    t = pipe.submit(("w",), "whatif", run=lambda: ran.append(1), generation=1, coalesce=True,
                    skip_when_open=br)
    assert t.skipped and t.result(timeout=1) is None
    st = pipe.stats()
    assert not ran and st["breaker-skipped"] == 1 and st["submitted"] == 0


def test_async_whatif_breaker_open_skip_via_backend():
    tt, jt = _pair(3)
    masks = tsynth.whatif_link_failure_masks(tt, 4, seed=1)
    pipeline.configure_process_pipeline(depth=2)
    br = CircuitBreaker("async-whatif-test", failure_threshold=1, recovery_timeout=1e9)
    be = pipeline.wrap_spf_backend(TorchSpfBackend(device="cpu", breaker=br))
    res = be.compute_whatif_async(tt, masks).result(timeout=WAIT)
    for r, s in zip(JScalar().compute_whatif(jt, masks), res):
        _same(s, r, "whatif")
    br.force_failure("exception", RuntimeError("boom"))
    assert br.state == "open"
    t2 = be.compute_whatif_async(tt, masks)
    assert t2.skipped and t2.result(timeout=1) is None


def test_passthrough_exception_surfaces_at_force_time():
    pipeline.configure_process_pipeline(depth=1)
    inner = TorchSpfBackend(device="cpu")
    be = pipeline.wrap_spf_backend(inner)

    def buggy_launch(t, edge_mask=None, multipath_k=1):
        raise TypeError("bug, not a device failure")

    inner.launch_one = buggy_launch
    res = be.compute(_pair(11)[0])
    with pytest.raises(TypeError):
        _ = res.dist
    snap = be.breaker.snapshot()
    assert snap["state"] == "closed" and snap["consecutive-failures"] == 0
    assert not snap["failures"] and not snap["fallbacks"]


def test_async_breaker_fallback_bit_identical_on_the_cpu(pipe):
    """No iteration cap on the CPU: forced launch failures are counted and
    the oracle serves them bit for bit; the open circuit serves too."""
    br = CircuitBreaker("async-fallback-test", failure_threshold=2, recovery_timeout=1e9)
    be = AsyncSpfBackend(TorchSpfBackend(device="cpu", breaker=br), pipe)
    tt, jt = _pair(7)
    ref = JScalar().compute(jt)
    with inject(FaultInjector(FaultPlan(seed=7, dispatch_fail={"pipeline.dispatch": 2}))) as inj:
        for _ in range(2):
            _same(_force(be.compute(tt)), ref, "fallback")
    assert inj.injected["pipeline.dispatch"] == 2
    assert br.state == "open"
    _same(be.compute(tt), ref, "open circuit")  # the caller's thread, the oracle
    snap = br.snapshot()
    assert snap["failures"] == {"exception": 2}
    assert snap["fallbacks"] == {"exception": 2, "open": 1} and not snap["refusals"]


def test_crashpoint_mid_chain_bit_identical_to_sync_control(pipe):
    """Forced ``pipeline.dispatch`` failures mid delta chain open the
    breaker; the oracle serves the rest, and every step equals a
    synchronous control run of the same chain."""
    tt, _ = _pair(33)
    rng = np.random.default_rng(33)
    chain = [tt]
    for _ in range(8):
        chain.append(_tstep(chain[-1], _mutation(chain[-1], rng)))
    control = TorchSpfBackend(device="cpu")
    want = [control.compute(t) for t in chain]
    br = CircuitBreaker("pipeline-chain", failure_threshold=2, recovery_timeout=1e9)
    be = AsyncSpfBackend(TorchSpfBackend(device="cpu", breaker=br), pipe)
    plan = FaultPlan(seed=33, dispatch_fail={"pipeline.dispatch": 2})
    got = [be.compute(t) for t in chain[:3]]
    with inject(FaultInjector(plan)) as inj:
        got += [be.compute(t) for t in chain[3:5]]
        got = [_force(g) for g in got]
        got += [be.compute(t) for t in chain[5:]]  # open: the caller's thread
    assert inj.injected["pipeline.dispatch"] == 2 and br.state == "open"
    for i, (g, w) in enumerate(zip(got, want)):
        _same(g, w, f"step {i}")


def test_wrap_helpers_are_identity_when_unarmed():
    be = TorchSpfBackend(device="cpu")
    eng = FrrEngine("torch", device="cpu")
    assert pipeline.wrap_spf_backend(be) is be and pipeline.wrap_frr_engine(eng) is eng
    pipeline.configure_process_pipeline(depth=1)
    scalar, sfrr = ScalarSpfBackend(), FrrEngine("scalar")
    assert pipeline.wrap_spf_backend(scalar) is scalar
    assert pipeline.wrap_frr_engine(sfrr) is sfrr
    assert isinstance(pipeline.wrap_spf_backend(be), AsyncSpfBackend)
    assert isinstance(pipeline.wrap_frr_engine(eng), AsyncFrrEngine)
    assert pipeline.wrap_spf_backend(be).name == "torch-async"
    pipeline.reset_process_pipeline()
    assert pipeline.process_pipeline() is None and pipeline.wrap_spf_backend(be) is be


# -- the card rule on the CPU


@pytest.mark.parametrize("site", ["spf.dispatch", "pipeline.dispatch", "finish"])
def test_no_fallback_failure_reraises_at_force_time(pipe, site):
    """``max_iters`` set: the oracle does not compute the same bits, so no
    pipelined dispatch is served from it.  A failure in the launch (a
    crashpoint) or the finish re-raises when the result is read, counted;
    the open circuit then refuses with CircuitOpen."""
    br = CircuitBreaker(f"card-rule-{site}", failure_threshold=1, recovery_timeout=1e9)
    inner = TorchSpfBackend(device="cpu", max_iters=5, breaker=br)
    be = AsyncSpfBackend(inner, pipe)
    tt, _ = _pair(2)
    if site == "finish":
        def boom(h):
            raise RuntimeError("device lost in the finish")
        inner.finish_one = boom
        res, err = be.compute(tt), RuntimeError
    else:
        with inject(FaultInjector(FaultPlan(dispatch_fail={site: 1}))):
            res = be.compute(tt)
            pipe.drain(timeout=WAIT)
        err = InjectedFault
    with pytest.raises(err):
        _ = res.dist
    assert br.state == "open"
    with pytest.raises(CircuitOpen):
        be.compute(tt)
    snap = br.snapshot()
    assert snap["failures"] == {"exception": 1} and snap["refusals"] == {"open": 1}
    assert not snap["fallbacks"]


def test_no_fallback_open_circuit_refuses_a_launch():
    """An open circuit seen by the launch (the breaker opened after the
    submit) raises CircuitOpen at force time, counted as a refusal."""
    br = CircuitBreaker("card-rule-launch-open", failure_threshold=1, recovery_timeout=1e9)
    be = TorchSpfBackend(device="cpu", max_iters=5, breaker=br)
    from holo_tpu_torch.pipeline.dispatch import _guarded_launch

    br.force_failure("exception", RuntimeError("boom"))
    with pytest.raises(CircuitOpen):
        _guarded_launch(br, "spf.one", lambda: be.launch_one(_pair(2)[0]))
    assert br.snapshot()["refusals"] == {"open": 1}


def test_frr_no_fallback_failure_reraises_at_force_time(pipe):
    jt = jsynth.random_ospf_topology(n_routers=12, n_networks=3, extra_p2p=6, seed=2)
    br = CircuitBreaker("card-rule-frr", failure_threshold=3, recovery_timeout=1e9)
    eng = AsyncFrrEngine(FrrEngine("torch", device="cpu", max_iters=5, breaker=br), pipe)
    with inject(FaultInjector(FaultPlan(dispatch_fail={"frr.dispatch": 1}))):
        table = eng.compute(jt)
        pipe.drain(timeout=WAIT)
    with pytest.raises(InjectedFault):
        _ = table.lfa_adj
    assert br.snapshot()["failures"] == {"exception": 1} and not br.snapshot()["fallbacks"]
    # With no cap the oracle serves the same failure bit for bit.
    eng = AsyncFrrEngine(FrrEngine("torch", device="cpu"), pipe)
    with inject(FaultInjector(FaultPlan(dispatch_fail={"frr.dispatch": 1}))):
        _frr_same(eng.compute(jt).wait(), JFrrEngine("scalar").compute(jt), "fallback")
    assert eng.inner.dispatches["fallback"] == 1


# -- concurrent threads: the shared graph cache and the library build


def test_shared_graph_cache_under_four_threads():
    """4 threads run compute / compute_whatif (and a delta step) on distinct
    topologies through one shared cache, shrunk to force evictions: the
    results equal the serial runs."""
    topos = [tsynth.random_ospf_topology(seed=40 + i, **KW) for i in range(4)]
    masks = [tsynth.whatif_link_failure_masks(t, 3, seed=i) for i, t in enumerate(topos)]
    deltas = [_tstep(t, {"cost": {0: 77}}) for t in topos]

    def work(i, be):
        out = []
        for _ in range(3):
            out.append(be.compute(topos[i]))
            out.extend(be.compute_whatif(topos[i], masks[i]))
            out.append(be.compute(topos[i], multipath_k=4))
        out.append(be.compute(deltas[i]))
        return out

    serial = [work(i, TorchSpfBackend(device="cpu", incremental=False)) for i in range(4)]
    cache = te.shared_graph_cache("cpu")
    cap = cache.capacity
    cache.capacity = 2
    got, errors = [None] * 4, []

    def run(i):
        try:
            got[i] = work(i, TorchSpfBackend(device="cpu"))
        except BaseException as exc:  # noqa: BLE001 -- reported below
            errors.append(exc)

    try:
        threads = [threading.Thread(target=run, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT)
    finally:
        cache.capacity = cap
    assert not errors, errors
    for i in range(4):
        for j, (g, w) in enumerate(zip(got[i], serial[i])):
            _same(g, w, f"thread {i} result {j}", 4 if g.parents is not None else 1)


@pytest.mark.parametrize("call", ["whatif", "multiroot"])
def test_sync_delegate_on_the_base_runs_after_the_chains_delta(pipe, call):
    """A delta of a chain is submitted, and while it waits to apply itself
    the caller runs ``compute_whatif`` / ``compute_multiroot`` on the
    delta's base.  The delegate must not read the base's graph while the
    delta rewrites its planes in place: its result equals the serial run.
    The delta's apply waits up to 1 s for the delegate to hold the base's
    graph, and the delegate, once it holds it, up to 1 s for the apply: run
    on the caller's thread, the delegate would read the next generation's
    costs; run in the chain's order on the worker, it follows the delta."""
    base = tsynth.random_ospf_topology(seed=11, **KW)
    nxt = _tstep(base, {"cost": {e: 60 + e for e in range(0, base.n_edges, 3)}})
    masks = tsynth.whatif_link_failure_masks(base, 3, seed=5)
    roots = [0, 3, 7]

    def delegate(be, topo):
        if call == "whatif":
            return be.compute_whatif(topo, masks)
        return [be.compute_multiroot(topo, roots)]

    ref = TorchSpfBackend(device="cpu", incremental=False)
    # The next generation's results from a copy of it (a uid of its own),
    # so that its graph is not resident before the delta applies.
    want, moved = delegate(ref, base), delegate(ref, tsynth.clone_topology(nxt))
    assert any(not np.array_equal(a.dist, b.dist) for a, b in zip(want, moved))

    inner = TorchSpfBackend(device="cpu")
    be = AsyncSpfBackend(inner, pipe)
    _force(be.compute(base))  # the base resident, its run kept
    cache = inner._gather_cache
    holds_base, applied = threading.Event(), threading.Event()
    real_get, real_delta = cache.get, cache._try_delta

    def get(topo, *a, **k):
        out = real_get(topo, *a, **k)
        if topo is base and not holds_base.is_set():
            holds_base.set()
            applied.wait(1.0)
        return out

    def try_delta(topo, *a, **k):
        holds_base.wait(1.0)
        out = real_delta(topo, *a, **k)
        applied.set()
        return out

    cache.get, cache._try_delta = get, try_delta
    lazy = be.compute(nxt)
    got = delegate(be, base)
    fields = FIELDS if call == "whatif" else ("dist", "parent", "hops")
    for j, (g, w) in enumerate(zip(got, want)):
        for f in fields:
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f), err_msg=f"{call} {j} {f}")
    _same(_force(lazy), ref.compute(nxt), "the delta")
    assert applied.is_set() and inner.delta_paths[("weight", "incremental")] == 1
    assert pipe.stats()["max-inflight-per-key"] <= 1


@pytest.mark.parametrize("masked", [True, False])
def test_partitioned_call_on_the_base_runs_after_the_chains_delta(pipe, masked):
    """The partitioned twin of the test above: a delta of a chain is
    submitted, and while it waits to re-solve the partitioned resident in
    place the caller runs ``compute_partitioned`` on the delta's base.  The
    solve's entry waits up to 1 s for the delta's in-place re-solve and the
    re-solve up to 1 s for the solve: run on the caller's thread, the solve
    would read the next generation's planes; run in the chain's order on
    the worker, it follows the delta and equals the serial run."""
    base = tsynth.multiarea_topology(4, 6, 6, seed=3)
    nxt = _tstep(base, {"cost": {e: 60 + e % 7 for e in range(0, base.n_edges, 3)}})
    mask = tsynth.whatif_link_failure_masks(base, 3, seed=5)[1] if masked else None
    ref = TorchSpfBackend(device="cpu", partition_threshold=1, incremental=False)
    want = ref.compute_partitioned(base, mask)
    moved = ref.compute_partitioned(tsynth.clone_topology(nxt), mask)
    assert not np.array_equal(want.dist, moved.dist)

    inner = TorchSpfBackend(device="cpu", partition_threshold=1)
    be = AsyncSpfBackend(inner, pipe)
    _force(be.compute(base))  # the base's partitioned resident
    eng = inner._part_engine
    holds_base, applied = threading.Event(), threading.Event()
    real_solve, real_delta = eng.solve, eng.try_delta

    def solve(topo, *a, **k):
        if topo is base and not holds_base.is_set():
            holds_base.set()
            applied.wait(1.0)
        return real_solve(topo, *a, **k)

    def try_delta(topo, *a, **k):
        holds_base.wait(1.0)
        out = real_delta(topo, *a, **k)
        applied.set()
        return out

    eng.solve, eng.try_delta = solve, try_delta
    lazy = be.compute(nxt)
    got = be.compute_partitioned(base, mask)
    _same(got, want, f"compute_partitioned masked={masked}")
    _same(_force(lazy), ref.compute(nxt), "the delta")
    assert applied.is_set()
    assert inner.delta_paths[("weight", "partitioned-incremental")] == 1
    assert pipe.stats()["max-inflight-per-key"] <= 1


@pytest.mark.parametrize("attr", sorted(AsyncSpfBackend.WORKER_ONLY))
def test_facade_refuses_calls_that_read_the_resident_graph(pipe, attr):
    """``launch_one`` / ``finish_one`` / ``prepare`` read (or update in
    place) the chain's resident graph: the facade does not pass them to the
    inner backend off the worker."""
    inner = TorchSpfBackend(device="cpu")
    be = AsyncSpfBackend(inner, pipe)
    with pytest.raises(AttributeError, match=attr):
        getattr(be, attr)
    assert callable(getattr(inner, attr))
    assert be.delta_paths is inner.delta_paths  # the rest passes through


def test_library_first_build_runs_once_at_a_time(monkeypatch):
    """Four threads asking for the library at once never build it at the
    same time (a build that fails leaves it unbuilt, so each tries)."""
    state = {"now": 0, "most": 0, "calls": 0}
    lock = threading.Lock()

    def slow_build():
        with lock:
            state["now"] += 1
            state["calls"] += 1
            state["most"] = max(state["most"], state["now"])
        time.sleep(0.05)
        with lock:
            state["now"] -= 1
        raise build.KernelBuildError("no nvcc here")

    monkeypatch.setattr(build, "_LIB", None)
    monkeypatch.setattr(build, "build", slow_build)
    errors = []

    def run():
        try:
            build.load()
        except build.KernelBuildError as exc:
            errors.append(exc)

    threads = [threading.Thread(target=run) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(WAIT)
    assert state == {"now": 0, "most": 1, "calls": 4} and len(errors) == 4
