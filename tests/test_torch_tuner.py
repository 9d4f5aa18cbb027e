"""The port's engine tuner (holo_tpu_torch.pipeline.tuner) against
holo_tpu.pipeline.tuner, and its wiring into the port's backend and graph
cache.

- The same pick / observe sequence gives the same engines, phases, winners
  and snapshot as holo_tpu's tuner over the same candidate sets;
- a table written by either package loads in the other and picks the same;
- a version mismatch or a corrupt file is discarded;
- the multipath candidates are holo_tpu's (mp and mp_tropical): a loaded
  table whose kp bucket winner is mp_tropical picks it, as holo_tpu's
  tuner does, and an engine neither package runs is kept (a save
  round-trips it) and never picked;
- an armed tuner measures both multipath engines of a compute() bucket
  with every plane equal to the oracle's, and a kp = 4 bucket whose
  measured winner is mp_tropical routes its DeltaPath chain through the
  tiles (tests/test_tropical.py:435-456 and :537-563);
- max_delta_depth scales with the measured ratio (tests/test_tuner.py:148);
- the port's DeviceGraphCache consults the tuned cap, and a chain past it
  is rebuilt (full-depth) with the same bits;
- an armed tuner's flips between engines leave every plane equal to seq's;
- a first-use dispatch is not a sample; the delta-linked and re-marshaling
  compute() feed the depth arms; a warm full partitioned solve, and only
  that, feeds the partitioned rows.
"""

import json

import numpy as np
import pytest

from holo_tpu.pipeline import tuner as jtuner
from holo_tpu_torch import pipeline
from holo_tpu_torch.ops import graph as tgraph
from holo_tpu_torch.ops import spf_engine as te
from holo_tpu_torch.pipeline import tuner
from holo_tpu_torch.spf import synth as tsynth
from holo_tpu_torch.spf.backend import TorchSpfBackend

FIELDS = ("dist", "parent", "hops", "nexthop_words")
MP_FIELDS = ("parents", "pdist", "pweight", "npaths", "nh_weights")
B1 = tuner.shape_bucket(1000, 4000, 1, None)
B8 = tuner.shape_bucket(1000, 4000, 8, None)
BK4 = tuner.shape_bucket(1000, 4000, 1, None, k=4)


@pytest.fixture(autouse=True)
def _clean():
    yield
    pipeline.reset_engine_tuner()


def _pair(**kw):
    return (tuner.EngineTuner(**kw),
            jtuner.EngineTuner(engines=tuner.ENGINES, mp_engines=tuner.MP_ENGINES, **kw))


def _wall(engine: str, i: int) -> float:
    """A deterministic wall: hybrid fastest early, then fused (a promotion)."""
    base = {"seq": 3.0, "fused": 2.0, "packed": 2.5, "hybrid": 1.0, "tropical": 3.5,
            "mp": 4.0, "mp_tropical": 3.8}[engine]
    return base + (5.0 if engine == "hybrid" and i > 20 else 0.0) + (i % 3) * 0.01


def _decisions_jax():
    from holo_tpu import telemetry

    return {k: v for k, v in telemetry.snapshot(prefix="holo_pipeline_tuner_decisions").items()}


def test_shape_bucket_matches_holo_tpu():
    for args in ((1000, 4000, 8, None), (1, 0, 1, ("m", 2)), (900, 3900, 1024, None, 8)):
        assert tuner.shape_bucket(*args) == jtuner.shape_bucket(*args)
    assert tuner.bgp_shape_bucket(1000, 17) == jtuner.bgp_shape_bucket(1000, 17)
    assert tuner.TABLE_VERSION == jtuner.TABLE_VERSION == 3
    for name in ("SAMPLE_WINDOW", "DEPTH_SCALE", "DEPTH_MIN", "DEPTH_MAX", "DEPTH_MIN_SAMPLES"):
        assert getattr(tuner, name) == getattr(jtuner, name), name
    assert tuner.ENGINES == jtuner.ENGINES
    assert tuner.MP_ENGINES == jtuner.MP_ENGINES == ("mp", "mp_tropical")


@pytest.mark.parametrize("explore_rounds,reprobe_every", [(1, 0), (2, 64), (2, 5), (3, 7)])
def test_same_sequence_same_decisions(explore_rounds, reprobe_every):
    port, ref = _pair(explore_rounds=explore_rounds, reprobe_every=reprobe_every)
    before = _decisions_jax()
    for i in range(60):
        for kind, bucket in (("one", B1), ("whatif", B8), ("one", BK4), ("whatif", BK4)):
            a, b = port.pick(kind, bucket), ref.pick(kind, bucket)
            assert a == b, (i, kind, bucket)
            if i % 4 != 3:  # some dispatches go unmeasured (first use)
                port.observe(kind, bucket, a, _wall(a, i))
                ref.observe(kind, bucket, b, _wall(b, i))
        if i == 30:
            port.cost_prior("one", B1, "packed", {"flops": 1.0, "bytes": 2.0})
            ref.cost_prior("one", B1, "packed", {"flops": 1.0, "bytes": 2.0})
    assert port.snapshot()["buckets"] == ref.snapshot()["buckets"]
    assert port.ledger() == ref.ledger()
    ps, rs = port.stats(), ref.stats()
    for key in ("buckets", "promotions", "winners"):
        assert ps[key] == rs[key], key
    after = _decisions_jax()
    jax_counts = {k: v - before.get(k, 0.0) for k, v in after.items() if v != before.get(k, 0.0)}
    port_counts = {f"holo_pipeline_tuner_decisions_total{{kind={k},engine={e},phase={p}}}":
                   float(n) for (k, e, p), n in ps["decisions"].items()}
    assert port_counts == jax_counts
    for kind, bucket in (("one", B1), ("whatif", B8), ("one", BK4)):
        assert port.current_winner(kind, bucket) == ref.current_winner(kind, bucket)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_tables_cross_load(tmp_path, writer):
    port, ref = _pair(explore_rounds=2, reprobe_every=0)
    src = port if writer == "port" else ref
    for i in range(20):
        for kind, bucket in (("one", B1), ("whatif", B8)):
            e = src.pick(kind, bucket)
            src.observe(kind, bucket, e, _wall(e, i))
    for _ in range(3):
        src.observe_delta(B1, 0.001)
        src.observe_full(B1, 0.010)
    src.observe_partitioned(B1, 0.5)
    path = tmp_path / "tuner.json"
    assert src.save(path)
    cold_port = tuner.EngineTuner(path=path)
    cold_jax = jtuner.EngineTuner(path=path, engines=tuner.ENGINES, mp_engines=tuner.MP_ENGINES)
    assert cold_port.stats()["loaded-from-disk"] and cold_jax.stats()["loaded-from-disk"]
    assert cold_port.snapshot()["buckets"] == cold_jax.snapshot()["buckets"]
    assert cold_port.snapshot()["depth"] == cold_jax.snapshot()["depth"]
    for kind, bucket in (("one", B1), ("whatif", B8)):
        assert cold_port.pick(kind, bucket) == cold_jax.pick(kind, bucket) == \
            src.current_winner(kind, bucket)
    assert cold_port.max_delta_depth(B1) == 10 * tuner.DEPTH_SCALE
    assert cold_port.partitioned_advantage(B1) == cold_jax.partitioned_advantage(B1)


@pytest.mark.parametrize("content", ['{"version": 999, "buckets": {"bogus": {}}}', "{not json",
                                     '{"version": 2, "buckets": {}}', "[1, 2]"])
def test_version_mismatch_or_corrupt_file_discarded(tmp_path, content):
    path = tmp_path / "tuner.json"
    path.write_text(content)
    t = tuner.EngineTuner(path=path)
    assert not t.stats()["loaded-from-disk"]
    assert t.stats()["buckets"] == 0
    assert t.pick("one", B1) in tuner.ENGINES


def test_unknown_engine_in_a_loaded_table_is_kept_and_never_picked(tmp_path):
    # holo_tpu's tuner writes the table.  Its kp = 4 compute() bucket's
    # winner, mp_tropical (the tropical multipath program), is picked here
    # as there; an engine neither package runs, measured in the same bucket
    # of the file, is kept through a save and never picked.
    ref = jtuner.EngineTuner(explore_rounds=1, reprobe_every=3)
    for i in range(12):
        e = ref.pick("one", BK4)
        ref.observe("one", BK4, e, 0.001 if e == "mp_tropical" else 1.0 + i * 1e-3)
    assert ref.current_winner("one", BK4) == "mp_tropical"
    path = tmp_path / "tuner.json"
    assert ref.save(path)
    doc = json.loads(path.read_text())
    key = json.dumps(["one", *BK4])
    doc["buckets"][key]["samples"]["mp_future"] = [0.0001]
    path.write_text(json.dumps(doc))
    t = tuner.EngineTuner(path=path, reprobe_every=3)
    cold = jtuner.EngineTuner(path=path, reprobe_every=3)
    assert "mp_future" in t.snapshot()["buckets"][key]["samples"]
    picks = [t.pick("one", BK4) for _ in range(40)]
    assert picks == [cold.pick("one", BK4) for _ in range(40)]
    assert "mp_future" not in picks and set(picks) == set(tuner.MP_ENGINES)
    assert picks.count("mp_tropical") > picks.count("mp")  # the winner, reprobes apart
    assert t.current_winner("one", BK4) == "mp_tropical"
    t.observe("one", BK4, "mp", 2.0)
    again = tmp_path / "again.json"
    assert t.save(again)
    doc = json.loads(again.read_text())
    assert doc["buckets"][key]["samples"]["mp_future"] == [0.0001]
    assert doc["buckets"][key]["samples"]["mp_tropical"] == \
        ref.snapshot()["buckets"][key]["samples"]["mp_tropical"]


def test_tuner_explores_tropical_and_the_mp_pair():
    """tests/test_tropical.py:435-456 on the port: an armed tuner measures
    tropical in the k = 1 compute() bucket and both mp and mp_tropical in
    the k = 8 one, every dispatch equal to the oracle."""
    from holo_tpu_torch.spf.backend import ScalarSpfBackend

    t = pipeline.configure_engine_tuner(explore_rounds=1, reprobe_every=0)
    topo = tsynth.random_ospf_topology(n_routers=14, n_networks=4, seed=1)
    sc = ScalarSpfBackend()
    be = TorchSpfBackend(device="cpu")
    ref = sc.compute(topo)
    for i in range(2 * len(tuner.ENGINES) + 2):
        _same(be.compute(topo), ref, f"one {i}")
    mref = sc.compute(topo, multipath_k=8)
    for i in range(2 * len(tuner.MP_ENGINES) + 2):
        _same(be.compute(topo, multipath_k=8), mref, f"mp {i}", FIELDS + MP_FIELDS)
    measured = set()
    for v in t.stats()["winners"].values():
        measured |= set(v["measured-engines"])
    assert "tropical" in measured
    assert {"mp", "mp_tropical"} <= measured
    picked = {e for (k, e, _) in t.stats()["decisions"] if k == "one"}
    assert {"mp", "mp_tropical"} <= picked


def test_mp_tropical_winner_routes_the_kp4_chain_through_the_tiles():
    """tests/test_tropical.py:537-563 at kp = 4: a bucket whose measured
    compute() winner is mp_tropical runs the DeltaPath chain of that width
    on the tiles (tile deltas applied), equal to the oracle; the kp = 1
    bucket, unmeasured, stays off them."""
    from holo_tpu_torch.ops import tropical as trop
    from holo_tpu_torch.spf.backend import ScalarSpfBackend

    t = pipeline.configure_engine_tuner(explore_rounds=1, reprobe_every=0)
    topo = tsynth.random_ospf_topology(n_routers=16, n_networks=4, seed=5)
    b4 = tuner.shape_bucket(topo.n_vertices, topo.n_edges, 1, None, k=4)
    for e, wall in (("mp", 0.1), ("mp_tropical", 0.001)):
        t.observe("one", b4, e, wall)
    be = TorchSpfBackend(device="cpu")
    assert be._trop_incremental(topo, 4) and not be._trop_incremental(topo, 1)
    calls = []
    real = trop.tropical_spf_one_incremental_multipath

    def counted(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    import holo_tpu_torch.spf.backend as backend_mod

    backend_mod.tropical_spf_one_incremental_multipath = counted
    try:
        _same(be.compute(topo, multipath_k=4), ScalarSpfBackend().compute(topo, multipath_k=4),
              "base", FIELDS + MP_FIELDS)
        nxt = tsynth.clone_topology(topo, cost={0: 7})
        nxt.link_delta(tgraph.diff_topologies(topo, nxt))
        _same(be.compute(nxt, multipath_k=4), ScalarSpfBackend().compute(nxt, multipath_k=4),
              "delta", FIELDS + MP_FIELDS)
    finally:
        backend_mod.tropical_spf_one_incremental_multipath = real
    assert calls == [1]
    assert be.delta_paths[("weight", "incremental")] == 1
    assert be._gather_cache.tile_deltas == {"apply": 1}


def test_depth_cap_scales_with_measured_ratio(tmp_path):
    t = tuner.EngineTuner(default_delta_depth=256)
    b = tuner.shape_bucket(500, 2000, 1, None)
    assert t.max_delta_depth(b) == 256
    for _ in range(tuner.DEPTH_MIN_SAMPLES):
        t.observe_delta(b, 0.001)
        t.observe_full(b, 0.040)  # delta 40x cheaper
    assert t.max_delta_depth(b) == 40 * tuner.DEPTH_SCALE
    b2 = tuner.shape_bucket(50, 100, 1, None)
    for _ in range(tuner.DEPTH_MIN_SAMPLES):
        t.observe_delta(b2, 0.010)
        t.observe_full(b2, 0.011)
    assert t.max_delta_depth(b2) == tuner.DEPTH_SCALE
    b3 = tuner.shape_bucket(70, 100, 1, None)
    for _ in range(tuner.DEPTH_MIN_SAMPLES):
        t.observe_delta(b3, 1e-6)
        t.observe_full(b3, 1.0)
    assert t.max_delta_depth(b3) == tuner.DEPTH_MAX
    path = tmp_path / "tuner.json"
    assert t.save(path)
    assert tuner.EngineTuner(path=path).max_delta_depth(b) == 40 * tuner.DEPTH_SCALE


def _cost_chain(topo, steps: int):
    """Topologies each linked to the one before by a weight delta."""
    cur, out = topo, []
    for i in range(steps):
        nxt = tsynth.clone_topology(cur, cost={i % 4: 2 + i % 5})
        nxt.link_delta(tgraph.diff_topologies(cur, nxt))
        out.append(nxt)
        cur = nxt
    return out


def test_device_graph_cache_consults_the_tuned_cap():
    topo = tsynth.random_ospf_topology(n_routers=30, n_networks=5, extra_p2p=15, seed=9)
    cache = te.DeviceGraphCache("cpu", capacity=4)
    assert cache._depth_cap(topo) == cache.max_delta_depth == 256
    t = pipeline.configure_engine_tuner()
    b = tuner.shape_bucket(topo.n_vertices, topo.n_edges, 1, None)
    for _ in range(tuner.DEPTH_MIN_SAMPLES):
        t.observe_delta(b, 1.0)
        t.observe_full(b, 1.0)
    assert cache._depth_cap(topo) == tuner.DEPTH_SCALE
    cache.get(topo, 64)
    chain = _cost_chain(topo, tuner.DEPTH_SCALE + 1)
    hows = [cache.get(t_, 64)[1] for t_ in chain]
    assert hows == ["delta"] * tuner.DEPTH_SCALE + ["miss"]
    assert cache.delta_paths[("weight", "full-depth")] == 1
    g, _ = cache.get(chain[-1], 64)
    fresh = te.device_graph_from_ell(tgraph.build_ell(chain[-1], n_atoms=64), "cpu")
    for a, b_ in zip(g, fresh):
        assert (a == b_).all()
    pipeline.reset_engine_tuner()
    assert cache._depth_cap(topo) == 256


def _same(a, b, label, fields=FIELDS):
    for f in fields:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f"{label} {f}")


@pytest.mark.parametrize("explore_rounds", [1, 2])
def test_tuned_backend_flips_engines_and_equals_seq(tmp_path, explore_rounds):
    topo = tsynth.random_ospf_topology(n_routers=70, n_networks=12, extra_p2p=60,
                                       seed=20 + explore_rounds)
    masks = tsynth.whatif_link_failure_masks(topo, 8, seed=1)
    seq = TorchSpfBackend(device="cpu", incremental=False)
    want_w, want_1 = seq.compute_whatif(topo, masks), seq.compute(topo)
    t = pipeline.configure_engine_tuner(path=tmp_path / "t.json",
                                        explore_rounds=explore_rounds, reprobe_every=4)
    be = TorchSpfBackend(device="cpu", incremental=False)
    for i in range(20):
        for a, b in zip(be.compute_whatif(topo, masks), want_w):
            _same(a, b, f"whatif {i}")
        _same(be.compute(topo), want_1, f"compute {i}")
    picked = {(k, e) for (k, e, _) in t.stats()["decisions"]}
    assert {e for k, e in picked if k == "whatif"} == set(tuner.ENGINES)
    assert {e for k, e in picked if k == "one"} == set(tuner.ENGINES)
    phases = {p for (_, _, p) in t.stats()["decisions"]}
    assert {"explore", "exploit", "reprobe"} <= phases
    assert t.save()
    # The reloaded table is read under the same schedule: with fewer explore
    # rounds than its own default, an engine the reprobes missed would still
    # be exploring.
    cold = tuner.EngineTuner(path=tmp_path / "t.json", explore_rounds=explore_rounds)
    bw = tuner.shape_bucket(topo.n_vertices, topo.n_edges, 8, None)
    assert cold.pick("whatif", bw) == t.current_winner("whatif", bw)


def test_first_use_dispatch_is_not_a_sample(monkeypatch):
    from holo_tpu_torch.spf import backend as backend_mod

    monkeypatch.setattr(backend_mod, "_DISPATCHED", set())
    topo = tsynth.random_ospf_topology(n_routers=61, n_networks=9, extra_p2p=41, seed=31)
    masks = tsynth.whatif_link_failure_masks(topo, 3, seed=2)
    be = TorchSpfBackend(device="cpu", incremental=False)
    # Unarmed, a dispatch leaves no signature: the first armed one still
    # counts as the first.
    be.compute(topo)
    assert backend_mod._DISPATCHED == set()
    t = pipeline.configure_engine_tuner(explore_rounds=1)
    keys = (("one", *tuner.shape_bucket(topo.n_vertices, topo.n_edges, 1, None)),
            ("whatif", *tuner.shape_bucket(topo.n_vertices, topo.n_edges, 3, None)))
    samples = []
    for _ in range(6):
        be.compute(topo)
        be.compute_whatif(topo, masks)
        samples.append([sum(len(d) for d in t._table[k].samples.values()) for k in keys])
    # Explore: seq, fused, packed, hybrid and tropical each run first (no
    # sample), then seq again, measured.
    assert samples == [[0, 0]] * 5 + [[1, 1]]


def test_depth_arms_are_fed_by_the_backend():
    topo = tsynth.random_ospf_topology(n_routers=33, n_networks=6, extra_p2p=21, seed=12)
    t = pipeline.configure_engine_tuner()
    be = TorchSpfBackend(device="cpu")
    be.compute(topo)  # a marshal: the "full" arm
    for nxt in _cost_chain(topo, 3):
        be.compute(nxt)  # delta-linked: the "delta" arm
    d = t._depth[tuner.shape_bucket(topo.n_vertices, topo.n_edges, 1, None)]
    assert len(d["full"]) == 1 and len(d["delta"]) == 3
    assert be.delta_paths[("weight", "incremental")] == 3


def test_partitioned_rows_take_warm_full_solves_only():
    topo = tsynth.multiarea_topology(3, 4, 4, seed=3)
    t = pipeline.configure_engine_tuner()
    be = TorchSpfBackend(device="cpu", partition_threshold=1)
    bucket = tuner.shape_bucket(topo.n_vertices, topo.n_edges, 1, None)

    def samples():
        st = t._table.get(("partitioned", *bucket))
        return 0 if st is None else len(st.samples.get("partitioned", ()))

    be.compute(topo)  # marshal
    assert samples() == 0
    be.compute(topo)  # warm full solve
    be.compute(topo)
    assert samples() == 2
    be.compute(topo, np.ones(topo.n_edges, bool))  # masked
    assert samples() == 2
    for nxt in _cost_chain(topo, 2):
        be.compute(nxt)  # delta re-solves
    assert samples() == 2
    assert be.delta_paths[("weight", "partitioned-incremental")] == 2
