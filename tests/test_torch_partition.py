"""Partitioned SPF in the port against holo_tpu's, bit for bit.

- the cut, the plan and the stacked planes: ``partition_topology`` and
  ``build_plan`` equal JAX's field for field (the parts' vertices in the
  port's ascending order), and the port's stacked planes equal JAX's
  ``PartPlanes`` brought across by ``convert.partition_from_numpy``;
- phase by phase on JAX's own plan and planes: the boundary tables (at root
  chunks 1, 16 and all), the skeleton distances and the final distances;
- the backend: ``TorchSpfBackend(partition_threshold=1,
  partition_max_part=12)`` equals ``TpuSpfBackend`` with the same arguments
  (JAX-CPU) and the scalar oracle on ``tied(seed)`` topologies
  (tests/test_partition.py's family): ``multipath_k`` 1, 2 and 8, what-if
  masks, random and adversarial cuts, a native hint, disconnected and
  one-vertex graphs, ``max_iters`` 0, 1 and 3, DeltaPath chains across cut
  edges (each step's disposition equal to JAX's ``holo_spf_delta_total``
  increment), a structural delta that re-marshals, a changed hint, the
  routing threshold and the breaker.

Tolerance: exact equality everywhere (the computation is integer-only).
"""

import numpy as np
import pytest
import torch

from holo_tpu import telemetry
from holo_tpu.ops import graph as jgraph
from holo_tpu.ops.partition import PartitionedSpfEngine as JaxEngine
from holo_tpu.spf import synth as jsynth
from holo_tpu.spf.backend import TpuSpfBackend
from holo_tpu_torch import convert
from holo_tpu_torch.ops import graph as tgraph
from holo_tpu_torch.ops import partition as tp
from holo_tpu_torch.ops.spf_engine import device_graph_from_ell, shared_graph_cache
from holo_tpu_torch.spf import synth as tsynth
from holo_tpu_torch.spf.backend import ScalarSpfBackend, TorchSpfBackend

MP_FIELDS = ("parents", "pdist", "pweight", "npaths", "nh_weights")
ALL_FIELDS = ("dist", "parent", "hops", "nexthop_words") + MP_FIELDS
PLANES = ("in_src", "in_cost", "in_valid", "in_edge_id", "direct_nh_words", "is_router")
TIED = dict(n_routers=40, n_networks=6, extra_p2p=60, max_cost=4)


def tied(seed):
    """The same random topology in both packages: a tiny cost universe
    (real ECMP ties) and enough links that random cuts cut many edges."""
    return (tsynth.random_ospf_topology(seed=seed, **TIED),
            jsynth.random_ospf_topology(seed=seed, **TIED))


def assert_same(a, b, tag=""):
    for f in ALL_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        if x is None or y is None:
            assert x is None and y is None, (tag, f)
        else:
            assert x.dtype == y.dtype, (tag, f)
            np.testing.assert_array_equal(x, y, err_msg=f"{tag} {f}")


def port_backend(**kw):
    return TorchSpfBackend(device="cpu", partition_threshold=1, partition_max_part=12, **kw)


def jax_backend(**kw):
    return TpuSpfBackend(partition_threshold=1, partition_max_part=12, **kw)


def jax_delta_count(kind: str, path: str) -> float:
    return telemetry.snapshot(prefix="holo_spf_delta").get(
        f"holo_spf_delta_total{{kind={kind},path={path}}}", 0.0)


def cuts(seed, t_topo):
    """The flat greedy cut and an adversarial random vertex -> part map."""
    rng = np.random.default_rng(seed)
    return {"flat": tgraph.partition_topology(t_topo, max_part=12),
            "random": rng.integers(0, 4, t_topo.n_vertices).astype(np.int32)}


@pytest.fixture(scope="module")
def mono():
    return TorchSpfBackend(device="cpu")


# -- the cut, the plan, the planes ----------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_partition_topology_equals_jax(seed):
    t, j = tied(seed)
    for mp in (4, 12, 40):
        a = tgraph.partition_topology(t, max_part=mp)
        assert np.array_equal(a, jgraph.partition_topology(j, max_part=mp))
        assert np.array_equal(a, tgraph.partition_topology(t, max_part=mp))
        assert a.min() == 0 and (np.bincount(a) > 0).all()
    hint = np.random.default_rng(seed).integers(0, 5, t.n_vertices).astype(np.int32)
    t.partition_hint, j.partition_hint = hint, hint.copy()
    assert np.array_equal(tgraph.partition_topology(t), jgraph.partition_topology(j))
    t.partition_hint = hint[:-1]
    with pytest.raises(ValueError):
        tgraph.partition_topology(t)


@pytest.mark.parametrize("cut", ["flat", "random", "hint"])
def test_plan_and_planes_equal_jax(cut):
    """build_plan equals JAX's field for field; the port's stacked planes
    equal JAX's PartPlanes brought across by convert, slot for slot."""
    t, j = tied(3)
    part_of = None
    if cut == "hint":
        hint = (np.arange(t.n_vertices) * 5 // t.n_vertices).astype(np.int32)
        t.partition_hint, j.partition_hint = hint, hint.copy()
    elif cut == "random":
        part_of = cuts(3, t)["random"]
    jres = JaxEngine().marshal(j, 64, max_part=12, part_of=part_of)
    plan = tp.build_plan(t, max_part=12, part_of=part_of)
    g = device_graph_from_ell(tp.marshal_partitions(t, plan, 64), "cpu")
    jplan = jres.plan
    for f in ("n_vertices", "n_parts", "root", "l_pad", "k_pad", "b_pad"):
        assert getattr(plan, f) == getattr(jplan, f), f
    for f in ("part_of", "skel", "skel_pos", "cut_src", "cut_dst", "cut_cost", "cut_eid"):
        np.testing.assert_array_equal(getattr(plan, f), getattr(jplan, f), err_msg=f)
    for f in ("halo", "bnd", "bnd_skel", "halo_skel"):
        assert all(np.array_equal(a, b) for a, b in zip(getattr(plan, f), getattr(jplan, f)))
    assert all(np.array_equal(a, np.sort(b)) for a, b in zip(plan.verts, jplan.verts))
    cplan, cg = convert.partition_from_numpy(
        vars(jplan), {k: np.asarray(v) for k, v in jres.planes._asdict().items()}, "cpu")
    for f in PLANES:
        assert torch.equal(getattr(g, f), getattr(cg, f)), f
    for f in ("base", "gid", "pinned", "row_of"):
        np.testing.assert_array_equal(getattr(plan, f), getattr(cplan, f), err_msg=f)
    # No slot leaves its part: every source row lies in its row's part.
    part_of_row = np.repeat(np.arange(plan.n_parts), np.diff(plan.base))
    src = g.in_src.numpy()
    assert (part_of_row[src] == part_of_row[:, None]).all()
    assert not g.in_valid.numpy()[plan.pinned].any(), "a halo row carries a slot"


@pytest.mark.parametrize("max_iters", [None, 1, 3])
@pytest.mark.parametrize("cut", ["flat", "random"])
def test_phases_on_jax_plan(cut, max_iters):
    """On JAX's own plan and planes (convert): the boundary tables at root
    chunks 1, 16 and all, the skeleton distances and the final distances
    equal the resident state of JAX's solve."""
    t, j = tied(8)
    part_of = None if cut == "flat" else cuts(8, t)["random"]
    jeng = JaxEngine(max_iters=max_iters)
    jres = jeng.marshal(j, 64, max_part=12, part_of=part_of)
    jeng.solve(j, jres, None, 1)
    plan, g = convert.partition_from_numpy(
        vars(jres.plan), {k: np.asarray(v) for k, v in jres.planes._asdict().items()}, "cpu")
    limit = plan.l_pad if max_iters is None else max_iters
    st = tp.part_stack(plan, g, range(plan.n_parts))
    for chunk in (1, 16, None):
        btab, _ = tp.boundary_tables(plan, st, limit, chunk)
        np.testing.assert_array_equal(btab, jres.btab, err_msg=f"btab chunk {chunk}")
    skel = tp.skeleton_solve(plan, btab)
    np.testing.assert_array_equal(skel, jres.skel_dist)
    dist, _ = tp.final_distances(plan, st, skel, limit)
    own = np.asarray(jres.own)[: plan.n_parts]
    want = np.full(plan.n_vertices, -1, np.int64)
    want[np.asarray(jres.gid)[: plan.n_parts][own]] = jres.dist_loc[own]
    got = np.full(plan.n_vertices, -2, np.int64)
    got[plan.gid[~plan.pinned]] = dist[:, 0].numpy()[~plan.pinned]
    np.testing.assert_array_equal(got, want)


# -- the backend against JAX and the oracle -------------------------------------


@pytest.fixture(scope="module")
def jax_part():
    return jax_backend()


@pytest.mark.parametrize("kp", [1, 2, 8])
@pytest.mark.parametrize("seed", [5, 6])
def test_backend_equals_jax_and_oracle(seed, kp, jax_part, mono):
    t, j = tied(seed)
    be = port_backend()
    got = be.compute(t, multipath_k=kp)
    assert be.partition_residents(), "the dispatch did not take the partitioned path"
    assert_same(got, jax_part.compute(j, multipath_k=kp), ("jax", seed, kp))
    assert_same(got, ScalarSpfBackend().compute(t, multipath_k=kp), ("oracle", seed, kp))
    assert_same(got, mono.compute(t, multipath_k=kp), ("monolithic", seed, kp))
    if kp > 1:  # real ECMP: some vertex has several equal-cost parents
        ecmp = (got.pdist == got.dist[:, None]) & (got.parents < t.n_vertices)
        assert (ecmp.sum(axis=1) > 1).any()


@pytest.mark.parametrize("kp", [1, 2])
def test_whatif_masks(kp, jax_part):
    t, j = tied(7)
    masks = jsynth.whatif_link_failure_masks(j, 6, seed=7)
    got = port_backend().compute_whatif(t, masks, multipath_k=kp)
    want = jax_part.compute_whatif(j, masks, multipath_k=kp)
    ref = ScalarSpfBackend().compute_whatif(t, masks, multipath_k=kp)
    assert len(got) == 6
    for i, (a, b, c) in enumerate(zip(got, want, ref)):
        assert_same(a, b, ("jax", i))
        assert_same(a, c, ("oracle", i))


@pytest.mark.parametrize("kp", [1, 8])
@pytest.mark.parametrize("cut", ["flat", "random"])
@pytest.mark.parametrize("seed", range(3))
def test_engine_cuts(seed, cut, kp):
    """Engine level, the cut given: the greedy cut and adversarial random
    vertex -> part maps (large skeletons) against JAX's engine on the same
    cut and the oracle."""
    t, j = tied(seed)
    part_of = cuts(seed, t)[cut]
    eng = tp.PartitionedSpfEngine("cpu")
    out = eng.solve(t, eng.marshal(t, 64, part_of=part_of), None, kp)
    jeng = JaxEngine()
    jout = jeng.solve(j, jeng.marshal(j, 64, part_of=part_of), None, kp)
    ref = ScalarSpfBackend().compute(t, multipath_k=kp)
    for f in ALL_FIELDS:
        if f in jout:
            np.testing.assert_array_equal(out[f], jout[f], err_msg=f"jax {f}")
            np.testing.assert_array_equal(out[f], getattr(ref, f), err_msg=f"oracle {f}")


@pytest.mark.parametrize("chunk", [1, 16, None])
def test_root_chunk_sizes(chunk):
    """The boundary solve's lanes in chunks of 1, 16 or all: equal results
    (each lane's fixpoint is its own)."""
    t, _ = tied(9)
    eng = tp.PartitionedSpfEngine("cpu", root_chunk=chunk)
    res = eng.marshal(t, 64, part_of=cuts(9, t)["random"])
    out = eng.solve(t, res, None, 2)
    assert res.rounds["bdist"] > 0
    ref = ScalarSpfBackend().compute(t, multipath_k=2)
    for f in ALL_FIELDS:
        np.testing.assert_array_equal(out[f], getattr(ref, f), err_msg=f)


@pytest.mark.parametrize("kp", [1, 2])
@pytest.mark.parametrize("max_iters", [0, 1, 3])
def test_max_iters_truncation(max_iters, kp):
    """Truncated fixpoints stop where JAX's do, in every phase (the oracle
    does not truncate, so JAX alone is the reference); a mask too."""
    t, j = tied(5)
    be, jb = port_backend(max_iters=max_iters), jax_backend(max_iters=max_iters)
    assert_same(be.compute(t, multipath_k=kp), jb.compute(j, multipath_k=kp), "compute")
    masks = jsynth.whatif_link_failure_masks(j, 2, seed=5)
    for a, b in zip(be.compute_whatif(t, masks, multipath_k=kp),
                    jb.compute_whatif(j, masks, multipath_k=kp)):
        assert_same(a, b, "whatif")


def test_native_hint_end_to_end():
    """A native hint drives the cut (4 parts, as stamped) and rides a delta
    chain: the clone keeps the hint, the delta links, the step is served
    incrementally."""
    t = tsynth.grid_topology(6, 8, max_cost=6, seed=29)
    j = jsynth.grid_topology(6, 8, max_cost=6, seed=29)
    hint = (np.arange(t.n_vertices) * 4 // t.n_vertices).astype(np.int32)
    t.partition_hint, j.partition_hint = hint, hint.copy()
    be = TorchSpfBackend(device="cpu", partition_threshold=1)
    jb = TpuSpfBackend(partition_threshold=1)
    assert_same(be.compute(t), jb.compute(j), "hint")
    assert_same(be.compute(t), ScalarSpfBackend().compute(t), "hint oracle")
    (res,) = be.partition_residents()
    assert res.plan.n_parts == 4
    nxt = tsynth.clone_topology(t, cost={0: int(t.edge_cost[0]) + 3})
    jnxt = jsynth.clone_topology(j, cost={0: int(j.edge_cost[0]) + 3})
    assert np.array_equal(nxt.partition_hint, hint)
    nxt.link_delta(tgraph.diff_topologies(t, nxt))
    jnxt.link_delta(jgraph.diff_topologies(j, jnxt))
    be.part_stats = {}
    assert_same(be.compute(nxt), jb.compute(jnxt), "hint-delta")
    assert be.part_stats["path"] == "incremental"


@pytest.mark.parametrize("shape", ["disconnected", "tiny", "one-vertex"])
def test_disconnected_and_tiny_graphs(shape):
    """Unreachable components (INF, parent N, hops N + 1), a part with no cut
    edge, graphs smaller than a part, a lone vertex."""
    if shape == "disconnected":
        g = tsynth.grid_topology(3, 4, max_cost=5, seed=31)
        kw = dict(n_vertices=g.n_vertices + 5,
                  is_router=np.concatenate([g.is_router, np.ones(5, bool)]),
                  edge_src=g.edge_src, edge_dst=g.edge_dst, edge_cost=g.edge_cost,
                  edge_direct_atom=g.edge_direct_atom, root=g.root)
    elif shape == "tiny":
        g = tsynth.grid_topology(2, 2, max_cost=3, seed=37)
        kw = dict(n_vertices=4, is_router=g.is_router, edge_src=g.edge_src,
                  edge_dst=g.edge_dst, edge_cost=g.edge_cost,
                  edge_direct_atom=g.edge_direct_atom, root=g.root)
    else:
        kw = dict(n_vertices=1, is_router=np.ones(1, bool), edge_src=np.zeros(0, np.int32),
                  edge_dst=np.zeros(0, np.int32), edge_cost=np.zeros(0, np.int32), root=0)
    t, j = tgraph.Topology(**kw), jgraph.Topology(**kw)
    be = TorchSpfBackend(device="cpu", partition_threshold=1, partition_max_part=4)
    jb = TpuSpfBackend(partition_threshold=1, partition_max_part=4)
    for kp in (1, 2):
        got = be.compute(t, multipath_k=kp)
        assert_same(got, jb.compute(j, multipath_k=kp), (shape, kp))
        assert_same(got, ScalarSpfBackend().compute(t, multipath_k=kp), (shape, kp))
    if shape == "disconnected":
        assert (got.dist[-5:] == int(tgraph.INF)).all() and (got.hops[-5:] == t.n_vertices + 1).all()


def _chain_picks(plan, topo):
    cutset = set(plan.cut_eid.tolist())
    intra = [e for e in range(topo.n_edges) if e not in cutset]
    cut = sorted(cutset)
    return cutset, [intra[0], cut[0], intra[len(intra) // 2], cut[-1], intra[-1], cut[len(cut) // 2]]


@pytest.mark.parametrize("kp", [1, 2])
def test_delta_chain_across_cut_edges(kp):
    """Six linked weight events, intra-part and on cut edges: every step
    served incrementally, equal to JAX's partitioned chain and the oracle,
    each step's disposition equal to JAX's; an intra-part step re-solves
    fewer parts than the cut has."""
    t, j = tied(11)
    be, jb = port_backend(), jax_backend()
    be.part_stats = {}
    assert_same(be.compute(t, multipath_k=kp), jb.compute(j, multipath_k=kp), "base")
    (res,) = be.partition_residents()
    assert res.plan.n_parts >= 3
    cutset, picks = _chain_picks(res.plan, t)
    bounded = False
    cur, jcur = t, j
    for step, e in enumerate(picks):
        cost = {e: int(cur.edge_cost[e]) + 1 + step}
        nxt, jnxt = tsynth.clone_topology(cur, cost=cost), jsynth.clone_topology(jcur, cost=cost)
        nxt.link_delta(tgraph.diff_topologies(cur, nxt))
        jnxt.link_delta(jgraph.diff_topologies(jcur, jnxt))
        before = dict(be.delta_paths)
        jbefore = jax_delta_count("weight", "partitioned-incremental")
        got = be.compute(nxt, multipath_k=kp)
        assert_same(got, jb.compute(jnxt, multipath_k=kp), ("jax", step))
        assert_same(got, ScalarSpfBackend().compute(nxt, multipath_k=kp), ("oracle", step))
        assert be.part_stats["path"] == "incremental", (step, be.part_stats)
        moved = be.delta_paths[("weight", "partitioned-incremental")] - before.get(
            ("weight", "partitioned-incremental"), 0)
        assert moved == 1 == jax_delta_count("weight", "partitioned-incremental") - jbefore
        if e not in cutset and be.part_stats["resolved"] < res.plan.n_parts:
            bounded = True
        cur, jcur = nxt, jnxt
    assert bounded, "no intra-part step re-solved a strict subset of the parts"


@pytest.mark.parametrize("where", ["cut", "intra"])
def test_structural_delta(where):
    """A link removed on a cut edge changes the halo and skeleton: the
    resident refuses it and the dispatch marshals again; removed inside a
    part, the delta is served in place.  Both equal the oracle and JAX."""
    t, j = tied(13)
    be, jb = port_backend(), jax_backend()
    be.part_stats = {}
    be.compute(t)
    jb.compute(j)
    (res,) = be.partition_residents()
    cutset = set(res.plan.cut_eid.tolist())
    e = (int(res.plan.cut_eid[0]) if where == "cut"
         else next(e for e in range(t.n_edges) if e not in cutset))
    s, d = int(t.edge_src[e]), int(t.edge_dst[e])
    keep = ~(((t.edge_src == s) & (t.edge_dst == d)) | ((t.edge_src == d) & (t.edge_dst == s)))
    nxt, jnxt = tsynth.clone_topology(t, keep=keep), jsynth.clone_topology(j, keep=keep)
    nxt.link_delta(tgraph.diff_topologies(t, nxt))
    jnxt.link_delta(jgraph.diff_topologies(j, jnxt))
    got = be.compute(nxt)
    assert_same(got, ScalarSpfBackend().compute(nxt), where)
    assert_same(got, jb.compute(jnxt), where)
    if where == "cut":
        assert be.part_stats["path"] == "marshal" and be.part_stats["refused"] == "cut-struct"
        assert be.delta_paths[("struct", "partitioned-full")] == 1
    else:
        assert be.part_stats["path"] == "incremental"
        (res,) = be.partition_residents()
        assert res.ids_stale
        # A mask needs edge ids: the stale resident is marshaled again.
        masks = jsynth.whatif_link_failure_masks(jnxt, 2, seed=1)
        for a, b in zip(be.compute_whatif(nxt, masks), jb.compute_whatif(jnxt, masks)):
            assert_same(a, b, "whatif after struct")
        (fresh,) = be.partition_residents()
        assert fresh is not res and not fresh.ids_stale


@pytest.mark.parametrize("how", ["clone", "in-place"])
def test_changed_hint_remarshals(how):
    """A topology whose partition hint changes is not delta-linked; the
    resident is marshaled again from the new hint and none serves the old
    cut."""
    t = tsynth.grid_topology(6, 8, max_cost=6, seed=41)
    t.partition_hint = (np.arange(t.n_vertices) * 4 // t.n_vertices).astype(np.int32)
    be = TorchSpfBackend(device="cpu", partition_threshold=1)
    be.compute(t)
    hint = (np.arange(t.n_vertices) * 3 // t.n_vertices).astype(np.int32)
    if how == "clone":
        nxt = tsynth.clone_topology(t)
        nxt.partition_hint = hint
        assert tgraph.diff_topologies(t, nxt) is None
    else:
        nxt = t
        nxt.partition_hint = hint  # the same identity: no touch(), the hint check alone
    be.part_stats = {}
    assert_same(be.compute(nxt), ScalarSpfBackend().compute(nxt), how)
    (res,) = be.partition_residents()
    assert be.part_stats["path"] == "marshal" and res.plan.n_parts == 3
    assert np.array_equal(res.hint, hint)


def test_routing_matches_jax():
    """Partitioned where JAX's backend is: at or past the threshold, never
    under ``engine="blocked"``; ``compute_partitioned`` always."""
    t, j = tied(2)
    for threshold, want in ((t.n_vertices, True), (t.n_vertices + 1, False)):
        be = TorchSpfBackend(device="cpu", partition_threshold=threshold)
        jb = TpuSpfBackend(partition_threshold=threshold)
        be.compute(t)
        jb.compute(j)
        assert bool(be.partition_residents()) == bool(jb.partition_residents()) == want
    blocked = TorchSpfBackend(device="cpu", engine="blocked", partition_threshold=1)
    assert_same(blocked.compute(t), ScalarSpfBackend().compute(t), "blocked")
    assert not blocked.partition_residents()
    plain = TorchSpfBackend(device="cpu")
    assert_same(plain.compute_partitioned(t, multipath_k=2),
                ScalarSpfBackend().compute(t, multipath_k=2), "explicit")
    assert len(plain.partition_residents()) == 1
    assert set(plain.partition_stats().popitem()[1]) >= {"parts", "skeleton", "resolved"}
    # Residents live in the device's shared cache, per backend.
    assert any(k[0] == plain._part_ns for k in shared_graph_cache("cpu").partitioned_entries())


def test_breaker_serves_the_oracle_on_the_cpu(monkeypatch):
    """A failing partitioned solve is counted by the breaker; on the CPU
    with no max_iters the oracle serves it (bit-identical), under max_iters
    it re-raises."""
    t, _ = tied(17)

    def boom(*args, **kw):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(tp.PartitionedSpfEngine, "solve", boom)
    be = port_backend()
    assert_same(be.compute(t, multipath_k=2), ScalarSpfBackend().compute(t, multipath_k=2),
                "fallback")
    snap = be.breaker.snapshot()
    assert sum(snap["failures"].values()) == 1 and sum(snap["fallbacks"].values()) == 1
    with pytest.raises(RuntimeError):
        port_backend(max_iters=3).compute(t)
