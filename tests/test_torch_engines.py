"""The port's fused, packed and hybrid engines against the JAX package's, bit
for bit (tolerance: exact int32 on dist, parent, hops and next-hop words).

The four formulations agree only at the fixpoint; truncated runs differ by
engine.  So each port engine is held to its own JAX engine:

- ``TorchSpfBackend(one_engine=e).compute`` against
  ``TpuSpfBackend(one_engine=e)`` on JAX-CPU, on two random OSPF shapes at
  three seeds, with ``max_iters`` None, 0, 1, 2 and 4 (and the scalar oracle
  at convergence);
- ``compute_whatif`` over 8 masks, at the same limits;
- ``fused_round_plain`` against one application of JAX's round, driven round
  by round: the port's round from JAX's state after r - 1 rounds equals JAX's
  after r, in both layouts, at one lane and at 8 masked lanes, and its
  frontier marks the lanes where the two states differ;
- the lone router and the disconnected root of ``tests/test_spf_parity.py``;
- ``one_engine="tropical"`` at ``multipath_k`` > 1 computes what
  ``holo_tpu``'s ``mp_tropical`` computes (its single path is held in
  tests/test_torch_tropical.py, its multipath program in
  tests/test_torch_tropical_mp.py), and ``spf_whatif_batch`` names the
  tropical module for ``engine="tropical"``.
"""

import jax
import numpy as np
import pytest
import torch

from holo_tpu.ops import graph as jgraph
from holo_tpu.ops import spf_engine as je
from holo_tpu.spf import synth as jsynth
from holo_tpu.spf.backend import ScalarSpfBackend as JScalar
from holo_tpu.spf.backend import TpuSpfBackend
from holo_tpu_torch.kernels import ell
from holo_tpu_torch.ops import graph as tgraph
from holo_tpu_torch.ops import spf_engine as te
from holo_tpu_torch.spf import synth as tsynth
from holo_tpu_torch.spf.backend import ScalarSpfBackend, TorchSpfBackend

FIELDS = ("dist", "parent", "hops", "nexthop_words")
ENGINES = ("fused", "packed", "hybrid")
LIMITS = (None, 0, 1, 2, 4)
SHAPES = {
    "small": dict(n_routers=40, n_networks=8, extra_p2p=30),
    "wide": dict(n_routers=90, n_networks=20, extra_p2p=120, max_cost=4),
}
INF = 1 << 30


def _same(a, b, label):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, (label, f)
        np.testing.assert_array_equal(x, y, err_msg=f"{label} {f}")


def _topos(**kw):
    return tsynth.random_ospf_topology(**kw), jsynth.random_ospf_topology(**kw)


@pytest.mark.parametrize("max_iters", LIMITS)
@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("engine", ENGINES)
def test_compute_matches_the_jax_engine(engine, shape, seed, max_iters):
    tt, jt = _topos(**SHAPES[shape], seed=seed)
    got = TorchSpfBackend(one_engine=engine, device="cpu", max_iters=max_iters,
                          incremental=False).compute(tt)
    jax_be = TpuSpfBackend(one_engine=engine, max_iters=max_iters, incremental=False)
    _same(got, jax_be.compute(jt), f"{engine} jax")
    if max_iters is None:
        _same(got, JScalar().compute(jt), f"{engine} jax scalar")
        _same(got, ScalarSpfBackend().compute(tt), f"{engine} port scalar")
        _same(got, TorchSpfBackend(device="cpu").compute(tt), f"{engine} seq")


@pytest.mark.parametrize("max_iters", LIMITS)
@pytest.mark.parametrize("engine", ENGINES)
def test_compute_whatif_matches_the_jax_engine(engine, max_iters):
    tt, jt = _topos(**SHAPES["wide"], seed=5)
    masks = jsynth.whatif_link_failure_masks(jt, 8, seed=6)
    got = TorchSpfBackend(one_engine=engine, device="cpu", max_iters=max_iters,
                          incremental=False).compute_whatif(tt, masks)
    want = TpuSpfBackend(one_engine=engine, max_iters=max_iters,
                         incremental=False).compute_whatif(jt, masks)
    assert len(got) == len(want) == 8
    for b, (x, y) in enumerate(zip(got, want)):
        _same(x, y, f"{engine} b={b}")
    if max_iters is None:
        seq = TorchSpfBackend(device="cpu").compute_whatif(tt, masks)
        for b, (x, y) in enumerate(zip(got, seq)):
            _same(x, y, f"{engine} seq b={b}")


_FUSED_BATCH = jax.jit(
    lambda g, r, m, mi: jax.vmap(lambda mm: je.spf_one_fused(g, r, mm, mi))(m))


def _jax_state(jg, root, masks, rounds: int):
    """JAX's fused planes after ``rounds`` rounds, lanes minor: (dist, hops,
    nh [N, W, B], parent).  Its hops are masked to N + 1 where dist is INF,
    which a round leaves them anyway (no DAG slot, so no parent)."""
    out = _FUSED_BATCH(jg, root, masks, rounds)
    nh = np.asarray(out.nexthops).view(np.int32)
    return (torch.from_numpy(np.asarray(out.dist).T.copy()),
            torch.from_numpy(np.asarray(out.hops).T.copy()),
            torch.from_numpy(nh.transpose(1, 2, 0).copy()),
            torch.from_numpy(np.asarray(out.parent).T.copy()))


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("lanes", [1, 8])
def test_fused_round_plain_is_one_jax_round(lanes, packed):
    tt, jt = _topos(**SHAPES["wide"], seed=7)
    jg = je.device_graph_from_ell(jgraph.build_ell(jt, n_atoms=64))
    tg = te.device_graph_from_ell(tgraph.build_ell(tt, n_atoms=64), device="cpu")
    masks = jsynth.whatif_link_failure_masks(jt, lanes, seed=8)
    if lanes == 1:
        masks[:] = True
    mask = te.pack_edge_masks(masks, "cpu")
    p = te.lane_planes(tg, mask)
    roots = torch.full((lanes,), tt.root, dtype=torch.int32)
    inc = tg.is_router.to(torch.int32)
    rounds = 0
    for r in range(1, 3 * tt.n_vertices + 6):
        dist, hops, nh, _ = _jax_state(jg, jt.root, masks, r - 1)
        state = ell.fused_state(dist, hops, nh, packed)
        new, parent, changed, front = ell.fused_round_plain(*p, tg.direct_nh_words, inc, roots,
                                                            state)
        want = _jax_state(jg, jt.root, masks, r)
        got = (*ell.fused_planes(new), parent)
        for name, a, b in zip(("dist", "hops", "nh", "parent"), got, want):
            assert torch.equal(a, b), f"round {r} {name}"
        lanes_moved = (dist != want[0]) | (hops != want[1]) | (nh != want[2]).any(1)
        moved = bool(lanes_moved.any())
        assert bool(changed) == moved, f"round {r} changed flag"
        assert torch.equal(front, ell.pack_lane_bits(lanes_moved)), f"round {r} frontier"
        rounds = r
        if not moved:
            break
    assert rounds > 3


def test_fused_state_layouts_round_trip():
    rng = np.random.default_rng(0)
    planes = (torch.from_numpy(rng.integers(0, 99, (5, 3), dtype=np.int32)),
              torch.from_numpy(rng.integers(0, 99, (5, 3), dtype=np.int32)),
              torch.from_numpy(rng.integers(-9, 99, (5, 2, 3), dtype=np.int32)))
    packed = ell.fused_state(*planes, True)
    assert packed.shape == (5, 3, 4) and packed.is_contiguous()
    for a, b in zip(ell.fused_planes(packed), planes):
        assert torch.equal(a, b)
    assert ell.fused_state(*planes, False) is not None
    assert all(a is b for a, b in zip(ell.fused_planes(planes), planes))


def test_lone_router_edgeless():
    kw = dict(n_vertices=1, is_router=np.ones(1, bool), edge_src=np.zeros(0, np.int32),
              edge_dst=np.zeros(0, np.int32), edge_cost=np.zeros(0, np.int32), root=0)
    from holo_tpu.ops.graph import Topology as JTopology

    tt, jt = tgraph.Topology(**kw), JTopology(**kw)
    for engine in ENGINES:
        got = TorchSpfBackend(one_engine=engine, device="cpu").compute(tt)
        _same(got, TpuSpfBackend(one_engine=engine).compute(jt), f"{engine} jax")
        _same(got, ScalarSpfBackend().compute(tt), f"{engine} scalar")
        assert TorchSpfBackend(one_engine=engine, device="cpu").compute_whatif(
            tt, np.ones((2, 0), bool))[1].dist.tolist() == [0]


@pytest.mark.parametrize("engine", ENGINES)
def test_disconnected_component_unreachable(engine):
    tt, jt = _topos(n_routers=8, n_networks=2, seed=1)
    mask = (tt.edge_src != tt.root) & (tt.edge_dst != tt.root)
    got = TorchSpfBackend(one_engine=engine, device="cpu").compute(tt, mask)
    _same(got, TpuSpfBackend(one_engine=engine).compute(jt, mask), f"{engine} jax")
    _same(got, JScalar().compute(jt, mask), f"{engine} scalar")
    unreachable = np.arange(tt.n_vertices) != tt.root
    assert (got.dist[unreachable] == INF).all()
    assert (got.parent[unreachable] == tt.n_vertices).all()


def test_tropical_names_a9():
    topo = tsynth.fat_tree_topology(k=4)
    be = TorchSpfBackend(one_engine="tropical", device="cpu")
    got = be.compute(topo, multipath_k=2)
    want = TpuSpfBackend(one_engine="tropical").compute(jsynth.fat_tree_topology(k=4),
                                                        multipath_k=2)
    _same(got, want, "mp_tropical")
    for f in ("parents", "pdist", "pweight", "npaths", "nh_weights"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    g = te.device_graph_from_ell(tgraph.build_ell(topo), device="cpu")
    with pytest.raises(ValueError, match="ops/tropical.py"):
        te.spf_whatif_batch(g, 0, np.ones((1, 32), bool), engine="tropical")


@pytest.mark.parametrize("engine", ENGINES)
def test_single_spf_functions_match_jax(engine):
    tt, jt = _topos(**SHAPES["small"], seed=9)
    jg = je.device_graph_from_ell(jgraph.build_ell(jt, n_atoms=64))
    tg = te.device_graph_from_ell(tgraph.build_ell(tt, n_atoms=64), device="cpu")
    mask = jsynth.whatif_link_failure_masks(jt, 3, seed=4)[2]
    for m in (None, mask):
        want = je._ONE_ENGINES[engine](jg, jt.root, _jax_mask(jt, m), None)
        got = te._ONE_ENGINES[engine](tg, tt.root, m, None)
        np.testing.assert_array_equal(got.dist.numpy(), np.asarray(want.dist))
        np.testing.assert_array_equal(got.parent.numpy(), np.asarray(want.parent))
        np.testing.assert_array_equal(got.hops.numpy(), np.asarray(want.hops))
        np.testing.assert_array_equal(got.nexthops.numpy().view(np.uint32),
                                      np.asarray(want.nexthops))


def _jax_mask(topo, mask):
    return np.ones(topo.n_edges, bool) if mask is None else mask
