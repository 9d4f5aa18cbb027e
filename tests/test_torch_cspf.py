"""CSPF in the port against holo_tpu's ``CspfEngine``, bit for bit.

Every case of tests/test_cspf.py runs through both engines on the same
topology and attributes (built once with numpy from a seed): the paths
(vertex lists) and costs must be equal, and each case's own expectation
must hold.  Beyond it: ``constraint_masks`` and the engine's
``device_constraint_masks`` equal JAX's plane for plane, a
TE metric replaces the IGP cost, a batch of requests like the bench's
(affinity from 8 bits, bandwidth 1..10, ``exclude_any`` 0..3) on a small fat
tree, and every cost held to the scalar oracle on the request's mask.

Tolerance: exact equality (integer distances, identical first-parent walks).
"""

import numpy as np
import pytest
import torch

from holo_tpu.ops import cspf as jcspf
from holo_tpu.ops import graph as jgraph
from holo_tpu.spf import synth as jsynth
from holo_tpu_torch.ops import cspf as tcspf
from holo_tpu_torch.ops import graph as tgraph
from holo_tpu_torch.spf import synth as tsynth
from holo_tpu_torch.spf.backend import ScalarSpfBackend

RED, BLUE = 0x1, 0x2


def diamond():
    """0 -> {1 (fast, red), 2 (slow, blue)} -> 3, in both packages."""
    kw = dict(n_vertices=4, is_router=np.ones(4, bool),
              edge_src=np.array([0, 1, 0, 2, 1, 3, 2, 3], np.int32),
              edge_dst=np.array([1, 0, 2, 0, 3, 1, 3, 2], np.int32),
              edge_cost=np.array([1, 1, 5, 5, 1, 1, 5, 5], np.int32), root=0)
    t, j = tgraph.Topology(**kw), jgraph.Topology(**kw)
    tsynth.assign_direct_atoms(t)
    jsynth.assign_direct_atoms(j)
    affinity = np.array([RED, RED, BLUE, BLUE, RED, RED, BLUE, BLUE], np.uint32)
    bandwidth = np.array([10.0, 10.0, 100.0, 100.0, 10.0, 10.0, 100.0, 100.0])
    return t, j, affinity, bandwidth


def engines(t, j, affinity, bandwidth, te_metric=None):
    return (tcspf.CspfEngine(t, tcspf.LinkAttrs(affinity, bandwidth, te_metric), device="cpu"),
            jcspf.CspfEngine(j, jcspf.LinkAttrs(affinity, bandwidth, te_metric)))


def both(t_eng, j_eng, cons: list, dsts: list) -> list:
    """The port's paths, after requiring them equal to JAX's."""
    got = t_eng.compute([tcspf.Constraint(**c) for c in cons], dsts)
    want = j_eng.compute([jcspf.Constraint(**c) for c in cons], dsts)
    assert len(got) == len(want) == len(dsts)
    for a, b in zip(got, want):
        assert (a.dst, a.cost, a.vertices) == (b.dst, b.cost, b.vertices)
    return got


# The cases of tests/test_cspf.py on the diamond: (constraints, destinations,
# expected costs, expected vertex lists or None where the case does not fix them).
DIAMOND_CASES = {
    "unconstrained": ([{}], [3], [2], [[0, 1, 3]]),
    "exclude-affinity": ([{"exclude_any": RED}], [3], [10], [[0, 2, 3]]),
    "bandwidth": ([{"min_bandwidth": 50.0}], [3], [None], [[0, 2, 3]]),
    "bandwidth-impossible": ([{"min_bandwidth": 1000.0}], [3], [None], [[]]),
    "batched-mixed": ([{}, {"exclude_any": RED}, {"include_any": RED},
                       {"max_link_metric": 1}], [3, 3, 3, 3], [2, 10, 2, 2],
                      [None, [0, 2, 3], None, [0, 1, 3]]),
}


@pytest.mark.parametrize("case", sorted(DIAMOND_CASES))
def test_diamond_cases(case):
    cons, dsts, costs, paths = DIAMOND_CASES[case]
    t_eng, j_eng = engines(*diamond())
    got = both(t_eng, j_eng, cons, dsts)
    for p, cost, verts in zip(got, costs, paths):
        if case == "bandwidth-impossible":
            assert p.cost is None and p.vertices == []
            continue
        if cost is not None:
            assert p.cost == cost
        if verts is not None:
            assert p.vertices == verts


def test_distances_match_scalar_on_random_graph():
    """The masked SSSP under a constraint equals the scalar reference on the
    same mask (tests/test_cspf.py's random case)."""
    kw = dict(n_routers=40, n_networks=8, extra_p2p=60, seed=4)
    t, j = tsynth.random_ospf_topology(**kw), jsynth.random_ospf_topology(**kw)
    rng = np.random.default_rng(7)
    affinity = rng.integers(0, 4, t.n_edges).astype(np.uint32)
    bandwidth = rng.uniform(1, 100, t.n_edges)
    cons = {"exclude_any": 0x1, "min_bandwidth": 20.0}
    masks = tcspf.constraint_masks(t, tcspf.LinkAttrs(affinity, bandwidth),
                                   [tcspf.Constraint(**cons)])
    dsts = [v for v in range(t.n_vertices) if t.is_router[v]][:5]
    got = both(*engines(t, j, affinity, bandwidth), [cons] * len(dsts), dsts)
    ref = ScalarSpfBackend().compute(t, masks[0])
    for p in got:
        assert p.cost == (None if ref.dist[p.dst] >= tgraph.INF else int(ref.dist[p.dst]))


@pytest.mark.parametrize("seed", [0, 1])
def test_constraint_masks_equal_jax(seed):
    kw = dict(n_routers=30, n_networks=6, extra_p2p=40, seed=seed)
    t, j = tsynth.random_ospf_topology(**kw), jsynth.random_ospf_topology(**kw)
    rng = np.random.default_rng(seed)
    affinity = rng.integers(0, 16, t.n_edges).astype(np.uint32)
    bandwidth = rng.uniform(1, 10, t.n_edges)
    te = rng.integers(1, 20, t.n_edges).astype(np.int32)
    cons = [dict(include_any=int(rng.integers(0, 16)), exclude_any=int(rng.integers(0, 4)),
                 min_bandwidth=float(rng.uniform(0, 5)),
                 max_link_metric=None if i % 2 else int(rng.integers(1, 20)))
            for i in range(12)]
    for metric in (None, te):
        a = tcspf.constraint_masks(t, tcspf.LinkAttrs(affinity, bandwidth, metric),
                                   [tcspf.Constraint(**c) for c in cons])
        b = jcspf.constraint_masks(j, jcspf.LinkAttrs(affinity, bandwidth, metric),
                                   [jcspf.Constraint(**c) for c in cons])
        assert a.dtype == b.dtype and np.array_equal(a, b)
        d = tcspf.device_constraint_masks(t, tcspf.LinkAttrs(affinity, bandwidth, metric),
                                          [tcspf.Constraint(**c) for c in cons], "cpu")
        assert d.dtype == torch.bool and np.array_equal(d.numpy(), b)


def test_te_metric_replaces_igp_cost():
    """TE metrics swap the diamond's preference: the blue side is cheaper."""
    t, j, affinity, bandwidth = diamond()
    te = np.array([9, 9, 1, 1, 9, 9, 1, 1], np.int32)
    got = both(*engines(t, j, affinity, bandwidth, te), [{}, {"max_link_metric": 1}], [3, 3])
    assert got[0].cost == 2 and got[0].vertices == [0, 2, 3]
    assert got[1].cost == 2 and got[1].vertices == [0, 2, 3]


def test_bench_shaped_batch_on_a_fat_tree():
    """Requests drawn as the bench draws them (affinity 8 bits, bandwidth
    1..10, exclude_any 0..3, min_bandwidth below 2, random destinations) on
    a k=6 fat tree: paths equal JAX's, costs equal the oracle on each mask,
    and each path is a chain of the request's usable edges."""
    t, j = tsynth.fat_tree_topology(k=6, seed=0), jsynth.fat_tree_topology(k=6, seed=0)
    rng = np.random.default_rng(7)
    affinity = rng.integers(0, 2**8, t.n_edges, dtype=np.uint32)
    bandwidth = rng.uniform(1.0, 10.0, t.n_edges)
    cons = [dict(exclude_any=int(rng.integers(0, 4)),
                 min_bandwidth=float(rng.uniform(0.0, 2.0))) for _ in range(24)]
    dsts = [int(d) for d in rng.integers(0, t.n_vertices, 24)]
    got = both(*engines(t, j, affinity, bandwidth), cons, dsts)
    masks = tcspf.constraint_masks(t, tcspf.LinkAttrs(affinity, bandwidth),
                                   [tcspf.Constraint(**c) for c in cons])
    oracle = ScalarSpfBackend()
    found = 0
    for b, p in enumerate(got):
        ref = oracle.compute(t, masks[b])
        assert p.cost == (None if ref.dist[p.dst] >= tgraph.INF else int(ref.dist[p.dst]))
        if p.cost is None:
            continue
        found += 1
        assert p.vertices[0] == t.root and p.vertices[-1] == p.dst
        cost = 0
        for u, v in zip(p.vertices, p.vertices[1:]):
            e = np.nonzero((t.edge_src == u) & (t.edge_dst == v) & masks[b])[0]
            cost += int(t.edge_cost[e].min())
        assert cost == p.cost
    assert found > 0


def test_requests_must_pair_up():
    t_eng, _ = engines(*diamond())
    with pytest.raises(ValueError):
        t_eng.compute([tcspf.Constraint()], [3, 3])
    assert t_eng.compute([], []) == []
