"""The row frontier of ell_mp_round and the fused parent sets, on the CPU.

A round of the multipath fixpoint recomputes each value from its DAG
sources' planes of the round before.  So a lane of a row whose sources did
not change keeps its value, and ``ell_mp_round`` recomputes only the lanes
that :func:`ell.mp_row_frontier` marks: some DAG source's frontier bit is
set, or the row's own bit is set and it has no DAG slot in that lane (its
value is then a constant).  It copies the other marked lanes from its input
state and leaves the rest of its output buffer, which holds the round
before, as it is.

- a numpy walk of that rule, lane by lane, equals ``mp_round_plain`` (out
  buffer, changed flag, frontier) and the full round in every round of a
  dispatch, from fresh seeds and from stale ones, with and without the
  count and weight planes, on a k=8 fat tree and a random OSPF topology,
  with what-if masks (one root) and without (a root a lane), at 1, 5 and
  33 lanes;
- on random states (the input a full round's output), a frontier that holds
  every change, and random extra bits, gives the full round; omitting a
  changed source gives a different result, so the check can fail;
- ``mp_fixpoint`` from fresh seeds (first frontier: the root) and from a
  previous run's (first frontier: every lane) equals JAX's
  ``_mp_fixpoint`` and ``_hops_nh_fixpoint`` at ``limit`` 1, 2, 3 and
  unbounded;
- ``first_parent_sets_plain`` equals ``first_parent_plain`` plus
  ``parent_sets_plain`` on random graphs with masks, zero-cost
  network-to-router edges, parallel links and several roots, for kp 2, 4
  and 8;
- ``full_frontier`` (the first frontier of a previous run's seeds) marks
  every lane and no bit past the last.

Tolerance: exact equality everywhere (the computation is integer-only).
"""

import numpy as np
import pytest
import torch

from holo_tpu.ops import graph as jgraph
from holo_tpu.ops import spf_engine as je
from holo_tpu.spf import synth as jsynth
from holo_tpu_torch import convert
from holo_tpu_torch.kernels import ell
from holo_tpu_torch.ops import graph as tgraph
from holo_tpu_torch.ops import spf_engine as te
from holo_tpu_torch.spf import synth as tsynth

INF = 1 << 30
SAT = ell.MP_SAT
ROUNDS = 8


def _topology(mod, shape):
    if shape == "fat_tree_k8":
        return mod.fat_tree_topology(k=8)
    if shape == "parallel":
        # A tied random topology with a second edge beside every fourth one,
        # at the same cost or one more.
        base = mod.random_ospf_topology(40, n_networks=8, extra_p2p=60, max_cost=3, seed=5)
        e = np.arange(0, base.n_edges, 4)
        topo = tgraph.Topology(
            n_vertices=base.n_vertices, is_router=base.is_router,
            edge_src=np.r_[base.edge_src, base.edge_src[e]],
            edge_dst=np.r_[base.edge_dst, base.edge_dst[e]],
            edge_cost=np.r_[base.edge_cost, base.edge_cost[e] + (e // 4) % 2],
            root=base.root)
        mod.assign_direct_atoms(topo)
        return topo
    return mod.random_ospf_topology(n_routers=60, n_networks=12, extra_p2p=90, max_cost=3,
                                    seed=3)


def _setup(shape, masked, lanes):
    """(graph, planes, roots, dist, parent, dag): what-if masks under one
    root, or no mask and a root a lane; the settled distances and DAG."""
    topo = _topology(tsynth, shape)
    g = te.device_graph_from_ell(tgraph.build_ell(topo, n_atoms=64), device="cpu")
    if masked:
        masks = tsynth.whatif_link_failure_masks(topo, lanes, seed=lanes)
        roots = torch.full((lanes,), topo.root, dtype=torch.int32)
        p = te.lane_planes(g, te.pack_edge_masks(masks, "cpu"))
    else:
        rng = np.random.default_rng(lanes)
        roots = torch.from_numpy(rng.integers(0, topo.n_vertices, lanes).astype(np.int32))
        p = te.lane_planes(g, None)
    dist = te.distance_fixpoint(p, roots, topo.n_vertices)
    parent, dag = ell.first_parent_plain(*p, dist, roots)
    return g, p, roots, dist, parent, dag


def _bit(words, b):
    """bool [...]: lane b's bit of int32 words [..., ceil(B / 32)]."""
    return ((words[..., b // 32].view(np.uint32) >> np.uint32(b % 32)) & 1) == 1


def walk_round(g, dag, roots, parent, state, front, out):
    """One ell_mp_round launch by the row-frontier rule, lane by lane in
    numpy: writes ``out`` (numpy planes) and returns (changed, frontier)."""
    src = g.in_src.numpy()
    direct = g.direct_nh_words.numpy().view(np.uint32)
    inc = g.is_router.numpy().astype(np.int64)
    hops, nh, npaths, aw = state
    n, k = src.shape
    lanes = hops.shape[1]
    atoms = 32 * direct.shape[2]
    onehot = ((direct[:, :, :, None] >> np.arange(32, dtype=np.uint32)) & 1).reshape(n, k, atoms)
    moved = np.zeros((n, lanes), bool)
    for b in range(lanes):
        d = _bit(dag, b)  # [N, K] DAG slots in lane b
        rec = (d & _bit(front, b)[src]).any(1) | (_bit(front, b) & ~d.any(1))
        keep = _bit(front, b) & ~rec
        h_nbr = hops[src, b]
        direct_slot, inherit_slot = d & (h_nbr == 0), d & (h_nbr != 0)
        p = parent[:, b]
        ph = np.where(p < n, hops[np.minimum(p, n - 1), b], n + 1)
        is_root = np.arange(n) == roots[b]
        new = [np.where(is_root, 0, np.where(ph < n + 1, ph + inc, n + 1))]
        words = np.stack([np.bitwise_or.reduce(
            np.where(direct_slot, direct[:, :, w], np.where(inherit_slot, nh[src, w, b].view(
                np.uint32), 0)), axis=1) for w in range(direct.shape[2])], 1)
        new.append(words.view(np.int32))
        if npaths is not None:
            np_nbr = np.where(d, npaths[src, b].astype(np.int64), 0)
            new.append(np.where(is_root, 1, np.minimum(np_nbr.sum(1), SAT)))
            acc = (onehot * np.where(direct_slot, np_nbr, 0)[:, :, None]).sum(1)
            acc += np.where(inherit_slot[:, :, None], aw[src, :, b], 0).sum(1)
            new.append(np.minimum(acc, SAT))
        for x, y, o in zip(state, new, out):
            if x is None:
                continue
            diff = (y != x[..., b]) if y.ndim == 1 else (y != x[..., b]).any(1)
            moved[:, b] |= rec & diff
            o[rec, ..., b] = y[rec]
            o[keep, ..., b] = x[keep, ..., b]
    padded = np.zeros((n, 32 * ((lanes + 31) // 32)), bool)
    padded[:, :lanes] = moved
    return int(moved.any()), np.packbits(padded, axis=1, bitorder="little").view(np.int32)


def _numpy(planes):
    return [None if x is None else x.numpy().copy() for x in planes]


def _check_dispatch(g, p, roots, parent, dag, state, before, front, label):
    """Run rounds of the dispatch: each one walked in numpy, by
    mp_round_plain and by the full round, all equal."""
    fixed = (p.src, dag, g.direct_nh_words, g.is_router.to(torch.int32), roots, parent)
    for r in range(1, ROUNDS + 1):
        walked = _numpy(before)
        w_changed, w_front = walk_round(g, dag.numpy(), roots.numpy(), parent.numpy(),
                                        _numpy(state), front.numpy(), walked)
        full = ell.mp_round_full(*fixed, state)
        changed, front = ell.mp_round_plain(*fixed, state, front, before)
        what = f"{label} round {r}"
        assert int(changed) == w_changed == int(full[4]), what
        np.testing.assert_array_equal(front.numpy(), w_front, err_msg=what)
        assert torch.equal(front, full[5]), what
        for i, (o, w, f) in enumerate(zip(before, walked, full[:4])):
            if o is None:
                assert w is None and f is None
                continue
            np.testing.assert_array_equal(o.numpy(), w, err_msg=f"{what} plane {i}")
            assert torch.equal(o, f), f"{what} plane {i}"
        state, before = before, state
        if not w_changed:
            return r
    return ROUNDS


def _stale(n, words, lanes, seed):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(x) for x in (
        rng.integers(0, n + 2, (n, lanes)).astype(np.int32),
        rng.integers(-(1 << 31), 1 << 31, (n, words, lanes)).astype(np.int32),
        rng.integers(0, SAT + 1, (n, lanes)).astype(np.int32),
        rng.integers(0, SAT + 1, (n, 32 * words, lanes)).astype(np.int32)))


CASES = [(shape, masked, lanes) for shape in ("fat_tree_k8", "random")
         for masked in (True, False) for lanes in (1, 5, 33)]


@pytest.mark.parametrize("counts", [True, False])
@pytest.mark.parametrize("shape,masked,lanes", CASES)
def test_row_frontier_walk_equals_the_full_round(shape, masked, lanes, counts):
    g, p, roots, dist, parent, dag = _setup(shape, masked, lanes)
    n = p.src.shape[0]
    words = g.direct_nh_words.shape[2]
    seeds, blank, front = te.mp_start(n, words, roots)
    if not counts:
        seeds, blank = (*seeds[:2], None, None), (*blank[:2], None, None)
    rounds = _check_dispatch(g, p, roots, parent, dag, seeds, blank, front, "fresh")
    assert rounds >= 2
    stale = _stale(n, words, lanes, lanes)
    if not counts:
        stale = (*stale[:2], None, None)
    kept = [None if x is None else x.clone() for x in stale]
    state, before, front = te.mp_resume(stale)
    assert torch.equal(front, ell.pack_lane_bits(torch.ones((n, lanes), dtype=torch.bool)))
    _check_dispatch(g, p, roots, parent, dag, state, before, front, "stale")
    for x, y in zip(stale, kept):  # the seeds are only read
        assert x is None or torch.equal(x, y)


def _random_round(shape, lanes, seed):
    """(fixed planes, X, A = the full round of X, its frontier): A is a
    round's output, X the round before it, both random but for that."""
    g, p, roots, dist, parent, dag = _setup(shape, True, lanes)
    n = p.src.shape[0]
    fixed = (p.src, dag, g.direct_nh_words, g.is_router.to(torch.int32), roots, parent)
    x = _stale(n, g.direct_nh_words.shape[2], lanes, seed)
    full = ell.mp_round_full(*fixed, x)
    return fixed, x, full[:4], full[5]


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("shape,lanes", [("random", 5), ("fat_tree_k8", 33)])
def test_superset_frontier_gives_the_full_round(shape, lanes, seed):
    fixed, x, a, changes = _random_round(shape, lanes, seed)
    assert popcount(changes) > 0
    rng = np.random.default_rng(seed + 10)
    extra = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, changes.shape).astype(np.int32))
    extra &= ell.pack_lane_bits(torch.ones((changes.shape[0], lanes), dtype=torch.bool))
    want = ell.mp_round_full(*fixed, a)
    for front in (changes, changes | extra):
        out = tuple(t.clone() for t in x)
        changed, f = ell.mp_round_plain(*fixed, a, front, out)
        assert int(changed) == int(want[4]) and torch.equal(f, want[5])
        for o, w in zip(out, want[:4]):
            assert torch.equal(o, w)


def popcount(words: torch.Tensor) -> int:
    return int(np.unpackbits(words.numpy().view(np.uint8)).sum())


@pytest.mark.parametrize("shape,lanes", [("random", 5), ("fat_tree_k8", 33)])
def test_omitting_a_changed_source_changes_the_result(shape, lanes):
    fixed, x, a, changes = _random_round(shape, lanes, 7)
    want = ell.mp_round_full(*fixed, a)
    rows, cols = np.nonzero(changes.numpy())
    differs = 0
    for v, w in zip(rows, cols):
        word = int(changes[v, w]) & 0xFFFFFFFF
        cleared = word & (word - 1)  # without the lowest changed lane of the word
        front = changes.clone()
        front[v, w] = cleared - (1 << 32) if cleared >> 31 else cleared
        out = tuple(t.clone() for t in x)
        ell.mp_round_plain(*fixed, a, front, out)
        differs += not all(torch.equal(o, t) for o, t in zip(out, want[:4]))
        if differs:
            break
    assert differs > 0


def _jax_pair(shape):
    tt = _topology(tsynth, shape)
    jt = _topology(jsynth, shape)
    jg = je.device_graph_from_ell(jgraph.build_ell(jt, n_atoms=64))
    tg = convert.device_graph_from_numpy({f: np.asarray(getattr(jg, f))
                                          for f in te.DeviceGraph._fields}, device="cpu")
    return tt, jt, tg, jg


@pytest.mark.parametrize("stale", [False, True])
@pytest.mark.parametrize("limit", [1, 2, 3, None])
@pytest.mark.parametrize("shape", ["fat_tree_k8", "random"])
def test_fixpoint_matches_jax_from_fresh_and_previous_seeds(shape, limit, stale):
    tt, jt, tg, jg = _jax_pair(shape)
    n, root = tt.n_vertices, jt.root
    lim = n if limit is None else limit
    dist = je.sssp_distances(jg, root)
    dag = je._sp_dag(jg, dist, jg.in_valid, root)
    parent = je._first_parent(jg, dag, dist[jg.in_src])
    words = tg.direct_nh_words.shape[2]
    roots = torch.tensor([root], dtype=torch.int32)
    if stale:
        seeds = [x[..., 0] for x in _stale(n, words, 1, lim)]
        start = te.mp_resume(tuple(x[..., None] for x in seeds))
    else:
        start = te.mp_start(n, words, roots)
        seeds = [x[..., 0].clone() for x in start[0]]
    j_seeds = [x.numpy() for x in seeds]
    want = je._mp_fixpoint(jg, root, dag, parent, *j_seeds, lim)
    bits = ell.pack_lane_bits(torch.from_numpy(np.array(dag))[:, :, None])
    tparent = torch.from_numpy(np.array(parent))[:, None]
    got, rounds = te.mp_fixpoint(tg, roots, bits, tparent, *start, lim)
    assert 1 <= rounds <= lim
    for i, (g_, w_) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g_[..., 0].numpy(), np.asarray(w_), err_msg=f"plane {i}")
    want2 = je._hops_nh_fixpoint(jg, root, dag, parent, *j_seeds[:2], lim)
    hops, nh, rounds = te.hops_nh_recompute(tg, root, bits, tparent[:, 0], seeds[0], seeds[1],
                                            lim)
    np.testing.assert_array_equal(hops.numpy(), np.asarray(want2[0]))
    np.testing.assert_array_equal(nh.numpy(), np.asarray(want2[1]))


@pytest.mark.parametrize("kp", [2, 4, 8])
@pytest.mark.parametrize("shape,masked,lanes", [
    ("random", True, 9), ("random", False, 6), ("parallel", True, 33),
    ("parallel", False, 4), ("fat_tree_k8", True, 40)])
def test_fused_parent_sets_equal_first_parent_and_parent_sets(shape, masked, lanes, kp):
    g, p, roots, dist, parent, dag = _setup(shape, masked, lanes)
    if shape != "fat_tree_k8":
        assert bool(((p.cost == 0) & (p.slot >= 0)).any())  # network -> router edges
    npaths = torch.from_numpy(np.random.default_rng(kp).integers(
        0, SAT + 1, dist.shape).astype(np.int32))
    got = ell.first_parent_sets_plain(*p, dist, roots, kp)
    want = (*ell.first_parent_plain(*p, dist, roots),
            *ell.parent_sets_plain(*p, dist, npaths, roots, kp))
    for i in range(4):
        assert torch.equal(got[i], want[i]), i
    assert torch.equal(ell.ell_parent_weights(got[2], npaths), want[4])
    assert bool((got[2] < p.src.shape[0]).any()) and got[2].shape[1] == kp


@pytest.mark.parametrize("lanes", [1, 5, 32, 33, 64, 70])
def test_full_frontier_marks_every_lane(lanes):
    want = ell.pack_lane_bits(torch.ones((7, lanes), dtype=torch.bool))
    assert torch.equal(ell.full_frontier(7, lanes, "cpu"), want)
