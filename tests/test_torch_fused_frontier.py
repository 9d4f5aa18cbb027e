"""The frontier rule of ell_fused_round, on the CPU.

The fused round recomputes a (row, lane) only where some valid slot of the
row, whose edge is up in that lane, has a source marked in the frontier (the
lanes that changed in the round before); it copies the row's other marked
lanes from its input into the output buffer, which holds the state before
that round, leaves every other entry of that buffer as it is, and writes the
parent of recomputed lanes into the parent plane it carries from round to
round.  A recomputed lane takes one pass over the slots with a running best
(a candidate below it resets the (dist, src) argmin and the OR accumulators,
one equal to it accumulates), in both layouts.

A numpy walk of that rule runs whole fused dispatches from the seeds (an
all-ones frontier, the sentinel parent N, an output buffer of noise) and
must equal ``fused_round_plain`` round by round in the state, the parent,
the changed flag and ``frontier_out``: on the k=8 fat tree, a random OSPF
topology and one with hops-0 networks, a row of only padding slots and
seven next-hop words, with what-if masks that take every in-edge of a row
down in some lanes, and without masks (one root a lane), at 1, 8, 9 and 64
lanes, both layouts.  Walks truncated at ``max_iters`` 0-4 (and run to the
end) equal ``fused_lanes``.  ``fused_row_frontier`` gives the walk's
recompute and copy lanes, and the plain round's ``frontier_out`` is
``pack_lane_bits`` of the lanes it moved.

Tolerance: exact equality everywhere (the computation is integer-only).
"""

import numpy as np
import pytest
import torch

from holo_tpu_torch.kernels import ell
from holo_tpu_torch.ops import graph as tgraph
from holo_tpu_torch.ops import spf_engine as te
from holo_tpu_torch.ops.graph import Topology
from holo_tpu_torch.spf import synth as tsynth

INF = 1 << 30
LANES = (1, 8, 9, 64)


def _networks_topology():
    # A random OSPF topology whose root neighbours transit networks (hops-0
    # sources other than the root), plus a router with only out-edges: a
    # row of only padding slots.
    t = tsynth.random_ospf_topology(n_routers=40, n_networks=12, extra_p2p=50, max_cost=3,
                                    seed=10)
    n = t.n_vertices
    topo = Topology(n_vertices=n + 1, is_router=np.r_[t.is_router, True],
                    edge_src=np.r_[t.edge_src, n, n], edge_dst=np.r_[t.edge_dst, t.root, n - 1],
                    edge_cost=np.r_[t.edge_cost, 1, 2], root=t.root)
    tsynth.assign_direct_atoms(topo)
    return topo


# name -> (topology, n_atoms); "networks" has seven next-hop words.
SHAPES = {
    "fat_tree_k8": (lambda: tsynth.fat_tree_topology(k=8), 64),
    "random": (lambda: tsynth.random_ospf_topology(n_routers=60, n_networks=12, extra_p2p=90,
                                                   max_cost=3, seed=3), 64),
    "networks": (_networks_topology, 200),
}


def _masks(topo, lanes):
    """What-if masks, plus every in-edge of one row down in every third
    lane (that row has no usable slot there)."""
    masks = tsynth.whatif_link_failure_masks(topo, lanes, seed=lanes)
    dark = int(np.argmax(np.bincount(topo.edge_dst, minlength=topo.n_vertices)))
    masks[::3, topo.edge_dst == dark] = False
    return masks


def _setup(shape, masked, lanes):
    """(graph, planes, roots, mask bool [B, E] or None): what-if masks under
    one root, or no mask and a root a lane."""
    make, n_atoms = SHAPES[shape]
    topo = make()
    g = te.device_graph_from_ell(tgraph.build_ell(topo, n_atoms=n_atoms), device="cpu")
    if masked:
        masks = _masks(topo, lanes)
        roots = torch.full((lanes,), topo.root, dtype=torch.int32)
        return g, te.lane_planes(g, te.pack_edge_masks(masks, "cpu")), roots
    rng = np.random.default_rng(lanes)
    roots = torch.from_numpy(rng.integers(0, topo.n_vertices, lanes).astype(np.int32))
    return g, te.lane_planes(g, None), roots


def _pack(moved):
    """bool [N, L] -> the frontier words, as numpy packs them."""
    n, lanes = moved.shape
    padded = np.zeros((n, 32 * ((lanes + 31) // 32)), bool)
    padded[:, :lanes] = moved
    return np.packbits(padded, axis=1, bitorder="little").view(np.int32)


def _unpack(words, lanes):
    lane = np.arange(lanes)
    return ((words.view(np.uint32)[:, lane // 32] >> (lane % 32).astype(np.uint32)) & 1) == 1


def _up(p, lanes):
    """bool [N, K, B]: slot valid and its edge up in the lane."""
    slot = p.slot.numpy()
    valid = (slot >= 0)[:, :, None]
    if p.mask is None:
        return np.broadcast_to(valid, (*slot.shape, lanes))
    lane = np.arange(lanes)
    words = p.mask.numpy().view(np.uint32)[np.maximum(slot, 0)][:, :, lane // 32]
    return valid & (((words >> (lane % 32).astype(np.uint32)) & 1) == 1)


def walk_fused(p, direct, inc, roots, planes, front, parent, out):
    """One ell_fused_round launch by the kernel's rule, on numpy planes
    (dist, hops, nh [N, W, B]): (out planes, parent, changed, frontier_out),
    ``out`` and ``parent`` updated as the kernel updates them."""
    src, cost = p.src.numpy(), p.cost.numpy()
    dist, hops, nh = planes
    n, k = src.shape
    lanes = dist.shape[1]
    up = _up(p, lanes)
    marked = _unpack(front, lanes)
    rec = (up & marked[src]).any(1)
    copy = marked & ~rec
    not_root = np.arange(n)[:, None] != roots[None, :]
    best = dist.copy()
    pd = np.full_like(dist, INF)
    ps = np.full_like(dist, n)
    ph = np.full_like(dist, n + 1)
    acc = np.zeros_like(nh)
    for j in range(k):  # one pass over the slots with a running best
        u = src[:, j]
        d = dist[u]
        ok = up[:, j] & (d < INF)
        cand = d + cost[:, j, None]  # int32: wraps as the kernel's add
        lower = ok & (cand < best)
        best = np.where(lower, cand, best)
        pd, ps, ph = (np.where(lower, x, y) for x, y in ((INF, pd), (n, ps), (n + 1, ph)))
        acc = np.where(lower[:, None, :], 0, acc)
        take = ok & (cand == best) & (best < INF) & not_root
        h = hops[u]
        better = take & ((d < pd) | ((d == pd) & (u[:, None] < ps)))
        pd, ps, ph = (np.where(better, x, y) for x, y in ((d, pd), (u[:, None], ps), (h, ph)))
        words = np.where((h == 0)[:, None, :], direct[:, j, :, None], nh[u])
        acc |= np.where(take[:, None, :], words, 0)
    hn = np.where(~not_root, 0, np.where((ps < n) & (ph < n + 1), ph + inc[:, None], n + 1))
    moved = rec & ((best != dist) | (hn != hops) | (acc != nh).any(1))
    new = []
    for x, y, o in ((dist, best, out[0]), (hops, hn, out[1]), (nh, acc, out[2])):
        r, c = (rec, copy) if x.ndim == 2 else (rec[:, None, :], copy[:, None, :])
        new.append(np.where(r, y, np.where(c, x, o)).astype(np.int32))
    return tuple(new), np.where(rec, ps, parent), int(moved.any()), _pack(moved)


def _seeds(n, words, roots):
    lanes = roots.shape[0]
    at_root = np.arange(n)[:, None] == roots[None, :]
    return (np.where(at_root, 0, INF).astype(np.int32),
            np.where(at_root, 0, n + 1).astype(np.int32),
            np.zeros((n, words, lanes), np.int32))


def walk_dispatch(g, p, roots, limit, plain=None):
    """A whole fused dispatch by the walk, from the seeds: (dist, parent,
    hops, nh) after at most ``limit`` rounds, and the rounds run.  With
    ``plain`` (the layout's ``packed`` flag) every round is held to
    ``fused_round_plain`` from the walk's state."""
    n = p.src.shape[0]
    direct = g.direct_nh_words.numpy()
    inc = g.is_router.to(torch.int32).numpy()
    r = roots.numpy()
    lanes = r.shape[0]
    state = _seeds(n, direct.shape[2], r)
    noise = np.random.default_rng(lanes)
    spare = tuple(noise.integers(-INF, INF, x.shape, dtype=np.int32) for x in state)
    front = _pack(np.ones((n, lanes), bool))
    parent = np.full((n, lanes), n, np.int32)
    rounds = 0
    for rnd in range(1, limit + 1):
        got = walk_fused(p, direct, inc, r, state, front, parent, spare)
        if plain is not None:
            _same_as_plain(g, p, roots, state, front, got, plain, f"round {rnd}")
        (new, parent, changed, front), rounds = got, rnd
        state, spare = new, state
        if not changed:
            break
    dist, hops, nh = state
    return (dist, parent, np.where(dist < INF, hops, n + 1), nh), rounds


def _same_as_plain(g, p, roots, state, front, walked, packed, label):
    tstate = ell.fused_state(*map(torch.from_numpy, state), packed)
    new, parent, changed, fout = ell.fused_round_plain(
        *p, g.direct_nh_words, g.is_router.to(torch.int32), roots, tstate)
    assert torch.is_tensor(new) == packed, label
    for name, a, b in zip(("dist", "hops", "nh"), ell.fused_planes(new), walked[0]):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=f"{label} {name}")
    np.testing.assert_array_equal(parent.numpy(), walked[1], err_msg=f"{label} parent")
    assert int(changed) == walked[2], f"{label} changed"
    np.testing.assert_array_equal(fout.numpy(), walked[3], err_msg=f"{label} frontier_out")
    rec, copy = ell.fused_row_frontier(p.src, p.slot, p.mask, torch.from_numpy(front))
    lanes = roots.shape[0]
    want = (_up(p, lanes) & _unpack(front, lanes)[p.src.numpy()]).any(1)
    np.testing.assert_array_equal(rec.numpy(), _pack(want), err_msg=f"{label} recompute")
    assert torch.equal(copy, torch.from_numpy(front) & ~rec), f"{label} copy"


CASES = [(shape, masked, lanes) for shape in SHAPES for masked in (True, False)
         for lanes in LANES]


@pytest.mark.parametrize("packed", [False, True], ids=["planar", "interleaved"])
@pytest.mark.parametrize("shape,masked,lanes", CASES)
def test_fused_walk_equals_the_plain_round(shape, masked, lanes, packed):
    g, p, roots = _setup(shape, masked, lanes)
    n = p.src.shape[0]
    (dist, parent, hops, nh), rounds = walk_dispatch(g, p, roots, 3 * n + 6, plain=packed)
    assert rounds > 2
    want = te.fused_lanes(g, roots, p.mask, packed)
    for name, a, b in zip(("dist", "parent", "hops", "nh"), want, (dist, parent, hops, nh)):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)


@pytest.mark.parametrize("max_iters", [0, 1, 2, 3, 4, None])
@pytest.mark.parametrize("shape,masked,lanes", [("random", True, 9), ("networks", False, 8),
                                                ("fat_tree_k8", True, 1)])
def test_truncated_walks_equal_fused_lanes(shape, masked, lanes, max_iters):
    g, p, roots = _setup(shape, masked, lanes)
    n = p.src.shape[0]
    limit = 3 * n + 6 if max_iters is None else max_iters
    got, rounds = walk_dispatch(g, p, roots, limit)
    assert rounds == limit or max_iters is None
    for packed in (False, True):
        want = te.fused_lanes(g, roots, p.mask, packed, max_iters)
        for name, a, b in zip(("dist", "parent", "hops", "nh"), want, got):
            np.testing.assert_array_equal(a.numpy(), b, err_msg=f"packed={packed} {name}")


@pytest.mark.parametrize("packed", [False, True], ids=["planar", "interleaved"])
@pytest.mark.parametrize("lanes", [1, 9, 64])
def test_plain_frontier_out_is_the_moved_lanes(lanes, packed):
    g, p, roots = _setup("random", True, lanes)
    n = p.src.shape[0]
    state = ell.fused_state(*map(torch.from_numpy, _seeds(n, g.direct_nh_words.shape[2],
                                                          roots.numpy())), packed)
    inc = g.is_router.to(torch.int32)
    for r in range(1, 6):
        new, _, changed, fout = ell.fused_round_plain(*p, g.direct_nh_words, inc, roots, state)
        moved = torch.zeros((n, lanes), dtype=torch.bool)
        for a, b in zip(ell.fused_planes(new), ell.fused_planes(state)):
            moved |= (a != b) if a.dim() == 2 else (a != b).any(1)
        assert torch.equal(fout, ell.pack_lane_bits(moved)), f"round {r}"
        assert int(changed) == int(moved.any()), f"round {r}"
        state = new
