"""The frontier rule of ell_relax and ell_nh_round, on the CPU.

The two round kernels gather only from sources whose lanes changed in the
previous round: they skip a (slot, 32-lane tile) where the source's frontier
word AND the slot's mask word (relax) or inherit word (next hops) is 0, and
predicate the tile's lanes on those bits.  A numpy walk that applies this
rule tile by tile must give exactly the plain full round (``relax_plain``,
``nh_round_plain``) in every round, changed flag included, and every
frontier plane must equal ``pack_lane_bits(out != in)`` (for next hops the
OR over words): on the k=8 fat tree and a random OSPF topology, with what-if
masks (one root) and without (one root a lane), at 1, 5, 33 and 64 lanes,
for rounds 1-7; and the drivers, which carry the frontier, stop where the
walk does at ``max_iters`` 1-7.

Tolerance: exact equality everywhere (the computation is integer-only).
"""

import numpy as np
import pytest
import torch

from holo_tpu_torch.kernels import ell
from holo_tpu_torch.ops import graph as tgraph
from holo_tpu_torch.ops import spf_engine as te
from holo_tpu_torch.spf import synth as tsynth

INF = 1 << 30
ROUNDS = 7


def _topology(shape):
    if shape == "fat_tree_k8":
        return tsynth.fat_tree_topology(k=8)
    return tsynth.random_ospf_topology(n_routers=80, n_networks=15, extra_p2p=120,
                                       max_cost=3, seed=3)


def _setup(shape, masked, lanes):
    """(graph, planes, roots): what-if masks under one root, or no mask and
    a root a lane."""
    topo = _topology(shape)
    g = te.device_graph_from_ell(tgraph.build_ell(topo, n_atoms=64), device="cpu")
    if masked:
        masks = tsynth.whatif_link_failure_masks(topo, lanes, seed=lanes)
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


def _active(bits, front, src, valid, w):
    """uint32 [N, K]: the lanes of tile w that a slot gathers, by the skip
    rule (0 where the kernels skip the (slot, tile))."""
    act = front[src, w].view(np.uint32) & bits
    return np.where(valid, act, np.uint32(0))


def walk_relax(p, dist, front):
    """One ell_relax launch by the kernels' skip rule."""
    src, cost, slot = p.src.numpy(), p.cost.numpy(), p.slot.numpy()
    mask = None if p.mask is None else p.mask.numpy().view(np.uint32)
    lanes = dist.shape[1]
    out = dist.copy()
    for w in range((lanes + 31) // 32):
        bits = np.uint32(0xFFFFFFFF) if mask is None else mask[np.maximum(slot, 0), w]
        act = _active(bits, front, src, slot >= 0, w)
        vs, ks = np.nonzero(act)  # the (slot, tile) pairs not skipped
        for b in range(32 * w, min(32 * w + 32, lanes)):
            on = ((act[vs, ks] >> np.uint32(b % 32)) & 1) == 1
            v, k = vs[on], ks[on]
            du = dist[src[v, k], b]
            ok = du < INF
            np.minimum.at(out[:, b], v[ok], du[ok] + cost[v, k][ok])
    return out, int((out != dist).any()), _pack(out != dist)


def walk_nh_round(p, inherit, nh, front):
    """One ell_nh_round launch by the kernels' skip rule."""
    src = p.src.numpy()
    lanes = nh.shape[2]
    out = nh.copy()
    for w in range((lanes + 31) // 32):
        act = _active(inherit[:, :, w].view(np.uint32), front, src, True, w)
        vs, ks = np.nonzero(act)
        for b in range(32 * w, min(32 * w + 32, lanes)):
            on = ((act[vs, ks] >> np.uint32(b % 32)) & 1) == 1
            v, k = vs[on], ks[on]
            np.bitwise_or.at(out[:, :, b], v, nh[src[v, k], :, b])
    moved = (out != nh).any(1)
    return out, int(moved.any()), _pack(moved)


def _same_round(plain, walked, plane, label):
    out, changed, front = plain
    np.testing.assert_array_equal(out.numpy(), walked[0], err_msg=label)
    assert int(changed) == walked[1], label
    np.testing.assert_array_equal(front.numpy(), walked[2], err_msg=label)
    moved = out != plane if out.dim() == 2 else (out != plane).any(1)
    assert torch.equal(front, ell.pack_lane_bits(moved)), label


CASES = [(shape, masked, lanes) for shape in ("fat_tree_k8", "random")
         for masked in (True, False) for lanes in (1, 5, 33, 64)]


@pytest.mark.parametrize("shape,masked,lanes", CASES)
def test_relax_frontier_walk_equals_the_full_round(shape, masked, lanes):
    _, p, roots = _setup(shape, masked, lanes)
    dist, front = te.distance_seed(p.src.shape[0], roots)
    assert torch.equal(front, ell.pack_lane_bits(dist < INF))
    for r in range(1, ROUNDS + 1):
        plain = ell.relax_plain(*p, dist, front)
        _same_round(plain, walk_relax(p, dist.numpy(), front.numpy()), dist, f"round {r}")
        dist, _, front = plain


@pytest.mark.parametrize("shape,masked,lanes", CASES)
def test_nh_round_frontier_walk_equals_the_full_round(shape, masked, lanes):
    g, p, roots = _setup(shape, masked, lanes)
    n = p.src.shape[0]
    dist = te.distance_fixpoint(p, roots, n)
    parent, dag = ell.first_parent_plain(*p, dist, roots)
    hops = te.hops_fixpoint(g, parent, roots, n)
    nh, inherit = ell.nh_seed_plain(p.src, dag, ell.pack_lane_bits(hops == 0),
                                    g.direct_nh_words, lanes)
    front = te.nexthop_frontier(nh)
    assert torch.equal(front, ell.pack_lane_bits((nh != 0).any(1)))
    for r in range(1, ROUNDS + 1):
        plain = ell.nh_round_plain(p.src, inherit, nh, front)
        walked = walk_nh_round(p, inherit.numpy(), nh.numpy(), front.numpy())
        _same_round(plain, walked, nh, f"round {r}")
        nh, _, front = plain


@pytest.mark.parametrize("max_iters", range(1, ROUNDS + 1))
def test_drivers_stop_where_the_walk_does(max_iters):
    g, p, roots = _setup("random", True, 33)
    n = p.src.shape[0]
    dist, front = te.distance_seed(n, roots)
    d, f = dist.numpy(), front.numpy()
    for _ in range(max_iters):
        d, changed, f = walk_relax(p, d, f)
        if not changed:
            break
    got = te.distance_fixpoint(p, roots, max_iters)
    np.testing.assert_array_equal(got.numpy(), d)
    parent, dag = ell.first_parent_plain(*p, got, roots)
    hops = te.hops_fixpoint(g, parent, roots, n)
    seed, inherit = ell.nh_seed_plain(p.src, dag, ell.pack_lane_bits(hops == 0),
                                      g.direct_nh_words, 33)
    h, f = seed.numpy(), te.nexthop_frontier(seed).numpy()
    for _ in range(max_iters):
        h, changed, f = walk_nh_round(p, inherit.numpy(), h, f)
        if not changed:
            break
    nh = te.nexthop_fixpoint(g, dag, hops, max_iters)
    np.testing.assert_array_equal(nh.numpy(), h)
