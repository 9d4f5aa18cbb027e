"""The DAG bits of ell_first_parent and the bit-plane seed of ell_nh_seed
against the JAX package, on the CPU.

``ell_first_parent`` returns, beside the parent, the DAG as lane bits [N, K,
ceil(B/32)]; ``ell_nh_seed`` builds the next-hop seed and the inherit bits
from those bits and ``hop0 = pack_lane_bits(hops == 0)``, gathering neither
distances nor hops.  On a random OSPF topology with networks (a network one
hop from the root has hops 0, so hops-0 sources other than the root exist),
with what-if masks under one root and without masks under one root a lane,
at 1, 8, 33 and 64 lanes, the same numpy-seeded inputs go through both
packages:

- the port's ``dag`` equals ``pack_lane_bits`` of JAX's ``_sp_dag`` per lane;
- ``nh_seed_plain`` equals the seed and inherit words built from JAX's DAG,
  ``hops[in_src] == 0`` and ``direct_nh_words`` (``spf_engine.py:977-990``);
- a numpy walk of the kernel's word rule (inherit ``d & ~h``; the lanes of
  ``d & h`` OR the slot's direct words into the seed) equals
  ``nh_seed_plain``.

Tolerance: exact equality everywhere (the computation is integer-only).
"""

import functools

import jax
import numpy as np
import pytest
import torch

from holo_tpu.ops import graph as jgraph
from holo_tpu.ops import spf_engine as je
from holo_tpu.spf import synth as jsynth
from holo_tpu_torch.kernels import ell
from holo_tpu_torch.ops import graph as tgraph
from holo_tpu_torch.ops import spf_engine as te
from holo_tpu_torch.spf import synth as tsynth

KW = dict(n_routers=60, n_networks=15, extra_p2p=80, max_cost=3, seed=10)
CASES = [(masked, lanes) for masked in (True, False) for lanes in (1, 8, 33, 64)]


def _pack(bits):
    """bool [..., L] -> uint32 [..., ceil(L / 32)], bit l % 32 of word l // 32."""
    *lead, lanes = bits.shape
    padded = np.zeros((*lead, 32 * ((lanes + 31) // 32)), bool)
    padded[..., :lanes] = bits
    return np.packbits(padded, axis=-1, bitorder="little").view(np.uint32)


@functools.lru_cache(maxsize=None)
def _case(masked, lanes):
    """JAX's per-lane DAG, hops and distances, and the port's planes, on the
    same topology, masks and roots."""
    jt, tt = jsynth.random_ospf_topology(**KW), tsynth.random_ospf_topology(**KW)
    jg = je.device_graph_from_ell(jgraph.build_ell(jt, n_atoms=64))
    tg = te.device_graph_from_ell(tgraph.build_ell(tt, n_atoms=64), device="cpu")
    if masked:
        masks = jsynth.whatif_link_failure_masks(jt, lanes, seed=lanes)
        roots = np.full(lanes, jt.root, np.int32)
    else:
        masks = None  # lane 0 at the root, which three networks neighbour
        roots = np.random.default_rng(lanes).integers(0, jt.n_vertices, lanes).astype(np.int32)
        roots[0] = jt.root

    def lane(mask, root):
        dist = je.sssp_distances(jg, root, mask)
        dag = je._sp_dag(jg, dist, je._slot_mask(jg, mask), root)
        return dist, dag, je.spf_one(jg, root, mask).hops

    if masked:
        dist, dag, hops = jax.jit(jax.vmap(lane))(masks, roots)
    else:
        dist, dag, hops = jax.jit(jax.vmap(lambda r: lane(None, r)))(roots)
    mask_w = None if masks is None else te.pack_edge_masks(masks, "cpu")
    p = te.lane_planes(tg, mask_w)
    jax_side = dict(dist=np.asarray(dist), dag=np.asarray(dag), hops=np.asarray(hops),
                    src=np.asarray(jg.in_src), direct=np.asarray(jg.direct_nh_words),
                    roots=roots)
    return tg, p, jax_side


def _port_planes(masked, lanes):
    """(graph, planes, dag, hop0) of the port on JAX's distances and hops."""
    tg, p, j = _case(masked, lanes)
    dist = torch.from_numpy(np.array(j["dist"].T))
    _, dag = ell.first_parent_plain(*p, dist, torch.from_numpy(j["roots"]))
    hop0 = ell.pack_lane_bits(torch.from_numpy(np.array(j["hops"].T)) == 0)
    return tg, p, dag, hop0


@pytest.mark.parametrize("masked,lanes", CASES)
def test_dag_bits_match_jax_sp_dag(masked, lanes):
    _, _, j = _case(masked, lanes)
    _, _, dag, _ = _port_planes(masked, lanes)
    want = _pack(j["dag"].transpose(1, 2, 0))  # [N, K, words]
    np.testing.assert_array_equal(dag.numpy().view(np.uint32), want)


@pytest.mark.parametrize("masked,lanes", CASES)
def test_nh_seed_plain_matches_jax_split(masked, lanes):
    _, _, j = _case(masked, lanes)
    tg, p, dag, hop0 = _port_planes(masked, lanes)
    use_direct = j["hops"][:, j["src"]] == 0  # [B, N, K]: JAX's hops[in_src] == 0
    direct_slot, inherit_slot = j["dag"] & use_direct, j["dag"] & ~use_direct
    # A hops-0 DAG source other than the lane's root: the rule is not the root's alone.
    other = j["src"][None] != j["roots"][:, None, None]
    assert (direct_slot & other).any()
    words = np.where(direct_slot[..., None], j["direct"][None], np.uint32(0))
    want_seed = np.bitwise_or.reduce(words, axis=2)  # [B, N, W]
    seed, inherit = ell.nh_seed_plain(p.src, dag, hop0, tg.direct_nh_words, lanes)
    np.testing.assert_array_equal(seed.numpy().view(np.uint32).transpose(2, 0, 1), want_seed)
    np.testing.assert_array_equal(inherit.numpy().view(np.uint32),
                                  _pack(inherit_slot.transpose(1, 2, 0)))


def _walk_seed(src, dag, hop0, direct, lanes):
    """The kernel's word rule, one (slot, word) at a time: skip a zero DAG
    word d; else h = hop0[src, word], inherit d & ~h, and each lane of d & h
    ORs the slot's direct words into its seed."""
    n, k, words = dag.shape
    seed = np.zeros((n, direct.shape[2], lanes), np.uint32)
    inherit = np.zeros_like(dag)
    for v, j, w in zip(*np.nonzero(dag)):
        d, h = dag[v, j, w], hop0[src[v, j], w]
        inherit[v, j, w] = d & ~h
        for bit in np.nonzero((d & h) >> np.arange(32, dtype=np.uint32) & 1)[0]:
            seed[v, :, 32 * w + bit] |= direct[v, j]
    return seed, inherit


@pytest.mark.parametrize("masked,lanes", CASES)
def test_nh_seed_word_rule_walk_matches_plain(masked, lanes):
    tg, p, dag, hop0 = _port_planes(masked, lanes)
    direct = tg.direct_nh_words
    seed, inherit = ell.nh_seed_plain(p.src, dag, hop0, direct, lanes)
    want_seed, want_inherit = _walk_seed(p.src.numpy(), dag.numpy().view(np.uint32),
                                         hop0.numpy().view(np.uint32),
                                         direct.numpy().view(np.uint32), lanes)
    np.testing.assert_array_equal(seed.numpy().view(np.uint32), want_seed)
    np.testing.assert_array_equal(inherit.numpy().view(np.uint32), want_inherit)
