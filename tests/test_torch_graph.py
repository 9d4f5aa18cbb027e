"""The port's host graph model and generators give the JAX package's arrays
for the same seeds (exact equality on every array)."""

import numpy as np
import pytest

from holo_tpu.ops import graph as jgraph
from holo_tpu.spf import synth as jsynth
from holo_tpu_torch.ops import graph as tgraph
from holo_tpu_torch.spf import synth as tsynth

TOPO_FIELDS = ("is_router", "edge_src", "edge_dst", "edge_cost", "edge_direct_atom")
ELL_FIELDS = ("in_src", "in_cost", "in_valid", "in_edge_id", "in_direct_atom", "is_router")


def _same_topology(a, b):
    assert a.n_vertices == b.n_vertices and a.root == b.root
    for f in TOPO_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.mark.parametrize("k", [4, 8])
def test_fat_tree_matches(k):
    _same_topology(tsynth.fat_tree_topology(k=k), jsynth.fat_tree_topology(k=k))


@pytest.mark.parametrize(
    "kw",
    [
        dict(n_routers=260, n_networks=40, extra_p2p=400, seed=0),
        dict(n_routers=120, n_networks=30, seed=9),
        dict(n_routers=80, n_networks=10, seed=5, max_cost=4),
        dict(n_routers=50, seed=3, root=7),
    ],
)
def test_random_ospf_matches(kw):
    _same_topology(tsynth.random_ospf_topology(**kw), jsynth.random_ospf_topology(**kw))


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_whatif_masks_match(seed):
    t = tsynth.random_ospf_topology(n_routers=150, n_networks=20, seed=seed)
    j = jsynth.random_ospf_topology(n_routers=150, n_networks=20, seed=seed)
    np.testing.assert_array_equal(
        tsynth.whatif_link_failure_masks(t, 9, seed=seed + 3),
        jsynth.whatif_link_failure_masks(j, 9, seed=seed + 3),
    )


@pytest.mark.parametrize("n_atoms", [64, 96])
def test_build_ell_matches(n_atoms):
    t = tsynth.random_ospf_topology(n_routers=200, n_networks=30, extra_p2p=300, seed=4)
    j = jsynth.random_ospf_topology(n_routers=200, n_networks=30, extra_p2p=300, seed=4)
    te, je = tgraph.build_ell(t, n_atoms=n_atoms), jgraph.build_ell(j, n_atoms=n_atoms)
    assert te.n_atoms == je.n_atoms and te.k_pad == je.k_pad
    for f in ELL_FIELDS:
        np.testing.assert_array_equal(getattr(te, f), getattr(je, f), err_msg=f)


def test_build_ell_rejects_like_jax():
    t = tsynth.random_ospf_topology(n_routers=30, seed=2)
    j = jsynth.random_ospf_topology(n_routers=30, seed=2)
    for mod, topo in ((tgraph, t), (jgraph, j)):
        with pytest.raises(ValueError, match="k_pad"):
            mod.build_ell(topo, k_pad=1)
        with pytest.raises(ValueError, match="atoms"):
            mod.build_ell(topo, n_atoms=1)


def test_mutual_filter_matches():
    src = np.array([0, 1, 1, 2, 3, 0], np.int32)
    dst = np.array([1, 0, 2, 3, 2, 3], np.int32)
    np.testing.assert_array_equal(
        tgraph.mutual_keep_mask(src, dst), jgraph.mutual_keep_mask(src, dst)
    )
    kw = dict(n_vertices=4, is_router=np.ones(4, bool), edge_src=src, edge_dst=dst,
              edge_cost=np.arange(1, 7, dtype=np.int32), root=0)
    _same_topology(
        tgraph.Topology(**kw).filter_mutual(), jgraph.Topology(**kw).filter_mutual()
    )


def test_cache_key_moves_on_touch():
    t = tsynth.random_ospf_topology(n_routers=20, seed=1)
    key = t.cache_key
    t.touch()
    assert t.cache_key != key and t.cache_key[0] == key[0]
    assert tsynth.random_ospf_topology(n_routers=20, seed=1).cache_key[0] != key[0]
