"""The port's relax-only what-if distances (whatif_distances_blocked, the K1
path) against holo_tpu.ops.blocked in interpret mode and the scalar oracle,
with the seeds of test_blocked.py.  Tolerance: exact equality."""

import numpy as np
import pytest

from holo_tpu.ops import blocked as jblk
from holo_tpu.ops.graph import Topology as JTopology
from holo_tpu.spf import synth as jsynth
from holo_tpu.spf.backend import ScalarSpfBackend
from holo_tpu_torch import convert
from holo_tpu_torch.ops import blocked as tblk
from holo_tpu_torch.ops.graph import Topology as TTopology
from holo_tpu_torch.spf import synth as tsynth

PLANES = ("w", "bsrc", "bdst", "in_src", "in_cost", "in_valid", "in_edge_id")


def _both(masks_fn, **kw):
    tt, jt = tsynth.random_ospf_topology(**kw), jsynth.random_ospf_topology(**kw)
    masks = masks_fn(jt)
    g = tblk.marshal_blocks(tt, device="cpu")
    fdst, fid = tblk.failed_edges_from_masks(tt, masks, device="cpu")
    got = tblk.whatif_distances_blocked(g, tt.root, fdst, fid).numpy()
    jg = jblk.marshal_blocks(jt)
    jd, ji = jblk.failed_edges_from_masks(jt, masks)
    np.testing.assert_array_equal(fdst.numpy(), jd)
    np.testing.assert_array_equal(fid.numpy(), ji)
    want = np.asarray(jblk.whatif_distances_blocked(jg, jt.root, jd, ji, interpret=True))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    for b, s in enumerate(ScalarSpfBackend().compute_whatif(jt, masks)):
        np.testing.assert_array_equal(s.dist, got[b], err_msg=f"scenario {b}")
    return g, jg


@pytest.mark.parametrize("seed", range(3))
def test_distances_match_jax_and_scalar(seed):
    g, jg = _both(
        lambda t: jsynth.whatif_link_failure_masks(t, n_scenarios=8, seed=seed + 10),
        n_routers=300, n_networks=40, extra_p2p=500, seed=seed,
    )
    for f in PLANES:
        np.testing.assert_array_equal(getattr(g, f).numpy(), np.asarray(getattr(jg, f)), f)
    c = convert.block_graph_from_numpy(
        {k: (v if isinstance(v, int) else np.asarray(v)) for k, v in jg._asdict().items()},
        device="cpu",
    )
    for f in (*PLANES, "seg"):
        np.testing.assert_array_equal(getattr(c, f).numpy(), getattr(g, f).numpy(), f)
    assert c.n_real == g.n_real == jg.n_real


def test_rejects_parallel_edges():
    kw = dict(
        n_vertices=2,
        is_router=np.ones(2, bool),
        edge_src=np.array([0, 0, 1], np.int32),
        edge_dst=np.array([1, 1, 0], np.int32),  # duplicate 0->1
        edge_cost=np.array([1, 2, 1], np.int32),
        root=0,
    )
    with pytest.raises(ValueError, match="parallel"):
        tblk.marshal_blocks(TTopology(**kw), device="cpu")
    with pytest.raises(ValueError, match="parallel"):
        jblk.marshal_blocks(JTopology(**kw))


def test_rejects_distance_bound():
    n = 3
    kw = dict(n_vertices=n, is_router=np.ones(n, bool),
              edge_src=np.array([0, 1], np.int32), edge_dst=np.array([1, 2], np.int32),
              edge_cost=np.array([1 << 26, 1 << 26], np.int32), root=0)
    with pytest.raises(ValueError, match="distance bound"):
        tblk.marshal_blocks(TTopology(**kw), device="cpu")


def _two_link_failure(t):
    masks = np.ones((2, t.n_edges), bool)
    rng = np.random.default_rng(3)
    pair = {(int(t.edge_src[e]), int(t.edge_dst[e])): e for e in range(t.n_edges)}
    for _ in range(2):
        e = int(rng.integers(0, t.n_edges))
        masks[1, e] = False
        rev = pair.get((int(t.edge_dst[e]), int(t.edge_src[e])))
        if rev is not None:
            masks[1, rev] = False
    return masks


def test_multi_failure_scenario():
    _both(_two_link_failure, n_routers=80, n_networks=10, seed=5)


def test_max_iters_bounds_rounds():
    """A cut fixpoint agrees with JAX's cut at the same round count."""
    tt = tsynth.random_ospf_topology(n_routers=200, n_networks=20, seed=1)
    jt = jsynth.random_ospf_topology(n_routers=200, n_networks=20, seed=1)
    masks = jsynth.whatif_link_failure_masks(jt, 3, seed=4)
    fdst, fid = tblk.failed_edges_from_masks(tt, masks, device="cpu")
    got = tblk.whatif_distances_blocked(
        tblk.marshal_blocks(tt, device="cpu"), tt.root, fdst, fid, max_iters=2
    ).numpy()
    jd, ji = jblk.failed_edges_from_masks(jt, masks)
    want = jblk.whatif_distances_blocked(
        jblk.marshal_blocks(jt), jt.root, jd, ji, max_iters=2, interpret=True
    )
    np.testing.assert_array_equal(got, np.asarray(want))
