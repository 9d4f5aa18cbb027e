"""The port's blocked SPF engine against the JAX package, bit for bit.

- marshal_block_spf: every plane equal field by field;
- each kernel's plain PyTorch version against the Pallas kernel run in
  interpret mode on identical planes (brought over with convert.py);
  dmin_parent's two outputs against K3 and against K4 fed K3's output;
- first_parent (one fused walk, then the corrections) against the
  two-pass sequence it replaces, with failed edges that change dmin;
- whatif_spf_blocked against JAX's whatif_spf_blocked(interpret=True) and
  the scalar oracle, on all four planes (the cases of test_blocked_spf.py).

Tolerance: exact equality everywhere (the computation is integer-only).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from holo_tpu.ops import blocked_spf as jbs
from holo_tpu.spf import synth as jsynth
from holo_tpu.spf.backend import ScalarSpfBackend
from holo_tpu_torch import convert
from holo_tpu_torch.kernels import blocked as kernels
from holo_tpu_torch.ops import blocked as tblk
from holo_tpu_torch.ops import blocked_spf as tbs
from holo_tpu_torch.spf import synth as tsynth

PLANES = ("w", "bsrc", "bdst", "in_src", "in_cost", "in_valid", "in_edge_id", "inc",
          "orig_id", "orig2perm", "vz", "z_src", "z_cost", "z_eid", "z_words", "z_valid")


def _topos(**kw):
    return tsynth.random_ospf_topology(**kw), jsynth.random_ospf_topology(**kw)


def _jax_fields(jg):
    return {k: (np.asarray(v) if not isinstance(v, int) else v) for k, v in jg._asdict().items()}


@pytest.mark.parametrize("permute", [True, False, "auto"])
@pytest.mark.parametrize("seed", [0, 1])
def test_marshal_matches_jax(permute, seed):
    tt, jt = _topos(n_routers=260, n_networks=40, extra_p2p=400, seed=seed)
    g = tbs.marshal_block_spf(tt, permute=permute, device="cpu")
    jg = jbs.marshal_block_spf(jt, permute=permute)
    for f in PLANES:
        a, b = getattr(g, f).numpy(), np.asarray(getattr(jg, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert (g.n_real, g.n_words, g.rootp) == (jg.n_real, jg.n_words, jg.rootp)
    # seg marks exactly the pairs JAX flags as first of their dst block.
    first = np.zeros(g.w.shape[0], np.int32)
    first[g.seg.numpy()[:-1]] = 1
    np.testing.assert_array_equal(first, np.asarray(jg.first))
    # convert.py builds the same graph from the JAX fields.
    c = convert.block_spf_graph_from_numpy(_jax_fields(jg), device="cpu")
    for f in (*PLANES, "seg"):
        assert torch.equal(getattr(c, f), getattr(g, f)), f


def test_bfs_permutation_matches_jax():
    tt, jt = _topos(n_routers=600, n_networks=80, extra_p2p=900, seed=1)
    np.testing.assert_array_equal(tbs.bfs_permutation(tt), jbs.bfs_permutation(jt))


@pytest.mark.parametrize("seed", [0, 2])
def test_failed_edges_perm_matches_jax(seed):
    tt, jt = _topos(n_routers=120, n_networks=20, seed=seed)
    masks = jsynth.whatif_link_failure_masks(jt, 7, seed=seed)
    masks[0, :4] = False  # a scenario with several failures
    perm = jbs.bfs_permutation(jt)
    fdst, fid = tbs.failed_edges_perm(perm, tt, masks, device="cpu")
    jd, ji = jbs.failed_edges_perm(perm, jt, masks)
    np.testing.assert_array_equal(fdst.numpy(), jd)
    np.testing.assert_array_equal(fid.numpy(), ji)
    masks[5, :5] = False
    with pytest.raises(ValueError, match="scenario 5: .* > 4"):
        tbs.failed_edges_perm(perm, tt, masks, device="cpu")


def _kernel_inputs(seed):
    """Identical planes for both packages plus real mid-fixpoint inputs."""
    tt, jt = _topos(n_routers=260, n_networks=40, extra_p2p=400, seed=seed)
    masks = jsynth.whatif_link_failure_masks(jt, 6, seed=seed + 7)
    jg = jbs.marshal_block_spf(jt)
    g = convert.block_spf_graph_from_numpy(_jax_fields(jg), device="cpu")
    fdst, fid = tbs.failed_edges_perm(g.orig2perm.numpy(), tt, masks, device="cpu")
    npad = g.in_src.shape[0]
    x = {"dist_mid": tblk.distance_fixpoint(g, g.rootp, fdst, fid, limit=2)}
    x["dist"] = tblk.distance_fixpoint(g, g.rootp, fdst, fid, limit=npad)
    x["dmin"], parent_o = tbs.first_parent(g, x["dist"], fdst, fid)
    hops = tbs.hops_fixpoint(g, parent_o, npad)
    x["gate"] = (hops > 0).to(torch.int32)
    x["direct"] = tbs.direct_words(g, x["dist"], hops, fid)
    x["nh"] = tbs.nexthop_fixpoint(g, x["dist"], hops, x["direct"], fdst, fid, limit=1)
    return g, jg, x


def _pallas(jg, kernel, extra, lanes, *planes):
    npad = jg.in_src.shape[0]
    call = jbs._grid(int(jg.bsrc.shape[0]), npad, lanes, kernel, extra, True)
    out = call(jg.bsrc, jg.bdst, jg.first, jg.w, *[jnp.asarray(p.numpy()) for p in planes])
    return np.asarray(out)


@pytest.mark.parametrize("name", ["relax", "dmin", "parent", "nh_or"])
@pytest.mark.parametrize("seed", [0, 1])
def test_plain_kernel_matches_pallas(name, seed):
    g, jg, x = _kernel_inputs(seed)
    pl = (g.w, g.bsrc, g.bdst, g.seg)
    batch = x["dist"].shape[1]
    if name == "relax":
        got = kernels.relax(*pl, x["dist_mid"])
        want = _pallas(jg, jbs._relax_kernel, "", batch, x["dist_mid"], x["dist_mid"])
    elif name == "dmin":
        got, _ = kernels.dmin_parent(*pl, x["dist"], g.orig_id)
        want = _pallas(jg, jbs._dmin_kernel, "", batch, x["dist"], x["dist"])
    elif name == "parent":
        # K4 fed K3's own (uncorrected) output: the fused walk's function.
        _, got = kernels.dmin_parent(*pl, x["dist"], g.orig_id)
        dmin = torch.tensor(_pallas(jg, jbs._dmin_kernel, "", batch, x["dist"], x["dist"]))
        oid = g.orig_id[:, None].expand(-1, batch).contiguous()
        want = _pallas(jg, jbs._parent_kernel, "ds", batch, x["dist"], x["dist"], dmin, oid)
    else:
        words = x["direct"].shape[1] // batch
        got = kernels.nh_or(*pl, x["dist"], x["gate"], x["nh"], x["direct"])
        dcat, gcat = x["dist"].repeat(1, words), x["gate"].repeat(1, words)
        want = _pallas(jg, jbs._nh_or_kernel, "ssd", words * batch,
                       dcat, dcat, gcat, x["nh"], x["direct"])
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def _first_parent_in_two_passes(g, dist, fdst, fid):
    """The sequence the fused step replaces: dmin, its correction, parent
    fed the corrected dmin, the parent correction."""
    pl = (g.w, g.bsrc, g.bdst)
    dmin = tbs._correct_dmin(g, dist, kernels.dmin_plain(*pl, dist), fdst, fid)
    parent_o = kernels.parent_plain(*pl, dist, dmin, g.orig_id)
    return dmin, tbs._correct_parent(g, dist, dmin, parent_o, fdst, fid)


def _fails_a_min_parent(t, g):
    """Masks [2, E]: no failure, then one failed edge u -> v whose source
    is the only parent of v at its min DAG-parent distance while v keeps a
    farther DAG parent, so v's distance stays and its static min parent
    distance (failed edge included) is below the corrected one."""
    none = torch.full((1, 4), -1, dtype=torch.int32)
    dist = tblk.distance_fixpoint(g, g.rootp, none, none, limit=g.in_src.shape[0])[:, 0]
    d = dist.numpy()
    perm = g.orig2perm.numpy()
    src, dst = perm[t.edge_src], perm[t.edge_dst]
    dag = (d[src] < tblk.CAP) & (d[src] + t.edge_cost == d[dst])
    for e in np.nonzero(dag)[0]:
        parents = d[src[dag & (dst == dst[e])]]
        if (parents == d[src[e]]).sum() == 1 and d[src[e]] == parents.min() < parents.max():
            masks = np.ones((2, t.n_edges), bool)
            masks[1, e] = False
            return masks, int(dst[e])
    raise AssertionError("no edge removes its destination's min-distance parent")


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_fused_first_parent_equals_the_two_pass_sequence(seed):
    tt = tsynth.random_ospf_topology(
        n_routers=200, n_networks=30, extra_p2p=300, max_cost=3, seed=seed
    )
    g = tbs.marshal_block_spf(tt, device="cpu")
    npad = g.in_src.shape[0]
    cases = [tsynth.whatif_link_failure_masks(tt, 7, seed=seed + 3)]
    masks, v = _fails_a_min_parent(tt, g)
    cases.append(masks)
    for m in cases:
        fdst, fid = tbs.failed_edges_perm(g.orig2perm.numpy(), tt, m, device="cpu")
        dist = tblk.distance_fixpoint(g, g.rootp, fdst, fid, limit=npad)
        got = tbs.first_parent(g, dist, fdst, fid)
        want = _first_parent_in_two_passes(g, dist, fdst, fid)
        for a, b in zip(got, want):
            assert a.dtype == torch.int32
            assert torch.equal(a, b)
    # The failed edge removed v's min-distance parent: the static dmin
    # (the kernel's) and the corrected one differ there, and so do the
    # static and corrected parents.
    static_dmin, static_parent = kernels.dmin_parent(g.w, g.bsrc, g.bdst, g.seg, dist, g.orig_id)
    assert static_dmin[v, 1] < got[0][v, 1]
    assert static_parent[v, 1] != got[1][v, 1]
    assert torch.equal(static_dmin[:, 0], got[0][:, 0])


def _assert_parity(kw, masks_fn, permute=True, n_atoms=64):
    tt, jt = _topos(**kw)
    masks = masks_fn(jt)
    g = tbs.marshal_block_spf(tt, n_atoms=n_atoms, permute=permute, device="cpu")
    fdst, fid = tbs.failed_edges_perm(g.orig2perm.numpy(), tt, masks, device="cpu")
    out = tbs.whatif_spf_blocked(g, fdst, fid)
    jg = jbs.marshal_block_spf(jt, n_atoms=n_atoms, permute=permute)
    jd, ji = jbs.failed_edges_perm(np.asarray(jg.orig2perm), jt, masks)
    jout = jbs.whatif_spf_blocked(jg, jd, ji, interpret=True)
    got = {"dist": out.dist.numpy(), "parent": out.parent.numpy(),
           "hops": out.hops.numpy(), "nexthops": out.nexthops.numpy().view(np.uint32)}
    for f, a in got.items():
        b = np.asarray(getattr(jout, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    scalar = ScalarSpfBackend(n_atoms=n_atoms).compute_whatif(jt, masks)
    for b, s in enumerate(scalar):
        np.testing.assert_array_equal(s.dist, got["dist"][b], err_msg=f"dist b={b}")
        np.testing.assert_array_equal(s.parent, got["parent"][b], err_msg=f"parent b={b}")
        np.testing.assert_array_equal(s.hops, got["hops"][b], err_msg=f"hops b={b}")
        np.testing.assert_array_equal(
            s.nexthop_words, got["nexthops"][b], err_msg=f"nexthops b={b}"
        )


@pytest.mark.parametrize("seed", range(3))
def test_whatif_parity(seed):
    _assert_parity(
        dict(n_routers=260, n_networks=40, extra_p2p=400, seed=seed),
        lambda t: jsynth.whatif_link_failure_masks(t, n_scenarios=6, seed=seed + 7),
    )


def test_whatif_parity_unpermuted():
    _assert_parity(
        dict(n_routers=120, n_networks=30, seed=9),
        lambda t: jsynth.whatif_link_failure_masks(t, n_scenarios=4, seed=2),
        permute=False,
    )


def test_whatif_parity_no_failures():
    _assert_parity(
        dict(n_routers=90, n_networks=20, seed=3),
        lambda t: np.ones((2, t.n_edges), bool),
    )


def _multi_failure_masks(t):
    masks = np.ones((3, t.n_edges), bool)
    rng = np.random.default_rng(11)
    pair = {(int(t.edge_src[e]), int(t.edge_dst[e])): e for e in range(t.n_edges)}
    for b in (1, 2):
        for _ in range(2):
            e = int(rng.integers(0, t.n_edges))
            masks[b, e] = False
            rev = pair.get((int(t.edge_dst[e]), int(t.edge_src[e])))
            if rev is not None:
                masks[b, rev] = False
    return masks


def test_whatif_parity_multi_failure():
    _assert_parity(dict(n_routers=80, n_networks=10, seed=5), _multi_failure_masks)


def test_or_reduce_matches_loop():
    rng = np.random.default_rng(3)
    x = rng.integers(-(2**31), 2**31, size=(7, 5, 3), dtype=np.int64).astype(np.int32)
    for dim in range(3):
        want = np.bitwise_or.reduce(x, axis=dim)
        got = kernels.or_reduce(torch.from_numpy(x), dim).numpy()
        np.testing.assert_array_equal(got, want)
