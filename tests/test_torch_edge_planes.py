"""The compact edge planes (per-pair CSC of the entries < CAP of ``w``) that
the kernels walk on the card.

- scattered back into a CAP-filled [P, S, S] they equal ``w`` exactly;
- entries are sorted by (pair, v_local, u_local) and ``cptr`` is monotone;
- the identity pair of a block with no in-edges has empty columns;
- convert.py derives the same planes from the JAX package's graph;
- a numpy walk of the CSC in the kernels' order (relax: add+min per edge;
  dmin_parent: the DAG test once per edge and scenario, then the
  lexicographic min of (distance, original id), also where many parents tie
  and where a block has no in-edges; nh_or: gated source distance, the DAG
  test once per edge and scenario, then an OR per word) equals the plain
  dense versions bit for bit.

Tolerance: exact equality everywhere (the computation is integer-only).
"""

import numpy as np
import pytest
import torch

from holo_tpu.ops import blocked as jblk
from holo_tpu.ops import blocked_spf as jbs
from holo_tpu.spf import synth as jsynth
from holo_tpu_torch import convert
from holo_tpu_torch.kernels import blocked as kernels
from holo_tpu_torch.ops import blocked as tblk
from holo_tpu_torch.ops import blocked_spf as tbs
from holo_tpu_torch.ops.graph import Topology
from holo_tpu_torch.spf import synth as tsynth

S, CAP, PBIG = tblk.S, tblk.CAP, tbs.PBIG


def _check_planes(w, cptr, crow, cw):
    """The CSC holds exactly the entries < CAP of ``w``, sorted."""
    p_count = w.shape[0]
    assert cptr.shape == (p_count, S + 1)
    assert cptr.dtype == crow.dtype == cw.dtype == np.int32
    assert cptr[0, 0] == 0 and cptr[-1, -1] == crow.shape[0] == cw.shape[0]
    assert (np.diff(cptr.reshape(-1)) >= 0).all()
    # offsets run over all pairs: column S of pair p ends where pair p + 1 starts
    np.testing.assert_array_equal(cptr[1:, 0], cptr[:-1, S])
    counts = np.diff(cptr, axis=1)  # [P, S] entries per (pair, v)
    pair = np.repeat(np.arange(p_count), counts.sum(1))
    col = np.repeat(np.tile(np.arange(S), p_count), counts.reshape(-1))
    key = (pair.astype(np.int64) * S + col) * S + crow
    assert (np.diff(key) > 0).all(), "entries not sorted by (pair, v, u)"
    assert ((crow >= 0) & (crow < S)).all() and (cw < CAP).all()
    back = np.full_like(w, CAP)
    back[pair, crow, col] = cw
    np.testing.assert_array_equal(back, w)
    return counts


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_planes_of_random_topologies(seed):
    t = tsynth.random_ospf_topology(n_routers=300, n_networks=40, extra_p2p=500, seed=seed)
    for g in (tbs.marshal_block_spf(t, device="cpu"), tblk.marshal_blocks(t, device="cpu")):
        _check_planes(*(x.numpy() for x in (g.w, g.cptr, g.crow, g.cw)))


def test_planes_of_fat_tree():
    t = tsynth.fat_tree_topology(k=8)
    g = tbs.marshal_block_spf(t, device="cpu")
    _check_planes(*(x.numpy() for x in (g.w, g.cptr, g.crow, g.cw)))
    assert g.crow.shape[0] == t.n_edges


def _unreached_block_topology():
    # 600 vertices = 3 blocks; a chain inside blocks 0-1 and edges from
    # block 2 into block 0, none into block 2.
    src = np.r_[np.arange(0, 511), np.arange(512, 600)]
    dst = np.r_[np.arange(1, 512), np.arange(0, 88)]
    return Topology(n_vertices=600, is_router=np.ones(600, bool), edge_src=src,
                    edge_dst=dst, edge_cost=np.arange(src.size) % 7 + 1, root=0)


def test_block_without_in_edges_has_empty_columns():
    t = _unreached_block_topology()
    arrays = tblk.block_pairs(t.edge_src, t.edge_dst, t.edge_cost, t.n_vertices)
    counts = _check_planes(arrays["w"], arrays["cptr"], arrays["crow"], arrays["cw"])
    ident = np.nonzero((arrays["bsrc"] == 2) & (arrays["bdst"] == 2))[0]
    assert ident.size == 1
    assert counts[ident[0]].sum() == 0
    assert counts.sum() == t.n_edges


def test_convert_derives_the_same_planes():
    kw = dict(n_routers=260, n_networks=40, extra_p2p=400, seed=1)
    tt, jt = tsynth.random_ospf_topology(**kw), jsynth.random_ospf_topology(**kw)
    jg = jbs.marshal_block_spf(jt)
    c = convert.block_spf_graph_from_numpy(
        {k: (v if isinstance(v, int) else np.asarray(v)) for k, v in jg._asdict().items()},
        device="cpu",
    )
    g = tbs.marshal_block_spf(tt, device="cpu")
    jb = jblk.marshal_blocks(jt)
    cb = convert.block_graph_from_numpy(
        {k: (v if isinstance(v, int) else np.asarray(v)) for k, v in jb._asdict().items()},
        device="cpu",
    )
    b = tblk.marshal_blocks(tt, device="cpu")
    for f in ("cptr", "crow", "cw"):
        assert torch.equal(getattr(c, f), getattr(g, f)), f
        assert torch.equal(getattr(cb, f), getattr(b, f)), f


def test_block_order_starts_with_the_heaviest_blocks():
    t = tsynth.fat_tree_topology(k=24)  # 1,008 vertices: 4 blocks
    g = tbs.marshal_block_spf(t, device="cpu")
    cptr, bdst, order = g.cptr.numpy(), g.bdst.numpy(), g.border.numpy()
    nb = g.seg.shape[0] - 1
    assert order.dtype == np.int32 and sorted(order.tolist()) == list(range(nb))
    work = np.zeros(nb)
    for p, bd in enumerate(bdst):
        work[bd] += cptr[p, S] - cptr[p, 0] + S
    assert (np.diff(work[order]) <= 0).all()
    # ties keep block order
    for a, b in zip(order[:-1], order[1:]):
        assert work[a] > work[b] or a < b


def _edges_global(g):
    """(source vertex, destination vertex, weight) of every CSC entry."""
    cptr, crow, cw = (x.numpy() for x in (g.cptr, g.crow, g.cw))
    counts = np.diff(cptr, axis=1)
    pair = np.repeat(np.arange(cptr.shape[0]), counts.sum(1))
    col = np.repeat(np.tile(np.arange(S), cptr.shape[0]), counts.reshape(-1))
    bsrc, bdst = g.bsrc.numpy()[pair], g.bdst.numpy()[pair]
    return bsrc.astype(np.int64) * S + crow, bdst.astype(np.int64) * S + col, cw


def _inputs(seed, batch, max_cost=20):
    t = tsynth.random_ospf_topology(
        n_routers=200, n_networks=30, extra_p2p=300, max_cost=max_cost, seed=seed
    )
    masks = tsynth.whatif_link_failure_masks(t, batch, seed=seed + 5)
    g = tbs.marshal_block_spf(t, device="cpu")
    fdst, fid = tbs.failed_edges_perm(g.orig2perm.numpy(), t, masks, device="cpu")
    npad = g.in_src.shape[0]
    dist_mid = tblk.distance_fixpoint(g, g.rootp, fdst, fid, limit=2)
    dist = tblk.distance_fixpoint(g, g.rootp, fdst, fid, limit=npad)
    _, parent_o = tbs.first_parent(g, dist, fdst, fid)
    hops = tbs.hops_fixpoint(g, parent_o, npad)
    gate = (hops > 0).to(torch.int32)
    direct = tbs.direct_words(g, dist, hops, fid)
    nh = tbs.nexthop_fixpoint(g, dist, hops, direct, fdst, fid, limit=1)
    return g, dist_mid, dist, gate, direct, nh


@pytest.mark.parametrize("seed,batch", [(0, 1), (1, 5), (2, 9)])
def test_csc_walk_equals_dense_relax(seed, batch):
    g, dist_mid, *_ = _inputs(seed, batch)
    src, dst, w = _edges_global(g)
    d = dist_mid.numpy()
    assert d.max() <= CAP  # the walk's precondition, as distance_fixpoint caps
    out = d.copy()
    np.minimum.at(out, dst, w[:, None] + d[src])
    want = kernels.relax_plain(g.w, g.bsrc, g.bdst, dist_mid).numpy()
    np.testing.assert_array_equal(out, want)


@pytest.mark.parametrize("seed,batch", [(0, 1), (1, 5), (2, 9)])
def test_csc_walk_equals_dense_nh_or(seed, batch):
    g, _, dist, gate, direct, nh = _inputs(seed, batch)
    src, dst, w = _edges_global(g)
    d, gt = dist.numpy(), gate.numpy()
    words = direct.shape[1] // batch
    du = np.where(gt > 0, d, CAP)[src]  # gated source distances
    dag = (du < CAP) & (w[:, None] + du == d[dst])  # [nnz, B], once per word chunk
    out = direct.numpy().reshape(-1, words, batch).copy()
    x = nh.numpy().reshape(-1, words, batch)[src]  # [nnz, W, B]
    np.bitwise_or.at(out, dst, np.where(dag[:, None, :], x, 0))
    want = kernels.nh_or_plain(g.w, g.bsrc, g.bdst, dist, gate, nh, direct).numpy()
    np.testing.assert_array_equal(out.reshape(want.shape), want)


def _lex_min_walk(g, dist):
    """numpy walk of the CSC: per (v, b) the lexicographic min of
    (dist[u, b], orig_id[u]) over the DAG parents u, (CAP, PBIG) if none."""
    src, dst, w = _edges_global(g)
    d, oid = dist.numpy(), g.orig_id.numpy()
    du = d[src]
    dag = (du < CAP) & (w[:, None] + du == d[dst])  # [nnz, B], once per edge
    key = np.where(dag, du.astype(np.int64) << 32 | oid[src, None], CAP << 32 | PBIG)
    best = np.full(d.shape, CAP << 32 | PBIG, np.int64)
    np.minimum.at(best, dst, key)
    return (best >> 32).astype(np.int32), (best & 0xFFFFFFFF).astype(np.int32), dag


def _assert_lex_min_walk_equals_plain(g, dist):
    pl = (g.w, g.bsrc, g.bdst)
    dmin, parent, dag = _lex_min_walk(g, dist)
    want_dmin = kernels.dmin_plain(*pl, dist)
    np.testing.assert_array_equal(dmin, want_dmin.numpy())
    want_parent = kernels.parent_plain(*pl, dist, want_dmin, g.orig_id)
    np.testing.assert_array_equal(parent, want_parent.numpy())
    return dag


@pytest.mark.parametrize("seed,batch,max_cost", [(0, 1, 20), (1, 5, 20), (2, 9, 2), (3, 4, 2)])
def test_csc_walk_equals_dense_dmin_parent(seed, batch, max_cost):
    g, _, dist, *_ = _inputs(seed, batch, max_cost)
    dag = _assert_lex_min_walk_equals_plain(g, dist)
    if max_cost == 2:
        # tie-heavy: many (v, b) have several DAG parents at the min distance
        src, dst, _ = _edges_global(g)
        d = dist.numpy()
        dmin, _, _ = _lex_min_walk(g, dist)
        at_min = dag & (d[src] == dmin[dst])
        ties = np.zeros(d.shape, np.int64)
        np.add.at(ties, dst, at_min.astype(np.int64))
        assert (ties >= 2).sum() > 50


def test_csc_walk_equals_dense_dmin_parent_with_an_unreached_block():
    t = _unreached_block_topology()
    g = tbs.marshal_block_spf(t, permute=False, device="cpu")
    dist = tblk.distance_fixpoint(g, g.rootp, *(torch.full((3, 4), -1, dtype=torch.int32),) * 2,
                                  limit=g.in_src.shape[0])
    _assert_lex_min_walk_equals_plain(g, dist)
    dmin, parent = kernels.dmin_parent(g.w, g.bsrc, g.bdst, g.seg, dist, g.orig_id)
    assert (dmin[2 * S:] == CAP).all() and (parent[2 * S:] == PBIG).all()


def test_card_wrappers_need_the_edge_planes():
    meta = torch.empty((1, S, S), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        kernels.relax(meta, meta, meta, meta, meta, edges=(meta,) * 4)
    w = torch.full((1, S, S), CAP, dtype=torch.int32)
    idx = torch.zeros(1, dtype=torch.int32)
    seg = torch.tensor([0, 1], dtype=torch.int32)
    dist = torch.zeros((S, 3), dtype=torch.int32)
    # On the CPU the plain version reads w and needs no edge planes.
    assert torch.equal(kernels.relax(w, idx, idx, seg, dist), dist)
    oid = torch.arange(S, dtype=torch.int32)
    dmin, parent = kernels.dmin_parent(w, idx, idx, seg, dist, oid)
    assert (dmin == CAP).all() and (parent == PBIG).all()
    with pytest.raises(ValueError, match="CUDA device"):
        kernels.dmin_parent(meta, meta, meta, meta, meta, meta, edges=(meta,) * 4)
    cptr = torch.zeros((1, S + 1), dtype=torch.int32)
    assert kernels._check_edges(w, 1, (cptr, idx, idx, idx)) is not None
    with pytest.raises(ValueError, match="edge planes"):
        kernels._check_edges(w, 1, (cptr[:, :S], idx, idx, idx))
    with pytest.raises(ValueError, match="edge planes"):
        kernels._check_edges(w, 2, (cptr, idx, idx, idx))
    with pytest.raises(ValueError, match="edges="):
        kernels._check_edges(w, 1, None)
