"""Full block-sparse SPF: distances + first parent + hops + ECMP next hops.

Port of ``holo_tpu/ops/blocked_spf.py``; the block kernels are the
hand-written CUDA kernels of :mod:`holo_tpu_torch.kernels.blocked`:

- distances: the block relax kernel (Jacobi min-plus fixpoint);
- first parent: one edge-walk kernel (``dmin_parent``) -- per-vertex min
  DAG-parent distance and the min *original id* among parents at that
  distance, together.  This reproduces the reference's BTreeMap pop
  order (holo-ospf/src/spf.rs:614-622, 676-706) even though compute runs
  in a BFS-permuted vertex space;
- hops: first-parent chain fixpoint (plain torch gathers);
- next-hop bitmasks: direct contributions come only from parents with
  ``hops == 0`` (spf.rs:733-767), a small static edge set handled in plain
  torch; the inherit fixpoint (spf.rs:710-717) runs as the block OR kernel
  (``nh_or``) with the (word x scenario) product riding the lane axis.

What-if exactness: kernels run on the static graph; after every step a
small correction recomputes the failed edges' destination rows from the ELL
in-edge lists with the failed slots masked.

The fixpoints are Python loops with one host sync per round (the
convergence test), bounded by ``max_iters`` (default N_pad).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from holo_tpu_torch.analysis.runtime import read_flag
from holo_tpu_torch.device import resolve_device
from holo_tpu_torch.kernels import blocked as kernels
from holo_tpu_torch.kernels.blocked import or_reduce
from holo_tpu_torch.ops.blocked import (
    CAP,
    S,
    UNREACH,
    as_plane,
    block_pairs,
    check_blocked_preconditions,
    distance_fixpoint,
    edges_of,
    ell_planes,
    failed_edges,
    row_plan,
    tensors_on,
)
from holo_tpu_torch.ops.graph import INF, Topology

# "no parent" sentinel inside kernels; > any original vertex id, < CAP so
# int32 arithmetic stays exact.
PBIG = 1 << 27


class BlockSpfGraph(NamedTuple):
    """Device planes for the full blocked SPF (all in BFS-permuted space)."""

    # block-sparse weight planes (as ops/blocked.py)
    w: torch.Tensor  # int32[P, S, S]
    bsrc: torch.Tensor  # int32[P]
    bdst: torch.Tensor  # int32[P]
    seg: torch.Tensor  # int32[nb + 1] pair offsets per destination block
    cptr: torch.Tensor  # int32[P, S + 1] compact edge planes (edge_planes)
    crow: torch.Tensor  # int32[nnz]
    cw: torch.Tensor  # int32[nnz]
    border: torch.Tensor  # int32[nb] destination blocks, heaviest walk first
    # ELL correction planes (permuted vertex space, original edge ids)
    in_src: torch.Tensor  # int32[N_pad, K]
    in_cost: torch.Tensor  # int32[N_pad, K]
    in_valid: torch.Tensor  # bool[N_pad, K]
    in_edge_id: torch.Tensor  # int32[N_pad, K]
    # per-vertex planes
    inc: torch.Tensor  # int32[N_pad] 1 if router (hops increment)
    orig_id: torch.Tensor  # int32[N_pad] perm -> original id (PBIG for pads)
    orig2perm: torch.Tensor  # int32[N_orig] original -> perm
    # direct next-hop candidate table: per vertex with in-edges from the
    # root / root-adjacent networks, its padded candidate list
    vz: torch.Tensor  # int32[M] destination vertex (perm)
    z_src: torch.Tensor  # int32[M, C] source vertex (perm)
    z_cost: torch.Tensor  # int32[M, C]
    z_eid: torch.Tensor  # int32[M, C] original edge id
    z_words: torch.Tensor  # int32[M, C, W] one-hot atom words
    z_valid: torch.Tensor  # bool[M, C]
    n_real: int  # permuted-space vertex count (== n_orig)
    n_words: int  # W
    rootp: int  # root row in permuted space


def bfs_permutation(topo: Topology) -> np.ndarray:
    """perm_of[orig_id] -> new id; BFS from root over the undirected graph.

    Neighbour visit order is ascending original id so the permutation is
    deterministic.  Unreached vertices keep relative order at the end.
    """
    n = topo.n_vertices
    us = np.concatenate([topo.edge_src, topo.edge_dst]).astype(np.int64)
    ud = np.concatenate([topo.edge_dst, topo.edge_src]).astype(np.int64)
    order_e = np.argsort(us, kind="stable")
    us_s, ud_s = us[order_e], ud[order_e]
    starts = np.searchsorted(us_s, np.arange(n + 1))

    seen = np.zeros(n, bool)
    seen[topo.root] = True
    frontier = np.array([topo.root], np.int64)
    chunks = [frontier]
    while frontier.size:
        lo, hi = starts[frontier], starts[frontier + 1]
        counts = hi - lo
        idx = np.repeat(lo, counts) + (
            np.arange(counts.sum()) - np.repeat(np.cumsum(counts) - counts, counts)
        )
        nbrs = np.unique(ud_s[idx])
        nbrs = nbrs[~seen[nbrs]]
        seen[nbrs] = True
        frontier = nbrs  # ascending-id order within each BFS layer
        if nbrs.size:
            chunks.append(nbrs)
    rest = np.nonzero(~seen)[0]
    if rest.size:
        chunks.append(rest)
    order = np.concatenate(chunks)
    perm_of = np.empty(n, np.int64)
    perm_of[order] = np.arange(n)
    return perm_of


def _block_pair_count(psrc: np.ndarray, pdst: np.ndarray, nb: int) -> int:
    key = (pdst // S).astype(np.int64) * nb + (psrc // S)
    return len(np.unique(key))


def marshal_arrays(topo: Topology, n_atoms: int = 64, permute: bool | str = "auto") -> dict:
    """The blocked-SPF planes as numpy arrays (see :func:`marshal_block_spf`)."""
    check_blocked_preconditions(topo)
    n = topo.n_vertices
    src, dst, cost = topo.edge_src, topo.edge_dst, topo.edge_cost
    nb = (n + S - 1) // S
    npad = nb * S
    if permute == "auto":
        bfs = bfs_permutation(topo)
        perm_of = (
            bfs
            if _block_pair_count(bfs[src], bfs[dst], nb) < _block_pair_count(src, dst, nb)
            else np.arange(n, dtype=np.int64)
        )
    else:
        perm_of = bfs_permutation(topo) if permute else np.arange(n, dtype=np.int64)
    psrc = perm_of[src].astype(np.int32)
    pdst = perm_of[dst].astype(np.int32)
    inv = np.empty(n, np.int64)  # perm -> orig
    inv[perm_of] = np.arange(n)

    arrays = block_pairs(psrc, pdst, cost, n)
    # ELL planes in permuted space (edge ids stay original).
    ptopo = Topology(
        n_vertices=n,
        is_router=topo.is_router[inv],
        edge_src=psrc,
        edge_dst=pdst,
        edge_cost=cost,
        edge_direct_atom=topo.edge_direct_atom,
        root=int(perm_of[topo.root]),
    )
    arrays.update(ell_planes(ptopo, npad, max(n_atoms, topo.n_atoms())))
    inc = np.zeros(npad, np.int32)
    inc[:n] = topo.is_router[inv].astype(np.int32)
    orig_id = np.full(npad, PBIG, np.int32)
    orig_id[:n] = inv
    arrays.update(inc=inc, orig_id=orig_id, orig2perm=perm_of.astype(np.int32))

    # Direct-contribution candidate edges: out-edges of Z = {root} union
    # {transit networks adjacent to the root}.  Only parents with hops == 0
    # contribute direct atoms, and those are exactly Z members.
    nwords = max((max(n_atoms, topo.n_atoms()) + 31) // 32, 1)
    rootp = int(perm_of[topo.root])
    in_z = np.zeros(n, bool)
    in_z[rootp] = True
    root_out = psrc == rootp
    in_z[pdst[root_out & ~topo.is_router[dst]]] = True
    by_dst: dict[int, list] = {}
    for e in np.nonzero(in_z[psrc])[0].tolist():
        by_dst.setdefault(int(pdst[e]), []).append(e)
    m = max(len(by_dst), 1)
    c = max((len(v) for v in by_dst.values()), default=1)
    vz = np.zeros(m, np.int32)
    z_src = np.zeros((m, c), np.int32)
    z_cost = np.zeros((m, c), np.int32)
    z_eid = np.zeros((m, c), np.int32)
    z_words = np.zeros((m, c, nwords), np.int32)
    z_valid = np.zeros((m, c), bool)
    for i, (v, edges) in enumerate(sorted(by_dst.items())):
        vz[i] = v
        for j, e in enumerate(edges):
            z_src[i, j] = psrc[e]
            z_cost[i, j] = cost[e]
            z_eid[i, j] = e
            z_valid[i, j] = True
            a = int(topo.edge_direct_atom[e])
            if a >= 0:
                z_words[i, j, a // 32] = np.int32(np.uint32(1) << np.uint32(a % 32))
    arrays.update(vz=vz, z_src=z_src, z_cost=z_cost, z_eid=z_eid, z_words=z_words, z_valid=z_valid)
    arrays.update(n_real=n, n_words=nwords, rootp=rootp)
    return arrays


def block_spf_graph(arrays: dict, device: torch.device) -> BlockSpfGraph:
    """Build the device graph from numpy planes (``seg``, ``border`` derived)."""
    scalars = ("n_real", "n_words", "rootp")
    derived = (*scalars, "seg", "border")
    planes = {k: arrays[k] for k in BlockSpfGraph._fields if k not in derived}
    return BlockSpfGraph(
        **tensors_on(planes, device), **{k: int(arrays[k]) for k in scalars}
    )


def marshal_block_spf(
    topo: Topology, n_atoms: int = 64, permute: bool | str = "auto", device=None
) -> BlockSpfGraph:
    """Lower a Topology to the full blocked-SPF device planes.

    ``permute="auto"`` picks whichever of {BFS order, native tie-break
    order} yields fewer nonzero block pairs -- kernel cost is proportional
    to the pair count.  Requires unique (src, dst) pairs and max finite
    distance < 2**27 (ValueError otherwise).
    """
    return block_spf_graph(marshal_arrays(topo, n_atoms, permute), resolve_device(device))


# ---------------------------------------------------------------------------
# Failed-edge corrections (exact repair of rows whose in-edges changed).
# Each edits ``acc`` in place: rows with v < 0 keep their value.


def _dag_slots(dist, idx, wcost, valid, v_safe, brange):
    """bool[B, K]: ELL slot is a DAG in-edge under the final distances."""
    dvals = dist[idx, brange[:, None]]
    dv = dist[v_safe, brange][:, None]
    return valid & (dvals < CAP) & (dv < CAP) & (dvals + wcost == dv), dvals


def _correct_dmin(g, dist, acc, fdst, fid):
    for f in range(fdst.shape[1]):
        v = fdst[:, f]
        v_safe, idx, wcost, valid, brange = row_plan(g, v, fid)
        dag, dvals = _dag_slots(dist, idx, wcost, valid, v_safe, brange)
        new_v = torch.where(dag, dvals, CAP).amin(1)
        acc[v_safe, brange] = torch.where(v >= 0, new_v, acc[v_safe, brange])
    return acc


def _correct_parent(g, dist, dmin, acc, fdst, fid):
    for f in range(fdst.shape[1]):
        v = fdst[:, f]
        v_safe, idx, wcost, valid, brange = row_plan(g, v, fid)
        dag, dvals = _dag_slots(dist, idx, wcost, valid, v_safe, brange)
        at_min = dag & (dvals == dmin[v_safe, brange][:, None])
        new_v = torch.where(at_min, g.orig_id[idx], PBIG).amin(1)
        acc[v_safe, brange] = torch.where(v >= 0, new_v, acc[v_safe, brange])
    return acc


def _correct_nh(g, dist, gate, direct, acc, fdst, fid):
    """Repair failed rows of the inherit fixpoint: recompute from ELL.

    ``direct``/``acc`` are lane-packed [N_pad, W*B]; dist/gate are [N_pad, B].
    """
    batch = fdst.shape[0]
    words = acc.shape[1] // batch
    for f in range(fdst.shape[1]):
        v = fdst[:, f]
        v_safe, idx, wcost, valid, brange = row_plan(g, v, fid)
        dag, _ = _dag_slots(dist, idx, wcost, valid, v_safe, brange)
        use = dag & (gate[idx, brange[:, None]] > 0)  # inherit: hops > 0
        lanes = [wd * batch + brange for wd in range(words)]
        new_rows = [
            direct[v_safe, lane] | or_reduce(torch.where(use, acc[idx, lane[:, None]], 0), 1)
            for lane in lanes
        ]
        for lane, row in zip(lanes, new_rows):
            acc[v_safe, lane] = torch.where(v >= 0, row, acc[v_safe, lane])
    return acc


# ---------------------------------------------------------------------------
# Pipeline stages (each public so a caller can feed a kernel real inputs).


def first_parent(g: BlockSpfGraph, dist, fdst, fid):
    """(dmin, parent) [N_pad, B]: min DAG-parent distance, then the min
    original id among parents at that distance (PBIG if none).

    One kernel walk gives both on the static graph (their lexicographic
    min); then ``_correct_dmin`` and ``_correct_parent``, in that order,
    rewrite the cells of failed-edge destinations.  This equals computing
    dmin, correcting it, and feeding the corrected dmin to a separate
    parent pass, bit for bit: ``_correct_dmin`` writes only those cells,
    ``_correct_parent`` recomputes exactly those cells whole from the ELL
    with the corrected dmin, and on every other cell the static dmin is
    the corrected one, so the static parent is too.
    """
    dmin, parent_o = kernels.dmin_parent(
        g.w, g.bsrc, g.bdst, g.seg, dist, g.orig_id, edges=edges_of(g)
    )
    dmin = _correct_dmin(g, dist, dmin, fdst, fid)
    return dmin, _correct_parent(g, dist, dmin, parent_o, fdst, fid)


def hops_fixpoint(g: BlockSpfGraph, parent_o, limit: int):
    """Hops along the first-parent chain: int32[N_pad, B], N+1 if none."""
    n = g.n_real
    npad, batch = parent_o.shape
    brange = torch.arange(batch, device=parent_o.device)
    has_parent = parent_o < PBIG
    pperm = torch.where(has_parent, g.orig2perm[parent_o.clamp_max(n - 1).long()], 0).long()
    big = n + 1
    hops = torch.full((npad, batch), big, dtype=torch.int32, device=parent_o.device)
    hops[g.rootp] = 0
    inc = g.inc[:, None]
    for _ in range(limit):
        ph = torch.where(has_parent, hops[pperm, brange[None, :]], big)
        new = torch.minimum(hops, torch.where(ph < big, ph + inc, big))
        changed = read_flag("spf.flag.blocked_hops", (new != hops).any())
        hops = new
        if not changed:
            break
    return hops


def direct_words(g: BlockSpfGraph, dist, hops, fid):
    """Direct next-hop words from hops == 0 parents (the Z-set edges),
    lane-packed int32[N_pad, W*B] with lane l = word * B + b."""
    npad, batch = dist.shape
    words = int(g.z_words.shape[2])
    brange = torch.arange(batch, device=dist.device)[None, None, :]
    z_src = g.z_src.long()[:, :, None]
    zdist_s = dist[z_src, brange]  # [M, C, B]
    zdist_d = dist[g.vz.long()[:, None, None], brange]  # [M, 1, B]
    hit = (g.z_eid[:, :, None, None] == fid[None, None]) & (fid[None, None] >= 0)
    zdag = (
        g.z_valid[:, :, None]
        & ~hit.any(3)  # candidate edge not failed in scenario b
        & (zdist_s < CAP)
        & (zdist_s + g.z_cost[:, :, None] == zdist_d)
        & (hops[z_src, brange] == 0)
    )  # [M, C, B]
    contrib = torch.where(zdag[..., None], g.z_words[:, :, None, :], 0)  # [M, C, B, W]
    direct = torch.zeros((npad, batch, words), dtype=torch.int32, device=dist.device)
    direct[g.vz.long()] = or_reduce(contrib, 1)
    return direct.permute(0, 2, 1).reshape(npad, words * batch)


def nexthop_fixpoint(g: BlockSpfGraph, dist, hops, direct, fdst, fid, limit: int):
    """Inherit fixpoint of the next-hop words, lane-packed [N_pad, W*B],
    starting from the direct words."""
    gate = (hops > 0).to(torch.int32)
    nh = direct
    for _ in range(limit):
        acc = kernels.nh_or(
            g.w, g.bsrc, g.bdst, g.seg, dist, gate, nh, direct, edges=edges_of(g)
        )
        acc = _correct_nh(g, dist, gate, direct, acc, fdst, fid)
        changed = read_flag("spf.flag.blocked_nexthop", (acc != nh).any())
        nh = acc
        if not changed:
            break
    return nh


# ---------------------------------------------------------------------------
# Full pipeline.


class BlockedSpfOut(NamedTuple):
    """[B, N] planes in the ORIGINAL vertex space (scalar-oracle layout)."""

    dist: torch.Tensor  # int32[B, N], INF unreachable
    parent: torch.Tensor  # int32[B, N], N if none
    hops: torch.Tensor  # int32[B, N], N+1 unreachable
    nexthops: torch.Tensor  # int32[B, N, W]: uint32 words as int32 bit patterns


def whatif_spf_blocked(
    g: BlockSpfGraph,
    failed_dst,  # int32[B, F] failed edges' dst (PERMUTED space)
    failed_id,  # int32[B, F] original edge ids (-1 pad)
    max_iters: int | None = None,
) -> BlockedSpfOut:
    """Batched full SPF on the blocked planes, on the planes' device.
    The failed-edge planes may be arrays or tensors."""
    device = g.w.device
    npad = g.in_src.shape[0]
    n = g.n_real
    fdst, fid = as_plane(failed_dst, device), as_plane(failed_id, device)
    batch = fdst.shape[0]
    words = int(g.z_words.shape[2])
    limit = npad if max_iters is None else max_iters

    dist = distance_fixpoint(g, g.rootp, fdst, fid, limit)
    _, parent_o = first_parent(g, dist, fdst, fid)
    hops = hops_fixpoint(g, parent_o, limit)
    direct = direct_words(g, dist, hops, fid)
    nh_cat = nexthop_fixpoint(g, dist, hops, direct, fdst, fid, limit)

    # assemble in original vertex space
    rows = g.orig2perm.long()
    dist_o = dist[rows].T  # [B, n]
    unreach = dist_o >= UNREACH
    parent_r = parent_o[rows].T
    nh_words = nh_cat.view(npad, words, batch).permute(0, 2, 1)  # [N_pad, B, W]
    return BlockedSpfOut(
        dist=torch.where(unreach, int(INF), dist_o).contiguous(),
        parent=torch.where(unreach | (parent_r >= n), n, parent_r).contiguous(),
        hops=torch.where(unreach, n + 1, hops[rows].T).contiguous(),
        nexthops=torch.where(
            unreach[:, :, None], 0, nh_words[rows].permute(1, 0, 2)
        ).contiguous(),
    )


def failed_edges_perm(
    perm_of: np.ndarray, topo: Topology, masks: np.ndarray, f_max: int = 4, device=None
):
    """Bool edge masks [B, E] -> (failed_dst_perm, failed_id) int32[B, F]
    tensors on ``device``.

    ``perm_of`` is the original -> permuted vertex map (``g.orig2perm``).
    """
    return failed_edges(
        np.asarray(perm_of)[topo.edge_dst], masks, f_max, resolve_device(device)
    )
