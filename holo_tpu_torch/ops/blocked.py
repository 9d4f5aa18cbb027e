"""Block-sparse dense min-plus SSSP (what-if distances).

Port of ``holo_tpu/ops/blocked.py``.  The relax step is dense min-plus over
the nonzero S x S blocks of the adjacency matrix,

    acc[v, b] = min_u W[u, v] + dist[u, b]        (per nonzero block)

run by the hand-written CUDA kernel :func:`holo_tpu_torch.kernels.blocked.relax`,
which walks only the block entries that are edges (the per-pair CSC of
:func:`edge_planes`, built beside the dense planes at marshal).
What-if link failures stay exact without per-scenario weights: the kernel
runs on the static graph, then a small correction recomputes the failed
edges' destination rows from their ELL in-edge lists with the failed slots
masked (only those rows can differ; the Jacobi fixpoint is preserved).
Scenarios ride the lane dimension (dist is [N_pad, B]).

Arithmetic uses CAP = 1<<28 as infinity with inputs re-capped every round,
keeping sums exact in int32 (real distances must stay below 1<<27 --
validated at marshal).  Outputs restore the canonical INF.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from holo_tpu_torch.analysis.runtime import read_flag
from holo_tpu_torch.device import resolve_device
from holo_tpu_torch.kernels import blocked as kernels
from holo_tpu_torch.ops.graph import INF, Topology, build_ell

CAP = 1 << 28
UNREACH = 1 << 27  # values >= this are unreachable
S = 256  # vertex block size


class BlockGraph(NamedTuple):
    w: torch.Tensor  # int32[P, S, S] -- w[p, u_local, v_local], CAP-filled
    bsrc: torch.Tensor  # int32[P] source block ids (sorted by bdst)
    bdst: torch.Tensor  # int32[P]
    seg: torch.Tensor  # int32[nb + 1] pair offsets per destination block
    # compact edge planes: the entries < CAP of w, per-pair CSC (edge_planes)
    cptr: torch.Tensor  # int32[P, S + 1]
    crow: torch.Tensor  # int32[nnz] u_local
    cw: torch.Tensor  # int32[nnz]
    border: torch.Tensor  # int32[nb] destination blocks, heaviest walk first
    # ELL planes for the correction pass:
    in_src: torch.Tensor  # int32[N_pad, K]
    in_cost: torch.Tensor  # int32[N_pad, K]
    in_valid: torch.Tensor  # bool[N_pad, K]
    in_edge_id: torch.Tensor  # int32[N_pad, K]
    n_real: int  # actual vertex count (<= N_pad)


def check_blocked_preconditions(topo: Topology) -> None:
    """Raise ValueError unless the topology fits the blocked engine:
    unique (src, dst) pairs and worst finite distance below UNREACH."""
    n = topo.n_vertices
    keys = topo.edge_src.astype(np.int64) * n + topo.edge_dst
    if len(np.unique(keys)) != topo.n_edges:
        raise ValueError("parallel (src,dst) edges: merge before marshaling")
    max_cost = int(topo.edge_cost.max()) if topo.n_edges else 0
    if (n - 1) * max_cost >= UNREACH:
        raise ValueError(
            f"distance bound (n-1)*max_cost = {(n - 1) * max_cost} "
            f">= {UNREACH}: the blocked engine is exact only below 2**27"
        )


def block_pairs(src: np.ndarray, dst: np.ndarray, cost: np.ndarray, n: int) -> dict:
    """The nonzero S x S block pairs of the adjacency, sorted by destination.

    Every destination block gets at least one pair (an identity CAP-only
    pair where it has no in-edges), as in the JAX marshal.
    """
    nb = (n + S - 1) // S
    key = (dst // S).astype(np.int64) * nb + (src // S)
    missing = sorted(set(range(nb)) - set((key // nb).tolist()))
    key_all = np.concatenate([key, np.array([m * nb + m for m in missing], np.int64)])
    uniq, inv_all = np.unique(key_all, return_inverse=True)
    p = len(uniq)
    bsrc = (uniq % nb).astype(np.int32)
    bdst = (uniq // nb).astype(np.int32)
    w = np.full((max(p, 1), S, S), CAP, np.int32)
    w[inv_all[: len(key)], src % S, dst % S] = np.minimum(cost, CAP)
    return {"w": w, "bsrc": bsrc, "bdst": bdst, **edge_planes(w)}


def edge_planes(w: np.ndarray) -> dict:
    """Per-pair CSC of the entries < CAP of the dense planes ``w`` [P, S, S].

    Entries are sorted by (pair, v_local, u_local).  Column ``v`` of pair
    ``p`` holds source rows ``crow[cptr[p, v]:cptr[p, v + 1]]`` with weights
    ``cw`` at the same offsets; offsets run over all pairs, so
    ``cptr[p, S] == cptr[p + 1, 0]``.  A pair without edges (the identity
    pair of a block with no in-edges) has empty columns.
    """
    p, u, v = np.nonzero(w < CAP)
    key = (p.astype(np.int64) * S + v) * S + u
    order = np.argsort(key)
    starts = (np.arange(w.shape[0], dtype=np.int64)[:, None] * S + np.arange(S + 1)) * S
    return {
        "cptr": np.searchsorted(key[order], starts).astype(np.int32),
        "crow": u[order].astype(np.int32),
        "cw": w[p, u, v][order],
    }


def ell_planes(topo: Topology, npad: int, n_atoms: int) -> dict:
    """ELL in-edge planes padded to ``npad`` rows."""
    ell = build_ell(topo, n_atoms=n_atoms)
    out = {}
    for name in ("in_src", "in_cost", "in_valid", "in_edge_id"):
        a = getattr(ell, name)
        pad = np.zeros((npad, ell.k_pad), a.dtype)
        pad[: topo.n_vertices] = a
        out[name] = pad
    return out


def block_order(cptr: np.ndarray, bdst: np.ndarray, nb: int) -> np.ndarray:
    """Destination blocks by descending edge-walk work (CSC entries plus S
    per pair), ties in block order.  The tile kernels start the heaviest
    blocks first, so that the last ones on the card are short."""
    per_pair = cptr[: len(bdst), S] - cptr[: len(bdst), 0] + S
    work = np.bincount(bdst, weights=per_pair, minlength=nb)
    return np.argsort(-work, kind="stable").astype(np.int32)


def edges_of(g) -> tuple:
    """The compact edge planes (cptr, crow, cw, border) that the kernels
    walk."""
    return g.cptr, g.crow, g.cw, g.border


def tensors_on(arrays: dict, device: torch.device) -> dict:
    """numpy planes -> tensors on ``device``; block-pair offsets ``seg``
    are derived from ``bdst``, the block order ``border`` from ``cptr``."""
    out = {k: torch.tensor(a, device=device) for k, a in arrays.items()}
    nb = arrays["in_src"].shape[0] // S
    seg = np.searchsorted(arrays["bdst"], np.arange(nb + 1)).astype(np.int32)
    out["seg"] = torch.tensor(seg, device=device)
    order = block_order(arrays["cptr"], arrays["bdst"], nb)
    out["border"] = torch.tensor(order, device=device)
    return out


def block_graph(arrays: dict, n_real: int, device: torch.device) -> BlockGraph:
    t = tensors_on({k: arrays[k] for k in BlockGraph._fields if k in arrays}, device)
    return BlockGraph(n_real=n_real, **t)


def marshal_blocks(topo: Topology, device=None) -> BlockGraph:
    """Lower a Topology to block-sparse W + ELL correction planes."""
    device = resolve_device(device)
    check_blocked_preconditions(topo)
    n = topo.n_vertices
    npad = ((n + S - 1) // S) * S
    arrays = block_pairs(topo.edge_src, topo.edge_dst, topo.edge_cost, n)
    arrays.update(ell_planes(topo, npad, max(topo.n_atoms(), 1)))
    return block_graph(arrays, n, device)


def row_plan(g, v: torch.Tensor, fid: torch.Tensor):
    """Gather plan for one failed-destination slot column ``v`` [B].

    Returns (v_safe, idx, wcost, valid, brange): the rows' in-edge sources,
    costs and validity with ALL of each scenario's failed edge ids masked.
    """
    brange = torch.arange(v.shape[0], device=v.device)
    v_safe = v.clamp_min(0).long()
    idx = g.in_src[v_safe].long()  # [B, K]
    eid = g.in_edge_id[v_safe]
    excl = ((eid[:, :, None] == fid[:, None, :]) & (fid[:, None, :] >= 0)).any(2)
    return v_safe, idx, g.in_cost[v_safe], g.in_valid[v_safe] & ~excl, brange


def correct_dist(g, dist_prev, acc, fdst, fid):
    """Exact repair of failed-edge destination rows, in place on ``acc``.

    fdst/fid: int32[B, F] failed directed edges per scenario (-1 pad).
    """
    for f in range(fdst.shape[1]):
        v = fdst[:, f]
        v_safe, idx, wcost, valid, brange = row_plan(g, v, fid)
        dvals = dist_prev[idx, brange[:, None]]  # [B, K]
        cand = torch.where(valid & (dvals < UNREACH), dvals + wcost, CAP)
        new_v = torch.minimum(dist_prev[v_safe, brange], cand.amin(1))
        acc[v_safe, brange] = torch.where(v >= 0, new_v, acc[v_safe, brange])
    return acc


def distance_fixpoint(g, root: int, fdst, fid, limit: int) -> torch.Tensor:
    """Jacobi min-plus fixpoint with failed-row repair: int32[N_pad, B],
    CAP-capped.  One host sync per round (the convergence test)."""
    npad, batch = g.in_src.shape[0], fdst.shape[0]
    dist = torch.full((npad, batch), CAP, dtype=torch.int32, device=g.w.device)
    dist[root] = 0
    for _ in range(limit):
        capped = dist.clamp_max(CAP)
        acc = kernels.relax(g.w, g.bsrc, g.bdst, g.seg, capped, edges=edges_of(g))
        acc = correct_dist(g, capped, acc, fdst, fid)
        changed = read_flag("spf.flag.blocked_relax", (acc != dist).any())
        dist = acc
        if not changed:
            break
    return dist.clamp_max(CAP)


def as_plane(a, device: torch.device) -> torch.Tensor:
    """int32 tensor on ``device`` from a tensor or an array."""
    return torch.as_tensor(a, dtype=torch.int32, device=device)


def whatif_distances_blocked(
    g: BlockGraph,
    root: int,
    failed_dst,  # int32[B, F] (array or tensor)
    failed_id,
    max_iters: int | None = None,
) -> torch.Tensor:
    """Batched what-if distances: int32[B, N] with canonical INF."""
    device = g.w.device
    fdst, fid = as_plane(failed_dst, device), as_plane(failed_id, device)
    limit = g.in_src.shape[0] if max_iters is None else max_iters
    dist = distance_fixpoint(g, root, fdst, fid, limit)
    out = dist[: g.n_real].T
    return torch.where(out >= UNREACH, int(INF), out).contiguous()


def failed_edges_from_masks(topo: Topology, masks: np.ndarray, f_max: int = 4, device=None):
    """Bool edge masks [B, E] -> (failed_dst, failed_id) int32[B, f_max]
    tensors on ``device``, failed edges in ascending id order, -1 padded."""
    return failed_edges(topo.edge_dst, masks, f_max, resolve_device(device))


def failed_edges(dst_of_edge: np.ndarray, masks: np.ndarray, f_max: int, device: torch.device):
    """(dst_of_edge[e], e) for every failed edge e of each scenario.

    The [B, E] masks are scanned on ``device``: at 1024 scenarios of a
    729k-edge graph they are 746 MB, which a host scan takes seconds over.
    """
    failed = ~torch.from_numpy(np.asarray(masks, bool)).to(device)
    batch = failed.shape[0]
    b_idx, e_idx = failed.nonzero(as_tuple=True)  # by scenario, then edge id
    counts = torch.bincount(b_idx, minlength=batch)
    if batch and int(counts.max()) > f_max:
        b = int(torch.nonzero(counts > f_max)[0, 0])
        raise ValueError(f"scenario {b}: {int(counts[b])} failures > {f_max}")
    slot = torch.arange(b_idx.shape[0], device=device) - torch.searchsorted(b_idx, b_idx)
    dst = torch.from_numpy(np.asarray(dst_of_edge, np.int32)).to(device)
    fdst = torch.full((batch, f_max), -1, dtype=torch.int32, device=device)
    fid = torch.full((batch, f_max), -1, dtype=torch.int32, device=device)
    fdst[b_idx, slot] = dst[e_idx]
    fid[b_idx, slot] = e_idx.to(torch.int32)
    return fdst, fid
