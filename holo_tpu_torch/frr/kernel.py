"""Batched FRR: all-roots SPF + LFA / remote-LFA / TI-LFA selection.

The port's counterpart of ``holo_tpu.frr.kernel`` (``frr_batch``, which
XLA compiles into one program there).  One call computes

1. ``D``, the all-roots distance matrix: one lane per vertex through the
   gather engine's distance fixpoint (``ell_relax`` at B = N lanes, no
   mask), in its layout: ``D[v, r]`` is the distance from r to v, so JAX's
   row ``D[r]`` is a column here and JAX's column ``D[:, c]`` a row;
2. the post-convergence SPF of every protected link (the what-if batch
   over the per-link failure masks: dist, parent and next-hop planes);
3. the repair selection (:func:`frr_select`), as torch tensor programs
   over those planes, all int32 [L, N] (``-1`` = none):

   - **LFA** (RFC 5286): candidate ``a`` protects ``(l, d)`` iff it does
     not ride link ``l`` and ``D[nbr_a, d] < D[nbr_a, root] + D[root, d]``;
     node-protecting candidates (``D[nbr_a, d] < D[nbr_a, far_l] +
     D[far_l, d]``) are preferred; within a class the alternate minimizing
     ``(adj_cost + D[nbr, d], nbr, a)`` wins.
   - **Remote LFA** (RFC 7490): per link, the PQ node minimizing
     ``(D[root, pq], pq)`` over extended P-space, Q-space and routers; a
     destination is covered when ``D[pq, d] < D[pq, root] + D[root, d]``.
   - **TI-LFA**: along each destination's post-convergence path, ``P`` is
     the last router loop-free reachable from the path's first router and
     ``Q`` the next router after it; the (release neighbor, P, successor)
     values propagate down the post SPT in Jacobi rounds, one host sync a
     round, at most ``2 N + 4`` (``2 max_iters + 4``) rounds.

``D[a, b]`` above is JAX's orientation (from a to b).  All comparisons are
exact int32 with INF-guarded sums, bit-identical to ``holo_tpu`` and to
the scalar oracle (:mod:`holo_tpu_torch.frr.scalar`).

Memory: ``D`` is [N, N] int32 (410 MB at 10,125 vertices) and the LFA
stage holds a few [L, A, N] temporaries.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from holo_tpu_torch.analysis.runtime import read_flag, sanctioned_transfer
from holo_tpu_torch.device import HostCopy
from holo_tpu_torch.frr.inputs import FrrInputs
from holo_tpu_torch.kernels import ell
from holo_tpu_torch.ops.graph import INF as _INF
from holo_tpu_torch.ops.spf_engine import (
    DeviceGraph,
    SpfTensors,
    distance_fixpoint,
    lane_planes,
    spf_whatif_batch,
)

INF = int(_INF)


class FrrTensors(NamedTuple):
    """Selection tables on the device (padded shapes)."""

    lfa_adj: torch.Tensor  # int32[L, N] candidate index or -1
    lfa_nodeprot: torch.Tensor  # int32[L, N] 1 = chosen LFA node-protects
    rlfa_pq: torch.Tensor  # int32[L, N] PQ vertex or -1
    tilfa_p: torch.Tensor  # int32[L, N] P vertex or -1
    tilfa_q: torch.Tensor  # int32[L, N] Q vertex or -1 (single segment)
    post_dist: torch.Tensor  # int32[L, N]
    post_nh: torch.Tensor  # int32[L, N, W] post-convergence atom words (uint32 bits)


def _fadd(a, b):
    """INF-guarded int32 sum: INF when either side is unreachable."""
    return torch.where((a < INF) & (b < INF), a + b, INF)


def _plane(x, device, dtype=torch.int32) -> torch.Tensor:
    """A host array or tensor as a ``dtype`` tensor on ``device``; uint32
    SRLG masks keep their bit patterns as int32."""
    if isinstance(x, np.ndarray) and x.dtype == np.uint32:
        x = x.view(np.int32)
    with sanctioned_transfer("frr.batch.marshal"):
        return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x).to(device, dtype)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def frr_select(
    D: torch.Tensor,
    post: SpfTensors,
    root: int,
    is_router,
    link_far,
    link_cost,
    link_valid,
    adj_nbr,
    adj_cost,
    adj_link,
    adj_valid,
    link_srlg=None,
    adj_srlg=None,
    require_np: bool = False,
    max_iters: int | None = None,
    stats: dict | None = None,
    link_offset: int = 0,
) -> FrrTensors:
    """The selection stages of :func:`frr_batch` over ``D`` (int32 [N, N],
    ``D[v, r]`` = distance from r to v) and ``post`` (the per-link
    post-convergence SpfTensors, [L, N] planes): LFA, remote LFA and
    TI-LFA on ``D``'s device.  ``link_srlg`` / ``adj_srlg`` (uint32 SRLG
    bitmasks): a candidate sharing any risk group with the protected link is
    excluded (all-zero planes exclude nothing).  ``require_np`` makes node
    protection a hard LFA policy.  ``stats``, when given, receives each
    stage's host milliseconds (ended by a device sync) and TI-LFA's rounds.
    ``link_offset``: the id of the first of these links (a mesh's batch
    shard holds a run of them), which a candidate's ``adj_link`` names."""
    dev = D.device
    n = D.shape[0]
    root = int(root)
    is_rtr = _plane(is_router, dev, torch.bool)
    link_far = _plane(link_far, dev).long()
    link_cost = _plane(link_cost, dev)
    link_valid = _plane(link_valid, dev, torch.bool)
    adj_nbr_i = _plane(adj_nbr, dev)
    adj_nbr = adj_nbr_i.long()
    adj_cost = _plane(adj_cost, dev)
    adj_link = _plane(adj_link, dev)
    adj_valid = _plane(adj_valid, dev, torch.bool)
    nlinks, nadj = link_far.shape[0], adj_nbr.shape[0]
    vidx = torch.arange(n, dtype=torch.int32, device=dev)
    t0 = time.perf_counter()

    droot = D[:, root]  # [N]: JAX's D[root]
    d_to_root = D[root]  # [N]: JAX's D[:, root]
    valid_d = (droot < INF) & (vidx != root)

    # -- LFA inequalities + lexicographic selection.
    dn = D[:, adj_nbr].T  # [A, N]: JAX's D[adj_nbr]
    dn_root = d_to_root[adj_nbr]  # [A]
    loopfree = adj_valid[:, None] & (dn < _fadd(dn_root[:, None], droot[None, :]))
    usable = (
        adj_valid[None, :]
        & link_valid[:, None]
        & (adj_link[None, :] != link_offset + torch.arange(nlinks, device=dev)[:, None])
    )  # [L, A]
    if link_srlg is not None and adj_srlg is not None:
        usable &= (_plane(link_srlg, dev)[:, None] & _plane(adj_srlg, dev)[None, :]) == 0
    dfar = D[:, link_far].T  # [L, N]: JAX's D[link_far]
    dn_far = D[link_far][:, adj_nbr]  # [L, A]: JAX's D[nbr_a, far_l]
    nodeprot = dn[None] < _fadd(dn_far[:, :, None], dfar[:, None, :])  # [L, A, N]
    cand = usable[:, :, None] & loopfree[None] & valid_d[None, None, :]
    np_cand = cand & nodeprot
    del nodeprot
    has_np = np_cand.any(1)  # [L, N]
    # Under require_np the preference becomes policy: only node-protecting
    # candidates are selectable at all.
    sel = np_cand if bool(require_np) else torch.where(has_np[:, None, :], np_cand, cand)
    del cand, np_cand
    altdist = _fadd(adj_cost[:, None], dn)  # [A, N]
    m1 = torch.where(sel, altdist[None], INF).amin(1)  # [L, N]
    sel &= (altdist[None] == m1[:, None]) & (m1 < INF)[:, None]
    m2 = torch.where(sel, adj_nbr_i[None, :, None], n).amin(1)
    sel &= adj_nbr_i[None, :, None] == m2[:, None]
    aidx = torch.arange(nadj, dtype=torch.int32, device=dev)
    m3 = torch.where(sel, aidx[None, :, None], nadj).amin(1)
    del sel
    lfa_adj = torch.where(m1 < INF, m3, -1).to(torch.int32)
    lfa_nodeprot = ((lfa_adj >= 0) & has_np).to(torch.int32)

    # -- Remote LFA: extended P-space and Q-space, one PQ node per link.
    pspace = droot[None, :] < _fadd(link_cost[:, None], dfar)  # [L, N]
    ext_any = (usable[:, :, None] & loopfree[None]).any(1)
    extp = (pspace | ext_any) & link_valid[:, None]
    dto_far = D[link_far]  # [L, N]: JAX's D[:, link_far].T
    qspace = dto_far < _fadd(d_to_root[None, :], link_cost[:, None])
    pq_cand = extp & qspace & is_rtr[None, :] & (vidx != root)[None, :]
    kq = torch.where(pq_cand, droot[None, :], INF)
    mq = kq.amin(1)  # [L]
    vq = torch.where(pq_cand & (kq == mq[:, None]), vidx[None, :], n).amin(1)
    pq = torch.where(mq < INF, vq, -1).to(torch.int32)  # [L]
    pqc = pq.clamp(0, n - 1).long()
    dpq = D[:, pqc].T  # [L, N]: JAX's D[pqc]
    rlfa_ok = (
        (pq >= 0)[:, None]
        & (dpq < _fadd(d_to_root[pqc][:, None], droot[None, :]))
        & valid_d[None, :]
    )
    rlfa_pq = torch.where(rlfa_ok, pq[:, None], -1).to(torch.int32)
    if stats is not None:
        _sync(dev)
    t1 = time.perf_counter()

    # -- TI-LFA: release neighbor (n1), last loop-free router (P) and its
    # successor (S), propagated down the post SPT.
    par = post.parent  # [L, N], n = no parent
    parc = par.clamp(0, n - 1).long()
    has_par = par < n
    at_root = (vidx == root)[None, :]
    stop = at_root | ~has_par
    limit = (2 * n + 4) if max_iters is None else (2 * int(max_iters) + 4)
    n1 = torch.full((nlinks, n), n, dtype=torch.int32, device=dev)  # n = none yet
    p = torch.where(at_root, root, -1).to(torch.int32).expand(nlinks, n).contiguous()
    s = torch.full((nlinks, n), -1, dtype=torch.int32, device=dev)
    rounds = 0
    changed = True
    while changed and rounds < limit:
        n1_u, p_u, s_u = n1.gather(1, parc), p.gather(1, parc), s.gather(1, parc)
        # First router on the path (the repair's release neighbor).
        n1_new = torch.where(
            stop, n, torch.where(n1_u < n, n1_u, torch.where(is_rtr[None, :], vidx[None, :], n))
        ).to(torch.int32)
        # v is loop-free reachable from its release neighbor: the P mark.
        n1c = n1_new.clamp(0, n - 1).long()
        d_n1_v = D.gather(1, n1c.T).T  # JAX's D[n1c, vidx]
        pmark = (
            (n1_new < n)
            & is_rtr[None, :]
            & (d_n1_v < _fadd(d_to_root[n1c], droot[None, :]))
        )
        p_new = torch.where(
            at_root, root, torch.where(~has_par, -1, torch.where(pmark, vidx[None, :], p_u))
        ).to(torch.int32)
        s_new = torch.where(
            stop,
            -1,
            torch.where(
                ~is_rtr[None, :],
                s_u,
                torch.where(pmark, -1, torch.where(s_u >= 0, s_u, vidx[None, :])),
            ),
        ).to(torch.int32)
        changed = read_flag("frr.flag.tilfa", ((n1_new != n1) | (p_new != p) | (s_new != s)).any())
        n1, p, s = n1_new, p_new, s_new
        rounds += 1

    ok = link_valid[:, None] & valid_d[None, :] & (post.dist < INF) & (p >= 0)
    sc = s.clamp(0, n - 1).long()
    d_s = D.gather(1, sc.T).T  # JAX's D[S, d]
    tail_ok = d_s < _fadd(d_to_root[sc], droot[None, :])
    single = s < 0
    double = (s >= 0) & tail_ok
    tilfa_p = torch.where(ok & (single | double), p, -1).to(torch.int32)
    tilfa_q = torch.where(ok & double, s, -1).to(torch.int32)
    if stats is not None:
        _sync(dev)
        stats.update(lfa_rlfa_ms=(t1 - t0) * 1e3, tilfa_rounds=rounds,
                     tilfa_ms=(time.perf_counter() - t1) * 1e3)
    return FrrTensors(
        lfa_adj=lfa_adj,
        lfa_nodeprot=lfa_nodeprot,
        rlfa_pq=rlfa_pq,
        tilfa_p=tilfa_p,
        tilfa_q=tilfa_q,
        post_dist=post.dist,
        post_nh=post.nexthops,
    )


def all_roots(g: DeviceGraph, max_iters: int | None = None) -> torch.Tensor:
    """The all-roots distance matrix int32 [N, N] (``D[v, r]`` = distance
    from r to v): the distance fixpoint with one lane per vertex, no mask."""
    n = g.in_src.shape[0]
    limit = n if max_iters is None else max_iters
    roots = torch.arange(n, dtype=torch.int32, device=g.in_src.device)
    return distance_fixpoint(lane_planes(g, None), roots, limit)


def frr_batch(
    g: DeviceGraph,
    root,
    link_far,
    link_cost,
    link_valid,
    edge_masks,
    adj_nbr,
    adj_cost,
    adj_link,
    adj_valid,
    link_srlg=None,
    adj_srlg=None,
    require_np: bool = False,
    max_iters: int | None = None,
    stats: dict | None = None,
) -> FrrTensors:
    """``holo_tpu``'s ``frr_batch`` on ``g``'s device: ``D``
    (:func:`all_roots`), the post-convergence batch over ``edge_masks``
    (bool [L, E]), then :func:`frr_select`.  ``stats``, when given, receives
    each stage's host milliseconds (each ended by a device sync), the
    ``ell_relax`` launches of ``D`` and TI-LFA's rounds."""
    dev = g.in_src.device
    t0 = time.perf_counter()
    relax0 = ell.launches["ell_relax"]
    D = all_roots(g, max_iters)
    if stats is not None:
        _sync(dev)
        stats.update(d_ms=(time.perf_counter() - t0) * 1e3,
                     d_launches=ell.launches["ell_relax"] - relax0)
    t1 = time.perf_counter()
    post = spf_whatif_batch(g, int(root), edge_masks, max_iters)
    if stats is not None:
        _sync(dev)
        stats["post_ms"] = (time.perf_counter() - t1) * 1e3
    return frr_select(D, post, root, g.is_router, link_far, link_cost, link_valid, adj_nbr,
                      adj_cost, adj_link, adj_valid, link_srlg, adj_srlg, require_np,
                      max_iters, stats)


@dataclass
class BackupTable:
    """Host-side backup tables for one topology (unpadded), produced by the
    batched path or the scalar oracle, bit-identical."""

    inputs: FrrInputs
    root: int
    lfa_adj: np.ndarray  # int32[L, N]
    lfa_nodeprot: np.ndarray  # int32[L, N]
    rlfa_pq: np.ndarray  # int32[L, N]
    tilfa_p: np.ndarray  # int32[L, N]
    tilfa_q: np.ndarray  # int32[L, N]
    post_dist: np.ndarray  # int32[L, N]
    post_nh: np.ndarray  # uint32[L, N, W]

    @property
    def n_links(self) -> int:
        return self.inputs.n_links

    def link_of_atom(self, atom: int) -> int | None:
        return self.inputs.atom_link.get(atom)

    def coverage(self) -> float:
        """Fraction of (protected link, protectable destination) pairs with
        any repair."""
        protected = (self.lfa_adj >= 0) | (self.rlfa_pq >= 0) | (self.tilfa_p >= 0)
        # Destinations a repair could exist for: still reachable after the
        # failure (a cut destination is unprotectable by definition).
        eligible = self.post_dist < INF
        eligible[:, self.root] = False
        denom = int(eligible.sum())
        if denom == 0:
            return 1.0
        return float((protected & eligible).sum()) / denom


TABLE_PLANES = ("lfa_adj", "lfa_nodeprot", "rlfa_pq", "tilfa_p", "tilfa_q", "post_dist",
                "post_nh")


def backup_table(out: FrrTensors, fin: FrrInputs, root: int, n: int) -> BackupTable:
    """Read the device tables back in two copies (the six [L, N] planes
    stacked, then the next-hop words as uint32), the link pad and any vertex
    pad dropped."""
    return host_tables(stage_tables(out, fin, n, queue=False), fin, root)


def stage_tables(out: FrrTensors, fin: FrrInputs, n: int, queue: bool = True) -> HostCopy:
    """Queue :func:`backup_table`'s two copies (pinned host memory on the
    card) behind the program that made ``out``; :func:`host_tables` waits.
    ``queue=False``: the wait reads them back with ``.cpu()``."""
    nl = fin.n_links
    stacked = torch.stack([getattr(out, f)[:nl, :n] for f in TABLE_PLANES[:-1]])
    return HostCopy({"stacked": stacked, "post_nh": out.post_nh[:nl, :n]}, queue)


def host_tables(staged: HostCopy, fin: FrrInputs, root: int) -> BackupTable:
    """The BackupTable of :func:`stage_tables`' copies, once they landed."""
    h = staged.wait()
    host = dict(zip(TABLE_PLANES[:-1], h["stacked"].numpy()))
    host["post_nh"] = h["post_nh"].numpy().view(np.uint32)
    return BackupTable(inputs=fin, root=int(root), **host)
