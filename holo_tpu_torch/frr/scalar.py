"""Scalar FRR oracle: the selection semantics in plain Python.

The port's copy of ``holo_tpu.frr.scalar``: an implementation with loops
over the port's reference Dijkstra (``spf_reference``), sharing no
vectorized code with :mod:`holo_tpu_torch.frr.kernel`, of the rules
documented there; the tests and the chip run require the two to be
bit-identical.  The all-roots matrix and the per-link post-convergence runs
use ``spf_reference``, whose planes are held to the device engines, so a
divergence localizes to the selection itself.
"""

from __future__ import annotations

import copy

import numpy as np

from holo_tpu_torch.frr.inputs import FrrInputs, marshal_frr
from holo_tpu_torch.frr.kernel import BackupTable
from holo_tpu_torch.ops.graph import INF, Topology
from holo_tpu_torch.spf.scalar import spf_reference

_INF = int(INF)


def _fadd(a: int, b: int) -> int:
    return a + b if a < _INF and b < _INF else _INF


def all_roots_dist(topo: Topology) -> np.ndarray:
    """int32[N, N] distance matrix (``[r, v]`` = from r to v) via per-root
    reference Dijkstra."""
    n = topo.n_vertices
    out = np.empty((n, n), np.int32)
    for r in range(n):
        t = copy.copy(topo)
        t.root = r
        out[r] = spf_reference(t).dist
    return out


def frr_reference(
    topo: Topology,
    n_atoms: int = 64,
    inputs: FrrInputs | None = None,
    srlg_disjoint: bool = False,
    node_protection: bool = False,
) -> BackupTable:
    """Compute the full backup table with scalar loops.

    ``srlg_disjoint``: exclude repair candidates sharing any SRLG bit
    with the protected link (the batched path's policy mask).  ``node_protection``: only node-protecting LFAs are
    selectable (inequality 3 as policy, not preference)."""
    fin = inputs if inputs is not None else marshal_frr(topo)
    n = topo.n_vertices
    root = int(topo.root)
    nl, na = fin.n_links, fin.n_adj
    is_router = topo.is_router
    d = all_roots_dist(topo)
    droot = d[root]
    w = max((max(n_atoms, topo.n_atoms()) + 31) // 32, 1)

    lfa_adj = np.full((nl, n), -1, np.int32)
    lfa_nodeprot = np.zeros((nl, n), np.int32)
    rlfa_pq = np.full((nl, n), -1, np.int32)
    tilfa_p = np.full((nl, n), -1, np.int32)
    tilfa_q = np.full((nl, n), -1, np.int32)
    post_dist = np.full((nl, n), _INF, np.int32)
    post_nh = np.zeros((nl, n, w), np.uint32)

    nbr = [int(x) for x in fin.adj_nbr[:na]]
    acost = [int(x) for x in fin.adj_cost[:na]]
    alink = [int(x) for x in fin.adj_link[:na]]

    def valid_d(dst: int) -> bool:
        return dst != root and int(droot[dst]) < _INF

    for l in range(nl):
        far = int(fin.link_far[l])
        lcost = int(fin.link_cost[l])
        post = spf_reference(topo, fin.edge_masks[l])
        post_dist[l] = post.dist
        post_nh[l] = post.nexthop_words(max(n_atoms, topo.n_atoms()))

        usable = [
            alink[a] != l
            and (
                not srlg_disjoint
                or (int(fin.link_srlg[l]) & int(fin.adj_srlg[a])) == 0
            )
            for a in range(na)
        ]

        # -- LFA (RFC 5286 inequalities 1 + 3, lexicographic pick)
        for dst in range(n):
            if not valid_d(dst):
                continue
            cands = []
            for a in range(na):
                if not usable[a]:
                    continue
                dn_d = int(d[nbr[a], dst])
                if not dn_d < _fadd(int(d[nbr[a], root]), int(droot[dst])):
                    continue
                nprot = dn_d < _fadd(int(d[nbr[a], far]), int(d[far, dst]))
                alt = _fadd(acost[a], dn_d)
                if alt < _INF:
                    cands.append((nprot, alt, nbr[a], a))
            if node_protection:
                cands = [c for c in cands if c[0]]
            if not cands:
                continue
            if any(c[0] for c in cands):
                cands = [c for c in cands if c[0]]
                lfa_nodeprot[l, dst] = 1
            _, _, _, best = min(cands, key=lambda c: (c[1], c[2], c[3]))
            lfa_adj[l, dst] = best

        # -- remote LFA (RFC 7490 P/Q intersection)
        def in_extp(v: int) -> bool:
            if int(droot[v]) < _fadd(lcost, int(d[far, v])):
                return True
            return any(
                usable[a]
                and int(d[nbr[a], v])
                < _fadd(int(d[nbr[a], root]), int(droot[v]))
                for a in range(na)
            )

        def in_qspace(v: int) -> bool:
            return int(d[v, far]) < _fadd(int(d[v, root]), lcost)

        pq = -1
        best_key = (_INF, n)
        for v in range(n):
            if v == root or not is_router[v]:
                continue
            if in_extp(v) and in_qspace(v):
                key = (int(droot[v]), v)
                if key < best_key:
                    best_key, pq = key, v
        if pq >= 0:
            for dst in range(n):
                if valid_d(dst) and int(d[pq, dst]) < _fadd(
                    int(d[pq, root]), int(droot[dst])
                ):
                    rlfa_pq[l, dst] = pq

        # -- TI-LFA along the post-convergence path
        for dst in range(n):
            if not valid_d(dst) or int(post.dist[dst]) >= _INF:
                continue
            # parent walk dst → root (acyclic SPT; sentinel n = none)
            path = []
            v = dst
            while v != root:
                path.append(v)
                v = int(post.parent[v])
                if v >= n:
                    path = None
                    break
            if path is None:
                continue
            path.reverse()  # first hop ... dst
            n1 = None
            p_node, s_node = root, -1
            for v in path:
                if n1 is None and is_router[v]:
                    n1 = v
                pmark = (
                    n1 is not None
                    and is_router[v]
                    and int(d[n1, v])
                    < _fadd(int(d[n1, root]), int(droot[v]))
                )
                if not is_router[v]:
                    pass  # pseudo-node: transparent for P and S
                elif pmark:
                    p_node, s_node = v, -1
                elif s_node < 0:
                    s_node = v
            if p_node < 0:
                continue
            if s_node < 0:
                tilfa_p[l, dst] = p_node
            elif int(d[s_node, dst]) < _fadd(
                int(d[s_node, root]), int(droot[dst])
            ):
                tilfa_p[l, dst] = p_node
                tilfa_q[l, dst] = s_node

    return BackupTable(
        inputs=fin,
        root=root,
        lfa_adj=lfa_adj,
        lfa_nodeprot=lfa_nodeprot,
        rlfa_pq=rlfa_pq,
        tilfa_p=tilfa_p,
        tilfa_q=tilfa_q,
        post_dist=post_dist,
        post_nh=post_nh,
    )
