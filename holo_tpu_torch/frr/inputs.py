"""FRR input marshaling: Topology -> protected links + repair candidates.

The port's copy of ``holo_tpu.frr.inputs``, with the edge scans done by
numpy instead of Python loops over the edges; every field equals
``holo_tpu``'s.  Shapes are padded to a multiple of ``pad_multiple``.
Padding rows carry ``valid == False`` and are result-neutral: the selection
and the scalar oracle both mask them out.

Model (shared by the selection and the oracle):

- A *protected link* is a root out-edge: one per p2p neighbor edge and one
  per attached transit network (the interface).  Its failure masks the edge
  and its first reverse edge (both directions of the link); for parallel
  p2p links the reverse is the first matching edge, so siblings share it.
- A *repair candidate* (adjacency) is a direct next hop the root could
  repair through: a root out-edge to a router carrying a next-hop atom, or a
  (root-adjacent network -> member router) edge with an atom.  Each rides
  exactly one protected link (``adj_link``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def _round_up(x: int, m: int) -> int:
    return ((max(x, 1)) + m - 1) // m * m


@dataclass
class FrrInputs:
    """Host-side padded FRR tables for one topology root."""

    # Protected links (root out-edges); padded with valid=False.
    link_edge: np.ndarray  # int32[Lp] edge id (-1 pad)
    link_far: np.ndarray  # int32[Lp] far-end vertex (0 pad)
    link_cost: np.ndarray  # int32[Lp]
    link_valid: np.ndarray  # bool[Lp]
    edge_masks: np.ndarray  # bool[Lp, E] post-convergence scenario masks
    link_srlg: np.ndarray  # uint32[Lp] SRLG bitmask of the link's edge (0 pad)
    # Repair candidates; padded with valid=False.
    adj_edge: np.ndarray  # int32[Ap] edge id of the candidate edge
    adj_nbr: np.ndarray  # int32[Ap] neighbor router vertex
    adj_cost: np.ndarray  # int32[Ap] root->neighbor cost over this candidate
    adj_link: np.ndarray  # int32[Ap] protected-link index it rides (-1 pad)
    adj_atom: np.ndarray  # int32[Ap] direct next-hop atom id
    adj_valid: np.ndarray  # bool[Ap]
    adj_srlg: np.ndarray  # uint32[Ap] SRLG bitmask of the candidate edge(s)
    n_links: int  # unpadded L
    n_adj: int  # unpadded A
    # next-hop atom id -> protected link index (which interface an installed
    # primary next hop rides), in first-occurrence order.
    atom_link: dict

    @property
    def shape_key(self) -> tuple:
        return (self.link_valid.shape[0], self.adj_valid.shape[0], self.edge_masks.shape[1])


def _reverse_edges(src: np.ndarray, dst: np.ndarray, root: int, far: np.ndarray) -> np.ndarray:
    """The first edge far -> root (in edge order) of each link's far end, -1
    where there is none: what ``dict.setdefault`` over the edges in order
    gives for the pair.  Only the root's in-edges are looked at."""
    first: dict[int, int] = {}
    for e in np.nonzero(dst == root)[0].tolist():
        first.setdefault(int(src[e]), e)
    return np.array([first.get(int(f), -1) for f in far], np.int64)


def marshal_frr(topo, pad_multiple: int = 8) -> FrrInputs:
    """Build the padded FRR tables for ``topo.root``."""
    root = int(topo.root)
    n = int(topo.n_vertices)
    src = np.asarray(topo.edge_src, np.int64)
    dst = np.asarray(topo.edge_dst, np.int64)
    cost = np.asarray(topo.edge_cost, np.int64)
    atom = np.asarray(topo.edge_direct_atom, np.int64)
    srlg = np.asarray(topo.edge_srlg, np.uint32)
    is_router = np.asarray(topo.is_router, bool)
    n_edges = int(topo.n_edges)

    # Protected links: root out-edges, in edge order; each masks its edge
    # and the first edge of the reverse pair.
    link_edge = np.nonzero(src == root)[0]
    nlinks = link_edge.shape[0]
    far = dst[link_edge]
    rev = _reverse_edges(src, dst, root, far)

    # Repair candidates.  A link to a router with an atom is one candidate;
    # a link to a network contributes the network's eligible member edges
    # (atom, member not the root, member a router) in edge order.
    elig = np.nonzero((atom >= 0) & (dst != root) & is_router[dst])[0]
    elig = elig[np.argsort(src[elig], kind="stable")]
    per_src = np.bincount(src[elig], minlength=n)
    start = np.cumsum(per_src) - per_src
    lan = ~is_router[far]
    link_atom = atom[link_edge]
    count = np.where(lan, per_src[far], (link_atom >= 0).astype(np.int64))
    cand_link = np.repeat(np.arange(nlinks), count)
    pos = np.arange(cand_link.shape[0]) - np.repeat(np.cumsum(count) - count, count)
    cand_lan = lan[cand_link]
    e1 = link_edge[cand_link]
    at = np.nonzero(cand_lan)[0]
    leg = elig[start[far[cand_link[at]]] + pos[at]]  # the network->member edges
    adj_edge = e1.copy()
    adj_edge[at] = leg
    adj_nbr = dst[adj_edge]
    adj_cost = cost[e1].copy()
    adj_cost[at] += cost[leg]
    # The LAN repair rides our interface edge AND the network->member leg:
    # its risk set is the union.
    adj_srlg = srlg[e1].copy()
    adj_srlg[at] |= srlg[leg]
    adj_atom = atom[adj_edge]
    nadj = adj_edge.shape[0]

    # atom -> link, first occurrence: each link's own atom, then its LAN
    # members' atoms, link by link.
    atom_link: dict[int, int] = {}
    c0 = 0
    for l in range(nlinks):
        if link_atom[l] >= 0:
            atom_link.setdefault(int(link_atom[l]), l)
        if lan[l]:
            for a in adj_atom[c0:c0 + count[l]]:
                atom_link.setdefault(int(a), l)
        c0 += int(count[l])

    lp = _round_up(nlinks, pad_multiple)
    ap = _round_up(nadj, pad_multiple)

    def pad(vals, size, fill, dtype=np.int32):
        out = np.full(size, fill, dtype)
        out[: len(vals)] = np.asarray(vals).astype(dtype)
        return out

    link_valid = np.zeros(lp, bool)
    link_valid[:nlinks] = True
    adj_valid = np.zeros(ap, bool)
    adj_valid[:nadj] = True
    # Pad scenarios keep every edge up: their post-SPF equals the base SPF,
    # and every output row is masked by link_valid anyway.
    masks_p = np.ones((lp, n_edges), bool)
    masks_p[np.arange(nlinks), link_edge] = False
    has_rev = rev >= 0
    masks_p[np.nonzero(has_rev)[0], rev[has_rev]] = False

    return FrrInputs(
        link_edge=pad(link_edge, lp, -1),
        link_far=pad(far, lp, 0),
        link_cost=pad(cost[link_edge], lp, 1),
        link_valid=link_valid,
        edge_masks=masks_p,
        link_srlg=pad(srlg[link_edge], lp, 0, np.uint32),
        adj_edge=pad(adj_edge, ap, -1),
        adj_nbr=pad(adj_nbr, ap, 0),
        adj_cost=pad(adj_cost, ap, 1),
        adj_link=pad(cand_link, ap, -1),
        adj_atom=pad(adj_atom, ap, -1),
        adj_valid=adj_valid,
        adj_srlg=pad(adj_srlg, ap, 0, np.uint32),
        n_links=int(nlinks),
        n_adj=int(nadj),
        atom_link=atom_link,
    )
