"""Scalar SPF oracle: the reference Dijkstra semantics, exactly.

The port's own copy of ``holo_tpu.spf.scalar.spf_reference``: an
independent host implementation of the candidate-list Dijkstra in
holo-ospf/src/spf.rs:587-729, against which the card's output is checked.

- candidate list ordered by (distance, vertex id);
- on a strictly better path the candidate is re-created (hops and next-hop
  set taken from the new parent -- spf.rs:685-706);
- on an equal-cost path only the next-hop set is extended (spf.rs:710-717);
- hops increments only when the linked vertex is a router (spf.rs:673-677);
- next hops: computed directly when the parent has hops == 0, otherwise
  inherited from the parent (spf.rs:744-767).
"""

from __future__ import annotations

from dataclasses import dataclass
from heapq import heappop, heappush

import numpy as np

from holo_tpu_torch.ops.graph import INF, Topology


@dataclass
class ScalarSpfOut:
    dist: np.ndarray  # int32[N], INF unreachable
    parent: np.ndarray  # int32[N], N if none (root/unreachable)
    hops: np.ndarray  # int32[N], N+1 if unreachable
    nexthops: list  # list[frozenset[int]] of atom ids per vertex

    def nexthop_words(self, n_atoms: int) -> np.ndarray:
        """Pack next-hop sets into uint32 bitmask words [N, W]."""
        w = max((n_atoms + 31) // 32, 1)
        out = np.zeros((len(self.nexthops), w), np.uint32)
        for v, atoms in enumerate(self.nexthops):
            for a in atoms:
                if a >= n_atoms:
                    raise ValueError(f"atom id {a} >= n_atoms {n_atoms}")
                out[v, a // 32] |= np.uint32(1) << np.uint32(a % 32)
        return out


def spf_reference(topo: Topology, edge_mask: np.ndarray | None = None) -> ScalarSpfOut:
    """Run the reference-semantics Dijkstra from ``topo.root``."""
    n = topo.n_vertices
    adj: list[list[tuple[int, int, int]]] = [[] for _ in range(n)]
    for e in range(topo.n_edges):
        if edge_mask is not None and not edge_mask[e]:
            continue
        adj[int(topo.edge_src[e])].append(
            (int(topo.edge_dst[e]), int(topo.edge_cost[e]), int(topo.edge_direct_atom[e]))
        )

    root = topo.root
    dist = np.full(n, INF, np.int32)
    parent = np.full(n, n, np.int32)
    hops = np.full(n, n + 1, np.int32)
    nexthops: list[frozenset] = [frozenset()] * n

    # cand: vid -> [dist, hops, set(atoms), first_parent]; heap of (dist, vid)
    # with lazy deletion emulates BTreeMap<(dist, vid)>::pop_first.
    cand: dict[int, list] = {root: [0, 0, set(), n]}
    heap: list[tuple[int, int]] = [(0, root)]
    in_spt = np.zeros(n, bool)

    while heap:
        d, v = heappop(heap)
        ent = cand.get(v)
        if ent is None or in_spt[v] or ent[0] != d:
            continue  # stale heap entry
        del cand[v]
        in_spt[v] = True
        dist[v] = d
        hops[v] = ent[1]
        nexthops[v] = frozenset(ent[2])
        parent[v] = ent[3]
        v_hops = ent[1]
        v_nh = nexthops[v]

        for dst, cost, atom in adj[v]:
            if in_spt[dst]:
                continue
            nd = d + cost
            nhops = v_hops + (1 if topo.is_router[dst] else 0)
            c = cand.get(dst)
            if c is not None:
                if nd > c[0]:
                    continue
                if nd < c[0]:
                    c[0], c[1], c[2], c[3] = nd, nhops, set(), v
                    heappush(heap, (nd, dst))
            else:
                c = [nd, nhops, set(), v]
                cand[dst] = c
                heappush(heap, (nd, dst))
            if v_hops == 0:
                if atom >= 0:
                    c[2].add(atom)
            else:
                c[2] |= v_nh

    parent[root] = n
    return ScalarSpfOut(dist=dist, parent=parent, hops=hops, nexthops=nexthops)
