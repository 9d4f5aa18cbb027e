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

:func:`spf_multipath_reference` is the port's copy of the multipath oracle
(``holo_tpu.spf.scalar.spf_multipath_reference``): loops and dicts, no code
shared with the lane-batched engine.
"""

from __future__ import annotations

from dataclasses import dataclass
from heapq import heappop, heappush

import numpy as np

from holo_tpu_torch.ops.graph import INF, MP_SAT, Topology


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


@dataclass
class ScalarMultipathOut:
    """Multi-parent frontier planes (the oracle of the engine's
    ``MultipathTensors``)."""

    parents: np.ndarray  # int32[N, Kp]; sentinel N past the set
    pdist: np.ndarray  # int32[N, Kp]; INF past the set
    pweight: np.ndarray  # int32[N, Kp]; 0 past the set
    npaths: np.ndarray  # int32[N]; saturated at MP_SAT, 0 unreachable
    nh_weights: np.ndarray  # int32[N, A]; saturated at MP_SAT


def spf_multipath_reference(
    topo: Topology,
    kp: int,
    edge_mask: np.ndarray | None = None,
    n_lanes: int | None = None,
) -> tuple[ScalarSpfOut, ScalarMultipathOut]:
    """Reference multipath SPF.

    - ``npaths[v] = min(sum over DAG parents u of npaths[u], MP_SAT)`` over
      already-clamped parent values, in ``(dist, vertex)`` order (a DAG edge
      either raises the distance or is a zero-cost network->router edge,
      whose network source orders first);
    - per-atom weights: a hops==0 DAG parent adds ``npaths[u]`` on its
      slot's direct atom, any other DAG parent its own clamped weight row;
    - parent sets: the distinct sources of admissible in-edges (DAG edges,
      and the strictly downward ``dist[u] < dist[v]`` loop-free diversity
      edges), each at its cheapest path cost, ranked by ``(path cost,
      source id)`` and cut to ``kp``.
    """
    n = topo.n_vertices
    base = spf_reference(topo, edge_mask)
    dist, hops = base.dist, base.hops
    sat = int(MP_SAT)
    n_atoms = max(topo.n_atoms(), 1) if n_lanes is None else int(n_lanes)

    radj: list[list[tuple[int, int, int]]] = [[] for _ in range(n)]
    for e in range(topo.n_edges):
        if edge_mask is not None and not edge_mask[e]:
            continue
        radj[int(topo.edge_dst[e])].append(
            (int(topo.edge_src[e]), int(topo.edge_cost[e]), int(topo.edge_direct_atom[e]))
        )

    root = int(topo.root)
    npaths = np.zeros(n, np.int64)
    nh_weights = np.zeros((n, n_atoms), np.int64)
    order = sorted((v for v in range(n) if int(dist[v]) < int(INF)),
                   key=lambda v: (int(dist[v]), v))
    for v in order:
        if v == root:
            npaths[v] = 1
            continue
        total = 0
        for u, c, atom in radj[v]:
            if int(dist[u]) >= int(INF) or int(dist[u]) + c != int(dist[v]):
                continue  # not a DAG edge
            total += int(npaths[u])
            if int(hops[u]) == 0:
                if atom >= 0:
                    nh_weights[v, atom] += int(npaths[u])
            else:
                nh_weights[v] += nh_weights[u]
        npaths[v] = min(total, sat)
        np.minimum(nh_weights[v], sat, out=nh_weights[v])

    parents = np.full((n, kp), n, np.int32)
    pdist = np.full((n, kp), INF, np.int32)
    pweight = np.zeros((n, kp), np.int32)
    for v in range(n):
        if v == root or int(dist[v]) >= int(INF):
            continue
        best: dict[int, int] = {}  # source -> cheapest admissible cost
        for u, c, _atom in radj[v]:
            du = int(dist[u])
            if du >= int(INF):
                continue
            cost = du + c
            if cost == int(dist[v]) or du < int(dist[v]):
                if u not in best or cost < best[u]:
                    best[u] = cost
        ranked = sorted(best.items(), key=lambda it: (it[1], it[0]))[:kp]
        for j, (u, cost) in enumerate(ranked):
            parents[v, j] = u
            pdist[v, j] = cost
            pweight[v, j] = int(npaths[u])

    return base, ScalarMultipathOut(
        parents=parents,
        pdist=pdist,
        pweight=pweight,
        npaths=npaths.astype(np.int32),
        nh_weights=nh_weights.astype(np.int32),
    )
