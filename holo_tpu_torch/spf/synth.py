"""Synthetic LSDB generators for tests and the chip smoke run.

The port's own copy of the generators of ``holo_tpu.spf.synth`` that this
slice needs.  The numpy seeding is the same, so one seed gives the same
arrays in both packages.  Topologies honour the OSPF vertex model:

- vertex indices in tie-break order: transit networks first, then routers;
- router->router and router->network links cost >= 1;
- network->router links cost 0 (RFC 2328 §16.1);
- ``edge_direct_atom`` assigned exactly where the reference computes next
  hops directly (holo-ospf/src/spf.rs:744-767).
"""

from __future__ import annotations

import numpy as np

from holo_tpu_torch.ops.graph import Topology


def clone_topology(topo: Topology, keep=None, extra=None, cost: dict | None = None) -> Topology:
    """Fresh-identity copy of ``topo`` with optional edge mutations, for
    DeltaPath chains: ``keep`` a bool[E] edge filter, ``extra`` rows of
    (src, dst, cost, atom) to append, ``cost`` {edge index: new cost} over
    the filtered edge array.  The copy has its own uid and no delta
    lineage; it keeps the partition hint (per-vertex state, without which
    ``diff_topologies`` would not link the two)."""
    src, dst, c, atom = topo.edge_src, topo.edge_dst, topo.edge_cost, topo.edge_direct_atom
    if keep is not None:
        src, dst, c, atom = src[keep], dst[keep], c[keep], atom[keep]
    else:
        src, dst, c, atom = src.copy(), dst.copy(), c.copy(), atom.copy()
    if cost is not None:
        for i, v in cost.items():
            c[i] = v
    if extra is not None:
        e = np.asarray(extra, np.int32).reshape(-1, 4)
        src = np.concatenate([src, e[:, 0]])
        dst = np.concatenate([dst, e[:, 1]])
        c = np.concatenate([c, e[:, 2]])
        atom = np.concatenate([atom, e[:, 3]])
    return Topology(
        n_vertices=topo.n_vertices,
        is_router=topo.is_router.copy(),
        edge_src=src, edge_dst=dst, edge_cost=c, edge_direct_atom=atom,
        root=topo.root,
        partition_hint=None if topo.partition_hint is None else topo.partition_hint.copy(),
    )


def assign_direct_atoms(topo: Topology) -> int:
    """Assign next-hop atom ids in place; returns the atom count.

    One atom per root out-edge, plus one per (root-adjacent network ->
    attached router) pair.
    """
    atom = np.full(topo.n_edges, -1, np.int32)
    next_id = 0
    root_nets = set()
    for e in range(topo.n_edges):
        if topo.edge_src[e] == topo.root:
            atom[e] = next_id
            next_id += 1
            dst = int(topo.edge_dst[e])
            if not topo.is_router[dst]:
                root_nets.add(dst)
    for e in range(topo.n_edges):
        s = int(topo.edge_src[e])
        if s in root_nets and topo.edge_dst[e] != topo.root:
            atom[e] = next_id
            next_id += 1
    topo.edge_direct_atom = atom
    topo.touch()
    return next_id


def random_ospf_topology(
    n_routers: int,
    n_networks: int = 0,
    extra_p2p: int | None = None,
    max_cost: int = 20,
    seed: int = 0,
    root: int | None = None,
) -> Topology:
    """Random connected OSPF-style topology.

    Routers are joined by a random spanning tree plus ``extra_p2p`` random
    p2p links (both directions, independent costs).  Each transit network
    connects 2-5 random routers.
    """
    rng = np.random.default_rng(seed)
    n = n_networks + n_routers  # networks occupy indices [0, n_networks)
    is_router = np.zeros(n, bool)
    is_router[n_networks:] = True

    def rtr(i):
        return n_networks + i

    src, dst, cost = [], [], []

    def add(a, b, c):
        src.append(a)
        dst.append(b)
        cost.append(c)

    order = rng.permutation(n_routers)
    for i in range(1, n_routers):
        a, b = rtr(order[i]), rtr(order[rng.integers(0, i)])
        add(a, b, int(rng.integers(1, max_cost + 1)))
        add(b, a, int(rng.integers(1, max_cost + 1)))

    if extra_p2p is None:
        extra_p2p = n_routers
    seen = set(zip(src, dst))
    for _ in range(extra_p2p):
        a, b = rng.integers(0, n_routers, 2)
        if a == b:
            continue
        a, b = rtr(a), rtr(b)
        if (a, b) in seen:
            continue
        seen.add((a, b))
        seen.add((b, a))
        add(a, b, int(rng.integers(1, max_cost + 1)))
        add(b, a, int(rng.integers(1, max_cost + 1)))

    for net in range(n_networks):
        k = int(rng.integers(2, 6))
        members = rng.choice(n_routers, size=min(k, n_routers), replace=False)
        for m in members:
            add(rtr(m), net, int(rng.integers(1, max_cost + 1)))
            add(net, rtr(m), 0)

    topo = Topology(
        n_vertices=n,
        is_router=is_router,
        edge_src=np.array(src, np.int32),
        edge_dst=np.array(dst, np.int32),
        edge_cost=np.array(cost, np.int32),
        root=rtr(0) if root is None else root,
    )
    assign_direct_atoms(topo)
    return topo


def fat_tree_topology(k: int = 20, seed: int = 0) -> Topology:
    """Three-tier fat tree of p2p router links.

    k pods x (k/2 edge + k/2 agg) routers plus (k/2)^2 core routers, with
    per-direction costs drawn from 1..3.  k=90 gives 10,125 vertices and
    729,000 directed edges.
    """
    rng = np.random.default_rng(seed)
    half = k // 2
    n_core = half * half
    n_agg = k * half
    n_edge = k * half
    n = n_core + n_agg + n_edge

    def core(i):
        return i

    def agg(p, i):
        return n_core + p * half + i

    def edge(p, i):
        return n_core + n_agg + p * half + i

    src, dst, cost = [], [], []

    def add2(a, b):
        c1 = int(rng.integers(1, 4))
        c2 = int(rng.integers(1, 4))
        src.extend((a, b))
        dst.extend((b, a))
        cost.extend((c1, c2))

    for p in range(k):
        for i in range(half):
            for j in range(half):
                add2(agg(p, i), edge(p, j))  # intra-pod full bipartite
            for j in range(half):
                add2(agg(p, i), core(i * half + j))  # agg i <-> its core group

    topo = Topology(
        n_vertices=n,
        is_router=np.ones(n, bool),
        edge_src=np.array(src, np.int32),
        edge_dst=np.array(dst, np.int32),
        edge_cost=np.array(cost, np.int32),
        root=edge(0, 0),
    )
    assign_direct_atoms(topo)
    return topo


def grid_topology(rows: int, cols: int, max_cost: int = 10, seed: int = 0) -> Topology:
    """rows x cols router grid with per-direction random costs."""
    rng = np.random.default_rng(seed)
    n = rows * cols
    src, dst, cost = [], [], []

    def add2(a, b):
        src.extend((a, b))
        dst.extend((b, a))
        cost.extend((int(rng.integers(1, max_cost + 1)), int(rng.integers(1, max_cost + 1))))

    for r in range(rows):
        for c in range(cols):
            if c + 1 < cols:
                add2(r * cols + c, r * cols + c + 1)
            if r + 1 < rows:
                add2(r * cols + c, (r + 1) * cols + c)
    topo = Topology(
        n_vertices=n,
        is_router=np.ones(n, bool),
        edge_src=np.array(src, np.int32),
        edge_dst=np.array(dst, np.int32),
        edge_cost=np.array(cost, np.int32),
        root=0,
    )
    assign_direct_atoms(topo)
    return topo


def multiarea_topology(n_areas: int, rows: int, cols: int, gateways: int = 4,
                       max_cost: int = 10, inter_cost: int = 5, seed: int = 0,
                       hint: bool = True) -> Topology:
    """Hub-and-spoke multi-area LSDB: ``n_areas`` grid areas of ``rows x
    cols`` routers, area 0 the backbone, every other area joined to it by
    ``gateways`` gateway pairs (area a's vertex g * cols <-> backbone vertex
    g * cols + a, costs 1..``inter_cost``): the OSPF area-0 shape, with cut
    edges only at the gateways.  Vertex ids are area-major, so the flat cut
    finds the areas again when the hint is withheld (``hint=False``).  Root
    is backbone vertex 0.  Vectorized: usable at 100k+ vertices."""
    rng = np.random.default_rng(seed)
    per = rows * cols
    n = n_areas * per
    vid = np.arange(per).reshape(rows, cols)
    h_src, h_dst = vid[:, :-1].ravel(), vid[:, 1:].ravel()
    v_src, v_dst = vid[:-1, :].ravel(), vid[1:, :].ravel()
    a_src = np.concatenate([h_src, h_dst, v_src, v_dst])
    a_dst = np.concatenate([h_dst, h_src, v_dst, v_src])
    offset = (np.arange(n_areas) * per)[:, None]
    src = (a_src[None, :] + offset).ravel()
    dst = (a_dst[None, :] + offset).ravel()
    cost = rng.integers(1, max_cost + 1, src.shape[0])
    g = np.arange(min(gateways, rows))
    gs, gd, gc = [src], [dst], [cost]
    for a in range(1, n_areas):
        leaf = a * per + g * cols
        hub = (g * cols + a) % per
        gs.append(np.concatenate([leaf, hub]))
        gd.append(np.concatenate([hub, leaf]))
        gc.append(rng.integers(1, inter_cost + 1, 2 * g.shape[0]))
    topo = Topology(
        n_vertices=n,
        is_router=np.ones(n, bool),
        edge_src=np.concatenate(gs).astype(np.int32),
        edge_dst=np.concatenate(gd).astype(np.int32),
        edge_cost=np.concatenate(gc).astype(np.int32),
        root=0,
        partition_hint=np.repeat(np.arange(n_areas, dtype=np.int32), per) if hint else None,
    )
    assign_direct_atoms(topo)
    return topo


def whatif_link_failure_masks(
    topo: Topology, n_scenarios: int, seed: int = 0
) -> np.ndarray:
    """bool[B, E] masks, each failing one bidirectional link (both directions).

    Scenario 0 is always the no-failure base case.
    """
    rng = np.random.default_rng(seed)
    pair_of = {}
    for e in range(topo.n_edges):
        pair_of[(int(topo.edge_src[e]), int(topo.edge_dst[e]))] = e
    masks = np.ones((n_scenarios, topo.n_edges), bool)
    for b in range(1, n_scenarios):
        e = int(rng.integers(0, topo.n_edges))
        masks[b, e] = False
        rev = pair_of.get((int(topo.edge_dst[e]), int(topo.edge_src[e])))
        if rev is not None:
            masks[b, rev] = False
    return masks
