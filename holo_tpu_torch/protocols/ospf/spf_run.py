"""SPF marshaling + route derivation for OSPFv2.

Bridges the protocol LSDB to the tensor/scalar SPF backends:

- :func:`build_topology` lowers an area LSDB into the generic
  :class:`~holo_tpu_torch.ops.graph.Topology` (vertex model of RFC 2328 §16.1,
  ordering contract of holo_tpu_torch.ops.graph), assigning next-hop atoms for
  exactly the parent-hops==0 cases (reference calc_nexthops,
  holo-ospf/src/ospfv2/spf.rs:172-…).
- :func:`derive_routes` turns backend results (distances + ECMP atom
  bitmasks) into per-prefix intra-area routes (reference
  route::update_rib_full, holo-ospf/src/route.rs:146-197).
"""

from __future__ import annotations

from dataclasses import dataclass
from ipaddress import IPv4Address, IPv4Network

import numpy as np

from holo_tpu_torch.ops.graph import INF, Topology
from holo_tpu_torch.protocols.ospf.lsdb import Lsdb
from holo_tpu_torch.protocols.ospf.packet import (
    LsaNetwork,
    LsaRouter,
    LsaType,
    RouterLinkType,
)
from holo_tpu_torch.spf.backend import SpfResult
from holo_tpu_torch.utils.ip import apply_mask


def srlg_bits(groups) -> int:
    """uint32 bitmask of configured SRLG group ids.

    Group ids fold modulo 32 onto the mask bits — membership testing
    stays conservative-correct under folding (a shared bit is treated
    as a shared risk, never the reverse), matching the FRR engines'
    ``srlg_disjoint`` exclusion semantics over ``Topology.edge_srlg``.
    """
    bits = 0
    for gid in groups or ():
        bits |= 1 << (int(gid) % 32)
    return bits


def apply_interface_srlg(
    topo: Topology, atom_ifnames, srlg_of_ifname: dict
) -> None:
    """Stamp ``Topology.edge_srlg`` from per-interface fast-reroute
    config.

    ``atom_ifnames[a]`` is the outgoing interface of next-hop atom
    ``a`` (None for borrowed/vlink atoms); ``srlg_of_ifname`` maps
    interface name -> uint32 SRLG bitmask (:func:`srlg_bits`).  Every
    edge resolving through a configured interface — exactly the root
    out-edges the FRR engines treat as protected links and repair
    candidates — carries that interface's groups.  In-place: callers
    stamp after ``edge_direct_atom`` is final."""
    if not srlg_of_ifname:
        return
    srlg = np.zeros(topo.n_edges, np.uint32)
    for e in range(topo.n_edges):
        a = int(topo.edge_direct_atom[e])
        if a < 0 or a >= len(atom_ifnames):
            continue
        ifn = atom_ifnames[a]
        if ifn is not None:
            srlg[e] = np.uint32(srlg_of_ifname.get(ifn, 0))
    topo.edge_srlg = srlg


def apply_partition_hint(topo: Topology, groups) -> None:
    """Stamp ``Topology.partition_hint`` from a per-vertex grouping:
    the protocol seam the hierarchical partitioned-SPF path
    reads (``ops/graph.partition_topology`` honors the hint verbatim).

    ``groups`` is a sequence of hashable, orderable group labels — one
    per vertex in vertex order (IS-IS area addresses, OSPF sub-area
    groupings, synth multi-area ids) — or None entries for ungrouped
    vertices.  The stamp happens only when EVERY vertex is grouped and
    at least two distinct groups exist; otherwise the topology stays
    flat and the deterministic BFS/greedy cut decides at partition
    time.  Distinct labels map onto dense partition ids in ascending
    label order, so the hint is reproducible across marshals (the
    DeltaPath chain contract).  Like ``edge_srlg`` the hint never
    enters the DeviceGraph planes — residents cannot serve it stale."""
    if groups is None:
        return
    labels = list(groups)
    if len(labels) != topo.n_vertices or any(
        g is None for g in labels
    ):
        return
    uniq = sorted(set(labels))
    if len(uniq) < 2:
        return
    dense = {g: i for i, g in enumerate(uniq)}
    topo.partition_hint = np.array(
        [dense[g] for g in labels], np.int32
    )


@dataclass(frozen=True)
class NexthopAtom:
    """Resolved direct next hop: outgoing interface + neighbor address.

    addr is None for p2p links where the neighbor address is learned from
    the adjacency (filled by the instance) — kept explicit for RIB parity.
    ``expand`` (virtual links, §16.1): the atom stands for the transit
    area's next-hop set toward the vlink neighbor and expands to it when
    atoms are converted to route next hops.
    """

    ifname: str | None
    addr: IPv4Address | None
    expand: frozenset = None


@dataclass
class SpfTopology:
    topo: Topology
    atoms: list[NexthopAtom]
    # vertex index maps
    router_index: dict[IPv4Address, int]
    network_index: dict[IPv4Address, int]


def build_topology(
    lsdb: Lsdb,
    router_id: IPv4Address,
    now: float,
    iface_by_addr: dict[IPv4Address, str],
    iface_by_nbr: dict[IPv4Address, tuple[str, IPv4Address]],
    p2p_nbr_addr: dict[tuple, IPv4Address] | None = None,
    iface_by_ifindex: dict[int, str] | None = None,
    vlink_nexthops: dict | None = None,
    iface_srlg: dict[str, int] | None = None,
    partition_of: dict | None = None,
) -> SpfTopology | None:
    """Lower the area LSDB to the SPF vertex/edge model.

    iface_by_addr: our interface address -> ifname (for transit networks we
    attach to).  iface_by_nbr: neighbor router-id -> (ifname, nbr addr)
    for p2p adjacencies (direct next-hop resolution); with
    ``p2p_nbr_addr`` {(ifname, nbr_rid): addr} parallel p2p links each
    resolve through their own interface (the per-link link_data of our
    router LSA selects the interface).
    MaxAge LSAs are excluded (RFC 2328 §16.1 note).
    """
    routers: list[IPv4Address] = []
    networks: list[IPv4Address] = []  # keyed by DR interface address (lsid)
    rlsa: dict[IPv4Address, LsaRouter] = {}
    nlsa: dict[IPv4Address, LsaNetwork] = {}
    for e in lsdb.all():
        if e.current_age(now) >= 3600:
            continue
        lsa = e.lsa
        if lsa.type == LsaType.ROUTER:
            rlsa[lsa.adv_rtr] = lsa.body
            routers.append(lsa.adv_rtr)
        elif lsa.type == LsaType.NETWORK:
            nlsa[lsa.lsid] = lsa.body
            networks.append(lsa.lsid)

    if router_id not in rlsa:
        return None  # no self LSA yet (reference: SpfRootNotFound)

    # Vertex ordering contract: Network < Router (ospfv2/spf.rs:42-45).
    networks.sort()
    routers.sort()
    network_index = {a: i for i, a in enumerate(networks)}
    router_index = {r: len(networks) + i for i, r in enumerate(routers)}
    n = len(networks) + len(routers)
    is_router = np.zeros(n, bool)
    is_router[len(networks) :] = True

    src, dst, cost = [], [], []
    # Per-edge link_data for edges out of the root (parallel p2p links
    # each resolve to their own interface); vlink edges tracked apart.
    root_edge_data: dict[int, IPv4Address] = {}
    root_vlink_edges: dict[int, IPv4Address] = {}  # edge -> nbr router id
    for rid, body in rlsa.items():
        u = router_index[rid]
        for link in body.links:
            if link.link_type in (
                RouterLinkType.POINT_TO_POINT,
                RouterLinkType.VIRTUAL_LINK,
            ):
                # Virtual links are router-router edges whose cost is the
                # transit-area distance (§15); for SPF they behave as p2p.
                v = router_index.get(link.id)
                if v is not None:
                    if rid == router_id:
                        if link.link_type == RouterLinkType.VIRTUAL_LINK:
                            root_vlink_edges[len(src)] = link.id
                        else:
                            root_edge_data[len(src)] = link.data
                    src.append(u), dst.append(v), cost.append(link.metric)
            elif link.link_type == RouterLinkType.TRANSIT_NETWORK:
                v = network_index.get(link.id)
                if v is not None:
                    if rid == router_id:
                        root_edge_data[len(src)] = link.data
                    src.append(u), dst.append(v), cost.append(link.metric)
    for dr_addr, body in nlsa.items():
        u = network_index[dr_addr]
        for rid in body.attached:
            v = router_index.get(rid)
            if v is not None:
                src.append(u), dst.append(v), cost.append(0)

    # Mutual-link filter (bidirectionality check, spf.rs:653-664) applied
    # here with index tracking so root-edge link_data survives filtering.
    from holo_tpu_torch.ops.graph import mutual_keep_mask

    keep_mask = mutual_keep_mask(
        np.array(src, np.int32), np.array(dst, np.int32)
    )
    keep = [i for i in range(len(src)) if keep_mask[i]]
    remap = {old: new for new, old in enumerate(keep)}
    root_edge_data = {
        remap[i]: d for i, d in root_edge_data.items() if i in remap
    }
    root_vlink_edges = {
        remap[i]: r for i, r in root_vlink_edges.items() if i in remap
    }
    topo = Topology(
        n_vertices=n,
        is_router=is_router,
        edge_src=np.array([src[i] for i in keep], np.int32).reshape(-1),
        edge_dst=np.array([dst[i] for i in keep], np.int32).reshape(-1),
        edge_cost=np.array([cost[i] for i in keep], np.int32).reshape(-1),
        root=router_index[router_id],
    )

    # Next-hop atoms: edges out of the root, and edges out of root-adjacent
    # transit networks (the hops==0 direct-calculation cases).
    atoms: list[NexthopAtom] = []
    atom_ids = np.full(topo.n_edges, -1, np.int32)
    root = topo.root
    root_nets: set[int] = set()
    self_body = rlsa[router_id]
    # Map vertex index -> transit our-iface (for root->net edges).
    net_if: dict[int, str] = {}
    for link in self_body.links:
        if link.link_type == RouterLinkType.TRANSIT_NETWORK:
            vi = network_index.get(link.id)
            if vi is not None:
                ifname = iface_by_addr.get(link.data)
                if ifname is not None:
                    net_if[vi] = ifname
    for e in range(topo.n_edges):
        if topo.edge_src[e] == root:
            v = int(topo.edge_dst[e])
            if e in root_vlink_edges:
                # Virtual link: next hops borrowed from the transit area's
                # path to the vlink neighbor (§16.1).
                nbr_rid = root_vlink_edges[e]
                expand = (vlink_nexthops or {}).get(nbr_rid)
                if expand:
                    atom_ids[e] = len(atoms)
                    atoms.append(NexthopAtom(None, None, expand))
                continue
            link_data = root_edge_data.get(e)
            if is_router[v]:
                # p2p neighbor: the link's own interface (parallel links
                # each get their own atom), neighbor addr per interface.
                # Unnumbered links carry the MIB ifIndex in link_data
                # (RFC 2328 A.4.2) instead of an address.
                rid = routers[v - len(networks)]
                ifname = (
                    iface_by_addr.get(link_data)
                    if link_data is not None
                    else None
                )
                if (
                    ifname is None
                    and link_data is not None
                    and iface_by_ifindex is not None
                    and int(link_data) < 0x1000000  # 0.x.y.z: never an addr
                ):
                    ifname = iface_by_ifindex.get(int(link_data))
                addr = None
                if ifname is not None and p2p_nbr_addr is not None:
                    addr = p2p_nbr_addr.get((ifname, rid))
                if ifname is not None and addr is not None:
                    atom_ids[e] = len(atoms)
                    atoms.append(NexthopAtom(ifname, addr))
                else:
                    hop = iface_by_nbr.get(rid)
                    if hop is not None:
                        atom_ids[e] = len(atoms)
                        atoms.append(NexthopAtom(hop[0], hop[1]))
            else:
                root_nets.add(v)
                # Directly-attached transit network: next hop is the
                # outgoing interface itself (no gateway address).
                ifname = (
                    iface_by_addr.get(link_data)
                    if link_data is not None
                    else None
                )
                if ifname is not None:
                    atom_ids[e] = len(atoms)
                    atoms.append(NexthopAtom(ifname, None))
        # second pass below needs root_nets complete
    for e in range(topo.n_edges):
        u = int(topo.edge_src[e])
        v = int(topo.edge_dst[e])
        if u in root_nets and is_router[v] and v != root:
            # Destination router's address on that network = the link.data
            # of ITS transit link pointing at this network's DR address.
            rid = routers[v - len(networks)]
            dr_addr = networks[u]
            body = rlsa.get(rid)
            ifname = net_if.get(u)
            if body is None or ifname is None:
                continue
            for link in body.links:
                if (
                    link.link_type == RouterLinkType.TRANSIT_NETWORK
                    and link.id == dr_addr
                ):
                    atom_ids[e] = len(atoms)
                    atoms.append(NexthopAtom(ifname, link.data))
                    break

    topo.edge_direct_atom = atom_ids
    if iface_srlg:
        # Interface fast-reroute SRLG config -> the edge_srlg seam the
        # FRR policy masks consume (srlg_disjoint).
        apply_interface_srlg(
            topo, [a.ifname for a in atoms], iface_srlg
        )
    if partition_of:
        # Hierarchical partition hint: per-router group
        # labels (config/topology-design groupings the operator knows —
        # PoPs, rings, sub-area clusters); a transit network rides the
        # lowest-labeled attached router so zero-cost net->rtr edges
        # stay intra-partition wherever the grouping allows.
        groups: list = []
        for dr_addr in networks:
            att = [
                partition_of[r]
                for r in nlsa[dr_addr].attached
                if r in partition_of
            ]
            groups.append(min(att) if att else None)
        for rid in routers:
            groups.append(partition_of.get(rid))
        apply_partition_hint(topo, groups)
    topo.touch()
    return SpfTopology(topo, atoms, router_index, network_index)


def link_spf_delta(
    prev: SpfTopology | None, new: SpfTopology, max_ops: int = 512
) -> bool:
    """DeltaPath construction at the LSDB seam: attach delta lineage to
    ``new`` when it differs from the previous run's marshaled topology
    by a small edge-level change over the SAME vertex model and
    next-hop atom table.  The device-graph cache then updates the
    resident EllGraph in place and the device backend recomputes
    incrementally instead of re-marshaling the whole LSDB.  Returns
    whether lineage was attached; False always means the full-rebuild
    path, never an error."""
    if prev is None:
        return False
    if (
        prev.atoms != new.atoms
        or prev.router_index != new.router_index
        or prev.network_index != new.network_index
    ):
        return False
    from holo_tpu_torch.ops.graph import diff_topologies

    delta = diff_topologies(prev.topo, new.topo, max_ops=max_ops)
    if delta is None:
        return False
    new.topo.link_delta(delta)
    return True


@dataclass(frozen=True)
class RouteNexthop:
    ifname: str
    addr: IPv4Address | None


@dataclass
class IntraRoute:
    prefix: IPv4Network
    dist: int
    nexthops: frozenset[RouteNexthop]
    area_id: IPv4Address
    # "intra" | "inter" | "external-1" | "external-2" | "nssa-1" |
    # "nssa-2" — drives per-type admin distance and maps onto the
    # ietf-ospf route-type enumeration in operational state.
    rtype: str = "intra"
    # SPF vertex the winning path terminates at (-1 when the route was
    # not derived from an SPT vertex, e.g. externals): the IP-FRR
    # consumption key — backup tables are indexed by destination vertex.
    vertex: int = -1
    # IP-FRR repairs attached after the backup-table run:
    # {primary RouteNexthop -> (backup RouteNexthop, label stack)}.
    backups: dict | None = None
    # UCMP weights {RouteNexthop -> saturated shortest-path count}:
    # present only when the SPF ran with multipath planes;
    # rides RouteMsg.nh_weights into the RIB's weighted install.
    nh_weights: dict | None = None


def atom_bits(words: np.ndarray, n_atoms: int) -> list[int]:
    """Indices of set bits in an ECMP atom bitmask (uint32 words)."""
    return [
        a
        for a in range(n_atoms)
        if words[a // 32] & (np.uint32(1) << np.uint32(a % 32))
    ]


def _atoms_of(words: np.ndarray, atoms: list[NexthopAtom]) -> frozenset[RouteNexthop]:
    out = set()
    for a in atom_bits(words, len(atoms)):
        atom = atoms[a]
        if atom.expand is not None:
            out |= atom.expand
        else:
            out.add(RouteNexthop(atom.ifname, atom.addr))
    return frozenset(out)


def _atom_weights_of(
    words: np.ndarray, weights_row: np.ndarray, atoms: list[NexthopAtom]
) -> dict:
    """{RouteNexthop -> UCMP weight} for one vertex's next-hop set;
    atoms resolving to the same next hop (or a vlink expansion) sum."""
    out: dict = {}
    for a in atom_bits(words, len(atoms)):
        atom = atoms[a]
        w = int(weights_row[a]) if a < len(weights_row) else 0
        targets = (
            atom.expand
            if atom.expand is not None
            else (RouteNexthop(atom.ifname, atom.addr),)
        )
        for nh in targets:
            out[nh] = out.get(nh, 0) + w
    return out


def _nh_rank(nh, weights: dict):
    """Deterministic multipath clamp order: UCMP weight descending,
    then lowest next-hop address (the reference's ECMP clamp key),
    then interface name."""
    return (
        -weights.get(nh, 1),
        nh.addr is None,
        nh.addr.packed if nh.addr is not None else b"",
        nh.ifname or "",
    )


def clamp_multipath(routes: dict, max_paths: int | None) -> int:
    """Truncate every route's ECMP set to ``max_paths`` next hops (the
    OSPF ``max-paths`` seam), keeping the highest-weight paths; weights
    dicts are filtered to the survivors.  Returns routes clamped."""
    if not max_paths or max_paths < 1:
        return 0
    clamped = 0
    for route in routes.values():
        if len(route.nexthops) <= max_paths:
            continue
        w = route.nh_weights or {}
        ranked = sorted(route.nexthops, key=lambda nh: _nh_rank(nh, w))
        keep = frozenset(ranked[:max_paths])
        route.nexthops = keep
        if route.nh_weights:
            route.nh_weights = {
                nh: ww for nh, ww in route.nh_weights.items() if nh in keep
            }
        clamped += 1
    return clamped


def derive_routes(
    st: SpfTopology,
    res: SpfResult,
    lsdb: Lsdb,
    now: float,
    area_id: IPv4Address,
    max_paths: int | None = None,
) -> dict[IPv4Network, IntraRoute]:
    """Intra-area routes from SPF results (RFC 2328 §16.1 steps 2-4).

    Transit networks yield their prefix at the network vertex's distance;
    router stub links yield prefix routes at dist(router)+metric.  Equal
    cost contributions union their next-hop sets; the root's own stubs
    are local (empty next-hop set).  Address-less next-hops (interface
    only) mean DIRECTLY ATTACHED (reference route.rs:96): they render in
    operational state but are never installed to the RIB — the connected
    route owns the FIB entry (see OspfInstance._sync_rib).
    """
    routes: dict[IPv4Network, IntraRoute] = {}

    def offer(prefix, dist, nhs, vertex=-1, weights=None):
        cur = routes.get(prefix)
        if cur is None or dist < cur.dist:
            routes[prefix] = IntraRoute(
                prefix, dist, nhs, area_id, vertex=vertex,
                nh_weights=dict(weights) if weights else None,
            )
        elif dist == cur.dist:
            # Equal-cost contributions union next hops; the first
            # contributing vertex keeps the FRR consumption key (its
            # backup covers the merged set's shared failure domain only
            # approximately, matching the reference's per-route pick).
            merged = None
            if cur.nh_weights or weights:
                merged = dict(cur.nh_weights or {})
                for nh, w in (weights or {}).items():
                    merged[nh] = merged.get(nh, 0) + w
            routes[prefix] = IntraRoute(
                prefix, dist, cur.nexthops | nhs, area_id,
                vertex=cur.vertex, nh_weights=merged,
            )

    inv_net = {i: a for a, i in st.network_index.items()}
    inv_rtr = {i: r for r, i in st.router_index.items()}
    nlsa = {}
    rlsa = {}
    for e in lsdb.all():
        if e.current_age(now) >= 3600:
            continue
        if e.lsa.type == LsaType.NETWORK:
            nlsa[e.lsa.lsid] = e.lsa.body
        elif e.lsa.type == LsaType.ROUTER:
            rlsa[e.lsa.adv_rtr] = e.lsa.body

    # Per-vertex UCMP weights ride the multipath planes when the
    # dispatch carried them (max-paths > 1 → multipath kernel).
    nhw = getattr(res, "nh_weights", None)
    n = st.topo.n_vertices
    for v in range(n):
        if res.dist[v] >= INF:
            continue
        nhs = _atoms_of(res.nexthop_words[v], st.atoms)
        weights = (
            _atom_weights_of(res.nexthop_words[v], nhw[v], st.atoms)
            if nhw is not None
            else None
        )
        if v in inv_net:
            body = nlsa.get(inv_net[v])
            if body is None:
                continue
            prefix = apply_mask(inv_net[v], body.mask)
            offer(prefix, int(res.dist[v]), nhs, vertex=v, weights=weights)
        else:
            body = rlsa.get(inv_rtr[v])
            if body is None:
                continue
            for link in body.links:
                if link.link_type == RouterLinkType.STUB_NETWORK:
                    prefix = apply_mask(link.id, link.data)
                    offer(
                        prefix, int(res.dist[v]) + link.metric, nhs,
                        vertex=v, weights=weights,
                    )
    clamp_multipath(routes, max_paths)
    return routes


def attach_frr_backups(
    st: SpfTopology,
    res: SpfResult,
    routes: dict,
    table,
    cfg,
    label_of_vertex=None,
    area_id=None,
) -> int:
    """Attach precomputed repairs to routes derived from ``st``/``res``.

    For every route whose winning path ends at an SPT vertex, each
    primary next-hop atom maps (via the backup table's ``atom_link``) to
    its protected link, and ``resolve_backup`` picks the repair.  Direct
    LFAs attach as plain next hops; remote-LFA / TI-LFA repairs need a
    tunnel to their release vertex, so they attach only when
    ``label_of_vertex`` resolves a segment (node-SID label) for every
    repair vertex — without SR there is no loop-free encapsulation and
    the destination stays unprotected (RFC 7490 §2 applies).  Returns
    the number of routes that gained at least one backup."""
    from holo_tpu_torch.frr.manager import repair_map

    n = st.topo.n_vertices
    attached = 0
    # All prefixes terminating at the same SPT vertex share one repair
    # map — memoize per vertex (O(reachable vertices), not O(routes)).
    memo: dict[int, dict] = {}
    for route in routes.values():
        if area_id is not None and route.area_id != area_id:
            continue
        if not cfg.protects_prefix(route.prefix):
            continue  # per-prefix protection filtering (policy scope)
        v = getattr(route, "vertex", -1)
        if v < 0 or v >= n:
            continue
        repairs = memo.get(v)
        if repairs is None:
            repairs = memo[v] = repair_map(
                table, cfg, res.nexthop_words[v], v
            )
        backups = {}
        for a, entry in repairs.items():
            atom = st.atoms[a]
            batom = st.atoms[entry.atom]
            if atom.expand is not None or batom.expand is not None:
                continue  # vlink bundles have no single protected link
            labels: tuple = ()
            if entry.kind != "lfa":
                if label_of_vertex is None:
                    continue
                resolved = [label_of_vertex(p) for p in entry.via]
                if any(l is None for l in resolved):
                    continue
                labels = tuple(resolved)
            backups[RouteNexthop(atom.ifname, atom.addr)] = (
                RouteNexthop(batom.ifname, batom.addr),
                labels,
            )
        if backups:
            route.backups = backups
            attached += 1
    return attached
