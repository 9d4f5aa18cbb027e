"""The BGP decision process: route cells, the §9.1.2.2 oracle and the engine
surface a table backend is driven through.

The port's own copy of the decision surface of
``holo_tpu/protocols/bgp_engine.py`` (which the port may not import): the
Adj-RIB-In / Loc-RIB cells that ``ops.bgp_table`` encodes (``:59-170``), the
constants and sort keys it needs, the scalar comparator ``_route_compare``
and ``_multipath_equal`` (``:1461-1532``), and :class:`DecisionEngine`, which
carries the engine attributes a table backend reads and the decision
methods verbatim (``:829-1052``): next-hop tracking, the per-address-family
decision process with its backend seam, ``_best_path`` (the oracle),
``_compute_nexthops`` and ``_loc_rib_update``.

Left out: sessions, the FSM, policy and the wire.  So ``_decision_process``
has no advertisement loop over established neighbours (``:895-911``); it
decides the queued prefixes, updates the Loc-RIB (with its ibus
``RouteIpAdd`` / ``RouteIpDel`` stream) and prunes empty destinations.

The cells are plain dataclasses, duck-typed to ``holo_tpu``'s: a backend of
the port decides over either package's cells, and ``BaseAttrs`` keeps all of
``holo_tpu``'s fields so attribute equality means the same in both.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from ipaddress import IPv4Address

DFLT_LOCAL_PREF = 100
ORIGIN_ORDER = {"Igp": 0, "Egp": 1, "Incomplete": 2}
AFI_SAFIS = ("ipv4-unicast", "ipv6-unicast")


# ===== attributes and RIB cells =====


@dataclass(frozen=True)
class AsSegment:
    seg_type: str  # "Sequence" | "Set"
    members: tuple = ()


@dataclass(frozen=True)
class BaseAttrs:
    """Path attributes (packet/attribute.rs BaseAttrs)."""

    origin: str = "Incomplete"  # "Igp"/"Egp"/"Incomplete"
    as_path: tuple = ()  # of AsSegment
    nexthop: str | None = None
    ll_nexthop: str | None = None
    med: int | None = None
    local_pref: int | None = None
    aggregator: tuple | None = None  # (asn, identifier)
    atomic_aggregate: bool = False
    originator_id: str | None = None
    cluster_list: tuple = ()
    comm: tuple = ()  # of u32
    ext_comm: tuple = ()  # of 8-byte values (hex strings in JSON)
    extv6_comm: tuple = ()  # of 20-byte values (hex strings in JSON)
    large_comm: tuple = ()  # of (global, local1, local2)

    def path_length(self) -> int:
        # as_path.path_length(): sets count as 1 (attribute.rs).
        total = 0
        for seg in self.as_path:
            total += len(seg.members) if seg.seg_type == "Sequence" else 1
        return total

    def first_as(self):
        for seg in self.as_path:
            if seg.seg_type == "Sequence" and seg.members:
                return seg.members[0]
            if seg.seg_type == "Set":
                return None
        return None

    def as_path_contains(self, asn: int) -> bool:
        return any(asn in seg.members for seg in self.as_path)


@dataclass(frozen=True)
class RouteOrigin:
    """rib.rs:91-101."""

    protocol: str | None = None  # local/redistributed origin
    identifier: str | None = None  # neighbor origin
    remote_addr: str | None = None

    def is_local(self) -> bool:
        return self.protocol is not None


@dataclass
class Route:
    origin: RouteOrigin
    attrs: BaseAttrs
    route_type: str  # "Internal" | "External"
    igp_cost: int | None = None
    ineligible_reason: str | None = None
    reject_reason: str | None = None

    def is_eligible(self) -> bool:
        return self.ineligible_reason is None


@dataclass
class AdjRib:
    in_pre: Route | None = None
    in_post: Route | None = None
    out_pre: Route | None = None
    out_post: Route | None = None


@dataclass
class Destination:
    local: Route | None = None
    local_nexthops: frozenset | None = None
    adj_rib: dict = field(default_factory=dict)  # addr(str) -> AdjRib
    redistribute: Route | None = None


@dataclass
class NhtEntry:
    metric: int | None = None
    prefixes: dict = field(default_factory=dict)  # prefix -> refcount


@dataclass
class Table:
    prefixes: dict = field(default_factory=dict)  # prefix(str) -> Destination
    queued: set = field(default_factory=set)
    nht: dict = field(default_factory=dict)  # addr -> NhtEntry


# ===== keys and the oracle =====


def _addr_key(addr: str):
    try:
        return (0, int(IPv4Address(addr)))
    except Exception:  # noqa: BLE001 — v6 sort after v4
        return (1, addr)


def _prefix_key(prefix: str):
    addr, _, plen = prefix.partition("/")
    return (_addr_key(addr), int(plen or 0))


def _route_compare(a: Route, b: Route) -> tuple[int, str]:
    """rib.rs Route::compare with default selection config.
    Returns (+1 if a preferred, -1 if b preferred, reason)."""
    av = a.attrs.local_pref if a.attrs.local_pref is not None else DFLT_LOCAL_PREF
    bv = b.attrs.local_pref if b.attrs.local_pref is not None else DFLT_LOCAL_PREF
    if av != bv:
        return (1 if av > bv else -1), "local-pref-lower"
    av, bv = a.attrs.path_length(), b.attrs.path_length()
    if av != bv:
        return (1 if av < bv else -1), "as-path-longer"
    av = ORIGIN_ORDER[a.attrs.origin]
    bv = ORIGIN_ORDER[b.attrs.origin]
    if av != bv:
        return (1 if av < bv else -1), "origin-type-higher"
    if a.attrs.first_as() == b.attrs.first_as():
        av, bv = a.attrs.med or 0, b.attrs.med or 0
        if av != bv:
            return (1 if av < bv else -1), "med-higher"
    order = {"Internal": 0, "External": 1}
    av, bv = order[a.route_type], order[b.route_type]
    if av != bv:
        return (1 if av > bv else -1), "prefer-external"
    if (a.igp_cost is None) != (b.igp_cost is None):
        return (
            1 if a.igp_cost is None else -1
        ), "nexthop-cost-higher"
    if a.igp_cost is not None and a.igp_cost != b.igp_cost:
        return (
            1 if a.igp_cost < b.igp_cost else -1
        ), "nexthop-cost-higher"
    if (
        a.origin.identifier is not None
        and b.origin.identifier is not None
    ):
        av = int(IPv4Address(a.origin.identifier))
        bv = int(IPv4Address(b.origin.identifier))
        if av != bv:
            return (1 if av < bv else -1), "higher-router-id"
    if (
        a.origin.remote_addr is not None
        and b.origin.remote_addr is not None
    ):
        av = _addr_key(a.origin.remote_addr)
        bv = _addr_key(b.origin.remote_addr)
        if av != bv:
            return (
                1 if av < bv else -1
            ), "higher-peer-address"
    return -1, "higher-peer-address"


def _multipath_equal(a: Route, b: Route, mp: dict) -> bool:
    """rib.rs:463-487 — equality prerequisites after full tie chain."""
    a_lp = a.attrs.local_pref if a.attrs.local_pref is not None else DFLT_LOCAL_PREF
    b_lp = b.attrs.local_pref if b.attrs.local_pref is not None else DFLT_LOCAL_PREF
    cmp_fields = (
        a_lp == b_lp
        and a.attrs.path_length() == b.attrs.path_length()
        and a.attrs.origin == b.attrs.origin
        and a.route_type == b.route_type
        and a.igp_cost == b.igp_cost
    )
    if not cmp_fields:
        return False
    if a.attrs.first_as() == b.attrs.first_as():
        if (a.attrs.med or 0) != (b.attrs.med or 0):
            return False
    if a.route_type == "External":
        return mp.get("allow_multiple_as", False) or (
            a.attrs.first_as() == b.attrs.first_as()
        )
    return a.attrs.as_path == b.attrs.as_path


# ===== the engine surface =====


class DecisionEngine:
    """The decision process of one BGP speaker, without sessions.

    ``table_backend`` is the dispatch seam (``ops.bgp_table``): None runs the
    scalar walk below (the oracle); a backend moves best-path and multipath
    selection onto the device, this walk its oracle.  ``ibus_cb(kind,
    payload)`` receives ``NexthopTrack`` / ``NexthopUntrack`` and the
    Loc-RIB's ``RouteIpAdd`` / ``RouteIpDel``.
    """

    def __init__(self, asn: int = 0, ibus_cb=None, table_backend=None):
        self.asn = asn
        self.ibus_cb = ibus_cb or (lambda kind, payload: None)
        self.table_backend = table_backend
        self.multipath: dict = {}  # afi_safi -> {"enabled","ebgp_max","ibgp_max","allow_multiple_as"}
        self.distance_external = 20
        self.distance_internal = 200
        self.tables: dict[str, Table] = {afs: Table() for afs in AFI_SAFIS}

    # ---- ibus rx

    def nexthop_update(self, addr: str, metric: int | None) -> None:
        for table in self.tables.values():
            nht = table.nht.get(addr)
            if nht is not None:
                nht.metric = metric
                table.queued.update(nht.prefixes.keys())
        self.trigger_decision_process()

    # ---- nexthop tracking (rib.rs:881-925)

    def _nexthop_track(self, table: Table, prefix: str, route: Route):
        addr = route.attrs.ll_nexthop or route.attrs.nexthop
        nht = table.nht.get(addr)
        if nht is None:
            nht = table.nht[addr] = NhtEntry()
            self.ibus_cb("NexthopTrack", {"addr": addr})
        nht.prefixes[prefix] = nht.prefixes.get(prefix, 0) + 1

    def _nexthop_untrack(self, table: Table, prefix: str, route: Route):
        addr = route.attrs.ll_nexthop or route.attrs.nexthop
        nht = table.nht.get(addr)
        if nht is None or prefix not in nht.prefixes:
            return
        nht.prefixes[prefix] -= 1
        if nht.prefixes[prefix] == 0:
            del nht.prefixes[prefix]
            if not nht.prefixes:
                self.ibus_cb("NexthopUntrack", {"addr": addr})
                del table.nht[addr]

    # ---- decision process (events.rs:643-848, rib.rs:297-774)

    def trigger_decision_process(self) -> None:
        """Scheduling is the caller's: it runs ``run_decision_process``."""

    def run_decision_process(self) -> None:
        for afs in AFI_SAFIS:
            self._decision_process(afs)

    def _decision_process(self, afs: str) -> None:
        table = self.tables[afs]
        queued = sorted(table.queued, key=_prefix_key)
        table.queued = set()
        tb = self.table_backend
        if tb is not None:
            # One device batch for the whole queued set: scatter the
            # changed rows, recompute only these prefixes, read the
            # verdicts back once.  Per-prefix results are consumed in
            # best_path below; any miss falls back to the scalar walk.
            tb.begin_batch(self, afs, table, queued)
        for prefix in queued:
            dest = table.prefixes.get(prefix)
            if dest is None:
                continue
            if tb is not None:
                best = tb.best_path(self, afs, table, prefix, dest)
            else:
                best = self._best_path(table, dest)
            self._loc_rib_update(afs, table, prefix, dest, best)
        # Prune empty destinations (events.rs:751-768).
        for prefix in queued:
            dest = table.prefixes.get(prefix)
            if (
                dest is not None
                and dest.local is None
                and dest.redistribute is None
                and all(
                    a.in_pre is None
                    and a.in_post is None
                    and a.out_pre is None
                    and a.out_post is None
                    for a in dest.adj_rib.values()
                )
            ):
                del table.prefixes[prefix]

    def _best_path(self, table: Table, dest: Destination) -> Route | None:
        best = None
        candidates = [
            adj.in_post
            for _, adj in sorted(dest.adj_rib.items(), key=lambda kv: _addr_key(kv[0]))
            if adj.in_post is not None
        ]
        if dest.redistribute is not None:
            candidates.append(dest.redistribute)
        for route in candidates:
            route.reject_reason = None
            route.ineligible_reason = None
            if route.attrs.as_path_contains(self.asn):
                route.ineligible_reason = "as-loop"
                continue
            if not route.origin.is_local():
                nexthop = route.attrs.ll_nexthop or route.attrs.nexthop
                nht = table.nht.get(nexthop)
                route.igp_cost = nht.metric if nht else None
                if route.igp_cost is None:
                    route.ineligible_reason = "unresolvable"
                    continue
            if best is None:
                best = route
            else:
                cmp, reason = _route_compare(route, best)
                if cmp > 0:
                    best.reject_reason = reason
                    best = route
                else:
                    route.reject_reason = reason
        if best is None:
            return None
        return Route(
            origin=best.origin,
            attrs=best.attrs,
            route_type=best.route_type,
            igp_cost=best.igp_cost,
        )

    def _compute_nexthops(
        self, afs: str, dest: Destination, best: Route
    ) -> frozenset | None:
        """rib.rs:667-705."""
        if best.origin.is_local():
            return None
        mp = self.multipath.get(afs)
        if not mp or not mp.get("enabled"):
            return frozenset(
                {best.attrs.ll_nexthop or best.attrs.nexthop}
            )
        max_paths = (
            mp.get("ibgp_max", 1)
            if best.route_type == "Internal"
            else mp.get("ebgp_max", 1)
        )
        nexthops = []
        for _, adj in sorted(
            dest.adj_rib.items(), key=lambda kv: _addr_key(kv[0])
        ):
            route = adj.in_post
            if route is None or not route.is_eligible():
                continue
            if not _multipath_equal(route, best, mp):
                continue
            nexthops.append(route.attrs.ll_nexthop or route.attrs.nexthop)
            if len(nexthops) >= max_paths:
                break
        return frozenset(nexthops)

    def _loc_rib_update(
        self, afs, table, prefix, dest: Destination, best: Route | None
    ) -> None:
        """rib.rs:776-847."""
        if best is not None:
            if self.table_backend is not None:
                nexthops = self.table_backend.compute_nexthops(
                    self, afs, prefix, dest, best
                )
            else:
                nexthops = self._compute_nexthops(afs, dest, best)
            if (
                dest.local is not None
                and dest.local.origin == best.origin
                and dest.local.attrs == best.attrs
                and dest.local.route_type == best.route_type
                and dest.local_nexthops == nexthops
            ):
                return
            dest.local = best
            dest.local_nexthops = nexthops
            if not best.origin.is_local():
                self.ibus_cb(
                    "RouteIpAdd",
                    {
                        "protocol": "bgp",
                        "prefix": prefix,
                        "distance": (
                            self.distance_internal
                            if best.route_type == "Internal"
                            else self.distance_external
                        ),
                        "metric": best.attrs.med or 0,
                        "tag": None,
                        "nexthops": [
                            {
                                "Recursive": {
                                    "addr": nh,
                                    "labels": [],
                                    "resolved": [],
                                }
                            }
                            for nh in sorted(nexthops or ())
                        ],
                    },
                )
        elif dest.local is not None:
            local = dest.local
            dest.local = None
            dest.local_nexthops = None
            if not local.origin.is_local():
                self.ibus_cb(
                    "RouteIpDel", {"protocol": "bgp", "prefix": prefix}
                )
