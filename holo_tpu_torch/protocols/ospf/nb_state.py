"""YANG-modeled OSPFv2 operational state.

Renders a live :class:`OspfInstance` into the ietf-ospf state tree —
the exact shape the reference serves through its northbound and records
in conformance snapshots (holo-ospf/src/northbound/state.rs; corpus:
holo-ospf/tests/conformance/ospfv2/**/northbound-state.json).  Volatile
leaves the reference marks ``ignore_in_testing`` (ages, seqnos,
checksums, timestamps) are omitted, matching the recorded trees.

Empty lists/containers are dropped, mirroring the reference's JSON
printer.
"""

from __future__ import annotations

from ipaddress import IPv4Address

from holo_tpu_torch.protocols.ospf.interface import IfType, IsmState, OspfInterface
from holo_tpu_torch.protocols.ospf.lsdb import Lsdb
from holo_tpu_torch.protocols.ospf.neighbor import NsmState
from holo_tpu_torch.protocols.ospf.packet import (
    EXT_PREFIX_OPAQUE_TYPE,
    GRACE_OPAQUE_TYPE,
    MAX_AGE,
    RI_CAP_GR_CAPABLE,
    RI_CAP_GR_HELPER,
    RI_CAP_STUB_ROUTER,
    RI_OPAQUE_TYPE,
    EXT_PREFIX_FLAG_A,
    EXT_PREFIX_FLAG_N,
    EXT_PREFIX_FLAG_AC,
    Lsa,
    LsaType,
    Options,
    RouterFlags,
    RouterLinkType,
    decode_ext_prefix_entries,
    decode_grace_tlvs,
    decode_router_info,
)

# ietf-ospf identity per LSA type (module prefix implied by context).
LSA_TYPE_NAME = {
    LsaType.ROUTER: "ospfv2-router-lsa",
    LsaType.NETWORK: "ospfv2-network-lsa",
    LsaType.SUMMARY_NETWORK: "ospfv2-network-summary-lsa",
    LsaType.SUMMARY_ROUTER: "ospfv2-asbr-summary-lsa",
    LsaType.AS_EXTERNAL: "ospfv2-as-external-lsa",
    LsaType.NSSA_EXTERNAL: "ospfv2-nssa-lsa",
    LsaType.OPAQUE_LINK: "ospfv2-link-scope-opaque-lsa",
    LsaType.OPAQUE_AREA: "ospfv2-area-scope-opaque-lsa",
    LsaType.OPAQUE_AS: "ospfv2-as-scope-opaque-lsa",
}

# RFC 8665 SID flag bit names, in the RECORDED corpus vintage's
# spelling (ietf-ospf-sr module, '-bit' suffixes; the module prefix is
# canonicalized away by the tree diff).
_PREFIX_SID_BITS = [
    (0x40, "np-bit"),
    (0x20, "m-bit"),
    (0x10, "e-bit"),
    (0x08, "v-bit"),
    (0x04, "l-bit"),
]
_ADJ_SID_BITS = [
    (0x80, "b-bit"),
    (0x40, "vi-bit"),
    (0x20, "lo-bit"),
    (0x10, "g-bit"),
    (0x08, "p-bit"),
]
_EXT_LINK_TYPE = {
    1: "point-to-point-link",
    2: "transit-network-link",
}
EXT_LINK_OPAQUE_TYPE = 8

_OPTION_BITS = [
    (Options.E, "v2-e-bit"),
    (Options.MC, "mc-bit"),
    (Options.NP, "v2-p-bit"),
    (Options.L, "ietf-ospf-lls:lls-bit"),
    (Options.DC, "v2-dc-bit"),
    (Options.O, "o-bit"),
]

_RTR_BITS = [
    (RouterFlags.B, "abr-bit"),
    (RouterFlags.E, "asbr-bit"),
    (RouterFlags.V, "vlink-end-bit"),
]

_LINK_TYPE_NAME = {
    RouterLinkType.POINT_TO_POINT: "point-to-point-link",
    RouterLinkType.TRANSIT_NETWORK: "transit-network-link",
    RouterLinkType.STUB_NETWORK: "stub-network-link",
    RouterLinkType.VIRTUAL_LINK: "virtual-link",
}

_ISM_NAME = {
    IsmState.DOWN: "down",
    IsmState.LOOPBACK: "loopback",
    IsmState.WAITING: "waiting",
    IsmState.POINT_TO_POINT: "point-to-point",
    IsmState.DR_OTHER: "dr-other",
    IsmState.BACKUP: "bdr",
    IsmState.DR: "dr",
}

_NSM_NAME = {
    NsmState.DOWN: "down",
    NsmState.ATTEMPT: "attempt",
    NsmState.INIT: "init",
    NsmState.TWO_WAY: "2-way",
    NsmState.EX_START: "exstart",
    NsmState.EXCHANGE: "exchange",
    NsmState.LOADING: "loading",
    NsmState.FULL: "full",
}

_ROUTE_TYPE_NAME = {
    "intra": "intra-area",
    "inter": "inter-area",
    "external-1": "external-1",
    "external-2": "external-2",
    "nssa-1": "nssa-1",
    "nssa-2": "nssa-2",
}

_GR_REASON_NAME = {
    0: "unknown",
    1: "software-restart",
    2: "software-upgrade",
    3: "control-processor-switchover",
}

_EXT_PREFIX_ROUTE_TYPE = {
    0: "unspecified",
    1: "intra-area",
    3: "inter-area",
    5: "external",
    7: "nssa",
}


def _bits(value, table) -> list[str]:
    return [name for bit, name in table if value & bit]


def _a(x) -> str:
    return str(IPv4Address(x))


def lsa_header_yang(lsa: Lsa, age: int) -> dict:
    h: dict = {
        "lsa-id": _a(lsa.lsid),
        "type": LSA_TYPE_NAME[lsa.type],
        "adv-router": _a(lsa.adv_rtr),
        "length": len(lsa.raw),
    }
    bits = _bits(lsa.options, _OPTION_BITS)
    if bits:
        # Empty bit containers are omitted (reference JSON printer).
        h["lsa-options"] = {"lsa-options": bits}
    if lsa.type in (
        LsaType.OPAQUE_LINK,
        LsaType.OPAQUE_AREA,
        LsaType.OPAQUE_AS,
    ):
        h["opaque-type"] = int(lsa.lsid) >> 24
        h["opaque-id"] = int(lsa.lsid) & 0xFFFFFF
    if age >= MAX_AGE:
        h["holo-ospf-dev:maxage"] = [None]
    return h


def _topology(metric: int) -> dict:
    return {"topologies": {"topology": [{"mt-id": 0, "metric": metric}]}}


def _opaque_body_yang(lsa: Lsa) -> dict:
    otype = int(lsa.lsid) >> 24
    data = lsa.body.data
    if otype == GRACE_OPAQUE_TYPE:
        info = decode_grace_tlvs(data)
        grace: dict = {}
        if "grace_period" in info:
            grace["grace-period"] = info["grace_period"]
        if "reason" in info:
            grace["graceful-restart-reason"] = _GR_REASON_NAME.get(
                info["reason"], "unknown"
            )
        if "addr" in info:
            grace["ip-interface-address"] = str(info["addr"])
        return {"holo-ospf:grace": grace}
    if otype == RI_OPAQUE_TYPE:
        info = decode_router_info(data)
        ri: dict = {}
        caps = info["info_caps"]
        if caps:
            names = []
            flags = []
            for bit, name in (
                (RI_CAP_GR_CAPABLE, "graceful-restart"),
                (RI_CAP_GR_HELPER, "graceful-restart-helper"),
                (RI_CAP_STUB_ROUTER, "stub-router"),
            ):
                if caps & bit:
                    names.append(name)
                    flags.append({"informational-flag": bit})
            ri["router-capabilities-tlv"] = {
                "router-informational-capabilities": {
                    "informational-capabilities": names
                },
                "informational-capabilities-flags": flags,
            }
        if info.get("sr_algos"):
            ri["ietf-ospf-sr:sr-algorithm-tlv"] = {
                "sr-algorithm": list(info["sr_algos"])
            }
        if info.get("srgb_ranges"):
            ri["ietf-ospf-sr:sid-range-tlvs"] = {
                "sid-range-tlv": [
                    {
                        "range-size": size,
                        **(
                            {"sid-sub-tlv": {"sid": first}}
                            if first is not None
                            else {}
                        ),
                    }
                    for size, first in info["srgb_ranges"]
                ]
            }
        if info["hostname"]:
            ri["dynamic-hostname-tlv"] = {"hostname": info["hostname"]}
        if info["node_tags"]:
            ri["node-tag-tlvs"] = {
                "node-tag-tlv": [
                    {
                        "node-tag": [
                            {"tag": t} for t in info["node_tags"]
                        ]
                    }
                ]
            }
        return {"ri-opaque": ri}
    if otype == EXT_PREFIX_OPAQUE_TYPE:
        tlvs = []
        for prefix, route_type, flags, sids in decode_ext_prefix_entries(
            data
        ):
            entry: dict = {
                "route-type": _EXT_PREFIX_ROUTE_TYPE.get(
                    route_type, "unspecified"
                ),
            }
            fl = []
            if flags & EXT_PREFIX_FLAG_A:
                fl.append("a-flag")
            if flags & EXT_PREFIX_FLAG_N:
                fl.append("node-flag")
            if flags & EXT_PREFIX_FLAG_AC:
                fl.append("ietf-ospf-anycast-flag:ac-flag")
            if fl:
                entry["flags"] = {"extended-prefix-flags": fl}
            entry["prefix"] = str(prefix)
            if sids:
                entry["ietf-ospf-sr:prefix-sid-sub-tlvs"] = {
                    "prefix-sid-sub-tlv": [
                        {
                            "prefix-sid-flags": {
                                "bits": _bits(
                                    s["flags"], _PREFIX_SID_BITS
                                )
                            },
                            "mt-id": s["mt"],
                            "algorithm": s["algo"],
                            "sid": s["sid"],
                        }
                        for s in sids
                    ]
                }
            tlvs.append(entry)
        return {
            "extended-prefix-opaque": {"extended-prefix-tlv": tlvs}
        }
    if otype == EXT_LINK_OPAQUE_TYPE:
        from holo_tpu_torch.protocols.ospf.packet import decode_ext_link

        links = decode_ext_link(data)
        if not links:
            return {}
        ltype, link_id, link_data, sids = links[0]
        out: dict = {
            "link-id": str(link_id),
            "link-data": str(link_data),
            "type": _EXT_LINK_TYPE.get(ltype, "unknown"),
        }
        p2p = [s for s in sids if "nbr" not in s]
        lan = [s for s in sids if "nbr" in s]
        if p2p:
            out["ietf-ospf-sr:adj-sid-sub-tlvs"] = {
                "adj-sid-sub-tlv": [
                    {
                        "adj-sid-flags": {
                            "bits": _bits(s["flags"], _ADJ_SID_BITS)
                        },
                        "mt-id": s["mt"],
                        "weight": s["weight"],
                        "sid": s["sid"],
                    }
                    for s in p2p
                ]
            }
        if lan:
            out["ietf-ospf-sr:lan-adj-sid-sub-tlvs"] = {
                "lan-adj-sid-sub-tlv": [
                    {
                        "lan-adj-sid-flags": {
                            "bits": _bits(s["flags"], _ADJ_SID_BITS)
                        },
                        "mt-id": s["mt"],
                        "weight": s["weight"],
                        "neighbor-router-id": str(s["nbr"]),
                        "sid": s["sid"],
                    }
                    for s in lan
                ]
            }
        return {"extended-link-opaque": {"extended-link-tlv": out}}
    return {}


def lsa_body_yang(lsa: Lsa) -> dict:
    t = lsa.type
    b = lsa.body
    if t == LsaType.ROUTER:
        body: dict = {"num-of-links": len(b.links)}
        bits = _bits(b.flags, _RTR_BITS)
        if bits:
            body["router-bits"] = {"rtr-lsa-bits": bits}
        if b.links:
            body["links"] = {
                "link": [
                    {
                        "link-id": _a(l.id),
                        "link-data": _a(l.data),
                        "type": _LINK_TYPE_NAME[l.link_type],
                        **_topology(l.metric),
                    }
                    for l in b.links
                ]
            }
        return {"router": body}
    if t == LsaType.NETWORK:
        body = {"network-mask": _a(b.mask)}
        if b.attached:
            body["attached-routers"] = {
                "attached-router": [_a(x) for x in b.attached]
            }
        return {"network": body}
    if t in (LsaType.SUMMARY_NETWORK, LsaType.SUMMARY_ROUTER):
        return {
            "summary": {
                "network-mask": _a(b.mask),
                **_topology(b.metric),
            }
        }
    if t in (LsaType.AS_EXTERNAL, LsaType.NSSA_EXTERNAL):
        topo = {
            "mt-id": 0,
            "flags": "v2-e-bit" if b.e_bit else "",
            "metric": b.metric,
            "external-route-tag": b.tag,
        }
        if int(b.fwd_addr):
            topo["forwarding-address"] = _a(b.fwd_addr)
        return {
            "external": {
                "network-mask": _a(b.mask),
                "topologies": {"topology": [topo]},
            }
        }
    if t in (LsaType.OPAQUE_LINK, LsaType.OPAQUE_AREA, LsaType.OPAQUE_AS):
        return {"opaque": _opaque_body_yang(lsa)}
    return {}


def render_lsa(lsa: Lsa, age: int) -> dict:
    out = {
        "lsa-id": _a(lsa.lsid),
        "adv-router": _a(lsa.adv_rtr),
        "decode-completed": True,
        "ospfv2": {
            "header": lsa_header_yang(lsa, age),
        },
    }
    body = lsa_body_yang(lsa)
    if body:
        out["ospfv2"]["body"] = body
    return out


def _db_buckets(entries, now, kind: str) -> tuple[list, list]:
    """Group LSA entries by type → (database list, statistics list)."""
    by_type: dict[int, list] = {}
    for e in entries:
        by_type.setdefault(int(e.lsa.type), []).append(e)
    db = []
    stats = []
    for t in sorted(by_type):
        lsas = sorted(
            by_type[t], key=lambda e: (int(e.lsa.lsid), int(e.lsa.adv_rtr))
        )
        db.append(
            {
                "lsa-type": t,
                f"{kind}-lsas": {
                    f"{kind}-lsa": [
                        render_lsa(e.lsa, e.current_age(now))
                        for e in lsas
                    ]
                },
            }
        )
        stats.append({"lsa-type": t, "lsa-count": len(lsas)})
    return db, stats


def _iface_state(
    inst, area, iface: OspfInterface, link_lsas: list, now
) -> dict:
    out: dict = {
        "name": iface.name,
        "state": _ISM_NAME[iface.state],
    }
    if int(iface.dr):
        out["dr-ip-addr"] = str(iface.dr)
        rid = _rid_for_addr(inst, iface, iface.dr)
        if rid is not None:
            out["dr-router-id"] = str(rid)
    if int(iface.bdr):
        out["bdr-ip-addr"] = str(iface.bdr)
        rid = _rid_for_addr(inst, iface, iface.bdr)
        if rid is not None:
            out["bdr-router-id"] = str(rid)
    db, stats = _db_buckets(link_lsas, now, "link-scope")
    out["statistics"] = {
        "link-scope-lsa-count": sum(s["lsa-count"] for s in stats)
    }
    if stats:
        out["statistics"]["database"] = {"link-scope-lsa-type": stats}
    if db:
        out["database"] = {"link-scope-lsa-type": db}
    nbrs = []
    for nbr in sorted(
        iface.neighbors.values(), key=lambda n: int(n.router_id)
    ):
        n: dict = {
            "neighbor-router-id": str(nbr.router_id),
            "address": str(nbr.src),
        }
        if int(nbr.dr):
            n["dr-ip-addr"] = str(nbr.dr)
            rid = _rid_for_addr(inst, iface, nbr.dr)
            if rid is not None:
                n["dr-router-id"] = str(rid)
        if int(nbr.bdr):
            n["bdr-ip-addr"] = str(nbr.bdr)
            rid = _rid_for_addr(inst, iface, nbr.bdr)
            if rid is not None:
                n["bdr-router-id"] = str(rid)
        n["state"] = _NSM_NAME[nbr.state]
        if nbr.gr_deadline is not None:
            n["holo-ospf:graceful-restart"] = {
                "restart-reason": _GR_REASON_NAME.get(
                    nbr.gr_reason, "unknown"
                )
            }
        n["statistics"] = {"nbr-retrans-qlen": len(nbr.ls_rxmt)}
        nbrs.append(n)
    if nbrs:
        out["neighbors"] = {"neighbor": nbrs}
    return out


def _rid_for_addr(inst, iface: OspfInterface, addr) -> IPv4Address | None:
    """Resolve an interface address to a router-id (self or a neighbor)."""
    if iface.addr_ip == addr:
        return inst.config.router_id
    for nbr in iface.neighbors.values():
        if nbr.src == addr:
            return nbr.router_id
    return None


def instance_state(inst) -> dict:
    """The full 'ietf-ospf:ospf' state subtree for an OspfInstance."""
    now = inst.loop.clock.now() if inst.loop is not None else 0.0
    if not getattr(inst, "enabled", True):
        # Disabled instance: minimal tree (areas + interface admin view),
        # like the reference's torn-down Instance<Down>.
        return _disabled_state(inst)
    ospf: dict = {"router-id": str(inst.config.router_id)}
    ospf["spf-control"] = {
        "ietf-spf-delay": {"current-state": inst.spf_state.value}
    }

    # Areas.
    areas = []
    hostnames: dict = {}
    as_entries: dict = {}  # LsaKey -> entry, deduped across areas
    for aid in sorted(inst.areas, key=int):
        area = inst.areas[aid]
        link_by_iface: dict[str, list] = {}
        area_entries = []
        for e in area.lsdb.all():
            t = e.lsa.type
            if t in (LsaType.AS_EXTERNAL, LsaType.OPAQUE_AS):
                as_entries[e.lsa.key] = e
                continue
            if t == LsaType.OPAQUE_LINK:
                ifname = inst._link_scope_iface.get(e.lsa.key)
                if ifname is not None:
                    link_by_iface.setdefault(ifname, []).append(e)
                continue
            area_entries.append(e)
            if t == LsaType.OPAQUE_AREA and (
                int(e.lsa.lsid) >> 24
            ) == RI_OPAQUE_TYPE:
                info = decode_router_info(e.lsa.body.data)
                if info["hostname"]:
                    hostnames[e.lsa.adv_rtr] = info["hostname"]

        db, stats = _db_buckets(area_entries, now, "area-scope")
        # Router flags come from the SPF products (captured at SPF time),
        # not the live LSDB — reference area.rs:164-182 counts
        # area.state.routers, which go stale together.
        reachable = inst._area_reachable_routers.get(aid, {})
        a: dict = {
            "area-id": str(aid),
            "statistics": {
                "abr-count": sum(
                    1
                    for fl in reachable.values()
                    if fl & RouterFlags.B
                ),
                "asbr-count": sum(
                    1
                    for fl in reachable.values()
                    if fl & RouterFlags.E
                ),
                "area-scope-lsa-count": sum(
                    s["lsa-count"] for s in stats
                ),
            },
        }
        if stats:
            a["statistics"]["database"] = {"area-scope-lsa-type": stats}
        if db:
            a["database"] = {"area-scope-lsa-type": db}
        # Virtual links render in their own container (§15), never in
        # the physical interface list.
        phys = [
            i for i in area.interfaces.values()
            if i.config.if_type != IfType.VIRTUAL_LINK
        ]
        vlinks = [
            i for i in area.interfaces.values()
            if i.config.if_type == IfType.VIRTUAL_LINK
        ]
        if vlinks:
            a["virtual-links"] = {
                "virtual-link": [
                    {
                        "transit-area-id": v.name.rsplit("-", 2)[-2],
                        "router-id": v.name.rsplit("-", 1)[-1],
                        "cost": v.config.cost,
                        "state": _ISM_NAME[v.state],
                        "statistics": {
                            "link-scope-lsa-count": len(
                                link_by_iface.get(v.name, [])
                            )
                        },
                        "neighbors": {
                            "neighbor": [
                                {
                                    "neighbor-router-id": str(
                                        n.router_id
                                    ),
                                    "address": str(n.src),
                                    "state": _NSM_NAME[n.state],
                                    "statistics": {
                                        "nbr-retrans-qlen": len(
                                            n.ls_rxmt
                                        )
                                    },
                                }
                                for n in v.neighbors.values()
                            ]
                        },
                    }
                    for v in sorted(vlinks, key=lambda i: i.name)
                ]
            }
        ifaces = [
            _iface_state(
                inst, area, iface, link_by_iface.get(iface.name, []), now
            )
            for iface in sorted(phys, key=lambda i: i.name)
        ]
        if ifaces:
            a["interfaces"] = {"interface": ifaces}
        areas.append(a)
    if areas:
        ospf["areas"] = {"area": areas}

    # AS-scope database + statistics.
    db, stats = _db_buckets(as_entries.values(), now, "as-scope")
    ospf["statistics"] = {
        "as-scope-lsa-count": sum(s["lsa-count"] for s in stats)
    }
    if stats:
        ospf["statistics"]["database"] = {"as-scope-lsa-type": stats}
    if db:
        ospf["database"] = {"as-scope-lsa-type": db}

    # Local RIB.
    routes = []
    for prefix in sorted(
        inst.routes, key=lambda p: (int(p.network_address), p.prefixlen)
    ):
        route = inst.routes[prefix]
        r: dict = {
            "prefix": str(prefix),
            "metric": route.dist,
            "route-type": _ROUTE_TYPE_NAME.get(route.rtype, route.rtype),
        }
        nhs = []
        for nh in sorted(
            route.nexthops,
            key=lambda n: (n.ifname, int(n.addr) if n.addr else 0),
        ):
            entry = {"outgoing-interface": nh.ifname}
            if nh.addr is not None:
                entry["next-hop"] = str(nh.addr)
            nhs.append(entry)
        if nhs:
            r["next-hops"] = {"next-hop": nhs}
        routes.append(r)
    if routes:
        ospf["local-rib"] = {"route": routes}

    if inst.hostname:
        hostnames[inst.config.router_id] = inst.hostname
    if hostnames:
        ospf["holo-ospf:hostnames"] = {
            "hostname": [
                {"router-id": str(rid), "hostname": hostnames[rid]}
                for rid in sorted(hostnames, key=int)
            ]
        }
    return ospf


def _disabled_state(inst) -> dict:
    areas = []
    for aid in sorted(inst.areas, key=int):
        area = inst.areas[aid]
        areas.append(
            {
                "area-id": str(aid),
                "statistics": {
                    "abr-count": 0,
                    "asbr-count": 0,
                    "area-scope-lsa-count": 0,
                },
                "interfaces": {
                    "interface": [
                        {
                            "name": iface.name,
                            "state": _ISM_NAME[iface.state],
                            "statistics": {"link-scope-lsa-count": 0},
                        }
                        for iface in sorted(
                            area.interfaces.values(), key=lambda i: i.name
                        )
                    ]
                },
            }
        )
    return {"areas": {"area": areas}} if areas else {}


def protocol_state(inst, name: str | None = None) -> dict:
    """Wrap in the ietf-routing control-plane-protocol envelope."""
    return {
        "ietf-routing:routing": {
            "control-plane-protocols": {
                "control-plane-protocol": [
                    {
                        "type": "ietf-ospf:ospfv2",
                        "name": name or inst.name,
                        "ietf-ospf:ospf": instance_state(inst),
                    }
                ]
            }
        }
    }
