"""Southbound message types: routes, interfaces, labels.

Parallels holo-utils/src/southbound.rs:112-190 — the payloads protocols
exchange with the routing/interface providers over the ibus.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from ipaddress import IPv4Address

from holo_tpu_torch.utils.ip import IpAddr, IpNetwork


class Protocol(enum.Enum):
    """Protocol registry (holo-utils/src/protocol.rs:18)."""

    BFD = "bfd"
    BGP = "bgp"
    DIRECT = "direct"
    IGMP = "igmp"
    ISIS = "isis"
    LDP = "ldp"
    OSPFV2 = "ospfv2"
    OSPFV3 = "ospfv3"
    RIPV2 = "ripv2"
    RIPNG = "ripng"
    STATIC = "static"
    VRRP = "vrrp"


# Default administrative distances (lower wins in the RIB).
DEFAULT_DISTANCE = {
    Protocol.DIRECT: 0,
    Protocol.STATIC: 1,
    Protocol.BGP: 20,
    Protocol.OSPFV2: 110,
    Protocol.OSPFV3: 110,
    Protocol.ISIS: 115,
    Protocol.RIPV2: 120,
    Protocol.RIPNG: 120,
}


class RouteOpaqueFlags(enum.Flag):
    NONE = 0
    CONNECTED = enum.auto()


@dataclass(frozen=True)
class Nexthop:
    """Resolved next hop: address and/or outgoing interface (+MPLS labels)."""

    addr: IpAddr | None = None
    ifname: str | None = None
    ifindex: int | None = None
    labels: tuple[int, ...] = ()


@dataclass
class RouteMsg:
    """Route install/uninstall payload (southbound.rs RouteMsg)."""

    protocol: Protocol
    prefix: IpNetwork
    distance: int
    metric: int
    nexthops: frozenset[Nexthop] = frozenset()
    tag: int | None = None
    opaque_attrs: dict = field(default_factory=dict)
    # IP-FRR precomputed repairs: primary next hop -> loop-free backup
    # (holo_tpu_torch.frr).  The RIB keeps them beside the installed primaries
    # and flips to them in O(1) on BFD/link-down, before reconvergence.
    backups: dict = field(default_factory=dict)
    # UCMP weights {Nexthop -> saturated path count}: ride
    # beside the ECMP set so the FIB layer can program weighted
    # next-hop groups; empty = plain equal-cost hashing.
    nh_weights: dict = field(default_factory=dict)


@dataclass
class RouteKeyMsg:
    protocol: Protocol
    prefix: IpNetwork


@dataclass
class LabelInstallMsg:
    protocol: Protocol
    label: int
    nexthops: frozenset[Nexthop] = frozenset()
    route: tuple | None = None


@dataclass
class LabelUninstallMsg:
    protocol: Protocol
    label: int


@dataclass
class AddressFlags:
    unnumbered: bool = False


@dataclass
class InterfaceUpdMsg:
    ifname: str
    ifindex: int
    mtu: int = 1500
    operative: bool = True
    loopback: bool = False
    mac: bytes = b"\x00" * 6


@dataclass
class AddressMsg:
    ifname: str
    addr: IpNetwork  # interface address with prefix length


@dataclass
class RouterIdMsg:
    router_id: IPv4Address | None
