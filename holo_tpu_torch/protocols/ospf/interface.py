"""OSPF interface state machine (ISM, RFC 2328 §9) + DR election (§9.4).

Reference: holo-ospf/src/interface.rs.  States for p2p and broadcast
networks; NBMA/p2mp deferred.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from ipaddress import IPv4Address, IPv4Network

from holo_tpu_torch.protocols.ospf.packet import Options


class IfType(enum.Enum):
    POINT_TO_POINT = "p2p"
    BROADCAST = "broadcast"
    # RFC 2328 §15: unnumbered point-to-point through a transit area.
    VIRTUAL_LINK = "virtual-link"


class IsmState(enum.IntEnum):
    DOWN = 0
    LOOPBACK = 1
    WAITING = 2
    POINT_TO_POINT = 3
    DR_OTHER = 4
    BACKUP = 5
    DR = 6


class IsmEvent(enum.Enum):
    INTERFACE_UP = "up"
    WAIT_TIMER = "wait_timer"
    BACKUP_SEEN = "backup_seen"
    NEIGHBOR_CHANGE = "neighbor_change"
    INTERFACE_DOWN = "down"


@dataclass
class IfConfig:
    area_id: IPv4Address = IPv4Address("0.0.0.0")
    if_type: IfType = IfType.BROADCAST
    cost: int = 10
    hello_interval: int = 10
    dead_interval: int = 40
    rxmt_interval: int = 5
    priority: int = 1
    passive: bool = False
    # Loopback interfaces advertise their host address as a zero-cost
    # stub link and run no hello machinery (reference: holo-ospf treats
    # kernel-loopback interfaces this way in the router-LSA build).
    loopback: bool = False
    mtu: int = 1500
    # RFC 2328 §10.6: a DD whose Interface MTU exceeds ours is rejected
    # (adjacency sticks in ExStart) unless mtu-ignore bypasses the check
    # (ietf-ospf interface leaf of the same name).
    mtu_ignore: bool = False
    # §13.3 InfTransDelay: seconds added to every LSA's age when it is
    # copied into an outgoing Link State Update on this interface
    # (ietf-ospf transmit-delay leaf).
    transmit_delay: int = 1
    bfd_enabled: bool = False
    auth: object = None  # AuthCtx (packet.py) or None
    # RFC 7684 prefix attribute flags advertised in extended-prefix
    # opaque LSAs: N marks a node host address, AC an anycast address
    # (reference ospfv2/lsdb.rs:760-783, iana.rs LsaExtPrefixFlags).
    node_flag: bool = False
    anycast_flag: bool = False
    # Shared-risk link group ids of this interface (ietf fast-reroute
    # SRLG membership).  Lowered to the uint32 ``Topology.edge_srlg``
    # bitmask at SPF marshal time (spf_run.srlg_bits; ids fold mod 32,
    # conservative-correct) — the srlg_disjoint FRR policy input.
    srlg: tuple = ()


@dataclass
class OspfInterface:
    name: str
    config: IfConfig
    addr_ip: IPv4Address | None = None  # our interface address
    prefix: IPv4Network | None = None  # attached subnet
    ifindex: int = 0
    state: IsmState = IsmState.DOWN
    dr: IPv4Address = IPv4Address(0)  # DR *interface address* (v2, §9)
    bdr: IPv4Address = IPv4Address(0)
    neighbors: dict = field(default_factory=dict)  # nbr router-id -> Neighbor
    # Additional subnets on the interface: advertised as stub links
    # (reference advertises every interface address).
    secondary: list = field(default_factory=list)  # [IPv4Network]
    # Virtual-link state (reference interface.rs:50,84,135-148): the
    # configured peer router-id, the transit area carrying the link, the
    # resolved unicast destination (the peer's transit-area interface
    # address) and the physical interface packets leave through.
    vlink_peer: IPv4Address | None = None
    vlink_transit: IPv4Address | None = None
    vlink_dst: IPv4Address | None = None
    vlink_out_ifname: str | None = None

    def options(self) -> Options:
        return Options.E  # stub-area support sets E=0 per area config later

    def is_dr(self) -> bool:
        return self.state == IsmState.DR

    def is_dr_or_bdr(self) -> bool:
        return self.state in (IsmState.DR, IsmState.BACKUP)


@dataclass(frozen=True)
class ElectionView:
    """A router's view for DR election: (priority, router-id, declared DR/BDR)."""

    priority: int
    router_id: IPv4Address
    addr: IPv4Address
    dr: IPv4Address
    bdr: IPv4Address


def elect_dr_bdr(views: list[ElectionView]) -> tuple[IPv4Address, IPv4Address]:
    """RFC 2328 §9.4 steps 2-3 (single pass; caller reruns on state change).

    Returns (dr_addr, bdr_addr) as interface addresses (0.0.0.0 if none).
    """
    eligible = [v for v in views if v.priority > 0]

    def best(cands):
        return max(cands, key=lambda v: (v.priority, int(v.router_id)))

    # BDR: routers not declaring themselves DR; prefer those declaring BDR.
    bdr_cands = [v for v in eligible if v.dr != v.addr]
    declared_bdr = [v for v in bdr_cands if v.bdr == v.addr]
    bdr = best(declared_bdr) if declared_bdr else (best(bdr_cands) if bdr_cands else None)

    # DR: routers declaring themselves DR; else the BDR is promoted.
    declared_dr = [v for v in eligible if v.dr == v.addr]
    if declared_dr:
        dr = best(declared_dr)
    else:
        dr = bdr
    if dr is not None and dr is bdr:
        # Promoted BDR: re-elect BDR excluding the new DR.
        rest = [v for v in bdr_cands if v is not dr]
        declared = [v for v in rest if v.bdr == v.addr]
        bdr = best(declared) if declared else (best(rest) if rest else None)

    zero = IPv4Address(0)
    return (dr.addr if dr else zero, bdr.addr if bdr else zero)
