"""IP address/prefix helpers over the stdlib ipaddress module.

Parallels holo-utils/src/ip.rs: address-family tagging, prefix utilities,
multicast constants the protocols need.
"""

from __future__ import annotations

import enum
from ipaddress import (
    IPv4Address,
    IPv4Network,
    IPv6Address,
    IPv6Network,
    ip_address,
    ip_network,
)


class AddressFamily(enum.Enum):
    IPV4 = 4
    IPV6 = 6


IpAddr = IPv4Address | IPv6Address
IpNetwork = IPv4Network | IPv6Network

# OSPF multicast groups (RFC 2328 §A.1 / RFC 5340).
ALL_SPF_RTRS_V4 = IPv4Address("224.0.0.5")
ALL_DR_RTRS_V4 = IPv4Address("224.0.0.6")
ALL_SPF_RTRS_V6 = IPv6Address("ff02::5")
ALL_DR_RTRS_V6 = IPv6Address("ff02::6")
# RIP (RFC 2453 §4.2) / RIPng (RFC 2080).
RIPV2_GROUP = IPv4Address("224.0.0.9")
RIPNG_GROUP = IPv6Address("ff02::9")
# VRRP (RFC 5798).
VRRP_GROUP_V4 = IPv4Address("224.0.0.18")
VRRP_GROUP_V6 = IPv6Address("ff02::12")


def af_of(addr: IpAddr) -> AddressFamily:
    return AddressFamily.IPV4 if addr.version == 4 else AddressFamily.IPV6


def parse_prefix(s: str) -> IpNetwork:
    return ip_network(s, strict=False)


def parse_addr(s: str) -> IpAddr:
    return ip_address(s)


def prefix_contains(net: IpNetwork, addr: IpAddr) -> bool:
    return addr.version == net.version and addr in net


def apply_mask(addr: IPv4Address, mask: IPv4Address) -> IPv4Network:
    """(addr, mask) pair → network, as OSPFv2 encodes prefixes on the wire."""
    return IPv4Network((int(addr) & int(mask), bin(int(mask)).count("1")))


def mask_of(net: IPv4Network) -> IPv4Address:
    return IPv4Address(int(net.netmask))


def router_id_u32(rid: IPv4Address) -> int:
    return int(rid)
