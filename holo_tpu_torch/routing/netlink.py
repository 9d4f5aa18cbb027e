"""rtnetlink link/address monitor and link actuation (Linux), from raw
AF_NETLINK sockets: the port's copy of the parts of
``holo_tpu.routing.netlink`` the daemon runs (``NetlinkMonitor`` and
``LinkManager`` when ``main`` runs as root, ``MockLinkManager`` otherwise).
The kernel FIB programmer (``NetlinkKernel``) is left out: the daemon's
``main`` programs no kernel FIB (its RIB runs on ``MockKernel``).

Reference: holo-interface/src/netlink.rs (link/address monitor).  No
netlink library is available in this environment, so the message
marshaling is implemented directly: nlmsghdr + ifinfomsg/ifaddrmsg +
attribute TLVs.
"""

from __future__ import annotations

import os
import socket
import struct
from dataclasses import dataclass

# netlink message types
RTM_NEWLINK = 16
RTM_DELLINK = 17
RTM_GETLINK = 18
RTM_NEWADDR = 20
RTM_DELADDR = 21
RTM_GETADDR = 22
NLMSG_ERROR = 2
NLMSG_DONE = 3

# multicast groups for the monitor socket
RTMGRP_LINK = 0x1
RTMGRP_IPV4_IFADDR = 0x10
RTMGRP_IPV6_IFADDR = 0x100

IFA_ADDRESS = 1
IFA_LOCAL = 2
IFF_UP = 0x1
IFF_RUNNING = 0x40

NLM_F_REQUEST = 0x01
NLM_F_ACK = 0x04
NLM_F_DUMP = 0x300
NLM_F_CREATE = 0x400
NLM_F_REPLACE = 0x100

# rtmsg fields

# route attributes
IFLA_ADDRESS = 1
IFLA_MTU = 4
IFLA_LINK = 5
IFLA_LINKINFO = 18
IFLA_INFO_KIND = 1
IFLA_INFO_DATA = 2
IFLA_MACVLAN_MODE = 1
MACVLAN_MODE_BRIDGE = 4
IFLA_VLAN_ID = 1  # nested in IFLA_INFO_DATA for kind "vlan"
IFF_UP = 1

# link attributes
IFLA_IFNAME = 3


def _align(n: int) -> int:
    return (n + 3) & ~3


def _attr(rta_type: int, data: bytes) -> bytes:
    length = 4 + len(data)
    return struct.pack("<HH", length, rta_type) + data + b"\x00" * (
        _align(length) - length
    )


class NetlinkSocket:
    def __init__(self) -> None:
        self.sock = socket.socket(
            socket.AF_NETLINK, socket.SOCK_RAW, socket.NETLINK_ROUTE
        )
        self.sock.bind((0, 0))
        self._seq = 1

    def close(self) -> None:
        self.sock.close()

    def _send(self, msg_type: int, flags: int, payload: bytes) -> int:
        seq = self._seq
        self._seq += 1
        hdr = struct.pack(
            "<IHHII", 16 + len(payload), msg_type, flags, seq, os.getpid()
        )
        self.sock.send(hdr + payload)
        return seq

    def request_ack(self, msg_type: int, flags: int, payload: bytes) -> None:
        """Send and wait for the ACK; raises OSError on kernel error."""
        seq = self._send(msg_type, flags | NLM_F_REQUEST | NLM_F_ACK, payload)
        while True:
            data = self.sock.recv(65536)
            off = 0
            while off < len(data):
                mlen, mtype, _, mseq, _ = struct.unpack_from("<IHHII", data, off)
                if mseq == seq and mtype == NLMSG_ERROR:
                    (err,) = struct.unpack_from("<i", data, off + 16)
                    if err != 0:
                        raise OSError(-err, os.strerror(-err))
                    return
                off += _align(mlen)

    def dump(self, msg_type: int, payload: bytes) -> list[tuple[int, bytes]]:
        """NLM_F_DUMP request; returns [(msg_type, payload)] until DONE."""
        seq = self._send(msg_type, NLM_F_REQUEST | NLM_F_DUMP, payload)
        out = []
        done = False
        while not done:
            data = self.sock.recv(65536)
            off = 0
            while off < len(data):
                mlen, mtype, _, mseq, _ = struct.unpack_from("<IHHII", data, off)
                if mseq == seq:
                    if mtype == NLMSG_DONE:
                        done = True
                        break
                    if mtype == NLMSG_ERROR:
                        (err,) = struct.unpack_from("<i", data, off + 16)
                        raise OSError(-err, os.strerror(-err))
                    out.append((mtype, data[off + 16 : off + mlen]))
                off += _align(mlen)
        return out


def parse_attrs(data: bytes) -> dict[int, bytes]:
    out = {}
    off = 0
    while off + 4 <= len(data):
        length, rta_type = struct.unpack_from("<HH", data, off)
        if length < 4:
            break
        out[rta_type] = data[off + 4 : off + length]
        off += _align(length)
    return out


def link_table(nl: NetlinkSocket) -> dict[str, int]:
    """ifname -> ifindex via RTM_GETLINK dump."""
    payload = struct.pack("<BBHiII", socket.AF_UNSPEC, 0, 0, 0, 0, 0)
    out = {}
    for mtype, body in nl.dump(RTM_GETLINK, payload):
        if mtype != RTM_NEWLINK or len(body) < 16:
            continue
        _, _, _, ifindex, _, _ = struct.unpack_from("<BBHiII", body, 0)
        attrs = parse_attrs(body[16:])
        name = attrs.get(IFLA_IFNAME, b"").split(b"\x00")[0].decode()
        if name:
            out[name] = ifindex
    return out


@dataclass
class LinkEvent:
    kind: str  # "link" | "link-del" | "addr" | "addr-del"
    ifindex: int
    ifname: str = ""
    up: bool = False
    running: bool = False
    mtu: int = 0
    addr: object = None  # ip_interface for addr events


class MockLinkManager:
    """Test double for :class:`LinkManager` (records actuations)."""

    def __init__(self):
        self.links: dict[str, dict] = {}
        self.log: list[tuple] = []

    def create_macvlan(self, parent, name, mac=None):
        self.links[name] = {"parent": parent, "mac": mac, "up": False,
                            "addrs": []}
        self.log.append(("create-macvlan", parent, name, mac))

    def create_vlan(self, parent, name, vlan_id):
        self.links[name] = {"parent": parent, "vlan_id": vlan_id,
                            "up": False, "addrs": []}
        self.log.append(("create-vlan", parent, name, vlan_id))

    def delete_link(self, name):
        self.links.pop(name, None)
        self.log.append(("delete-link", name))

    def set_link(self, name, up=None, mtu=None):
        if name not in self.links:
            raise OSError(f"no such link {name!r}")
        st = self.links[name]
        if up is not None:
            st["up"] = up
        if mtu is not None:
            st["mtu"] = mtu
        self.log.append(("set-link", name, up, mtu))

    def add_address(self, name, addr):
        if name not in self.links:
            raise OSError(f"no such link {name!r}")
        self.links[name]["addrs"].append(addr)
        self.log.append(("add-address", name, addr))


class LinkManager:
    """Link actuation: macvlan creation (VRRP virtual MACs), admin status
    and MTU apply (reference holo-interface/src/netlink.rs:242-270 and the
    macvlan path instance.rs:301-311)."""

    def __init__(self, nl: NetlinkSocket | None = None):
        self.nl = nl or NetlinkSocket()

    def _ifindex(self, name: str) -> int | None:
        return link_table(self.nl).get(name)

    @staticmethod
    def _ifinfomsg(ifindex: int = 0, flags: int = 0, change: int = 0) -> bytes:
        return struct.pack("<BBHiII", socket.AF_UNSPEC, 0, 0, ifindex, flags, change)

    def create_macvlan(
        self, parent: str, name: str, mac: bytes | None = None
    ) -> None:
        parent_idx = self._ifindex(parent)
        if parent_idx is None:
            raise OSError(f"no such link {parent!r}")
        payload = self._ifinfomsg()
        payload += _attr(IFLA_IFNAME, name.encode() + b"\x00")
        payload += _attr(IFLA_LINK, struct.pack("<i", parent_idx))
        if mac is not None:
            payload += _attr(IFLA_ADDRESS, mac)
        info = _attr(IFLA_INFO_KIND, b"macvlan\x00")
        info += _attr(
            IFLA_INFO_DATA,
            _attr(IFLA_MACVLAN_MODE, struct.pack("<I", MACVLAN_MODE_BRIDGE)),
        )
        payload += _attr(IFLA_LINKINFO, info)
        self.nl.request_ack(RTM_NEWLINK, NLM_F_CREATE | NLM_F_REPLACE, payload)

    def create_vlan(self, parent: str, name: str, vlan_id: int) -> None:
        """802.1Q subinterface on ``parent`` (reference
        holo-interface/src/netlink.rs:271-285 vlan_create)."""
        if not 1 <= vlan_id <= 4094:
            raise ValueError(f"vlan-id must be 1-4094, got {vlan_id}")
        parent_idx = self._ifindex(parent)
        if parent_idx is None:
            raise OSError(f"no such link {parent!r}")
        payload = self._ifinfomsg()
        payload += _attr(IFLA_IFNAME, name.encode() + b"\x00")
        payload += _attr(IFLA_LINK, struct.pack("<i", parent_idx))
        info = _attr(IFLA_INFO_KIND, b"vlan\x00")
        info += _attr(
            IFLA_INFO_DATA,
            _attr(IFLA_VLAN_ID, struct.pack("<H", vlan_id)),
        )
        payload += _attr(IFLA_LINKINFO, info)
        self.nl.request_ack(RTM_NEWLINK, NLM_F_CREATE | NLM_F_REPLACE, payload)

    def delete_link(self, name: str) -> None:
        idx = self._ifindex(name)
        if idx is None:
            return
        self.nl.request_ack(RTM_DELLINK, 0, self._ifinfomsg(ifindex=idx))

    def set_link(
        self, name: str, up: bool | None = None, mtu: int | None = None
    ) -> None:
        idx = self._ifindex(name)
        if idx is None:
            raise OSError(f"no such link {name!r}")
        flags = change = 0
        if up is not None:
            change = IFF_UP
            flags = IFF_UP if up else 0
        payload = self._ifinfomsg(ifindex=idx, flags=flags, change=change)
        if mtu is not None:
            payload += _attr(IFLA_MTU, struct.pack("<I", mtu))
        self.nl.request_ack(RTM_NEWLINK, 0, payload)

    def add_address(self, name: str, addr) -> None:
        """ip_interface-style addr on a link (the VRRP virtual IP)."""
        idx = self._ifindex(name)
        if idx is None:
            raise OSError(f"no such link {name!r}")
        family = socket.AF_INET if addr.version == 4 else socket.AF_INET6
        payload = struct.pack(
            "<BBBBi", family, addr.network.prefixlen, 0, 0, idx
        )
        IFA_LOCAL, IFA_ADDRESS = 2, 1
        payload += _attr(IFA_LOCAL, addr.ip.packed)
        payload += _attr(IFA_ADDRESS, addr.ip.packed)
        self.nl.request_ack(RTM_NEWADDR, NLM_F_CREATE | NLM_F_REPLACE, payload)


class NetlinkMonitor:
    """Kernel link/address event monitor (holo-interface's netlink watch,
    holo-interface/src/netlink.rs:92-239).

    A second AF_NETLINK socket subscribed to the LINK/IFADDR multicast
    groups; the daemon registers its fd with the poller and calls
    ``drain()`` on readiness, feeding events into the interface provider.
    """

    IFLA_MTU = 4

    def __init__(self) -> None:
        self.sock = socket.socket(
            socket.AF_NETLINK, socket.SOCK_RAW, socket.NETLINK_ROUTE
        )
        groups = RTMGRP_LINK | RTMGRP_IPV4_IFADDR | RTMGRP_IPV6_IFADDR
        self.sock.bind((0, groups))
        self.sock.setblocking(False)
        self.overflowed = False

    def fileno(self) -> int:
        return self.sock.fileno()

    def close(self) -> None:
        self.sock.close()

    def drain(self) -> list[LinkEvent]:
        """Drain queued events.  On kernel queue overflow (ENOBUFS) the
        ``overflowed`` flag is set — the caller MUST re-dump full state
        (link_table + addresses) because events were lost."""
        import errno
        from ipaddress import ip_address, ip_interface

        events: list[LinkEvent] = []
        while True:
            try:
                data = self.sock.recv(65536)
            except BlockingIOError:
                break
            except OSError as e:
                if e.errno == errno.ENOBUFS:
                    self.overflowed = True
                    continue  # later events may still be readable
                raise
            off = 0
            while off + 16 <= len(data):
                mlen, mtype, _f, _seq, _pid = struct.unpack_from(
                    "<IHHII", data, off
                )
                if mlen < 16:
                    break
                ev = self._parse_one(mtype, data[off + 16 : off + mlen])
                if ev is not None:
                    events.append(ev)
                off += _align(mlen)
        return events

    @staticmethod
    def _parse_one(mtype: int, body: bytes) -> "LinkEvent | None":
        from ipaddress import ip_address, ip_interface

        if mtype in (RTM_NEWLINK, RTM_DELLINK) and len(body) >= 16:
            _fam, _res, _t, ifindex, flags, _chg = struct.unpack_from(
                "<BBHiII", body, 0
            )
            attrs = parse_attrs(body[16:])
            name = attrs.get(IFLA_IFNAME, b"").split(b"\x00")[0].decode()
            mtu = 0
            raw_mtu = attrs.get(NetlinkMonitor.IFLA_MTU)
            if raw_mtu is not None and len(raw_mtu) >= 4:
                (mtu,) = struct.unpack("<I", raw_mtu[:4])
            return LinkEvent(
                "link" if mtype == RTM_NEWLINK else "link-del",
                ifindex,
                name,
                bool(flags & IFF_UP),
                bool(flags & IFF_RUNNING),
                mtu,
            )
        if mtype in (RTM_NEWADDR, RTM_DELADDR) and len(body) >= 8:
            fam, plen, _flags, _scope, ifindex = struct.unpack_from(
                "<BBBBi", body, 0
            )
            attrs = parse_attrs(body[8:])
            raw = attrs.get(IFA_LOCAL) or attrs.get(IFA_ADDRESS)
            if raw is not None:
                addr = ip_interface((ip_address(raw), plen))
                return LinkEvent(
                    "addr" if mtype == RTM_NEWADDR else "addr-del",
                    ifindex,
                    addr=addr,
                )
        return None

    def resync(self) -> list[LinkEvent]:
        """Full link+address dump (recovery after ENOBUFS overflow)."""
        nl = NetlinkSocket()
        try:
            events: list[LinkEvent] = []
            payload = struct.pack("<BBHiII", socket.AF_UNSPEC, 0, 0, 0, 0, 0)
            for mtype, body in nl.dump(RTM_GETLINK, payload):
                ev = self._parse_one(mtype, body)
                if ev is not None:
                    events.append(ev)
            for family in (socket.AF_INET, socket.AF_INET6):
                payload = struct.pack("<BBBBi", family, 0, 0, 0, 0)
                for mtype, body in nl.dump(RTM_GETADDR, payload):
                    ev = self._parse_one(mtype, body)
                    if ev is not None:
                        events.append(ev)
            return events
        finally:
            nl.close()
