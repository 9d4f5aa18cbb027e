"""Network IO abstraction: real sockets (prod) and in-memory fabric (test).

The reference swaps raw sockets for empty mocks under its `testing` feature
(holo-utils/src/socket.rs:602-641) and replays recorded packets.  We go
further: ``MockFabric`` is an in-memory L2/L3 segment simulator that wires
instance interfaces onto shared links with multicast semantics, so true
multi-router convergence runs in-process under the virtual clock — no
recorded fixtures needed to exercise adjacency bring-up.

Real-socket transports (raw IP proto 89 for OSPF, UDP 520/521 for RIP,
TCP 179 for BGP, etc.) implement the same ``NetIo`` interface and register
with the event loop's IO poller; they require CAP_NET_RAW and are only
constructed by the daemon, never by tests.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

from holo_tpu_torch.utils.runtime import EventLoop


@dataclass
class NetRxPacket:
    """Delivered to a protocol actor when a frame arrives on an interface."""

    ifname: str
    src: Any  # source address (family-specific)
    dst: Any  # destination (unicast addr or multicast group)
    data: bytes


class NetIo:
    """Transmit-side interface handed to protocol instances."""

    def send(self, ifname: str, src: Any, dst: Any, data: bytes) -> None:
        raise NotImplementedError


@dataclass
class _Endpoint:
    actor: str
    ifname: str
    addr: Any


class MockFabric(NetIo):
    """In-memory links with multicast delivery and fault injection.

    Links are named; endpoints join a link as (actor, ifname, addr).
    Unicast delivers to the matching endpoint, multicast/broadcast to all
    other endpoints on the link.  ``set_link_up`` injects link failures;
    ``drop_next`` injects loss for retransmission tests.
    """

    def __init__(self, loop_: EventLoop):
        self.loop = loop_
        self.links: dict[str, list[_Endpoint]] = {}
        self._if_link: dict[tuple[str, str], str] = {}  # (actor, ifname) -> link
        self.link_up: dict[str, bool] = {}
        self._drop: list[Callable[[str, Any, bytes], bool]] = []
        self.tx_log: list[tuple[str, str, Any, Any]] = []  # (actor, ifname, dst, pkt)

    def join(self, link: str, actor: str, ifname: str, addr: Any) -> None:
        self.links.setdefault(link, []).append(_Endpoint(actor, ifname, addr))
        self._if_link[(actor, ifname)] = link
        self.link_up.setdefault(link, True)

    def set_link_up(self, link: str, up: bool) -> None:
        self.link_up[link] = up

    def add_drop_rule(self, fn: Callable[[str, Any, bytes], bool]) -> None:
        """fn(link, dst, data) -> True to drop the frame."""
        self._drop.append(fn)

    def sender_for(self, actor: str) -> NetIo:
        fabric = self

        class _Bound(NetIo):
            def send(self, ifname, src, dst, data):
                fabric._send(actor, ifname, src, dst, data)

        return _Bound()

    def _send(self, actor: str, ifname: str, src: Any, dst: Any, data: bytes) -> None:
        self.tx_log.append((actor, ifname, dst, data))
        if ifname is None:
            # Routed (multihop) send: pick the sender's link that can
            # reach ``dst`` — the mock kernel's FIB lookup.
            for (a, ifn), link in self._if_link.items():
                if a != actor:
                    continue
                if any(
                    ep.addr == dst and ep.actor != actor
                    for ep in self.links[link]
                ):
                    ifname = ifn
                    break
            else:
                return
        link = self._if_link.get((actor, ifname))
        if link is None or not self.link_up.get(link, False):
            return
        if any(rule(link, dst, data) for rule in self._drop):
            return
        for ep in self.links[link]:
            if ep.actor == actor and ep.ifname == ifname:
                continue  # no self-delivery
            is_mcast = getattr(dst, "is_multicast", False)
            if is_mcast or ep.addr == dst:
                self.loop.send(
                    ep.actor, NetRxPacket(ep.ifname, src, dst, data)
                )
