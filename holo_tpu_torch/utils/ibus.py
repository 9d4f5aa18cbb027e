"""ibus: the in-process typed pub/sub bus between providers and protocols.

Reference: holo-utils/src/ibus.rs — five server components (routing,
interface, system, keychain, policy) serve subscriptions; each client has a
dedicated channel pair; ~50 message kinds (ibus.rs:112-228).

Here the bus rides the shared EventLoop: a subscription routes matching
publications into the subscriber actor's inbox, wrapped in ``IbusMsg`` so
protocol actors can dispatch on one envelope type.  Disconnect = actor
unregistration (the loop drops undeliverable sends, mirroring
channel-drop detection at ibus.rs:473-488).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any

from holo_tpu_torch import telemetry
from holo_tpu_torch.telemetry import convergence
from holo_tpu_torch.utils.runtime import EventLoop
from holo_tpu_torch.utils.southbound import Protocol

# Bus observability: publish rate per topic plus the undeliverable
# count (a send to an unregistered/disconnected actor — the reference's
# channel-drop detection moment, ibus.rs:473-488).
_PUBLISHES = telemetry.counter(
    "holo_ibus_publish_total", "ibus publications delivered", ("topic",)
)
_UNDELIVERABLE = telemetry.counter(
    "holo_ibus_undeliverable_total",
    "ibus sends dropped (no such actor / disconnected)",
    ("topic",),
)


@dataclass
class IbusMsg:
    """Envelope delivered to subscriber actors.

    ``event_id`` is the causal-event stamp of the convergence
    observatory: construction captures the publisher's active event ids
    (a tuple, or None while the tracker is disarmed / no event is open)
    so the EventLoop delivery hook can re-activate the causal context
    inside the subscriber's handler — this is how an LSA arrival's id
    rides publish → protocol actor → RIB → FIB commit."""

    topic: str
    payload: Any
    sender: str = ""
    event_id: tuple | None = None

    def __post_init__(self):
        if self.event_id is None:
            self.event_id = convergence.current() or None


# Topic names (grouped as in ibus.rs:112-228).
TOPIC_INTERFACE_UPD = "interface.upd"
TOPIC_INTERFACE_DEL = "interface.del"
TOPIC_ADDRESS_ADD = "interface.addr.add"
TOPIC_ADDRESS_DEL = "interface.addr.del"
TOPIC_ROUTER_ID = "system.router_id"
TOPIC_HOSTNAME = "system.hostname"
TOPIC_ROUTE_ADD = "routing.route.add"
TOPIC_ROUTE_DEL = "routing.route.del"
TOPIC_ROUTE_MPLS_ADD = "routing.mpls.add"
TOPIC_ROUTE_MPLS_DEL = "routing.mpls.del"
TOPIC_ROUTE_BIER_ADD = "routing.bier.add"
TOPIC_ROUTE_BIER_DEL = "routing.bier.del"
TOPIC_REDISTRIBUTE_ADD = "routing.redistribute.add"
TOPIC_REDISTRIBUTE_DEL = "routing.redistribute.del"
TOPIC_NHT_UPD = "routing.nht.upd"
TOPIC_BFD_STATE = "bfd.state"
TOPIC_KEYCHAIN_UPD = "keychain.upd"
TOPIC_KEYCHAIN_DEL = "keychain.del"
TOPIC_POLICY_UPD = "policy.upd"
TOPIC_POLICY_MATCH_SETS_UPD = "policy.match_sets.upd"
TOPIC_SR_CFG = "sr.cfg"
TOPIC_BIER_CFG = "bier.cfg"
TOPIC_MACVLAN_ADD = "interface.macvlan.add"
TOPIC_MACVLAN_DEL = "interface.macvlan.del"


@dataclass
class _Sub:
    actor: str
    # Optional filters: e.g. redistribute subs filter on (protocol, af);
    # interface subs may filter on ifname.
    filter: dict = field(default_factory=dict)


class Ibus:
    """Topic-routed pub/sub over the event loop.

    Thread-shared under preemptive isolation: protocol instances
    publish from their own ThreadedLoop threads while commit-time
    (un)subscribes run on the management thread, so ``_subs`` has an
    owning lock.  Discipline (holo-lint HL203): the lock only guards
    the subscription table — matching subscribers are *snapshotted*
    under the lock and delivery (``loop.send``, which may take another
    loop's wake lock) happens after release, so a publish can never
    deadlock against a subscriber's own locking.
    """

    def __init__(self, loop_: EventLoop):
        self.loop = loop_
        self._subs: dict[str, list[_Sub]] = {}
        self._lock = threading.Lock()

    def subscribe(self, topic: str, actor: str, **filters) -> None:
        with self._lock:
            subs = self._subs.setdefault(topic, [])
            if not any(
                s.actor == actor and s.filter == filters for s in subs
            ):
                subs.append(_Sub(actor, filters))

    def unsubscribe(self, topic: str, actor: str) -> None:
        with self._lock:
            self._subs[topic] = [
                s for s in self._subs.get(topic, []) if s.actor != actor
            ]

    def unsubscribe_all(self, actor: str) -> None:
        with self._lock:
            for topic in self._subs:
                self._subs[topic] = [
                    s for s in self._subs[topic] if s.actor != actor
                ]

    def publish(
        self, topic: str, payload: Any, sender: str = "", **match
    ) -> int:
        """Deliver to all subscribers whose filters match; returns count."""
        # Snapshot-then-release: never call loop.send under _lock.
        with self._lock:
            targets = [
                s.actor
                for s in self._subs.get(topic, [])
                if all(match.get(k) == v for k, v in s.filter.items())
            ]
        n = 0
        dropped = 0
        for actor in targets:
            if self.loop.send(actor, IbusMsg(topic, payload, sender)):
                n += 1
            else:
                dropped += 1
        if n:
            _PUBLISHES.labels(topic=topic).inc(n)
        if dropped:
            _UNDELIVERABLE.labels(topic=topic).inc(dropped)
        return n

    def request(self, server_actor: str, payload: Any, sender: str = "") -> bool:
        """Directed request to a server component (e.g. route install —
        ibus.rs route_install path); reply comes back as a publication or a
        directed IbusMsg."""
        return self.loop.send(server_actor, IbusMsg("request", payload, sender))


@dataclass
class BfdSessionReg:
    sender: str
    key: tuple  # session key (ifname/addr family specifics)
    local: Any = None  # local address for the session's tx packets
    client_id: int = 0
    min_rx: int = 1000000
    min_tx: int = 1000000
    multiplier: int = 3


@dataclass
class BfdSessionUnreg:
    sender: str
    key: tuple


@dataclass
class BfdStateUpd:
    key: tuple
    state: str  # 'up' | 'down' | 'admin-down' | 'init'


@dataclass
class RedistributeSub:
    protocol: Protocol
    af: int
