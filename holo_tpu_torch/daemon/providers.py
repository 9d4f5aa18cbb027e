"""Base system providers: interface, system, keychain, policy, routing (the
port's copy of ``holo_tpu.daemon.providers``; the routing provider runs
OSPFv2 and static routes and refuses the protocols not ported yet).

Reference: SURVEY.md §2.2 — each is an actor + northbound provider + ibus
server.  The routing provider owns the RIB manager and spawns/stops
protocol instances from configuration (the reference does this in
holo-routing/src/northbound/configuration.rs:1228-1301).
"""

from __future__ import annotations

import logging

log = logging.getLogger("holo_tpu_torch.providers")

from dataclasses import dataclass, field
from ipaddress import IPv4Address, ip_interface

from holo_tpu_torch.device import resolve_device
from holo_tpu_torch.frr.manager import FrrConfig, ensure_engine
from holo_tpu_torch.northbound.provider import CommitPhase, Provider
from holo_tpu_torch.pipeline import wrap_spf_backend
from holo_tpu_torch.protocols.ospf.instance import (
    IfConfig,
    IfDownMsg,
    IfUpMsg,
    InstanceConfig,
    OspfInstance,
    SpfTimers,
)
from holo_tpu_torch.protocols.ospf.interface import IfType
from holo_tpu_torch.routing.rib import Kernel, MockKernel, RibManager
from holo_tpu_torch.spf.backend import ScalarSpfBackend, TorchSpfBackend
from holo_tpu_torch.utils.ibus import (
    TOPIC_ADDRESS_ADD,
    TOPIC_HOSTNAME,
    TOPIC_INTERFACE_UPD,
    TOPIC_KEYCHAIN_UPD,
    TOPIC_POLICY_UPD,
    TOPIC_ROUTER_ID,
    Ibus,
)
from holo_tpu_torch.utils.runtime import Actor, EventLoop
from holo_tpu_torch.utils.southbound import InterfaceUpdMsg


@dataclass
class IfaceState:
    name: str
    ifindex: int
    mtu: int = 1500
    enabled: bool = True
    operative: bool = True
    addresses: list = field(default_factory=list)
    # (parent, vlan-id) of the kernel 802.1Q device we actuated for this
    # interface; None = no vlan device created by us.
    vlan_actuated: tuple | None = None


class InterfaceProvider(Provider, Actor):
    """Interface table owner.  In the daemon this mirrors the OS via
    netlink (holo-interface/src/netlink.rs); under test it is driven by
    config + synthetic link events."""

    name = "interface"
    subtree_prefixes = ("interfaces",)

    def __init__(self, ibus: Ibus):
        self.ibus = ibus
        self.interfaces: dict[str, IfaceState] = {}
        self._next_ifindex = 1
        # Set by the daemon: where connected (direct) routes are sent.
        self.routing_actor: str | None = None
        self._direct: set = set()  # prefixes currently installed as direct
        # Set by the daemon when kernel actuation is available: config
        # admin-status/MTU changes then apply via netlink (reference
        # holo-interface/src/netlink.rs:242-270).
        self.link_mgr = None

    def handle(self, msg):
        pass

    def validate(self, new_tree) -> None:
        # Fail-closed at commit time (same pattern as the keychain
        # lifetime validation): a bad vlan-id or a vlan interface
        # without its parent must reject the commit, not silently skip
        # device creation at apply time.
        from holo_tpu_torch.northbound.provider import CommitError

        for name, entry in (
            new_tree.get("interfaces/interface", {}) or {}
        ).items():
            if entry.get("type") != "vlan":
                continue
            vid = entry.get("vlan-id")
            if vid is not None and not 1 <= vid <= 4094:
                raise CommitError(
                    f"interface {name}: vlan-id must be 1-4094, got {vid}"
                )
            if (vid is None) != (not entry.get("parent-interface")):
                raise CommitError(
                    f"interface {name}: vlan interfaces need BOTH "
                    f"parent-interface and vlan-id"
                )

    def _sync_direct_routes(self) -> None:
        """Connected prefixes go into the RIB as protocol 'direct' at
        distance 0 with an empty next-hop set — they win over any IGP copy
        of the same prefix and the empty set keeps them out of the kernel
        FIB (which already has them)."""
        from holo_tpu_torch.utils.southbound import Protocol, RouteKeyMsg, RouteMsg

        if self.routing_actor is None:
            return
        wanted = {
            a.network
            for st in self.interfaces.values()
            if st.operative
            for a in st.addresses
        }
        for prefix in self._direct - wanted:
            self.ibus.request(
                self.routing_actor,
                RouteKeyMsg(Protocol.DIRECT, prefix),
                sender=self.name,
            )
        for prefix in wanted - self._direct:
            self.ibus.request(
                self.routing_actor,
                RouteMsg(Protocol.DIRECT, prefix, 0, 0, frozenset()),
                sender=self.name,
            )
        self._direct = wanted

    def commit(self, phase, old, new, changes):
        if phase != CommitPhase.APPLY:
            return
        conf = new.get("interfaces/interface", {}) or {}
        for name, entry in conf.items():
            st = self.interfaces.get(name)
            if st is None:
                st = IfaceState(name=name, ifindex=self._next_ifindex)
                self._next_ifindex += 1
                self.interfaces[name] = st
            # 802.1Q subinterface actuation is CHANGE-driven (reference
            # configuration.rs:122-131,354-365 Event::VlanCreate fires
            # on the config change, not on map appearance): whenever the
            # wanted (parent, vlan-id) differs from what we actuated,
            # tear the old device down and create the new one.
            want_vlan = (
                (entry.get("parent-interface"), entry.get("vlan-id"))
                if entry.get("type") == "vlan"
                and entry.get("parent-interface")
                and entry.get("vlan-id") is not None
                else None
            )
            if self.link_mgr is not None and want_vlan != st.vlan_actuated:
                try:
                    if st.vlan_actuated is not None:
                        self.link_mgr.delete_link(name)
                        st.vlan_actuated = None
                    if want_vlan is not None:
                        self.link_mgr.create_vlan(
                            want_vlan[0], name, want_vlan[1]
                        )
                        st.vlan_actuated = want_vlan
                except (OSError, ValueError) as e:
                    log.error("vlan actuation failed for %s: %s", name, e)
            new_mtu = entry.get("mtu", 1500)
            new_enabled = entry.get("enabled", True)
            if self.link_mgr is not None and (
                new_mtu != st.mtu or new_enabled != st.enabled
            ):
                try:
                    self.link_mgr.set_link(
                        name,
                        up=new_enabled if new_enabled != st.enabled else None,
                        mtu=new_mtu if new_mtu != st.mtu else None,
                    )
                except OSError as e:
                    log.error("link apply failed for %s: %s", name, e)
            st.mtu = new_mtu
            st.enabled = new_enabled
            st.addresses = [ip_interface(a) for a in entry.get("address", [])]
            # Causal origin: an interface config change is a topology
            # event (convergence trigger class "ifconfig").
            from holo_tpu_torch.telemetry import convergence

            eid = convergence.begin(
                convergence.TRIGGER_IFCONFIG, ifname=name,
                operative=st.enabled and st.operative,
            )
            with convergence.activation(eid):
                self.ibus.publish(
                    TOPIC_INTERFACE_UPD,
                    # operative = admin AND carrier: a config commit must
                    # not report a carrier-down link as up (the RIB treats
                    # operative=True as an FRR restore signal).
                    InterfaceUpdMsg(ifname=name, ifindex=st.ifindex,
                                    mtu=st.mtu,
                                    operative=st.enabled and st.operative),
                    ifname=name,
                )
            for addr in st.addresses:
                self.ibus.publish(TOPIC_ADDRESS_ADD, (name, addr), ifname=name)
        from holo_tpu_torch.utils.ibus import TOPIC_INTERFACE_DEL

        for name in list(self.interfaces):
            if name not in conf:
                st = self.interfaces.pop(name)
                # Symmetric teardown: a vlan device WE created goes away
                # with its config entry, or the kernel link leaks and a
                # later re-add with a different id fails changelink.
                if st.vlan_actuated is not None and self.link_mgr is not None:
                    try:
                        self.link_mgr.delete_link(name)
                    except OSError as e:
                        log.error("vlan teardown failed for %s: %s", name, e)
                self.ibus.publish(TOPIC_INTERFACE_DEL, name, ifname=name)
        self._publish_router_id()
        self._sync_direct_routes()

    def _publish_router_id(self):
        """Router-ID derivation: highest interface address (reference
        holo-interface/src/interface.rs Router-ID logic)."""
        best = None
        for st in self.interfaces.values():
            for a in st.addresses:
                if a.version == 4 and (best is None or int(a.ip) > int(best)):
                    best = a.ip
        self.ibus.publish(TOPIC_ROUTER_ID, best)

    def apply_kernel_event(self, ev) -> None:
        """Feed a NetlinkMonitor LinkEvent into the provider table (the
        production path; config-driven interfaces take precedence)."""
        from holo_tpu_torch.utils.ibus import TOPIC_INTERFACE_DEL

        if ev.kind == "link":
            st = self.interfaces.get(ev.ifname)
            if st is None:
                st = IfaceState(name=ev.ifname, ifindex=ev.ifindex)
                self.interfaces[ev.ifname] = st
            st.ifindex = ev.ifindex
            st.operative = ev.up and ev.running
            if ev.mtu:
                st.mtu = ev.mtu
            # Causal origin: a kernel link event is the carrier-loss /
            # carrier-recovery moment (convergence trigger "carrier").
            from holo_tpu_torch.telemetry import convergence

            eid = convergence.begin(
                convergence.TRIGGER_CARRIER, ifname=ev.ifname,
                operative=st.operative,
            )
            with convergence.activation(eid):
                self.ibus.publish(
                    TOPIC_INTERFACE_UPD,
                    InterfaceUpdMsg(ifname=ev.ifname, ifindex=st.ifindex,
                                    mtu=st.mtu, operative=st.operative),
                    ifname=ev.ifname,
                )
        elif ev.kind == "link-del":
            if self.interfaces.pop(ev.ifname, None) is not None:
                self.ibus.publish(TOPIC_INTERFACE_DEL, ev.ifname,
                                  ifname=ev.ifname)
                self._publish_router_id()
        elif ev.kind in ("addr", "addr-del"):
            for st in self.interfaces.values():
                if st.ifindex == ev.ifindex:
                    if ev.kind == "addr" and ev.addr not in st.addresses:
                        st.addresses.append(ev.addr)
                        self.ibus.publish(TOPIC_ADDRESS_ADD,
                                          (st.name, ev.addr), ifname=st.name)
                    elif ev.kind == "addr-del" and ev.addr in st.addresses:
                        st.addresses.remove(ev.addr)
                    self._publish_router_id()
                    self._sync_direct_routes()
                    break

    def get_state(self, path=None):
        return {
            "interfaces": {
                "interface": {
                    name: {
                        "name": name,
                        "if-index": st.ifindex,
                        "oper-status": "up" if st.operative else "down",
                        "mtu": st.mtu,
                    }
                    for name, st in self.interfaces.items()
                }
            }
        }


class SystemProvider(Provider, Actor):
    name = "system"
    subtree_prefixes = ("system",)

    def __init__(self, ibus: Ibus):
        self.ibus = ibus
        self.hostname = ""

    def handle(self, msg):
        pass

    def commit(self, phase, old, new, changes):
        if phase != CommitPhase.APPLY:
            return
        hostname = new.get("system/hostname")
        if hostname != self.hostname:
            self.hostname = hostname or ""
            self.ibus.publish(TOPIC_HOSTNAME, self.hostname)

    def get_state(self, path=None):
        return {"system": {"hostname": self.hostname}}


class KeychainProvider(Provider, Actor):
    name = "keychain"
    subtree_prefixes = ("key-chains",)

    def __init__(self, ibus: Ibus):
        self.ibus = ibus
        self.keychains: dict = {}

    def handle(self, msg):
        pass

    def validate(self, new_tree) -> None:
        # FAIL-CLOSED on lifetimes: a malformed date-and-time must
        # reject the commit, never silently become an unbounded key.
        from holo_tpu_torch.northbound.provider import CommitError
        from holo_tpu_torch.utils.keychain import Keychain

        for name, chain in (
            new_tree.get("key-chains/key-chain", {}) or {}
        ).items():
            try:
                Keychain.from_config(name, chain)
            except ValueError as e:
                raise CommitError(f"key-chain {name!r}: {e}") from e

    def commit(self, phase, old, new, changes):
        from holo_tpu_torch.utils.ibus import TOPIC_KEYCHAIN_DEL

        if phase != CommitPhase.APPLY:
            return
        prev = self.keychains
        self.keychains = new.get("key-chains/key-chain", {}) or {}
        for name in prev.keys() - self.keychains.keys():
            self.ibus.publish(TOPIC_KEYCHAIN_DEL, name)
        for name, chain in self.keychains.items():
            if prev.get(name) != chain:  # changed or new only
                self.ibus.publish(TOPIC_KEYCHAIN_UPD, name)


class PolicyProvider(Provider, Actor):
    name = "policy"
    subtree_prefixes = ("routing-policy",)

    def __init__(self, ibus: Ibus):
        from holo_tpu_torch.utils.policy import PolicyEngine

        self.ibus = ibus
        self.engine = PolicyEngine()
        self.policies: dict = {}
        self.defined_sets: dict = {}

    def handle(self, msg):
        pass

    def commit(self, phase, old, new, changes):
        if phase != CommitPhase.APPLY:
            return
        self.policies = new.get("routing-policy/policy-definition", {}) or {}
        self.defined_sets = new.get("routing-policy/defined-sets", {}) or {}
        self.engine.load_from_config(
            {
                "defined-sets": self.defined_sets,
                "policy-definition": self.policies,
            }
        )
        for name in self.policies:
            self.ibus.publish(TOPIC_POLICY_UPD, name)



class RoutingProvider(Provider, Actor):
    """RIB owner + protocol instance lifecycle from configuration."""

    name = "routing"
    subtree_prefixes = ("routing",)

    # Optional placement hooks (set by the daemon): with preemptive
    # isolation each protocol instance is registered on its own
    # ThreadedLoop instead of the shared loop (utils/preempt.py).
    instance_placer = None
    instance_unplacer = None

    def _place_instance(self, inst):
        """Registers the instance and returns the object the provider
        should hold: the instance itself (cooperative), or a marshalling
        handle when the daemon placed it on its own thread."""
        if self.instance_placer is not None:
            return self.instance_placer(inst) or inst
        if hasattr(inst, "attach_loop"):
            # Multi-actor node (IS-IS L1/L2): registers the per-level
            # actors plus the node's own packet entry point.
            inst.attach_loop(self.loop)
        else:
            self.loop.register(inst)
        return inst

    def _unplace_instance(self, name: str) -> None:
        if self.instance_unplacer is not None:
            self.instance_unplacer(name)
            return
        if name in self.loop.actors:
            self.loop.unregister(name)
        # Multi-actor node: its per-level actors carry "<name>-..." names.
        for sub in [a for a in self.loop.actors if a.startswith(f"{name}-")]:
            self.loop.unregister(sub)

    # The protocols whose instances are not ported yet, by the item of the
    # port's ROADMAP that ports them.  Their configuration fails validation:
    # a commit must never be accepted and then run nothing.
    UNPORTED = {
        "ospfv3": "A15",
        "isis": "A16",
        "ripv2": "A17",
        "ripng": "A17",
        "bgp": "A17",
        "vrrp": "A17",
        "igmp": "A17",
        "ldp": "A17",
    }

    def validate(self, new_tree) -> None:
        from holo_tpu_torch.northbound.provider import CommitError

        for proto, item in self.UNPORTED.items():
            if new_tree.get(f"routing/control-plane-protocols/{proto}"):
                raise CommitError(
                    f"{proto}: the protocol is not ported to holo_tpu_torch "
                    f"yet (ROADMAP {item})"
                )
        # Keychain references must resolve within the same candidate.
        chains = new_tree.get("key-chains/key-chain", {}) or {}
        areas = new_tree.get(
            "routing/control-plane-protocols/ospfv2/area", {}
        ) or {}
        for area_conf in areas.values():
            for ifname, if_conf in (area_conf.get("interface") or {}).items():
                kc = (if_conf.get("authentication") or {}).get("key-chain")
                if kc is None:
                    continue
                if kc not in chains:
                    raise CommitError(
                        f"interface {ifname}: unknown key-chain {kc!r}"
                    )
                if not (chains[kc].get("key") or {}):
                    raise CommitError(
                        f"interface {ifname}: key-chain {kc!r} has no keys"
                    )
        # RFC 2328: the backbone can never be a stub area (any spelling of
        # area id 0 counts).
        for area_id, area_conf in areas.items():
            try:
                is_backbone = int(IPv4Address(area_id)) == 0
            except Exception:
                is_backbone = area_id in ("0", "0.0.0.0")
            if is_backbone and area_conf.get("area-type") in ("stub", "nssa"):
                raise CommitError("the backbone area cannot be stub or NSSA")

    def __init__(
        self,
        loop: EventLoop,
        ibus: Ibus,
        netio,
        interface_provider: InterfaceProvider,
        kernel: Kernel | None = None,
        prefix: str = "",
        policy_engine=None,
        keychains: "KeychainProvider | None" = None,
        nvstore=None,
        link_mgr=None,
        yang_notify=None,
        microloop_delay: float = 0.0,
        device=None,
    ):
        """``device``: where ``spf-control/backend tpu`` runs its SPF and
        ``fast-reroute/engine tpu`` its backup tables (the card unless the
        caller asks for the CPU)."""
        self.loop = loop
        self.ibus = ibus
        # Sink for protocol YANG notifications (reference notification.rs
        # -> northbound -> management clients); the daemon points this at
        # its fan-out so gRPC/gNMI Subscribe streams see them.
        self.yang_notify = yang_notify
        self.policy_engine = policy_engine
        self.keychains = keychains
        self.nvstore = nvstore
        # Link actuation (macvlans, admin/MTU): LinkManager in production,
        # MockLinkManager under test.
        if link_mgr is None:
            from holo_tpu_torch.routing.netlink import MockLinkManager

            link_mgr = MockLinkManager()
        self.link_mgr = link_mgr
        # netio: either a NetIo (shared sender) or a callable actor->NetIo
        # (MockFabric.sender_for) so each protocol actor receives its own
        # bound transmit handle.
        self.netio_factory = netio if callable(netio) else (lambda _actor: netio)
        self.ifp = interface_provider
        self.prefix = prefix
        self.rib = RibManager(
            ibus, kernel or MockKernel(), microloop_delay=microloop_delay
        )
        self.instances: dict[str, OspfInstance] = {}
        self.device = resolve_device(device)
        # No-argument class (the reuse check below compares classes): one
        # backend per OSPFv2 instance survives commits.
        self.spf_backend_class = TorchSpfBackend.bound_to(self.device)

    def attach(self, loop_):
        super().attach(loop_)
        loop_.register(self.rib, name=f"{self.prefix}routing-rib")
        from holo_tpu_torch.utils.ibus import (
            TOPIC_INTERFACE_DEL,
            TOPIC_KEYCHAIN_DEL,
            TOPIC_KEYCHAIN_UPD,
            TOPIC_REDISTRIBUTE_ADD,
            TOPIC_REDISTRIBUTE_DEL,
        )

        self.ibus.subscribe(TOPIC_INTERFACE_DEL, self.name)
        self.ibus.subscribe(TOPIC_KEYCHAIN_UPD, self.name)
        self.ibus.subscribe(TOPIC_KEYCHAIN_DEL, self.name)
        self.ibus.subscribe(TOPIC_REDISTRIBUTE_ADD, self.name)
        self.ibus.subscribe(TOPIC_REDISTRIBUTE_DEL, self.name)
        # BFD is always-on, spawned at startup inside the routing provider
        # (reference holo-routing/src/lib.rs:261-281).
        from holo_tpu_torch.protocols.bfd import BfdInstance

        self.bfd = BfdInstance(
            self.netio_factory(f"{self.prefix}bfd"), self.ibus,
            notif_cb=self.yang_notify,
        )
        loop_.register(self.bfd, name=f"{self.prefix}bfd")

    def handle(self, msg):
        from holo_tpu_torch.utils.ibus import (
            TOPIC_INTERFACE_DEL,
            TOPIC_KEYCHAIN_DEL,
            TOPIC_KEYCHAIN_UPD,
            TOPIC_REDISTRIBUTE_ADD,
            TOPIC_REDISTRIBUTE_DEL,
            IbusMsg,
        )

        if isinstance(msg, IbusMsg) and msg.topic in (
            TOPIC_REDISTRIBUTE_ADD,
            TOPIC_REDISTRIBUTE_DEL,
        ):
            self._handle_redistribution(msg)
            return
        if isinstance(msg, IbusMsg) and msg.topic in (
            TOPIC_KEYCHAIN_UPD,
            TOPIC_KEYCHAIN_DEL,
        ):
            # Key rotation: re-resolve AuthCtx for interfaces referencing
            # the changed keychain (in place — adjacencies re-key live).
            self._refresh_ospf_auth()
            return
        if isinstance(msg, IbusMsg) and msg.topic == TOPIC_INTERFACE_DEL:
            # Interface removed from the system: down it in the instance
            # that uses it (stops hellos, withdraws the subnet).
            ifname = msg.payload
            inst = self.instances.get("ospfv2")
            if isinstance(inst, OspfInstance) and ifname in inst._if_area:
                self.loop.send(inst.name, IfDownMsg(ifname))

    def commit(self, phase, old, new, changes):
        if phase != CommitPhase.APPLY:
            return
        self._last_tree = new
        self._apply_ospfv2(new)
        self._apply_static(new)

    def _handle_redistribution(self, msg) -> None:
        """RIB redistribution → OSPF type-5 origination (reference:
        redistribution pub/sub, holo-routing/src/rib.rs:71)."""
        from holo_tpu_torch.utils.ibus import TOPIC_REDISTRIBUTE_ADD
        from holo_tpu_torch.utils.southbound import Protocol

        inst = self.instances.get("ospfv2")
        wanted = getattr(self, "_ospf_redistribute", set())
        if inst is None:
            return
        payload = msg.payload
        proto = payload.protocol
        if proto in (Protocol.OSPFV2,):
            return  # never re-inject our own routes
        if payload.prefix.version != 4:
            return
        if msg.topic == TOPIC_REDISTRIBUTE_ADD:
            if proto.value in wanted:
                inst.redistribute(payload.prefix, metric=max(payload.metric, 1))
            elif payload.prefix in inst.redistributed:
                # Best route switched to a non-redistributed protocol: the
                # type-5 must go (the RIB only publishes DEL on full
                # removal, so the ADD with the new winner is our signal).
                inst.withdraw_redistributed(payload.prefix)
        else:
            inst.withdraw_redistributed(payload.prefix)

    def _refresh_ospf_auth(self) -> None:
        tree = getattr(self, "_last_tree", None)
        inst = self.instances.get("ospfv2")
        if tree is None or inst is None:
            return
        areas = tree.get("routing/control-plane-protocols/ospfv2/area", {}) or {}
        for area_conf in areas.values():
            for ifname, if_conf in (area_conf.get("interface") or {}).items():
                ai = inst._iface(ifname)
                if ai is not None:
                    ai[1].config.auth = self._ospf_auth(
                        if_conf.get("authentication")
                    )

    # -- OSPFv2 lifecycle (holo-routing northbound/configuration.rs analog)

    def _apply_ospfv2(self, new):
        base = "routing/control-plane-protocols/ospfv2"
        conf = new.get(base)
        enabled = bool(conf) and new.get(f"{base}/enabled", True)
        inst = self.instances.get("ospfv2")
        if not enabled:
            if inst is not None:
                # Withdraw every route the instance installed before it goes
                # (reference: instance stop purges its RIB contributions).
                from holo_tpu_torch.utils.southbound import Protocol, RouteKeyMsg

                for prefix in inst.routes:
                    self.rib.route_del(RouteKeyMsg(Protocol.OSPFV2, prefix))
                self._unplace_instance(inst.name)
                del self.instances["ospfv2"]
            return
        router_id = new.get(f"{base}/router-id")
        if router_id is None:
            return  # not ready (reference: instance waits for router-id)
        spf = new.get(f"{base}/spf-control", {}) or {}
        delay = spf.get("ietf-spf-delay", {}) or {}
        timers = SpfTimers(
            initial_delay=delay.get("initial-delay", 50) / 1000,
            short_delay=delay.get("short-delay", 200) / 1000,
            long_delay=delay.get("long-delay", 5000) / 1000,
            hold_down=delay.get("hold-down", 10000) / 1000,
            time_to_learn=delay.get("time-to-learn", 500) / 1000,
        )
        backend_name = spf.get("backend", "scalar")
        # Reuse the live backend when the engine kind is unchanged (the
        # ensure_engine pattern): a rebuilt TorchSpfBackend on every
        # commit would discard its resident graph and mint a fresh
        # breaker metric series each time.
        want = self.spf_backend_class if backend_name == "tpu" else ScalarSpfBackend
        prev = getattr(inst, "backend", None) if inst is not None else None
        # A pipelined backend wraps the real one (AsyncSpfBackend.inner):
        # the reuse check looks through the facade, and a fresh tpu
        # backend rides the process pipeline when one is armed
        # (wrap_spf_backend is the identity otherwise).
        prev_core = getattr(prev, "inner", prev)
        backend = prev if type(prev_core) is want else wrap_spf_backend(want())
        old_redist = getattr(self, "_ospf_redistribute", set())
        self._ospf_redistribute = set(new.get(f"{base}/redistribute") or [])
        redist_changed = old_redist != self._ospf_redistribute
        if inst is None:
            inst = OspfInstance(
                name=f"{self.prefix}ospfv2",
                config=InstanceConfig(router_id=IPv4Address(router_id), spf=timers),
                netio=self.netio_factory(f"{self.prefix}ospfv2"),
                spf_backend=backend,
                notif_cb=self.yang_notify,
                nvstore=self.nvstore,
            )
            inst = self._place_instance(inst)
            inst.attach_ibus(
                self.ibus,
                routing_actor=f"{self.prefix}routing-rib",
                bfd_actor=f"{self.prefix}bfd",
            )
            self.instances["ospfv2"] = inst
        else:
            inst.config.router_id = IPv4Address(router_id)
            inst.config.spf = timers
            inst.backend = backend
        # IP fast reroute (mirrors the reference YANG fast-reroute
        # container: ietf-ospf fast-reroute/lfa plus holo's remote-lfa /
        # ti-lfa extension leaves).  A change must force a full SPF run:
        # that is what recomputes (or, on disable, drops) the backup
        # tables and republishes routes with the new repair set.
        new_frr = self._frr_config(new.get(f"{base}/fast-reroute"))
        if new_frr is not None and new_frr.active():
            # The engine on the daemon's device, made here (the instance's
            # own lazy step would build a torch engine on the card).
            inst._frr_engine = ensure_engine(inst._frr_engine, new_frr, self.device)
        if new_frr != inst.config.frr:
            inst.config.frr = new_frr
            inst._schedule_spf()
        # RFC 6987 stub-router maintenance mode (max-metric router-LSA).
        inst.set_stub_router(bool(new.get(f"{base}/stub-router", False)))

        areas = new.get(f"{base}/area", {}) or {}
        for area_id, area_conf in areas.items():
            area_type = area_conf.get("area-type", "normal")
            stub = area_type == "stub"
            nssa = area_type == "nssa"
            stub_cost = area_conf.get("default-cost", 1)
            for ifname, if_conf in (area_conf.get("interface") or {}).items():
                if ifname in inst._if_area:
                    # Live reconfiguration on the running circuit
                    # (reference configuration.rs InterfaceUpdate
                    # family); auth refreshes via _refresh_ospf_auth.
                    st = self.ifp.interfaces.get(ifname)
                    inst.iface_cost_update(ifname, if_conf.get("cost", 10))
                    inst.iface_update(
                        ifname,
                        hello=if_conf.get("hello-interval", 10),
                        dead=if_conf.get("dead-interval", 40),
                        priority=if_conf.get("priority", 1),
                        passive=if_conf.get("passive", False),
                        mtu=st.mtu if st is not None else None,
                        mtu_ignore=if_conf.get("mtu-ignore", False),
                        transmit_delay=if_conf.get("transmit-delay", 1),
                    )
                    continue
                st = self.ifp.interfaces.get(ifname)
                if st is None or not st.addresses:
                    continue
                addr = st.addresses[0].network
                host = st.addresses[0].ip
                cfg = IfConfig(
                    area_id=IPv4Address(area_id),
                    if_type=(
                        IfType.POINT_TO_POINT
                        if if_conf.get("interface-type") == "point-to-point"
                        else IfType.BROADCAST
                    ),
                    cost=if_conf.get("cost", 10),
                    hello_interval=if_conf.get("hello-interval", 10),
                    dead_interval=if_conf.get("dead-interval", 40),
                    rxmt_interval=if_conf.get("retransmit-interval", 5),
                    priority=if_conf.get("priority", 1),
                    passive=if_conf.get("passive", False),
                    mtu=st.mtu,
                    mtu_ignore=if_conf.get("mtu-ignore", False),
                    transmit_delay=if_conf.get("transmit-delay", 1),
                    bfd_enabled=if_conf.get("bfd", False),
                    auth=self._ospf_auth(if_conf.get("authentication")),
                )
                inst.add_interface(ifname, cfg, addr, host, stub=stub,
                                   stub_default_cost=stub_cost, nssa=nssa)
                self.loop.send(inst.name, IfUpMsg(ifname))
            # area-type reconfig on an existing area (no new interfaces):
            aid = IPv4Address(area_id)
            if aid in inst.areas and (
                inst.areas[aid].stub != stub or inst.areas[aid].nssa != nssa
            ):
                inst.set_area_type(aid, stub=stub, nssa=nssa)
        # Auth is change-driven on running circuits too: an inline key
        # change must re-key immediately, not only on keychain events
        # (_last_tree is set before the apply chain runs).
        self._refresh_ospf_auth()
        if redist_changed:
            self._reconcile_redistribution(inst)

    @staticmethod
    def _frr_config(frr_conf):
        """ietf fast-reroute container -> FrrConfig (None = disabled).

        Shape:
          fast-reroute: {lfa: true, remote-lfa: bool, ti-lfa: bool,
                         engine: scalar|tpu}

        ``engine tpu`` is the port's batched engine, ``FrrEngine("torch")``.
        """
        if not frr_conf:
            return None
        engine = frr_conf.get("engine", "scalar")
        return FrrConfig(
            enabled=bool(frr_conf.get("lfa", True)),
            remote_lfa=bool(frr_conf.get("remote-lfa", False)),
            ti_lfa=bool(frr_conf.get("ti-lfa", False)),
            engine="torch" if engine == "tpu" else engine,
        )

    def _reconcile_redistribution(self, inst) -> None:
        """Replay the RIB against a changed redistribute set: inject
        now-wanted active routes, withdraw no-longer-wanted type-5s."""
        from holo_tpu_torch.utils.southbound import Protocol

        wanted = self._ospf_redistribute
        active = self.rib.active_routes()
        backed: set = set()
        for prefix, routemsg in active.items():
            if prefix.version != 4:
                continue
            if (
                routemsg.protocol.value in wanted
                and routemsg.protocol != Protocol.OSPFV2
            ):
                backed.add(prefix)
                inst.redistribute(prefix, metric=max(routemsg.metric, 1))
        for prefix in list(inst.redistributed.keys()):
            if prefix not in backed:
                inst.withdraw_redistributed(prefix)

    def _ospf_auth(self, auth_conf):
        """Build an AuthCtx from interface auth config, resolving keychain
        references through the keychain provider (holo-keychain analog).

        FAIL-CLOSED: an unresolvable keychain reference yields a deny-all
        context (random key nobody shares) — never an unauthenticated
        interface.  The reference likewise drops packets when the key
        cannot be resolved.
        """
        import os as _os

        from holo_tpu_torch.protocols.ospf.packet import AuthCtx, AuthType

        if not auth_conf:
            return None
        kc_name = auth_conf.get("key-chain")
        if kc_name:
            # Lifetime-based selection (keychain.rs:42-92): the active
            # SEND key signs, received key ids validate against their
            # ACCEPT lifetimes — rollover works.
            resolved = self._resolve_keychain(kc_name)
            if resolved is not None:
                return AuthCtx(
                    AuthType.CRYPTOGRAPHIC,
                    keychain=resolved,
                    clock=lambda: self.loop.clock.now(),
                )
            return AuthCtx(AuthType.CRYPTOGRAPHIC, _os.urandom(16), key_id=0)
        atype = auth_conf.get("type", "none")
        key = (auth_conf.get("key") or "").encode()
        if atype == "simple":
            return AuthCtx(AuthType.SIMPLE, key)
        if atype == "md5":
            return AuthCtx(AuthType.CRYPTOGRAPHIC, key, key_id=1)
        return None


    def _resolve_keychain(self, name):
        """Keychain object from the provider store, or None when the
        reference is unknown/empty (callers FAIL CLOSED).  Shared by the
        OSPF and IS-IS auth builders so keychain-resolution semantics
        cannot drift between protocols."""
        from holo_tpu_torch.utils.keychain import Keychain

        kc = (
            self.keychains.keychains.get(name)
            if self.keychains is not None
            else None
        )
        if kc and kc.get("key"):
            return Keychain.from_config(name, kc)
        return None



    def _apply_static(self, new):
        from holo_tpu_torch.utils.southbound import (
            Nexthop,
            Protocol,
            RouteKeyMsg,
            RouteMsg,
        )

        routes = new.get(
            "routing/control-plane-protocols/static-routes/route", {}
        ) or {}
        # Withdraw statics removed from config.
        new_prefixes = {r.get("prefix") for r in routes.values()}
        for prefix in getattr(self, "_static_prefixes", set()) - new_prefixes:
            self.rib.route_del(RouteKeyMsg(Protocol.STATIC, prefix))
        self._static_prefixes = {p for p in new_prefixes if p is not None}
        for _key, r in routes.items():
            prefix = r.get("prefix")
            if prefix is None:
                continue
            nhs = set()
            if r.get("next-hop") is not None:
                nhs.add(Nexthop(addr=r["next-hop"], ifname=r.get("interface")))
            elif r.get("interface"):
                nhs.add(Nexthop(ifname=r["interface"]))
            self.rib.route_add(
                RouteMsg(
                    protocol=Protocol.STATIC,
                    prefix=prefix,
                    distance=1,
                    metric=r.get("metric", 0),
                    nexthops=frozenset(nhs),
                )
            )

    def get_state(self, path=None):
        rib = {
            str(prefix): {
                "protocol": msg.protocol.value,
                "distance": msg.distance,
                "metric": msg.metric,
                "next-hops": sorted(
                    f"{nh.ifname or ''}:{nh.addr or ''}" for nh in msg.nexthops
                ),
            }
            for prefix, msg in self.rib.active_routes().items()
        }
        state = {"routing": {"rib": rib}}
        ospf = self.instances.get("ospfv2")
        if ospf is not None:
            now = self.loop.clock.now() if self.loop else 0.0

            def _lsdb_state(a):
                out = []
                for e in a.lsdb.all():
                    lsa = e.lsa
                    out.append(
                        {
                            "type": int(lsa.type),
                            "lsa-id": str(lsa.lsid),
                            "adv-router": str(lsa.adv_rtr),
                            "seq-num": lsa.seq_no & 0xFFFFFFFF,
                            "age": int(e.current_age(now)),
                            "length": lsa.length,
                        }
                    )
                return out

            state["routing"]["ospfv2"] = {
                "router-id": str(ospf.config.router_id),
                "spf-run-count": ospf.spf_run_count,
                "spf-log": list(ospf.spf_log),
                "is-abr": ospf.is_abr,
                "areas": {
                    str(aid): {
                        "area-type": (
                            "nssa" if a.nssa
                            else "stub" if a.stub
                            else "normal"
                        ),
                        "lsdb-count": len(a.lsdb.entries),
                        "database": _lsdb_state(a),
                        "interfaces": {
                            i.name: {
                                "state": i.state.name.lower(),
                                "type": i.config.if_type.name.lower(),
                                "cost": i.config.cost,
                                "hello-interval": (
                                    i.config.hello_interval
                                ),
                                "dead-interval": i.config.dead_interval,
                                "passive": i.config.passive,
                                "dr": str(i.dr),
                                "bdr": str(i.bdr),
                                "neighbor-count": len(i.neighbors),
                            }
                            for i in a.interfaces.values()
                        },
                    }
                    for aid, a in ospf.areas.items()
                },
                "neighbors": {
                    str(n.router_id): {
                        "state": n.state.name.lower(),
                        "iface": i.name,
                        "address": str(n.src),
                        "dr": str(n.dr),
                        "bdr": str(n.bdr),
                        "priority": n.priority,
                    }
                    for a in ospf.areas.values()
                    for i in a.interfaces.values()
                    for n in i.neighbors.values()
                },
                "local-rib": {
                    str(prefix): {
                        "metric": r.dist,
                        "route-type": getattr(r, "route_type", ""),
                        "next-hops": sorted(
                            f"{nh.ifname or ''}:{nh.addr or ''}"
                            for nh in r.nexthops
                        ),
                    }
                    for prefix, r in ospf.routes.items()
                },
                "sr-labels": {
                    str(prefix): label
                    for prefix, (label, _r) in getattr(
                        ospf, "sr_labels", {}
                    ).items()
                },
            }
            # YANG-modeled ietf-ospf tree (same renderer the conformance
            # harness diffs against the reference's recorded plane).
            try:
                from holo_tpu_torch.protocols.ospf.nb_state import instance_state

                state["routing"]["ietf-ospf:ospf"] = instance_state(ospf)
            except Exception:  # noqa: BLE001 — ad-hoc state must survive
                log.exception("ietf-ospf state render failed")
        return state
