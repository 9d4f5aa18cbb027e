"""RIB manager actor: per-prefix multi-protocol routes, best selection,
redistribution, next-hop tracking, and FIB programming.

Reference: holo-routing/src/rib.rs (admin-distance selection :318-420,
NHT :64,290, redistribution :71) and netlink.rs (kernel programming).
The kernel interface is pluggable: ``MockKernel`` records programmed
routes for tests; ``NetlinkKernel`` (daemon-only) talks rtnetlink.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, NamedTuple

from holo_tpu_torch import telemetry
from holo_tpu_torch.telemetry import convergence
from holo_tpu_torch.utils.ibus import (
    TOPIC_BFD_STATE,
    TOPIC_INTERFACE_DEL,
    TOPIC_INTERFACE_UPD,
    TOPIC_NHT_UPD,
    TOPIC_REDISTRIBUTE_ADD,
    TOPIC_REDISTRIBUTE_DEL,
    TOPIC_ROUTE_ADD,
    TOPIC_ROUTE_DEL,
    BfdStateUpd,
    Ibus,
    IbusMsg,
)
from holo_tpu_torch.utils.ip import IpNetwork
from holo_tpu_torch.utils.runtime import Actor
from holo_tpu_torch.utils.southbound import (
    LabelInstallMsg,
    LabelUninstallMsg,
    DEFAULT_DISTANCE,
    InterfaceUpdMsg,
    Nexthop,
    Protocol,
    RouteKeyMsg,
    RouteMsg,
)


# RIB churn observability: route add/replace/withdraw rates are the
# protocol-visible convergence signal; backup flips/restores count the
# IP-FRR local-repair moments (each one is a dataplane-affecting event).
_RIB_OPS = telemetry.counter(
    "holo_rib_route_ops_total", "RIB route operations", ("op",)
)
_RIB_INSTALLS = telemetry.counter(
    "holo_rib_kernel_installs_total", "Kernel FIB install/uninstall calls", ("op",)
)
_RIB_FLIPS = telemetry.counter(
    "holo_rib_backup_flips_total",
    "Prefixes flipped to precomputed FRR backups by local repair",
)
_RIB_RESTORES = telemetry.counter(
    "holo_rib_backup_restores_total",
    "Repaired prefixes unwound after a failure event recovered",
)
_RIB_PREFIXES = telemetry.gauge(
    "holo_rib_prefixes", "Prefixes currently present in the RIB"
)
_RIB_MICROLOOP = telemetry.counter(
    "holo_rib_microloop_delays_total",
    "Reconvergence installs delayed by the RFC 8333 microloop-avoidance "
    "window (the repair path kept meanwhile)",
)


class _Repair(NamedTuple):
    """An active IP-FRR local repair: the original best RouteMsg and the
    outstanding ``(ifname, addr)`` failure events applied to it."""

    msg: RouteMsg
    events: tuple


class Kernel:
    """FIB programming interface (netlink.rs equivalent)."""

    def install(
        self,
        prefix: IpNetwork,
        nexthops: frozenset[Nexthop],
        proto: Protocol,
        backups: dict | None = None,
        weights: dict | None = None,
    ) -> None:
        """Program ``prefix``.  ``backups`` (primary → loop-free backup
        next hop) ride along so the fast-reroute flip is a single
        replace from state the FIB layer already holds.  ``weights``
        ({next hop → UCMP weight}) program a weighted
        next-hop group; None/empty = equal-cost hashing."""
        raise NotImplementedError

    def uninstall(self, prefix: IpNetwork) -> None:
        raise NotImplementedError

    def install_label(self, in_label: int, nexthops) -> None:
        """LFIB entry: in-label -> swap (nexthop .labels) or pop."""

    def uninstall_label(self, in_label: int) -> None:
        pass

    def purge_stale(self) -> None:
        """Remove leftover routes from a previous run (netlink.rs:177)."""


class MockKernel(Kernel):
    def __init__(self) -> None:
        self.fib: dict[IpNetwork, tuple[frozenset[Nexthop], Protocol]] = {}
        self.backups: dict[IpNetwork, dict] = {}  # prefix -> primary->backup
        self.weights: dict[IpNetwork, dict] = {}  # prefix -> nh->weight
        self.lfib: dict[int, frozenset[Nexthop]] = {}  # in-label -> nexthops
        self.log: list[tuple[str, IpNetwork]] = []

    def install(self, prefix, nexthops, proto, backups=None, weights=None):
        # Cumulative multipath surface (storm/bench assertions must not
        # depend on whether the run ENDS mid-failure with repairs
        # holding single-survivor sets).
        if len(nexthops) > 1:
            self.multipath_installs = getattr(self, "multipath_installs", 0) + 1
        if weights:
            self.weighted_installs = getattr(self, "weighted_installs", 0) + 1
        self.fib[prefix] = (nexthops, proto)
        if backups:
            self.backups[prefix] = dict(backups)
        else:
            self.backups.pop(prefix, None)
        if weights:
            self.weights[prefix] = dict(weights)
        else:
            self.weights.pop(prefix, None)
        self.log.append(("install", prefix))

    def uninstall(self, prefix):
        self.fib.pop(prefix, None)
        self.backups.pop(prefix, None)
        self.weights.pop(prefix, None)
        self.log.append(("uninstall", prefix))

    def install_label(self, in_label, nexthops):
        self.lfib[in_label] = nexthops
        self.log.append(("install-label", in_label))

    def uninstall_label(self, in_label):
        self.lfib.pop(in_label, None)
        self.log.append(("uninstall-label", in_label))

    def purge_stale(self):
        self.fib.clear()
        self.backups.clear()
        self.lfib.clear()


@dataclass
class MicroloopFlipMsg:
    """Timer message ending a prefix's RFC 8333 microloop-avoidance
    window: the delayed post-reconvergence install happens now."""

    prefix: object


@dataclass
class NhtUpd:
    """Next-hop tracking update: resolvability of a tracked address."""

    addr: object
    reachable: bool
    # Longest-prefix route currently resolving the address (or None).
    via_prefix: object = None
    metric: int = 0


@dataclass
class NhtRegister:
    addr: object
    sender: str = ""


@dataclass
class NhtUnregister:
    addr: object
    sender: str = ""


@dataclass
class RibEntry:
    msg: RouteMsg
    active: bool = False


@dataclass
class _PrefixRoutes:
    # protocol -> entry; best = lowest (distance, metric).
    entries: dict[Protocol, RibEntry] = field(default_factory=dict)

    def best(self) -> RibEntry | None:
        cands = sorted(
            self.entries.values(),
            key=lambda e: (e.msg.distance, e.msg.metric, e.msg.protocol.value),
        )
        return cands[0] if cands else None


class RibManager(Actor):
    """The holo-routing master equivalent: serves route install requests
    over the ibus, runs best-route selection, programs the kernel, and
    republishes redistribution + next-hop-tracking updates."""

    name = "routing"

    def __init__(
        self,
        ibus: Ibus,
        kernel: Kernel | None = None,
        microloop_delay: float = 0.0,
    ):
        """``microloop_delay`` > 0 arms RFC 8333 microloop avoidance:
        a reconvergence install that would replace an ACTIVE fast-
        reroute repair is delayed by that many seconds (the repair —
        already loop-free by construction — keeps forwarding), so this
        router does not flip to the new primaries while upstream
        routers still forward on pre-convergence state.  0 (default)
        installs immediately — the historical behavior."""
        self.ibus = ibus
        self.kernel = kernel or MockKernel()
        self.microloop_delay = float(microloop_delay)
        # prefix -> pending delayed RouteMsg + its window timer.
        self._microloop_pending: dict = {}
        self._microloop_timers: dict = {}
        self.routes: dict[IpNetwork, _PrefixRoutes] = {}
        self.mpls: dict[int, LabelInstallMsg] = {}  # in-label -> LFIB entry
        # Invoked after any route table change (the provider uses it to
        # keep LDP FECs and LFIB entries in sync with the RIB).
        self.on_change: Callable | None = None
        self._programmed: set[IpNetwork] = set()  # prefixes in the kernel FIB
        # Next-hop tracking: addr -> (last NhtUpd, subscriber names).
        self._nht: dict = {}
        # IP-FRR local repair: prefix -> (original RouteMsg, outstanding
        # failure events).  A repair is cleared only when the winning
        # entry for the prefix actually changes (reconvergence
        # republishes it) or every failure event is restored — an
        # unrelated protocol's add/del must not reinstall the dead
        # primaries.  Membership (`in`) is the e2e-visible surface.
        self.repaired: dict[IpNetwork, _Repair] = {}
        # (protocol, af) redistribution subscriptions handled via ibus topics.
        self.kernel.purge_stale()

    # -- actor

    def attach(self, loop_) -> None:
        super().attach(loop_)
        # Fast-failure triggers for the FRR flip (reference: holo-routing
        # consumes the same ibus feeds): BFD session state and interface
        # operational state.
        self.ibus.subscribe(TOPIC_BFD_STATE, self.name)
        self.ibus.subscribe(TOPIC_INTERFACE_UPD, self.name)
        self.ibus.subscribe(TOPIC_INTERFACE_DEL, self.name)

    def handle(self, msg) -> None:
        if isinstance(msg, MicroloopFlipMsg):
            self._microloop_fire(msg.prefix)
            return
        if isinstance(msg, IbusMsg):
            if msg.topic == TOPIC_BFD_STATE:
                upd = msg.payload
                if isinstance(upd, BfdStateUpd) and upd.key:
                    flip = (
                        self.local_repair
                        if upd.state == "down"
                        else self.local_restore
                    )
                    if upd.key[0] == "mh":
                        flip(None, addr=upd.key[2])
                    else:
                        flip(upd.key[0], addr=upd.key[1])
                return
            if msg.topic == TOPIC_INTERFACE_UPD:
                upd = msg.payload
                if isinstance(upd, InterfaceUpdMsg):
                    if not upd.operative:
                        self.local_repair(upd.ifname)
                    else:
                        self.local_restore(upd.ifname)
                return
            if msg.topic == TOPIC_INTERFACE_DEL:
                if isinstance(msg.payload, str):
                    self.local_repair(msg.payload)
                return
            payload = msg.payload
            if isinstance(payload, RouteMsg):
                self.route_add(payload)
            elif isinstance(payload, RouteKeyMsg):
                self.route_del(payload)
            elif isinstance(payload, LabelInstallMsg):
                self.label_add(payload)
            elif isinstance(payload, LabelUninstallMsg):
                self.label_del(payload)
            elif isinstance(payload, NhtRegister):
                self.nht_register(payload.addr, payload.sender or msg.sender)
            elif isinstance(payload, NhtUnregister):
                self.nht_unregister(payload.addr, payload.sender or msg.sender)

    # -- IP fast reroute: O(1) flip to precomputed backups

    @staticmethod
    def _nh_failed(nh: Nexthop, ifname: str | None, addr) -> bool:
        if ifname is not None and nh.ifname == ifname:
            # Interface failure takes every next hop riding it (addr
            # narrows a BFD single-hop event to the session's neighbor).
            return addr is None or nh.addr == addr
        return addr is not None and nh.addr == addr

    def _hit_by(self, nh: Nexthop, events) -> bool:
        return any(self._nh_failed(nh, i, a) for i, a in events)

    def _repair_install(self, prefix, msg, events) -> bool:
        """Install ``msg``'s survivor set under ``events``: primaries
        not hit by any outstanding failure, plus each failed primary's
        precomputed backup when the backup itself is unhit.  False when
        nothing survives (caller leaves the FIB entry for reconvergence
        — pulling the route would blackhole sooner, not later)."""
        failed = {nh for nh in msg.nexthops if self._hit_by(nh, events)}
        survivors = set(msg.nexthops) - failed
        for nh in failed:
            backup = msg.backups.get(nh) if msg.backups else None
            if backup is not None and not self._hit_by(backup, events):
                survivors.add(backup)
        if not survivors:
            return False
        self.kernel.install(prefix, frozenset(survivors), msg.protocol)
        _RIB_INSTALLS.labels(op="repair").inc()
        return True

    def local_repair(self, ifname: str | None, addr=None) -> int:
        """Flip programmed routes whose next hops ride the failed
        interface/neighbor onto their precomputed loop-free backups.

        This is the IP-FRR local-repair moment (reference: TI-LFA's
        whole point): no SPF, no route recomputation — one kernel
        replace per affected prefix, using backup next hops the
        protocols attached at the last convergence.  Failure events
        accumulate, so a second failure re-repairs an already-repaired
        prefix.  Reconvergence republishes the prefix and ``_reselect``
        clears the repair; :meth:`local_restore` unwinds events that
        recover first.  Returns the number of prefixes flipped."""
        event = (ifname, addr)
        flipped = 0
        for prefix, pr in self.routes.items():
            if prefix not in self._programmed:
                continue
            best = pr.best()
            if best is None or not best.msg.nexthops:
                continue
            msg = best.msg
            rec = self.repaired.get(prefix)
            if rec is not None and event in rec.events:
                continue
            # Only act when the event hits a primary or an in-use backup.
            if not any(
                self._nh_failed(nh, ifname, addr) for nh in msg.nexthops
            ) and not (
                msg.backups
                and any(
                    self._nh_failed(b, ifname, addr)
                    for b in msg.backups.values()
                )
            ):
                continue
            events = ((*rec.events, event) if rec else (event,))
            if not self._repair_install(prefix, msg, events):
                continue
            self.repaired[prefix] = _Repair(msg, events)
            flipped += 1
        if flipped:
            _RIB_FLIPS.inc(flipped)
            # The backup flip IS the FIB moment for a BFD/carrier event:
            # the causal context rode in on the IbusMsg envelope.  The
            # rib phase is observed at the same moment: a
            # repair event then decomposes into rib (the O(1) flip
            # computation, begin→here) vs fib_commit in the
            # critical-path ledger instead of one undifferentiated lump.
            convergence.observe(convergence.PHASE_RIB, op="repair")
            convergence.fib_commit(op="repair", flips=flipped)
        return flipped

    def local_restore(self, ifname: str | None, addr=None) -> int:
        """Clear a recovered failure event from active local repairs:
        reinstall the original next-hop set once every event is gone, or
        the recomputed survivor set while other failures are still
        outstanding.

        The counterpart of :meth:`local_repair` for failures that clear
        before the owning protocol republishes the prefix (a carrier
        flap inside hold timers, a BFD session recovering) — without it
        a static/ECMP route would stay degraded forever.  ``_reselect``
        clears ``repaired`` whenever the winning entry changes, so the
        stored message is still the prefix's best."""
        event = (ifname, addr)
        restored = 0
        for prefix, rec in list(self.repaired.items()):
            if event not in rec.events:
                continue
            events = tuple(e for e in rec.events if e != event)
            if not events:
                self.kernel.install(
                    prefix,
                    rec.msg.nexthops,
                    rec.msg.protocol,
                    backups=rec.msg.backups or None,
                    weights=getattr(rec.msg, "nh_weights", None) or None,
                )
                del self.repaired[prefix]
            elif self._repair_install(prefix, rec.msg, events):
                self.repaired[prefix] = _Repair(rec.msg, events)
            restored += 1
        if restored:
            _RIB_RESTORES.inc(restored)
            # Same split as local_repair: rib = the restore scan,
            # fib_commit = the closing reinstall moment.
            convergence.observe(convergence.PHASE_RIB, op="restore")
            convergence.fib_commit(op="restore", restores=restored)
        return restored

    # -- RFC 8333 microloop avoidance (delayed post-reconvergence flip)

    def _microloop_clear(self, prefix) -> None:
        self._microloop_pending.pop(prefix, None)
        t = self._microloop_timers.pop(prefix, None)
        if t is not None:
            t.cancel()

    def _microloop_fire(self, prefix) -> None:
        """Window expiry: install the held reconvergence result — if it
        is still the prefix's winning entry (a later reselect replaces
        the pending message; a withdraw cancels the window)."""
        msg = self._microloop_pending.pop(prefix, None)
        self._microloop_timers.pop(prefix, None)
        if msg is None:
            return
        pr = self.routes.get(prefix)
        best = pr.best() if pr is not None else None
        if best is None or best.msg is not msg:
            return  # superseded since the window opened
        rec = self.repaired.get(prefix)
        if rec is not None and rec.msg is msg:
            # A NEW failure hit during the window: local_repair already
            # re-flipped against the held message's next hops and the
            # repair record now tracks it.  Installing the raw primary
            # set here would put the just-failed next hop back in the
            # FIB — keep the repair; reconvergence for the new failure
            # republishes the prefix and clears it the normal way.
            return
        self.repaired.pop(prefix, None)
        self.kernel.install(
            prefix,
            msg.nexthops,
            msg.protocol,
            backups=msg.backups or None,
            weights=msg.nh_weights or None,
        )
        _RIB_INSTALLS.labels(op="install").inc()
        self._programmed.add(prefix)
        convergence.fib_commit(op="install", microloop="delayed")

    # -- next-hop tracking (reference rib.rs:64,290)

    def nht_register(self, addr, sender: str = "") -> None:
        """Track resolvability of an address for ``sender``; publishes an
        immediate NhtUpd and further ones on every change.  Tracking is
        refcounted PER SUBSCRIBER (a sender registering twice must
        unregister twice — two BGP peers sharing a next hop)."""
        entry = self._nht.get(addr)
        if entry is None:
            state = self._resolve_nht(addr)
            self._nht[addr] = (state, {sender: 1})
        else:
            entry[1][sender] = entry[1].get(sender, 0) + 1
            state = entry[0]
        self.ibus.publish(TOPIC_NHT_UPD, state)

    def nht_unregister(self, addr, sender: str = "") -> None:
        entry = self._nht.get(addr)
        if entry is None:
            return
        refs = entry[1]
        if sender in refs:
            refs[sender] -= 1
            if refs[sender] <= 0:
                del refs[sender]
        if not refs:
            del self._nht[addr]

    def _resolve_nht(self, addr) -> NhtUpd:
        from holo_tpu_torch.utils.ip import prefix_contains

        best = None
        for prefix, pr in self.routes.items():
            if not prefix_contains(prefix, addr):
                continue
            e = pr.best()
            if e is None:
                continue
            if best is None or prefix.prefixlen > best[0].prefixlen:
                best = (prefix, e)
        if best is None:
            return NhtUpd(addr, False)
        return NhtUpd(addr, True, best[0], best[1].msg.metric)

    def _nht_reeval(self, changed_prefix) -> None:
        """Re-resolve only addresses the changed prefix can affect: those
        it covers, or whose current resolution rode it."""
        from holo_tpu_torch.utils.ip import prefix_contains

        for addr, (old, subs) in list(self._nht.items()):
            if not (
                prefix_contains(changed_prefix, addr)
                or old.via_prefix == changed_prefix
            ):
                continue
            new = self._resolve_nht(addr)
            if (new.reachable, new.via_prefix, new.metric) != (
                old.reachable, old.via_prefix, old.metric
            ):
                self._nht[addr] = (new, subs)
                self.ibus.publish(TOPIC_NHT_UPD, new)

    # -- RIB operations (also callable directly by the daemon)

    def route_add(self, msg: RouteMsg) -> None:
        pr = self.routes.setdefault(msg.prefix, _PrefixRoutes())
        _RIB_OPS.labels(
            op="replace" if msg.protocol in pr.entries else "add"
        ).inc()
        convergence.observe(convergence.PHASE_RIB, op="add")
        pr.entries[msg.protocol] = RibEntry(msg)
        self._reselect(msg.prefix)
        self._nht_reeval(msg.prefix)
        _RIB_PREFIXES.set(len(self.routes))

    def label_add(self, msg: LabelInstallMsg) -> None:
        """LFIB programming: the protocol's (LDP/SR) label binding joined
        with its next hops (reference rib.rs:152-212 -> netlink MPLS).
        Identical re-installs are elided (convergence churn)."""
        cur = self.mpls.get(msg.label)
        if cur is not None and cur.nexthops == msg.nexthops:
            self.mpls[msg.label] = msg
            return
        self.mpls[msg.label] = msg
        self.kernel.install_label(msg.label, msg.nexthops)

    def label_del(self, msg: LabelUninstallMsg) -> None:
        if self.mpls.pop(msg.label, None) is not None:
            self.kernel.uninstall_label(msg.label)

    def route_del(self, msg: RouteKeyMsg) -> None:
        pr = self.routes.get(msg.prefix)
        if pr is None:
            return
        if msg.protocol in pr.entries:
            _RIB_OPS.labels(op="withdraw").inc()
            convergence.observe(convergence.PHASE_RIB, op="withdraw")
        pr.entries.pop(msg.protocol, None)
        _RIB_PREFIXES.set(
            len(self.routes) - (0 if pr.entries else 1)
        )
        if not pr.entries:
            del self.routes[msg.prefix]
            self.repaired.pop(msg.prefix, None)
            self._microloop_clear(msg.prefix)
            if msg.prefix in self._programmed:
                self.kernel.uninstall(msg.prefix)
                _RIB_INSTALLS.labels(op="uninstall").inc()
                self._programmed.discard(msg.prefix)
                convergence.fib_commit(op="uninstall")
            self.ibus.publish(
                TOPIC_REDISTRIBUTE_DEL, RouteKeyMsg(msg.protocol, msg.prefix)
            )
            self._nht_reeval(msg.prefix)
            if self.on_change is not None:
                self.on_change()
            return
        self._reselect(msg.prefix)
        self._nht_reeval(msg.prefix)

    def _reselect(self, prefix: IpNetwork) -> None:
        pr = self.routes[prefix]
        best = pr.best()
        for e in pr.entries.values():
            e.active = e is best
        if best is not None:
            # Connected/local routes (empty next-hop set) are not programmed
            # — the kernel already has them from the interface address.  If
            # the prefix was previously programmed with next hops, withdraw
            # the stale kernel entry.
            if best.msg.nexthops:
                rec = self.repaired.get(prefix)
                if rec is not None and rec.msg is best.msg:
                    # The winning entry is untouched since the FRR flip
                    # (this reselect was driven by some OTHER protocol's
                    # add/del for the prefix): reinstalling its primaries
                    # would revert the repair onto the dead next hop.
                    # Keep the repair until the owner republishes — but
                    # ONLY the kernel install is skipped: the
                    # redistribute publish and on_change below still
                    # fire, like every other reselect.
                    pass
                elif (
                    rec is not None
                    and self.microloop_delay > 0
                    and getattr(self, "loop", None) is not None
                ):
                    # RFC 8333 microloop avoidance: the protocol HAS
                    # reconverged, but flipping off the (loop-free)
                    # repair immediately risks transient microloops
                    # while neighbors still run pre-convergence state.
                    # Hold the repair, install after the window.
                    self._microloop_pending[prefix] = best.msg
                    t = self._microloop_timers.get(prefix)
                    if t is None:
                        t = self.loop.timer(
                            self.name,
                            lambda p=prefix: MicroloopFlipMsg(p),
                        )
                        self._microloop_timers[prefix] = t
                    t.start(self.microloop_delay)
                    _RIB_MICROLOOP.inc()
                else:
                    # A reinstall replaces any active FRR local repair:
                    # the protocol has reconverged (or re-published)
                    # this prefix.
                    self.repaired.pop(prefix, None)
                    self._microloop_clear(prefix)
                    self.kernel.install(
                        prefix,
                        best.msg.nexthops,
                        best.msg.protocol,
                        backups=best.msg.backups or None,
                        weights=best.msg.nh_weights or None,
                    )
                    _RIB_INSTALLS.labels(op="install").inc()
                    self._programmed.add(prefix)
                    # Event-to-FIB: the kernel now reflects the change
                    # this causal event started (first install closes
                    # the event; later installs for the same event are
                    # the same virtual instant under the loop clock).
                    convergence.fib_commit(op="install")
            elif prefix in self._programmed:
                # The withdrawn entry takes any active local repair with
                # it — a later restore must not resurrect the route.
                self.repaired.pop(prefix, None)
                self._microloop_clear(prefix)
                self.kernel.uninstall(prefix)
                _RIB_INSTALLS.labels(op="uninstall").inc()
                self._programmed.discard(prefix)
                convergence.fib_commit(op="uninstall")
            self.ibus.publish(TOPIC_REDISTRIBUTE_ADD, best.msg)
        if self.on_change is not None:
            self.on_change()

    # -- queries

    def active_routes(self) -> dict[IpNetwork, RouteMsg]:
        out = {}
        for prefix, pr in self.routes.items():
            b = pr.best()
            if b is not None:
                out[prefix] = b.msg
        return out


def default_distance(proto: Protocol) -> int:
    return DEFAULT_DISTANCE.get(proto, 250)
