"""OSPFv2 instance actor: event dispatch, adjacency, flooding, SPF, routes.

Reference anatomy: holo-ospf/src/instance.rs (root state machine),
events.rs (packet handlers), flood.rs (flooding), spf.rs (delay FSM).
One actor per instance on the shared event loop; all IO via NetIo; all
timers via loop timers (virtual-clock testable).

Implemented here: multi-area ABR (type-3/4), AS externals (type-5) with
redistribution, stub + NSSA areas (RFC 3101, elected translator), virtual
links, keyed-MD5/HMAC auth with keychains and restart-safe seqno
reservation (persisted ceiling; replaces the reference's boot-count seed),
graceful restart (RFC 3623, both sides), RFC 8405 SPF delay FSM.
Simplifications: DD packets carry up to DD_CHUNK headers (MTU pagination
simplified); MaxAge LSAs are removed once flooded with empty
retransmission lists.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from ipaddress import IPv4Address, IPv4Network

from holo_tpu_torch import telemetry
from holo_tpu_torch.protocols.ospf.interface import (
    ElectionView,
    IfConfig,
    IfType,
    IsmState,
    OspfInterface,
    elect_dr_bdr,
)

# Protocol observability shared by OSPFv2 and OSPFv3 (the v3 instance
# imports these families): NSM transitions, wire rx/tx/retransmit
# rates, and SPF runs.  Labels stay low-cardinality (instance name +
# an 8-state enum / direction).
_OSPF_NBR_TRANSITIONS = telemetry.counter(
    "holo_ospf_nbr_transitions_total",
    "OSPF neighbor FSM state changes",
    ("instance", "to"),
)
_OSPF_PACKETS = telemetry.counter(
    "holo_ospf_packets_total", "OSPF packets", ("instance", "dir")
)
_OSPF_RX_BAD = telemetry.counter(
    "holo_ospf_rx_bad_total",
    "OSPF packets dropped in decode/auth",
    ("instance",),
)
_OSPF_RETRANSMITS = telemetry.counter(
    "holo_ospf_retransmits_total",
    "OSPF rxmt-timer firings that resent DD/request/update state",
    ("instance",),
)
_OSPF_SPF_RUNS = telemetry.counter(
    "holo_ospf_spf_runs_total", "SPF runs", ("instance", "type")
)
from holo_tpu_torch.protocols.ospf.lsdb import (
    MIN_LS_ARRIVAL,
    Lsdb,
    next_seq_no,
)
from holo_tpu_torch.protocols.ospf.neighbor import (
    Neighbor,
    NsmEvent,
    NsmState,
    nsm_transition,
)
from holo_tpu_torch.protocols.ospf.packet import (
    MAX_AGE,
    MAX_LINK_METRIC,
    AuthType,
    DbDesc,
    DbDescFlags,
    Hello,
    Lsa,
    LsaKey,
    LsaRouter,
    LsaNetwork,
    LsaType,
    LsAck,
    LsRequest,
    LsUpdate,
    Options,
    Packet,
    PacketType,
    RouterFlags,
    RouterLink,
    RouterLinkType,
)
from holo_tpu_torch.protocols.ospf.spf_run import (
    build_topology,
    derive_routes,
    link_spf_delta,
)
from holo_tpu_torch.spf.backend import ScalarSpfBackend, SpfBackend
from holo_tpu_torch.telemetry import convergence
from holo_tpu_torch.utils.ip import ALL_DR_RTRS_V4, ALL_SPF_RTRS_V4, mask_of
from holo_tpu_torch.utils.netio import NetIo, NetRxPacket
from holo_tpu_torch.utils.runtime import Actor

DD_CHUNK = 64  # LSA headers per DD packet
LSREQ_CHUNK = 64
AGE_TICK = 1.0


# ===== timer messages =====


@dataclass
class HelloTimerMsg:
    ifname: str


@dataclass
class WaitTimerMsg:
    ifname: str


@dataclass
class InactivityTimerMsg:
    ifname: str
    nbr_id: IPv4Address


@dataclass
class RxmtTimerMsg:
    ifname: str
    nbr_id: IPv4Address


@dataclass
class SpfDelayTimerMsg:
    pass


@dataclass
class SpfHoldDownMsg:
    pass


@dataclass
class GrRestartExpireMsg:
    pass


@dataclass
class FrrTablesReadyMsg:
    """Posted (cross-thread) by the pipeline worker's done-callback
    when every pending lazy backup table of an SPF run completed: the
    actor then attaches backups and republishes routes that gained
    them — the force never runs on the SPF critical path."""

    run: int = 0  # spf_run_count stamp (stale messages are harmless)


@dataclass
class AgeTickMsg:
    pass


@dataclass
class IfUpMsg:
    ifname: str


@dataclass
class IfDownMsg:
    ifname: str


# ===== SPF delay FSM (RFC 8405; reference holo-ospf/src/spf.rs:270-484) ==


class SpfFsmState(enum.Enum):
    QUIET = "quiet"
    SHORT_WAIT = "short-wait"
    LONG_WAIT = "long-wait"


@dataclass
class SpfTimers:
    initial_delay: float = 0.05
    short_delay: float = 0.2
    long_delay: float = 5.0
    hold_down: float = 10.0
    time_to_learn: float = 0.5


@dataclass
class InstanceConfig:
    router_id: IPv4Address = IPv4Address("0.0.0.0")
    spf: SpfTimers = field(default_factory=SpfTimers)
    sr: object = None  # an SR configuration (None = SR disabled; not ported)
    bier: object = None  # holo_tpu_torch.utils.bier.BierCfg (None = disabled)
    # Administrative distances for routes published to the RIB manager
    # (ietf-ospf preference hierarchy: specific type > internal > all).
    preference: int = 110
    preference_intra: int | None = None
    preference_inter: int | None = None
    preference_internal: int | None = None
    preference_external: int | None = None
    # RFC 3623 helper-mode capability (advertised in the RI LSA).
    gr_helper_enabled: bool = True
    # RFC 2328 §15 virtual links: (transit_area_id, peer_router_id)
    # pairs.  The vlink interface itself materializes when the peer
    # becomes reachable through the transit area (see
    # _sync_virtual_links); hello/dead intervals for vlink adjacencies.
    virtual_links: tuple = ()
    vlink_hello_interval: int = 10
    vlink_dead_interval: int = 60
    # IP fast reroute (holo_tpu_torch.frr.manager.FrrConfig; None = disabled): after
    # every full SPF one batched backup-table run per area precomputes
    # LFA/remote-LFA/TI-LFA repairs, attached to published routes.
    frr: object = None
    # ECMP width limit (ietf-ospf ``max-paths``): None = unlimited
    # (every equal-cost next hop installs, the historical behavior).
    # 2..8 arms the vectorized multipath dispatch: the SPF
    # runs with k-wide parent-set planes, routes carry UCMP weights,
    # and ECMP sets clamp to the highest-weight max-paths next hops.
    max_paths: int | None = None
    # Advisory what-if batching: > 0 enqueues that
    # many single-link-failure scenarios through the async pipeline
    # after every full SPF (coalesced/skipped by the pipeline; results
    # feed the whatif-advisory stats only, never the RIB).
    whatif_advisory: int = 0
    # RFC 6987 stub-router: advertise MaxLinkMetric (0xFFFF) on every
    # transit/p2p link so neighbors route around us while our own
    # adjacencies and stub prefixes stay reachable (maintenance mode).
    stub_router: bool = False
    # Interop knobs for replaying the reference's recorded exchanges
    # (tools/stepwise.py): seed DD seqnos like the reference's
    # 'deterministic' build, and override the §13(5a) arrival throttle
    # (frozen-clock replays carry no timestamps).
    deterministic_dd: bool = False
    min_ls_arrival: float = MIN_LS_ARRIVAL
    # Two-phase origination (reference lsdb.rs LsaOriginateEvent →
    # originate_check): triggers queue re-origination CHECKS; flushing
    # rebuilds each LSA from current state and skips unchanged content.
    # False (production): checks run immediately at the trigger site.
    # True (conformance replay): checks accumulate until the harness
    # flushes at the recorded LsaOrigCheck positions, reproducing the
    # reference's exact instance counts.
    external_orig_checks: bool = False


@dataclass
class Area:
    area_id: IPv4Address
    lsdb: Lsdb = field(default_factory=Lsdb)
    interfaces: dict[str, OspfInterface] = field(default_factory=dict)
    # RFC 2328 stub areas: no type-5 flooding; ABRs inject a default
    # summary with this cost instead.  RFC 3101 NSSA: no type-5s either,
    # but type-7s circulate inside and the elected ABR translates them.
    stub: bool = False
    nssa: bool = False
    stub_default_cost: int = 10  # holo-ietf-ospf-deviations.yang:61-66
    # Totally-stubby variant: ABRs inject only the default summary into
    # the (stub/NSSA) area, no per-prefix type-3s (RFC 2328 §12.4.3.1).
    summary: bool = True
    # RFC 2328 area address ranges: [{prefix, advertise, cost}] — intra
    # routes inside an active range are aggregated when summarized into
    # other areas.
    ranges: list = field(default_factory=list)

    @property
    def no_type5(self) -> bool:
        return self.stub or self.nssa


@dataclass
class ExternalRoute:
    """A route this ASBR redistributes into OSPF (→ type-5 LSA)."""

    prefix: IPv4Network
    metric: int = 20
    e2: bool = True  # type-2 external metric (default, like the reference)
    tag: int = 0


_PKT_TYPE_YANG = {
    PacketType.HELLO: "hello",
    PacketType.DB_DESC: "database-description",
    PacketType.LS_REQUEST: "link-state-request",
    PacketType.LS_UPDATE: "link-state-update",
    PacketType.LS_ACK: "link-state-ack",
}


# Sentinel: a queued origination check whose subject vanished between
# trigger and dequeue (area/interface removed) — dropped, never installed.
_CHECK_SKIP = object()


class OspfInstance(Actor):
    """One OSPFv2 routing process."""

    def __init__(
        self,
        name: str,
        config: InstanceConfig,
        netio: NetIo,
        spf_backend: SpfBackend | None = None,
        route_cb=None,
        nvstore=None,
        notif_cb=None,
    ):
        self.name = name
        self.config = config
        self.netio = netio
        # YANG notification sink: receives ietf-ospf notification dicts
        # (reference holo-ospf/src/northbound/notification.rs).
        self.notif_cb = notif_cb
        self.backend = spf_backend or ScalarSpfBackend()
        self.route_cb = route_cb  # callable(dict[prefix -> IntraRoute])
        self.areas: dict[IPv4Address, Area] = {}
        self._if_area: dict[str, IPv4Address] = {}
        self._timers: dict[tuple, object] = {}
        self._dd_seq = 0x1000  # deterministic DD seq seed
        self.hostname: str | None = None  # RFC 5642, advertised in RI LSA
        self.node_tags: tuple[int, ...] = ()  # RFC 7777, RI LSA TLV 10
        # Cryptographic-auth sequence numbers must be strictly higher after
        # a restart than anything a neighbor saw before it, or every packet
        # is dropped as a replay until the dead interval expires.  The
        # reference seeds from a persisted boot count
        # (holo-ospf/src/instance.rs:231,257-258 initial_auth_seqno).  We
        # persist a *reserved ceiling* instead: the store always holds a
        # seqno no packet has used yet, and tx extends the reservation in
        # 2^16-packet windows (one durable write per window), so restarts
        # always seed above every previously sent seqno regardless of
        # uptime.  Without a store (deterministic tests) the seed stays 0.
        self._nvstore = nvstore
        self._seqno_key = f"ospf/{name}/seqno-ceiling"
        self._grace_seqno_key = f"ospf/{name}/grace-seqno"
        self._crypto_reserved = 0
        if nvstore is not None:
            # Boot count is operational state only (exposed for debugging,
            # GR bookkeeping later); the seqno seed comes from the ceiling.
            nvstore.incr(f"ospf/{name}/boot-count")
            self._crypto_seq = int(nvstore.get(self._seqno_key, 0))
            self._reserve_seqnos()
        else:
            self._crypto_seq = 0

        # RFC 3623 restarting side: while True, self-LSA origination is
        # suppressed and pre-restart copies are adopted (not outpaced) so
        # helpers keep forwarding on the pre-restart topology.
        self.gr_restarting = False
        self._gr_grace_period = 120  # last announced/entered grace params
        self._gr_reason = 1
        # Admin state: False after a disable (operational state renders a
        # minimal tree, like the reference's torn-down Instance).
        self.enabled = True
        # SPF FSM state
        self.spf_state = SpfFsmState.QUIET
        self._spf_timer = None
        self._hold_timer = None
        self._spf_scheduled = False
        self._last_event_time: float | None = None
        self._first_full_run = False
        self._learn_deadline: float | None = None
        self.routes = {}
        self.spf_run_count = 0
        # SPF run log: ring of the last 32 runs with schedule/start/end
        # times and trigger counts (reference holo-ospf/src/spf.rs:33-36,
        # 770-804 — exposed via operational state).
        self.spf_log: list[dict] = []
        self._spf_scheduled_at: float | None = None
        self._spf_trigger_count = 0
        # Full-vs-partial trigger classification (reference
        # holo-ospf/src/spf.rs:49-60,513-516): LSAs that changed since the
        # last run accumulate here; non-LSA events (config, interface
        # state, clear) force a full run.  The cache holds the last full
        # run's products (per-area SPTs + derived route tables) so a
        # summary/external-only change recomputes scoped table entries
        # without re-running Dijkstra (route.rs:200-333).
        self._spf_triggers: list = []
        self._spf_force_full = True
        self._spf_cache: dict | None = None
        # DeltaPath: the previous full run's marshaled SpfTopology per
        # area — the diff base for incremental device-graph updates.
        self._spf_delta_bases: dict = {}
        # Hierarchical partition hint: router-id -> group
        # label, stamped onto Topology.partition_hint at marshal time
        # (spf_run.apply_partition_hint) so the partitioned-SPF path
        # cuts along operator-known structure instead of a flat BFS cut.
        self.spf_partition_of: dict | None = None
        # Convergence-observatory causal ids pending on the next SPF run
        # (bounded; stamped in _schedule_spf, drained by run_spf).
        self._conv_pending: list = []
        self.ibus = None  # set via attach_ibus for RIB integration
        self.routing_actor = "routing"
        # Externals we originate (type 5; stored in every area's LSDB with
        # install-time cross-area propagation = AS flooding scope).
        self.redistributed: dict[IPv4Network, ExternalRoute] = {}
        self._external_lsids: dict[IPv4Network, IPv4Address] = {}
        # Prefixes we currently translate type-7 -> type-5 for (RFC 3101
        # §3, elected NSSA ABR translator duty).
        self._nssa_translated: set[IPv4Network] = set()
        # Segment routing state (labels resolved after each SPF).
        self.sr_labels: dict = {}
        # IP-FRR backup tables (area_id -> BackupTable), refreshed by
        # every full SPF run; partial runs keep them (no topology change
        # by definition).  The engine persists for its shape-bucket
        # compile cache.
        self.frr_tables: dict = {}
        self._frr_engine = None
        # Deferred FRR-backup attach (pipelined
        # tables are forced on the worker, never on the SPF path) and
        # advisory what-if tickets + counters per area.
        self._frr_attach_deferred = False
        self._whatif_tickets: dict = {}
        self._whatif_stats: dict = {"enqueued": 0, "completed": 0}
        self.bier_routes: dict = {}
        # Shared opaque-id allocator for RFC 7684 extended-prefix LSAs:
        # keys are ("sr", prefix) and ("bier", sd_id); ids never reused.
        self._ext_prefix_opaque_ids: dict[tuple, int] = {}
        # Which interface each link-scope (type 9) LSA belongs to, for
        # per-interface operational-state grouping (state.rs link db).
        self._link_scope_iface: dict[LsaKey, str] = {}
        # Routers reachable per area in the last SPF (intra-area paths),
        # rid -> RouterFlags captured at SPF time: serves abr-count/
        # asbr-count (reference area.rs:164-182).
        self._area_reachable_routers: dict[IPv4Address, dict] = {}
        # Deferred origination checks (see InstanceConfig.external_orig_checks):
        # key -> kwargs, deduped so N triggers collapse into one rebuild at
        # the recorded check position (see _queue_check).
        self._pending_checks: dict[tuple, dict] = {}
        # Prefixes we've actually pushed to the RIB — tracked explicitly
        # because route objects can mutate between syncs, so inferring
        # "was installed" from snapshots is unreliable (see _sync_rib).
        self._installed_prefixes: set = set()

    _SEQNO_WINDOW = 1 << 16

    def _reserve_seqnos(self) -> None:
        """Durably reserve the next window of auth sequence numbers."""
        self._crypto_reserved = self._crypto_seq + self._SEQNO_WINDOW
        self._nvstore.put(self._seqno_key, self._crypto_reserved)

    def attach_ibus(
        self, ibus, routing_actor: str = "routing", bfd_actor: str = "bfd"
    ) -> None:
        """Wire route programming + BFD registration over the ibus."""
        self.ibus = ibus
        self.routing_actor = routing_actor
        self.bfd_actor = bfd_actor

    # ----- wiring helpers

    def attach(self, loop_):
        super().attach(loop_)
        self._age_timer = self.loop.timer(self.name, AgeTickMsg)
        self._age_timer.start(AGE_TICK)

    def add_interface(
        self,
        ifname: str,
        cfg: IfConfig,
        addr: IPv4Network,
        addr_ip: IPv4Address,
        stub: bool = False,
        stub_default_cost: int = 10,  # deviation holo-ietf-ospf-deviations.yang:61-66
        nssa: bool = False,
    ) -> OspfInterface:
        """Area type is part of area creation — the stub/NSSA flags must
        be set BEFORE any LSA origination touches the area."""
        assert not (stub and nssa), "area cannot be both stub and NSSA"
        new_area = cfg.area_id not in self.areas
        area = self.areas.setdefault(cfg.area_id, Area(cfg.area_id))
        if new_area:
            area.stub = stub
            area.nssa = nssa
            area.stub_default_cost = stub_default_cost
        elif area.stub != stub or area.nssa != nssa:
            self.set_area_type(cfg.area_id, stub=stub, nssa=nssa)
        iface = OspfInterface(
            name=ifname, config=cfg, addr_ip=addr_ip, prefix=addr
        )
        area.interfaces[ifname] = iface
        self._if_area[ifname] = cfg.area_id
        if new_area and self.redistributed:
            # AS-scope LSAs must exist in every (non-stub) area, incl.
            # late-attached ones.
            for prefix in list(self.redistributed):
                self._originate_external(prefix)
        if new_area:
            self._originate_router_info(area)
        return iface

    def _build_router_info(self, area: Area):
        """RFC 7770 Router-Information opaque LSA (one per area).

        Advertises the informational capabilities the instance actually
        has: GR helper (gr.rs) and stub-router support — real since
        ``set_stub_router`` implements the RFC 6987 max-metric behavior
        (reference holo-ospf originates the same pair at area start).
        Returns (lsid, body) for the deferred-check queue.
        """
        from holo_tpu_torch.protocols.ospf.packet import (
            RI_CAP_GR_HELPER,
            RI_CAP_STUB_ROUTER,
            LsaOpaque,
            encode_router_info,
            ri_lsid,
        )

        caps = RI_CAP_STUB_ROUTER
        if self.config.gr_helper_enabled:
            caps |= RI_CAP_GR_HELPER
        return (
            ri_lsid(),
            LsaOpaque(
                data=encode_router_info(caps, self.hostname, self.node_tags)
            ),
        )


    def set_stub_router(self, enabled: bool) -> None:
        """RFC 6987 stub-router (max-metric) maintenance mode: flip the
        leaf and re-originate every area's router-LSA with MaxLinkMetric
        on transit links (reference: the same leaf re-triggers
        lsa_orig_router)."""
        if enabled == self.config.stub_router:
            return
        self.config.stub_router = enabled
        for area in self.areas.values():
            self._originate_router_lsa(area)

    def set_node_tags(self, tags: tuple[int, ...]) -> None:
        """RFC 7777 node administrative tags (RI LSA, re-originated on
        change — reference NodeTagsChange event)."""
        if tuple(tags) == self.node_tags:
            return
        self.node_tags = tuple(tags)
        for area in self.areas.values():
            self._originate_router_info(area)

    def set_hostname(self, hostname: str | None) -> None:
        """RFC 5642 dynamic hostname: carried in the RI LSA, re-originated
        on change (reference: HostnameChange -> lsa_orig_router_info)."""
        if hostname == self.hostname:
            return
        self.hostname = hostname
        for area in self.areas.values():
            self._originate_router_info(area)

    def interface_address_add(self, ifname: str, prefix: IPv4Network) -> None:
        """Secondary subnet on a live interface: advertise it as a stub
        link (kernel address-add path, holo-interface ibus feed)."""
        ai = self._iface(ifname)
        if ai is None:
            return
        area, iface = ai
        if prefix == iface.prefix or prefix in iface.secondary:
            return
        iface.secondary.append(prefix)
        if iface.state != IsmState.DOWN:
            self._originate_router_lsa(area)

    def interface_address_del(self, ifname: str, prefix: IPv4Network) -> None:
        ai = self._iface(ifname)
        if ai is None:
            return
        area, iface = ai
        if prefix in iface.secondary:
            iface.secondary.remove(prefix)
            if iface.state != IsmState.DOWN:
                self._originate_router_lsa(area)

    def set_area_stub(self, area_id: IPv4Address, stub: bool) -> None:
        self.set_area_type(area_id, stub=stub)

    def set_area_type(
        self, area_id: IPv4Address, stub: bool = False, nssa: bool = False
    ) -> None:
        """Flip an area's type at runtime: purge now-forbidden LSAs and
        restart the area's adjacencies (the E/N option bits changed, so
        existing neighbors would reject our hellos anyway)."""
        assert not (stub and nssa), "area cannot be both stub and NSSA"
        area = self.areas.get(area_id)
        if area is None or (area.stub == stub and area.nssa == nssa):
            return
        was_nssa = area.nssa
        area.stub = stub
        area.nssa = nssa
        if was_nssa and not nssa:
            # Leaving NSSA: type-7s are meaningless outside one.
            for key in list(area.lsdb.entries):
                if key.type == LsaType.NSSA_EXTERNAL:
                    area.lsdb.remove(key)
        if area.no_type5:
            for key in list(area.lsdb.entries):
                if key.type == LsaType.AS_EXTERNAL:
                    area.lsdb.remove(key)
            if nssa and self.redistributed:
                for prefix in list(self.redistributed):
                    self._originate_external(prefix)  # as type-7 now
        else:
            if self.redistributed:
                for prefix in list(self.redistributed):
                    self._originate_external(prefix)
            # Foreign type-5s held in our other areas must reach the
            # newly-normal area too (AS scope).
            seen: dict = {}
            for other in self.areas.values():
                if other is area:
                    continue
                for key, e in other.lsdb.entries.items():
                    if key.type != LsaType.AS_EXTERNAL:
                        continue
                    cur = seen.get(key)
                    if cur is None or e.lsa.compare(cur) > 0:
                        seen[key] = e.lsa
            for lsa in seen.values():
                cur = area.lsdb.get(lsa.key)
                if cur is None or lsa.compare(cur.lsa) > 0:
                    self._install_and_flood(area, lsa)
        for ifname, iface in list(area.interfaces.items()):
            if iface.state != IsmState.DOWN:
                self.if_down(ifname)
                self.if_up(ifname)
        self._schedule_spf()

    def _iface(self, ifname: str) -> tuple[Area, OspfInterface] | None:
        aid = self._if_area.get(ifname)
        if aid is None:
            return None
        area = self.areas[aid]
        iface = area.interfaces.get(ifname)
        return None if iface is None else (area, iface)

    def _timer(self, key: tuple, msg_fn):
        t = self._timers.get(key)
        if t is None:
            t = self.loop.timer(self.name, msg_fn)
            self._timers[key] = t
        return t

    # ----- message dispatch

    def handle(self, msg) -> None:
        if isinstance(msg, NetRxPacket):
            self._rx_packet(msg)
        elif isinstance(msg, HelloTimerMsg):
            self._send_hello(msg.ifname)
        elif isinstance(msg, WaitTimerMsg):
            self._wait_timer(msg.ifname)
        elif isinstance(msg, InactivityTimerMsg):
            self._inactivity_expired(msg.ifname, msg.nbr_id)
        elif isinstance(msg, RxmtTimerMsg):
            self._rxmt(msg.ifname, msg.nbr_id)
        elif isinstance(msg, SpfDelayTimerMsg):
            self._spf_timer_fired()
        elif isinstance(msg, SpfHoldDownMsg):
            self._spf_holddown_fired()
        elif isinstance(msg, GrRestartExpireMsg):
            self._gr_restart_expired()
        elif isinstance(msg, FrrTablesReadyMsg):
            self._frr_tables_ready()
        elif isinstance(msg, AgeTickMsg):
            self._age_tick()
        elif isinstance(msg, IfUpMsg):
            self.if_up(msg.ifname)
        elif isinstance(msg, IfDownMsg):
            self.if_down(msg.ifname)
        else:
            self._rx_ibus(msg)

    def _rx_ibus(self, msg) -> None:
        """BFD fast failure: a Down state update kills the adjacency
        immediately (reference: SURVEY.md §3.5 BfdStateUpd path)."""
        from holo_tpu_torch.utils.ibus import TOPIC_BFD_STATE, BfdStateUpd, IbusMsg

        if not isinstance(msg, IbusMsg) or msg.topic != TOPIC_BFD_STATE:
            return
        upd = msg.payload
        if not isinstance(upd, BfdStateUpd) or upd.state != "down":
            return
        ifname, peer = upd.key
        ai = self._iface(ifname)
        if ai is None:
            return
        _, iface = ai
        for nbr_id, nbr in list(iface.neighbors.items()):
            if nbr.src == peer:
                self._nbr_event(ifname, nbr_id, NsmEvent.KILL_NBR)

    # ----- YANG notifications (reference northbound/notification.rs)

    def _notify(self, kind: str, data: dict) -> None:
        if self.notif_cb is not None:
            self.notif_cb({kind: data})

    def _notif_iface(self, iface: OspfInterface) -> dict:
        return {
            "routing-protocol-name": self.name,
            "address-family": "ipv4",
            "interface": {"interface": iface.name},
        }

    def _set_ism_state(self, iface: OspfInterface, new: IsmState) -> None:
        if iface.state == new:
            return
        iface.state = new
        from holo_tpu_torch.protocols.ospf.nb_state import _ISM_NAME

        self._notify(
            "ietf-ospf:if-state-change",
            self._notif_iface(iface) | {"state": _ISM_NAME[new]},
        )

    def _notify_if_config_error(
        self, iface: OspfInterface, src, pkt_type: str, error: str
    ) -> None:
        self._notify(
            "ietf-ospf:if-config-error",
            self._notif_iface(iface)
            | {
                "packet-source": str(src),
                "packet-type": pkt_type,
                "error": error,
            },
        )

    def gr_helper_enter(
        self, area: Area, iface: OspfInterface, nbr, grace_period: int
    ) -> None:
        self._notify(
            "ietf-ospf:nbr-restart-helper-status-change",
            self._notif_iface(iface)
            | {
                "neighbor-router-id": str(nbr.router_id),
                "neighbor-ip-addr": str(nbr.src),
                "status": "helping",
                "age": grace_period,
            },
        )

    def gr_helper_exit(
        self, area: Area, iface: OspfInterface, nbr, reason: str
    ) -> None:
        """End the helper window (gr.rs:166-203): notify, clear the GR
        state, and re-originate the segment's LSAs.  The adjacency itself
        is untouched — it only dies later on the inactivity timer."""
        nbr.gr_deadline = None
        self._notify(
            "ietf-ospf:nbr-restart-helper-status-change",
            self._notif_iface(iface)
            | {
                "neighbor-router-id": str(nbr.router_id),
                "neighbor-ip-addr": str(nbr.src),
                "status": "not-helping",
                "exit-reason": reason,
            },
        )
        self._originate_router_lsa(area)
        self._originate_network_lsa(area, iface)

    # ----- ISM

    def if_up(self, ifname: str) -> None:
        ai = self._iface(ifname)
        if ai is None:
            return
        area, iface = ai
        if iface.state != IsmState.DOWN:
            return
        if iface.config.loopback:
            self._set_ism_state(iface, IsmState.LOOPBACK)
            self._originate_router_lsa(area)
            return
        if iface.config.if_type == IfType.POINT_TO_POINT:
            self._set_ism_state(iface, IsmState.POINT_TO_POINT)
        else:
            self._set_ism_state(iface, IsmState.WAITING)
            self._timer(("wait", ifname), lambda: WaitTimerMsg(ifname)).start(
                iface.config.dead_interval
            )
        self._timer(("hello", ifname), lambda: HelloTimerMsg(ifname)).start(0.0)
        self._originate_router_lsa(area)

    def if_down(self, ifname: str) -> None:
        ai = self._iface(ifname)
        if ai is None:
            return
        area, iface = ai
        # No network-LSA flush here: the reference's interface stop only
        # resets state (interface.rs:391-437) — the MaxAge flood happens
        # solely on a DR change while the interface is still up.  The
        # stale network LSA is invalidated anyway once our router-LSA
        # stops listing the transit link.
        # Teardown kills neighbors without re-running DR election — the
        # reference's InterfaceDown FSM goes straight to Down; an interim
        # election here would emit a spurious if-state-change (e.g. "dr")
        # before the "down" notification.
        iface.going_down = True
        try:
            for nbr_id in list(iface.neighbors):
                self._nbr_event(ifname, nbr_id, NsmEvent.KILL_NBR)
        finally:
            iface.going_down = False
        self._set_ism_state(iface, IsmState.DOWN)
        iface.dr = IPv4Address(0)
        iface.bdr = IPv4Address(0)
        for key in ("hello", "wait"):
            t = self._timers.get((key, ifname))
            if t:
                t.cancel()
        self._originate_router_lsa(area)

    def _wait_timer(self, ifname: str) -> None:
        ai = self._iface(ifname)
        if ai and ai[1].state == IsmState.WAITING:
            self._run_dr_election(*ai)

    def _run_dr_election(self, area: Area, iface: OspfInterface) -> None:
        """§9.4 (run twice when our own role changes, per step 4)."""
        for _ in range(2):
            views = [
                ElectionView(
                    iface.config.priority,
                    self.config.router_id,
                    iface.addr_ip,
                    iface.dr,
                    iface.bdr,
                )
            ]
            for nbr in iface.neighbors.values():
                if nbr.state >= NsmState.TWO_WAY:
                    views.append(
                        ElectionView(nbr.priority, nbr.router_id, nbr.src, nbr.dr, nbr.bdr)
                    )
            new_dr, new_bdr = elect_dr_bdr(views)
            changed = (new_dr, new_bdr) != (iface.dr, iface.bdr)
            iface.dr, iface.bdr = new_dr, new_bdr
            if new_dr == iface.addr_ip:
                self._set_ism_state(iface, IsmState.DR)
            elif new_bdr == iface.addr_ip:
                self._set_ism_state(iface, IsmState.BACKUP)
            else:
                self._set_ism_state(iface, IsmState.DR_OTHER)
            if not changed:
                break
        # AdjOK? on all 2-Way+ neighbors (adjacency set may change).
        for nbr_id in list(iface.neighbors):
            nbr = iface.neighbors[nbr_id]
            if nbr.state >= NsmState.TWO_WAY:
                self._nbr_event(iface.name, nbr_id, NsmEvent.ADJ_OK)
        self._originate_router_lsa(area)
        self._originate_network_lsa(area, iface)

    # ----- hello

    def _send_hello(self, ifname: str) -> None:
        ai = self._iface(ifname)
        if ai is None:
            return
        area, iface = ai
        if iface.state == IsmState.DOWN or iface.config.passive:
            return
        options = (
            Options.NP if area.nssa
            else Options(0) if area.stub
            else Options.E
        )
        lls = None
        if self.gr_restarting:
            # RFC 4812 restart signal: hellos during graceful restart
            # carry an LLS block with the RS bit so helpers keep the
            # adjacency without resetting it.
            from holo_tpu_torch.protocols.ospf.packet import LLS_EOF_RS, LlsBlock

            options |= Options.L
            lls = LlsBlock(eof=LLS_EOF_RS)
        hello = Hello(
            # §15/A.3.2: unnumbered p2p and virtual links send mask 0.
            mask=mask_of(iface.prefix) if iface.prefix else IPv4Address(0),
            hello_interval=iface.config.hello_interval,
            options=options,
            priority=iface.config.priority,
            dead_interval=iface.config.dead_interval,
            dr=iface.dr,
            bdr=iface.bdr,
            neighbors=[n.router_id for n in iface.neighbors.values()
                       if n.state >= NsmState.INIT],
        )
        self._send(iface, ALL_SPF_RTRS_V4, hello, area, lls=lls)
        self._timer(("hello", ifname), lambda: HelloTimerMsg(ifname)).start(
            iface.config.hello_interval
        )

    def _rx_hello(self, area: Area, iface: OspfInterface, src: IPv4Address, pkt: Packet) -> None:
        h: Hello = pkt.body
        if h.hello_interval != iface.config.hello_interval:
            # §10.5 parameter mismatch (notification per error.rs to_yang).
            self._notify_if_config_error(
                iface, src, "hello", "hello-interval-mismatch"
            )
            return
        if h.dead_interval != iface.config.dead_interval:
            self._notify_if_config_error(
                iface, src, "hello", "dead-interval-mismatch"
            )
            return
        if bool(h.options & Options.E) == area.no_type5:
            # §10.5: E-bit must agree with the area's type.
            self._notify_if_config_error(iface, src, "hello", "option-mismatch")
            return
        # RFC 5613: record the peer's LLS extended options (restart
        # signal / OOB-resync capability) on the neighbor.
        lls_eof = pkt.lls.eof if pkt.lls is not None else None
        if bool(h.options & Options.NP) != area.nssa:
            # RFC 3101 §2.4: N-bit must agree on NSSA-ness.
            self._notify_if_config_error(iface, src, "hello", "option-mismatch")
            return
        if (
            iface.config.if_type == IfType.BROADCAST
            and iface.prefix is not None
            and h.mask != mask_of(iface.prefix)
        ):
            self._notify_if_config_error(
                iface, src, "hello", "net-mask-mismatch"
            )
            return
        nbr = iface.neighbors.get(pkt.router_id)
        created = nbr is None
        if created:
            nbr = Neighbor(router_id=pkt.router_id, src=src)
            iface.neighbors[pkt.router_id] = nbr
        nbr.lls_eof = lls_eof
        if created:
            if iface.config.bfd_enabled and self.ibus is not None:
                # Register a BFD session for fast failure detection
                # (ibus bfd_session_reg path, SURVEY.md §3.5).
                from holo_tpu_torch.utils.ibus import TOPIC_BFD_STATE, BfdSessionReg

                self.ibus.subscribe(TOPIC_BFD_STATE, self.name)
                self.ibus.request(
                    self.bfd_actor,
                    BfdSessionReg(
                        sender=self.name,
                        key=(iface.name, src),
                        local=iface.addr_ip,
                    ),
                    sender=self.name,
                )
        prev = (nbr.priority, nbr.dr, nbr.bdr)
        nbr.src = src
        nbr.priority = h.priority
        nbr.dr, nbr.bdr = h.dr, h.bdr
        self._nbr_event(iface.name, pkt.router_id, NsmEvent.HELLO_RECEIVED)
        self._timer(
            ("inactivity", iface.name, pkt.router_id),
            lambda: InactivityTimerMsg(iface.name, pkt.router_id),
        ).start(iface.config.dead_interval)
        if self.config.router_id in h.neighbors:
            self._nbr_event(iface.name, pkt.router_id, NsmEvent.TWO_WAY_RECEIVED)
        else:
            self._nbr_event(iface.name, pkt.router_id, NsmEvent.ONE_WAY_RECEIVED)
            return
        if iface.config.if_type == IfType.BROADCAST:
            if iface.state == IsmState.WAITING:
                # BackupSeen (§9.2): nbr declares itself BDR, or DR with no BDR.
                if h.bdr == src or (h.dr == src and h.bdr == IPv4Address(0)):
                    t = self._timers.get(("wait", iface.name))
                    if t:
                        t.cancel()
                    self._run_dr_election(area, iface)
            elif (nbr.priority, nbr.dr, nbr.bdr) != prev:
                self._run_dr_election(area, iface)

    # ----- AS-external routes (type 5, §12.4.4 / §16.4)

    @property
    def is_asbr(self) -> bool:
        # An NSSA translator originates type-5s, so it is an ASBR to the
        # rest of the domain (RFC 3101 §3.1).
        return bool(self.redistributed) or bool(self._nssa_translated)

    def _external_lsid(self, prefix: IPv4Network) -> IPv4Address:
        """Appendix E link-state-id assignment for type-5 LSAs: prefixes
        sharing a network address get host bits set so keys stay unique."""
        from holo_tpu_torch.utils.ip import mask_of

        cur = self._external_lsids.get(prefix)
        if cur is not None:
            return cur
        net = prefix.network_address
        taken = set(self._external_lsids.values())
        lsid = net
        if lsid in taken:
            lsid = IPv4Address(int(net) | (~int(mask_of(prefix)) & 0xFFFFFFFF))
        self._external_lsids[prefix] = lsid
        return lsid

    def redistribute(
        self,
        prefix: IPv4Network,
        metric: int = 20,
        e2: bool = True,
        tag: int = 0,
    ) -> None:
        """ASBR: inject an external route as a type-5 LSA (AS scope — one
        copy per area LSDB, kept consistent by install-time propagation)."""
        was_asbr = self.is_asbr
        self.redistributed[prefix] = ExternalRoute(prefix, metric, e2, tag)
        self._originate_external(prefix)
        if not was_asbr:
            for area in self.areas.values():
                self._originate_router_lsa(area)  # E flag

    def _originate_external(
        self, prefix: IPv4Network, force: bool = False
    ) -> None:
        from holo_tpu_torch.protocols.ospf.packet import LsaAsExternal
        from holo_tpu_torch.utils.ip import mask_of

        route = self.redistributed[prefix]
        body = LsaAsExternal(
            mask=mask_of(prefix), e_bit=route.e2, metric=route.metric,
            fwd_addr=IPv4Address(0), tag=route.tag,
        )
        lsid = self._external_lsid(prefix)
        for area in self.areas.values():
            if area.nssa:
                # RFC 3101 §2.4: inside an NSSA the ASBR originates a
                # type-7 instead.  P-bit set so the elected ABR
                # translates it — unless we are an ABR ourselves (we
                # already flood the type-5 into the other areas, and
                # §2.3 forbids translating our own).
                opts = Options(0) if self.is_abr else Options.NP
                self._originate(
                    area, LsaType.NSSA_EXTERNAL, lsid, body,
                    options=opts, force=force,
                )
            elif not area.stub:  # §3.6: no type-5s in stub areas
                self._originate(
                    area, LsaType.AS_EXTERNAL, lsid, body, force=force
                )

    def withdraw_redistributed(self, prefix: IPv4Network) -> None:
        if self.redistributed.pop(prefix, None) is None:
            return
        lsid = self._external_lsids.pop(prefix, prefix.network_address)
        for area in self.areas.values():
            for ltype in (LsaType.AS_EXTERNAL, LsaType.NSSA_EXTERNAL):
                self._flush_self_lsa(
                    area, LsaKey(ltype, lsid, self.config.router_id)
                )
        if not self.is_asbr:
            for area in self.areas.values():
                self._originate_router_lsa(area)

    def _propagate_external(self, from_area: Area, lsa: Lsa) -> None:
        """AS scope: a type-5 installed in one area is installed (and thus
        flooded) into every other non-stub, non-NSSA area by ABRs
        (§3.6, RFC 3101 §2.2)."""
        for area in self.areas.values():
            if area is from_area or area.no_type5:
                continue
            cur = area.lsdb.get(lsa.key)
            if cur is None or lsa.compare(cur.lsa) > 0:
                self._install_and_flood(area, lsa)

    def _asbr_distance(self, aid, st, res, asbr: IPv4Address, now: float):
        """Distance + next hops to an ASBR within one area — directly if
        it is in this area's SPF, else via a type-4 ASBR-summary from a
        reachable ABR (§16.4 step 3)."""
        from holo_tpu_torch.protocols.ospf.spf_run import _atoms_of

        v = st.router_index.get(asbr)
        if v is not None and res.dist[v] < 0x40000000:
            return int(res.dist[v]), _atoms_of(res.nexthop_words[v], st.atoms)
        best = None
        area = self.areas[aid]
        for e in area.lsdb.all():
            lsa = e.lsa
            if (
                lsa.type != LsaType.SUMMARY_ROUTER
                or lsa.lsid != asbr
                or lsa.adv_rtr == self.config.router_id
                or e.current_age(now) >= MAX_AGE
            ):
                continue
            abr_v = st.router_index.get(lsa.adv_rtr)
            if abr_v is None or res.dist[abr_v] >= 0x40000000:
                continue
            dist = int(res.dist[abr_v]) + lsa.body.metric
            if best is None or dist < best[0]:
                best = (dist, _atoms_of(res.nexthop_words[abr_v], st.atoms))
        return best if best is not None else (None, None)

    def _external_routes(
        self, area_results: dict, known: set, only: set | None = None
    ) -> dict:
        """§16.4 condensed: E1 = dist(ASBR)+metric; E2 ranked by (metric,
        dist(ASBR)) after all internal paths; intra/inter always win.

        ``only`` scopes a partial run to the changed prefixes
        (route.rs:307-321): other externals keep their table entries."""
        best: dict = {}
        now = self.loop.clock.now()
        for aid, (st, res) in area_results.items():
            area = self.areas[aid]
            # RFC 3101 §2.5: inside an NSSA, type-7s are examined
            # alongside type-5s from the other attached areas.
            wanted_types = (
                (LsaType.AS_EXTERNAL, LsaType.NSSA_EXTERNAL)
                if area.nssa
                else (LsaType.AS_EXTERNAL,)
            )
            for e in area.lsdb.all():
                lsa = e.lsa
                if (
                    lsa.type not in wanted_types
                    or lsa.adv_rtr == self.config.router_id
                    or e.current_age(now) >= MAX_AGE
                    or lsa.body.metric >= 0xFFFFFF
                ):
                    continue
                asbr_dist, nhs = self._asbr_distance(
                    aid, st, res, lsa.adv_rtr, now
                )
                if asbr_dist is None:
                    continue
                from holo_tpu_torch.protocols.ospf.spf_run import IntraRoute
                from holo_tpu_torch.utils.ip import apply_mask

                prefix = apply_mask(lsa.lsid, lsa.body.mask)
                if only is not None and prefix not in only:
                    continue  # partial run: out-of-scope prefix
                if prefix in known:
                    continue  # internal paths always preferred
                # Ranking key: E1 before E2; E1 by total; E2 by (metric,
                # asbr dist); type-5 over type-7 on full ties (§2.5).
                is_t7 = lsa.type == LsaType.NSSA_EXTERNAL
                if is_t7 and self.is_abr and prefix.prefixlen == 0:
                    # RFC 3101 §2.5: type-7 default LSAs are examined
                    # only by non-border NSSA routers — two ABRs would
                    # otherwise default-route into each other.
                    continue
                if lsa.body.e_bit:
                    rank = (1, lsa.body.metric, asbr_dist, is_t7)
                    dist = lsa.body.metric
                    rtype = "nssa-2" if is_t7 else "external-2"
                else:
                    rank = (0, asbr_dist + lsa.body.metric, 0, is_t7)
                    dist = asbr_dist + lsa.body.metric
                    rtype = "nssa-1" if is_t7 else "external-1"
                cur = best.get(prefix)
                if cur is None or rank < cur[0]:
                    best[prefix] = (
                        rank, IntraRoute(prefix, dist, nhs, aid, rtype)
                    )
                elif rank == cur[0]:
                    merged = IntraRoute(
                        prefix, dist, cur[1].nexthops | nhs, aid, rtype
                    )
                    best[prefix] = (rank, merged)
        return {p: r for p, (rank, r) in best.items()}

    def _nssa_translate(self, area_results: dict) -> None:
        """RFC 3101 §3: the reachable NSSA ABR with the highest router-id
        translates P-bit type-7s into type-5s for the rest of the domain;
        everyone else (and routers losing the election) withdraws."""
        from holo_tpu_torch.protocols.ospf.packet import LsaAsExternal, RouterFlags
        from holo_tpu_torch.utils.ip import apply_mask

        now = self.loop.clock.now()
        wanted: dict[IPv4Network, LsaAsExternal] = {}
        if self.is_abr:
            for aid, (st, res) in area_results.items():
                area = self.areas[aid]
                if not area.nssa:
                    continue
                # Translator election (§3.1): highest-RID reachable ABR.
                abrs = {self.config.router_id}
                for e in area.lsdb.all():
                    lsa = e.lsa
                    if (
                        lsa.type != LsaType.ROUTER
                        or not (lsa.body.flags & RouterFlags.B)
                        or e.current_age(now) >= MAX_AGE
                    ):
                        continue
                    v = st.router_index.get(lsa.adv_rtr)
                    if v is not None and res.dist[v] < 0x40000000:
                        abrs.add(lsa.adv_rtr)
                if max(abrs) != self.config.router_id:
                    continue  # someone else translates for this NSSA
                for e in area.lsdb.all():
                    lsa = e.lsa
                    if (
                        lsa.type != LsaType.NSSA_EXTERNAL
                        or lsa.adv_rtr == self.config.router_id
                        or not (lsa.options & Options.NP)  # P=0: never
                        or e.current_age(now) >= MAX_AGE
                        or lsa.body.metric >= 0xFFFFFF
                    ):
                        continue
                    v = st.router_index.get(lsa.adv_rtr)
                    if v is None or res.dist[v] >= 0x40000000:
                        continue  # §3.2: ASBR must be reachable
                    prefix = apply_mask(lsa.lsid, lsa.body.mask)
                    body = LsaAsExternal(
                        mask=lsa.body.mask,
                        e_bit=lsa.body.e_bit,
                        metric=lsa.body.metric,
                        fwd_addr=lsa.body.fwd_addr,
                        tag=lsa.body.tag,
                    )
                    cur = wanted.get(prefix)
                    # Aggregate duplicates: best (E1-first, lowest metric).
                    if cur is None or (not body.e_bit, body.metric) < (
                        not cur.e_bit, cur.metric
                    ):
                        wanted[prefix] = body
        was_asbr = self.is_asbr
        for prefix in self._nssa_translated - set(wanted):
            if prefix in self.redistributed:
                continue  # still advertised in our own right
            lsid = self._external_lsids.pop(prefix, prefix.network_address)
            key = LsaKey(LsaType.AS_EXTERNAL, lsid, self.config.router_id)
            for area in self.areas.values():
                self._flush_self_lsa(area, key)
        self._nssa_translated = set(wanted)
        for prefix, body in wanted.items():
            if prefix in self.redistributed:
                continue  # our own type-5 wins; no translated duplicate
            lsid = self._external_lsid(prefix)
            for area in self.areas.values():
                if not area.no_type5:
                    self._originate(area, LsaType.AS_EXTERNAL, lsid, body)
        if was_asbr != self.is_asbr:
            for area in self.areas.values():
                self._originate_router_lsa(area)  # E-flag changed

    # ----- graceful restart (RFC 3623)

    def _inactivity_expired(self, ifname: str, nbr_id: IPv4Address) -> None:
        """Dead timer fired — unless we are helping this neighbor restart
        (grace window open), in which case we hold the adjacency
        (reference gr.rs helper mode)."""
        ai = self._iface(ifname)
        if ai is None:
            return
        nbr = ai[1].neighbors.get(nbr_id)
        if nbr is not None and nbr.gr_deadline is not None:
            now = self.loop.clock.now()
            if now < nbr.gr_deadline:
                self._timer(
                    ("inactivity", ifname, nbr_id),
                    lambda: InactivityTimerMsg(ifname, nbr_id),
                ).start(nbr.gr_deadline - now)
                return
            nbr.gr_deadline = None  # grace expired: proceed with the kill
        self._nbr_event(ifname, nbr_id, NsmEvent.INACTIVITY_TIMER)

    def send_grace_lsas(self, grace_period: int = 120, reason: int = 1) -> None:
        """Restarting side: announce intent to restart, one link-local
        Grace-LSA per interface (opaque type 9.3), flooded only on its
        own link.  Exempt from the gr_restarting origination suppression
        (RFC 3623 §2.2 — Grace-LSAs are the one thing a restarting router
        DOES originate)."""
        from holo_tpu_torch.protocols.ospf.packet import (
            LsaOpaque,
            encode_grace_tlvs,
            grace_lsa_lsid,
        )

        self._gr_grace_period = grace_period
        self._gr_reason = reason
        for area in self.areas.values():
            for idx, iface in enumerate(area.interfaces.values()):
                if iface.state == IsmState.DOWN or iface.addr_ip is None:
                    continue
                body = LsaOpaque(
                    encode_grace_tlvs(grace_period, reason, iface.addr_ip)
                )
                self._originate(
                    area,
                    LsaType.OPAQUE_LINK,
                    grace_lsa_lsid(idx),
                    body,
                    allow_in_gr=True,
                    only_iface=iface,
                )
        # Persist the highest Grace-LSA seq-no actually used: the post-
        # restart instance resumes from it when synthesizing the MaxAge
        # flush, so helpers accept the flush no matter how many times
        # grace params were re-announced before the restart.
        if self._nvstore is not None:
            seqs = [
                e.lsa.seq_no
                for area in self.areas.values()
                for key in list(area.lsdb.entries)
                if self._is_own_grace_lsa(key)
                and (e := area.lsdb.get(key)) is not None
            ]
            if seqs:
                self._nvstore.put(self._grace_seqno_key, max(seqs))

    def iface_update(
        self,
        ifname: str,
        hello: int | None = None,
        dead: int | None = None,
        priority: int | None = None,
        passive: bool | None = None,
        mtu: int | None = None,
        mtu_ignore: bool | None = None,
        transmit_delay: int | None = None,
    ) -> None:
        """Live interface reconfiguration beyond cost (reference
        northbound InterfaceUpdate family).

        - hello/dead intervals apply from the NEXT hello (the hello
          timer re-arms with the config value each fire); a mismatch
          with the peer drops its hellos until both sides agree —
          standard OSPF semantics.
        - priority is advertised in the next hello; elections react via
          the peers' NeighborChange processing.
        - passive=True kills the circuit's neighbors (the interface
          stops exchanging hellos); passive=False restarts the hello
          task that the passive gate parked."""
        ai = self._iface(ifname)
        if ai is None:
            return
        area, iface = ai
        cfg = iface.config
        if hello is not None:
            cfg.hello_interval = hello
        if dead is not None:
            cfg.dead_interval = dead
        if priority is not None:
            cfg.priority = priority
        if mtu is not None:
            # The §10.6 DD Interface-MTU check reads this live — a stale
            # creation-time snapshot would wedge jumbo adjacencies.
            cfg.mtu = mtu
        if mtu_ignore is not None:
            cfg.mtu_ignore = mtu_ignore
        if transmit_delay is not None:
            cfg.transmit_delay = transmit_delay
        if passive is not None and cfg.passive != passive:
            cfg.passive = passive
            if iface.state == IsmState.DOWN:
                # A link-down interface has nothing to tear down or
                # revive — and forcing WAITING here would advertise a
                # dead link AND break the next if_up's DOWN check.
                return
            if passive:
                # Same teardown discipline as if_down: the going_down
                # guard suppresses interim DR elections per KILL_NBR
                # (a passive interface must not end up claiming DR).
                iface.going_down = True
                try:
                    for nbr_id in list(iface.neighbors):
                        self._nbr_event(ifname, nbr_id, NsmEvent.KILL_NBR)
                finally:
                    iface.going_down = False
                iface.dr = IPv4Address(0)
                iface.bdr = IPv4Address(0)
                if cfg.if_type == IfType.BROADCAST:
                    self._set_ism_state(iface, IsmState.WAITING)
                for key in ("hello", "wait"):
                    t = self._timers.get((key, ifname))
                    if t:
                        t.cancel()
                self._originate_router_lsa(area)
            elif iface.state != IsmState.DOWN:
                # Revival re-enters the §9.1 Waiting phase on broadcast
                # circuits and restarts the hello task the passive gate
                # parked.
                if cfg.if_type == IfType.BROADCAST:
                    self._set_ism_state(iface, IsmState.WAITING)
                    self._timer(
                        ("wait", ifname), lambda: WaitTimerMsg(ifname)
                    ).start(cfg.dead_interval)
                self._timer(
                    ("hello", ifname), lambda: HelloTimerMsg(ifname)
                ).start(0.0)

    def iface_cost_update(self, ifname: str, cost: int) -> None:
        """Live cost reconfiguration (reference northbound
        InterfaceCostUpdate): the new metric re-originates our
        router-LSA, and neighbors reconverge through normal flooding."""
        ai = self._iface(ifname)
        if ai is None:
            return
        area, iface = ai
        if iface.config.cost == cost:
            return
        iface.config.cost = cost
        self._originate_router_lsa(area)

    def _is_own_grace_lsa(self, key: "LsaKey") -> bool:
        """Self-originated Grace-LSA key (link-local opaque type 3)."""
        return (
            key.type == LsaType.OPAQUE_LINK
            and key.adv_rtr == self.config.router_id
            and (int(key.lsid) >> 24) == 3
        )

    def begin_graceful_restart(self, grace_period: int = 120) -> None:
        """Enter restarting mode with a hard exit deadline (RFC 3623 §2.5):
        if resync hasn't completed when the grace period lapses, resume
        normal operation with whatever adjacencies exist — a vanished
        pre-restart neighbor must not suppress origination forever."""
        self.gr_restarting = True
        self._gr_grace_period = grace_period
        t = self._timers.get(("gr-expire",))
        if t is None:
            t = self.loop.timer(self.name, GrRestartExpireMsg)
            self._timers[("gr-expire",)] = t
        t.start(grace_period)

    def _gr_restart_expired(self) -> None:
        if not self.gr_restarting:
            return
        self.gr_restarting = False
        for a in self.areas.values():
            self._originate_router_lsa(a)
            self._originate_router_info(a)  # hostname/caps changed during GR
        self._flush_grace_lsas()

    def _gr_resync_complete(self) -> bool:
        """All p2p neighbors named in our adopted pre-restart router LSA
        must be FULL again before the restart is considered complete
        (RFC 3623 §2.3; the pre-restart LSA is the surviving record of
        which adjacencies existed)."""
        for area in self.areas.values():
            key = LsaKey(LsaType.ROUTER, self.config.router_id, self.config.router_id)
            e = area.lsdb.get(key)
            expected: set = set()
            if e is not None:
                for link in e.lsa.body.links:
                    if link.link_type == RouterLinkType.POINT_TO_POINT:
                        expected.add(link.id)
            full = {
                n.router_id
                for i in area.interfaces.values()
                for n in i.neighbors.values()
                if n.state == NsmState.FULL
            }
            if expected - full:
                return False
        return True

    def _flush_grace_lsas(self) -> None:
        """Restart complete (§2.4): withdraw our Grace-LSAs on the wire.

        The opaque id encodes the interface's position in the area's
        interface order (assigned identically in send_grace_lsas), so the
        maxage copy floods on exactly its own link.

        A freshly restarted instance usually does NOT hold its own
        pre-restart Grace-LSAs (DD exchange excludes link-local opaques),
        so flushing by LSDB lookup alone would silently do nothing and
        helpers would sit out the whole grace period.  For interfaces with
        no stored copy we synthesize the MaxAge Grace-LSA directly with a
        sequence number strictly newer than any plausible pre-restart
        copy, so helpers accept the flush under RFC 2328 §13.1.
        """
        from holo_tpu_torch.protocols.ospf.packet import (
            LsaOpaque,
            encode_grace_tlvs,
            grace_lsa_lsid,
        )

        # Resume from the persisted pre-restart Grace-LSA seq-no when the
        # NV store has one (send_grace_lsas records it); the +4 guess is
        # only the fallback for instances that never wrote the record.
        synth_seq = next_seq_no(None) + 4
        if self._nvstore is not None:
            persisted = self._nvstore.get(self._grace_seqno_key)
            if persisted is not None:
                synth_seq = max(int(persisted) + 1, synth_seq)
        for area in self.areas.values():
            ifaces = list(area.interfaces.values())
            flushed: set = set()
            for key in list(area.lsdb.entries):
                if self._is_own_grace_lsa(key):
                    idx = int(key.lsid) & 0xFFFFFF
                    only = ifaces[idx] if idx < len(ifaces) else None
                    self._flush_self_lsa(area, key, only_iface=only)
                    flushed.add(idx)
            for idx, iface in enumerate(ifaces):
                if idx in flushed:
                    continue
                if iface.state == IsmState.DOWN or iface.addr_ip is None:
                    continue
                lsa = Lsa(
                    age=MAX_AGE,
                    options=Options(0) if area.stub else Options.E,
                    type=LsaType.OPAQUE_LINK,
                    lsid=grace_lsa_lsid(idx),
                    adv_rtr=self.config.router_id,
                    # Strictly newer than any pre-restart copy helpers
                    # hold: the NV store records how far the old instance
                    # got (synth_seq above); the +4-past-initial fallback
                    # covers instances without the record.
                    seq_no=synth_seq,
                    body=LsaOpaque(
                        encode_grace_tlvs(
                            self._gr_grace_period, self._gr_reason,
                            iface.addr_ip,
                        )
                    ),
                )
                lsa.encode()
                self._install_and_flood(area, lsa, only_iface=iface)

    def _maybe_enter_gr_helper(self, area: Area, lsa: Lsa) -> None:
        from holo_tpu_torch.protocols.ospf.packet import decode_grace_tlvs

        if lsa.type != LsaType.OPAQUE_LINK or (int(lsa.lsid) >> 24) != 3:
            return
        if lsa.is_maxage:
            # Flushed Grace-LSA = restart complete: close the window.
            for iface in area.interfaces.values():
                nbr = iface.neighbors.get(lsa.adv_rtr)
                if nbr is not None and nbr.gr_deadline is not None:
                    self.gr_helper_exit(area, iface, nbr, "completed")
            return
        info = decode_grace_tlvs(lsa.body.data)
        period = info.get("grace_period")
        if period is None:
            return
        now = self.loop.clock.now()
        for iface in area.interfaces.values():
            nbr = iface.neighbors.get(lsa.adv_rtr)
            if nbr is not None and nbr.state == NsmState.FULL:
                entering = nbr.gr_deadline is None
                nbr.gr_deadline = now + period
                nbr.gr_reason = info.get("reason", 0)
                if entering:
                    self.gr_helper_enter(area, iface, nbr, period)

    # ----- NSM plumbing

    def _adj_ok(self, iface: OspfInterface, nbr: Neighbor) -> bool:
        """§10.4: should we form/keep an adjacency with this neighbor?"""
        if iface.config.if_type in (
            IfType.POINT_TO_POINT, IfType.VIRTUAL_LINK
        ):
            return True
        return (
            iface.state in (IsmState.DR, IsmState.BACKUP)
            or nbr.src == iface.dr
            or nbr.src == iface.bdr
        )

    def _nbr_event(self, ifname: str, nbr_id: IPv4Address, event: NsmEvent) -> None:
        ai = self._iface(ifname)
        if ai is None:
            return
        area, iface = ai
        nbr = iface.neighbors.get(nbr_id)
        if nbr is None:
            return
        old_state = nbr.state
        res = nsm_transition(nbr, event, adj_ok=self._adj_ok(iface, nbr))
        nbr.state = res.new_state
        if nbr.state != old_state:
            from holo_tpu_torch.protocols.ospf.nb_state import _NSM_NAME

            _OSPF_NBR_TRANSITIONS.labels(
                instance=self.name, to=_NSM_NAME[nbr.state]
            ).inc()
            self._notify(
                "ietf-ospf:nbr-state-change",
                self._notif_iface(iface)
                | {
                    "neighbor-router-id": str(nbr.router_id),
                    "neighbor-ip-addr": str(nbr.src),
                    "state": _NSM_NAME[nbr.state],
                },
            )
        for act in res.actions:
            if act == "start_exstart":
                self._start_exstart(area, iface, nbr)
            elif act == "send_dd_summary":
                self._enter_exchange(area, iface, nbr)
            elif act == "send_ls_request":
                self._send_ls_request(area, iface, nbr)
            elif act == "clear_lists":
                nbr.ls_request.clear()
                nbr.ls_rxmt.clear()
                nbr.dd_summary.clear()
            elif act == "stop_timers":
                for key in ("inactivity", "rxmt"):
                    t = self._timers.get((key, ifname, nbr_id))
                    if t:
                        t.cancel()
            elif act == "full":
                t = self._timers.get(("rxmt", ifname, nbr_id))
                if t:
                    t.cancel()
                # The helper window stays open until the restarting router
                # flushes its Grace-LSA (gr.rs:49-63) — reaching FULL alone
                # does not end it.
                if self.gr_restarting and self._gr_resync_complete():
                    # All pre-restart adjacencies re-established (§2.3):
                    # resume origination and withdraw Grace-LSAs (§2.4).
                    self.gr_restarting = False
                    t = self._timers.get(("gr-expire",))
                    if t:
                        t.cancel()
                    for a in self.areas.values():
                        self._originate_router_lsa(a)
                        self._originate_router_info(a)
                    self._flush_grace_lsas()
        if nbr.state == NsmState.DOWN:
            del iface.neighbors[nbr_id]
            if iface.config.bfd_enabled and self.ibus is not None:
                from holo_tpu_torch.utils.ibus import BfdSessionUnreg

                self.ibus.request(
                    self.bfd_actor,
                    BfdSessionUnreg(sender=self.name, key=(iface.name, nbr.src)),
                    sender=self.name,
                )
        if (old_state >= NsmState.FULL) != (nbr.state >= NsmState.FULL) or (
            nbr.state == NsmState.DOWN
        ):
            # Adjacency formed/lost: re-originate router LSA (+network if DR),
            # and rerun election bookkeeping via NeighborChange where needed.
            self._originate_router_lsa(area)
            self._originate_network_lsa(area, iface)
        if event in (NsmEvent.KILL_NBR, NsmEvent.INACTIVITY_TIMER, NsmEvent.ONE_WAY_RECEIVED):
            if (
                iface.config.if_type == IfType.BROADCAST
                and iface.state >= IsmState.DR_OTHER
                and not getattr(iface, "going_down", False)
            ):
                self._run_dr_election(area, iface)

    # ----- DD exchange

    def _start_exstart(self, area: Area, iface: OspfInterface, nbr: Neighbor) -> None:
        if self.config.deterministic_dd:
            # Interop with the reference's recorded exchanges: its
            # 'deterministic' build seeds the DD sequence number from the
            # neighbor's router-id (holo-ospf/src/neighbor.rs:171-178) and
            # increments before the first DD, so recorded slave echoes only
            # line up if we do the same.
            nbr.dd_seq_no = int(nbr.router_id) + 1
        else:
            self._dd_seq += 1
            nbr.dd_seq_no = self._dd_seq
        nbr.master = True  # assume master until negotiation says otherwise
        dd = DbDesc(
            mtu=iface.config.mtu,
            options=Options.E,
            flags=DbDescFlags.I | DbDescFlags.M | DbDescFlags.MS,
            dd_seq_no=nbr.dd_seq_no,
        )
        nbr.last_sent_dd = dd
        self._send(iface, nbr.src, dd, area)
        self._arm_rxmt(iface, nbr)

    def _dd_summary_chunk(self, nbr: Neighbor) -> list[Lsa]:
        return nbr.dd_summary[:DD_CHUNK]

    def _enter_exchange(self, area: Area, iface: OspfInterface, nbr: Neighbor) -> None:
        """Populate the DD summary list (§10.8 NegotiationDone).  Sending is
        driven by the caller: the master continues processing the packet
        that completed negotiation, the slave replies to it."""
        now = self.loop.clock.now()
        # Link-local (type 9) LSAs are excluded: they must not DD-sync
        # beyond their own link (RFC 5250 §3).
        nbr.dd_summary = [
            e.lsa
            for e in area.lsdb.entries.values()
            if e.current_age(now) < MAX_AGE
            and e.lsa.type != LsaType.OPAQUE_LINK
        ]

    def _send_dd(self, area: Area, iface: OspfInterface, nbr: Neighbor) -> None:
        chunk = self._dd_summary_chunk(nbr)
        more = len(nbr.dd_summary) > len(chunk)
        flags = DbDescFlags(0)
        if nbr.master:
            flags |= DbDescFlags.MS
        if more:
            flags |= DbDescFlags.M
        dd = DbDesc(
            mtu=iface.config.mtu,
            options=Options.E,
            flags=flags,
            dd_seq_no=nbr.dd_seq_no,
            lsa_headers=chunk,
        )
        nbr.last_sent_dd = dd
        self._send(iface, nbr.src, dd, area)
        if nbr.master:
            self._arm_rxmt(iface, nbr)

    def _rx_db_desc(self, area: Area, iface: OspfInterface, src: IPv4Address, pkt: Packet) -> None:
        dd: DbDesc = pkt.body
        nbr = iface.neighbors.get(pkt.router_id)
        if nbr is None:
            return
        if nbr.state == NsmState.INIT:
            # §10.6: a DD in Init proves the neighbor sees us — run
            # 2-WayReceived and, if that starts the adjacency (ExStart),
            # keep processing this same packet.
            self._nbr_event(iface.name, pkt.router_id, NsmEvent.TWO_WAY_RECEIVED)
            nbr = iface.neighbors.get(pkt.router_id)
            if nbr is None:
                return
        if nbr.state < NsmState.EX_START:
            return
        # §10.6: reject a DD whose Interface MTU exceeds what we can
        # receive unfragmented, unless mtu-ignore is set.  Virtual links
        # carry MTU 0 and are exempt (§10.8).
        if (
            dd.mtu > iface.config.mtu
            and not iface.config.mtu_ignore
            and iface.config.if_type != IfType.VIRTUAL_LINK
        ):
            return
        if nbr.state == NsmState.EX_START:
            negotiated = False
            if (
                dd.flags == DbDescFlags.I | DbDescFlags.M | DbDescFlags.MS
                and not dd.lsa_headers
                and int(pkt.router_id) > int(self.config.router_id)
            ):
                # Peer is master; adopt its sequence number.
                nbr.master = False
                nbr.dd_seq_no = dd.dd_seq_no
                negotiated = True
            elif (
                not (dd.flags & DbDescFlags.I)
                and not (dd.flags & DbDescFlags.MS)
                and dd.dd_seq_no == nbr.dd_seq_no
                and int(pkt.router_id) < int(self.config.router_id)
            ):
                nbr.master = True
                negotiated = True
            if not negotiated:
                return
            self._nbr_event(iface.name, pkt.router_id, NsmEvent.NEGOTIATION_DONE)
            nbr = iface.neighbors.get(pkt.router_id)
            if nbr is None or nbr.state != NsmState.EXCHANGE:
                return
            nbr.last_dd = (dd.flags, dd.options, dd.dd_seq_no)
            # Either way the packet completing negotiation must be processed
            # for content (§10.8): the slave's echo may carry LSA headers.
            self._process_dd_headers(area, iface, nbr, dd)
            if nbr.master:
                # The master always sends its first data DD (even with an
                # empty summary): the slave can only conclude the exchange
                # from a master DD with M clear.
                nbr.dd_seq_no += 1
                self._send_dd(area, iface, nbr)
            else:
                self._slave_reply(area, iface, nbr, dd)
            return

        if nbr.state != NsmState.EXCHANGE:
            # §10.6: duplicate handling in Loading/Full — slave re-echoes.
            if (
                nbr.state in (NsmState.LOADING, NsmState.FULL)
                and not nbr.master
                and nbr.last_dd == (dd.flags, dd.options, dd.dd_seq_no)
            ):
                if nbr.last_sent_dd is not None:
                    self._send(iface, nbr.src, nbr.last_sent_dd, area)
                return
            if nbr.state in (NsmState.LOADING, NsmState.FULL):
                self._nbr_event(iface.name, pkt.router_id, NsmEvent.SEQ_NUMBER_MISMATCH)
            return

        dup = nbr.last_dd == (dd.flags, dd.options, dd.dd_seq_no)
        if dup:
            if not nbr.master and nbr.last_sent_dd is not None:
                self._send(iface, nbr.src, nbr.last_sent_dd, area)
            return
        # Master/slave bit must be consistent (exactly one master).
        peer_is_master = bool(dd.flags & DbDescFlags.MS)
        if peer_is_master == nbr.master:
            self._nbr_event(iface.name, pkt.router_id, NsmEvent.SEQ_NUMBER_MISMATCH)
            return
        if dd.flags & DbDescFlags.I:
            self._nbr_event(iface.name, pkt.router_id, NsmEvent.SEQ_NUMBER_MISMATCH)
            return
        if nbr.master:
            if dd.dd_seq_no != nbr.dd_seq_no:
                self._nbr_event(iface.name, pkt.router_id, NsmEvent.SEQ_NUMBER_MISMATCH)
                return
            nbr.last_dd = (dd.flags, dd.options, dd.dd_seq_no)
            self._process_dd_headers(area, iface, nbr, dd)
            nbr.dd_summary = nbr.dd_summary[len(self._dd_summary_chunk(nbr)) :]
            nbr.dd_seq_no += 1
            if not nbr.dd_summary and not (dd.flags & DbDescFlags.M):
                self._nbr_event(iface.name, pkt.router_id, NsmEvent.EXCHANGE_DONE)
            else:
                self._send_dd(area, iface, nbr)
        else:
            if dd.dd_seq_no != nbr.dd_seq_no + 1 and nbr.last_dd is not None:
                self._nbr_event(iface.name, pkt.router_id, NsmEvent.SEQ_NUMBER_MISMATCH)
                return
            nbr.last_dd = (dd.flags, dd.options, dd.dd_seq_no)
            self._process_dd_headers(area, iface, nbr, dd)
            self._slave_reply(area, iface, nbr, dd)

    def _slave_reply(self, area: Area, iface: OspfInterface, nbr: Neighbor, dd: DbDesc) -> None:
        nbr.dd_seq_no = dd.dd_seq_no
        chunk = self._dd_summary_chunk(nbr)
        nbr.dd_summary = nbr.dd_summary[len(chunk) :]
        flags = DbDescFlags(0)
        if nbr.dd_summary:
            flags |= DbDescFlags.M
        reply = DbDesc(
            mtu=iface.config.mtu,
            options=Options.E,
            flags=flags,
            dd_seq_no=nbr.dd_seq_no,
            lsa_headers=chunk,
        )
        nbr.last_sent_dd = reply
        self._send(iface, nbr.src, reply, area)
        if not (dd.flags & DbDescFlags.M) and not (flags & DbDescFlags.M):
            self._nbr_event(iface.name, nbr.router_id, NsmEvent.EXCHANGE_DONE)

    def _process_dd_headers(self, area: Area, iface: OspfInterface, nbr: Neighbor, dd: DbDesc) -> None:
        for hdr in dd.lsa_headers:
            cur = area.lsdb.get(hdr.key)
            if cur is None or hdr.compare(cur.lsa) > 0:
                nbr.ls_request[hdr.key] = hdr

    # ----- LS request / update / ack

    def _send_ls_request(self, area: Area, iface: OspfInterface, nbr: Neighbor) -> None:
        keys = list(nbr.ls_request.keys())[:LSREQ_CHUNK]
        if not keys:
            return
        self._send(iface, nbr.src, LsRequest(keys), area)
        self._arm_rxmt(iface, nbr)

    def _rx_ls_request(self, area: Area, iface: OspfInterface, src: IPv4Address, pkt: Packet) -> None:
        nbr = iface.neighbors.get(pkt.router_id)
        if nbr is None or nbr.state < NsmState.EXCHANGE:
            return
        lsas = []
        for key in pkt.body.entries:
            e = area.lsdb.get(key)
            if e is None:
                self._nbr_event(iface.name, pkt.router_id, NsmEvent.BAD_LS_REQ)
                return
            lsas.append(self._aged_copy(e, iface.config.transmit_delay))
        if lsas:
            self._send(iface, nbr.src, LsUpdate(lsas), area)

    def _aged_copy(self, entry, delay: int = 0) -> Lsa:
        """LSA with age advanced to now plus the outgoing interface's
        InfTransDelay (§13.1/§13.3), capped at MaxAge.  The copy/patch
        step is the shared ``lsa_tx_copy``, expressed as the delta from
        the stored age to (current age + delay)."""
        lsa = entry.lsa
        from holo_tpu_torch.protocols.ospf.packet import lsa_tx_copy

        age = min(entry.current_age(self.loop.clock.now()) + delay, MAX_AGE)
        return lsa_tx_copy(lsa, age - lsa.age)

    @staticmethod
    def _tx_copy(lsa: Lsa, delay: int) -> Lsa:
        """§13.3 InfTransDelay age increment (shared helper)."""
        from holo_tpu_torch.protocols.ospf.packet import lsa_tx_copy

        return lsa_tx_copy(lsa, delay)

    @staticmethod
    def _validate_lsa(lsa: Lsa) -> str | None:
        """LSA sanity checks (reference lsa.rs validate()); returns the
        holo-ospf lsa-validation-error identity or None."""
        from holo_tpu_torch.utils.bytesbuf import fletcher16_verify

        if lsa.age > MAX_AGE:
            return "invalid-age"
        if (lsa.seq_no & 0xFFFFFFFF) == 0x80000000:  # reserved seqno
            return "invalid-seq-num"
        if lsa.raw and len(lsa.raw) >= 20 and not fletcher16_verify(
            lsa.raw[2:]
        ):
            return "invalid-checksum"
        if lsa.type == LsaType.ROUTER and lsa.lsid != lsa.adv_rtr:
            return "ospfv2-router-lsa-id-mismatch"
        return None

    def _rx_ls_update(self, area: Area, iface: OspfInterface, src: IPv4Address, pkt: Packet) -> None:
        nbr = iface.neighbors.get(pkt.router_id)
        if nbr is None or nbr.state < NsmState.EXCHANGE:
            return
        acks: list[Lsa] = []
        now = self.loop.clock.now()
        exchanging = any(
            n.state in (NsmState.EXCHANGE, NsmState.LOADING)
            for a2 in self.areas.values()
            for i2 in a2.interfaces.values()
            for n in i2.neighbors.values()
        )
        for lsa in pkt.body.lsas:
            # (1) Validation beyond the RFC's checksum-only rule
            # (reference lsa.rs:370-386 + events.rs:830-845).
            err = self._validate_lsa(lsa)
            if err is not None:
                self._notify(
                    "holo-ospf:if-rx-bad-lsa",
                    {
                        "routing-protocol-name": self.name,
                        "packet-source": str(src),
                        "error": err,
                    },
                )
                continue
            # Flooding scope (§3.6 / RFC 3101 §2.2): no type-5s into
            # stub or NSSA areas — nor type-4 ASBR-summaries or AS-scope
            # opaques (RFC 2328 errata 3746; reference lsdb.rs:85-99) —
            # and type-7s only inside an NSSA.
            if lsa.type in (
                LsaType.AS_EXTERNAL,
                LsaType.SUMMARY_ROUTER,
                LsaType.OPAQUE_AS,
            ) and area.no_type5:
                continue
            if lsa.type == LsaType.NSSA_EXTERNAL and not area.nssa:
                continue
            cur = area.lsdb.get(lsa.key)
            # §13 (4): a MaxAge LSA with no database copy (and no
            # exchange in progress) is acked directly, never installed —
            # otherwise flushes ping-pong around multi-access links.
            if lsa.is_maxage and cur is None and not exchanging:
                acks.append(lsa)
                continue
            # §13 (5): newer than DB copy (or no copy).
            if cur is None or lsa.compare(cur.lsa) > 0:
                if (
                    cur is not None
                    and now - cur.rcvd_time < self.config.min_ls_arrival
                ):
                    continue
                # Self-originated received from elsewhere (§13.4): flood
                # the newer copy on as usual, then outpace or flush it
                # (the reference does both, in that order — two floods on
                # every adjacency).  Network LSAs are self-identified by
                # the LSA-ID matching one of our interface addresses, NOT
                # only by the advertising router (a pre-restart router-id
                # change leaves stale copies under the old adv-rtr).
                self_net_iface = (
                    self._iface_by_addr(lsa.lsid)
                    if lsa.type == LsaType.NETWORK
                    else None
                )
                if (
                    lsa.adv_rtr == self.config.router_id
                    or self_net_iface is not None
                ) and not lsa.is_maxage:
                    prev_lsa = cur.lsa if cur is not None else None
                    fb = self._install_and_flood(
                        area, lsa, from_iface=iface, from_nbr=nbr
                    )
                    if self._ack_wanted(iface, nbr, fb):
                        acks.append(lsa)
                    self._post_self_orig(area, lsa, prev_lsa, self_net_iface)
                    continue
                fb = self._install_and_flood(
                    area, lsa, from_iface=iface, from_nbr=nbr
                )
                if self._ack_wanted(iface, nbr, fb):
                    acks.append(lsa)
            elif lsa.key in nbr.ls_request:
                # §13 (4)... actually handled via request list below.
                self._nbr_event(iface.name, pkt.router_id, NsmEvent.BAD_LS_REQ)
                return
            elif cur is not None and lsa.compare(cur.lsa) == 0:
                # Duplicate: implied ack if on rxmt list, else direct ack.
                if lsa.key in nbr.ls_rxmt:
                    nbr.ls_rxmt.pop(lsa.key, None)
                else:
                    self._send(iface, nbr.src, LsAck([lsa]), area)
            else:
                # DB copy is newer: send it back directly (§13 (8)).
                self._send(
                    iface,
                    nbr.src,
                    LsUpdate(
                        [self._aged_copy(cur, iface.config.transmit_delay)]
                    ),
                    area,
                )
            # Fulfilled request?
            if lsa.key in nbr.ls_request:
                req = nbr.ls_request[lsa.key]
                if lsa.compare(req) >= 0:
                    del nbr.ls_request[lsa.key]
        if acks:
            # §13.5 delayed-ack destination: AllSPFRouters on p2p and from
            # DR/BDR; AllDRouters (modeled as the DR address) otherwise.
            if (
                iface.config.if_type
                in (IfType.POINT_TO_POINT, IfType.VIRTUAL_LINK)
                or iface.is_dr_or_bdr()
            ):
                ack_dst = ALL_SPF_RTRS_V4
            else:
                ack_dst = iface.dr if int(iface.dr) else nbr.src
            self._send(iface, ack_dst, LsAck(acks), area)
        if nbr.state == NsmState.LOADING and not nbr.ls_request:
            self._nbr_event(iface.name, pkt.router_id, NsmEvent.LOADING_DONE)
        elif nbr.state == NsmState.LOADING:
            self._send_ls_request(area, iface, nbr)

    @staticmethod
    def _ack_wanted(iface: OspfInterface, nbr: Neighbor, flooded_back: bool) -> bool:
        """§13.5 (5.e) delayed-ack condition (events.rs:941-947): no ack
        when the LSA was flooded back out the receiving interface, and a
        Backup DR only acks what arrived from the DR."""
        if flooded_back:
            return False
        return (
            iface.state != IsmState.BACKUP or nbr.src == iface.dr
        )

    def _rx_ls_ack(self, area: Area, iface: OspfInterface, src: IPv4Address, pkt: Packet) -> None:
        nbr = iface.neighbors.get(pkt.router_id)
        if nbr is None or nbr.state < NsmState.EXCHANGE:
            return
        for hdr in pkt.body.lsa_headers:
            cur = nbr.ls_rxmt.get(hdr.key)
            # Same-instance acks only (§13.7) — the reference's exact rule.
            if cur is not None and hdr.compare(cur) == 0:
                del nbr.ls_rxmt[hdr.key]

    # ----- flooding (§13.3)

    def _install_and_flood(
        self, area: Area, lsa: Lsa, from_iface=None, from_nbr=None, only_iface=None
    ) -> bool:
        """Installs and floods; returns the §13.5 flooded-back flag (see
        _flood)."""
        if lsa.type == LsaType.AS_EXTERNAL and area.stub:
            return False  # §3.6: stub areas refuse AS-external LSAs
        now = self.loop.clock.now()
        old = area.lsdb.get(lsa.key)
        _, changed = area.lsdb.install(lsa, now)
        if lsa.type == LsaType.OPAQUE_LINK:
            # Operational state groups type-9s under their link: remember
            # which interface each one belongs to (arrival interface for
            # received copies, the pinned tx interface for our own).
            owner = only_iface or from_iface
            if owner is not None:
                self._link_scope_iface[lsa.key] = owner.name
        # Our OWN summary LSAs never trigger route recalculation — they
        # are derived FROM the routes (reference lsdb.rs:465-469).
        self_orig_summary = (
            lsa.adv_rtr == self.config.router_id
            and lsa.type
            in (LsaType.SUMMARY_NETWORK, LsaType.SUMMARY_ROUTER)
        )
        if changed and not self_orig_summary:
            # Old body rides along: a mask change moves the prefix, and
            # the partial run must reconsider BOTH the old and the new
            # prefix or the withdrawn one keeps a stale route.
            self._schedule_spf(
                trigger=(lsa, old.lsa if old is not None else None)
            )
        if lsa.adv_rtr != self.config.router_id:
            self._maybe_enter_gr_helper(area, lsa)
        # A changed topology-information LSA terminates every open helper
        # window (strict-LSA-checking, reference lsdb.rs:472-482).
        if changed and lsa.type in (
            LsaType.ROUTER,
            LsaType.NETWORK,
            LsaType.SUMMARY_NETWORK,
            LsaType.SUMMARY_ROUTER,
            LsaType.AS_EXTERNAL,
            LsaType.NSSA_EXTERNAL,
        ):
            for a2 in self.areas.values():
                for i2 in a2.interfaces.values():
                    for n2 in i2.neighbors.values():
                        if n2.gr_deadline is not None:
                            self.gr_helper_exit(
                                a2, i2, n2, "topology-changed"
                            )
        if lsa.type == LsaType.AS_EXTERNAL and changed and len(self.areas) > 1:
            self._propagate_external(area, lsa)
        # Link-local opaque LSAs (type 9) never leave their link
        # (RFC 5250 §3): received copies re-flood ONLY on the receiving
        # interface (other neighbors on the same segment still need them —
        # e.g. a Grace-LSA on a broadcast link); self-originated ones go
        # out on the originating interface only.
        if lsa.type == LsaType.OPAQUE_LINK and only_iface is None:
            if from_iface is None:
                return False
            only_iface = from_iface
        # MaxAge copies STAY installed (marked maxage in operational
        # state, invisible to SPF) until the rxmt lists drain — the
        # RFC 2328 §14 removal condition, swept from the age tick.
        return self._flood(area, lsa, from_iface, from_nbr, only_iface=only_iface)

    def _flood(
        self, area: Area, lsa: Lsa, from_iface=None, from_nbr=None, only_iface=None
    ) -> bool:
        """Returns True if the LSA was flooded back out the RECEIVING
        interface — the §13.5 'flooded back' condition that suppresses
        the delayed acknowledgment (reference events.rs:941-947)."""
        flooded_back = False
        for iface in area.interfaces.values():
            if iface.state == IsmState.DOWN:
                continue
            if only_iface is not None and iface is not only_iface:
                continue
            if iface.config.if_type == IfType.VIRTUAL_LINK and lsa.type in (
                LsaType.AS_EXTERNAL,
                LsaType.OPAQUE_AS,
            ):
                # AS-scope LSAs never cross virtual links (reference
                # lsdb.rs:74-83; the transit area's own flooding carries
                # them).
                continue
            flood_it = False
            for nbr in iface.neighbors.values():
                if nbr.state < NsmState.EXCHANGE:
                    continue
                if nbr.state in (NsmState.EXCHANGE, NsmState.LOADING):
                    req = nbr.ls_request.get(lsa.key)
                    if req is not None:
                        c = lsa.compare(req)
                        if c < 0:
                            continue
                        del nbr.ls_request[lsa.key]
                        if c == 0:
                            continue
                if from_nbr is not None and nbr is from_nbr:
                    continue
                nbr.ls_rxmt[lsa.key] = lsa
                flood_it = True
                self._arm_rxmt(iface, nbr)
            if not flood_it:
                continue
            if iface is from_iface and from_nbr is not None:
                # §13.3 (3): received on this iface from DR/BDR → skip send.
                if from_nbr.src in (iface.dr, iface.bdr):
                    continue
                # §13.3 (4): the Backup DR defers to the DR's re-flood.
                if iface.state == IsmState.BACKUP:
                    continue
            if iface is from_iface:
                flooded_back = True
            self._send(
                iface,
                ALL_SPF_RTRS_V4,
                LsUpdate([self._tx_copy(lsa, iface.config.transmit_delay)]),
                area,
            )
        return flooded_back

    def _arm_rxmt(self, iface: OspfInterface, nbr: Neighbor) -> None:
        t = self._timer(
            ("rxmt", iface.name, nbr.router_id),
            lambda: RxmtTimerMsg(iface.name, nbr.router_id),
        )
        if not t.armed:
            t.start(iface.config.rxmt_interval)

    def _rxmt(self, ifname: str, nbr_id: IPv4Address) -> None:
        ai = self._iface(ifname)
        if ai is None:
            return
        area, iface = ai
        nbr = iface.neighbors.get(nbr_id)
        if nbr is None:
            return
        resent = False
        if nbr.state == NsmState.EX_START or (
            nbr.state == NsmState.EXCHANGE and nbr.master
        ):
            if nbr.last_sent_dd is not None:
                self._send(iface, nbr.src, nbr.last_sent_dd, area)
                resent = True
        if nbr.state == NsmState.LOADING and nbr.ls_request:
            self._send_ls_request(area, iface, nbr)
            resent = True
        if resent or nbr.ls_rxmt:
            _OSPF_RETRANSMITS.labels(instance=self.name).inc()
        if nbr.ls_rxmt:
            lsas = [
                self._tx_copy(l, iface.config.transmit_delay)
                for l in list(nbr.ls_rxmt.values())[:20]
            ]
            self._send(iface, nbr.src, LsUpdate(lsas), area)
        if (
            nbr.state in (NsmState.EX_START, NsmState.EXCHANGE, NsmState.LOADING)
            or nbr.ls_rxmt
        ):
            self._arm_rxmt(iface, nbr)

    # ----- origination

    def _originate(
        self,
        area: Area,
        ltype: LsaType,
        lsid: IPv4Address,
        body,
        allow_in_gr: bool = False,
        only_iface=None,
        options: Options | None = None,
        force: bool = False,
    ) -> None:
        if options is None:
            # Area-default LSA options (reference area_options): stub
            # areas clear the E-bit on everything originated into them.
            options = Options(0) if area.stub else Options.E
        if self.gr_restarting and not allow_in_gr:
            return  # RFC 3623 §2.2: no origination until resync completes
        if getattr(self, "_shutting_down", False):
            return  # teardown in progress: nothing new goes out
        key = LsaKey(ltype, lsid, self.config.router_id)
        old = area.lsdb.get(key)
        lsa = Lsa(
            age=0,
            options=options,
            type=ltype,
            lsid=lsid,
            adv_rtr=self.config.router_id,
            seq_no=next_seq_no(old.lsa if old else None),
            body=body,
        )
        lsa.encode()
        if (
            not force
            and old is not None
            and not old.lsa.is_maxage
            and old.lsa.raw[20:] == lsa.raw[20:]
            and old.lsa.options == options
        ):
            # Unchanged content AND header options (the NSSA P-bit lives
            # in the header): no re-origination needed.  A MaxAge copy
            # (mid-flush) never suppresses: wanting the LSA again after a
            # premature age requires a fresh instance (§12.4/14.1).
            return
        self._install_and_flood(area, lsa, only_iface=only_iface)

    def _flush_self_lsa(self, area: Area, key: LsaKey, only_iface=None) -> None:
        e = area.lsdb.get(key)
        if e is None:
            return
        if e.lsa.is_maxage:
            # Already being flushed — never flush the same LSA twice
            # (reference lsdb.rs flush(): early-return on is_maxage).
            return
        import copy

        lsa = copy.copy(e.lsa)
        lsa.age = MAX_AGE
        if lsa.raw:
            raw = bytearray(lsa.raw)
            raw[0:2] = MAX_AGE.to_bytes(2, "big")
            lsa.raw = bytes(raw)
        self._install_and_flood(area, lsa, only_iface=only_iface)

    def refresh_lsa(self, area_id: IPv4Address, key: LsaKey) -> None:
        """LSRefreshTime: re-originate a self LSA with a fresh sequence
        number (also driven by the age machinery in _age_tick)."""
        area = self.areas.get(area_id)
        if area is None:
            return
        e = area.lsdb.get(key)
        if e is None or e.lsa.adv_rtr != self.config.router_id:
            return
        lsa = Lsa(
            age=0,
            options=e.lsa.options,
            type=e.lsa.type,
            lsid=e.lsa.lsid,
            adv_rtr=e.lsa.adv_rtr,
            seq_no=next_seq_no(e.lsa),
            body=e.lsa.body,
        )
        lsa.encode()
        self._install_and_flood(area, lsa)

    def _iface_by_addr(self, addr: IPv4Address):
        for area in self.areas.values():
            for iface in area.interfaces.values():
                if iface.addr_ip == addr:
                    return iface
        return None

    def _post_self_orig(
        self, area: Area, received: Lsa, prev: Lsa | None, net_iface
    ) -> None:
        """§13.4 per-type disposition after flooding the received copy
        (mirrors the reference's process_self_originated_lsa,
        holo-ospf/src/ospfv2/lsdb.rs:975-1035)."""
        if self.gr_restarting:
            return  # adopt the pre-restart copy until resync completes
        t = received.type
        if t == LsaType.ROUTER:
            # Force: the received copy is already installed, so a content
            # comparison would wrongly suppress the outpacing origination.
            self._originate_router_lsa(area, force=True)
        elif t == LsaType.NETWORK:
            # Still DR for the network under the current router-id?
            if (
                net_iface is not None
                and net_iface.is_dr()
                and received.adv_rtr == self.config.router_id
            ):
                self._originate_network_lsa(area, net_iface, force=True)
            else:
                self._flush_self_lsa(area, received.key)
        elif t in (LsaType.SUMMARY_NETWORK, LsaType.SUMMARY_ROUTER):
            pass  # the next SPF run re-originates or flushes summaries
        elif t in (LsaType.AS_EXTERNAL, LsaType.NSSA_EXTERNAL):
            prefix = IPv4Network(
                (int(received.lsid), bin(int(received.body.mask)).count("1")),
                strict=False,
            )
            cur_lsid = self._external_lsids.get(prefix)
            if prefix in self.redistributed:
                self._originate_external(prefix, force=True)
                if cur_lsid is not None and cur_lsid != received.lsid:
                    # Appendix-E drift: the echo came back under a stale
                    # link-state id; the fresh origination used the current
                    # one, so the stale copy must not linger.
                    self._flush_self_lsa(area, received.key)
            else:
                self._flush_self_lsa(area, received.key)
        elif prev is not None:
            # Opaque and friends: outpace with our previous content.
            lsa = Lsa(
                age=0,
                options=prev.options,
                type=prev.type,
                lsid=prev.lsid,
                adv_rtr=prev.adv_rtr,
                seq_no=received.seq_no + 1,
                body=prev.body,
            )
            lsa.encode()
            self._install_and_flood(area, lsa)
        else:
            self._flush_self_lsa(area, received.key)

    def _nbr_counts_full(self, nbr: Neighbor) -> bool:
        """FULL, or in an open graceful-restart helper window — the helper
        keeps advertising the adjacency while the neighbor restarts
        (RFC 3623 §3.1)."""
        if nbr.state == NsmState.FULL:
            return True
        return (
            nbr.gr_deadline is not None
            and self.loop.clock.now() < nbr.gr_deadline
        )

    # -- deferred origination checks (reference lsdb.rs:589-660)

    def _queue_check(self, key: tuple, **kwargs) -> None:
        """Reference semantics (lsdb.rs:589-660): originations are deferred
        originate-check messages processed later by the instance loop.
        Production (external_orig_checks=False) runs them inline; the
        conformance harness defers them to the recorded LsaOrigCheck
        positions via flush_orig_checks — it drives the *cadence* (when
        the reference rebuilt and whether it bumped the sequence number)
        from the recording while the LSA *content* always comes from our
        own state."""
        if self.config.external_orig_checks:
            self._pending_checks[key] = kwargs
        else:
            self._run_check(key, self._build_check(key), **kwargs)

    def flush_orig_checks(
        self,
        kind: str | None = None,
        area_id: IPv4Address | None = None,
        force: bool = False,
    ) -> None:
        """Run deferred origination checks against CURRENT state.

        With ``kind`` (a recorded LsaOrigCheck position, ``area_id`` from
        its recorded lsdb_key): rebuild that LSA class in that area now.
        ``force=True`` replays a position where the reference's recorded
        body changed — the sequence number advances even when our content
        is unchanged, keeping our instance count aligned with the
        recorded ack stream.  Without ``kind`` (end-of-step quiescence):
        drain everything pending normally."""
        if kind is None:
            pending, self._pending_checks = self._pending_checks, {}
            for key, kwargs in pending.items():
                self._run_check(key, self._build_check(key), **kwargs)
            return
        keys = [
            k
            for k in self._pending_checks
            if k[0] == kind and (area_id is None or k[1] == area_id)
        ]
        if not keys:
            # The reference re-originated here from a trigger we never
            # raised: rebuild from current state so the LSDB keeps pace.
            keys = self._fallback_check_keys(kind, area_id)
        for key in keys:
            kwargs = self._pending_checks.pop(key, {})
            if force:
                kwargs = {**kwargs, "force": True}
            self._run_check(key, self._build_check(key), **kwargs)

    def _fallback_check_keys(
        self, kind: str, area_id: IPv4Address | None = None
    ):
        """Plausible check keys when a recorded check has no queued match:
        one per area (router/RI) or per DR interface (network), narrowed
        to the recorded check's area when known.  A named area we don't
        have (yet) yields nothing — widening to every area would
        force-bump unrelated LSAs."""
        if area_id is not None and area_id not in self.areas:
            return []
        aids = [area_id] if area_id is not None else list(self.areas)
        if kind in ("router", "ri"):
            return [(kind, aid) for aid in aids]
        if kind == "network":
            return [
                ("network", aid, iface.name)
                for aid in aids
                for iface in self.areas[aid].interfaces.values()
                if iface.is_dr()
            ]
        return []

    def _build_check(self, key: tuple):
        """Build the LSA body for a queued check from CURRENT state."""
        kind = key[0]
        area = self.areas.get(key[1])
        if area is None:
            return _CHECK_SKIP
        if kind == "router":
            return self._build_router_lsa(area)
        if kind == "network":
            iface = area.interfaces.get(key[2])
            if iface is None:
                return _CHECK_SKIP
            return self._build_network_lsa(area, iface)
        if kind == "ri":
            return self._build_router_info(area)
        return _CHECK_SKIP

    def _run_check(self, key: tuple, body, **kwargs) -> None:
        kind = key[0]
        area = self.areas.get(key[1])
        if area is None or body is _CHECK_SKIP:
            return
        if kind == "router":
            self._originate(
                area, LsaType.ROUTER, self.config.router_id, body, **kwargs
            )
        elif kind == "network":
            iface = area.interfaces.get(key[2])
            if iface is None:
                return
            if body is None:
                lkey = LsaKey(
                    LsaType.NETWORK, iface.addr_ip, self.config.router_id
                )
                if area.lsdb.get(lkey) is not None:
                    self._flush_self_lsa(area, lkey)
            else:
                self._originate(
                    area, LsaType.NETWORK, iface.addr_ip, body, **kwargs
                )
        elif kind == "ri":
            opts = Options(0) if area.no_type5 else Options.E
            self._originate(
                area, LsaType.OPAQUE_AREA, body[0], body[1],
                options=opts, **kwargs
            )

    def _originate_router_lsa(self, area: Area, force: bool = False) -> None:
        self._queue_check(("router", area.area_id), force=force)

    def _originate_network_lsa(
        self, area: Area, iface: OspfInterface, force: bool = False
    ) -> None:
        self._queue_check(("network", area.area_id, iface.name), force=force)

    def _originate_router_info(self, area: Area) -> None:
        self._queue_check(("ri", area.area_id))

    def _build_router_lsa(self, area: Area) -> "LsaRouter":
        links: list[RouterLink] = []
        # RFC 6987 stub-router: transit-traffic links (p2p, transit,
        # vlink) advertise MaxLinkMetric so neighbors route around us;
        # stub links keep their real cost so our own prefixes stay
        # reachable (maintenance mode).
        def transit_cost(cost: int) -> int:
            return MAX_LINK_METRIC if self.config.stub_router else cost

        # Real interfaces first, loopback host routes last (matches the
        # reference's router-LSA build order).
        ifaces = sorted(
            area.interfaces.values(), key=lambda i: i.config.loopback
        )
        for iface in ifaces:
            if iface.config.if_type == IfType.VIRTUAL_LINK:
                # §12.4.1.3: a type-4 link for each FULL virtual-link
                # neighbor, link data = our vlink interface address,
                # metric = the transit area's current path cost.
                if iface.state == IsmState.DOWN:
                    continue
                for nbr in iface.neighbors.values():
                    if self._nbr_counts_full(nbr):
                        links.append(
                            RouterLink(
                                RouterLinkType.VIRTUAL_LINK,
                                nbr.router_id,
                                iface.addr_ip,
                                transit_cost(iface.config.cost),
                            )
                        )
                continue
            if iface.state == IsmState.DOWN or iface.prefix is None:
                continue
            cost = iface.config.cost
            if iface.config.loopback:
                # Host route for the loopback address, zero cost.
                links.append(
                    RouterLink(
                        RouterLinkType.STUB_NETWORK,
                        iface.addr_ip,
                        IPv4Address("255.255.255.255"),
                        0,
                    )
                )
                continue
            if iface.config.if_type == IfType.POINT_TO_POINT:
                for nbr in iface.neighbors.values():
                    if self._nbr_counts_full(nbr):
                        links.append(
                            RouterLink(RouterLinkType.POINT_TO_POINT,
                                       nbr.router_id, iface.addr_ip,
                                       transit_cost(cost))
                        )
                links.append(
                    RouterLink(RouterLinkType.STUB_NETWORK,
                               iface.prefix.network_address,
                               mask_of(iface.prefix), cost)
                )
            else:
                dr_full = any(
                    self._nbr_counts_full(n) and n.src == iface.dr
                    for n in iface.neighbors.values()
                )
                we_are_dr_with_full = iface.is_dr() and any(
                    self._nbr_counts_full(n) for n in iface.neighbors.values()
                )
                if iface.state >= IsmState.DR_OTHER and (dr_full or we_are_dr_with_full):
                    links.append(
                        RouterLink(RouterLinkType.TRANSIT_NETWORK,
                                   iface.dr, iface.addr_ip,
                                   transit_cost(cost))
                    )
                else:
                    links.append(
                        RouterLink(RouterLinkType.STUB_NETWORK,
                                   iface.prefix.network_address,
                                   mask_of(iface.prefix), cost)
                    )
            for extra in iface.secondary:
                links.append(
                    RouterLink(RouterLinkType.STUB_NETWORK,
                               extra.network_address, mask_of(extra), cost)
                )
        flags = RouterFlags(0)
        if self.is_abr:
            flags |= RouterFlags.B
        if self.is_asbr:
            flags |= RouterFlags.E
        # §12.4.1: the V bit marks this area as the transit area of a
        # FULLY ADJACENT virtual link of ours.
        backbone = self.areas.get(IPv4Address(0))
        if backbone is not None:
            for taid, rid in self.config.virtual_links:
                if taid != area.area_id:
                    continue
                vl = backbone.interfaces.get(f"vlink-{taid}-{rid}")
                if vl is not None and any(
                    self._nbr_counts_full(n)
                    for n in vl.neighbors.values()
                ):
                    flags |= RouterFlags.V
                    break
        return LsaRouter(flags=flags, links=links)

    def _build_network_lsa(self, area: Area, iface: OspfInterface):
        """Network-LSA body for the deferred-check queue, or None when the
        LSA should be withdrawn (not DR / no full neighbors)."""
        full = [n.router_id for n in iface.neighbors.values()
                if self._nbr_counts_full(n)]
        if iface.is_dr() and full and iface.prefix is not None:
            return LsaNetwork(
                mask=mask_of(iface.prefix),
                attached=sorted([self.config.router_id] + full, key=int),
            )
        return None

    # ----- aging / refresh

    def _age_tick(self) -> None:
        now = self.loop.clock.now()
        for area in self.areas.values():
            for e in area.lsdb.refresh_due(now, self.config.router_id):
                lsa = Lsa(
                    age=0,
                    options=e.lsa.options,
                    type=e.lsa.type,
                    lsid=e.lsa.lsid,
                    adv_rtr=e.lsa.adv_rtr,
                    seq_no=next_seq_no(e.lsa),
                    body=e.lsa.body,
                )
                lsa.encode()
                self._install_and_flood(area, lsa)
            for key in area.lsdb.maxage_keys(now):
                e = area.lsdb.get(key)
                if not e.lsa.is_maxage:
                    # Newly expired: flood the MaxAge copy once (§14).
                    lsa = self._aged_copy(e)
                    self._install_and_flood(area, lsa)
                elif not self._maxage_referenced(area, key):
                    # §14 removal: no rxmt holds it and no neighbor is
                    # mid-exchange — the MaxAge copy leaves the database.
                    area.lsdb.remove(key)
                    self._link_scope_iface.pop(key, None)
        self._age_timer.start(AGE_TICK)

    def _maxage_referenced(self, area: Area, key: LsaKey) -> bool:
        for iface in area.interfaces.values():
            for nbr in iface.neighbors.values():
                if key in nbr.ls_rxmt or nbr.state in (
                    NsmState.EXCHANGE,
                    NsmState.LOADING,
                ):
                    return True
        return False

    # ----- SPF scheduling (RFC 8405 delay FSM)

    def _schedule_spf(self, trigger=None) -> None:
        """RFC 8405 SPF delay FSM (reference holo-ospf/src/spf.rs:295-484):
        QUIET→SHORT_WAIT on first IGP event (initial_delay); further events
        in SHORT_WAIT use short_delay until time_to_learn expires, then
        LONG_WAIT uses long_delay; HOLDDOWN quiet time returns to QUIET.

        ``trigger`` is the changed LSA when the event is an LSDB install;
        a trigger-less call (config/interface/clear events) marks the next
        run as unconditionally full (spf.rs:511-516 force_full_run)."""
        if trigger is None:
            self._spf_force_full = True
        else:
            self._spf_triggers.append(trigger)
        # Convergence observatory: stamp the causal event at its origin
        # (an LSA install or a trigger-less config/interface event) —
        # or inherit the already-active ids when this schedule is part
        # of a larger causal chain.  Pending ids drain at the SPF run
        # the delay FSM coalesces them into (shared contract:
        # convergence.pend_schedule / convergence.spf_run).
        convergence.pend_schedule(
            self._conv_pending,
            convergence.TRIGGER_LSA
            if trigger is not None
            else convergence.TRIGGER_IFCONFIG,
            instance=self.name,
        )
        cfg = self.config.spf
        now = self.loop.clock.now()
        self._spf_trigger_count += 1
        if self._spf_scheduled_at is None:
            self._spf_scheduled_at = now
        if self._spf_timer is None:
            self._spf_timer = self.loop.timer(self.name, SpfDelayTimerMsg)
        if self._hold_timer is None:
            self._hold_timer = self.loop.timer(self.name, SpfHoldDownMsg)
        self._hold_timer.start(cfg.hold_down)  # reset on every IGP event
        if self.spf_state == SpfFsmState.QUIET:
            self._learn_deadline = now + cfg.time_to_learn
            self.spf_state = SpfFsmState.SHORT_WAIT
            self._spf_timer.start(cfg.initial_delay)
        elif self.spf_state == SpfFsmState.SHORT_WAIT:
            if now >= (self._learn_deadline or 0):
                self.spf_state = SpfFsmState.LONG_WAIT
                self._spf_timer.start(cfg.long_delay)
            elif not self._spf_timer.armed:
                self._spf_timer.start(cfg.short_delay)
        elif self.spf_state == SpfFsmState.LONG_WAIT:
            if not self._spf_timer.armed:
                self._spf_timer.start(cfg.long_delay)

    def _spf_timer_fired(self) -> None:
        self.run_spf()

    def _spf_holddown_fired(self) -> None:
        self.spf_state = SpfFsmState.QUIET
        self._learn_deadline = None

    # ----- SPF execution + route programming

    @property
    def is_abr(self) -> bool:
        """Area border router: interfaces in more than one active area."""
        active = [
            a
            for a in self.areas.values()
            if any(i.state != IsmState.DOWN for i in a.interfaces.values())
        ]
        return len(active) > 1

    def _classify_spf(self, triggers: list) -> dict | None:
        """Full-vs-partial trigger classification (reference
        holo-ospf/src/ospfv2/spf.rs:99-171).  Returns None when a full
        SPF is required (topology changed), else the partial sets.

        Router/Network-LSA changes are topological; Opaque changes
        (RI/SR ext-prefix/ext-link) also force full because SR label
        derivation depends on them (the reference makes the same
        simplification).  Link-local opaques (Grace) never affect
        routes.  Summaries and externals are prefix-scoped."""
        from holo_tpu_torch.utils.ip import apply_mask

        inter_network: set = set()
        inter_router: set = set()
        external: set = set()
        for new, old in triggers:
            t = new.type
            if t in (
                LsaType.ROUTER,
                LsaType.NETWORK,
                LsaType.OPAQUE_AREA,
                LsaType.OPAQUE_AS,
            ):
                return None
            if t == LsaType.OPAQUE_LINK:
                continue  # Grace-LSAs carry no routing information
            # Both versions contribute prefixes: a mask change moves the
            # prefix and the OLD one must drop its route too.
            if t == LsaType.SUMMARY_NETWORK:
                for lsa in (new, old):
                    if lsa is not None:
                        inter_network.add(apply_mask(lsa.lsid, lsa.body.mask))
            elif t == LsaType.SUMMARY_ROUTER:
                inter_router.add(new.lsid)
            elif t in (LsaType.AS_EXTERNAL, LsaType.NSSA_EXTERNAL):
                for lsa in (new, old):
                    if lsa is not None:
                        external.add(apply_mask(lsa.lsid, lsa.body.mask))
            else:
                return None  # unknown type: be safe, run full
        return {
            "inter_network": inter_network,
            "inter_router": inter_router,
            "external": external,
        }

    def run_spf(self) -> None:
        # Pending causal ids drain into an active context: route
        # publishes to the RIB (ibus requests / marshalled route_cb)
        # capture them, so the event rides through to the FIB commit.
        with convergence.spf_run(self._conv_pending, self.name):
            with telemetry.span("ospf.spf", instance=self.name):
                self._run_spf_traced()

    def _run_spf_traced(self) -> None:
        now = self.loop.clock.now()
        self.spf_run_count += 1
        start_time = now
        scheduled_at = self._spf_scheduled_at
        triggers = self._spf_trigger_count
        self._spf_scheduled_at = None
        self._spf_trigger_count = 0
        trigger_lsas = self._spf_triggers
        self._spf_triggers = []
        force_full = self._spf_force_full
        self._spf_force_full = False
        partial = None if force_full else self._classify_spf(trigger_lsas)
        if partial is not None and self._spf_cache is not None:
            _OSPF_SPF_RUNS.labels(instance=self.name, type="partial").inc()
            self._run_spf_partial(partial, scheduled_at, triggers, start_time)
            return
        _OSPF_SPF_RUNS.labels(instance=self.name, type="full").inc()
        all_routes = {}
        area_intra: dict[IPv4Address, dict] = {}
        area_results: dict[IPv4Address, tuple] = {}
        # Backbone last: its SPF consumes transit-area results for virtual
        # links (§16.1 — vlink next hops come from the transit area).
        # The vlink sync sits between the two passes: it may CREATE the
        # backbone area (a router whose only area-0 attachment is the
        # vlink itself) before the backbone pass runs.
        ordered_areas = sorted(
            self.areas.values(), key=lambda a: int(a.area_id) == 0
        )
        if self.config.virtual_links:
            ordered_areas = [
                a for a in ordered_areas if int(a.area_id) != 0
            ] + ["_vlink_sync"]
        for area in ordered_areas:
            if area == "_vlink_sync":
                self._sync_virtual_links(area_results, now)
                # Backbone pass — the sync may have just created area 0.
                ordered_areas += [
                    a for a in self.areas.values() if int(a.area_id) == 0
                ]
                continue
            iface_by_addr = {
                i.addr_ip: i.name for i in area.interfaces.values() if i.addr_ip
            }
            iface_by_nbr = {}
            p2p_nbr_addr = {}
            for i in area.interfaces.values():
                for nbr in i.neighbors.values():
                    if nbr.state == NsmState.FULL:
                        iface_by_nbr[nbr.router_id] = (i.name, nbr.src)
                        p2p_nbr_addr[(i.name, nbr.router_id)] = nbr.src
            iface_by_ifindex = {
                i.ifindex: i.name
                for i in area.interfaces.values()
                if i.ifindex
            }
            vlink_nexthops = None
            if int(area.area_id) == 0:
                vlink_nexthops = self._vlink_nexthops(area, area_results, now)
            # Interface fast-reroute SRLG config -> Topology.edge_srlg
            # (the FRR srlg_disjoint policy input).
            from holo_tpu_torch.protocols.ospf.spf_run import srlg_bits

            iface_srlg = {
                i.name: srlg_bits(i.config.srlg)
                for i in area.interfaces.values()
                if i.config.srlg
            }
            st = build_topology(
                area.lsdb, self.config.router_id, now, iface_by_addr,
                iface_by_nbr, p2p_nbr_addr, iface_by_ifindex,
                vlink_nexthops, iface_srlg=iface_srlg,
                partition_of=self.spf_partition_of,
            )
            if st is None:
                self._spf_delta_bases.pop(area.area_id, None)
                continue
            # DeltaPath seam: diff against the previous run's marshaled
            # topology so the backend can update the device-resident
            # graph in place instead of re-marshaling the area LSDB.
            link_spf_delta(self._spf_delta_bases.get(area.area_id), st)
            self._spf_delta_bases[area.area_id] = st
            res = self.backend.compute(
                st.topo, multipath_k=self._multipath_k()
            )
            area_results[area.area_id] = (st, res)
            # Reachable routers per area WITH their flags as of this SPF
            # run: operational state serves abr-count/asbr-count from the
            # SPF products (reference area.rs:164-182 counts
            # area.state.routers, whose flags were captured at route
            # computation — NOT the live LSDB, which may have changed
            # since, e.g. right after a clear-database RPC).
            from holo_tpu_torch.ops.graph import INF as _INF

            flags_now = {}
            for key, e in area.lsdb.entries.items():
                if key.type == LsaType.ROUTER and not e.lsa.is_maxage:
                    flags_now[key.adv_rtr] = e.lsa.body.flags
            self._area_reachable_routers[area.area_id] = {
                rid: flags_now.get(rid, RouterFlags(0))
                for rid, v in st.router_index.items()
                if res.dist[v] < _INF
            }
            intra = derive_routes(
                st, res, area.lsdb, now, area.area_id,
                max_paths=self.config.max_paths,
            )
            area_intra[area.area_id] = intra
            for prefix, route in intra.items():
                cur = all_routes.get(prefix)
                if cur is None or route.dist < cur.dist or (
                    route.dist == cur.dist and int(route.area_id) < int(cur.area_id)
                ):
                    all_routes[prefix] = route

        # IP-FRR: one batched backup-table dispatch per area right after
        # the primary SPF (the reference hangs TI-LFA off the same
        # moment) — all-roots distance matrix + per-link post-convergence
        # planes + vectorized LFA/rLFA/TI-LFA selection.
        engine = self._frr_engine_for()
        if engine is not None:
            self.frr_tables = {
                aid: engine.compute(st.topo)
                for aid, (st, _res) in area_results.items()
            }
        else:
            self.frr_tables = {}

        # Advisory what-if batches ride the async pipeline;
        # enqueue-only — nothing here waits on them.
        self._enqueue_whatif_advisory(area_results)

        # Inter-area routes (RFC 2328 §16.2): shared consumption stage
        # (also used by the partial run with a prefix scope).
        intra_prefixes = set(all_routes.keys())
        inter_routes: dict = {}
        self._derive_inter_area(
            area_results, all_routes, inter_routes, intra_prefixes
        )

        # ABR: (re-)originate Summary LSAs — each area's intra routes are
        # advertised into every other attached area (loop-free: summaries
        # are never derived from summaries).
        # AS-external routes (lowest preference — only for unknown prefixes).
        for prefix, route in self._external_routes(
            area_results, set(all_routes.keys())
        ).items():
            all_routes[prefix] = route

        self._nssa_translate(area_results)
        if self.is_abr:
            self._originate_summaries(area_intra, inter_routes)
            self._originate_asbr_summaries(area_results)
        else:
            # No longer (or never) an ABR: flush any self-originated
            # summaries or neighbors would route into a dead hierarchy
            # forever (refresh would keep them alive otherwise).
            for area in self.areas.values():
                for key in list(area.lsdb.entries):
                    if (
                        key.type == LsaType.SUMMARY_NETWORK
                        and key.adv_rtr == self.config.router_id
                        and not area.lsdb.entries[key].lsa.is_maxage
                    ):
                        self._flush_self_lsa(area, key)

        # SPF log ring (32 entries, reference spf.rs:770-804).
        self.spf_log.append(
            {
                "run": self.spf_run_count,
                "type": "full",
                "backend": self.backend.name,
                "scheduled-at": scheduled_at,
                "start-time": start_time,
                "end-time": self.loop.clock.now(),
                "trigger-count": triggers,
                "route-count": len(all_routes),
            }
        )
        del self.spf_log[:-32]

        # Cache this run's products: a later summary/external-only change
        # reuses the per-area SPTs and rewrites only the affected table
        # entries (reference route.rs:200-333 update_rib_partial).
        self._spf_cache = {
            "area_results": area_results,
            "area_intra": area_intra,
            "routes": all_routes,
            "inter_routes": inter_routes,
        }

        self._finish_spf(all_routes)

    def _derive_inter_area(
        self,
        area_results: dict,
        routes: dict,
        inter_routes: dict,
        intra_prefixes: set,
        only: set | None = None,
    ) -> bool:
        """Summary-LSA consumption (RFC 2328 §16.2): distance to the
        advertising ABR from the cached/current SPT plus the advertised
        metric; intra-area always preferred, inter-area displaces
        externals (path-type preference, §11).  Shared by the full and
        partial runs — ``only`` scopes a partial run to the changed
        prefixes.  Returns whether anything changed."""
        from holo_tpu_torch.protocols.ospf.spf_run import IntraRoute, _atoms_of
        from holo_tpu_torch.utils.ip import apply_mask

        now = self.loop.clock.now()
        changed = False
        for area in self.areas.values():
            sr = area_results.get(area.area_id)
            if sr is None:
                continue
            st, res = sr
            for e in area.lsdb.all():
                lsa = e.lsa
                if (
                    lsa.type != LsaType.SUMMARY_NETWORK
                    or lsa.adv_rtr == self.config.router_id
                    or e.current_age(now) >= MAX_AGE
                ):
                    continue
                if self.is_abr and int(area.area_id) != 0:
                    # §16.2: ABRs examine backbone summaries only — transit
                    # through non-backbone areas would break the hierarchy.
                    continue
                prefix = apply_mask(lsa.lsid, lsa.body.mask)
                if only is not None and prefix not in only:
                    continue  # partial run: out-of-scope prefix
                if prefix in intra_prefixes:
                    continue  # intra-area preferred
                abr_v = st.router_index.get(lsa.adv_rtr)
                if abr_v is None or res.dist[abr_v] >= 0x40000000:
                    continue
                dist = int(res.dist[abr_v]) + lsa.body.metric
                nhs = _atoms_of(res.nexthop_words[abr_v], st.atoms)
                cur = routes.get(prefix)
                if cur is not None and cur.rtype not in ("intra", "inter"):
                    # Path-type preference, not distance: inter-area
                    # always displaces an external entry (§11).  Only
                    # reachable in partial runs — the full run computes
                    # externals after this stage.
                    cur = None
                if cur is None or dist < cur.dist:
                    # vertex = the advertising ABR: FRR protects the
                    # path toward the area-exit router (the repair
                    # covers the intra-area leg, like the reference).
                    route = IntraRoute(
                        prefix, dist, nhs, area.area_id, "inter", vertex=abr_v
                    )
                    routes[prefix] = route
                    inter_routes[prefix] = route
                    changed = True
                elif dist == cur.dist and cur.rtype == "inter":
                    # Equal-cost inter-area paths union their next hops.
                    # (area_id, vertex) is the FRR consumption key and
                    # must stay a consistent pair — keep the first
                    # contributing area's, like the v3 merge.
                    route = IntraRoute(
                        prefix, dist, cur.nexthops | nhs, cur.area_id,
                        "inter", vertex=cur.vertex,
                    )
                    routes[prefix] = route
                    inter_routes[prefix] = route
                    changed = True
        return changed

    def _run_spf_partial(
        self, partial: dict, scheduled_at, triggers: int, start_time: float
    ) -> None:
        """Prefix-scoped route recomputation over the cached SPTs —
        no Dijkstra runs (reference route.rs:200-333).

        In OSPFv2 intra-area information lives in Router/Network-LSAs,
        which always force a full run, so only the inter-area and
        external stages apply (ospfv2/spf.rs:124-126)."""
        cache = self._spf_cache
        area_results = cache["area_results"]
        area_intra = cache["area_intra"]
        routes = dict(cache["routes"])
        inter_routes = dict(cache["inter_routes"])
        now = self.loop.clock.now()
        inter_network = set(partial["inter_network"])
        inter_router = set(partial["inter_router"])
        external = set(partial["external"])

        inter_changed = False
        if inter_network:
            # Remove affected inter-area routes, then re-derive them for
            # exactly those prefixes from the cached per-area SPTs.
            removed: set = set()
            for prefix in inter_network:
                r = routes.get(prefix)
                if r is not None and r.rtype == "inter":
                    del routes[prefix]
                    inter_routes.pop(prefix, None)
                    removed.add(prefix)
            intra_prefixes = {
                p for p, r in routes.items() if r.rtype == "intra"
            }
            inter_changed = self._derive_inter_area(
                area_results, routes, inter_routes, intra_prefixes,
                only=inter_network,
            )
            # Destinations now newly unreachable fall through to the
            # external stage for alternate paths (route.rs:234-237).
            external |= {p for p in removed if p not in routes}
            inter_changed = inter_changed or bool(removed)

        if inter_router or external:
            # A type-4 change alters ASBR reachability, which can affect
            # ANY external route — re-evaluate them all (route.rs:302-306);
            # otherwise only the changed prefixes.
            reevaluate_all = bool(inter_router)
            ext_types = ("external-1", "external-2", "nssa-1", "nssa-2")
            for prefix in list(routes):
                r = routes[prefix]
                if r.rtype in ext_types and (
                    reevaluate_all or prefix in external
                ):
                    del routes[prefix]
            known = set(routes.keys())
            new_ext = self._external_routes(
                area_results,
                known,
                only=None if reevaluate_all else external,
            )
            routes.update(new_ext)
            # Type-7 changes can shift the NSSA translator's output set.
            if external and any(a.nssa for a in self.areas.values()):
                self._nssa_translate(area_results)

        # ABR summary re-origination: inter routes feed non-backbone
        # summaries, so a changed inter table re-runs origination over
        # the cached intra inputs.
        if inter_changed and self.is_abr:
            self._originate_summaries(area_intra, inter_routes)

        log_type = "inter" if inter_network else "external"
        self.spf_log.append(
            {
                "run": self.spf_run_count,
                "type": log_type,
                "backend": self.backend.name,
                "scheduled-at": scheduled_at,
                "start-time": start_time,
                "end-time": self.loop.clock.now(),
                "trigger-count": triggers,
                "route-count": len(routes),
            }
        )
        del self.spf_log[:-32]

        cache["routes"] = routes
        cache["inter_routes"] = inter_routes
        self._finish_spf(routes)

    def reoriginate_summaries(self) -> None:
        """Config-triggered summary refresh (ranges / totally-stubby /
        default-cost changed): re-run origination over the LAST SPF's
        routing inputs without recomputing routes."""
        if getattr(self, "_last_summary_inputs", None) is not None:
            self._originate_summaries(*self._last_summary_inputs)

    def _originate_summaries(self, area_intra: dict, inter_routes: dict) -> None:
        """ABR summary generation: intra-area routes of each area go into
        every other attached area; inter-area routes learned via the
        BACKBONE are re-summarized into non-backbone areas (the standard
        loop-free hierarchy, RFC 2328 §12.4.3)."""
        from holo_tpu_torch.utils.ip import mask_of

        self._last_summary_inputs = (area_intra, inter_routes)
        backbone = IPv4Address(0)
        wanted: dict[IPv4Address, dict] = {aid: {} for aid in self.areas}

        area_ifnames = {
            aid: frozenset(a.interfaces) for aid, a in self.areas.items()
        }

        def _nexthops_in_area(route, dst_aid) -> bool:
            # area.rs:628-630 split horizon: never summarize a route
            # into the area its next hops already exit through (the
            # vlink-transit case).
            names = area_ifnames.get(dst_aid, frozenset())
            return any(
                nh.ifname in names
                for nh in getattr(route, "nexthops", ())
                if nh.ifname is not None
            )
        for src_aid, routes in area_intra.items():
            if src_aid not in self.areas:
                continue  # area deleted since that SPF ran
            # Area address ranges (§12.4.3 / Appendix C.2): components of
            # an active advertised range aggregate into the range prefix
            # at the max component distance (or its configured cost);
            # advertise=false ranges black-hole their components.
            src_ranges = self.areas[src_aid].ranges
            eff: dict = {}
            range_max: dict = {}
            # Areas a range's COMPONENT routes exit through: the split
            # horizon below must also cover range aggregates.
            range_nh_areas: dict = {}
            for prefix, route in routes.items():
                matches = [
                    r for r in src_ranges if prefix.subnet_of(r["prefix"])
                ]
                # Most-specific range wins (Appendix C.2 semantics).
                rng = max(
                    matches,
                    key=lambda r: r["prefix"].prefixlen,
                    default=None,
                )
                if rng is None:
                    eff[prefix] = route.dist
                elif rng.get("advertise", True):
                    cur = range_max.get(rng["prefix"], -1)
                    range_max[rng["prefix"]] = max(cur, route.dist)
                    acc = range_nh_areas.setdefault(
                        rng["prefix"], set()
                    )
                    for aid2 in self.areas:
                        if _nexthops_in_area(route, aid2):
                            acc.add(aid2)
            for r in src_ranges:
                if r["prefix"] in range_max:
                    eff[r["prefix"]] = (
                        r["cost"]
                        if r.get("cost") is not None
                        else range_max[r["prefix"]]
                    )
            for prefix, dist in eff.items():
                for dst_aid in self.areas:
                    if dst_aid == src_aid:
                        continue
                    r = routes.get(prefix)
                    if r is not None and _nexthops_in_area(r, dst_aid):
                        continue
                    if dst_aid in range_nh_areas.get(prefix, ()):
                        continue  # aggregate: component split horizon
                    cur = wanted[dst_aid].get(prefix)
                    if cur is None or dist < cur:
                        wanted[dst_aid][prefix] = dist
        for prefix, route in inter_routes.items():
            if route.area_id != backbone:
                continue
            for dst_aid in self.areas:
                if dst_aid == backbone:
                    continue
                if _nexthops_in_area(route, dst_aid):
                    continue
                cur = wanted[dst_aid].get(prefix)
                if cur is None or route.dist < cur:
                    wanted[dst_aid][prefix] = route.dist
        # Stub areas get a default summary instead of type-5s (§12.4.3.1);
        # NSSAs get a default type-7 (RFC 3101 §2.4, P=0 so it is never
        # translated back out).
        default = IPv4Network("0.0.0.0/0")
        for aid, area in self.areas.items():
            if (area.stub or area.nssa) and not area.summary:
                # Totally stubby: the default is the only summary.
                wanted[aid].clear()
            if area.stub:
                wanted[aid][default] = area.stub_default_cost
            elif area.nssa and default not in self.redistributed:
                # Injected ABR default (skipped when the operator
                # redistributes 0.0.0.0/0 — that type-7 owns the lsid).
                from holo_tpu_torch.protocols.ospf.packet import LsaAsExternal

                self._originate(
                    area,
                    LsaType.NSSA_EXTERNAL,
                    IPv4Address(0),
                    LsaAsExternal(
                        mask=IPv4Address(0), e_bit=True,
                        metric=area.stub_default_cost,
                        fwd_addr=IPv4Address(0), tag=0,
                    ),
                    options=Options(0),
                )
        for aid, prefixes in wanted.items():
            area = self.areas[aid]
            # Link-state-ID assignment with the RFC 2328 Appendix E rule:
            # prefixes sharing a network address get host bits set on the
            # more specific ones so their LSA keys stay distinct.
            by_net: dict[IPv4Address, list] = {}
            for p in prefixes:
                by_net.setdefault(p.network_address, []).append(p)
            lsid_of = {}
            for net, group in by_net.items():
                group.sort(key=lambda p: p.prefixlen)
                lsid_of[group[0]] = net
                for p in group[1:]:
                    lsid_of[p] = IPv4Address(
                        int(net) | (~int(mask_of(p)) & 0xFFFFFFFF)
                    )
            wanted_lsids = set(lsid_of.values())
            # Flush summaries we no longer want in this area.
            for key in list(area.lsdb.entries):
                if (
                    key.type == LsaType.SUMMARY_NETWORK
                    and key.adv_rtr == self.config.router_id
                    and key.lsid not in wanted_lsids
                ):
                    if not area.lsdb.entries[key].lsa.is_maxage:
                        self._flush_self_lsa(area, key)
            for prefix, dist in prefixes.items():
                from holo_tpu_torch.protocols.ospf.packet import LsaSummary

                self._originate(
                    area,
                    LsaType.SUMMARY_NETWORK,
                    lsid_of[prefix],
                    LsaSummary(mask_of(prefix), dist),
                    # Stub/NSSA areas clear the E option (no external
                    # routing capability inside, RFC 2328 §12.1.2).
                    options=Options(0) if area.no_type5 else Options.E,
                )

    def add_virtual_link(
        self, transit_area_id: IPv4Address, peer_rid: IPv4Address
    ) -> None:
        """Configure a §15 virtual link; it comes up when the peer is
        reachable through the transit area (next SPF run)."""
        entry = (transit_area_id, peer_rid)
        if entry not in self.config.virtual_links:
            self.config.virtual_links = self.config.virtual_links + (entry,)
        self._schedule_spf()

    def _vlink_endpoint_addr(
        self, transit: Area, peer_rid: IPv4Address, now: float
    ) -> IPv4Address | None:
        """The peer's transit-area interface address (§15.1: learned from
        its router-LSA in the transit area) — the vlink's unicast dst."""
        e = transit.lsdb.get(
            LsaKey(LsaType.ROUTER, peer_rid, peer_rid)
        )
        if e is None or e.current_age(now) >= MAX_AGE:
            return None
        # First p2p/transit link's data, exactly like the reference
        # (ospfv2/area.rs:75-95 vlink_neighbor_addr) — in deployment the
        # unicast is routed to the peer regardless of which of its
        # transit-area addresses is picked.
        return next(
            (
                link.data
                for link in e.lsa.body.links
                if link.link_type
                in (
                    RouterLinkType.POINT_TO_POINT,
                    RouterLinkType.TRANSIT_NETWORK,
                )
            ),
            None,
        )

    def _sync_virtual_links(self, area_results: dict, now: float) -> None:
        """Bring configured virtual links up/down from transit-area SPF
        reachability (reference interface.rs:50,84,135-148): a reachable
        endpoint materializes an unnumbered point-to-point interface in
        the BACKBONE whose packets ride the transit area's shortest path;
        an unreachable one tears the interface (and adjacency) down."""
        from holo_tpu_torch.ops.graph import INF as _INF
        from holo_tpu_torch.protocols.ospf.spf_run import _atoms_of

        wanted: dict[str, tuple] = {}
        # Virtual links only activate on ABRs (reference area.rs:304-306).
        vlinks = self.config.virtual_links if self.is_abr else ()
        for taid, rid in vlinks:
            transit = self.areas.get(taid)
            got = area_results.get(taid)
            if transit is None or transit.stub or transit.nssa or got is None:
                continue
            st, res = got
            v = st.router_index.get(rid)
            # §15.1: a path cost at or above LSInfinity means the
            # endpoint is unusable — the vlink stays down rather than
            # advertising a wrapped 16-bit metric.
            if v is None or res.dist[v] >= min(_INF, 0xFFFF):
                continue
            # The endpoint must itself be an ABR (reference area.rs:314).
            pe = transit.lsdb.get(LsaKey(LsaType.ROUTER, rid, rid))
            if pe is None or not (pe.lsa.body.flags & RouterFlags.B):
                continue
            nhs = _atoms_of(res.nexthop_words[v], st.atoms)
            # Deterministic egress for the unnumbered link-data: the
            # lowest-addressed transit interface among the ECMP set.
            cands = sorted(
                (
                    n
                    for n in (
                        nh.ifname for nh in nhs if nh.ifname is not None
                    )
                    if n in transit.interfaces
                    and transit.interfaces[n].addr_ip is not None
                ),
                key=lambda n: int(transit.interfaces[n].addr_ip),
            )
            out_if = cands[0] if cands else None
            dst = self._vlink_endpoint_addr(transit, rid, now)
            if out_if is None or dst is None:
                continue
            phys = transit.interfaces.get(out_if)
            if phys is None or phys.addr_ip is None:
                continue
            wanted[f"vlink-{taid}-{rid}"] = (
                taid, rid, dst, out_if, phys.addr_ip, int(res.dist[v]),
                phys.config.auth,
            )
        backbone = self.areas.get(IPv4Address(0))
        if backbone is None:
            if not wanted:
                return
            # A vlink IS the router's backbone attachment (§15): area 0
            # springs into existence with the first RESOLVED vlink, with
            # the same new-area hooks add_interface runs.
            backbone = self.areas[IPv4Address(0)] = Area(IPv4Address(0))
            for prefix in list(self.redistributed):
                self._originate_external(prefix)
            self._originate_router_info(backbone)
        # Tear down vlinks that lost their transit path.
        for name in [
            n
            for n, i in backbone.interfaces.items()
            if i.config.if_type == IfType.VIRTUAL_LINK and n not in wanted
        ]:
            self.if_down(name)
            del backbone.interfaces[name]
            self._if_area.pop(name, None)
        # Bring up / refresh the rest.
        changed = False
        for name, (taid, rid, dst, out_if, src, cost, auth) in wanted.items():
            iface = backbone.interfaces.get(name)
            if iface is None:
                iface = OspfInterface(
                    name=name,
                    config=IfConfig(
                        area_id=backbone.area_id,
                        if_type=IfType.VIRTUAL_LINK,
                        cost=cost,
                        hello_interval=self.config.vlink_hello_interval,
                        dead_interval=self.config.vlink_dead_interval,
                        # Vlink packets arrive on (and are decoded with)
                        # the transit interface — send with its auth.
                        auth=auth,
                    ),
                    addr_ip=src,
                    vlink_peer=rid,
                    vlink_transit=taid,
                    vlink_dst=dst,
                    vlink_out_ifname=out_if,
                )
                backbone.interfaces[name] = iface
                self._if_area[name] = backbone.area_id
                self._set_ism_state(iface, IsmState.POINT_TO_POINT)
                self._timer(
                    ("hello", name), lambda n=name: HelloTimerMsg(n)
                ).start(0.0)
                changed = True
            else:
                # Any dynamic-parameter change re-originates the backbone
                # router-LSA (reference area.rs:339-371: nbr_addr /
                # src_addr / cost changes all resync advertisement).
                if (
                    iface.vlink_dst,
                    iface.vlink_out_ifname,
                    iface.addr_ip,
                    iface.config.cost,
                ) != (dst, out_if, src, cost):
                    iface.vlink_dst = dst
                    iface.vlink_out_ifname = out_if
                    iface.addr_ip = src
                    iface.config.cost = cost
                    iface.config.auth = auth
                    changed = True
        if changed:
            self._originate_router_lsa(backbone)

    def _vlink_nexthops(self, backbone: Area, area_results: dict, now) -> dict:
        """{vlink neighbor rid: frozenset[RouteNexthop]} — the transit
        area's next hops toward each virtual-link neighbor named in our
        backbone router LSA."""
        from holo_tpu_torch.protocols.ospf.spf_run import _atoms_of

        key = LsaKey(
            LsaType.ROUTER, self.config.router_id, self.config.router_id
        )
        e = backbone.lsdb.get(key)
        if e is None:
            return {}
        from holo_tpu_torch.ops.graph import INF

        # The transit area is the one actually carrying the vlink
        # (§16.1): shortest intra-area path to the endpoint; equal-cost
        # paths through DIFFERENT transit areas union their next hops
        # (parallel virtual links, reference topo3-3).
        best: dict = {}  # rid -> (dist, area id of first best, nhs)
        for link in e.lsa.body.links:
            if link.link_type != RouterLinkType.VIRTUAL_LINK:
                continue
            for aid, (st, res) in area_results.items():
                v = st.router_index.get(link.id)
                if v is None or res.dist[v] >= INF:
                    continue
                nhs = _atoms_of(res.nexthop_words[v], st.atoms)
                if not nhs:
                    continue
                cand = (int(res.dist[v]), int(aid))
                cur = best.get(link.id)
                if cur is None or cand[0] < cur[0]:
                    best[link.id] = (*cand, nhs)
                elif cand[0] == cur[0]:
                    # Parallel virtual links through different transit
                    # areas at equal cost: ECMP union (reference
                    # topo3-3 shape).
                    best[link.id] = (cur[0], cur[1], cur[2] | nhs)
        return {rid: nhs for rid, (_d, _a, nhs) in best.items()}

    def _originate_asbr_summaries(self, area_results: dict) -> None:
        """ABR: type-4 ASBR-summary LSAs (§12.4.3) so other areas can
        resolve ASBRs they cannot see in their own SPF."""
        from holo_tpu_torch.protocols.ospf.packet import LsaSummary

        now = self.loop.clock.now()
        # ASBRs reachable per area: routers whose router-LSA carries E.
        asbr_dist: dict[IPv4Address, tuple[IPv4Address, int]] = {}
        for aid, (st, res) in area_results.items():
            area = self.areas[aid]
            for e in area.lsdb.all():
                lsa = e.lsa
                if (
                    lsa.type != LsaType.ROUTER
                    or not (lsa.body.flags & RouterFlags.E)
                    or lsa.adv_rtr == self.config.router_id
                    or e.current_age(now) >= MAX_AGE
                ):
                    continue
                v = st.router_index.get(lsa.adv_rtr)
                if v is None or res.dist[v] >= 0x40000000:
                    continue
                d = int(res.dist[v])
                cur = asbr_dist.get(lsa.adv_rtr)
                if cur is None or d < cur[1]:
                    asbr_dist[lsa.adv_rtr] = (aid, d)
        wanted_per_area: dict[IPv4Address, dict] = {
            aid: {} for aid in self.areas
        }
        for asbr, (src_aid, d) in asbr_dist.items():
            for dst_aid, dst_area in self.areas.items():
                if dst_aid != src_aid and not dst_area.stub:
                    # §12.4.3.1: no type-4s into stub areas (no type-5s
                    # there to resolve).
                    wanted_per_area[dst_aid][asbr] = d
        zero_mask = IPv4Address(0)
        for aid, wanted in wanted_per_area.items():
            area = self.areas[aid]
            for key in list(area.lsdb.entries):
                if (
                    key.type == LsaType.SUMMARY_ROUTER
                    and key.adv_rtr == self.config.router_id
                    and key.lsid not in wanted
                    and not area.lsdb.entries[key].lsa.is_maxage
                ):
                    self._flush_self_lsa(area, key)
            for asbr, d in wanted.items():
                self._originate(
                    area, LsaType.SUMMARY_ROUTER, asbr,
                    LsaSummary(zero_mask, d),
                )

    # ----- segment routing (RFC 8665 prefix-SIDs over RFC 7684 LSAs)

    def _originate_prefix_sids(self) -> None:
        sr = self.config.sr
        if sr is None or not sr.enabled:
            return
        from holo_tpu_torch.protocols.ospf.packet import (
            LsaOpaque,
            encode_ext_prefix_sid,
            ext_prefix_lsid,
        )

        # Stable opaque-id per prefix (never reused) so removals can be
        # flushed and reorderings can't cross LSAs.
        for prefix in sr.prefix_sids:
            self._alloc_ext_prefix_opaque_id(("sr", prefix))
        for key, opaque_id in list(self._ext_prefix_opaque_ids.items()):
            if key[0] != "sr":
                continue
            prefix = key[1]
            psid = sr.prefix_sids.get(prefix)
            lsid = ext_prefix_lsid(opaque_id)
            if psid is None:
                key = LsaKey(LsaType.OPAQUE_AREA, lsid, self.config.router_id)
                for area in self.areas.values():
                    self._flush_self_lsa(area, key)
                continue
            flags = 0x40 if psid.no_php else 0
            body = LsaOpaque(
                encode_ext_prefix_sid(psid.prefix, psid.index, flags)
            )
            for area in self.areas.values():
                self._originate(area, LsaType.OPAQUE_AREA, lsid, body)

    def _resolve_sr_labels(self, all_routes: dict) -> dict:
        """prefix → (local label, route) for every prefix-SID heard,
        resolved through the SRGB (reference holo-ospf/src/sr.rs)."""
        sr = self.config.sr
        if sr is None or not sr.enabled:
            return {}
        from holo_tpu_torch.protocols.ospf.packet import decode_ext_prefix_sid

        now = self.loop.clock.now()
        out = {}
        for area in self.areas.values():
            for e in area.lsdb.all():
                lsa = e.lsa
                if (
                    lsa.type != LsaType.OPAQUE_AREA
                    or (int(lsa.lsid) >> 24) != 7
                    or e.current_age(now) >= MAX_AGE
                ):
                    continue
                parsed = decode_ext_prefix_sid(lsa.body.data)
                if parsed is None:
                    continue
                prefix, sid_index, _flags = parsed
                label = sr.srgb.label_of(sid_index)
                route = all_routes.get(prefix)
                if label is not None and route is not None:
                    out[prefix] = (label, route)
        return out

    def _alloc_ext_prefix_opaque_id(self, key: tuple) -> int:
        if key not in self._ext_prefix_opaque_ids:
            self._ext_prefix_opaque_ids[key] = len(
                self._ext_prefix_opaque_ids
            )
        return self._ext_prefix_opaque_ids[key]

    def update_ext_prefix_flags(self) -> None:
        """Originate (or flush) the extended-prefix attribute LSA
        carrying N/AC flags for interface addresses (reference
        ospfv2/lsdb.rs:760-800: lsa-id 7.0.0.0, one TLV per flagged
        address; N for node-flag host addresses, else AC for
        anycast-flag interfaces)."""
        from holo_tpu_torch.protocols.ospf.packet import (
            EXT_PREFIX_FLAG_AC,
            EXT_PREFIX_FLAG_N,
            LsaOpaque,
            encode_ext_prefix_flags,
        )

        lsid = IPv4Address(7 << 24)  # opaque type 7, opaque id 0
        for area in self.areas.values():
            entries = []
            for iface in area.interfaces.values():
                if iface.state == IsmState.DOWN:
                    continue
                addrs = []
                if iface.prefix is not None:
                    addrs.append(iface.prefix)
                addrs.extend(iface.secondary)
                for prefix in addrs:
                    if (
                        iface.config.node_flag
                        and prefix.prefixlen == 32
                    ):
                        entries.append((prefix, EXT_PREFIX_FLAG_N))
                    elif iface.config.anycast_flag:
                        entries.append((prefix, EXT_PREFIX_FLAG_AC))
            if entries:
                body = LsaOpaque(encode_ext_prefix_flags(sorted(
                    entries, key=lambda e: (int(e[0].network_address), e[0].prefixlen)
                )))
                self._originate(area, LsaType.OPAQUE_AREA, lsid, body)
            else:
                key = LsaKey(
                    LsaType.OPAQUE_AREA, lsid, self.config.router_id
                )
                self._flush_self_lsa(area, key)

    # ----- BIER underlay (RFC 9089 over RFC 7684 LSAs)

    def _originate_bier(self) -> None:
        bier = self.config.bier
        if bier is None or not bier.enabled():
            # Withdraw any previously advertised sub-domains.
            from holo_tpu_torch.protocols.ospf.packet import ext_prefix_lsid

            for key, opaque_id in self._ext_prefix_opaque_ids.items():
                if key[0] != "bier":
                    continue
                lsa_key = LsaKey(
                    LsaType.OPAQUE_AREA,
                    ext_prefix_lsid(opaque_id),
                    self.config.router_id,
                )
                for area in self.areas.values():
                    self._flush_self_lsa(area, lsa_key)
            return
        from holo_tpu_torch.protocols.ospf.packet import (
            LsaOpaque,
            encode_ext_prefix_bier,
            ext_prefix_lsid,
        )

        for sd_id, sd in sorted(bier.sub_domains.items()):
            if sd.bfr_prefix is None:
                continue
            self._alloc_ext_prefix_opaque_id(("bier", sd_id))
        for key, opaque_id in list(self._ext_prefix_opaque_ids.items()):
            if key[0] != "bier":
                continue
            sd = bier.sub_domains.get(key[1])
            lsid = ext_prefix_lsid(opaque_id)
            if sd is None or sd.bfr_prefix is None:
                # Sub-domain removed: withdraw the advertisement.
                lsa_key = LsaKey(
                    LsaType.OPAQUE_AREA, lsid, self.config.router_id
                )
                for area in self.areas.values():
                    self._flush_self_lsa(area, lsa_key)
                continue
            body = LsaOpaque(
                encode_ext_prefix_bier(
                    sd.bfr_prefix, key[1], sd.bfr_id, sd.encaps
                )
            )
            for area in self.areas.values():
                self._originate(area, LsaType.OPAQUE_AREA, lsid, body)

    def _resolve_bier(self, all_routes: dict) -> dict:
        """prefix -> (BierInfo, route) for every BFR prefix heard in a
        locally configured sub-domain (reference holo-ospf/src/bier.rs:
        bier_route_add filters on the shared sub-domain config)."""
        bier = self.config.bier
        if bier is None or not bier.enabled():
            return {}
        from holo_tpu_torch.protocols.ospf.packet import decode_ext_prefix_bier
        from holo_tpu_torch.utils.bier import BierInfo

        now = self.loop.clock.now()
        out = {}
        for area in self.areas.values():
            for e in area.lsdb.all():
                lsa = e.lsa
                if (
                    lsa.type != LsaType.OPAQUE_AREA
                    or (int(lsa.lsid) >> 24) != 7
                    or e.current_age(now) >= MAX_AGE
                ):
                    continue
                parsed = decode_ext_prefix_bier(lsa.body.data)
                if parsed is None:
                    continue
                prefix, sd_id, _mt, bfr_id, bsls = parsed
                if sd_id not in bier.sub_domains or not bsls:
                    continue
                route = all_routes.get(prefix)
                if route is not None:
                    out[prefix] = (
                        BierInfo(sd_id=sd_id, bfr_id=bfr_id, bfr_bss=bsls),
                        route,
                    )
        return out

    def _multipath_k(self) -> int:
        """The SPF dispatch's parent-set width: ``max-paths`` when it
        limits ECMP (2..8 → the vectorized multipath kernel with UCMP
        weights), else 1 (the unchanged single-parent program)."""
        m = self.config.max_paths
        return m if (m is not None and m > 1) else 1

    def _enqueue_whatif_advisory(self, area_results: dict) -> None:
        """Protocol-level consumption of ``compute_whatif_async``:
        after each full SPF, enqueue an advisory batch of
        single-link-failure scenarios per area through the async
        pipeline.  Purely advisory — nothing on the SPF path waits for
        the results; a storm's batches coalesce (newer SPF generation
        supersedes a queued older one) and breaker-open batches are
        skipped, both visible in ``holo_pipeline_coalesced_total`` /
        ``holo_pipeline_breaker_skip_total``."""
        budget = int(self.config.whatif_advisory or 0)
        enqueue = getattr(self.backend, "compute_whatif_async", None)
        if budget <= 0 or enqueue is None:
            return
        import numpy as np

        for aid, (st, _res) in area_results.items():
            topo = st.topo
            if topo.n_edges == 0:
                continue
            pair: dict = {}
            for e in range(topo.n_edges):
                pair.setdefault(
                    (int(topo.edge_src[e]), int(topo.edge_dst[e])), e
                )
            n = min(budget, topo.n_edges)
            masks = np.ones((n, topo.n_edges), bool)
            row = 0
            for e in range(topo.n_edges):
                if row >= n:
                    break
                rev = pair.get(
                    (int(topo.edge_dst[e]), int(topo.edge_src[e]))
                )
                if rev is not None and rev < e:
                    # The reverse direction already produced this
                    # link's scenario: one row per LINK, not per
                    # directed edge, or half the budget is duplicates.
                    continue
                # Mask both directions of the link (§16.1 contract).
                masks[row, e] = False
                if rev is not None:
                    masks[row, rev] = False
                row += 1
            ticket = enqueue(
                topo, masks[:row], generation=self.spf_run_count
            )
            self._whatif_tickets[aid] = ticket
            self._whatif_stats["enqueued"] += 1
            ticket.add_done_callback(self._whatif_done)

    def _whatif_done(self, _ticket) -> None:
        # Worker-thread callback: a plain counter bump only (ints are
        # GIL-atomic; the advisory results themselves stay on the
        # ticket for operational-state readers).
        self._whatif_stats["completed"] += 1

    def _frr_tables_ready(self) -> None:
        """Actor-side completion of a deferred FRR attach: join the
        (now materialized) backup tables onto the current routes and
        republish the prefixes that gained backups."""
        if not self._frr_attach_deferred or self._spf_cache is None:
            return
        self._frr_attach_deferred = False
        import copy as _copy

        routes = self.routes
        before = {p: r.backups for p, r in routes.items()}
        # NOT deferred=True: a newer SPF may have swapped in tables
        # that are THEMSELVES still in flight — the pending check then
        # re-defers (fresh callbacks) instead of forcing them here.
        self._attach_frr_backups(routes)
        if self._frr_attach_deferred:
            return
        old = {}
        for p, r in routes.items():
            if (r.backups or None) != (before.get(p) or None):
                c = _copy.copy(r)
                c.backups = before.get(p)
                old[p] = c
            else:
                old[p] = r
        if self.ibus is not None:
            self._sync_rib(old, routes)

    def _frr_engine_for(self):
        """The instance's FrrEngine when fast reroute is configured."""
        cfg = self.config.frr
        if cfg is None or not cfg.active():
            return None
        from holo_tpu_torch.frr.manager import ensure_engine

        self._frr_engine = ensure_engine(self._frr_engine, cfg)
        return self._frr_engine

    def _attach_frr_backups(self, all_routes: dict, deferred: bool = False) -> None:
        """Join the per-area backup tables onto the route table (runs
        after SR label resolution: remote/TI-LFA repairs tunnel through
        node-SID labels and attach only when the stack resolves).

        When the tables are PIPELINED and still in flight, the attach
        is deferred: a done-callback on the last
        pending ticket posts :class:`FrrTablesReadyMsg` back to this
        actor, and the SPF path proceeds without forcing — the FRR
        device wait moves entirely onto the pipeline worker
        (``holo_pipeline_wait_seconds{kind=frr}`` stays empty)."""
        cfg = self.config.frr
        if (
            cfg is None
            or not cfg.active()
            or not self.frr_tables
            or self._spf_cache is None
        ):
            return
        if not deferred:
            pending = [
                t
                for t in self.frr_tables.values()
                if getattr(t, "pending", None) is not None and t.pending()
            ]
            if pending:
                self._frr_attach_deferred = True
                run = self.spf_run_count
                import threading

                lock = threading.Lock()
                remaining = [len(pending)]

                def _one_done(_ticket, _remaining=remaining, _run=run,
                              _lock=lock):
                    # May fire on the pipeline worker OR inline on this
                    # actor thread (a ticket that completed between the
                    # pending scan and registration): the countdown
                    # must be atomic or a lost decrement strands the
                    # deferred attach forever.  The winner hops back
                    # onto the actor loop (deque append is thread-safe;
                    # the loop drains it on its own thread).
                    with _lock:
                        _remaining[0] -= 1
                        last = _remaining[0] <= 0
                    if last:
                        self.loop.send(self.name, FrrTablesReadyMsg(_run))

                for t in pending:
                    t.on_done(_one_done)
                return
        from holo_tpu_torch.protocols.ospf.spf_run import attach_frr_backups

        # Per-area vertex -> node-SID label maps (vertex ids are area
        # scoped; the SID of a router's host prefix stands for the node).
        vlabels: dict = {}
        for _prefix, (label, route) in self.sr_labels.items():
            v = getattr(route, "vertex", -1)
            if v >= 0:
                vlabels.setdefault(route.area_id, {}).setdefault(v, label)
        for aid, (st, res) in self._spf_cache["area_results"].items():
            table = self.frr_tables.get(aid)
            if table is None:
                continue
            label_of = vlabels.get(aid, {}).get if cfg.ti_lfa or cfg.remote_lfa else None
            attach_frr_backups(
                st, res, all_routes, table, cfg, label_of, area_id=aid
            )

    def _finish_spf(self, all_routes: dict) -> None:
        # max-paths applies to the WHOLE table (full and partial runs):
        # inter-area and external routes inherit raw SPF next-hop sets
        # via their ABR/ASBR vertex and must clamp like intra routes
        # (the v3 instance clamps its merged table the same way).
        # Intra routes were already clamped weight-aware in
        # derive_routes; re-clamping them is a no-op.
        from holo_tpu_torch.protocols.ospf.spf_run import clamp_multipath

        clamp_multipath(all_routes, self.config.max_paths)
        self._originate_prefix_sids()
        self._originate_bier()
        self.bier_routes = self._resolve_bier(all_routes)
        self.sr_labels = self._resolve_sr_labels(all_routes)
        self._attach_frr_backups(all_routes)
        old = self.routes
        self.routes = all_routes
        if self.route_cb is not None:
            self.route_cb(all_routes)
        if self.ibus is not None:
            self._sync_rib(old, all_routes)

    def _sync_rib(self, old: dict, new: dict) -> None:
        """Publish route deltas to the routing provider (ibus route
        install/uninstall — reference route.rs:894-906 → ibus.rs:344-351)."""
        from holo_tpu_torch.utils.southbound import (
            Nexthop,
            Protocol,
            RouteKeyMsg,
            RouteMsg,
            DEFAULT_DISTANCE,
        )

        def installable(route) -> bool:
            # Connected destinations — no next-hops at all, or only
            # address-less (interface-only) ones — are never installed:
            # the RIB's DIRECT entries own them (reference route.rs:96
            # models connected with addr=None and skips the install).
            return any(nh.addr is not None for nh in route.nexthops)

        installed = self._installed_prefixes

        def uninstall(prefix):
            installed.discard(prefix)
            self.ibus.request(
                self.routing_actor,
                RouteKeyMsg(Protocol.OSPFV2, prefix),
                sender=self.name,
            )

        for prefix in old:
            if prefix not in new and prefix in installed:
                uninstall(prefix)
        for prefix, route in new.items():
            prev = old.get(prefix)
            if (
                prev is not None
                and prev.dist == route.dist
                and prev.nexthops == route.nexthops
                and getattr(prev, "backups", None) == getattr(route, "backups", None)
                and getattr(prev, "nh_weights", None)
                == getattr(route, "nh_weights", None)
            ):
                continue
            if not installable(route):
                # A previously-installed route degrading to connected
                # (directly attached again) is left in place — the
                # reference emits nothing on this transition (verified
                # against its recordings: ibus-addr-add3 step 4); the
                # entry is withdrawn when the prefix itself goes away.
                continue
            nhs = frozenset(
                Nexthop(
                    addr=nh.addr,
                    ifname=nh.ifname,
                    ifindex=self._ifindex_of(nh.ifname),
                )
                # An ECMP tie between a directly-attached path and one
                # via a neighbor can mix address-less and addressed
                # next-hops: only the addressed ones are installable.
                for nh in route.nexthops
                if nh.addr is not None
            )
            nh_weights = {}
            for nh, w in (getattr(route, "nh_weights", None) or {}).items():
                if nh.addr is None or nh not in route.nexthops:
                    continue
                nh_weights[
                    Nexthop(
                        addr=nh.addr,
                        ifname=nh.ifname,
                        ifindex=self._ifindex_of(nh.ifname),
                    )
                ] = int(w)
            backups = {}
            for pnh, (bnh, labels) in (getattr(route, "backups", None) or {}).items():
                if pnh.addr is None or bnh.addr is None:
                    continue
                backups[
                    Nexthop(
                        addr=pnh.addr,
                        ifname=pnh.ifname,
                        ifindex=self._ifindex_of(pnh.ifname),
                    )
                ] = Nexthop(
                    addr=bnh.addr,
                    ifname=bnh.ifname,
                    ifindex=self._ifindex_of(bnh.ifname),
                    labels=tuple(labels),
                )
            installed.add(prefix)
            self.ibus.request(
                self.routing_actor,
                RouteMsg(
                    protocol=Protocol.OSPFV2,
                    prefix=prefix,
                    distance=self._route_distance(route),
                    metric=route.dist,
                    nexthops=nhs,
                    backups=backups,
                    nh_weights=nh_weights,
                ),
                sender=self.name,
            )

    def _route_distance(self, route) -> int:
        c = self.config
        rtype = getattr(route, "rtype", "intra")
        if rtype.startswith(("external", "nssa")):
            return c.preference_external if c.preference_external is not None else c.preference
        typed = c.preference_intra if rtype == "intra" else c.preference_inter
        if typed is not None:
            return typed
        if c.preference_internal is not None:
            return c.preference_internal
        return c.preference

    def _ifindex_of(self, ifname: str | None) -> int | None:
        if ifname is None:
            return None
        ai = self._iface(ifname)
        return ai[1].ifindex if ai else None

    def set_preference(self, preference: int | None = None, **typed) -> None:
        """Administrative-distance change: republish every route with the
        new distances (the RIB re-ranks protocols on them).  ``typed``
        accepts intra/inter/internal/external keyword overrides."""
        changed = False
        if preference is not None and preference != self.config.preference:
            self.config.preference = preference
            changed = True
        for kind, val in typed.items():
            attr = f"preference_{kind}"
            if getattr(self.config, attr) != val:
                setattr(self.config, attr, val)
                changed = True
        if changed and self.ibus is not None:
            self._sync_rib({}, self.routes)

    def shutdown_self(self) -> None:
        """Disable path (and router-id change): flush every LSA we
        originated and withdraw all routes (reference: instance teardown
        floods MaxAge self-LSAs and uninstalls its RIB contribution)."""
        # Flush while adjacencies can still flood the MaxAge copies; the
        # shutdown guard stops the FULL->DOWN kill hooks from
        # re-originating live LSAs behind the flush.
        self._shutting_down = True
        try:
            for area in self.areas.values():
                for key in list(area.lsdb.entries):
                    if key.adv_rtr == self.config.router_id:
                        self._flush_self_lsa(area, key)
            # Stop interfaces one by one (reference teardown): each kills
            # its neighbors (nbr down notifications) then transitions the
            # interface itself to Down (if-state-change notification).
            # Loopbacks have no ISM to stop — they stay 'loopback'.
            for area in self.areas.values():
                for iface in area.interfaces.values():
                    for nbr_id in list(iface.neighbors):
                        self._nbr_event(iface.name, nbr_id, NsmEvent.KILL_NBR)
                    if iface.config.loopback:
                        continue
                    self._set_ism_state(iface, IsmState.DOWN)
                    iface.dr = IPv4Address(0)
                    iface.bdr = IPv4Address(0)
                    for key in ("hello", "wait"):
                        t = self._timers.get((key, iface.name))
                        if t:
                            t.cancel()
        finally:
            self._shutting_down = False
        # Teardown discards any re-origination checks its kill hooks queued,
        # and drops ALL instance state — the reference tears the whole
        # Instance<Up> down, so the LSDBs and SPF products vanish with it.
        self._pending_checks.clear()
        for area in self.areas.values():
            area.lsdb.entries.clear()
            area.lsdb.pending.clear()
        self._link_scope_iface.clear()
        self._area_reachable_routers.clear()
        self.spf_state = SpfFsmState.QUIET
        self._learn_deadline = None
        self.enabled = False
        old = self.routes
        self.routes = {}
        if self.route_cb is not None:
            self.route_cb({})
        if self.ibus is not None:
            self._sync_rib(old, {})

    def restart_with_router_id(self, router_id: IPv4Address) -> None:
        """Router-id change requires a restart: flush the old identity's
        LSAs, adopt the new id, bring interfaces back up and let
        adjacencies re-form."""
        if router_id == self.config.router_id:
            return
        was_up = [
            iface.name
            for area in self.areas.values()
            for iface in area.interfaces.values()
            if iface.state != IsmState.DOWN
        ]
        self.shutdown_self()
        self.config.router_id = router_id
        self.enabled = True
        # Instance (re)start: AreaStart re-originates the RI LSAs, then
        # the interfaces come back up under the new identity.
        for area in self.areas.values():
            self._originate_router_info(area)
        for ifname in was_up:
            self.if_up(ifname)

    def clear_neighbors(
        self,
        nbr_id: IPv4Address | None = None,
        ifname: str | None = None,
    ) -> None:
        """ietf-ospf clear-neighbor RPC: tear down adjacencies (they
        re-form from hellos), optionally scoped to one interface/neighbor."""
        for area in self.areas.values():
            for iface in area.interfaces.values():
                if ifname is not None and iface.name != ifname:
                    continue
                for rid in list(iface.neighbors):
                    if nbr_id is None or rid == nbr_id:
                        self._nbr_event(iface.name, rid, NsmEvent.KILL_NBR)

    def clear_database(self) -> None:
        """ietf-ospf clear-database RPC (reference rpc.rs:48-76): drop
        every LSA and kill the neighbors; re-origination happens through
        the kill events' own origination checks (router-LSA), NOT
        explicitly — the RI LSA only returns at area (re)start."""
        for area in self.areas.values():
            for key in list(area.lsdb.entries):
                area.lsdb.remove(key)
            for iface in area.interfaces.values():
                for rid in list(iface.neighbors):
                    self._nbr_event(iface.name, rid, NsmEvent.KILL_NBR)
        self._link_scope_iface.clear()

    # ----- rx/tx plumbing

    def _rx_packet(self, msg: NetRxPacket) -> None:
        ai = self._iface(msg.ifname)
        if ai is None:
            return
        area, iface = ai
        if iface.state == IsmState.DOWN:
            return
        if iface.config.passive:
            # Passive circuits neither send NOR process OSPF packets —
            # a peer's hellos must not recreate phantom neighbors here.
            return
        try:
            pkt = Packet.decode(msg.data, auth=iface.config.auth)
        except Exception:
            # Malformed/unauthenticated: drop + notify (events.rs:132).
            _OSPF_RX_BAD.labels(instance=self.name).inc()
            self._notify(
                "ietf-ospf:if-rx-bad-packet",
                self._notif_iface(iface) | {"packet-source": str(msg.src)},
            )
            return
        _OSPF_PACKETS.labels(instance=self.name, dir="rx").inc()
        # Destination validation (ospfv2/interface.rs:94-126): our own
        # address, AllSPFRouters, or AllDRouters when we are DR/BDR.
        if msg.dst is not None and msg.dst not in (
            iface.addr_ip,
            ALL_SPF_RTRS_V4,
        ):
            if not (msg.dst == ALL_DR_RTRS_V4 and iface.is_dr_or_bdr()):
                return
        # Source validation (:128-146): usable, and on the interface's
        # subnet for non-p2p interfaces.  Virtual-link packets are exempt
        # from the subnet rule — the peer sits several hops away across
        # the transit area (§15), identified by area id 0 in the header.
        if int(msg.src) == 0:
            return
        if (
            iface.config.if_type != IfType.POINT_TO_POINT
            and iface.prefix is not None
            and msg.src not in iface.prefix
            and not (int(pkt.area_id) == 0 and int(area.area_id) != 0)
        ):
            return
        if pkt.router_id == self.config.router_id:
            if pkt.body.TYPE == PacketType.HELLO:
                # Another router is using OUR router-id (hello from a
                # different source): misconfiguration worth flagging.
                self._notify_if_config_error(
                    iface, msg.src, "hello", "duplicate-router-id"
                )
            return  # our own multicast (or a duplicate router-id)
        if pkt.area_id != area.area_id:
            # §15: virtual-link packets carry the BACKBONE area id but
            # arrive over the transit area's physical interface — rebind
            # to the matching vlink interface before processing.
            vl = None
            if int(pkt.area_id) == 0 and int(area.area_id) != 0:
                backbone = self.areas.get(IPv4Address(0))
                if backbone is not None:
                    # The vlink must be configured THROUGH this transit
                    # area and the source must be the resolved endpoint —
                    # otherwise an off-path sender could inject packets
                    # as the vlink neighbor.
                    vl = next(
                        (
                            i
                            for i in backbone.interfaces.values()
                            if i.config.if_type == IfType.VIRTUAL_LINK
                            and i.vlink_peer == pkt.router_id
                            and i.vlink_transit == area.area_id
                            and i.vlink_dst == msg.src
                        ),
                        None,
                    )
            if vl is None:
                self._notify_if_config_error(
                    iface, msg.src, _PKT_TYPE_YANG[pkt.body.TYPE],
                    "area-mismatch",
                )
                return
            area, iface = self.areas[IPv4Address(0)], vl
        if pkt.auth_type == AuthType.CRYPTOGRAPHIC:
            nbr = iface.neighbors.get(pkt.router_id)
            if nbr is not None:
                if pkt.auth_seqno < nbr.crypto_seqno:
                    return  # replay
                nbr.crypto_seqno = pkt.auth_seqno
        t = pkt.body.TYPE
        if t == PacketType.HELLO:
            self._rx_hello(area, iface, msg.src, pkt)
        elif t == PacketType.DB_DESC:
            self._rx_db_desc(area, iface, msg.src, pkt)
        elif t == PacketType.LS_REQUEST:
            self._rx_ls_request(area, iface, msg.src, pkt)
        elif t == PacketType.LS_UPDATE:
            self._rx_ls_update(area, iface, msg.src, pkt)
        elif t == PacketType.LS_ACK:
            self._rx_ls_ack(area, iface, msg.src, pkt)

    def _send(self, iface: OspfInterface, dst, body, area: Area, lls=None) -> None:
        pkt = Packet(
            router_id=self.config.router_id,
            area_id=area.area_id,
            body=body,
            lls=lls,
        )
        auth = iface.config.auth
        if auth is not None and auth.type == AuthType.CRYPTOGRAPHIC:
            self._crypto_seq += 1
            if self._nvstore is not None and self._crypto_seq >= self._crypto_reserved:
                self._reserve_seqnos()
            auth.seqno = self._crypto_seq
        out_ifname = iface.name
        if iface.config.if_type == IfType.VIRTUAL_LINK:
            # §15: vlink packets are unicast to the resolved endpoint and
            # leave through the transit area's physical interface.
            out_ifname = iface.vlink_out_ifname or iface.name
            dst = iface.vlink_dst
            if dst is None:
                return
        _OSPF_PACKETS.labels(instance=self.name, dir="tx").inc()
        self.netio.send(out_ifname, iface.addr_ip, dst, pkt.encode(auth=auth))
