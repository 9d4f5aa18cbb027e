"""Convergence-storm harness (the port's copy of
``holo_tpu.spf.synth_storm``): seeded flap storms over a synthetic
multi-thousand-router OSPFv2 LSDB inside a REAL instance, from LSA install to
FIB commit.

Like ``holo_tpu``'s ``spf.synth_proto``, the topology scales in the LSDB —
one device-under-test :class:`OspfInstance` holds Router-LSAs for
``n_routers`` synthetic routers — while the causal machinery around it
is entirely real: LSA installs run through ``_install_and_flood`` (so
the RFC 8405 SPF-delay FSM, trigger classification, and the convergence
tracker's origin stamps all fire), routes flow over the ibus into a
real :class:`RibManager`, and BFD/carrier events drive its O(1)
local-repair flips.

With no ``spf_backend`` the DUT runs :class:`TorchSpfBackend` on
``device`` (the CUDA card unless the caller passes ``device="cpu"``;
:func:`holo_tpu_torch.device.resolve_device`).

Storm events come from the existing :class:`FaultPlan` seed streams
(same seed → same timeline, virtual-clock deterministic):

- **lsa** — a non-structural link flaps; both endpoint Router-LSAs
  reinstall with bumped sequence numbers.  With probability
  ``plan.drop_prob`` the arrival is LOST and retransmitted
  ``RXMT_DELAY`` later — convergence latency then includes the
  retransmit penalty, exactly the 10%-loss tail the storm measures.
- **bfd** — a BFD session to one of the DUT's two ECMP gateways drops
  (and later recovers): the RIB flips survivors in O(1).
- **carrier** — a DUT interface loses (and regains) carrier.
- **ifconfig** — the DUT's gateway link metric changes (config event;
  forces a full SPF).

The dual-gateway construction (root → g0/g1 → shared hubs → the rest)
guarantees 2-way ECMP for every destination behind the hubs, so
bfd/carrier repairs always have survivors to flip to.
"""

from __future__ import annotations

import hashlib
import json
import time
from dataclasses import dataclass
from ipaddress import IPv4Address, IPv4Network

import numpy as np

from holo_tpu_torch.device import resolve_device
from holo_tpu_torch.protocols.ospf.instance import (
    IfConfig,
    InstanceConfig,
    OspfInstance,
)
from holo_tpu_torch.protocols.ospf.interface import IfType, IsmState
from holo_tpu_torch.protocols.ospf.neighbor import Neighbor, NsmState
from holo_tpu_torch.protocols.ospf.packet import (
    Lsa,
    LsaRouter,
    LsaType,
    Options,
    RouterLink,
    RouterLinkType,
)
from holo_tpu_torch.resilience.faults import FaultInjector, FaultPlan
from holo_tpu_torch.routing.rib import MockKernel, RibManager
from holo_tpu_torch.spf.backend import TorchSpfBackend
from holo_tpu_torch.telemetry import convergence
from holo_tpu_torch.utils.ibus import (
    TOPIC_BFD_STATE,
    TOPIC_INTERFACE_UPD,
    BfdStateUpd,
    Ibus,
)
from holo_tpu_torch.utils.netio import NetIo
from holo_tpu_torch.utils.runtime import Actor, EventLoop, VirtualClock
from holo_tpu_torch.utils.southbound import InterfaceUpdMsg

#: modeled LS-retransmit penalty for a "lost" LSA arrival
RXMT_DELAY = 5.0

_MASK24 = IPv4Address("255.255.255.0")


class _DiscardIo(NetIo):
    """Flood sink: the synthetic neighbors have no receive side."""

    def send(self, ifname, src, dst, data) -> None:
        pass


def _rid(i: int) -> IPv4Address:
    """Synthetic router id for index ``i`` (root is index 0)."""
    return IPv4Address((10 << 24) | (i + 1))


def _p2p(nbr: IPv4Address, data: IPv4Address, metric: int) -> RouterLink:
    return RouterLink(RouterLinkType.POINT_TO_POINT, nbr, data, metric)


def _stub(prefix: IPv4Network, metric: int = 1) -> RouterLink:
    return RouterLink(
        RouterLinkType.STUB_NETWORK,
        prefix.network_address,
        prefix.netmask,
        metric,
    )


@dataclass
class _ApplyLsas:
    """Storm-actor message: install LSAs under a causal context (the
    ``event_id`` field is what the EventLoop delivery hook activates —
    lost arrivals redeliver this same message after RXMT_DELAY)."""

    lsas: list
    event_id: tuple | None = None


class StormNet:
    """One DUT instance + RIB over a virtual-clock loop, plus the
    python-side link model the storm mutates."""

    DUT = "storm-dut"
    ACTOR = "storm-driver"

    def __init__(
        self,
        n_routers: int = 2000,
        seed: int = 0,
        spf_backend=None,
        prefix_every: int = 8,
        hubs: int = 6,
        loop=None,
        max_paths: int | None = None,
        device=None,
    ):
        """``loop`` defaults to a fresh virtual-clock EventLoop (the
        deterministic storm configuration).  ``max_paths`` arms the
        multipath dispatch on the DUT: the dual-gateway ECMP pairs then
        install as real next-hop SETS with UCMP weights.  ``spf_backend``
        defaults to a :class:`TorchSpfBackend` on ``device``."""
        assert n_routers >= hubs + 8, "need root + 2 gateways + hubs + some"
        if spf_backend is None:
            spf_backend = TorchSpfBackend(device=resolve_device(device))
        self.n_routers = n_routers
        self.loop = loop if loop is not None else EventLoop(
            clock=VirtualClock()
        )
        self.bus = Ibus(self.loop)
        self.kernel = MockKernel()
        self.rib = RibManager(self.bus, self.kernel)
        self.rib.name = "routing"
        self.loop.register(self.rib)
        cfg = InstanceConfig(router_id=_rid(0), max_paths=max_paths)
        self.inst = OspfInstance(
            name=self.DUT,
            config=cfg,
            netio=_DiscardIo(),
            spf_backend=spf_backend,
        )
        self.loop.register(self.inst)
        self.inst.attach_ibus(self.bus, routing_actor="routing")
        self.loop.register(_StormActor(self), name=self.ACTOR)

        rng = np.random.default_rng(seed)
        # Link model: adjacency dict rid-index -> {peer-index: metric}.
        # Indices: 0 root, 1..2 gateways, 3..3+hubs-1 hubs, rest leaves.
        self.adj: dict[int, dict[int, int]] = {i: {} for i in range(n_routers)}
        self.g0, self.g1 = 1, 2
        self.hub0 = 3
        self.n_hubs = hubs

        def link(a: int, b: int, cost: int) -> None:
            self.adj[a][b] = cost
            self.adj[b][a] = cost

        link(0, self.g0, 1)
        link(0, self.g1, 1)
        for j in range(hubs):
            h = self.hub0 + j
            link(self.g0, h, 1)
            link(self.g1, h, 1)
            if j:
                link(h - 1, h, 1)
        first_leaf = self.hub0 + hubs
        for i in range(first_leaf, n_routers):
            # Spanning attachment to a hub or an earlier leaf, plus a
            # sprinkling of extra edges for path diversity.
            parent = int(rng.integers(self.hub0, i))
            link(i, parent, int(rng.integers(1, 5)))
            if rng.random() < 0.3:
                extra = int(rng.integers(self.hub0, i))
                if extra != i and extra not in self.adj[i]:
                    link(i, extra, int(rng.integers(1, 8)))
        # Flappable edges: leaf/hub-side only — never the root/gateway
        # structure the ECMP construction depends on.
        self.flappable = sorted(
            (a, b)
            for a, nbrs in self.adj.items()
            for b in nbrs
            if a < b and a >= self.hub0
        )
        self.down: set[tuple[int, int]] = set()
        # Per-prefix stub owners (every prefix_every-th leaf).
        self.stub_owners = list(range(first_leaf, n_routers, prefix_every))
        self._seq: dict[int, int] = {}

        # DUT interfaces + FULL neighbors toward the gateways (next-hop
        # resolution; the ISM/NSM machinery is bypassed exactly like
        # synth_proto does for OSPFv3).
        self.g0_addr = IPv4Address("10.255.0.2")
        self.g1_addr = IPv4Address("10.255.1.2")
        for ifname, net, our, nbr_idx, nbr_addr in (
            ("e0", "10.255.0.0/30", "10.255.0.1", self.g0, self.g0_addr),
            ("e1", "10.255.1.0/30", "10.255.1.1", self.g1, self.g1_addr),
        ):
            iface = self.inst.add_interface(
                ifname,
                IfConfig(if_type=IfType.POINT_TO_POINT, cost=1),
                IPv4Network(net),
                IPv4Address(our),
            )
            iface.state = IsmState.POINT_TO_POINT
            iface.neighbors[_rid(nbr_idx)] = Neighbor(
                router_id=_rid(nbr_idx), src=nbr_addr, state=NsmState.FULL
            )
        self.area = self.inst.areas[next(iter(self.inst.areas))]
        inner = getattr(self.loop, "loop", self.loop)  # ThreadedLoop hosts
        now = inner.clock.now()
        for i in range(n_routers):
            self.area.lsdb.install(self._router_lsa(i), now)
        # First full SPF + RIB sync (outside any storm measurement); a
        # ThreadedLoop host converges on its own pump thread instead.
        self.inst._schedule_spf()
        if hasattr(self.loop, "advance"):
            self.loop.advance(30.0)

    # -- LSA construction

    def _router_lsa(self, i: int) -> Lsa:
        seq = self._seq.get(i, 0) + 1
        self._seq[i] = seq
        links: list[RouterLink] = []
        if i == 0:
            links.append(
                _p2p(_rid(self.g0), IPv4Address("10.255.0.1"),
                     self.adj[0][self.g0])
            )
            links.append(
                _p2p(_rid(self.g1), IPv4Address("10.255.1.1"),
                     self.adj[0][self.g1])
            )
        else:
            for peer, metric in sorted(self.adj[i].items()):
                if (min(i, peer), max(i, peer)) in self.down:
                    continue
                links.append(_p2p(_rid(peer), IPv4Address(0), metric))
        if i and i in self._stub_set():
            links.append(
                _stub(IPv4Network(((172 << 24) | (i << 8), 24)), 1)
            )
        lsa = Lsa(
            age=1,
            options=Options(0x02),
            type=LsaType.ROUTER,
            lsid=_rid(i),
            adv_rtr=_rid(i),
            seq_no=seq,
            body=LsaRouter(links=links),
        )
        # §13.2 change detection compares the encoded body bytes —
        # synthetic LSAs must carry a real wire image.
        lsa.encode()
        return lsa

    def _stub_set(self) -> set[int]:
        s = getattr(self, "_stub_cache", None)
        if s is None:
            s = self._stub_cache = set(self.stub_owners)
        return s

    # -- storm event primitives (called by run_storm)

    def _deliver(self, lsas: list, eid, delay: float = 0.0) -> None:
        msg = _ApplyLsas(lsas, (eid,) if eid is not None else None)
        if delay > 0.0:
            t = self.loop.timer(self.ACTOR, lambda m=msg: m)
            t.start(delay)
        else:
            self.loop.send(self.ACTOR, msg)

    def apply_lsas(self, lsas: list) -> None:
        """Runs inside the storm actor (causal context already active
        via the delivery hook)."""
        for lsa in lsas:
            self.inst._install_and_flood(self.area, lsa)
        # The synthetic neighbors ack instantly: drop retransmit state
        # so the storm's timer load stays bounded.
        for area in self.inst.areas.values():
            for iface in area.interfaces.values():
                for nbr in iface.neighbors.values():
                    nbr.ls_rxmt.clear()

    def flap(self, edge: tuple[int, int], lost: bool) -> int | None:
        """Toggle ``edge``; both endpoint LSAs (re)install as one causal
        LSA-arrival event.  ``lost`` defers the arrival by RXMT_DELAY."""
        if edge in self.down:
            self.down.discard(edge)
            state = "up"
        else:
            self.down.add(edge)
            state = "down"
        eid = convergence.begin(
            convergence.TRIGGER_LSA, edge=f"{edge[0]}-{edge[1]}", state=state
        )
        a, b = edge
        self._deliver(
            [self._router_lsa(a), self._router_lsa(b)],
            eid,
            delay=RXMT_DELAY if lost else 0.0,
        )
        return eid

    def bfd(self, gateway: int, state: str) -> None:
        addr = self.g0_addr if gateway == self.g0 else self.g1_addr
        ifname = "e0" if gateway == self.g0 else "e1"
        eid = convergence.begin(
            convergence.TRIGGER_BFD, state=state, ifname=ifname
        )
        with convergence.activation(eid):
            self.bus.publish(
                TOPIC_BFD_STATE, BfdStateUpd((ifname, addr), state)
            )

    def carrier(self, ifname: str, operative: bool) -> None:
        eid = convergence.begin(
            convergence.TRIGGER_CARRIER, ifname=ifname, operative=operative
        )
        with convergence.activation(eid):
            self.bus.publish(
                TOPIC_INTERFACE_UPD,
                InterfaceUpdMsg(ifname=ifname, ifindex=0,
                                operative=operative),
            )

    def ifconfig_metric(self) -> None:
        """Config event on the DUT: the e0 gateway link metric flips
        between 1 and 2 — a full-SPF-forcing change with real route
        movement (ECMP collapses to g1 and back)."""
        cur = self.adj[0][self.g0]
        self.adj[0][self.g0] = 2 if cur == 1 else 1
        self.adj[self.g0][0] = self.adj[0][self.g0]
        eid = convergence.begin(convergence.TRIGGER_IFCONFIG, ifname="e0")
        self._deliver([self._router_lsa(0)], eid)


class _StormActor(Actor):
    """Applies deferred/immediate LSA batches on the loop (the delivery
    hook re-activates each message's causal event context)."""

    def __init__(self, net: StormNet):
        self.net = net

    def handle(self, msg) -> None:
        if isinstance(msg, _ApplyLsas):
            self.net.apply_lsas(msg.lsas)


def _percentiles(values: list[float]) -> dict:
    if not values:
        return {"count": 0}
    arr = np.sort(np.asarray(values, np.float64))
    pick = lambda q: float(arr[min(len(arr) - 1, int(q * (len(arr) - 1)))])
    return {
        "count": len(arr),
        "p50": round(pick(0.50), 6),
        "p95": round(pick(0.95), 6),
        "p99": round(pick(0.99), 6),
        "max": round(float(arr[-1]), 6),
    }


def storm_report(timelines: list[dict]) -> dict:
    """Aggregate completed causal timelines into per-trigger
    event-to-FIB latency distributions, split by dispatch mode
    (batched-device vs scalar-fallback vs plain scalar)."""
    per: dict[tuple, list[float]] = {}
    outcomes: dict[str, int] = {}
    for rec in timelines:
        outcomes[rec["outcome"]] = outcomes.get(rec["outcome"], 0) + 1
        if rec["outcome"] != "converged":
            continue
        fib_t = next(
            (t for step, t, _ in rec["timeline"] if step in ("fib", "fallback")),
            None,
        )
        if fib_t is None:
            continue
        modes = set(rec["dispatch"].values())
        mode = (
            "fallback"
            if rec["fallback"]
            else ("device" if "device" in modes else "scalar")
        )
        per.setdefault((rec["trigger"], mode), []).append(fib_t)
        per.setdefault((rec["trigger"], "all"), []).append(fib_t)
    report: dict = {"outcomes": outcomes, "triggers": {}}
    for (trigger, mode), vals in sorted(per.items()):
        report["triggers"].setdefault(trigger, {})[mode] = _percentiles(vals)
    return report


def _instrument_dispatch_wall(net: StormNet):
    """Wrap the DUT backend's ``compute`` to attribute REAL (wall-clock)
    SPF dispatch seconds to the active causal triggers.

    The storm's event-to-FIB latencies are virtual-clock quantities —
    deterministic, but blind to how long the device work actually takes
    (the virtual clock does not advance while Python computes).  This
    sink is the DeltaPath headline instrument: the per-trigger
    dispatch-wall distribution is what the incremental path must shrink
    while the virtual timelines (and FIB digests) stay byte-identical.

    Returns ``(sink, restore)``; the harness calls ``restore`` when the
    storm ends so a caller-supplied backend leaves unwrapped (backends
    are parameters — reuse across storms must not nest timers).
    """
    sink: dict[str, list[float]] = {}
    backend = net.inst.backend
    inner = backend.compute

    def timed(topo, edge_mask=None, multipath_k: int = 1):
        t0 = time.perf_counter()
        res = inner(topo, edge_mask, multipath_k=multipath_k)
        dt = time.perf_counter() - t0
        for trig in set(convergence.active_triggers()) or {"untracked"}:
            sink.setdefault(trig, []).append(dt)
        return res

    backend.compute = timed

    def restore():
        backend.compute = inner

    return sink, restore


def storm_digest(timelines: list[dict]) -> str:
    """Canonical digest of the causal timelines for the determinism
    gate (same seed → same digest).  Trace span ids are stripped: the
    tracer's id counter is process-global and survives across runs."""

    def clean(rec: dict) -> dict:
        out = dict(rec)
        out["timeline"] = [
            [step, t, {k: v for k, v in attrs.items() if k != "span_id"}]
            for step, t, attrs in rec["timeline"]
        ]
        return out

    text = json.dumps([clean(r) for r in timelines], sort_keys=True)
    return hashlib.sha256(text.encode()).hexdigest()


def run_convergence_storm(
    n_routers: int = 2000,
    events: int = 200,
    seed: int = 7,
    spf_backend=None,
    tracker_capacity: int = 4096,
    drop_prob: float = 0.10,
    settle: float = 60.0,
    prefix_every: int = 8,
    max_paths: int | None = None,
    event_hook=None,
    device=None,
) -> tuple[dict, str, "StormNet"]:
    """One seeded convergence storm end to end.  Returns ``(report,
    digest, net)``; the report carries per-trigger p50/p95/p99/max
    event-to-FIB distributions split by dispatch mode.

    The event mix and every stochastic choice come from
    ``FaultPlan(seed)`` per-site streams, and time is virtual — two
    runs with one seed produce byte-identical digests.

    ``event_hook(net, index, now)`` — optional observer called after
    each event's inter-event gap has elapsed (and once more after the
    settle window, with ``index == events``).  The gNMI fan-out bench
    rides this seam: a subscriber fleet joins/leaves and the shared
    delta engine ticks at these deterministic virtual times.  The hook
    only READS daemon state — the storm's causal timelines and FIB
    digests are unaffected by its presence.

    ``spf_backend`` defaults to a :class:`TorchSpfBackend` on ``device``
    (the CUDA card unless ``device="cpu"``)."""
    plan = FaultPlan(seed=seed, drop_prob=drop_prob)
    inj = FaultInjector(plan)
    net = StormNet(
        n_routers=n_routers, seed=seed, spf_backend=spf_backend,
        prefix_every=prefix_every, max_paths=max_paths, device=device,
    )
    tracker = convergence.configure(
        tracker_capacity, clock=net.loop.clock.now
    )
    dispatch_wall, restore_dispatch = _instrument_dispatch_wall(net)
    try:
        mix_rng = inj._rng("storm.mix")
        loss_rng = inj._rng("storm.loss")
        gap_rng = inj._rng("storm.gap")
        bfd_down = carrier_down = False
        for ev_i in range(events):
            roll = mix_rng.random()
            if roll < 0.70:
                edge = net.flappable[
                    mix_rng.randrange(len(net.flappable))
                ]
                net.flap(edge, lost=loss_rng.random() < plan.drop_prob)
            elif roll < 0.82:
                net.bfd(net.g0, "up" if bfd_down else "down")
                bfd_down = not bfd_down
            elif roll < 0.90:
                net.carrier("e1", operative=carrier_down)
                carrier_down = not carrier_down
            else:
                net.ifconfig_metric()
            # Bursty inter-event gaps: mostly sub-second (a real flap
            # storm), occasionally a multi-second lull that lets the
            # delay FSM drain.
            gap = (
                0.05 + gap_rng.random() * 0.8
                if gap_rng.random() < 0.8
                else 2.0 + gap_rng.random() * 4.0
            )
            net.loop.advance(gap)
            if event_hook is not None:
                event_hook(net, ev_i, net.loop.clock.now())
        net.loop.advance(settle)
        if event_hook is not None:
            event_hook(net, events, net.loop.clock.now())
        swept = tracker.sweep()
        timelines = tracker.timelines()
        report = storm_report(timelines)
        report["events"] = events
        report["swept-open"] = swept
        report["n-routers"] = n_routers
        report["spf-runs"] = net.inst.spf_run_count
        report["fib-size"] = len(net.kernel.fib)
        # Multipath surface: cumulative installs that carried
        # real next-hop SETS / UCMP weight groups (cumulative, so a
        # storm that happens to END mid-failure — repairs holding
        # single-survivor sets — still reports the multipath activity).
        report["fib-multipath"] = getattr(
            net.kernel, "multipath_installs", 0
        )
        report["fib-weighted"] = getattr(net.kernel, "weighted_installs", 0)
        # REAL per-trigger dispatch seconds (never in the digest: wall
        # time is nondeterministic by nature; the determinism gate is
        # the virtual timelines + FIB digest above).
        report["dispatch-wall"] = {
            trig: _percentiles(vals)
            for trig, vals in sorted(dispatch_wall.items())
        }
        return report, storm_digest(timelines), net
    finally:
        restore_dispatch()
        convergence.configure(0)
