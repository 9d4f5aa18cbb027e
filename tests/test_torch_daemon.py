"""holod_torch.py: holo_tpu's daemon with the port behind ``backend tpu``.

Every arm runs holo_tpu's daemons on one MockFabric under a VirtualClock.
The launcher's arm runs inside ``holod_torch.launched("cpu")`` (the port's
plain kernels on the host), the other arms outside it: holo_tpu's own
``backend tpu`` (TpuSpfBackend on JAX-CPU, FrrEngine("tpu")) and ``scalar``.

- (a) a two-daemon pair converges on the launcher's backend class, its SPF
  log names the port, and its RIB equals both other arms';
- (b) commits keep one backend object per instance, and SPF runs one FRR
  engine per instance;
- (c) a seeded storm (six daemons, a ring with chords, 8 events: cost
  commits and link down/up, fast reroute on) gives every daemon the same FIB
  and backup sets after every event as the scalar run and as holo_tpu's
  ``backend tpu`` run (whose backups come from its scalar FRR engine: (d)
  holds the port's to FrrEngine("tpu"));
- (d) fast reroute with ``engine tpu`` on OSPFv2 and IS-IS (three daemons
  in a triangle, a metric commit and a link down): one kept port
  FrrEngine per instance, FIBs and backups equal to FrrEngine("tpu")'s run;
- (e) ``[pipeline]`` armed: the port's pipelined facades, holo_tpu's process
  pipeline left unarmed, a killed port worker respawned by the daemon's
  supervisor, the next SPF served;
- (f) ``/metrics`` (over HTTP on localhost) parses with each family once;
  the state leaf is JSON, holds the port's stats and names the device;
- (g) the bindings are holo_tpu's again after the block, also after a
  raise, and a daemon built then gets TpuSpfBackend; no card: no launch;
- (h) with ``convergence-events`` armed, an OSPF event's waterfall in the
  port's critical-path ledger carries the dispatch phases;
- (i) ``holod_torch.main`` is holo_tpu's ``main``: one tick of it from a
  ``holod.toml`` arms the port's breaker defaults, mesh, tuner, pipeline
  and watchdog (none of holo_tpu's), serves both registries on
  ``/metrics``, pumps a BGP instance's TCP transport, and flushes the
  port's tuner table on the way out;
- (j) a breaker deadline: on the CPU every SPF overruns, the oracle's
  fallback keeps the results and the pair converges as the scalar pair; on
  the card (no fallback) the launcher does not arm it.

Daemons are built through ``holo_tpu.daemon.daemon.Daemon`` as holo_tpu's
``main`` builds them: inside the launcher's block that name is the
launcher's class, which attaches each daemon to the port.

Tolerance: exact (FIBs, RIBs, backup sets as dicts and sets).
"""

from __future__ import annotations

import gc
import json
import re
import urllib.request
from ipaddress import ip_address

import numpy as np
import pytest

import holod_torch
from holo_tpu import pipeline as jpipeline
from holo_tpu.daemon import daemon as jdaemon
from holo_tpu.daemon import providers as jproviders
from holo_tpu.daemon.config import DaemonConfig
from holo_tpu.daemon.daemon import Daemon
from holo_tpu.frr.manager import FrrEngine as JFrrEngine
from holo_tpu.pipeline import dispatch as jdispatch
from holo_tpu.pipeline import tuner as jtuner
from holo_tpu.spf.backend import ScalarSpfBackend, TpuSpfBackend
from holo_tpu.telemetry import convergence as jconv
from holo_tpu.utils.netio import MockFabric
from holo_tpu.utils.runtime import EventLoop, VirtualClock
from holo_tpu_torch.frr.manager import FrrEngine
from holo_tpu_torch.pipeline import dispatch as tdispatch
from holo_tpu_torch.pipeline import tuner as ttuner
from holo_tpu_torch.resilience import FaultInjector, FaultPlan, inject
from holo_tpu_torch.telemetry import convergence as tconv
from holo_tpu_torch.telemetry import critpath as tcritpath

OSPF = "routing/control-plane-protocols/ospfv2"
ISIS = "routing/control-plane-protocols/isis"
# Six routers: a ring and two chords; link k is 10.0.k.0/30 (.1 on a, .2 on b).
LINKS = [(0, 1), (1, 2), (2, 3), (3, 4), (4, 5), (5, 0), (0, 3), (1, 4)]
# Three routers: a triangle.
TRIANGLE = [(0, 1), (1, 2), (2, 0)]


def _wiring(links):
    """{router: [(ifname, link, address, prefix len)]} in link order."""
    out: dict[int, list] = {}
    for k, (a, b) in enumerate(links):
        for end, r in ((1, a), (2, b)):
            ifs = out.setdefault(r, [])
            ifs.append((f"eth{len(ifs)}", k, f"10.0.{k}.{end}", 30))
    return out


def _ifname(wiring, r: int, k: int) -> str:
    return next(ifn for ifn, kk, _, _ in wiring[r] if kk == k)


def _network(backend: str, frr: str | None = None, links=LINKS, proto: str = "ospfv2",
             seed: int = 0):
    """Build and converge the daemons; link costs seeded (both ends alike)."""
    loop = EventLoop(clock=VirtualClock())
    fabric = MockFabric(loop)
    wiring = _wiring(links)
    costs = np.random.default_rng(seed).integers(1, 11, len(links))
    daemons = {}
    for r, ifs in sorted(wiring.items()):
        d = jdaemon.Daemon(loop=loop, netio=fabric, name=f"r{r}")
        daemons[r] = d
        for ifn, k, addr, _ in ifs:
            fabric.join(f"l{k}", f"r{r}.{proto}", ifn, ip_address(addr))
    for r, d in daemons.items():
        c = d.candidate()
        base = OSPF if proto == "ospfv2" else ISIS
        for ifn, k, addr, plen in wiring[r]:
            c.set(f"interfaces/interface[{ifn}]/address", [f"{addr}/{plen}"])
            if proto == "ospfv2":
                pre = f"{OSPF}/area[0.0.0.0]/interface[{ifn}]"
                c.set(f"{pre}/interface-type", "point-to-point")
                c.set(f"{pre}/cost", int(costs[k]))
            else:
                c.set(f"{ISIS}/interface[{ifn}]/metric", int(costs[k]))
        if proto == "ospfv2":
            c.set(f"{OSPF}/router-id", f"{r + 1}.{r + 1}.{r + 1}.{r + 1}")
            c.set(f"{OSPF}/spf-control/backend", backend)
        else:
            c.set(f"{ISIS}/system-id", f"0000.0000.000{r + 1}")
            c.set(f"{ISIS}/level", "level-2")
        if frr is not None:
            c.set(f"{base}/fast-reroute/lfa", True)
            c.set(f"{base}/fast-reroute/engine", frr)
        d.commit(c)
    loop.advance(60)
    return loop, fabric, daemons, wiring


def _snapshot(daemons) -> dict:
    """Each daemon's FIB (prefix -> sorted next hops, protocol) and backup
    sets (prefix -> {(primary, backup)})."""
    out = {}
    for r, d in daemons.items():
        k = d.routing.rib.kernel
        fib = {str(p): (sorted(str(nh.addr) for nh in nhs), str(proto))
               for p, (nhs, proto) in k.fib.items()}
        backups = {str(p): {(str(a.addr), str(b.addr)) for a, b in m.items()}
                   for p, m in k.backups.items()}
        out[r] = (fib, backups)
    return out


def _events(seed: int = 4) -> list[tuple]:
    """Eight events: cost commits (seeded link and cost) alternating with two
    seeded links going down and coming back up, one at a time."""
    rng = np.random.default_rng(seed)
    flap = rng.choice(len(LINKS), 2, replace=False)
    out = []
    for i in range(8):
        if i % 2 == 0:
            out.append(("cost", int(rng.integers(0, len(LINKS))), int(rng.integers(1, 21))))
        else:
            out.append(("down" if i % 4 == 1 else "up", int(flap[i // 4])))
    return out


def _ospf_parts(daemons):
    """{router: (backend, FRR engine)} of the OSPFv2 instances."""
    return {r: (d.routing.instances["ospfv2"].backend,
                d.routing.instances["ospfv2"]._frr_engine) for r, d in daemons.items()}


def _storm(backend: str, frr: str) -> dict:
    loop, fabric, daemons, wiring = _network(backend, frr)
    steps = [_snapshot(daemons)]
    parts = [_ospf_parts(daemons)]
    runs = [{r: d.routing.instances["ospfv2"].spf_run_count for r, d in daemons.items()}]
    for ev in _events():
        if ev[0] == "cost":
            _, k, cost = ev
            a = LINKS[k][0]
            c = daemons[a].candidate()
            c.set(f"{OSPF}/area[0.0.0.0]/interface[{_ifname(wiring, a, k)}]/cost", cost)
            daemons[a].commit(c)
        else:
            fabric.set_link_up(f"l{ev[1]}", ev[0] == "up")
        loop.advance(60)
        steps.append(_snapshot(daemons))
        parts.append(_ospf_parts(daemons))
        runs.append({r: d.routing.instances["ospfv2"].spf_run_count
                     for r, d in daemons.items()})
    logs = {r: d.routing.get_state()["routing"]["ospfv2"]["spf-log"][-1]["backend"]
            for r, d in daemons.items()}
    return {"steps": steps, "parts": parts, "runs": runs, "logs": logs}


@pytest.fixture(scope="module", autouse=True)
def _collect():
    """Daemons hold their instances (and so the port's backends and their
    resident planes) in reference cycles: collect them before the next file,
    whose residency counts would otherwise drop when its own collection runs."""
    yield
    gc.collect()


@pytest.fixture(scope="module")
def storms():
    with holod_torch.launched("cpu") as launcher:
        port = _storm("tpu", "tpu")
        port["launcher"] = launcher
    return {"port": port, "scalar": _storm("scalar", "scalar"),
            "jax": _storm("tpu", "scalar")}


@pytest.fixture
def telemetry_off():
    """Disarm what a daemon's [telemetry] section armed process-wide."""
    yield
    jconv.configure(0)
    tconv.configure(0)
    tcritpath.configure(0)


# -- (a) the pair


def _pair(backend: str, config=None):
    loop = EventLoop(clock=VirtualClock())
    fabric = MockFabric(loop)
    d1 = jdaemon.Daemon(config=config, loop=loop, netio=fabric, name="d1")
    d2 = jdaemon.Daemon(config=config, loop=loop, netio=fabric, name="d2")
    # Two links: a /30 between them and a stub /24 behind each.
    fabric.join("l12", "d1.ospfv2", "eth0", ip_address("10.0.12.1"))
    fabric.join("l12", "d2.ospfv2", "eth0", ip_address("10.0.12.2"))
    for d, rid, addr, stub in ((d1, "1.1.1.1", "10.0.12.1/30", "10.1.0.1/24"),
                               (d2, "2.2.2.2", "10.0.12.2/30", "10.2.0.1/24")):
        c = d.candidate()
        c.set("interfaces/interface[eth0]/address", [addr])
        c.set("interfaces/interface[eth1]/address", [stub])
        c.set(f"{OSPF}/router-id", rid)
        c.set(f"{OSPF}/spf-control/backend", backend)
        c.set(f"{OSPF}/area[0.0.0.0]/interface[eth0]/interface-type", "point-to-point")
        c.set(f"{OSPF}/area[0.0.0.0]/interface[eth1]/passive", True)
        d.commit(c)
    loop.advance(60)
    return loop, d1, d2


def _rib(d) -> dict:
    return {str(p): (str(r.protocol), r.metric, sorted(str(nh.addr) for nh in r.nexthops))
            for p, r in d.routing.rib.active_routes().items()}


def test_pair_converges_on_the_launcher_backend_as_holo_tpu():
    with holod_torch.launched("cpu") as launcher:
        loop, d1, d2 = _pair("tpu")
        inst = d1.routing.instances["ospfv2"]
        assert type(inst.backend) is launcher.spf_backend_class
        assert str(inst.backend.device) == "cpu"
        state = d1.routing.get_state()["routing"]["ospfv2"]
        assert state["neighbors"]["2.2.2.2"]["state"] == "full"
        assert state["spf-log"][-1]["backend"] == "torch"
        got = (_rib(d1), _rib(d2))
    assert "10.2.0.0/24" in got[0] and got[0]["10.2.0.0/24"][0] == "Protocol.OSPFV2"
    _, j1, j2 = _pair("tpu")
    assert isinstance(j1.routing.instances["ospfv2"].backend, TpuSpfBackend)
    _, s1, s2 = _pair("scalar")
    assert got == (_rib(j1), _rib(j2)) == (_rib(s1), _rib(s2))


# -- (b)-(d) the storm


def test_storm_fibs_and_backups_equal_scalar_and_jax_after_every_event(storms):
    port, scalar, jax = storms["port"], storms["scalar"], storms["jax"]
    assert len(port["steps"]) == 9
    for i, (p, s, j) in enumerate(zip(port["steps"], scalar["steps"], jax["steps"])):
        assert p == s, f"event {i}: the port's FIBs differ from the scalar run"
        assert p == j, f"event {i}: the port's FIBs differ from holo_tpu's backend tpu"
    # The storm moved routes, and fast reroute protected some of them.
    assert port["steps"][0] != port["steps"][-1]
    assert any(backups for fib, backups in port["steps"][0].values())
    assert set(port["logs"].values()) == {"torch"}
    assert set(jax["logs"].values()) == {"tpu"}


def test_storm_keeps_one_backend_and_one_frr_engine_per_instance(storms):
    port = storms["port"]
    cls = port["launcher"].spf_backend_class
    first = port["parts"][0]
    for parts in port["parts"]:
        for r, (backend, engine) in parts.items():
            assert backend is first[r][0] and type(backend) is cls
            assert engine is first[r][1] and type(engine).__mro__[1] is FrrEngine
            assert engine.engine == "torch" and engine.policy.engine == "torch"
            assert engine.policy.enabled and not engine.policy.remote_lfa
    # SPF ran again after the storm's events, on the same objects.
    assert all(port["runs"][-1][r] > port["runs"][0][r] for r in first)
    assert all(e.dispatches["device"] > 1 for _, e in first.values())
    assert all(e.dispatches["fallback"] == 0 for _, e in first.values())
    jax = storms["jax"]["parts"][0]
    assert all(type(b) is TpuSpfBackend for b, _ in jax.values())


def _frr_run(proto: str, backend: str):
    """Fast reroute with engine tpu on the triangle: converge, a metric
    commit, a link down; (snapshots, engines) at the start and end."""
    loop, fabric, daemons, wiring = _network(backend, "tpu", TRIANGLE, proto)
    engines = [{r: d.routing.instances[proto]._frr_engine for r, d in daemons.items()}]
    steps = [_snapshot(daemons)]
    c = daemons[0].candidate()
    ifn = _ifname(wiring, 0, 0)
    c.set(f"{OSPF}/area[0.0.0.0]/interface[{ifn}]/cost" if proto == "ospfv2"
          else f"{ISIS}/interface[{ifn}]/metric", 17)
    daemons[0].commit(c)
    loop.advance(30)
    fabric.set_link_up("l1", False)
    loop.advance(60)
    steps.append(_snapshot(daemons))
    engines.append({r: d.routing.instances[proto]._frr_engine for r, d in daemons.items()})
    return steps, engines


@pytest.mark.parametrize("proto", ["ospfv2", "isis"])
def test_fast_reroute_on_the_port_engine_equals_frr_engine_tpu(proto):
    with holod_torch.launched("cpu"):
        got, engines = _frr_run(proto, "tpu")
    # holo_tpu's arm: its FrrEngine("tpu") beside the scalar SPF, whose
    # results equal TpuSpfBackend's (test (c)).
    want, jengines = _frr_run(proto, "scalar")
    assert got == want
    assert any(backups for fib, backups in got[0].values())
    assert got[0] != got[1]
    for r, e in engines[0].items():
        assert e is engines[1][r] and isinstance(e, FrrEngine) and e.engine == "torch"
        assert e.dispatches["device"] >= 2 and e.dispatches["fallback"] == 0
    assert all(isinstance(e, JFrrEngine) and e.engine == "tpu" for e in jengines[1].values())


# -- (e) the pipeline


def _pipeline_config() -> DaemonConfig:
    cfg = DaemonConfig()
    cfg.parallel.enabled = False
    cfg.pipeline.enabled = True
    cfg.pipeline.tuner = True
    cfg.resilience.restart_base_delay = 0.5
    return cfg


def test_pipeline_armed_runs_the_port_facades_and_respawns_a_killed_worker():
    cfg = _pipeline_config()
    with holod_torch.launched("cpu") as launcher:
        # Armed through holo_tpu's own names, as its main arms them at boot.
        jpipeline.configure_engine_tuner(path=cfg.pipeline.tuner_cache)
        jpipeline.configure_process_pipeline(depth=cfg.pipeline.depth,
                                             capacity=cfg.pipeline.queue)
        assert jdispatch.process_pipeline() is None and jtuner.active_tuner() is None
        pipe = tdispatch.process_pipeline()
        assert pipe is not None and jpipeline.active_tuner() is ttuner.active_tuner() is not None
        loop = EventLoop(clock=VirtualClock())
        fabric = MockFabric(loop)
        daemons = {}
        for name, addr in (("d1", "10.0.12.1"), ("d2", "10.0.12.2")):
            daemons[name] = jdaemon.Daemon(config=cfg, loop=loop, netio=fabric, name=name)
            assert type(daemons[name]) is launcher.daemon_class
            fabric.join("l12", f"{name}.ospfv2", "eth0", ip_address(addr))
        for name, d in daemons.items():
            c = d.candidate()
            c.set("interfaces/interface[eth0]/address", [f"10.0.12.{name[1]}/30"])
            c.set("interfaces/interface[eth1]/address", [f"10.{name[1]}.0.1/24"])
            c.set(f"{OSPF}/router-id", f"{name[1]}.{name[1]}.{name[1]}.{name[1]}")
            c.set(f"{OSPF}/spf-control/backend", "tpu")
            c.set(f"{OSPF}/fast-reroute/lfa", True)
            c.set(f"{OSPF}/fast-reroute/engine", "tpu")
            c.set(f"{OSPF}/area[0.0.0.0]/interface[eth0]/interface-type", "point-to-point")
            c.set(f"{OSPF}/area[0.0.0.0]/interface[eth1]/passive", True)
            d.commit(c)
        loop.advance(60)
        inst = daemons["d1"].routing.instances["ospfv2"]
        backend, engine = inst.backend, inst._frr_engine
        assert type(backend) is launcher.async_spf_class and backend.pipeline is pipe
        assert type(backend.inner) is launcher.spf_backend_class
        assert type(engine) is launcher.async_frr_class and engine.inner.engine == "torch"
        assert jdispatch.process_pipeline() is None
        assert "10.2.0.0/24" in _rib(daemons["d1"])
        stats = pipe.stats()
        assert stats["submitted"] > 0 and stats["dispatches"]
        # Kill the worker at its loop top; the supervisor respawns it.
        sup = daemons["d2"].supervisor
        with inject(FaultInjector(FaultPlan(seed=1, worker_kill={"pipeline.worker": 1}))) as inj:
            ticket = pipe.submit(("kill",), "spf", run=lambda: "served")
            for _ in range(200):
                if inj.injected.get("kill:pipeline.worker"):
                    break
                loop.advance(0.01)
            pipe._thread is None or pipe._thread.join(5.0)
            assert inj.injected["kill:pipeline.worker"] == 1
            loop.advance(5)
        assert sup.crashes.get("worker:pipeline") == 1
        assert ticket.result(5.0) == "served"
        assert pipe.stats()["worker-respawns"] >= 1
        runs = inst.spf_run_count
        c = daemons["d1"].candidate()
        c.set(f"{OSPF}/area[0.0.0.0]/interface[eth0]/cost", 25)
        daemons["d1"].commit(c)
        loop.advance(30)
        assert inst.spf_run_count > runs and inst.backend is backend
        assert _rib(daemons["d1"])["10.2.0.0/24"][1] == 35
    assert tdispatch.process_pipeline() is None and ttuner.active_tuner() is None


# -- (f) the telemetry surfaces


_SAMPLE = re.compile(r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? -?[0-9.e+-]+|NaN|[+-]Inf$')


def test_metrics_and_state_leaf_serve_the_port():
    cfg = DaemonConfig()
    cfg.parallel.enabled = False
    with holod_torch.launched("cpu"):
        loop, d1, d2 = _pair("tpu", config=cfg)
        server = d1.start_telemetry("127.0.0.1:0")
        try:
            host, port = server.server_address[:2]
            text = urllib.request.urlopen(f"http://{host}:{port}/metrics", timeout=10).read()
        finally:
            d1.stop()
        leaf = d1.northbound.get_state("holo-telemetry")
    text = text.decode()
    types = re.findall(r"^# TYPE (\S+) ", text, re.M)
    assert len(types) == len(set(types)) and len(types) > 20
    for line in text.splitlines():
        assert line.startswith("#") or _SAMPLE.match(line), line
    assert re.search(r'^holo_spf_dispatch_seconds_count\{backend="torch",kind="one"\} [1-9]',
                     text, re.M)
    assert "holo_ospf" in text or "holo_rib" in text or "holo_convergence" in text
    tree = json.loads(json.dumps(leaf))["holo-telemetry"]
    assert tree["device"] == "cpu"
    cache = tree["spf-graph-cache"]
    assert cache["per-device"]["cpu"]["entries"] >= 1 and cache["per-device"]["cpu"]["rows"] > 0
    assert tree["device-residency"]["planes"]["spf-graph"]["entries"] >= 1
    assert any(name.startswith("spf-dispatch") and "refusals" in snap
               for name, snap in tree["health"]["breakers"].items())
    names = [m["name"] for m in tree["metric"]]
    assert len(names) == len(set(names))


# -- (g) the bindings


def test_bindings_restored_after_the_block_and_after_a_raise():
    before = holod_torch.bindings()
    with holod_torch.launched("cpu") as launcher:
        inside = holod_torch.bindings()
        assert inside == launcher.replacements()
        assert inside["TpuSpfBackend"] is launcher.spf_backend_class
        assert inside["Daemon"] is launcher.daemon_class
        with pytest.raises(RuntimeError, match="already bound"):
            with holod_torch.launched("cpu"):
                pass
    assert holod_torch.bindings() == before
    with pytest.raises(KeyError):
        with holod_torch.launched("cpu"):
            raise KeyError("boom")
    assert holod_torch.bindings() == before
    assert before["TpuSpfBackend"] is TpuSpfBackend and before["Daemon"] is Daemon
    assert before["active_tuner"] is jtuner.active_tuner
    assert jproviders.TpuSpfBackend is TpuSpfBackend
    _, d1, _ = _pair("tpu")
    assert type(d1.routing.instances["ospfv2"].backend) is TpuSpfBackend
    _, s1, _ = _pair("scalar")
    assert type(s1.routing.instances["ospfv2"].backend) is ScalarSpfBackend


def test_no_card_no_launch(monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    before = holod_torch.bindings()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with holod_torch.launched():
            pass
    assert holod_torch.bindings() == before


# -- (h) the tracker bridge


def test_convergence_bridge_carries_ospf_events_into_the_port(telemetry_off):
    cfg = DaemonConfig()
    cfg.parallel.enabled = False
    cfg.telemetry.convergence_events = 256
    with holod_torch.launched("cpu") as launcher:
        loop, d1, d2 = _pair("tpu", config=cfg)
        ledger = tcritpath.configure(capacity=64, check_every=0)
        assert launcher.bridge.armed and jconv._CP_HOOK is launcher.bridge
        c = d1.candidate()
        c.set(f"{OSPF}/area[0.0.0.0]/interface[eth0]/cost", 9)
        d1.commit(c)
        loop.advance(30)
        port_done = tconv.tracker().timelines()
        holo_done = jconv.tracker().timelines()
        waterfalls = ledger.waterfalls()
        # A pair still open is an event holo_tpu has not closed either (an
        # SPF that changed no route); holo_tpu's sweep closes both.
        pairs = launcher.bridge.port_events()
        assert all(jconv.tracker()._events((h,)) for h in pairs)
        jconv.sweep()
        assert launcher.bridge.port_events() == {}
        assert tconv.tracker().stats()["open"] == 0
        swept = [t for t in tconv.tracker().timelines() if t["outcome"] == "no-fib"]
        assert len(swept) == len(pairs)
    assert jconv._CP_HOOK is None and tconv.tracker() is None
    converged = [t for t in port_done if t["outcome"] == "converged"]
    assert converged and all(t["dispatch"].get("spf") == "device" for t in converged)
    holo_ids = {t["eid"] for t in holo_done if t["outcome"] == "converged"}
    assert {dict(t["timeline"][0][2])["holo_event"] for t in converged} <= {
        str(e) for e in holo_ids}
    assert any(w["phases"]["marshal"] > 0 and "device" in w["phases"] for w in waterfalls)


# -- (i) holo_tpu's main under the launcher


def test_main_is_holo_tpus_main_with_the_port_armed_and_the_bgp_pump(tmp_path, monkeypatch):
    """holod_torch.main runs holo_tpu.daemon.daemon.main: its boot arms the
    port (breaker defaults, mesh, tuner, pipeline, watchdog) and none of
    holo_tpu's, /metrics serves both registries, and its loop pumps a BGP
    instance's TCP transport.  One tick: the wait after the pump stops it."""
    import os
    import socket

    from holo_tpu.daemon import hardening
    from holo_tpu.parallel import mesh as jmesh
    from holo_tpu.resilience import breaker as jbreaker
    from holo_tpu.utils import tcpio
    from holo_tpu_torch.parallel import mesh as tmesh
    from holo_tpu_torch.resilience import breaker as tbreaker
    from holo_tpu_torch.resilience import watchdog as twatchdog

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        bgp_port = s.getsockname()[1]
    cache = tmp_path / "tuner.json"
    conf = tmp_path / "holod.toml"
    conf.write_text(f"""
[grpc]
enabled = false
[telemetry]
enabled = true
address = "127.0.0.1:0"
[resilience]
breaker-failure-threshold = 7
[parallel]
batch = 2
[pipeline]
enabled = true
tuner-cache = "{cache}"
watchdog = true
[runtime]
isolation = "cooperative"
""")
    monkeypatch.setattr(os, "geteuid", lambda: 1000)  # no kernel link monitor
    seen: dict = {}
    attach = holod_torch.Launcher.attach

    def attached(launcher, daemon):
        seen["launcher"], seen["daemon"] = launcher, daemon
        attach(launcher, daemon)

    def handlers(shutdown_cb, dump_cb=None, flush_cb=None, postmortem_cb=None):
        # After the boot, before the loop: configure BGP over TCP and OSPF.
        d = seen["daemon"]
        c = d.candidate()
        base = "routing/control-plane-protocols/bgp"
        c.set(f"{base}/as", 65001)
        c.set(f"{base}/router-id", "1.1.1.1")
        c.set(f"{base}/transport", "tcp")
        c.set(f"{base}/port", bgp_port)
        c.set("interfaces/interface[eth0]/address", ["10.9.0.1/24"])
        c.set(f"{OSPF}/router-id", "1.1.1.1")
        c.set(f"{OSPF}/spf-control/backend", "tpu")
        c.set(f"{OSPF}/area[0.0.0.0]/interface[eth0]/passive", True)
        d.commit(c)
        seen["handlers"] = shutdown_cb

    real_pump = tcpio.pump_once

    def pump(ios, timeout_ms=50):
        seen.setdefault("pumped", []).append(list(ios))
        return real_pump(ios, timeout_ms=timeout_ms)

    def wait(ios, timeout_ms):
        d = seen["daemon"]
        seen["waited"] = list(ios)
        seen["armed"] = (tdispatch.process_pipeline() is not None,
                         twatchdog.process_watchdog() is not None,
                         ttuner.active_tuner() is not None, tmesh.process_mesh().size,
                         tbreaker.DEFAULTS["failure_threshold"])
        seen["unarmed"] = (jdispatch.process_pipeline(), jtuner.active_tuner(),
                           jmesh.process_mesh(), jbreaker.DEFAULTS["failure_threshold"])
        seen["backend"] = d.routing.instances["ospfv2"].backend
        host, port = d._telemetry_server.server_address[:2]
        seen["metrics"] = urllib.request.urlopen(f"http://{host}:{port}/metrics",
                                                 timeout=10).read().decode()
        raise KeyboardInterrupt  # main's own stop path: daemon.stop(), tuner flush

    monkeypatch.setattr(holod_torch.Launcher, "attach", attached)
    monkeypatch.setattr(hardening, "install_signal_handlers", handlers)
    monkeypatch.setattr(tcpio, "pump_once", pump)
    monkeypatch.setattr(tcpio, "wait_ready", wait)
    before = holod_torch.bindings()
    threshold = tbreaker.DEFAULTS["failure_threshold"]
    try:
        holod_torch.main(["-f", str(conf), "--device", "cpu"])
    finally:
        io = getattr(seen.get("daemon") and seen["daemon"].routing, "bgp_tcp_io", None)
        if io is not None:
            io.close()
    d = seen["daemon"]
    assert type(d) is seen["launcher"].daemon_class and "handlers" in seen
    assert d.routing.bgp_tcp_io is not None
    assert seen["pumped"] == [[d.routing.bgp_tcp_io]] and seen["waited"] == [d.routing.bgp_tcp_io]
    assert seen["armed"] == (True, True, True, 2, 7)
    assert seen["unarmed"] == (None, None, None, threshold)
    assert type(seen["backend"].inner) is seen["launcher"].spf_backend_class
    types = re.findall(r"^# TYPE (\S+) ", seen["metrics"], re.M)
    assert len(types) == len(set(types)) and "holo_pipeline_queue_depth" in types
    # Both packages declare the mesh gauge: the port's (armed) samples serve.
    assert re.search(r'^holo_parallel_mesh_size\{axis="batch"\} 2', seen["metrics"], re.M)
    assert cache.exists()  # the port's tuner, flushed by main's exit path
    assert holod_torch.bindings() == before and tdispatch.process_pipeline() is None
    assert tbreaker.DEFAULTS["failure_threshold"] == threshold


# -- (j) the breaker deadline


def test_breaker_deadline_on_the_cpu_keeps_results_and_is_dropped_on_the_card(monkeypatch):
    """On the CPU the oracle is the fallback: an overrun is counted, its
    result kept, and the OSPF pair converges as the scalar pair.  On the card
    no fallback serves an overrun, so the launcher does not arm a deadline."""
    from holo_tpu.resilience import breaker as jbreaker
    from holo_tpu_torch.resilience import breaker as tbreaker

    saved = dict(tbreaker.DEFAULTS)
    with holod_torch.launched("cpu"):
        jbreaker.configure_defaults(failure_threshold=2, deadline=1e-9)
        assert tbreaker.DEFAULTS["deadline"] == 1e-9 and jbreaker.DEFAULTS["deadline"] is None
        loop, d1, d2 = _pair("tpu")
        breaker = d1.routing.instances["ospfv2"].backend.breaker
        got = (_rib(d1), _rib(d2))
    assert tbreaker.DEFAULTS == saved
    assert breaker.failures["deadline"] >= 1 and breaker.deadline == 1e-9
    _, s1, s2 = _pair("scalar")
    assert got == (_rib(s1), _rib(s2)) and "10.2.0.0/24" in got[0]
    monkeypatch.setattr("torch.cuda.is_available", lambda: True)
    with holod_torch.launched("cuda") as launcher:
        assert launcher.device.type == "cuda"
        jbreaker.configure_defaults(failure_threshold=2, deadline=0.05)
        assert tbreaker.DEFAULTS["deadline"] is None
        assert tbreaker.DEFAULTS["failure_threshold"] == 2
    assert tbreaker.DEFAULTS == saved
