"""The port's own daemon (``holo_tpu_torch.daemon``, run by ``holod_torch.py``)
against ``holo_tpu``'s daemon on the CPU.

The two packages' daemons cannot share one event loop, so each package runs
its own network: the same configuration trees are committed through each
daemon's northbound, the same event script is replayed, and the results are
compared.  The port's daemons run with ``device="cpu"`` (the port's plain
PyTorch versions of the kernels behind ``backend tpu``); ``holo_tpu``'s run
``backend scalar`` and ``backend tpu`` (TpuSpfBackend on JAX-CPU).

- (a) a two-daemon pair converges on the port's backend class, its SPF log
  names the port, and its RIB equals both ``holo_tpu`` arms';
- (c) a seeded storm (``holo_tpu_torch.daemon.scenario``: six daemons, a
  ring with chords, 8 events: cost commits and link down/up, fast reroute
  on) gives every daemon the same FIB
  and backup sets after every event as ``holo_tpu``'s scalar run and its
  ``backend tpu`` run (whose backups come from its scalar FRR engine: (d)
  holds the port's to ``FrrEngine("tpu")``);
- (b) commits keep one backend object per instance, and SPF runs one FRR
  engine per instance;
- (d) fast reroute with ``engine tpu`` on OSPFv2 (three daemons in a
  triangle, a metric commit and a link down): one kept port FrrEngine per
  instance, FIBs and backups equal to ``FrrEngine("tpu")``'s run; the
  configuration of each protocol the port has not ported (IS-IS among them)
  fails the commit with its ROADMAP item named;
- (e) ``[pipeline]`` armed: the port's pipelined facades, a killed worker
  respawned by the daemon's supervisor, the next SPF served and its RIB
  equal to ``holo_tpu``'s;
- (f) ``/metrics`` (over HTTP on localhost) parses with each family once;
  the state leaf is JSON, holds the port's stats and names the device;
- (g) no card: the daemon and ``main`` refuse to start;
- (h) with ``convergence-events`` armed, an OSPF event's waterfall in the
  port's critical-path ledger carries the dispatch phases, and the
  tracker's events are ``holo_tpu``'s;
- (i) one tick of ``holod_torch.main`` from a ``holod.toml`` with gRPC on,
  in a subprocess: the port's breaker defaults, mesh, tuner, pipeline and
  watchdog armed, a configuration committed over gRPC builds a
  ``TorchSpfBackend`` instance on its own thread, ``/metrics`` served, the
  tuner table flushed on the way out, and neither ``jax`` nor ``holo_tpu``
  in ``sys.modules``;
- (j) a breaker deadline: on the CPU every SPF overruns, the oracle's
  fallback keeps the results and the pair converges as the scalar pair; on
  the card (no fallback) ``main`` does not arm it;
- (k) the port's daemons boot from the ``[database]`` files ``holo_tpu``'s
  daemons wrote (a rollback to the last transaction restores its
  configuration) with FIBs equal to the writers'.

Tolerance: exact (FIBs, RIBs, backup sets as dicts and sets).
"""

from __future__ import annotations

import gc
import json
import re
import subprocess
import sys
import urllib.request
from ipaddress import ip_address
from pathlib import Path
from types import SimpleNamespace

import pytest

import holod_torch
from holo_tpu.daemon import daemon as jdaemon
from holo_tpu.daemon.config import DaemonConfig as JDaemonConfig
from holo_tpu.frr.manager import FrrEngine as JFrrEngine
from holo_tpu.spf.backend import ScalarSpfBackend as JScalarSpfBackend
from holo_tpu.spf.backend import TpuSpfBackend
from holo_tpu.telemetry import convergence as jconv
from holo_tpu.utils import netio as jnetio
from holo_tpu.utils import runtime as jruntime
from holo_tpu_torch.daemon import daemon as tdaemon
from holo_tpu_torch.daemon import hardening, scenario
from holo_tpu_torch.daemon.config import DaemonConfig
from holo_tpu_torch.frr.manager import FrrEngine
from holo_tpu_torch.northbound.provider import CommitError
from holo_tpu_torch.pipeline import dispatch as tdispatch
from holo_tpu_torch.pipeline import tuner as ttuner
from holo_tpu_torch.resilience import FaultInjector, FaultPlan, inject
from holo_tpu_torch.resilience import breaker as tbreaker
from holo_tpu_torch.spf.backend import TorchSpfBackend
from holo_tpu_torch.telemetry import convergence as tconv
from holo_tpu_torch.telemetry import critpath as tcritpath
from holo_tpu_torch.utils import netio as tnetio
from holo_tpu_torch.utils import runtime as truntime

ROOT = Path(__file__).resolve().parent.parent
OSPF = scenario.OSPF
# Three routers: a triangle.
TRIANGLE = [(0, 1), (1, 2), (2, 0)]

# Each package's daemon and simulation pieces; the port's daemons run on the CPU.
J = SimpleNamespace(Daemon=jdaemon.Daemon, Config=JDaemonConfig, MockFabric=jnetio.MockFabric,
                    EventLoop=jruntime.EventLoop, VirtualClock=jruntime.VirtualClock, kw={})
T = SimpleNamespace(Daemon=tdaemon.Daemon, Config=DaemonConfig, MockFabric=tnetio.MockFabric,
                    EventLoop=truntime.EventLoop, VirtualClock=truntime.VirtualClock,
                    kw={"device": "cpu"})


@pytest.fixture(scope="module", autouse=True)
def _collect():
    """Daemons hold their instances (and so the port's backends and their
    resident planes) in reference cycles: collect them before the next file,
    whose residency counts would otherwise drop when its own collection runs."""
    yield
    gc.collect()


@pytest.fixture(scope="module")
def storms():
    return {"port": scenario.storm(T, "tpu", "tpu"),
            "scalar": scenario.storm(J, "scalar", "scalar"),
            "jax": scenario.storm(J, "tpu", "scalar")}


@pytest.fixture
def telemetry_off():
    """Disarm what a daemon's [telemetry] section armed process-wide."""
    yield
    jconv.configure(0)
    tconv.configure(0)
    tcritpath.configure(0)


# -- (a) the pair


def _pair(p, backend: str, config=None, cost: int | None = None):
    loop = p.EventLoop(clock=p.VirtualClock())
    fabric = p.MockFabric(loop)
    d1 = p.Daemon(config=config, loop=loop, netio=fabric, name="d1", **p.kw)
    d2 = p.Daemon(config=config, loop=loop, netio=fabric, name="d2", **p.kw)
    # Two links: a /30 between them and a stub /24 behind each.
    fabric.join("l12", "d1.ospfv2", "eth0", ip_address("10.0.12.1"))
    fabric.join("l12", "d2.ospfv2", "eth0", ip_address("10.0.12.2"))
    for d, rid, addr, stub in ((d1, "1.1.1.1", "10.0.12.1/30", "10.1.0.1/24"),
                               (d2, "2.2.2.2", "10.0.12.2/30", "10.2.0.1/24")):
        d.commit(_pair_config(d.candidate(), rid, addr, stub, backend))
    loop.advance(60)
    if cost is not None:
        c = d1.candidate()
        c.set(f"{OSPF}/area[0.0.0.0]/interface[eth0]/cost", cost)
        d1.commit(c)
        loop.advance(30)
    return loop, d1, d2


def _pair_config(c, rid, addr, stub, backend, frr: str | None = None):
    c.set("interfaces/interface[eth0]/address", [addr])
    c.set("interfaces/interface[eth1]/address", [stub])
    c.set(f"{OSPF}/router-id", rid)
    c.set(f"{OSPF}/spf-control/backend", backend)
    if frr is not None:
        c.set(f"{OSPF}/fast-reroute/lfa", True)
        c.set(f"{OSPF}/fast-reroute/engine", frr)
    c.set(f"{OSPF}/area[0.0.0.0]/interface[eth0]/interface-type", "point-to-point")
    c.set(f"{OSPF}/area[0.0.0.0]/interface[eth1]/passive", True)
    return c


def _rib(d) -> dict:
    return {str(p): (str(r.protocol), r.metric, sorted(str(nh.addr) for nh in r.nexthops))
            for p, r in d.routing.rib.active_routes().items()}


def test_pair_converges_on_the_port_backend_as_holo_tpu():
    loop, d1, d2 = _pair(T, "tpu")
    inst = d1.routing.instances["ospfv2"]
    assert type(inst.backend) is d1.routing.spf_backend_class
    assert isinstance(inst.backend, TorchSpfBackend) and str(inst.backend.device) == "cpu"
    state = d1.routing.get_state()["routing"]["ospfv2"]
    assert state["neighbors"]["2.2.2.2"]["state"] == "full"
    assert state["spf-log"][-1]["backend"] == "torch"
    got = (_rib(d1), _rib(d2))
    assert "10.2.0.0/24" in got[0] and got[0]["10.2.0.0/24"][0] == "Protocol.OSPFV2"
    _, j1, j2 = _pair(J, "tpu")
    assert isinstance(j1.routing.instances["ospfv2"].backend, TpuSpfBackend)
    _, s1, s2 = _pair(J, "scalar")
    assert type(s1.routing.instances["ospfv2"].backend) is JScalarSpfBackend
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
    first = port["parts"][0]
    for parts in port["parts"]:
        for r, (backend, engine) in parts.items():
            assert backend is first[r][0] and type(backend).__mro__[1] is TorchSpfBackend
            assert engine is first[r][1] and type(engine) is FrrEngine
            assert engine.engine == "torch" and engine.policy.engine == "torch"
            assert engine.policy.enabled and not engine.policy.remote_lfa
            assert str(backend.device) == str(engine.device) == "cpu"
    # SPF ran again after the storm's events, on the same objects.
    assert all(port["runs"][-1][r] > port["runs"][0][r] for r in first)
    assert port["runs"] == storms["scalar"]["runs"] == storms["jax"]["runs"]
    assert all(e.dispatches["device"] > 1 for _, e in first.values())
    assert all(e.dispatches["fallback"] == 0 for _, e in first.values())
    jax = storms["jax"]["parts"][0]
    assert all(type(b) is TpuSpfBackend for b, _ in jax.values())


def _frr_run(p, backend: str):
    """Fast reroute with engine tpu on the triangle: converge, a metric
    commit, a link down; (snapshots, engines) at the start and end."""
    loop, fabric, daemons, wires = scenario.network(p, backend, "tpu", TRIANGLE)
    engines = [{r: d.routing.instances["ospfv2"]._frr_engine for r, d in daemons.items()}]
    steps = [scenario.snapshot(daemons)]
    scenario.commit(daemons[0], {
        f"{OSPF}/area[0.0.0.0]/interface[{scenario.ifname(wires, 0, 0)}]/cost": 17})
    loop.advance(30)
    fabric.set_link_up("l1", False)
    loop.advance(60)
    steps.append(scenario.snapshot(daemons))
    engines.append({r: d.routing.instances["ospfv2"]._frr_engine for r, d in daemons.items()})
    return steps, engines


def test_fast_reroute_on_the_port_engine_equals_frr_engine_tpu():
    got, engines = _frr_run(T, "tpu")
    # holo_tpu's arm: its FrrEngine("tpu") beside the scalar SPF, whose
    # results equal TpuSpfBackend's (test (c)).
    want, jengines = _frr_run(J, "scalar")
    assert got == want
    assert any(backups for fib, backups in got[0].values())
    assert got[0] != got[1]
    for r, e in engines[0].items():
        assert e is engines[1][r] and isinstance(e, FrrEngine) and e.engine == "torch"
        assert e.dispatches["device"] >= 2 and e.dispatches["fallback"] == 0
    assert all(isinstance(e, JFrrEngine) and e.engine == "tpu" for e in jengines[1].values())


UNPORTED = {
    "isis": ("A16", {"system-id": "0000.0000.0001", "level": "level-2"}),
    "ospfv3": ("A15", {"router-id": "1.1.1.1"}),
    "ripv2": ("A17", {"interface[eth0]/split-horizon": "simple"}),
    "ripng": ("A17", {"interface[eth0]/split-horizon": "simple"}),
    "bgp": ("A17", {"as": 65001, "router-id": "1.1.1.1"}),
    "vrrp": ("A17", {"instance[1]/interface": "eth0", "instance[1]/priority": 100}),
    "igmp": ("A17", {"interface[eth0]/version": 2}),
    "ldp": ("A17", {"lsr-id": "1.1.1.1"}),
}


@pytest.mark.parametrize("proto", sorted(UNPORTED))
def test_unported_protocol_config_fails_the_commit_with_its_item(proto):
    item, leaves = UNPORTED[proto]
    loop, d1, _ = _pair(T, "scalar")
    before = d1.northbound.running.to_json()
    c = d1.candidate()
    for leaf, value in leaves.items():
        c.set(f"routing/control-plane-protocols/{proto}/{leaf}", value)
    with pytest.raises(CommitError, match=rf"{proto}: .*not ported.*ROADMAP {item}\)"):
        d1.commit(c)
    assert d1.northbound.running.to_json() == before
    assert list(d1.routing.instances) == ["ospfv2"]
    # holo_tpu's daemon accepts the same tree (its instance exists).
    _, j1, _ = _pair(J, "scalar")
    jc = j1.candidate()
    for leaf, value in leaves.items():
        jc.set(f"routing/control-plane-protocols/{proto}/{leaf}", value)
    j1.commit(jc)
    assert j1.northbound.running.get(f"routing/control-plane-protocols/{proto}")


# -- (e) the pipeline


def test_pipeline_armed_runs_the_port_facades_and_respawns_a_killed_worker():
    cfg = DaemonConfig()
    cfg.parallel.enabled = False
    cfg.pipeline.enabled = True
    cfg.resilience.restart_base_delay = 0.5
    # Armed as main arms them at boot.
    ttuner.configure_engine_tuner(path=None)
    pipe = tdispatch.configure_process_pipeline(depth=cfg.pipeline.depth,
                                                capacity=cfg.pipeline.queue)
    try:
        loop = T.EventLoop(clock=T.VirtualClock())
        fabric = T.MockFabric(loop)
        daemons = {}
        for name, addr in (("d1", "10.0.12.1"), ("d2", "10.0.12.2")):
            daemons[name] = T.Daemon(config=cfg, loop=loop, netio=fabric, name=name,
                                     device="cpu")
            fabric.join("l12", f"{name}.ospfv2", "eth0", ip_address(addr))
        for name, d in daemons.items():
            n = name[1]
            d.commit(_pair_config(d.candidate(), f"{n}.{n}.{n}.{n}", f"10.0.12.{n}/30",
                                  f"10.{n}.0.1/24", "tpu", frr="tpu"))
        loop.advance(60)
        inst = daemons["d1"].routing.instances["ospfv2"]
        backend, engine = inst.backend, inst._frr_engine
        assert type(backend) is tdispatch.AsyncSpfBackend and backend.pipeline is pipe
        assert type(backend.inner) is daemons["d1"].routing.spf_backend_class
        assert type(engine) is tdispatch.AsyncFrrEngine and engine.inner.engine == "torch"
        assert "10.2.0.0/24" in _rib(daemons["d1"])
        stats = pipe.stats()
        assert stats["submitted"] > 0 and stats["dispatches"]
        # Kill the worker at its loop top; the daemon's supervisor respawns it.
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
        got = _rib(daemons["d1"])
    finally:
        tdispatch.reset_process_pipeline()
        ttuner.reset_engine_tuner()
    assert got["10.2.0.0/24"][1] == 35
    _, j1, _ = _pair(J, "scalar", cost=25)
    assert got == _rib(j1)


# -- (f) the telemetry surfaces


_SAMPLE = re.compile(r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? -?[0-9.e+-]+|NaN|[+-]Inf$')


def test_metrics_and_state_leaf_serve_the_port():
    cfg = DaemonConfig()
    cfg.parallel.enabled = False
    loop, d1, d2 = _pair(T, "tpu", config=cfg)
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
    assert set(tree["health"]["supervision"]) == {"degraded-actors", "restarts", "crashes"}
    names = [m["name"] for m in tree["metric"]]
    assert len(names) == len(set(names))


# -- (g) no card


def test_no_card_no_launch(monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.Daemon(clock=T.VirtualClock())
    assert str(T.Daemon(clock=T.VirtualClock(), device="cpu").routing.device) == "cpu"
    built = []
    monkeypatch.setattr(tdaemon, "DaemonConfig", lambda: built.append(1))
    for argv in (["--device", "cuda"], []):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            holod_torch.main(argv)
    assert built == []  # refused before the static config was read


# -- (h) the convergence waterfall


def test_convergence_waterfall_in_the_critical_path_ledger(telemetry_off):
    def run(p):
        cfg = p.Config()
        cfg.parallel.enabled = False
        cfg.telemetry.convergence_events = 256
        loop, d1, d2 = _pair(p, "tpu", config=cfg)
        ledger = tcritpath.configure(capacity=64, check_every=0) if p is T else None
        c = d1.candidate()
        c.set(f"{OSPF}/area[0.0.0.0]/interface[eth0]/cost", 9)
        d1.commit(c)
        loop.advance(30)
        tracker = (tconv if p is T else jconv).tracker()
        return tracker.timelines(), ledger and ledger.waterfalls()

    port, waterfalls = run(T)
    jax, _ = run(J)
    converged = [t for t in port if t["outcome"] == "converged"]
    assert converged and all(t["dispatch"].get("spf") == "device" for t in converged)
    assert any(w["phases"]["marshal"] > 0 and "device" in w["phases"] for w in waterfalls)

    def events(timelines):
        return sorted((t["trigger"], t["outcome"]) for t in timelines)

    assert events(port) == events(jax)


# -- (i) holod_torch.main, one tick, in a process of its own

_MAIN_TICK = r"""
import json, os, sys, time, types, urllib.request
sys.path.insert(0, ROOT)
import holod_torch
from holo_tpu_torch.daemon import daemon as D, hardening
from holo_tpu_torch.daemon.grpc_server import NorthboundClient
from holo_tpu_torch.daemon import holo_tpu_pb2 as pb
from holo_tpu_torch.parallel import mesh
from holo_tpu_torch.pipeline import dispatch, tuner
from holo_tpu_torch.resilience import breaker, watchdog

os.geteuid = lambda: 1000  # no kernel link monitor
seen = {}


class Recorded(D.Daemon):
    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        seen["daemon"] = self


def handlers(shutdown_cb, dump_cb=None, postmortem_cb=None):
    seen["stop"] = shutdown_cb


def tick(wait):
    # main's wait after its first pass over the loop: configure over gRPC,
    # read the armed state and /metrics, then stop.
    if "stop" in seen and "done" not in seen:
        seen["done"] = True
        d = seen["daemon"]
        client = NorthboundClient(f"127.0.0.1:{d._grpc_server._bound_port}")
        base = "routing/control-plane-protocols/ospfv2"
        edits = [("interfaces/interface[eth0]/address", '["10.9.0.1/24"]'),
                 (f"{base}/router-id", "1.1.1.1"), (f"{base}/spf-control/backend", "tpu"),
                 (f"{base}/area[0.0.0.0]/interface[eth0]/passive", "true")]
        resp = client.Commit(pb.CommitRequest(
            operation=pb.CommitOperation.CHANGE,
            edits=[pb.PathEdit(path=p, value=v) for p, v in edits]), timeout=60)
        caps = client.Capabilities(pb.CapabilitiesRequest(), timeout=60)
        inst = d.routing.instances["ospfv2"]
        host, port = d._telemetry_server.server_address[:2]
        text = urllib.request.urlopen(f"http://{host}:{port}/metrics", timeout=10).read().decode()
        seen["out"] = {
            "commit": [resp.transaction_id, resp.error], "version": caps.version,
            "armed": [dispatch.process_pipeline() is not None,
                      watchdog.process_watchdog() is not None,
                      tuner.active_tuner() is not None, mesh.process_mesh().size,
                      breaker.DEFAULTS["failure_threshold"]],
            "backend": [type(inst.backend).__name__, type(inst.backend.inner).__mro__[1].__name__,
                        str(inst.backend.inner.device)],
            "thread": sorted(d.instance_loops),
            "metrics": text,
        }
        client.channel.close()
        seen["stop"]()
    real_sleep(wait)


real_sleep = time.sleep
D.Daemon = Recorded
hardening.install_signal_handlers = handlers
D.time = types.SimpleNamespace(time=time.time, sleep=tick)
holod_torch.main(["-f", CONF, "--device", "cpu"])
out = seen["out"]
out["modules"] = sorted(m for m in sys.modules
                        if m.split(".")[0] == "jax" or m == "holo_tpu" or m.startswith("holo_tpu."))
print(json.dumps(out))
"""


def test_main_ticks_once_from_holod_toml_with_grpc_on_and_no_jax(tmp_path):
    cache = tmp_path / "tuner.json"
    conf = tmp_path / "holod.toml"
    conf.write_text(f"""
[grpc]
enabled = true
address = "127.0.0.1:0"
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
isolation = "threaded"
""")
    code = f"ROOT = {str(ROOT)!r}\nCONF = {str(conf)!r}\n" + _MAIN_TICK
    run = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=str(tmp_path), timeout=240)
    assert run.returncode == 0, run.stderr[-3000:]
    out = json.loads(run.stdout.strip().splitlines()[-1])
    assert out["modules"] == []
    assert out["commit"] == [1, ""] and out["version"] == "0.1.0+torch"
    assert out["armed"] == [True, True, True, 2, 7]
    assert out["backend"] == ["AsyncSpfBackend", "TorchSpfBackend", "cpu"]
    assert out["thread"] == ["ospfv2"]  # threaded isolation on the real clock
    types = re.findall(r"^# TYPE (\S+) ", out["metrics"], re.M)
    assert len(types) == len(set(types)) and "holo_pipeline_queue_depth" in types
    assert re.search(r'^holo_parallel_mesh_size\{axis="batch"\} 2', out["metrics"], re.M)
    assert cache.exists()  # the tuner table, flushed by main's exit path


# -- (j) the breaker deadline


def test_breaker_deadline_on_the_cpu_keeps_results_and_is_dropped_on_the_card(
        monkeypatch, tmp_path):
    """On the CPU the oracle is the fallback: an overrun is counted, its
    result kept, and the OSPF pair converges as the scalar pair.  On the card
    no fallback serves an overrun, so main does not arm a deadline."""
    saved = dict(tbreaker.DEFAULTS)
    try:
        tbreaker.configure_defaults(failure_threshold=2, deadline=1e-9)
        loop, d1, d2 = _pair(T, "tpu")
        breaker = d1.routing.instances["ospfv2"].backend.breaker
        got = (_rib(d1), _rib(d2))
    finally:
        tbreaker.DEFAULTS.clear()
        tbreaker.DEFAULTS.update(saved)
    assert breaker.failures["deadline"] >= 1 and breaker.deadline == 1e-9
    _, s1, s2 = _pair(J, "scalar")
    assert got == (_rib(s1), _rib(s2)) and "10.2.0.0/24" in got[0]
    # main on the card (availability faked: nothing dispatches).
    conf = tmp_path / "holod.toml"
    conf.write_text("[grpc]\nenabled = false\n[parallel]\nenabled = false\n"
                    "[resilience]\nbreaker-failure-threshold = 2\nbreaker-deadline = 0.05\n"
                    "[runtime]\nisolation = \"cooperative\"\n")
    monkeypatch.setattr("torch.cuda.is_available", lambda: True)
    seen = {}

    def handlers(shutdown_cb, **_):
        seen["defaults"] = dict(tbreaker.DEFAULTS)
        shutdown_cb()

    monkeypatch.setattr(hardening, "install_signal_handlers", handlers)
    try:
        holod_torch.main(["-f", str(conf)])
    finally:
        tbreaker.DEFAULTS.clear()
        tbreaker.DEFAULTS.update(saved)
    assert seen["defaults"]["deadline"] is None
    assert seen["defaults"]["failure_threshold"] == 2


# -- (k) boot from holo_tpu's database


def test_boots_from_holo_tpus_database_with_equal_fibs(tmp_path):
    """holo_tpu's pair writes its [database] files; the port's pair boots
    from them (its northbound reloads the transaction log, as holo_tpu's
    does) and a rollback to the last transaction restores the running
    configuration: the FIBs equal the writers'."""

    def pair_with_db(p, restore: bool):
        loop = p.EventLoop(clock=p.VirtualClock())
        fabric = p.MockFabric(loop)
        out = {}
        for name, rid, addr, stub in (("d1", "1.1.1.1", "10.0.12.1/30", "10.1.0.1/24"),
                                      ("d2", "2.2.2.2", "10.0.12.2/30", "10.2.0.1/24")):
            cfg = p.Config()
            cfg.db_path = str(tmp_path / f"{name}.db")
            d = out[name] = p.Daemon(config=cfg, loop=loop, netio=fabric, name=name, **p.kw)
            fabric.join("l12", f"{name}.ospfv2", "eth0", ip_address(addr.split("/")[0]))
            if restore:
                d.northbound.rollback(d.northbound.txn_log[-1].id)
            else:
                d.commit(_pair_config(d.candidate(), rid, addr, stub, "tpu", frr="tpu"))
                c = d.candidate()
                c.set(f"{OSPF}/area[0.0.0.0]/interface[eth0]/cost", 7)
                d.commit(c)
        loop.advance(60)
        return out

    wrote = pair_with_db(J, restore=False)
    booted = pair_with_db(T, restore=True)
    for name, d in booted.items():
        assert len(d.northbound.txn_log) == 3  # the writer's two and the rollback
        assert d.northbound.running.to_json() == wrote[name].northbound.running.to_json()
        assert isinstance(d.routing.instances["ospfv2"].backend, TorchSpfBackend)
    assert scenario.snapshot(booted) == scenario.snapshot(wrote)
    assert _rib(booted["d1"])["10.2.0.0/24"][1] == 17
