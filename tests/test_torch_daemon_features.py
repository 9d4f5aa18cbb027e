"""The daemon's features beyond plain OSPFv2 adjacencies, on the port's
daemon against ``holo_tpu``'s on the CPU: static routes redistributed into
OSPFv2, interface authentication through a key chain (a lifetime rollover
and a key rotation by commit), a BFD session across a link flap, and the
routing-policy provider.

Three routers in a triangle (``holo_tpu_torch.daemon.scenario``'s wiring;
link 0 costs 10, link 1 10, link 2 30), each package on its own
virtual-clock network and configured by the same trees:

- link 0 (r0-r1) is authenticated through key chain ``k``: key 1 (md5)
  sends until t=60, key 2 (hmac-sha-256) from t=60;
- link 1 (r1-r2) runs BFD (hello 10 s, dead 40 s, so only BFD takes the
  adjacency down within seconds of the link going down);
- r0 has a passive stub 10.9.0.0/24, a static route 192.168.50.0/24 via
  10.9.0.254, ``redistribute static`` and a route-policy.

Steps: converge (t=40); cross the key rollover (t=80); rotate key 2 on r0
alone (the adjacency on link 0 drops); the same rotation on r1 (it comes
back); link 1 down for 5 s (BFD down); link 1 up; ``redistribute``
removed; restored with a second static route; the first static route
deleted.  After every step the FIBs with their backup sets, the RIBs, the
``get_state`` subtrees, the interfaces' send keys and the BFD sessions
equal ``holo_tpu``'s daemon's, on ``backend scalar`` and on ``backend
tpu`` (the port's plain PyTorch versions against TpuSpfBackend on
JAX-CPU; the SPF log names ``torch`` where ``holo_tpu``'s names ``tpu``).

``holo_tpu``'s daemon applies route-policies to BGP peers only (BGP is not
ported, ROADMAP A17), so the policy engine is held to ``holo_tpu``'s on
its own: the provider's engine after a commit, and seeded policies over
seeded routes.

Tolerance: exact (dicts, sets and JSON; addresses as strings).
"""

from __future__ import annotations

import dataclasses
import json
from ipaddress import ip_address, ip_network
from types import SimpleNamespace

import numpy as np
import pytest

from holo_tpu.daemon import daemon as jdaemon
from holo_tpu.utils import netio as jnetio
from holo_tpu.utils import policy as jpolicy
from holo_tpu.utils import runtime as jruntime
from holo_tpu_torch.daemon import daemon as tdaemon
from holo_tpu_torch.daemon import scenario
from holo_tpu_torch.utils import netio as tnetio
from holo_tpu_torch.utils import policy as tpolicy
from holo_tpu_torch.utils import runtime as truntime

OSPF = scenario.OSPF
AREA = f"{OSPF}/area[0.0.0.0]"
STATIC = "routing/control-plane-protocols/static-routes/route"
KC = "key-chains/key-chain[k]"
TRIANGLE = [(0, 1), (1, 2), (2, 0)]
COSTS = [10, 10, 30]
J = SimpleNamespace(Daemon=jdaemon.Daemon, MockFabric=jnetio.MockFabric,
                    EventLoop=jruntime.EventLoop, VirtualClock=jruntime.VirtualClock, kw={},
                    policy=jpolicy)
T = SimpleNamespace(Daemon=tdaemon.Daemon, MockFabric=tnetio.MockFabric,
                    EventLoop=truntime.EventLoop, VirtualClock=truntime.VirtualClock,
                    kw={"device": "cpu"}, policy=tpolicy)
SUBTREES = ["interfaces", "routing/rib", "routing/ospfv2", "routing/ietf-ospf:ospf"]
STEPS = ["converged", "key rollover", "rotated on r0", "rotated on r1", "link 1 down",
         "link 1 up", "redistribution off", "redistribution on, second static",
         "first static deleted"]
POLICY = {
    "routing-policy/defined-sets/prefix-set[statics]/prefix": ["192.168.50.0/24",
                                                               "192.168.60.0/24"],
    "routing-policy/defined-sets/tag-set[blocked]/tag": [666],
    "routing-policy/policy-definition[export]/statement[drop]/conditions/match-tag-set":
        "blocked",
    "routing-policy/policy-definition[export]/statement[drop]/actions/policy-result":
        "reject-route",
    "routing-policy/policy-definition[export]/statement[statics]/conditions/match-prefix-set":
        "statics",
    "routing-policy/policy-definition[export]/statement[statics]/actions/set-metric": 20,
    "routing-policy/policy-definition[export]/statement[statics]/actions/policy-result":
        "accept-route",
}


def _key(n: int, secret: str) -> dict:
    """Key ``n`` of chain ``k``: 1 sends until t=60, 2 from t=60."""
    base = f"{KC}/key[{n}]"
    out = {f"{base}/key-string": secret,
           f"{base}/crypto-algorithm": "md5" if n == 1 else "hmac-sha-256"}
    if n == 1:
        out[f"{base}/send-lifetime/end-date-time"] = "1970-01-01T00:01:00+00:00"
        out[f"{base}/accept-lifetime/end-date-time"] = "1970-01-01T00:02:00+00:00"
    else:
        out[f"{base}/send-lifetime/start-date-time"] = "1970-01-01T00:01:00+00:00"
        out[f"{base}/accept-lifetime/start-date-time"] = "1970-01-01T00:00:30+00:00"
    return out


def _config(r: int, wires: dict, backend: str) -> dict:
    edits = {f"{OSPF}/router-id": f"{r + 1}.{r + 1}.{r + 1}.{r + 1}",
             f"{OSPF}/spf-control/backend": backend}
    for ifn, k, addr, plen in wires[r]:
        pre = f"{AREA}/interface[{ifn}]"
        edits[f"interfaces/interface[{ifn}]/address"] = [f"{addr}/{plen}"]
        edits[f"{pre}/interface-type"] = "point-to-point"
        edits[f"{pre}/cost"] = COSTS[k]
        if k == 0:
            edits.update(_key(1, "old-secret") | _key(2, "new-secret"))
            edits[f"{pre}/hello-interval"] = 2
            edits[f"{pre}/dead-interval"] = 8
            edits[f"{pre}/authentication/key-chain"] = "k"
        elif k == 1:
            edits[f"{pre}/bfd"] = True
    if r == 0:
        edits["interfaces/interface[stub]/address"] = ["10.9.0.1/24"]
        edits[f"{AREA}/interface[stub]/passive"] = True
        edits[f"{STATIC}[192.168.50.0/24]/next-hop"] = "10.9.0.254"
        edits[f"{OSPF}/redistribute"] = ["static"]
        edits.update(POLICY)
    return edits


def _delete(d, path: str) -> None:
    c = d.candidate()
    c.delete(path)
    d.commit(c)


def _observe(daemons: dict, backend: str) -> dict:
    """FIBs and backups, RIBs, the state subtrees, each OSPFv2 interface's
    (auth type, send key id) and neighbors, and the BFD sessions."""
    out = {"fib": scenario.snapshot(daemons), "rib": {}, "state": {}, "auth": {}, "bfd": {}}
    for r, d in daemons.items():
        out["rib"][r] = {str(p): (str(m.protocol), m.distance, m.metric,
                                  sorted(f"{nh.ifname}:{nh.addr}" for nh in m.nexthops))
                         for p, m in d.routing.rib.active_routes().items()}
        state = json.loads(json.dumps(d.northbound.get_state(), default=str))
        for path in SUBTREES:
            node = state
            for key in path.split("/"):
                node = node[key]
            if path == "routing/ospfv2" and backend == "tpu":
                # The SPF log names the engine: "torch" in the port.
                node = dict(node, **{"spf-log": [
                    dict(e, backend={"torch": "tpu"}.get(e["backend"], e["backend"]))
                    for e in node["spf-log"]]})
            out["state"][(r, path)] = node
        inst = d.routing.instances["ospfv2"]
        for area in inst.areas.values():
            for ifn, iface in area.interfaces.items():
                auth = iface.config.auth
                out["auth"][(r, ifn)] = (
                    None if auth is None else (auth.type.name, auth.tx_key_id),
                    sorted((str(n.router_id), n.state.name) for n in iface.neighbors.values()))
        out["bfd"][r] = {str(key): (s.state.name, s.remote_state.name, sorted(s.clients))
                         for key, s in d.routing.bfd.sessions.items()}
    return out


def _run(p, backend: str) -> dict:
    loop = p.EventLoop(clock=p.VirtualClock())
    fabric = p.MockFabric(loop)
    wires = scenario.wiring(TRIANGLE)
    daemons = {}
    for r, ifs in sorted(wires.items()):
        daemons[r] = p.Daemon(loop=loop, netio=fabric, name=f"r{r}", **p.kw)
        for ifn, k, addr, _ in ifs:
            fabric.join(f"l{k}", f"r{r}.ospfv2", ifn, ip_address(addr))
            if k == 1:
                fabric.join(f"l{k}", f"r{r}.bfd", ifn, ip_address(addr))
    for r, d in daemons.items():
        scenario.commit(d, _config(r, wires, backend))
    r0, r1 = daemons[0], daemons[1]
    actions = [
        lambda: None,
        lambda: None,
        lambda: scenario.commit(r0, {f"{KC}/key[2]/key-string": "rotated"}),
        lambda: scenario.commit(r1, {f"{KC}/key[2]/key-string": "rotated"}),
        lambda: fabric.set_link_up("l1", False),
        lambda: fabric.set_link_up("l1", True),
        lambda: _delete(r0, f"{OSPF}/redistribute"),
        lambda: scenario.commit(r0, {f"{OSPF}/redistribute": ["static"],
                                     f"{STATIC}[192.168.60.0/24]/interface": "stub"}),
        lambda: _delete(r0, f"{STATIC}[192.168.50.0/24]"),
    ]
    waits = [40, 40, 20, 30, 5, 60, 30, 30, 30]
    steps = []
    for act, wait in zip(actions, waits):
        act()
        loop.advance(wait)
        steps.append(_observe(daemons, backend))
    return {"steps": steps, "policy": daemons[0].policy.engine}


@pytest.fixture(scope="module")
def runs():
    return {b: (_run(T, b), _run(J, b)) for b in ("scalar", "tpu")}


def _each_step(runs, backend: str, what: str):
    port, jax = runs[backend]
    for i, (got, want) in enumerate(zip(port["steps"], jax["steps"])):
        assert got[what] == want[what], f"{STEPS[i]}: {what} differs from holo_tpu's"
    return [s[what] for s in port["steps"]]


@pytest.mark.parametrize("backend", ["scalar", "tpu"])
def test_fibs_and_backups_equal_holo_tpus_after_every_step(runs, backend):
    fibs = [{r: fib for r, (fib, _) in s.items()} for s in _each_step(runs, backend, "fib")]
    # r2 learns the redistributed statics through OSPFv2; r0 keeps them static.
    has = [{p for p, (_, proto) in f[2].items() if p.startswith("192.168.")} for f in fibs]
    assert has[:6] == [{"192.168.50.0/24"}] * 6
    assert has[6] == set() and has[7] == {"192.168.50.0/24", "192.168.60.0/24"}
    assert has[8] == {"192.168.60.0/24"}
    assert fibs[0][2]["192.168.50.0/24"][1] == "Protocol.OSPFV2"
    assert fibs[6][0]["192.168.50.0/24"][1] == "Protocol.STATIC"
    # Link 0's adjacency dropped with the one-sided rotation: r1 reaches
    # r0's stub over link 1 and link 2 until the rotation on r1.
    assert fibs[2][1]["10.9.0.0/24"] != fibs[1][1]["10.9.0.0/24"]
    assert fibs[3][1]["10.9.0.0/24"] == fibs[1][1]["10.9.0.0/24"]


@pytest.mark.parametrize("backend", ["scalar", "tpu"])
def test_ribs_equal_holo_tpus_after_every_step(runs, backend):
    ribs = _each_step(runs, backend, "rib")
    proto, _, metric, _ = ribs[0][1]["192.168.50.0/24"]
    assert proto == "Protocol.OSPFV2" and metric > 0


@pytest.mark.parametrize("subtree", SUBTREES)
@pytest.mark.parametrize("backend", ["scalar", "tpu"])
def test_state_subtree_equals_holo_tpus_after_every_step(runs, backend, subtree):
    port, jax = runs[backend]
    for i, (got, want) in enumerate(zip(port["steps"], jax["steps"])):
        for r in range(3):
            assert got["state"][(r, subtree)] == want["state"][(r, subtree)], \
                f"{STEPS[i]}: router {r}: {subtree}"


@pytest.mark.parametrize("backend", ["scalar", "tpu"])
def test_keychain_rollover_and_rotation_equal_holo_tpus(runs, backend):
    auth = _each_step(runs, backend, "auth")

    def link0(step):
        return [auth[step][(0, "eth0")], auth[step][(1, "eth0")]]

    assert [a for a, _ in link0(0)] == [("CRYPTOGRAPHIC", 1)] * 2
    assert [a for a, _ in link0(1)] == [("CRYPTOGRAPHIC", 2)] * 2
    assert all(n == [("2.2.2.2", "FULL")] for n in (link0(1)[0][1], link0(3)[0][1]))
    assert link0(2)[0][1] == [] and link0(2)[1][1] == []
    assert auth[0][(2, "eth0")][0] is None  # link 1 is not authenticated


@pytest.mark.parametrize("backend", ["scalar", "tpu"])
def test_bfd_session_across_a_link_flap_equals_holo_tpus(runs, backend):
    bfd = _each_step(runs, backend, "bfd")
    sessions = [{r: {k: s for k, (s, _, _) in b.items()} for r, b in step.items()}
                for step in bfd]
    assert sessions[0][1] == {"('eth1', IPv4Address('10.0.1.2'))": "UP"}
    assert sessions[0][0] == {}
    # Five seconds after link 1 went down (dead interval 40 s) the session
    # is down, its adjacency killed with it; up again after the link is.
    steps = runs[backend][0]["steps"]
    assert steps[4]["auth"][(1, "eth1")][1] == []
    assert sessions[5][1] == {"('eth1', IPv4Address('10.0.1.2'))": "UP"}
    assert steps[5]["auth"][(1, "eth1")][1] == [("3.3.3.3", "FULL")]


def _ctx_fields(ctx) -> dict:
    return {k: (sorted(map(str, v)) if isinstance(v, set) else str(v))
            for k, v in dataclasses.asdict(ctx).items()}


def _contexts(p, seed: int, n: int = 64):
    """Seeded routes: prefixes, protocols, metrics, tags, BGP attributes."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        plen = int(rng.choice([16, 24, 32]))
        prefix = ip_network(f"{int(rng.choice([10, 192]))}.{int(rng.integers(0, 4)) + 168}"
                            f".{int(rng.integers(0, 4)) * 10}.0/{plen}", strict=False)
        out.append(p.policy.RouteContext(
            prefix=prefix, protocol=str(rng.choice(["static", "ospfv2", "bgp", ""])),
            metric=None if rng.random() < 0.2 else int(rng.integers(0, 50)),
            tag=None if rng.random() < 0.3 else int(rng.choice([1, 7, 666])),
            local_pref=None if rng.random() < 0.3 else int(rng.integers(50, 200)),
            communities={(65000 << 16) | int(c) for c in rng.integers(0, 4, rng.integers(0, 3))},
            large_communities={(65000, 1, int(c)) for c in rng.integers(0, 3, rng.integers(0, 2))},
            as_path=tuple(int(a) for a in rng.integers(64512, 64516, rng.integers(0, 4))),
            origin=str(rng.choice(["igp", "egp", "incomplete"])),
            nexthop=f"10.0.0.{int(rng.integers(1, 4))}",
            neighbor=f"10.0.1.{int(rng.integers(1, 4))}"))
    return out


def _policies(seed: int) -> dict:
    """A seeded routing-policy subtree over every kind of match set, match
    option, comparison and action the engine reads."""
    rng = np.random.default_rng(seed)
    sets = {
        "prefix-set": {f"p{i}": {"prefix": [
            f"{int(rng.choice([10, 192]))}.{168 + int(rng.integers(0, 4))}"
            f".{int(rng.integers(0, 4)) * 10}.0/{int(rng.choice([16, 24]))}"
            for _ in range(3)]} for i in range(2)},
        "tag-set": {"t": {"tag": [1, int(rng.choice([7, 666]))]}},
        "community-set": {"c": {"member": [f"65000:{int(c)}" for c in rng.integers(0, 4, 2)]}},
        "large-community-set": {"l": {"member": ["65000:1:0", "65000:1:2"]}},
        "as-path-set": {"a": {"member": [int(a) for a in rng.integers(64512, 64516, 2)]}},
        "neighbor-set": {"n": {"address": ["10.0.1.1", "10.0.1.3"]}},
        "next-hop-set": {"h": {"address": [f"10.0.0.{int(rng.integers(1, 4))}"]}},
        "ext-community-set": {"e": {"member": ["rt:65000:1"]}},
    }
    conditions = [
        lambda: {"match-prefix-set": f"p{int(rng.integers(0, 2))}"},
        lambda: {"match-tag-set": "t"},
        lambda: {"match-community-set": "c",
                 "community-match-options": str(rng.choice(["any", "all", "invert"]))},
        lambda: {"match-large-community-set": "l"},
        lambda: {"match-as-path-set": "a"},
        lambda: {"match-neighbor-set": "n"},
        lambda: {"match-next-hop-set": "h"},
        lambda: {"med": {"value": int(rng.integers(0, 50)), "op": str(rng.choice(["eq", "le", "ge"]))}},
        lambda: {"local-pref": {"value": 100, "op": str(rng.choice(["le", "ge"]))}},
        lambda: {"as-path-length": {"value": int(rng.integers(0, 3)), "op": "ge"}},
        lambda: {"origin-eq": str(rng.choice(["igp", "egp"]))},
    ]
    actions = [
        lambda: {"set-metric": int(rng.integers(0, 100))},
        lambda: {"set-tag": int(rng.integers(1, 9))},
        lambda: {"set-local-pref": int(rng.integers(50, 300))},
        lambda: {"set-community": {"method": str(rng.choice(["add", "remove", "replace"])),
                                   "communities": ["65000:9"]}},
        lambda: {"set-large-community": {"communities": ["65000:2:2"]}},
        lambda: {"set-med": {str(rng.choice(["set", "add", "subtract"])): int(rng.integers(0, 30))}},
        lambda: {"set-as-path-prepend": {"asn": 65001, "repeat": int(rng.integers(1, 3))}},
        lambda: {"set-route-origin": "incomplete"},
        lambda: {"set-next-hop": "self"},
    ]
    policies = {}
    for name in ("a", "b"):
        stmts = {}
        for s in range(int(rng.integers(2, 5))):
            cond = {}
            for i in rng.choice(len(conditions), int(rng.integers(0, 3)), replace=False):
                cond.update(conditions[i]())
            act = {}
            for i in rng.choice(len(actions), int(rng.integers(1, 3)), replace=False):
                act.update(actions[i]())
            result = rng.choice(["accept-route", "reject-route", "continue"])
            if result != "continue":
                act["policy-result"] = str(result)
            stmts[f"s{s}"] = {"conditions": cond, "actions": act}
        policies[name] = {"statement": stmts}
    return {"defined-sets": sets, "policy-definition": policies}


def _evaluate(p, engine, seed: int) -> list:
    out = []
    for name in ("a", "b", "absent"):
        for ctx in _contexts(p, seed):
            result = engine.apply(name, ctx)
            out.append((name, result.value, _ctx_fields(ctx)))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_policy_engine_evaluations_equal_holo_tpus_on_seeded_policies(seed):
    conf = _policies(seed)
    got, want = tpolicy.PolicyEngine(), jpolicy.PolicyEngine()
    got.load_from_config(conf)
    want.load_from_config(conf)
    port, jax = _evaluate(T, got, seed), _evaluate(J, want, seed)
    assert port == jax
    # The seeded policies accepted, rejected and edited routes.
    results = {r for _, r, _ in port}
    assert {"accept-route", "reject-route"} <= results


def test_policy_provider_engine_equals_holo_tpus_after_the_commit(runs):
    port, jax = runs["scalar"][0]["policy"], runs["scalar"][1]["policy"]
    assert sorted(port.policies) == sorted(jax.policies) == ["export"]
    got, want = _evaluate(T, port, 7), _evaluate(J, jax, 7)
    assert got == want
    ctx = T.policy.RouteContext(prefix=ip_network("192.168.50.0/24"), protocol="static")
    assert port.apply("export", ctx) == T.policy.PolicyResult.ACCEPT and ctx.metric == 20
