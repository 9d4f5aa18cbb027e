"""The operational state the port's daemon renders (``get_state``: the
interfaces, the RIB, the OSPFv2 summary and the YANG-modeled
``ietf-ospf:ospf`` tree of ``protocols/ospf/nb_state.py``: LSDB, neighbors,
interfaces) against ``holo_tpu``'s daemon on the CPU.

Four routers, each package on its own virtual-clock network, configured by
the same trees: three on a broadcast LAN (a DR and a BDR elected), a
point-to-point link from router 0 to router 3, a passive stub behind each,
and one link cost changed by a commit after convergence.  The port's daemons
run on the CPU; ``backend scalar`` is held to ``holo_tpu``'s scalar arm and
``backend tpu`` to ``holo_tpu``'s TpuSpfBackend on JAX-CPU (the SPF log
names ``torch`` where ``holo_tpu``'s names ``tpu``).

Tolerance: exact (the JSON of each subtree, values as strings).
"""

from __future__ import annotations

import json
from ipaddress import ip_address
from types import SimpleNamespace

import pytest

from holo_tpu.daemon import daemon as jdaemon
from holo_tpu.utils import netio as jnetio
from holo_tpu.utils import runtime as jruntime
from holo_tpu_torch.daemon import daemon as tdaemon
from holo_tpu_torch.utils import netio as tnetio
from holo_tpu_torch.utils import runtime as truntime

OSPF = "routing/control-plane-protocols/ospfv2"
J = SimpleNamespace(Daemon=jdaemon.Daemon, MockFabric=jnetio.MockFabric,
                    EventLoop=jruntime.EventLoop, VirtualClock=jruntime.VirtualClock, kw={})
T = SimpleNamespace(Daemon=tdaemon.Daemon, MockFabric=tnetio.MockFabric,
                    EventLoop=truntime.EventLoop, VirtualClock=truntime.VirtualClock,
                    kw={"device": "cpu"})
# (router, ifname, link, address, prefix length, interface type)
PORTS = [(r, "eth0", "lan", f"10.0.100.{r + 1}", 24, "broadcast") for r in range(3)] + [
    (0, "eth1", "p2p", "10.0.1.1", 30, "point-to-point"),
    (3, "eth0", "p2p", "10.0.1.2", 30, "point-to-point"),
]
SUBTREES = ["interfaces", "routing/rib", "routing/ospfv2", "routing/ietf-ospf:ospf"]


def _network(p, backend: str) -> dict:
    loop = p.EventLoop(clock=p.VirtualClock())
    fabric = p.MockFabric(loop)
    daemons = {r: p.Daemon(loop=loop, netio=fabric, name=f"r{r}", **p.kw) for r in range(4)}
    for r, ifn, link, addr, _, _ in PORTS:
        fabric.join(link, f"r{r}.ospfv2", ifn, ip_address(addr))
    for r, d in daemons.items():
        c = d.candidate()
        for rr, ifn, _, addr, plen, kind in PORTS:
            if rr == r:
                c.set(f"interfaces/interface[{ifn}]/address", [f"{addr}/{plen}"])
                c.set(f"{OSPF}/area[0.0.0.0]/interface[{ifn}]/interface-type", kind)
                c.set(f"{OSPF}/area[0.0.0.0]/interface[{ifn}]/priority", r + 1)
        c.set("interfaces/interface[stub]/address", [f"10.{r + 1}.0.1/24"])
        c.set(f"{OSPF}/area[0.0.0.0]/interface[stub]/passive", True)
        c.set(f"{OSPF}/router-id", f"{r + 1}.{r + 1}.{r + 1}.{r + 1}")
        c.set(f"{OSPF}/spf-control/backend", backend)
        d.commit(c)
    loop.advance(60)
    c = daemons[0].candidate()
    c.set(f"{OSPF}/area[0.0.0.0]/interface[eth1]/cost", 25)
    daemons[0].commit(c)
    loop.advance(30)
    return daemons


def _states(p, backend: str) -> dict:
    out = {}
    for r, d in _network(p, backend).items():
        state = json.loads(json.dumps(d.northbound.get_state(), default=str))
        for path in SUBTREES:
            node = state
            for key in path.split("/"):
                node = node[key]
            out[(r, path)] = node
    return out


@pytest.fixture(scope="module")
def states():
    return {b: (_states(T, b), _states(J, b)) for b in ("scalar", "tpu")}


@pytest.mark.parametrize("subtree", SUBTREES)
@pytest.mark.parametrize("backend", ["scalar", "tpu"])
def test_state_subtree_equals_holo_tpus(states, backend, subtree):
    port, jax = states[backend]
    for r in range(4):
        got, want = port[(r, subtree)], jax[(r, subtree)]
        if subtree == "routing/ospfv2" and backend == "tpu":
            assert {e["backend"] for e in got["spf-log"]} == {"torch"}
            assert {e["backend"] for e in want["spf-log"]} == {"tpu"}
            got = dict(got, **{"spf-log": [dict(e, backend="tpu") for e in got["spf-log"]]})
        assert got == want, f"router {r}: {subtree}"
    # The network converged: a DR and a BDR on the LAN, every stub routed.
    rib = port[(3, "routing/rib")]
    assert {f"10.{r + 1}.0.0/24" for r in range(4)} <= set(rib)
    ospf = port[(0, "routing/ospfv2")]
    assert {n["state"] for n in ospf["neighbors"].values()} == {"full"}
    lan = ospf["areas"]["0.0.0.0"]["interfaces"]["eth0"]
    assert lan["dr"] == "10.0.100.3" and lan["bdr"] == "10.0.100.2"
