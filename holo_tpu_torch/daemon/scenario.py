"""The six-daemon OSPFv2 storm: one scenario for the tests and the card.

A ring of six routers with two chords (link k is 10.0.k.0/30, .1 on its
first router and .2 on its second), link costs seeded alike at both ends,
and eight events: cost commits through the northbound alternating with two
seeded links going down and coming back up, one at a time.

Every function takes the daemon package's pieces as ``p``, a namespace with
``Daemon``, ``MockFabric``, ``EventLoop``, ``VirtualClock`` and ``kw`` (the
keyword arguments each ``Daemon`` gets, ``{"device": ...}`` for the port's),
so one script drives any package whose daemon has this shape.
"""

from __future__ import annotations

from ipaddress import ip_address

import numpy as np

OSPF = "routing/control-plane-protocols/ospfv2"
# A ring and two chords.
LINKS = [(0, 1), (1, 2), (2, 3), (3, 4), (4, 5), (5, 0), (0, 3), (1, 4)]


def commit(d, edits: dict) -> None:
    """Commit ``{path: value}`` through ``d``'s northbound."""
    c = d.candidate()
    for path, value in edits.items():
        c.set(path, value)
    d.commit(c)


def wiring(links) -> dict:
    """{router: [(ifname, link, address, prefix len)]} in link order."""
    out: dict[int, list] = {}
    for k, (a, b) in enumerate(links):
        for end, r in ((1, a), (2, b)):
            ifs = out.setdefault(r, [])
            ifs.append((f"eth{len(ifs)}", k, f"10.0.{k}.{end}", 30))
    return out


def ifname(wires: dict, r: int, k: int) -> str:
    return next(ifn for ifn, kk, _, _ in wires[r] if kk == k)


def network(p, backend: str, frr: str | None = None, links=LINKS, seed: int = 0):
    """Build package ``p``'s daemons on ``links``, configure each through
    its northbound and converge: (loop, fabric, daemons, wiring)."""
    loop = p.EventLoop(clock=p.VirtualClock())
    fabric = p.MockFabric(loop)
    wires = wiring(links)
    costs = np.random.default_rng(seed).integers(1, 11, len(links))
    daemons = {}
    for r, ifs in sorted(wires.items()):
        daemons[r] = p.Daemon(loop=loop, netio=fabric, name=f"r{r}", **p.kw)
        for ifn, k, addr, _ in ifs:
            fabric.join(f"l{k}", f"r{r}.ospfv2", ifn, ip_address(addr))
    for r, d in daemons.items():
        edits = {f"{OSPF}/router-id": f"{r + 1}.{r + 1}.{r + 1}.{r + 1}",
                 f"{OSPF}/spf-control/backend": backend}
        if frr is not None:
            edits[f"{OSPF}/fast-reroute/lfa"] = True
            edits[f"{OSPF}/fast-reroute/engine"] = frr
        for ifn, k, addr, plen in wires[r]:
            pre = f"{OSPF}/area[0.0.0.0]/interface[{ifn}]"
            edits[f"interfaces/interface[{ifn}]/address"] = [f"{addr}/{plen}"]
            edits[f"{pre}/interface-type"] = "point-to-point"
            edits[f"{pre}/cost"] = int(costs[k])
        commit(d, edits)
    loop.advance(60)
    return loop, fabric, daemons, wires


def fib(kernel) -> dict:
    """A kernel's FIB: prefix -> (sorted "ifname:address" next hops, protocol)."""
    return {str(pfx): (sorted(f"{nh.ifname}:{nh.addr}" for nh in nhs), str(proto))
            for pfx, (nhs, proto) in kernel.fib.items()}


def snapshot(daemons: dict) -> dict:
    """Each daemon's FIB and backup sets (prefix -> {(primary, backup)})."""
    out = {}
    for r, d in daemons.items():
        k = d.routing.rib.kernel
        backups = {str(pfx): {(str(a.addr), str(b.addr)) for a, b in m.items()}
                   for pfx, m in k.backups.items()}
        out[r] = (fib(k), backups)
    return out


def events(seed: int = 4, links=LINKS) -> list[tuple]:
    """("cost", link, cost) at even steps, ("down"|"up", link) at odd ones."""
    rng = np.random.default_rng(seed)
    flap = rng.choice(len(links), 2, replace=False)
    out = []
    for i in range(8):
        if i % 2 == 0:
            out.append(("cost", int(rng.integers(0, len(links))), int(rng.integers(1, 21))))
        else:
            out.append(("down" if i % 4 == 1 else "up", int(flap[i // 4])))
    return out


def _parts(daemons: dict) -> dict:
    """{router: (backend, FRR engine)} of the OSPFv2 instances."""
    return {r: (d.routing.instances["ospfv2"].backend,
                d.routing.instances["ospfv2"]._frr_engine) for r, d in daemons.items()}


def storm(p, backend: str, frr: str) -> dict:
    """Converge, then replay ``events()``: the snapshots, the instances'
    (backend, FRR engine) and SPF run counts after convergence and after
    each event, and each daemon's last SPF-log backend."""
    loop, fabric, daemons, wires = network(p, backend, frr)
    steps, parts = [snapshot(daemons)], [_parts(daemons)]
    runs = [{r: d.routing.instances["ospfv2"].spf_run_count for r, d in daemons.items()}]
    for ev in events():
        if ev[0] == "cost":
            _, k, cost = ev
            a = LINKS[k][0]
            commit(daemons[a], {
                f"{OSPF}/area[0.0.0.0]/interface[{ifname(wires, a, k)}]/cost": cost})
        else:
            fabric.set_link_up(f"l{ev[1]}", ev[0] == "up")
        loop.advance(60)
        steps.append(snapshot(daemons))
        parts.append(_parts(daemons))
        runs.append({r: d.routing.instances["ospfv2"].spf_run_count for r, d in daemons.items()})
    logs = {r: d.routing.get_state()["routing"]["ospfv2"]["spf-log"][-1]["backend"]
            for r, d in daemons.items()}
    return {"steps": steps, "parts": parts, "runs": runs, "logs": logs}
