"""The port's OSPFv2 path (``holo_tpu_torch.protocols.ospf``, ``routing.rib``
and the ``utils`` they run on) against ``holo_tpu``'s on the CPU: the LSA and
packet codecs byte for byte, ``build_topology`` over one LSDB carried across
by ``convert.lsdb_from_wire``, ``link_spf_delta``, ``derive_routes`` from
equal SPF planes, the RIB over one scripted route feed, whole OSPFv2
networks on the in-memory fabric (LSDBs and FIBs after convergence and
after a link failure) and fast reroute's backup sets in the triangle of
``tests/test_torch_frr.py``."""

import dataclasses
import importlib
from ipaddress import IPv4Address as A
from ipaddress import IPv4Network as N
from types import SimpleNamespace

import numpy as np
import pytest

from holo_tpu_torch import convert
from holo_tpu_torch.frr.manager import FrrEngine
from holo_tpu_torch.spf.backend import TorchSpfBackend

MODULES = {
    "packet": "protocols.ospf.packet", "lsdb": "protocols.ospf.lsdb",
    "instance": "protocols.ospf.instance", "interface": "protocols.ospf.interface",
    "neighbor": "protocols.ospf.neighbor", "spf_run": "protocols.ospf.spf_run",
    "nb_state": "protocols.ospf.nb_state", "rib": "routing.rib", "ibus": "utils.ibus",
    "netio": "utils.netio", "runtime": "utils.runtime", "southbound": "utils.southbound",
    "bytesbuf": "utils.bytesbuf", "backend": "spf.backend", "frr": "frr.manager",
    "ip": "utils.ip", "bier": "utils.bier",
}


def _package(root: str) -> SimpleNamespace:
    return SimpleNamespace(**{k: importlib.import_module(f"{root}.{v}")
                              for k, v in MODULES.items()})


J = _package("holo_tpu")
T = _package("holo_tpu_torch")
AREA0 = A("0.0.0.0")
AREA1 = A("0.0.0.1")


# -- codecs

def _addr(rng) -> A:
    return A(int(rng.integers(1, 2**32 - 1)))


def _mask(rng) -> A:
    return N(f"0.0.0.0/{int(rng.integers(8, 33))}").netmask


def _body(p, ltype, rng):
    """A seeded body of ``ltype`` built from package ``p``'s classes."""
    pk = p.packet
    if ltype == pk.LsaType.ROUTER:
        links = [pk.RouterLink(pk.RouterLinkType(int(rng.integers(1, 5))), _addr(rng),
                               _addr(rng), int(rng.integers(0, 65536)))
                 for _ in range(int(rng.integers(0, 9)))]
        return pk.LsaRouter(pk.RouterFlags(int(rng.integers(0, 8))), links)
    if ltype == pk.LsaType.NETWORK:
        return pk.LsaNetwork(_mask(rng), [_addr(rng) for _ in range(int(rng.integers(1, 7)))])
    if ltype in (pk.LsaType.SUMMARY_NETWORK, pk.LsaType.SUMMARY_ROUTER):
        return pk.LsaSummary(_mask(rng), int(rng.integers(0, 2**24)))
    if ltype in (pk.LsaType.AS_EXTERNAL, pk.LsaType.NSSA_EXTERNAL):
        return pk.LsaAsExternal(_mask(rng), bool(rng.integers(0, 2)), int(rng.integers(0, 2**24)),
                                _addr(rng), int(rng.integers(0, 2**32)))
    if ltype == pk.LsaType.OPAQUE_LINK:
        data = pk.encode_grace_tlvs(int(rng.integers(1, 1800)), int(rng.integers(0, 4)),
                                    _addr(rng) if rng.integers(0, 2) else None)
    elif ltype == pk.LsaType.OPAQUE_AREA:
        data = pk.encode_router_info(int(rng.integers(0, 2**32)), "rtr-" + str(rng.integers(99)),
                                     tuple(int(t) for t in rng.integers(0, 2**32, 2)))
        pfx = N(f"10.{int(rng.integers(256))}.0.0/16")
        data += pk.encode_ext_prefix_sid(pfx, int(rng.integers(0, 2**20)), 0x40)
        data += pk.encode_ext_prefix_bier(pfx, 1, int(rng.integers(1, 4096)), (64, 256))
    else:
        data = rng.integers(0, 256, int(rng.integers(0, 33)), dtype=np.uint8).tobytes()
    return pk.LsaOpaque(data)


def _lsa(p, ltype, seed):
    rng = np.random.default_rng(seed)
    pk = p.packet
    ltype = pk.LsaType(int(ltype))
    return pk.Lsa(age=int(rng.integers(0, 3601)), options=pk.Options(int(rng.integers(0, 128))),
                  type=ltype, lsid=_addr(rng), adv_rtr=_addr(rng),
                  seq_no=int(rng.integers(-2**31 + 1, 2**31 - 1)), body=_body(p, ltype, rng))


LSA_TYPES = [int(t) for t in J.packet.LsaType]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("ltype", LSA_TYPES, ids=[J.packet.LsaType(t).name for t in LSA_TYPES])
def test_lsa_encode_and_decode_match_holo_tpu(ltype, seed):
    jl, tl = _lsa(J, ltype, seed), _lsa(T, ltype, seed)
    raw = tl.encode()
    assert raw == jl.encode()
    assert (tl.cksum, tl.length) == (jl.cksum, jl.length)
    back = T.packet.Lsa.decode(T.bytesbuf.Reader(raw))
    assert back.raw == raw and back.encode() == raw
    assert dataclasses.astuple(back) == dataclasses.astuple(tl)
    jback = J.packet.Lsa.decode(J.bytesbuf.Reader(raw))
    assert repr(jback).replace("holo_tpu.", "") == repr(back).replace("holo_tpu_torch.", "")
    assert T.bytesbuf.fletcher16_verify(raw[2:]) == J.bytesbuf.fletcher16_verify(raw[2:])


def test_opaque_tlv_decoders_match_holo_tpu():
    for seed in range(4):
        data = _lsa(T, T.packet.LsaType.OPAQUE_AREA, seed).body.data
        for name in ("decode_router_info", "decode_ext_prefix_sid", "decode_ext_prefix_bier",
                     "decode_ext_prefix_entries"):
            assert getattr(T.packet, name)(data) == getattr(J.packet, name)(data), name
        grace = _lsa(T, T.packet.LsaType.OPAQUE_LINK, seed).body.data
        assert T.packet.decode_grace_tlvs(grace) == J.packet.decode_grace_tlvs(grace)


def _packets(p):
    pk = p.packet
    lsas = [_lsa(p, t, 7) for t in LSA_TYPES]
    for lsa in lsas:
        lsa.encode()
    keys = [lsa.key for lsa in lsas]
    return {
        "hello": pk.Hello(A("255.255.255.0"), 10, pk.Options.E | pk.Options.O, 1, 40,
                          A("10.0.0.1"), A("10.0.0.2"), [A("1.1.1.1"), A("2.2.2.2")]),
        "dbdesc": pk.DbDesc(1500, pk.Options.E, pk.DbDescFlags(7), 12345, lsas),
        "lsreq": pk.LsRequest(keys),
        "lsupd": pk.LsUpdate(lsas),
        "lsack": pk.LsAck(lsas),
    }


@pytest.mark.parametrize("auth", ["null", "simple", "md5", "hmac-sha-256"])
@pytest.mark.parametrize("kind", ["hello", "dbdesc", "lsreq", "lsupd", "lsack"])
def test_packet_encode_matches_holo_tpu(kind, auth):
    def ctx(p):
        pk = p.packet
        if auth == "null":
            return None
        if auth == "simple":
            return pk.AuthCtx(type=pk.AuthType.SIMPLE, key=b"secret!!")
        return pk.AuthCtx(type=pk.AuthType.CRYPTOGRAPHIC, key=b"k3y", key_id=3, algo=auth,
                          seqno=77)

    def pkt(p):
        return p.packet.Packet(router_id=A("1.1.1.1"), area_id=AREA1, body=_packets(p)[kind])

    raw = pkt(T).encode(ctx(T))
    assert raw == pkt(J).encode(ctx(J))
    back = T.packet.Packet.decode(raw, ctx(T))
    want = J.packet.Packet.decode(raw, ctx(J))
    assert repr(back).replace("holo_tpu_torch.", "") == repr(want).replace("holo_tpu.", "")
    assert back.encode(ctx(T)) == raw


def test_state_name_tables_match_holo_tpu():
    from holo_tpu.protocols.ospf import nb_state as jnb

    assert {s.name: v for s, v in T.nb_state._ISM_NAME.items()} == \
        {s.name: v for s, v in jnb._ISM_NAME.items()}
    assert {s.name: v for s, v in T.nb_state._NSM_NAME.items()} == \
        {s.name: v for s, v in jnb._NSM_NAME.items()}


# -- OSPFv2 networks on the in-memory fabric

def _network(p, max_paths=None, backend=None):
    """r1-r2 and r1-r3 point-to-point, a broadcast LAN of r2, r3 and r4 (two
    equal-cost paths from r1 to r4), r4 an ABR into area 1 towards r5 over a
    point-to-point link and a stub LAN of r5.  ``backend()`` gives each
    router's SPF backend."""
    inst = p.instance
    loop = p.runtime.EventLoop(clock=p.runtime.VirtualClock())
    fabric = p.netio.MockFabric(loop)
    routers, kernels, ribs, buses = {}, {}, {}, {}
    for i in range(1, 6):
        name = f"r{i}"
        bus = p.ibus.Ibus(loop)
        k = p.rib.MockKernel()
        rib = p.rib.RibManager(bus, k)
        rib.name = f"routing-{name}"
        loop.register(rib)
        r = inst.OspfInstance(name=name, netio=fabric.sender_for(name),
                              config=inst.InstanceConfig(router_id=A(f"{i}.{i}.{i}.{i}"),
                                                         max_paths=max_paths),
                              spf_backend=None if backend is None else backend())
        loop.register(r)
        r.attach_ibus(bus, routing_actor=rib.name)
        routers[name], kernels[name], ribs[name], buses[name] = r, k, rib, bus
    IfType = p.interface.IfType

    def join(link, name, ifname, net, addr, area, if_type, cost=10):
        routers[name].add_interface(ifname, inst.IfConfig(area_id=area, if_type=if_type,
                                                          cost=cost), N(net), A(addr))
        fabric.join(link, name, ifname, A(addr))

    p2p, lan = IfType.POINT_TO_POINT, IfType.BROADCAST
    join("l12", "r1", "e0", "10.0.12.0/30", "10.0.12.1", AREA0, p2p)
    join("l12", "r2", "e0", "10.0.12.0/30", "10.0.12.2", AREA0, p2p)
    join("l13", "r1", "e1", "10.0.13.0/30", "10.0.13.1", AREA0, p2p)
    join("l13", "r3", "e0", "10.0.13.0/30", "10.0.13.2", AREA0, p2p)
    for name, addr in (("r2", "10.0.234.2"), ("r3", "10.0.234.3"), ("r4", "10.0.234.4")):
        join("lan", name, "lan0", "10.0.234.0/24", addr, AREA0, lan)
    join("l45", "r4", "e1", "10.0.45.0/30", "10.0.45.1", AREA1, p2p, cost=5)
    join("l45", "r5", "e0", "10.0.45.0/30", "10.0.45.2", AREA1, p2p, cost=5)
    join("stub5", "r5", "lan0", "10.5.0.0/24", "10.5.0.1", AREA1, lan, cost=3)
    for r in routers.values():
        for area in r.areas.values():
            for ifname in area.interfaces:
                loop.send(r.name, inst.IfUpMsg(ifname))
    loop.advance(90)
    return SimpleNamespace(loop=loop, fabric=fabric, routers=routers, kernels=kernels,
                           ribs=ribs, buses=buses)


def _nh(nh):
    """A next hop, or a (next hop, label stack) backup, as plain values."""
    if isinstance(nh, tuple):
        return (_nh(nh[0]), tuple(nh[1]))
    return (str(nh.addr), nh.ifname, nh.ifindex, tuple(nh.labels))


def _fib(kernel):
    """A kernel's FIB, backups and weights as plain values."""
    fib = {str(p): (sorted(map(_nh, nhs)), proto.name) for p, (nhs, proto) in kernel.fib.items()}
    backups = {str(p): sorted((_nh(a), _nh(b)) for a, b in m.items())
               for p, m in kernel.backups.items()}
    weights = {str(p): sorted((_nh(a), w) for a, w in m.items()) for p, m in kernel.weights.items()}
    return fib, backups, weights, [(op, str(x)) for op, x in kernel.log]


def _lsdbs(net):
    return {name: {str(aid): sorted((int(k.type), str(k.lsid), str(k.adv_rtr), e.lsa.seq_no,
                                     e.lsa.raw[20:], e.installed_at)
                                    for k, e in area.lsdb.entries.items())
                   for aid, area in r.areas.items()}
            for name, r in net.routers.items()}


def _state(net):
    return {"lsdb": _lsdbs(net), "fib": {n: _fib(k) for n, k in net.kernels.items()},
            "spf": {n: r.spf_run_count for n, r in net.routers.items()},
            "nbrs": {n: sorted((iface.name, str(rid), nbr.state.name)
                               for a in r.areas.values() for iface in a.interfaces.values()
                               for rid, nbr in iface.neighbors.items())
                     for n, r in net.routers.items()}}


def _port_backend(kind):
    if kind == "scalar":
        return None
    return lambda: TorchSpfBackend(device="cpu")


@pytest.mark.parametrize("max_paths", [None, 2])
@pytest.mark.parametrize("backend", ["scalar", "torch"])
def test_network_converges_and_reconverges_as_holo_tpu(backend, max_paths):
    jnet = _network(J, max_paths)
    tnet = _network(T, max_paths, _port_backend(backend))
    want, got = _state(jnet), _state(tnet)
    assert got == want
    assert "10.5.0.0/24" in got["fib"]["r1"][0]  # the inter-area route
    ecmp = got["fib"]["r1"][0]["10.0.45.0/30"][0]
    assert len(ecmp) == 2  # r1 reaches the ABR over r2 and over r3
    for net in (jnet, tnet):
        net.fabric.set_link_up("l12", False)
        net.loop.advance(60)
    want, got = _state(jnet), _state(tnet)
    assert got == want
    assert [nh[:2] for nh in got["fib"]["r1"][0]["10.0.45.0/30"][0]] == [("10.0.13.2", "e1")]
    if backend == "torch":
        for r in tnet.routers.values():
            assert sum(r.backend._gather_cache.lookups.values()) > 0  # the port's engine ran
            snap = r.backend.breaker.snapshot()
            assert snap["failures"] == snap["fallbacks"] == {}


# -- spf_run over one LSDB carried across

def _spf_args(r, area):
    """The arguments the instance's full SPF run passes to build_topology."""
    from holo_tpu.protocols.ospf.neighbor import NsmState

    iface_by_addr = {i.addr_ip: i.name for i in area.interfaces.values() if i.addr_ip}
    iface_by_nbr, p2p = {}, {}
    for i in area.interfaces.values():
        for nbr in i.neighbors.values():
            if nbr.state == NsmState.FULL:
                iface_by_nbr[nbr.router_id] = (i.name, nbr.src)
                p2p[(i.name, nbr.router_id)] = nbr.src
    ifindex = {i.ifindex: i.name for i in area.interfaces.values() if i.ifindex}
    return iface_by_addr, iface_by_nbr, p2p, ifindex


def _carried(jnet, name, aid):
    r = jnet.routers[name]
    area = r.areas[aid]
    now = jnet.loop.clock.now()
    wire = [(e.lsa.raw, e.installed_at) for e in area.lsdb.entries.values()]
    return r, area, now, convert.lsdb_from_wire(wire)


def _topo_tuple(st):
    t = st.topo
    return (t.n_vertices, t.root, t.is_router.tolist(), t.edge_src.tolist(), t.edge_dst.tolist(),
            t.edge_cost.tolist(), t.edge_direct_atom.tolist(), t.edge_srlg.tolist(),
            None if t.partition_hint is None else t.partition_hint.tolist(), t.n_atoms(),
            [(a.ifname, str(a.addr), a.expand) for a in st.atoms],
            {str(k): v for k, v in st.router_index.items()},
            {str(k): v for k, v in st.network_index.items()})


@pytest.fixture(scope="module")
def jnet():
    return _network(J)


@pytest.mark.parametrize("where", [("r1", "0.0.0.0"), ("r2", "0.0.0.0"), ("r4", "0.0.0.0"),
                                   ("r4", "0.0.0.1"), ("r5", "0.0.0.1")])
def test_build_topology_matches_holo_tpu_over_a_carried_lsdb(jnet, where):
    name, aid = where
    r, area, now, tlsdb = _carried(jnet, name, A(aid))
    assert [(k.type, k.lsid, k.adv_rtr) for k in tlsdb.entries] == \
        [(int(k.type), k.lsid, k.adv_rtr) for k in area.lsdb.entries]
    assert [e.lsa.raw for e in tlsdb.entries.values()] == \
        [e.lsa.raw for e in area.lsdb.entries.values()]
    args = _spf_args(r, area)
    srlg = {"e0": 0b101}
    want = J.spf_run.build_topology(area.lsdb, r.config.router_id, now, *args, iface_srlg=srlg)
    got = T.spf_run.build_topology(tlsdb, r.config.router_id, now, *args, iface_srlg=srlg)
    assert _topo_tuple(got) == _topo_tuple(want)


def _routes(routes):
    return {str(p): (r.dist, sorted((n.ifname, str(n.addr)) for n in r.nexthops), str(r.area_id),
                     r.rtype, r.vertex,
                     None if r.nh_weights is None else
                     sorted(((n.ifname, str(n.addr)), w) for n, w in r.nh_weights.items()))
            for p, r in routes.items()}


@pytest.mark.parametrize("max_paths", [None, 1, 2])
@pytest.mark.parametrize("name", ["r1", "r3", "r4"])
def test_derive_routes_matches_holo_tpu_from_equal_planes(jnet, name, max_paths):
    r, area, now, tlsdb = _carried(jnet, name, AREA0)
    args = _spf_args(r, area)
    jst = J.spf_run.build_topology(area.lsdb, r.config.router_id, now, *args)
    tst = T.spf_run.build_topology(tlsdb, r.config.router_id, now, *args)
    k = max_paths if (max_paths or 0) > 1 else 1
    jres = J.backend.ScalarSpfBackend().compute(jst.topo, multipath_k=k)
    tres = T.backend.SpfResult(**{f.name: getattr(jres, f.name)
                                  for f in dataclasses.fields(T.backend.SpfResult)})
    want = J.spf_run.derive_routes(jst, jres, area.lsdb, now, AREA0, max_paths=max_paths)
    got = T.spf_run.derive_routes(tst, tres, tlsdb, now, AREA0, max_paths=max_paths)
    assert _routes(got) == _routes(want) and len(got) >= 3
    # The port's own scalar backend gives the same planes.
    mine = T.backend.ScalarSpfBackend().compute(tst.topo, multipath_k=k)
    for f in dataclasses.fields(T.backend.SpfResult):
        a, b = getattr(mine, f.name), getattr(jres, f.name)
        assert (a is None and b is None) or np.array_equal(a, b), f.name


def test_link_spf_delta_matches_holo_tpu(jnet):
    """A cost change and a link removal in r1's area-0 LSDB: both packages
    link the same delta onto the new topology."""
    r, area, now, tlsdb = _carried(jnet, "r1", AREA0)
    args = _spf_args(r, area)
    key = next(k for k in area.lsdb.entries
               if k.type == J.packet.LsaType.ROUTER and k.adv_rtr == A("2.2.2.2"))
    changed = []
    for edit in ("cost", "drop"):
        lsa = J.packet.Lsa.decode(J.bytesbuf.Reader(area.lsdb.entries[key].lsa.raw))
        links = list(lsa.body.links)
        if edit == "cost":
            links = [dataclasses.replace(lk, metric=lk.metric + 7)
                     if lk.link_type == J.packet.RouterLinkType.POINT_TO_POINT else lk
                     for lk in links]
        else:
            links = [lk for lk in links
                     if lk.link_type != J.packet.RouterLinkType.POINT_TO_POINT]
        lsa.body = J.packet.LsaRouter(lsa.body.flags, links)
        lsa.seq_no += 1
        lsa.encode()
        changed.append(lsa.raw)
    for raw in changed:
        jl = J.lsdb.Lsdb()
        for e in area.lsdb.entries.values():
            jl.install(J.packet.Lsa.decode(J.bytesbuf.Reader(e.lsa.raw)), e.installed_at)
        tl = convert.lsdb_from_wire([(e.lsa.raw, e.installed_at)
                                     for e in tlsdb.entries.values()])
        jprev = J.spf_run.build_topology(jl, r.config.router_id, now, *args)
        tprev = T.spf_run.build_topology(tl, r.config.router_id, now, *args)
        jl.install(J.packet.Lsa.decode(J.bytesbuf.Reader(raw)), now)
        tl.install(T.packet.Lsa.decode(T.bytesbuf.Reader(raw)), now)
        jnew = J.spf_run.build_topology(jl, r.config.router_id, now, *args)
        tnew = T.spf_run.build_topology(tl, r.config.router_id, now, *args)
        linked = J.spf_run.link_spf_delta(jprev, jnew)
        assert T.spf_run.link_spf_delta(tprev, tnew) is linked
        assert linked or raw is changed[1]  # the cost change is a delta
        jd, td = getattr(jnew.topo, "delta_base", None), getattr(tnew.topo, "delta_base", None)
        assert (jd is None) == (td is None) == (not linked)
        for f in dataclasses.fields(td) if linked else ():
            if f.name == "base_key":
                continue
            a, b = getattr(td, f.name), getattr(jd, f.name)
            assert np.array_equal(np.asarray(a), np.asarray(b)), f.name
        assert T.spf_run.link_spf_delta(None, tnew) is False


# -- the RIB over one scripted feed

def _feed(p):
    """Routes of three protocols added, replaced and withdrawn, FRR backups
    and UCMP weights, a BFD flip to the backups and back, a carrier loss;
    returns the kernel and the RIB's active routes after each step."""
    sb, ib = p.southbound, p.ibus
    loop = p.runtime.EventLoop(clock=p.runtime.VirtualClock())
    bus = ib.Ibus(loop)
    kernel = p.rib.MockKernel()
    rib = p.rib.RibManager(bus, kernel)
    loop.register(rib)
    nh = {i: sb.Nexthop(addr=A(f"10.0.{i}.2"), ifname=f"e{i}") for i in range(4)}
    P = sb.Protocol

    def route(proto, pfx, dist, metric, hops, backups=None, weights=None):
        return sb.RouteMsg(protocol=proto, prefix=N(pfx), distance=dist, metric=metric,
                           nexthops=frozenset(nh[i] for i in hops),
                           backups={nh[a]: nh[b] for a, b in (backups or {}).items()},
                           nh_weights={nh[a]: w for a, w in (weights or {}).items()})

    script = [
        route(P.OSPFV2, "10.1.0.0/16", 110, 20, [0, 1], backups={0: 2, 1: 2},
              weights={0: 2, 1: 1}),
        route(P.OSPFV2, "10.2.0.0/24", 110, 30, [1]),
        route(P.STATIC, "10.2.0.0/24", 1, 0, [3]),
        route(P.ISIS, "10.3.0.0/24", 115, 10, [0]),
        route(P.OSPFV2, "10.3.0.0/24", 110, 50, [2], backups={2: 3}),
        sb.RouteKeyMsg(P.STATIC, N("10.2.0.0/24")),
        ("bfd", "down", "e0", A("10.0.0.2")),
        route(P.OSPFV2, "10.4.0.0/24", 110, 5, [0, 2], backups={0: 1}),
        ("bfd", "up", "e0", A("10.0.0.2")),
        ("carrier", "e1", False),
        ("carrier", "e1", True),
        sb.RouteKeyMsg(P.ISIS, N("10.3.0.0/24")),
        route(P.OSPFV2, "10.1.0.0/16", 110, 25, [2]),
    ]
    out = []
    for step in script:
        if isinstance(step, tuple) and step[0] == "bfd":
            bus.publish(ib.TOPIC_BFD_STATE, ib.BfdStateUpd((step[2], step[3]), step[1]))
        elif isinstance(step, tuple):
            bus.publish(ib.TOPIC_INTERFACE_UPD,
                        sb.InterfaceUpdMsg(ifname=step[1], ifindex=0, operative=step[2]))
        else:
            bus.request(rib.name, step, sender="feed")
        loop.run_until_idle()
        active = {str(pf): (m.protocol.name, m.distance, m.metric, sorted(map(_nh, m.nexthops)))
                  for pf, m in rib.active_routes().items()}
        out.append((_fib(kernel), active, sorted(map(str, rib.repaired)),
                    getattr(kernel, "multipath_installs", 0),
                    getattr(kernel, "weighted_installs", 0)))
    return out


def test_rib_reaches_the_fib_of_holo_tpu_from_one_route_feed():
    want, got = _feed(J), _feed(T)
    assert len(got) == len(want) == 13
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"step {i}"
    assert got[6][2] == ["10.1.0.0/16"]  # the BFD flip repaired the e0 route
    assert [nh[:2] for nh in got[-1][0][0]["10.1.0.0/16"][0]] == [("10.0.2.2", "e2")]


# -- fast reroute in the triangle

def _triangle(p, frr_cfg, engine=None):
    """tests/test_torch_frr.py's triangle built from package ``p``."""
    inst = p.instance
    loop = p.runtime.EventLoop(clock=p.runtime.VirtualClock())
    fabric = p.netio.MockFabric(loop)
    buses, kernels, ribs, routers = {}, {}, {}, {}
    for name, rid in [("r1", "1.1.1.1"), ("r2", "2.2.2.2"), ("r3", "3.3.3.3")]:
        bus = p.ibus.Ibus(loop)
        k = p.rib.MockKernel()
        rib = p.rib.RibManager(bus, k)
        rib.name = f"routing-{name}"
        loop.register(rib)
        r = inst.OspfInstance(name=name, netio=fabric.sender_for(name),
                              config=inst.InstanceConfig(router_id=A(rid), frr=frr_cfg
                                                         if name == "r1" else None))
        loop.register(r)
        r.attach_ibus(bus, routing_actor=rib.name)
        buses[name], kernels[name], ribs[name], routers[name] = bus, k, rib, r
    if engine is not None:
        routers["r1"]._frr_engine = engine

    def cfg(c):
        return inst.IfConfig(if_type=p.interface.IfType.POINT_TO_POINT, cost=c)

    r1, r2, r3 = routers["r1"], routers["r2"], routers["r3"]
    for r, ifn, c, net, addr, link in (
            (r1, "e0", 10, "10.0.12.0/30", "10.0.12.1", "l12"),
            (r2, "e0", 10, "10.0.12.0/30", "10.0.12.2", "l12"),
            (r2, "e1", 10, "10.0.23.0/30", "10.0.23.1", "l23"),
            (r3, "e0", 10, "10.0.23.0/30", "10.0.23.2", "l23"),
            (r1, "e1", 100, "10.0.13.0/30", "10.0.13.1", "l13"),
            (r3, "e1", 100, "10.0.13.0/30", "10.0.13.2", "l13")):
        r.add_interface(ifn, cfg(c), N(net), A(addr))
        fabric.join(link, r.name, ifn, A(addr))
    for r in routers.values():
        for area in r.areas.values():
            for ifname in area.interfaces:
                loop.send(r.name, inst.IfUpMsg(ifname))
    loop.advance(90)
    return loop, fabric, buses, kernels, ribs, routers


def _frr_steps(p, frr_cfg, engine=None):
    loop, fabric, buses, kernels, ribs, routers = _triangle(p, frr_cfg, engine)
    k1 = kernels["r1"]
    steps = [_fib(k1)]
    buses["r1"].publish(p.ibus.TOPIC_BFD_STATE,
                        p.ibus.BfdStateUpd(key=("e0", A("10.0.12.2")), state="down"))
    loop.run_until_idle()
    steps.append((_fib(k1), sorted(map(str, ribs["r1"].repaired))))
    fabric.set_link_up("l12", False)
    loop.advance(60)
    steps.append((_fib(k1), sorted(map(str, ribs["r1"].repaired))))
    return steps, routers["r1"]


@pytest.mark.parametrize("policy", [dict(), dict(remote_lfa=True), dict(node_protection=True)])
@pytest.mark.parametrize("engine", ["scalar", "torch"])
def test_fast_reroute_backups_match_holo_tpu(engine, policy):
    want, jr1 = _frr_steps(J, J.frr.FrrConfig(enabled=True, engine="scalar", **policy))
    if engine == "torch":
        eng = FrrEngine("torch", device="cpu")
        got, r1 = _frr_steps(T, T.frr.FrrConfig(enabled=True, engine="torch", **policy), eng)
        assert r1._frr_engine is eng and eng.dispatches["device"] > 0
        assert eng.breaker.snapshot()["fallbacks"] == {}
    else:
        got, r1 = _frr_steps(T, T.frr.FrrConfig(enabled=True, engine="scalar", **policy))
        assert type(r1._frr_engine) is FrrEngine and r1._frr_engine.engine == "scalar"
    assert got == want
    if not policy.get("node_protection"):
        backups = got[0][1]
        assert backups and all(b for b in backups.values())  # r1's routes carry backups
        assert got[1][1]  # the BFD flip repaired over them


def test_ensure_engine_is_the_ports():
    r1 = _triangle(T, None)[5]["r1"]
    cfg = T.frr.FrrConfig(enabled=True, engine="scalar")
    r1.config.frr = cfg
    eng = r1._frr_engine_for()
    assert isinstance(eng, FrrEngine) and r1._frr_engine_for() is eng
