"""The port's fast reroute against holo_tpu's: FrrEngine("torch") on the CPU
gives all seven BackupTable planes bit-identical to holo_tpu's
FrrEngine("tpu") on JAX-CPU and to both scalar oracles (the topologies and
seeds of tests/test_frr_parity.py, the policies, max_iters 1-3, pad
neutrality, LAN pseudo-nodes); marshal_frr's fields equal holo_tpu's
(parallel links, LANs, every root); resolve_backup, repair_map and
coverage() agree; the OSPF triangle's backup flip with the port's engine
gives the JAX engine's FIB; graft_entry.entry() equals __graft_entry__'s."""

import dataclasses
from ipaddress import IPv4Address as A
from ipaddress import IPv4Network as N

import jax
import numpy as np
import pytest
import torch

from holo_tpu.frr.inputs import marshal_frr as jmarshal
from holo_tpu.frr.manager import FrrConfig as JConfig
from holo_tpu.frr.manager import FrrEngine as JEngine
from holo_tpu.frr.manager import repair_map as jrepair_map
from holo_tpu.frr.manager import resolve_backup as jresolve
from holo_tpu.frr.scalar import frr_reference as jreference
from holo_tpu.ops import graph as jgraph
from holo_tpu.spf import synth as jsynth
from holo_tpu.spf.backend import ScalarSpfBackend as JScalar
from holo_tpu_torch import convert
from holo_tpu_torch.frr import kernel as tkernel
from holo_tpu_torch.frr.inputs import marshal_frr
from holo_tpu_torch.frr.manager import FrrConfig, FrrEngine, ensure_engine, repair_map, resolve_backup
from holo_tpu_torch.frr.scalar import all_roots_dist, frr_reference
from holo_tpu_torch.ops import graph as tgraph
from holo_tpu_torch.ops import spf_engine as se
from holo_tpu_torch.spf.backend import TorchSpfBackend

N_ATOMS = 64
PLANES = tkernel.TABLE_PLANES


def port_topology(jt) -> tgraph.Topology:
    """The port's Topology with holo_tpu's topology's arrays and root."""
    return tgraph.Topology(
        n_vertices=jt.n_vertices, is_router=jt.is_router.copy(), edge_src=jt.edge_src.copy(),
        edge_dst=jt.edge_dst.copy(), edge_cost=jt.edge_cost.copy(),
        edge_direct_atom=jt.edge_direct_atom.copy(), edge_srlg=jt.edge_srlg.copy(),
        root=int(jt.root),
    )


def same_table(got, want, label=""):
    for f in PLANES:
        x, y = getattr(got, f), getattr(want, f)
        assert x.dtype == y.dtype and x.shape == y.shape, (label, f)
        np.testing.assert_array_equal(x, y, err_msg=f"{label} {f}")


def _parity_topos(seed):
    return {
        "ring": jsynth.ring_topology(10, seed=seed),
        "grid": jsynth.grid_topology(4, 4, seed=seed),
        "fat-tree": jsynth.fat_tree_topology(k=4, seed=seed),
        "random": jsynth.random_ospf_topology(n_routers=10, n_networks=3, seed=seed),
    }


def _lan_topology(seed=5):
    jt = jsynth.random_ospf_topology(n_routers=18, n_networks=6, extra_p2p=10, seed=seed)
    jt.edge_srlg = np.random.default_rng(seed).integers(0, 8, jt.n_edges).astype(np.uint32)
    return jt


def _parallel_topology():
    """A random topology with three p2p links doubled (parallel siblings,
    each with its own atom): the reverse of each sibling is the first
    matching edge."""
    jt = jsynth.random_ospf_topology(n_routers=12, n_networks=2, extra_p2p=6, seed=7)
    rtr = jt.is_router[jt.edge_src] & jt.is_router[jt.edge_dst]
    pick = np.nonzero(rtr & ((jt.edge_src == jt.root) | (jt.edge_dst == jt.root)))[0][:2]
    pick = np.concatenate([pick, np.nonzero(rtr)[0][-1:]])
    src = np.concatenate([jt.edge_src, jt.edge_dst[pick], jt.edge_src[pick]])
    dst = np.concatenate([jt.edge_dst, jt.edge_src[pick], jt.edge_dst[pick]])
    cost = np.concatenate([jt.edge_cost, jt.edge_cost[pick] + 1, jt.edge_cost[pick] + 2])
    out = jgraph.Topology(
        n_vertices=jt.n_vertices, is_router=jt.is_router, edge_src=src, edge_dst=dst,
        edge_cost=cost, root=jt.root,
        edge_srlg=np.random.default_rng(1).integers(0, 4, src.shape[0]).astype(np.uint32),
    )
    jsynth.assign_direct_atoms(out)
    return out


@pytest.fixture(scope="module")
def parity_cases():
    """(label, holo_tpu topology, holo_tpu's tpu table, its scalar table)
    over test_frr_parity's topology family and seeds."""
    cases = {}
    for seed in range(3):
        for shape, jt in _parity_topos(seed).items():
            cases[(shape, seed)] = (jt, JEngine("tpu", N_ATOMS).compute(jt),
                                    JEngine("scalar", N_ATOMS).compute(jt))
    return cases


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("shape", ["ring", "grid", "fat-tree", "random"])
def test_tables_match_jax_and_both_oracles(parity_cases, shape, seed):
    jt, jtab, jscal = parity_cases[(shape, seed)]
    tt = port_topology(jt)
    got = FrrEngine("torch", device="cpu").compute(tt)
    same_table(got, jtab, "jax tpu")
    same_table(got, jscal, "jax scalar")
    same_table(got, frr_reference(tt, N_ATOMS), "port scalar")
    same_table(FrrEngine("scalar").compute(tt), got, "port scalar engine")
    assert got.coverage() == jtab.coverage()


@pytest.mark.parametrize("node_protection,srlg_disjoint",
                         [(True, False), (False, True), (True, True)])
@pytest.mark.parametrize("which", ["lan", "parallel", "grid"])
def test_policies_match_jax_and_both_oracles(which, node_protection, srlg_disjoint):
    jt = {"lan": _lan_topology, "parallel": _parallel_topology,
          "grid": lambda: jsynth.grid_topology(4, 4, seed=2)}[which]()
    if which == "grid":
        jt.edge_srlg = np.random.default_rng(3).integers(0, 4, jt.n_edges).astype(np.uint32)
    tt = port_topology(jt)
    kw = dict(node_protection=node_protection, srlg_disjoint=srlg_disjoint)
    jeng = JEngine("tpu", N_ATOMS)
    jeng.set_policy(JConfig(enabled=True, **kw))
    teng = FrrEngine("torch", device="cpu")
    teng.set_policy(FrrConfig(enabled=True, **kw))
    got = teng.compute(tt)
    same_table(got, jeng.compute(jt), "jax tpu")
    same_table(got, jreference(jt, N_ATOMS, **kw), "jax scalar")
    same_table(got, frr_reference(tt, N_ATOMS, **kw), "port scalar")


@pytest.mark.parametrize("max_iters", [1, 2, 3])
@pytest.mark.parametrize("which", ["lan", "ring"])
def test_truncated_fixpoints_match_jax(which, max_iters):
    jt = _lan_topology() if which == "lan" else jsynth.ring_topology(12, seed=1)
    got = FrrEngine("torch", device="cpu", max_iters=max_iters).compute(port_topology(jt))
    same_table(got, JEngine("tpu", N_ATOMS, max_iters=max_iters).compute(jt), "jax tpu")


def test_padding_is_result_neutral():
    """Growing the pads changes no entry, through the oracle and through
    frr_batch, where the pads enter the arithmetic."""
    jt = jsynth.random_ospf_topology(n_routers=8, n_networks=2, seed=4)
    tt = port_topology(jt)
    a = frr_reference(tt, N_ATOMS, inputs=marshal_frr(tt, pad_multiple=1))
    b = frr_reference(tt, N_ATOMS, inputs=marshal_frr(tt, pad_multiple=16))
    same_table(a, b, "oracle pads")
    same_table(a, jreference(jt, N_ATOMS, inputs=jmarshal(jt, pad_multiple=16)), "jax oracle")
    g = se.device_graph_from_ell(tgraph.build_ell(tt, n_atoms=N_ATOMS), "cpu")
    for pad in (1, 16):
        fin = marshal_frr(tt, pad_multiple=pad)
        out = tkernel.frr_batch(g, tt.root, fin.link_far, fin.link_cost, fin.link_valid,
                                fin.edge_masks, fin.adj_nbr, fin.adj_cost, fin.adj_link,
                                fin.adj_valid)
        assert out.lfa_adj.shape == (fin.link_valid.shape[0], tt.n_vertices)
        same_table(tkernel.backup_table(out, fin, tt.root, tt.n_vertices), a, f"pad {pad}")


def test_all_roots_matrix_matches_oracle_layout():
    """D[v, r] (the lane layout) is the oracle's [r, v] transposed."""
    jt = _lan_topology()
    tt = port_topology(jt)
    g = se.device_graph_from_ell(tgraph.build_ell(tt), "cpu")
    d = tkernel.all_roots(g).numpy()
    np.testing.assert_array_equal(d.T, all_roots_dist(tt))


def test_select_over_stage_planes_matches_batch():
    """frr_select over frr_batch's own D and post planes gives its tables
    (what the chip run does on the host over the card's planes)."""
    tt = port_topology(_lan_topology())
    fin = marshal_frr(tt)
    g = se.device_graph_from_ell(tgraph.build_ell(tt), "cpu")
    args = (fin.link_far, fin.link_cost, fin.link_valid, fin.adj_nbr, fin.adj_cost,
            fin.adj_link, fin.adj_valid, fin.link_srlg, fin.adj_srlg, True)
    stats = {}
    batch = tkernel.frr_batch(g, tt.root, *args[:3], fin.edge_masks, *args[3:], stats=stats)
    post = se.spf_whatif_batch(g, tt.root, fin.edge_masks)
    sel = tkernel.frr_select(tkernel.all_roots(g), post, tt.root, g.is_router, *args)
    for f in tkernel.FrrTensors._fields:
        assert torch.equal(getattr(sel, f), getattr(batch, f)), f
    assert {"d_ms", "d_launches", "post_ms", "lfa_rlfa_ms", "tilfa_ms", "tilfa_rounds"} <= set(stats)
    assert stats["d_launches"] == 0 and stats["tilfa_rounds"] > 0  # the plain path counts none


def _roots(jt):
    return range(0, jt.n_vertices, max(1, jt.n_vertices // 9))


@pytest.mark.parametrize("which", ["lan", "parallel", "fat-tree", "ring"])
def test_marshal_matches_jax(which):
    jt = {"lan": _lan_topology, "parallel": _parallel_topology,
          "fat-tree": lambda: jsynth.fat_tree_topology(k=6, seed=1),
          "ring": lambda: jsynth.ring_topology(9, seed=2)}[which]()
    for root in _roots(jt):
        jt.root = root
        want = jmarshal(jt)
        got = marshal_frr(port_topology(jt))
        for f in dataclasses.fields(want):
            x, y = getattr(want, f.name), getattr(got, f.name)
            if isinstance(x, np.ndarray):
                assert x.dtype == y.dtype, (root, f.name)
                np.testing.assert_array_equal(x, y, err_msg=f"root {root} {f.name}")
            else:
                assert x == y, (root, f.name)
        assert list(got.atom_link.items()) == list(want.atom_link.items())
        assert got.shape_key == want.shape_key
    if which == "lan":
        assert any(not jt.is_router[f] for f in want.link_far[:want.n_links])
    if which == "parallel":
        pairs = list(zip(jt.edge_src.tolist(), jt.edge_dst.tolist()))
        assert len(pairs) > len(set(pairs))


def _entry(e):
    return None if e is None else (e.kind, e.atom, e.via, e.node_protecting)


@pytest.mark.parametrize("which", ["lan", "ring-uniform"])
def test_resolve_backup_and_repair_map_match_jax(which):
    jt = _lan_topology() if which == "lan" else jsynth.ring_topology(8, max_cost=1, seed=0)
    tt = port_topology(jt)
    got = FrrEngine("torch", device="cpu").compute(tt)
    want = JEngine("tpu", N_ATOMS).compute(jt)
    words = JScalar(N_ATOMS).compute(jt).nexthop_words
    kinds = set()
    for flags in [(True, True, True), (True, False, False), (True, True, False),
                  (True, False, True), (False, True, True)]:
        kw = dict(zip(("enabled", "remote_lfa", "ti_lfa"), flags))
        tcfg, jcfg = FrrConfig(**kw), JConfig(**kw)
        for link in range(-1, got.n_links + 1):
            for dest in range(tt.n_vertices):
                e = _entry(resolve_backup(got, tcfg, link, dest))
                assert e == _entry(jresolve(want, jcfg, link, dest)), (flags, link, dest)
                kinds.add(e and e[0])
        for v in range(tt.n_vertices):
            tmap = {a: _entry(e) for a, e in repair_map(got, tcfg, words[v], v).items()}
            jmap = {a: _entry(e) for a, e in jrepair_map(want, jcfg, words[v], v).items()}
            assert tmap == jmap, (flags, v)
    assert "lfa" in kinds and ({"rlfa", "ti-lfa"} & kinds)
    assert got.coverage() == want.coverage()
    for a in range(N_ATOMS):
        assert got.link_of_atom(a) == want.link_of_atom(a)


def test_jax_values_carry_across():
    jt = _lan_topology()
    want = JEngine("tpu", N_ATOMS).compute(jt)
    table = convert.backup_table_from_jax(want)
    assert isinstance(table, tkernel.BackupTable)
    same_table(table, want, "converted")
    same_table(FrrEngine("torch", device="cpu").compute(port_topology(jt)), table, "port")
    fin = convert.frr_inputs_from_jax(want.inputs)
    assert fin.atom_link == want.inputs.atom_link and fin.atom_link is not want.inputs.atom_link
    cfg = FrrConfig(enabled=True, remote_lfa=True, ti_lfa=True)
    jcfg = JConfig(enabled=True, remote_lfa=True, ti_lfa=True)
    for link in range(table.n_links):
        for dest in range(jt.n_vertices):
            assert _entry(resolve_backup(table, cfg, link, dest)) == _entry(
                jresolve(want, jcfg, link, dest))


def test_engine_rules():
    with pytest.raises(ValueError, match="'scalar' and 'torch'"):
        FrrEngine("tpu")
    eng = FrrEngine("torch", device="cpu")
    cfg = FrrConfig(enabled=True, engine="torch", node_protection=True)
    assert ensure_engine(eng, cfg) is eng and eng.policy is cfg
    scalar = ensure_engine(eng, FrrConfig(enabled=True))
    assert scalar is not eng and scalar.engine == "scalar" and scalar.device is None
    assert FrrEngine("scalar").device is None
    assert eng.device == torch.device("cpu")


def test_no_device_and_no_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FrrEngine("torch")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ensure_engine(None, FrrConfig(enabled=True, engine="torch"))
    from holo_tpu_torch import graft_entry

    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.entry()


def test_shared_graph_cache_serves_frr_and_is_per_device():
    tt = port_topology(_lan_topology())
    cache = se.shared_graph_cache("cpu")
    assert se.shared_graph_cache("cpu") is cache
    eng = FrrEngine("torch", device="cpu")
    eng.compute(tt)
    eng.compute(tt)
    assert eng.graph_cache["hit"] >= 1 and eng.dispatches["device"] == 2
    assert FrrEngine("torch", device="cpu").compute(tt) is not None
    assert cache.lookups["hit"] >= 2
    # SPF on the topology FRR marshaled: the backend's view finds the graph.
    be = TorchSpfBackend(device="cpu")
    be.compute(tt)
    assert be._gather_cache.lookups == {"hit": 1} and be.prepare(tt) is cache.get(tt, 64)[0]


def test_graft_entry_matches_jax_entry():
    import __graft_entry__ as jentry
    from holo_tpu_torch import graft_entry

    fn, args = graft_entry.entry(device="cpu")
    got = fn(*args)
    jfn, jargs = jentry.entry()
    want = jax.jit(jfn)(*jargs)
    assert got.dist.shape == (8, args[0].in_src.shape[0])
    for f in ("dist", "parent", "hops"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(got.nexthops.numpy().view(np.uint32),
                                  np.asarray(want.nexthops))
    jtopo, _g, masks = jentry._small_problem()
    ttopo, _tg, tmasks = graft_entry._small_problem(device="cpu")
    np.testing.assert_array_equal(masks, tmasks)
    for b in range(masks.shape[0]):
        ref = JScalar().compute(jtopo, masks[b])
        np.testing.assert_array_equal(got.dist[b].numpy(), ref.dist)


# -- OSPF end to end: the port's engine in r1's _frr_engine slot

DEST = N("10.0.23.0/30")  # the r2--r3 subnet, primary via r2 from r1


def _triangle(frr_cfg, r1_engine=None):
    """tests/test_frr_e2e.py's triangle: r1--r2 (10), r2--r3 (10), r1--r3
    (100); ``r1_engine`` goes into r1's FRR engine slot before any SPF."""
    from holo_tpu.protocols.ospf.instance import IfConfig, IfUpMsg, InstanceConfig, OspfInstance
    from holo_tpu.protocols.ospf.interface import IfType
    from holo_tpu.routing.rib import MockKernel, RibManager
    from holo_tpu.utils.ibus import Ibus
    from holo_tpu.utils.netio import MockFabric
    from holo_tpu.utils.runtime import EventLoop, VirtualClock

    loop = EventLoop(clock=VirtualClock())
    fabric = MockFabric(loop)
    buses, kernels, ribs, routers = {}, {}, {}, {}
    for name, rid in [("r1", "1.1.1.1"), ("r2", "2.2.2.2"), ("r3", "3.3.3.3")]:
        bus = Ibus(loop)
        k = MockKernel()
        rib = RibManager(bus, k)
        rib.name = f"routing-{name}"
        loop.register(rib)
        inst = OspfInstance(
            name=name,
            config=InstanceConfig(router_id=A(rid), frr=frr_cfg if name == "r1" else None),
            netio=fabric.sender_for(name),
        )
        loop.register(inst)
        inst.attach_ibus(bus, routing_actor=rib.name)
        buses[name], kernels[name], ribs[name], routers[name] = bus, k, rib, inst
    if r1_engine is not None:
        routers["r1"]._frr_engine = r1_engine

    def cfg(c):
        return IfConfig(if_type=IfType.POINT_TO_POINT, cost=c)

    r1, r2, r3 = routers["r1"], routers["r2"], routers["r3"]
    r1.add_interface("e0", cfg(10), N("10.0.12.0/30"), A("10.0.12.1"))
    r2.add_interface("e0", cfg(10), N("10.0.12.0/30"), A("10.0.12.2"))
    r2.add_interface("e1", cfg(10), N("10.0.23.0/30"), A("10.0.23.1"))
    r3.add_interface("e0", cfg(10), N("10.0.23.0/30"), A("10.0.23.2"))
    r1.add_interface("e1", cfg(100), N("10.0.13.0/30"), A("10.0.13.1"))
    r3.add_interface("e1", cfg(100), N("10.0.13.0/30"), A("10.0.13.2"))
    fabric.join("l12", "r1", "e0", A("10.0.12.1"))
    fabric.join("l12", "r2", "e0", A("10.0.12.2"))
    fabric.join("l23", "r2", "e1", A("10.0.23.1"))
    fabric.join("l23", "r3", "e0", A("10.0.23.2"))
    fabric.join("l13", "r1", "e1", A("10.0.13.1"))
    fabric.join("l13", "r3", "e1", A("10.0.13.2"))
    for r in routers.values():
        for area in r.areas.values():
            for ifname in area.interfaces:
                loop.send(r.name, IfUpMsg(ifname))
    loop.advance(90)
    return loop, fabric, buses, kernels, ribs, routers


def _fib(kernel):
    return {p: (sorted(str(nh.addr) for nh in nhs), proto) for p, (nhs, proto) in
            kernel.fib.items()}


def _flip(frr_cfg, r1_engine=None):
    """The FIB and r1's backups converged, after the BFD-down flip and after
    reconvergence."""
    from holo_tpu.utils.ibus import TOPIC_BFD_STATE, BfdStateUpd

    loop, fabric, buses, kernels, ribs, routers = _triangle(frr_cfg, r1_engine)
    k1 = kernels["r1"]
    steps = [(_fib(k1), {p: {(str(a.addr), str(b.addr)) for a, b in m.items()}
                         for p, m in k1.backups.items()})]
    buses["r1"].publish(TOPIC_BFD_STATE, BfdStateUpd(key=("e0", A("10.0.12.2")), state="down"))
    loop.run_until_idle()
    steps.append((_fib(k1), set(ribs["r1"].repaired)))
    fabric.set_link_up("l12", False)
    loop.advance(60)
    steps.append((_fib(k1), set(ribs["r1"].repaired)))
    return steps, routers["r1"]


def test_ospf_backup_flip_with_the_port_engine():
    cfg = JConfig(enabled=True, engine="torch")
    eng = FrrEngine("torch", device="cpu")
    got, r1 = _flip(cfg, eng)
    assert r1._frr_engine is eng and eng.dispatches["device"] > 0
    assert eng.breaker.snapshot()["fallbacks"] == {}
    want, jr1 = _flip(JConfig(enabled=True, engine="tpu"))
    assert jr1._frr_engine.engine == "tpu"
    assert got == want
    (fib0, backups0), (fib1, repaired1), (fib2, repaired2) = got
    assert fib0[DEST][0] == ["10.0.12.2"] and backups0[DEST] == {("10.0.12.2", "10.0.13.2")}
    assert fib1[DEST][0] == ["10.0.13.2"] and DEST in repaired1
    assert fib2[DEST][0] == ["10.0.13.2"] and DEST not in repaired2
