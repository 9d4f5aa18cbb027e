"""The device BGP table in the port against holo_tpu's, bit for bit.

Every arm of tests/test_bgp_table.py runs through ``holo_tpu``'s
``BgpEngine`` three ways -- on the port's ``TorchBgpTableBackend`` (CPU
tensors: the plain fold), on ``TpuBgpTableBackend`` (JAX-CPU) and with no
backend (the scalar decision process) -- and the full observable state must
be equal: Loc-RIB routes and next-hop sets, every candidate's reject and
ineligible reason strings and ``igp_cost``, and the ibus stream.  Beyond the
arms: ``fold_planes`` and ``decide`` of both packages on seeded lane planes
(MED cycles, mixed router-id presence, unresolved next hops, padded ``idx``,
unassigned columns); byte specs as ``holo_tpu/tools/fuzz.py``'s
``bgp_table_invariants`` reads them, under hypothesis; the port's own
``DecisionEngine`` and cells against ``BgpEngine`` from one seed; the rank
backend against ``sorted`` and through ``BgpInstance._decision``; a JAX
table carried into the port (``convert.bgp_table_from_numpy``) and an
incremental chain on both; a cold batch of 4,096 new prefixes that were not
noted.

Tolerance: exact equality throughout (integer lanes, reason codes and
strings, frozensets of next hops).
"""

import dataclasses
import time
from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from holo_tpu.ops import bgp_table as jbt
from holo_tpu.protocols import bgp_engine as jbe
from holo_tpu.protocols.bgp_engine import (
    AdjRib,
    AsSegment,
    BaseAttrs,
    BgpEngine,
    Destination,
    NhtEntry,
    Route,
    RouteOrigin,
)
from holo_tpu.resilience.breaker import CircuitBreaker as JaxBreaker
from holo_tpu_torch import convert
from holo_tpu_torch.kernels import bgp as kb
from holo_tpu_torch.ops import bgp_table as tbt
from holo_tpu_torch.protocols import bgp_engine as tbe
from holo_tpu_torch.resilience.breaker import CircuitBreaker
from test_torch_cuda import _bgp_planes, _bgp_vectors

AFS = "ipv4-unicast"


def torch_backend(**kw):
    return tbt.TorchBgpTableBackend(device="cpu", **kw)


def seg(*asns):
    return (AsSegment("Sequence", tuple(asns)),)


def mk_engine(backend=None, mp=None, cells=jbe):
    calls = []
    cb = lambda kind, payload: calls.append((kind, payload))  # noqa: E731
    if cells is jbe:
        eng = BgpEngine("r1", ibus_cb=cb, table_backend=backend)
    else:
        eng = tbe.DecisionEngine(ibus_cb=cb, table_backend=backend)
    eng.asn = 65000
    if mp:
        eng.multipath[AFS] = dict(mp)
    return eng, calls


def queue(eng, prefix):
    eng.tables[AFS].queued.add(prefix)
    if eng.table_backend is not None:
        eng.table_backend.note_route_change(AFS, prefix)


def install(eng, routes, nht=(), redistribute=(), cells=jbe):
    """routes: (prefix, peer_addr, attrs, route_type, router_id)."""
    table = eng.tables[AFS]
    for prefix, addr, attrs, route_type, rid in routes:
        dest = table.prefixes.setdefault(prefix, cells.Destination())
        adj = dest.adj_rib.setdefault(addr, cells.AdjRib())
        adj.in_post = cells.Route(
            origin=cells.RouteOrigin(identifier=rid, remote_addr=addr),
            attrs=attrs,
            route_type=route_type,
        )
        queue(eng, prefix)
    for prefix, attrs in redistribute:
        dest = table.prefixes.setdefault(prefix, cells.Destination())
        dest.redistribute = cells.Route(
            origin=cells.RouteOrigin(protocol="static"), attrs=attrs, route_type="Internal",
        )
        queue(eng, prefix)
    for addr, metric in dict(nht).items():
        table.nht[addr] = cells.NhtEntry(metric=metric)


def withdraw(eng, prefix, addr):
    table = eng.tables[AFS]
    adj = table.prefixes[prefix].adj_rib[addr]
    eng._nexthop_untrack(table, prefix, adj.in_post)
    adj.in_pre = None
    adj.in_post = None
    queue(eng, prefix)


def _plain(x):
    """Cells of either package as plain tuples (dataclass equality is per
    class)."""
    return None if x is None else dataclasses.astuple(x)


def snapshot(eng):
    out = {}
    for prefix, dest in eng.tables[AFS].prefixes.items():
        out[prefix] = {
            "local": None if dest.local is None else (
                _plain(dest.local.origin), _plain(dest.local.attrs),
                dest.local.route_type, dest.local.igp_cost),
            "nexthops": dest.local_nexthops,
            "adj": {
                addr: (adj.in_post.reject_reason, adj.in_post.ineligible_reason,
                       adj.in_post.igp_cost)
                for addr, adj in dest.adj_rib.items() if adj.in_post is not None
            },
            "redistribute": None if dest.redistribute is None else (
                dest.redistribute.reject_reason, dest.redistribute.ineligible_reason),
        }
    return out


def assert_on_device(backend):
    """No batch and no prefix came from the oracle except the poisoned."""
    assert backend.stats()["fallbacks"] == 0
    assert not backend.breaker.failures
    assert backend.served["best-host"] == backend.served["nexthops-host"] == 0


class Trio:
    """The scalar engine and one engine on each device backend, fed alike."""

    def __init__(self, mp=None, torch_kw=None, tpu_kw=None, fallback=False):
        self.fallback = fallback  # whether the device path is made to fail
        self.engines = {}
        for name, make, kw in (("scalar", None, None), ("torch", torch_backend, torch_kw),
                               ("tpu", jbt.TpuBgpTableBackend, tpu_kw)):
            backend = None if make is None else make(**(kw or {}))
            self.engines[name] = mk_engine(backend=backend, mp=mp)

    def each(self, fn):
        for eng, _ in self.engines.values():
            fn(eng)

    def run(self):
        self.each(lambda eng: eng.run_decision_process())
        self.check()

    def check(self):
        (s, s_calls) = self.engines["scalar"]
        for name in ("torch", "tpu"):
            eng, calls = self.engines[name]
            assert snapshot(eng) == snapshot(s), name
            assert calls == s_calls, name
        if not self.fallback:  # parity from the device path, not the oracle
            assert_on_device(self.backend())

    def backend(self, name="torch"):
        return self.engines[name][0].table_backend


def trio(routes, nht=(), mp=None, redistribute=(), **kw):
    t = Trio(mp=mp, **kw)
    t.each(lambda eng: install(eng, routes, nht, redistribute))
    t.run()
    return t


ATTR = BaseAttrs(origin="Igp", as_path=seg(1), nexthop="9.9.9.1")


def test_plain_best_path_parity():
    t = trio(
        [
            ("10.0.0.0/24", "1.1.1.1", BaseAttrs(origin="Igp", as_path=seg(100),
                                                 nexthop="9.9.9.1", med=100),
             "External", "1.1.1.1"),
            ("10.0.0.0/24", "1.1.1.2", BaseAttrs(origin="Igp", as_path=seg(200),
                                                 nexthop="9.9.9.2", med=0),
             "External", "1.1.1.2"),
            ("10.0.0.0/24", "1.1.1.3", BaseAttrs(origin="Igp", as_path=seg(100),
                                                 nexthop="9.9.9.3", med=0),
             "External", "1.1.1.3"),
            ("10.0.1.0/24", "1.1.1.2", BaseAttrs(origin="Egp", as_path=seg(100),
                                                 nexthop="9.9.9.9"),
             "External", "1.1.1.2"),  # unresolvable next hop
            ("10.0.2.0/24", "1.1.1.2", BaseAttrs(origin="Igp", as_path=seg(65000, 1),
                                                 nexthop="9.9.9.2"),
             "External", "1.1.1.2"),  # AS loop
        ],
        nht={"9.9.9.1": 10, "9.9.9.2": 10, "9.9.9.3": 5},
    )
    st_ = t.backend().stats()
    assert st_["dispatches"] == 1 and st_["fallbacks"] == 0
    assert st_["backend"] == "torch" and st_["compiled-shapes"] == 1
    assert t.backend().served["best-device"] == 3  # every prefix from the fold


def test_med_non_transitive_cycle_parity():
    """X3 beats X1 on MED, X1 beats X2 on router-id, X2 beats X3 on
    router-id: a preference cycle, which only the fold in order resolves."""
    trio(
        [
            ("10.0.0.0/24", "1.1.1.1", BaseAttrs(origin="Igp", as_path=seg(1),
                                                 nexthop="9.9.9.1", med=100),
             "External", "0.0.0.1"),
            ("10.0.0.0/24", "1.1.1.2", BaseAttrs(origin="Igp", as_path=seg(2),
                                                 nexthop="9.9.9.1", med=0),
             "External", "0.0.0.2"),
            ("10.0.0.0/24", "1.1.1.3", BaseAttrs(origin="Igp", as_path=seg(1),
                                                 nexthop="9.9.9.1", med=0),
             "External", "0.0.0.3"),
        ],
        nht={"9.9.9.1": 10},
    )


def test_med_missing_folds_to_zero():
    trio(
        [
            ("10.0.0.0/24", "1.1.1.1", replace(ATTR, med=None), "External", "0.0.0.1"),
            ("10.0.0.0/24", "1.1.1.2", replace(ATTR, med=5), "External", "0.0.0.2"),
        ],
        nht={"9.9.9.1": 10},
    )


LADDER = [
    ((replace(ATTR, local_pref=200), "External", "0.0.0.2"),
     (replace(ATTR, local_pref=100), "External", "0.0.0.1")),
    ((replace(ATTR, as_path=seg(1)), "External", "0.0.0.2"),
     (replace(ATTR, as_path=seg(1, 2)), "External", "0.0.0.1")),
    ((replace(ATTR, origin="Igp"), "External", "0.0.0.2"),
     (replace(ATTR, origin="Incomplete"), "External", "0.0.0.1")),
    ((ATTR, "External", "0.0.0.2"), (ATTR, "External", "0.0.0.1")),  # router-id
    ((ATTR, "Internal", "0.0.0.1"), (ATTR, "External", "0.0.0.2")),  # prefer-external
    ((replace(ATTR, nexthop="9.9.9.1"), "External", "0.0.0.1"),
     (replace(ATTR, nexthop="9.9.9.2"), "External", "0.0.0.2")),  # IGP cost
    ((ATTR, "External", "0.0.0.9"), (ATTR, "External", "0.0.0.9")),  # peer address
    ((ATTR, "External", None), (ATTR, "External", "0.0.0.1")),  # one side has no rid
]


@pytest.mark.parametrize("case", range(len(LADDER)))
def test_tie_breaker_ladder_parity(case):
    (a1, rt1, rid1), (a2, rt2, rid2) = LADDER[case]
    addrs = ("1.1.1.2", "1.1.1.1") if case == 6 else ("1.1.1.1", "1.1.1.2")
    trio(
        [("10.0.0.0/24", addrs[0], a1, rt1, rid1), ("10.0.0.0/24", addrs[1], a2, rt2, rid2)],
        nht={"9.9.9.1": 20 if case == 5 else 10, "9.9.9.2": 10},
    )


@pytest.mark.parametrize("lp", [50, 200])
def test_redistribute_column_parity(lp):
    trio(
        [("10.0.0.0/24", "1.1.1.1", replace(ATTR, local_pref=lp), "External", "0.0.0.1")],
        nht={"9.9.9.1": 10},
        redistribute=[("10.0.0.0/24", BaseAttrs(origin="Igp", as_path=()))],
    )


MULTIPATH = [
    {"enabled": True, "ebgp_max": 2, "ibgp_max": 1, "allow_multiple_as": True},
    {"enabled": True, "ebgp_max": 4, "ibgp_max": 1, "allow_multiple_as": False},
    {"enabled": False},
]


@pytest.mark.parametrize("mp", MULTIPATH)
def test_multipath_parity(mp):
    trio(
        [
            ("10.0.0.0/24", f"1.1.1.{i}", BaseAttrs(origin="Igp", as_path=seg(i),
                                                    nexthop=f"9.9.9.{i}"),
             "External", "0.0.0.1")
            for i in (1, 2, 3)
        ],
        nht={"9.9.9.1": 10, "9.9.9.2": 10, "9.9.9.3": 10},
        mp=mp,
    )


def test_peer_flap_parity():
    routes = [
        ("10.0.0.0/24", "1.1.1.1", ATTR, "External", "0.0.0.1"),
        ("10.0.0.0/24", "1.1.1.2", replace(ATTR, as_path=seg(2), nexthop="9.9.9.2"),
         "External", "0.0.0.2"),
    ]
    t = trio(routes, {"9.9.9.1": 20, "9.9.9.2": 10})
    t.each(lambda eng: withdraw(eng, "10.0.0.0/24", "1.1.1.2"))
    t.run()

    def flap_up(eng):
        table = eng.tables[AFS]
        adj = table.prefixes["10.0.0.0/24"].adj_rib["1.1.1.2"]
        adj.in_post = Route(origin=RouteOrigin(identifier="0.0.0.2", remote_addr="1.1.1.2"),
                            attrs=routes[1][2], route_type="External")
        eng._nexthop_track(table, "10.0.0.0/24", adj.in_post)
        queue(eng, "10.0.0.0/24")

    t.each(flap_up)
    t.run()


def test_incremental_chain_reuses_resident_rows():
    routes = [
        ("10.0.0.0/24", "1.1.1.1", ATTR, "External", "0.0.0.1"),
        ("10.0.1.0/24", "1.1.1.1", replace(ATTR, as_path=seg(1, 2)), "External", "0.0.0.1"),
    ]
    t = trio(routes, nht={"9.9.9.1": 10})

    def track(eng):
        eng.tables[AFS].nht["9.9.9.1"].prefixes = {"10.0.0.0/24": 1, "10.0.1.0/24": 1}

    t.each(track)
    before = t.backend().stats()["tables"][AFS]["scatters"]
    # NHT-only churn: queued via nexthop_update, no note_route_change: the
    # device recomputes from resident rows, no re-marshal.
    t.each(lambda eng: eng.nexthop_update("9.9.9.1", 99))
    t.run()
    assert t.backend().stats()["tables"][AFS]["scatters"] == before, "NHT churn re-marshaled"
    t.each(lambda eng: eng.nexthop_update("9.9.9.1", None))
    t.run()
    assert t.backend().stats()["tables"][AFS]["scatters"] == before


def _boom(*_args, **_kw):
    raise RuntimeError("injected device fault")


def test_breaker_fallback_parity():
    """On the CPU a device failure is counted and the oracle serves the
    batch, as in holo_tpu."""
    t = Trio(torch_kw={"breaker": CircuitBreaker("bgp-table-test-fallback",
                                                 failure_threshold=1)},
             tpu_kw={"breaker": JaxBreaker("bgp-table-test-fallback", failure_threshold=1,
                                           enabled=True)}, fallback=True)
    for name in ("torch", "tpu"):
        t.backend(name)._device_batch = _boom
    t.each(lambda eng: install(eng, [("10.0.0.0/24", "1.1.1.1", ATTR, "External",
                                      "0.0.0.1")], {"9.9.9.1": 10}))
    t.run()
    assert t.backend().stats()["fallbacks"] >= 1
    assert t.backend("tpu").stats()["fallbacks"] >= 1
    assert t.backend().breaker.failures["exception"] >= 1


def test_marshal_poison_falls_back_per_prefix():
    """A route outside the lane contract (med >= 2**32) poisons only its
    own prefix; everything else stays on the device."""
    t = trio(
        [
            ("10.0.0.0/24", "1.1.1.1", replace(ATTR, med=2**40), "External", "0.0.0.1"),
            ("10.0.1.0/24", "1.1.1.1", ATTR, "External", "0.0.0.1"),
        ],
        nht={"9.9.9.1": 10},
    )
    for name in ("torch", "tpu"):
        assert t.backend(name).stats()["tables"][AFS]["poisoned"] == 1
    assert t.backend().served["best-poisoned"] == 1
    assert t.backend().served["best-device"] == 1


@pytest.mark.parametrize("cells", [jbe, tbe], ids=["holo_tpu", "port"])
def test_scalar_backend_is_the_identity_seam(cells):
    attrs = cells.BaseAttrs(origin="Igp", as_path=(cells.AsSegment("Sequence", (1,)),),
                            nexthop="9.9.9.1")
    routes = [("10.0.0.0/24", "1.1.1.1", attrs, "External", "0.0.0.1")]
    bare, bare_calls = mk_engine(cells=cells)
    install(bare, routes, {"9.9.9.1": 10}, cells=cells)
    bare.run_decision_process()
    seam, seam_calls = mk_engine(backend=tbt.ScalarBgpTableBackend(), cells=cells)
    install(seam, routes, {"9.9.9.1": 10}, cells=cells)
    seam.run_decision_process()
    assert snapshot(bare) == snapshot(seam)
    assert bare_calls == seam_calls
    assert seam.table_backend.stats() == {"backend": "scalar"}


def test_backends_stats_registry():
    backend = torch_backend()
    assert any(s["backend"] == "torch" for s in tbt.backends_stats())
    ref_count = len(tbt._BACKENDS)
    del backend
    import gc

    gc.collect()
    tbt.backends_stats()
    assert len(tbt._BACKENDS) < ref_count


def test_card_rule_reraises_without_cpu():
    """Off the CPU a failed batch is not served by the oracle: the breaker
    counts it and it re-raises (here: a backend whose device is not the
    CPU, its dispatch patched to fail before touching it)."""
    backend = torch_backend(breaker=CircuitBreaker("bgp-table-test-card"))
    backend.device = torch.device("meta")
    backend._device_batch = _boom
    eng, _ = mk_engine(backend=backend)
    install(eng, [("10.0.0.0/24", "1.1.1.1", ATTR, "External", "0.0.0.1")], {"9.9.9.1": 10})
    with pytest.raises(RuntimeError, match="injected"):
        eng.run_decision_process()
    assert backend.breaker.failures["exception"] == 1
    assert backend.stats()["fallbacks"] == 0


@pytest.mark.parametrize("miss", ["no-verdict", "no-column", "no-route"])
def test_unserved_prefix_is_counted_on_cpu_and_raises_off_it(miss):
    """A prefix that is not poisoned but finds no usable device verdict --
    missing from the batch, a peer without a column, a winning column
    without a route -- is served by the oracle and counted on the CPU, and
    raises off it: there the card decides every prefix but the poisoned."""
    prefix = "10.0.0.0/24"
    results = {}
    for device in ("cpu", "meta"):
        backend = torch_backend()
        eng, _ = mk_engine(backend=backend)
        install(eng, [(prefix, "1.1.1.1", ATTR, "External", "0.0.0.1")], {"9.9.9.1": 10})
        eng.run_decision_process()
        assert backend.served["best-device"] == 1
        table = eng.tables[AFS]
        dest = table.prefixes[prefix]
        batch = backend._batch[AFS]
        if miss == "no-verdict":
            del batch[prefix]
        elif miss == "no-column":
            dest.adj_rib["1.1.1.9"] = dest.adj_rib["1.1.1.1"]
        else:
            dest.adj_rib["1.1.1.1"].in_post = None
        backend.device = torch.device(device)
        if device == "meta":
            with pytest.raises(RuntimeError, match=prefix):
                backend.best_path(eng, AFS, table, prefix, dest)
        else:
            results[device] = backend.best_path(eng, AFS, table, prefix, dest)
            assert backend.served["best-host"] == 1
            assert backend.served["best-device"] == 1
    assert _plain(results["cpu"]) == _plain(eng._best_path(table, dest))


def test_unserved_nexthops_raise_off_the_cpu():
    mp = {"enabled": True, "ebgp_max": 4, "ibgp_max": 2, "allow_multiple_as": True}
    prefix = "10.0.0.0/24"
    backend = torch_backend()
    eng, _ = mk_engine(backend=backend, mp=mp)
    install(eng, [(prefix, "1.1.1.1", ATTR, "External", "0.0.0.1"),
                  (prefix, "1.1.1.2", ATTR, "External", "0.0.0.2")], {"9.9.9.1": 10})
    eng.run_decision_process()
    assert backend.served["nexthops-device"] == 1
    table = eng.tables[AFS]
    dest = table.prefixes[prefix]
    del backend._batch[AFS][prefix]
    assert backend.compute_nexthops(eng, AFS, prefix, dest, dest.local) == \
        eng._compute_nexthops(AFS, dest, dest.local)
    assert backend.served["nexthops-host"] == 1
    backend.device = torch.device("meta")
    with pytest.raises(RuntimeError, match=prefix):
        backend.compute_nexthops(eng, AFS, prefix, dest, dest.local)


# ---------------------------------------------------------------------------
# the fold on lane planes (the card tests' seeded planes: MED-cycle row 0,
# router ids present or not, next hops unresolved or past K, unassigned
# columns in the order)


def assert_same(got, want):
    names = ("best_col", "reasons", "elig", "mp_sel")
    for name, g, w in zip(names, got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.dtype == w.dtype, name
        assert g.shape == w.shape, name
        assert np.array_equal(g, w), name


SHAPES = [(8, 2), (37, 17), (64, 16)]


@pytest.mark.parametrize("m,cols", SHAPES)
@pytest.mark.parametrize("seed", [0, 1])
def test_fold_planes_matches_jax(m, cols, seed):
    rng = np.random.default_rng(100 + seed)
    k = 4
    sub = _bgp_planes(rng, m, cols, k)
    args = _bgp_vectors(rng, cols, k)
    want = jbt.fold_planes(jnp.asarray(sub), *map(jnp.asarray, args))
    got = tbt.fold_planes(torch.from_numpy(sub), *map(torch.from_numpy, args))
    assert_same(got, want)
    if cols >= 4:  # the MED cycle: columns 1-3 all eligible
        assert got[2][0, 1:4].all()


@pytest.mark.parametrize("m,cols", SHAPES)
def test_decide_matches_jax_with_padded_idx(m, cols):
    rng = np.random.default_rng(7)
    k = 8
    planes = _bgp_planes(rng, 3 * m, cols, k)
    live = rng.choice(3 * m, size=m - 1 if m > 1 else 1, replace=False)
    idx = np.zeros(tbt._pow2(len(live)), np.int32)  # padded with row 0, as the backend pads
    idx[: len(live)] = live
    args = _bgp_vectors(rng, cols, k)
    want = jbt._decide(jnp.asarray(planes), jnp.asarray(idx), *map(jnp.asarray, args))
    got = tbt.decide(torch.from_numpy(planes), torch.from_numpy(idx),
                     *map(torch.from_numpy, args))
    assert_same(got, want)


def test_scatter_and_grow_match_jax():
    rng = np.random.default_rng(3)
    planes = rng.integers(-5, 5, size=(jbt.N_LANES, 8, 4)).astype(np.int32)
    idx = np.array([6, 1, 3], np.int32)
    rows = rng.integers(-5, 5, size=(jbt.N_LANES, 3, 4)).astype(np.int32)
    want = np.asarray(jbt._scatter(jnp.asarray(planes), jnp.asarray(idx), jnp.asarray(rows)))
    t = torch.from_numpy(planes.copy())
    out = tbt.scatter_rows(t, torch.from_numpy(idx), torch.from_numpy(rows))
    assert out is t and np.array_equal(t.numpy(), want)
    grown = tbt.grow_planes(t, 8, 4)
    assert np.array_equal(grown.numpy(), np.asarray(jbt._grow(jnp.asarray(want), 8, 4)))


# ---------------------------------------------------------------------------
# the kernel's launch geometry and a numpy model of its walk


@pytest.mark.parametrize("cols", [1, 2, 17, 32, 64, 1024])
def test_geometry_fits_shared_memory(cols):
    for m in (1, 37, 4096, 524_288):
        geo = kb.geometry(m, cols)
        assert geo.smem_bytes == kb.smem_bytes(cols, geo.group_rows, geo.tile_rows, geo.stages,
                                               geo.warps)
        assert geo.smem_bytes <= kb.SMEM_LIMIT
        assert 1 <= geo.group_rows <= kb.GROUP_ROWS
        assert geo.group_rows & (geo.group_rows - 1) == 0
        assert geo.tile_rows == min(geo.group_rows, kb.TILE_ROWS)
        assert geo.stages >= 2 and 1 <= geo.warps <= kb.FOLD_WARPS
        assert 1 <= geo.blocks <= -(-m // geo.group_rows)
        assert geo.blocks * (geo.smem_bytes + kb.BLOCK_RESERVE) <= kb.SM_SHARED * kb.H100_SMS
        assert geo.copy == ("tma" if cols % 4 == 0 else "cp.async")


@pytest.mark.parametrize("m,cols,group", [(4096, 64, 16), (524_288, 64, 16), (32_768, 32, 32),
                                          (1024, 32, 4)])
def test_geometry_spreads_over_every_sm(m, cols, group):
    """The update shape and the engine's batches cover all 132 SMs with
    groups and raw tiles; the full table keeps 48 rows folding an SM."""
    geo = kb.geometry(m, cols)
    assert geo.group_rows == group
    assert -(-m // geo.group_rows) >= kb.H100_SMS
    assert -(-m // geo.tile_rows) >= kb.H100_SMS
    assert geo.blocks >= kb.H100_SMS
    if m == 524_288:
        assert geo.group_rows * geo.warps >= 48


@pytest.mark.parametrize("cols", [1450, 1 << 16])
def test_geometry_raises_where_one_row_does_not_fit(cols):
    with pytest.raises(ValueError, match="do not fit"):
        kb.geometry(1, cols)


def walk_fold(planes, idx, order, addr_rank, has_addr, nht_enc, nht_res, mp, n_sms):
    """csrc/bgp_kernels.cu's fold in numpy, as its blocks take the groups of
    ``kb.geometry(M, C, n_sms)``: each group's rows copied raw through
    ``idx`` tile by tile, each cell derived at its candidate position
    (position j holds column order[j]) with eligibility bits by position,
    a scan of each row's eligible (LP, L1) pairs in order that settles the
    positions above the least pair before them, the fold walking only the
    others (the first, each new least pair, each tie on it) with each
    reason sent to the loser's position (column order[j] on the way out),
    the multipath pass over the walked positions on the winner's pair with
    its early stop, and the group's outputs written by column.  Returns
    the four outputs as numpy."""
    _, n_rows, cols = planes.shape
    m, k = len(idx), len(nht_enc)
    geo = kb.geometry(m, cols, n_sms)
    gr, tr, words = geo.group_rows, geo.tile_rows, (cols + 31) // 32
    pos_col = np.clip(order, 0, cols - 1)
    inv = np.empty(cols, np.int64)
    inv[pos_col] = np.arange(cols)
    s_addr, s_has = addr_rank[pos_col], has_addr[pos_col] != 0
    local_pos = int(inv[kb.LOCAL_COL])
    allow, ibgp_max, ebgp_max = int(mp[0]) != 0, int(mp[1]), int(mp[2])
    best_out = np.full(m, -7, np.int32)
    reasons = np.full((m, cols), -7, np.int32)
    elig = np.zeros((m, cols), bool)
    sel = np.zeros((m, cols), bool)
    written = np.zeros(m, np.int64)
    n_groups = -(-m // gr)
    for block in range(geo.blocks):
        for gi in range(block, n_groups, geo.blocks):
            row0 = gi * gr
            rows = min(gr, m - row0)
            raw = np.concatenate([  # the producer's tiles
                planes[:, np.clip(idx[t0:min(t0 + tr, row0 + rows)], 0, n_rows - 1), :]
                for t0 in range(row0, row0 + rows, tr)], axis=1)
            cand = raw[:, :, pos_col].astype(np.int64)  # by position
            nh = np.clip(cand[kb.L_NH], 0, k - 1)
            local = cand[kb.L_LOCAL] != 0
            e = (cand[kb.L_OCC] != 0) & (cand[kb.L_LOOP] == 0) & (local | (nht_res[nh] != 0))
            igp = np.where(local, cand[kb.L_IGP], nht_enc[nh])
            ebits = np.zeros((rows, words), np.int64)
            for p in range(cols):
                ebits[:, p >> 5] |= e[:, p].astype(np.int64) << (p & 31)
            sbits = np.zeros((rows, words), np.int64)
            sreason = np.zeros((rows, cols), np.int32)
            for t in range(rows):
                cell = {name: cand[lane, t] for name, lane in (
                    ("lp", kb.L_LP), ("l1", kb.L_L1), ("med", kb.L_MED), ("fas", kb.L_FAS),
                    ("rt", kb.L_RT), ("rid", kb.L_RID), ("hasrid", kb.L_HASRID),
                    ("path", kb.L_PATH))}
                cell["igp"] = igp[t]

                def key(p, t=t):
                    return int(cand[kb.L_LP, t, p]), int(cand[kb.L_L1, t, p])

                # The derive step's scan: the winner's (LP, L1) after any
                # step is the least pair so far, so an eligible position
                # above the least pair before it loses at LP or L1, its
                # reason known at once; the walk visits only the rest (the
                # first, each new least pair, each tie on it).
                events, least = [], None
                for p in range(cols):
                    if not e[t, p]:
                        continue
                    if least is None or key(p) <= least:
                        events.append(p)
                    else:
                        sreason[t, p] = kb.R_LP if key(p)[0] != least[0] else (
                            kb.R_PLEN if key(p)[1] >> 2 != least[1] >> 2 else kb.R_ORIGIN)
                    least = key(p) if least is None else min(least, key(p))
                best, b = -1, {}
                for p in events:
                    c = {name: int(v[p]) for name, v in cell.items()}
                    a_addr, a_has = int(s_addr[p]), bool(s_has[p])
                    better = True
                    if best >= 0:
                        if c["lp"] != b["lp"] or c["l1"] != b["l1"]:  # a new least pair
                            assert (c["lp"], c["l1"]) < (b["lp"], b["l1"])
                            reason = kb.R_LP if c["lp"] != b["lp"] else (
                                kb.R_PLEN if c["l1"] >> 2 != b["l1"] >> 2 else kb.R_ORIGIN)
                        else:  # the other rungs at once; the first that differs decides
                            differs = [c["fas"] == b["fas"] and c["med"] != b["med"],
                                       c["rt"] != b["rt"], c["igp"] != b["igp"],
                                       bool(c["hasrid"] & b["hasrid"]) and c["rid"] != b["rid"],
                                       True]
                            wins = [c["med"] < b["med"], c["rt"] > b["rt"], c["igp"] < b["igp"],
                                    c["rid"] < b["rid"], a_has and b["has"] and a_addr < b["addr"]]
                            rung = differs.index(True)
                            better = wins[rung]
                            reason = kb.R_MED + rung
                        assert sreason[t, best if better else p] == 0  # once a cell
                        sreason[t, best if better else p] = reason
                    if better:
                        best, b = p, dict(c, addr=a_addr, has=a_has)
                if best >= 0:
                    # the multipath candidates: the events on the winner's
                    # pair, which are every eligible position with that pair
                    ties = [p for p in events if key(p) == (b["lp"], b["l1"])]
                    assert ties == [p for p in range(cols)
                                    if e[t, p] and key(p) == (b["lp"], b["l1"])]
                    maxp = ibgp_max if b["rt"] == 0 else ebgp_max
                    count = 0
                    for p in ties:
                        if count >= maxp:
                            break  # the early stop
                        c = {name: int(v[p]) for name, v in cell.items()}
                        if p == local_pos or c["rt"] != b["rt"] or c["igp"] != b["igp"]:
                            continue
                        fas_eq = c["fas"] == b["fas"]
                        if fas_eq and c["med"] != b["med"]:
                            continue
                        if not ((allow or fas_eq) if b["rt"] == 1 else c["path"] == b["path"]):
                            continue
                        count += 1
                        sbits[t, p >> 5] |= 1 << (p & 31)
                best_out[row0 + t] = -1 if best < 0 else pos_col[best]
            out = slice(row0, row0 + rows)
            reasons[out] = sreason[:, inv]
            elig[out] = (ebits[:, inv >> 5] >> (inv & 31)) & 1 == 1
            sel[out] = (sbits[:, inv >> 5] >> (inv & 31)) & 1 == 1
            written[out] += 1
    assert (written == 1).all()  # every row of every tile, once
    return best_out, reasons, elig, sel


def assert_model(got, want):
    for name, g, w in zip(("best_col", "reasons", "elig", "mp_sel"), got, want):
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert np.array_equal(g, w), name


@pytest.mark.parametrize("m,cols", [(8, 2), (37, 17), (64, 16), (50, 64), (21, 33)])
@pytest.mark.parametrize("rows", ["padded", "repeated"])
def test_walk_model_matches_fold_plain_and_jax(m, cols, rows):
    """The kernel's walk (positions, the (LP, L1) scan, the walk over its
    events, reasons to order[j], the multipath pass over the ties) on
    seeded planes with the MED cycle
    in row 0, through a padded idx and through one with repeated rows, at
    one SM so that each block walks several tiles; held to fold_plain and
    to JAX's decide."""
    rng = np.random.default_rng(50 + m + cols)
    k = 6
    planes = _bgp_planes(rng, 2 * m, cols, k)
    if rows == "padded":
        idx = np.zeros(tbt._pow2(m), np.int32)  # padded with row 0
        idx[:m] = rng.choice(2 * m, size=m, replace=False)
        idx[0] = 0  # the MED cycle
    else:
        idx = rng.integers(0, 2 * m, size=m + 3).astype(np.int32)
        idx[-3:] = idx[:3]
    args = _bgp_vectors(rng, cols, k)
    got = walk_fold(planes, idx, *args, n_sms=1)
    assert_model(got, tbt.decide(torch.from_numpy(planes), torch.from_numpy(idx),
                                 *map(torch.from_numpy, args)))
    assert_model(got, jbt._decide(jnp.asarray(planes), jnp.asarray(idx),
                                  *map(jnp.asarray, args)))
    if cols >= 4 and rows == "padded":  # the MED cycle was decided
        assert got[2][0, 1:4].all()


# ---------------------------------------------------------------------------
# byte specs (holo_tpu/tools/fuzz.py bgp_table_invariants' generator)


def spec_engines(data: bytes):
    """The fuzz target's table, built three ways; None for a short spec."""
    if len(data) < 6:
        return None
    n_prefixes = 1 + data[0] % 4
    n_peers = 1 + data[1] % 3
    mp_byte = data[2]
    if len(data) < 3 + n_prefixes * n_peers:
        return None
    mp_cfg = None
    if mp_byte & 1:
        mp_cfg = {
            "enabled": True,
            "ebgp_max": 1 + (mp_byte >> 1) % 3,
            "ibgp_max": 1 + (mp_byte >> 3) % 3,
            "allow_multiple_as": bool(mp_byte & 0x20),
        }

    def build(backend):
        eng = BgpEngine("fuzz", table_backend=backend)
        eng.asn = 65000
        if mp_cfg:
            eng.multipath[AFS] = dict(mp_cfg)
        table = eng.tables[AFS]
        for addr, metric in (("9.9.9.1", 10), ("9.9.9.2", None)):
            table.nht[addr] = NhtEntry(metric=metric)
        k = 3
        for pi in range(n_prefixes):
            prefix = f"10.0.{pi}.0/24"
            for qi in range(n_peers):
                b = data[k]
                k += 1
                if not b & 1:
                    continue  # empty cell
                addr = f"1.1.1.{qi + 1}"
                path = (65000,) if b & 2 else (100 + (b >> 2) % 2,)
                attrs = BaseAttrs(
                    origin=("Igp", "Egp", "Incomplete")[(b >> 3) % 3],
                    as_path=(AsSegment("Sequence", path),),
                    nexthop="9.9.9.1" if b & 0x40 else "9.9.9.2",
                    med=None if b & 0x80 else (b >> 2) % 4,
                    local_pref=None if b & 0x10 else 100 + (b % 8),
                )
                dest = table.prefixes.setdefault(prefix, Destination())
                adj = dest.adj_rib.setdefault(addr, AdjRib())
                adj.in_post = Route(
                    origin=RouteOrigin(identifier=f"0.0.0.{1 + (b >> 5) % 2}",
                                       remote_addr=addr),
                    attrs=attrs,
                    route_type="External" if b & 4 else "Internal",
                )
                table.queued.add(prefix)
                if backend is not None:
                    backend.note_route_change(AFS, prefix)
        return eng

    return mp_cfg, build(None), build(torch_backend()), build(jbt.TpuBgpTableBackend())


@settings(max_examples=150, deadline=None, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(st.binary(min_size=6, max_size=20))
def test_byte_specs_match_jax_and_oracle(data):
    built = spec_engines(data)
    if built is None:
        return
    mp_cfg, scalar, port, tpu = built
    for eng in (scalar, port, tpu):
        eng.run_decision_process()
    assert snapshot(port) == snapshot(scalar) == snapshot(tpu)
    assert_on_device(port.table_backend)
    # The fuzz target's invariants, on the port's batch.
    backend = port.table_backend
    batch = backend._batch.get(AFS)
    for prefix, (best_col, _reasons, elig, mp_sel) in (batch or {}).items():
        dest = port.tables[AFS].prefixes.get(prefix)
        occ = {0} if dest is not None and dest.redistribute else set()
        if dest is not None:
            occ |= {backend._tables[AFS].cols[a] for a, adj in dest.adj_rib.items()
                    if adj.in_post is not None}
        elig_cols = {int(c) for c in np.nonzero(elig)[0]}
        assert elig_cols <= occ
        assert (best_col >= 0) == bool(elig_cols)
        sel = {int(c) for c in np.nonzero(mp_sel)[0]}
        assert sel <= elig_cols
        if mp_cfg:
            assert len(sel) <= max(mp_cfg["ebgp_max"], mp_cfg["ibgp_max"])


# ---------------------------------------------------------------------------
# the port's own engine and cells


def seeded_feed(seed: int, n_prefixes: int, n_peers: int):
    """(prefix, peer, attrs fields, route type, router id) rows and the NHT,
    drawn once with numpy: every ladder rung varies, some next hops do not
    resolve, some paths loop through the local AS."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n_prefixes):
        prefix = f"10.{i >> 8}.{i & 255}.0/24"
        for p in range(n_peers):
            if rng.random() < 0.35:
                continue
            path = tuple(int(a) for a in rng.integers(1, 6, size=int(rng.integers(1, 3))))
            if rng.random() < 0.05:
                path = path + (65000,)
            rows.append((prefix, f"1.1.1.{p + 1}", dict(
                origin=("Igp", "Egp", "Incomplete")[int(rng.integers(0, 3))],
                path=path,
                nexthop=f"9.9.{int(rng.integers(0, 4))}.1",
                med=None if rng.random() < 0.3 else int(rng.integers(0, 3)),
                local_pref=None if rng.random() < 0.6 else int(rng.integers(99, 102)),
            ), ("Internal", "External")[int(rng.integers(0, 2))],
                None if rng.random() < 0.1 else f"0.0.0.{int(rng.integers(1, 4))}"))
    nht = {f"9.9.{nh}.1": (None if nh == 3 else int(rng.integers(1, 4))) for nh in range(4)}
    return rows, nht


def build_feed(eng, rows, nht, cells):
    install(eng, [
        (prefix, addr, cells.BaseAttrs(origin=f["origin"], as_path=(
            cells.AsSegment("Sequence", f["path"]),), nexthop=f["nexthop"], med=f["med"],
            local_pref=f["local_pref"]), rt, rid)
        for prefix, addr, f, rt, rid in rows
    ], nht, cells=cells)
    table = eng.tables[AFS]
    for prefix, dest in table.prefixes.items():
        for adj in dest.adj_rib.values():
            eng._nexthop_track(table, prefix, adj.in_post)


@pytest.mark.parametrize("mp", [None, MULTIPATH[0], MULTIPATH[1]])
def test_decision_engine_matches_bgp_engine(mp):
    rows, nht = seeded_feed(11, 60, 5)
    jax_eng, jax_calls = mk_engine(mp=mp)
    port_eng, port_calls = mk_engine(mp=mp, cells=tbe)
    dev_eng, dev_calls = mk_engine(backend=torch_backend(), mp=mp, cells=tbe)
    build_feed(jax_eng, rows, nht, jbe)
    build_feed(port_eng, rows, nht, tbe)
    build_feed(dev_eng, rows, nht, tbe)
    for step in range(3):
        for eng in (jax_eng, port_eng, dev_eng):
            if step == 1:
                eng.nexthop_update("9.9.0.1", 50)
            elif step == 2:
                withdraw(eng, "10.0.3.0/24", next(iter(eng.tables[AFS].prefixes[
                    "10.0.3.0/24"].adj_rib)))
            eng.run_decision_process()
        assert snapshot(port_eng) == snapshot(jax_eng)
        assert snapshot(dev_eng) == snapshot(jax_eng)
        assert port_calls == jax_calls == dev_calls
    assert dev_eng.table_backend.stats()["dispatches"] == 3
    assert_on_device(dev_eng.table_backend)


@pytest.mark.parametrize("pair", [(0, 1), (1, 2), (2, 3)])
def test_route_compare_matches(pair):
    """The oracle's comparator and multipath test on both packages' cells."""
    rows, nht = seeded_feed(5, 1, 8)

    def route(cells, i):
        _, addr, f, rt, rid = rows[i]
        attrs = cells.BaseAttrs(origin=f["origin"], as_path=(cells.AsSegment(
            "Sequence", f["path"]),), nexthop=f["nexthop"], med=f["med"],
            local_pref=f["local_pref"])
        return cells.Route(origin=cells.RouteOrigin(identifier=rid, remote_addr=addr),
                           attrs=attrs, route_type=rt, igp_cost=nht[f["nexthop"]])

    a, b = pair
    mp = MULTIPATH[0]
    assert tbe._route_compare(route(tbe, a), route(tbe, b)) == jbe._route_compare(
        route(jbe, a), route(jbe, b))
    assert tbe._multipath_equal(route(tbe, a), route(tbe, b), mp) == jbe._multipath_equal(
        route(jbe, a), route(jbe, b), mp)
    assert tbe._prefix_key("10.0.0.0/24") == jbe._prefix_key("10.0.0.0/24")


# ---------------------------------------------------------------------------
# the decision-rank seam


def test_rank_backend_matches_host_sort():
    rb = tbt.DeviceRankBackend(device="cpu")
    ranks = [
        (-200, 1, 0, 0, 1, 7),
        (-100, 1, 0, 0, 1, 7),
        (-200, 1, 0, 0, 1, 3),
        (-200, 2, 0, 5, 2, 3),
        (-200, 1, 0, 0, 1, 3),  # duplicate: stability must hold
    ]
    assert rb.rank_order(list(ranks)) == sorted(range(len(ranks)), key=lambda i: ranks[i])
    # out-of-contract lane -> None (caller falls back to list.sort)
    assert rb.rank_order([(0, 0, 0, 2**32, 0, 0), (0, 0, 0, 0, 0, 0)]) is None
    assert rb.refusals == 1
    assert rb.rank_order([(1, 2, 3, 4, 5, 6)]) == [0]


@pytest.mark.parametrize("n", [2, 33, 300])
def test_rank_backend_seeded_tuples(n):
    rng = np.random.default_rng(n)
    ranks = [(-int(rng.integers(0, 3)), int(rng.integers(0, 3)), int(rng.integers(0, 3)),
              int(rng.choice([0, 1, 2**32 - 1])), int(rng.integers(0, 3)),
              int(rng.integers(0, 2**32))) for _ in range(n)]
    want = sorted(range(n), key=lambda i: ranks[i])
    assert tbt.DeviceRankBackend(device="cpu").rank_order(ranks) == want
    assert jbt.DeviceRankBackend().rank_order(ranks) == want


def test_bgp_instance_decision_rides_rank_backend():
    from ipaddress import IPv4Address, IPv4Network

    from holo_tpu.protocols import bgp

    class _NullNetIo:
        def __getattr__(self, name):
            return lambda *a, **k: None

    def build(rank_backend):
        inst = bgp.BgpInstance("b1", 65000, IPv4Address("10.255.0.1"), _NullNetIo())
        inst.rank_backend = rank_backend
        prefix = IPv4Network("10.9.0.0/24")
        inst.originated[prefix] = bgp.PathAttrs(origin=bgp.Origin.IGP, as_path=())
        inst._decision(prefix)
        return [e.attrs for e in inst.loc_rib[prefix]]

    assert build(None) == build(tbt.DeviceRankBackend(device="cpu"))


# ---------------------------------------------------------------------------
# state carried across, and the cold batch of new prefixes


def test_carried_table_continues_the_chain():
    """A JAX backend's table after a cold batch, carried into the port: an
    incremental chain (withdraw, re-announce, NHT churn) is equal on both
    engines and the scalar one, re-marshals only the noted rows, and leaves
    both packages' planes equal."""
    rows, nht = seeded_feed(21, 40, 4)
    jax_eng, jax_calls = mk_engine(backend=jbt.TpuBgpTableBackend(), mp=MULTIPATH[0])
    port_eng, port_calls = mk_engine(mp=MULTIPATH[0])
    build_feed(jax_eng, rows, nht, jbe)
    build_feed(port_eng, rows, nht, jbe)
    jax_eng.run_decision_process()
    port_eng.run_decision_process()  # scalar: the same state as the cold batch
    assert snapshot(port_eng) == snapshot(jax_eng) and port_calls == jax_calls
    jdt = jax_eng.table_backend._tables[AFS]
    backend = torch_backend()
    backend._tables[AFS] = convert.bgp_table_from_numpy(
        np.asarray(jdt.planes), jdt.cap_rows, jdt.cap_cols, jdt.rows, jdt.cols,
        jdt.fas_ids.values, jdt.path_ids.values, jdt.nh_ids.values, jdt.poisoned,
        device="cpu")
    port_eng.table_backend = backend
    prefixes = sorted(jax_eng.tables[AFS].prefixes)

    def step(eng, k):
        table = eng.tables[AFS]
        if k == 0:
            prefix = prefixes[3]
            withdraw(eng, prefix, next(iter(table.prefixes[prefix].adj_rib)))
        elif k == 1:
            prefix = prefixes[5]
            adj = next(iter(table.prefixes[prefix].adj_rib.values()))
            adj.in_post = replace(adj.in_post, attrs=replace(adj.in_post.attrs, med=7),
                                  reject_reason=None, ineligible_reason=None)
            queue(eng, prefix)
        else:
            eng.nexthop_update("9.9.1.1", 3)
        eng.run_decision_process()

    for k in range(3):
        step(jax_eng, k)
        step(port_eng, k)
        assert snapshot(port_eng) == snapshot(jax_eng)
        assert port_calls == jax_calls
    assert_on_device(backend)
    st_ = backend.stats()["tables"][AFS]
    assert st_["scatters"] == 2 and st_["rows"] == len(jdt.rows)
    assert np.array_equal(backend._tables[AFS].planes.numpy(), np.asarray(jdt.planes))


class _CountingList(list):
    def __init__(self, *a):
        super().__init__(*a)
        self.iterations = 0

    def __iter__(self):
        self.iterations += 1
        return super().__iter__()


def test_cold_batch_of_unnoted_prefixes_is_linear():
    """4,096 new prefixes queued without note_route_change: the marshal list
    walks ``new_rows`` once (holo_tpu's copy builds a set of it per prefix),
    and the batch decides equal to the oracle well inside a coarse limit."""
    n = 4096
    new_rows = _CountingList(f"10.{i >> 8}.{i & 255}.0/24" for i in range(n))
    prefixes = list(new_rows)
    new_rows.iterations = 0
    assert tbt._marshal_list(prefixes, set(), new_rows) == prefixes
    assert new_rows.iterations == 1
    engines = []
    for backend in (None, torch_backend()):
        eng, calls = mk_engine(backend=backend)
        table = eng.tables[AFS]
        table.nht["9.9.9.1"] = NhtEntry(metric=10)
        for i in range(n):
            prefix = f"10.{i >> 8}.{i & 255}.0/24"
            dest = table.prefixes.setdefault(prefix, Destination())
            dest.adj_rib["1.1.1.1"] = AdjRib(in_post=Route(
                origin=RouteOrigin(identifier="0.0.0.1", remote_addr="1.1.1.1"),
                attrs=replace(ATTR, med=i % 7), route_type="External"))
            table.queued.add(prefix)  # not noted
        t0 = time.perf_counter()
        eng.run_decision_process()
        engines.append((eng, calls, time.perf_counter() - t0))
    (s, s_calls, _), (d, d_calls, seconds) = engines
    assert snapshot(d) == snapshot(s) and d_calls == s_calls
    assert d.table_backend.stats()["tables"][AFS]["rows"] == n
    assert_on_device(d.table_backend)
    assert seconds < 60.0
