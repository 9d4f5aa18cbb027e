"""DeltaPath in the port against holo_tpu's, bit for bit.

- the delta model: diff_topologies (both paths), seed_rows and kind equal
  JAX's field for field on random mutation chains; the delta lowering
  equals JAX's ``_lower_delta`` on the real rows (JAX's padding sentinels
  dropped) and leaves the mirror in the same state; ``apply_delta_slots``
  equals JAX's ``_apply_delta_slots`` plane for plane;
- ``spf_one_incremental`` equals JAX's at max_iters None, 2 and 3;
- the backend: random delta chains equal ``TpuSpfBackend(64)`` (JAX-CPU),
  the port's full path and the scalar oracle, each step's dispositions
  equal to JAX's ``holo_spf_delta_total`` increments; at max_iters 2 and 3
  they equal ``TpuSpfBackend(64, max_iters=m)``, which the port's full path
  does not; every fallback lands on JAX's disposition with the oracle's
  bits;
- the protocol seam: ``holo_tpu`` topologies and deltas, and the OSPFv2
  storm; the two Topology classes never share a cache entry or a delta.

Tolerance: exact equality everywhere (the computation is integer-only).
"""

from collections import Counter

import jax
import numpy as np
import pytest
import torch

from holo_tpu import telemetry
from holo_tpu.ops import graph as jgraph
from holo_tpu.ops import spf_engine as je
from holo_tpu.spf import synth as jsynth
from holo_tpu.spf.backend import ScalarSpfBackend as JScalar
from holo_tpu.spf.backend import TpuSpfBackend
from holo_tpu_torch.kernels import ell
from holo_tpu_torch.ops import graph as tgraph
from holo_tpu_torch.ops import spf_engine as te
from holo_tpu_torch.spf import synth as tsynth
from holo_tpu_torch.spf.backend import ScalarSpfBackend, SpfResult, TorchSpfBackend

N_ATOMS = 64
FIELDS = ("dist", "parent", "hops", "nexthop_words")
KW = dict(n_routers=24, n_networks=6, extra_p2p=30)
DELTA_ARRAYS = ("w_src", "w_dst", "w_old", "w_new", "w_atom", "r_src", "r_dst", "r_cost",
                "r_atom", "a_src", "a_dst", "a_cost", "a_atom", "overload")
GRAPH_PLANES = ("in_src", "in_cost", "in_valid", "in_edge_id", "direct_nh_words", "is_router")


def _same(a, b, label=""):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, (label, f)
        np.testing.assert_array_equal(x, y, err_msg=f"{label} {f}")


def _pair(seed, **kw):
    kw = {**KW, **kw}
    return (tsynth.random_ospf_topology(seed=seed, **kw),
            jsynth.random_ospf_topology(seed=seed, **kw))


def _mutation(topo, rng) -> dict:
    """One storm-shaped event as clone_topology arguments (the draws of
    tests/test_delta_spf.py's random_mutation): a metric change, a link
    flap (both directions), or a fresh bidirectional edge."""
    roll = rng.random()
    if roll < 0.4 and topo.n_edges:
        e = int(rng.integers(0, topo.n_edges))
        return {"cost": {e: int(rng.integers(1, 64))}}
    if roll < 0.8 and topo.n_edges:
        e = int(rng.integers(0, topo.n_edges))
        s, d = int(topo.edge_src[e]), int(topo.edge_dst[e])
        keep = ~(((topo.edge_src == s) & (topo.edge_dst == d))
                 | ((topo.edge_src == d) & (topo.edge_dst == s)))
        return {"keep": keep}
    a = int(rng.integers(0, topo.n_vertices))
    b = int(rng.integers(0, topo.n_vertices))
    w = int(rng.integers(1, 32))
    return {"extra": [[a, b, w, -1], [b, a, w, -1]]}


def _link_flap(topo) -> dict:
    """Remove both directions of the first link not out of the root."""
    e = int(np.nonzero(topo.edge_src != topo.root)[0][0])
    s, d = int(topo.edge_src[e]), int(topo.edge_dst[e])
    return {"keep": ~(((topo.edge_src == s) & (topo.edge_dst == d))
                      | ((topo.edge_src == d) & (topo.edge_dst == s)))}


def _step(tt, jt, link=True, **spec):
    """Apply one mutation to both packages' topologies; with ``link``,
    attach each package's own delta.  (port, jax, port delta, jax delta)."""
    tn, jn = tsynth.clone_topology(tt, **spec), jsynth.clone_topology(jt, **spec)
    td, jd = tgraph.diff_topologies(tt, tn), jgraph.diff_topologies(jt, jn)
    if link and td is not None:
        tn.link_delta(td)
        jn.link_delta(jd)
    return tn, jn, td, jd


def _jax_paths() -> Counter:
    """holo_tpu's holo_spf_delta_total as (kind, path) -> count."""
    out = Counter()
    for key, v in telemetry.snapshot(prefix="holo_spf_delta_total").items():
        labels = dict(x.split("=") for x in key[key.index("{") + 1:-1].split(","))
        out[(labels["kind"], labels["path"])] = int(v)
    return out


class _Dispositions:
    """Per-step increments of the port's and JAX's disposition counters."""

    def __init__(self, be):
        self.be = be
        self.port, self.jax = Counter(be.delta_paths), _jax_paths()

    def step(self) -> tuple[Counter, Counter]:
        port, jax_now = Counter(self.be.delta_paths), _jax_paths()
        out = (port - self.port, jax_now - self.jax)
        self.port, self.jax = port, jax_now
        return out


def _assert_delta_equal(td, jd, tbase, jbase):
    if jd is None:
        assert td is None
        return
    assert td.base_key == tbase.cache_key and jd.base_key == jbase.cache_key
    for f in DELTA_ARRAYS:
        a, b = getattr(td, f), getattr(jd, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert (td.ids_stable, td.n_ops, td.kind) == (jd.ids_stable, jd.n_ops, jd.kind)
    np.testing.assert_array_equal(td.seed_rows(), jd.seed_rows())
    np.testing.assert_array_equal(tgraph.delta_seed_rows(jd), jd.seed_rows())
    assert tgraph.delta_kind(jd) == jd.kind


# ---------------------------------------------------------------------------
# The delta model


@pytest.mark.parametrize("seed", range(5))
def test_diff_topologies_matches_jax(seed):
    rng = np.random.default_rng(seed)
    tt, jt = _pair(seed)
    for _ in range(10):
        tn, jn, td, jd = _step(tt, jt, **_mutation(tt, rng))
        _assert_delta_equal(td, jd, tt, jt)
        tt, jt = tn, jn


def test_diff_topologies_refusals_match_jax():
    tt, jt = _pair(1)
    many = {e: int(tt.edge_cost[e]) + 1 for e in range(20)}
    for spec, kw in (({"cost": many}, {"max_ops": 19}), ({"cost": many}, {}),
                     ({"extra": [[0, 9, 3, -1]] * 30}, {"max_ops": 29}), (_link_flap(tt), {})):
        tn, jn = tsynth.clone_topology(tt, **spec), jsynth.clone_topology(jt, **spec)
        _assert_delta_equal(tgraph.diff_topologies(tt, tn, **kw),
                            jgraph.diff_topologies(jt, jn, **kw), tt, jt)
    other = tsynth.random_ospf_topology(seed=2, n_routers=25, n_networks=6)
    assert tgraph.diff_topologies(tt, other) is None
    moved = tsynth.clone_topology(tt)
    moved.root += 1
    assert tgraph.diff_topologies(tt, moved) is None


def test_touch_drops_the_lineage():
    tt, _ = _pair(3)
    tn = tsynth.clone_topology(tt, cost={0: 9})
    tn.link_delta(tgraph.diff_topologies(tt, tn))
    assert tn.delta_base is not None and tt.delta_base is None
    tn.touch()
    assert tn.delta_base is None


def _mirrors(tt, jt):
    return (te._EllMirror(tgraph.build_ell(tt, n_atoms=N_ATOMS)),
            je._EllMirror(jgraph.build_ell(jt, n_atoms=N_ATOMS)))


def _same_mirror(tm, jm):
    for f in ("in_src", "in_cost", "in_valid", "in_atom"):
        np.testing.assert_array_equal(getattr(tm, f), getattr(jm, f), err_msg=f)
    assert (tm.n_valid, tm.n_atoms) == (jm.n_valid, jm.n_atoms)


def _same_ops(tops, jops, n):
    rows, cols, src, cost, valid, words, strike = jops
    real = rows < n
    np.testing.assert_array_equal(tops.rows, rows[real])
    for name, want in (("cols", cols), ("src", src), ("cost", cost), ("valid", valid),
                       ("words", words.view(np.int32))):
        np.testing.assert_array_equal(getattr(tops, name), want[real], err_msg=name)
    got_strike = np.zeros(n, bool) if tops.strike is None else tops.strike
    np.testing.assert_array_equal(got_strike, strike)


def _overload_delta(mod, topo, vertices):
    return mod.TopologyDelta(base_key=topo.cache_key, overload=np.asarray(vertices, np.int32),
                             ids_stable=False)


@pytest.mark.parametrize("seed", range(3))
def test_lower_delta_matches_jax(seed):
    """One mirror each carried down a chain of random deltas (and an
    overload strike): the same slot ops and the same mirror after each."""
    rng = np.random.default_rng(seed)
    tt, jt = _pair(seed)
    tm, jm = _mirrors(tt, jt)
    n = tt.n_vertices
    for i in range(12):
        if i == 6:
            v = int(tt.edge_src[np.nonzero(tt.edge_src != tt.root)[0][0]])
            td, jd = _overload_delta(tgraph, tt, [v]), _overload_delta(jgraph, jt, [v])
            tn, jn = tt, jt
        else:
            tn, jn, td, jd = _step(tt, jt, link=False, **_mutation(tt, rng))
        try:
            jops = je._lower_delta(jm, jd, n)
        except je._DeltaUnappliable as exc:
            with pytest.raises(te._DeltaUnappliable) as got:
                te.lower_delta(tm, td, n)
            assert got.value.reason == exc.reason
            tm, jm = _mirrors(tn, jn)
        else:
            _same_ops(te.lower_delta(tm, td, n), jops, n)
        _same_mirror(tm, jm)
        tt, jt = tn, jn


def test_lower_delta_reasons_match_jax():
    tt, jt = _pair(4)
    n = tt.n_vertices
    k_pad = tgraph.build_ell(tt).k_pad
    v = int(tt.edge_dst[0])
    flood = [[(v + 1 + i) % n, v, 7, -1] for i in range(k_pad + 4)]
    cases = {
        "padding-overflow": {"extra": flood},
        "atom-overflow": {"extra": [[1, v, 7, N_ATOMS]]},
    }
    for reason, spec in cases.items():
        tm, jm = _mirrors(tt, jt)
        tn, jn = tsynth.clone_topology(tt, **spec), jsynth.clone_topology(jt, **spec)
        td = tgraph.diff_topologies(tt, tn, max_ops=4 * k_pad)
        jd = jgraph.diff_topologies(jt, jn, max_ops=4 * k_pad)
        with pytest.raises(je._DeltaUnappliable, match=reason):
            je._lower_delta(jm, jd, n)
        with pytest.raises(te._DeltaUnappliable, match=reason):
            te.lower_delta(tm, td, n)
    tm, jm = _mirrors(tt, jt)
    ghost = dict(r_src=np.int32([1]), r_dst=np.int32([v]), r_cost=np.int32([999]),
                 r_atom=np.int32([-1]), ids_stable=False)
    with pytest.raises(je._DeltaUnappliable, match="missing-edge"):
        je._lower_delta(jm, jgraph.TopologyDelta(base_key=jt.cache_key, **ghost), n)
    with pytest.raises(te._DeltaUnappliable, match="missing-edge"):
        te.lower_delta(tm, tgraph.TopologyDelta(base_key=tt.cache_key, **ghost), n)


def _graphs(tt, jt):
    jg = je.device_graph_from_ell(jgraph.build_ell(jt, n_atoms=N_ATOMS))
    tg = te.device_graph_from_ell(tgraph.build_ell(tt, n_atoms=N_ATOMS), device="cpu")
    return tg, jg


def _same_graph(tg, jg):
    for f in GRAPH_PLANES:
        a, b = getattr(tg, f).numpy(), np.asarray(getattr(jg, f))
        if f == "direct_nh_words":
            a = a.view(np.uint32)
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("kind", ["weight", "struct", "overload", "atom31"])
def test_apply_delta_slots_matches_jax(kind):
    tt, jt = _pair(5)
    tg, jg = _graphs(tt, jt)
    tm, jm = _mirrors(tt, jt)
    n = tt.n_vertices
    if kind == "overload":
        v = int(tt.edge_src[np.nonzero(tt.edge_src != tt.root)[0][0]])
        td, jd = _overload_delta(tgraph, tt, [v]), _overload_delta(jgraph, jt, [v])
    else:
        spec = {"weight": {"cost": {3: 40, 11: 1}}, "struct": _link_flap(tt),
                # an added edge carrying atom 31: bit 31 of word 0, the sign bit
                "atom31": {"extra": [[tt.root, 7, 2, 31]]}}[kind]
        _, _, td, jd = _step(tt, jt, link=False, **spec)
    same_graph = te.apply_delta_slots(tg, te.lower_delta(tm, td, n))
    assert same_graph is tg  # in place
    _same_graph(tg, je._apply_delta_slots(jg, *je._lower_delta(jm, jd, n)))
    if kind == "atom31":
        assert int(tg.direct_nh_words.min()) == -(1 << 31)


def _jax_incremental(max_iters):
    return jax.jit(lambda g, r, prev, seeds: je.spf_one_incremental(g, r, prev, seeds,
                                                                     max_iters))


def _same_tensors(tout, jout, label):
    for f in ("dist", "parent", "hops", "nexthops"):
        a, b = getattr(tout, f).numpy(), np.asarray(getattr(jout, f))
        if f == "nexthops":
            a = a.view(np.uint32)
        assert a.dtype == b.dtype, (label, f)
        np.testing.assert_array_equal(a, b, err_msg=f"{label} {f}")


@pytest.mark.parametrize("max_iters", [None, 2, 3])
@pytest.mark.parametrize("kind", ["weight", "struct", "overload"])
def test_spf_one_incremental_matches_jax(kind, max_iters):
    """Both packages' previous runs (truncated alike), one delta applied to
    both resident graphs, then each incremental SPF."""
    tt, jt = _pair(6, n_routers=60, n_networks=12, extra_p2p=80)
    tg, jg = _graphs(tt, jt)
    tm, jm = _mirrors(tt, jt)
    n = tt.n_vertices
    tprev = te.spf_one(tg, tt.root, None, max_iters)
    jprev = je.spf_one(jg, jt.root, None, max_iters)
    _same_tensors(tprev, jprev, "previous run")
    if kind == "overload":
        v = int(tt.edge_src[np.nonzero(tt.edge_src != tt.root)[0][5]])
        td, jd = _overload_delta(tgraph, tt, [v]), _overload_delta(jgraph, jt, [v])
    else:
        spec = {"weight": {"cost": {e: int(tt.edge_cost[e]) + 9 for e in (2, 30, 57)}},
                "struct": _link_flap(tt)}[kind]
        _, _, td, jd = _step(tt, jt, link=False, **spec)
    te.apply_delta_slots(tg, te.lower_delta(tm, td, n))
    jg = je._apply_delta_slots(jg, *je._lower_delta(jm, jd, n))
    seeds = jd.seed_rows()
    padded = np.full(je._pad_pow2(seeds.shape[0]), n, np.int32)
    padded[: seeds.shape[0]] = seeds
    stats = {}
    got = te.spf_one_incremental(tg, tt.root, tprev, td.seed_rows(), max_iters, stats)
    _same_tensors(got, _jax_incremental(max_iters)(jg, jt.root, jprev, padded),
                  f"{kind} max_iters={max_iters}")
    assert set(stats) == {"affected", "affected_rows", "relax", "hops_nh", "affected_ms",
                          "relax_ms", "hops_nh_ms"}
    assert stats["affected_rows"] >= len(seeds)


def test_hops_nh_recompute_lowers_stale_seeds():
    """Seeded with values that are too large and bits that should not be
    set, the recompute still reaches the full path's planes (ell_nh_round,
    which only ORs into its input, could not)."""
    tt, _ = _pair(7)
    tg = te.device_graph_from_ell(tgraph.build_ell(tt, n_atoms=N_ATOMS), device="cpu")
    full = te.spf_one(tg, tt.root)
    p = te.lane_planes(tg, None)
    roots = torch.tensor([tt.root], dtype=torch.int32)
    parent, dag = ell.ell_first_parent(*p, full.dist[:, None].contiguous(), roots)
    n = tt.n_vertices
    hops, nh, _ = te.hops_nh_recompute(tg, tt.root, dag, parent[:, 0],
                                    torch.full((n,), 3, dtype=torch.int32),
                                    torch.full_like(full.nexthops, -1), n)
    assert torch.equal(torch.where(full.dist < te.INF, hops, n + 1), full.hops)
    assert torch.equal(nh, full.nexthops)


# ---------------------------------------------------------------------------
# The backend


def _backends(**kw):
    return (TorchSpfBackend(device="cpu", **kw), TpuSpfBackend(N_ATOMS, **kw),
            TorchSpfBackend(device="cpu", incremental=False, **kw), JScalar(N_ATOMS))


@pytest.mark.parametrize("seed", range(5))
def test_random_delta_chain_matches_jax_full_path_and_oracle(seed):
    rng = np.random.default_rng(seed)
    tt, jt = _pair(seed)
    be, jbe, full, oracle = _backends()
    be.compute(tt)
    jbe.compute(jt)
    disp = _Dispositions(be)
    served = 0
    for i in range(10):
        tt, jt, _, _ = _step(tt, jt, **_mutation(tt, rng))
        got = be.compute(tt)
        label = f"seed {seed} step {i}"
        _same(got, jbe.compute(jt), f"{label} jax")
        _same(got, full.compute(tsynth.clone_topology(tt)), f"{label} port full path")
        _same(got, oracle.compute(jt), f"{label} oracle")
        port, jax_paths = disp.step()
        assert port == jax_paths, label
        served += sum(v for (_, path), v in port.items() if path == "incremental")
    assert served > 0


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("max_iters", [2, 3])
def test_truncated_chain_matches_jax_incremental(max_iters, seed):
    """Under a truncating max_iters JAX's incremental path stops at other
    bits than its full path; the port follows the incremental one."""
    rng = np.random.default_rng(seed)
    tt, jt = _pair(seed)
    be, jbe, full, _ = _backends(max_iters=max_iters)
    _same(be.compute(tt), jbe.compute(jt), "first run")
    differs = 0
    for i in range(6):
        tt, jt, _, _ = _step(tt, jt, **_mutation(tt, rng))
        got = be.compute(tt)
        _same(got, jbe.compute(jt), f"seed {seed} step {i}")
        ref = full.compute(tsynth.clone_topology(tt))
        differs += any(not np.array_equal(getattr(got, f), getattr(ref, f)) for f in FIELDS)
    assert be.delta_paths[("weight", "incremental")] + be.delta_paths[("struct", "incremental")]
    assert differs > 0


def _fallback(seed, make, *, then=None):
    """Run ``make(tt, jt) -> (port topo, jax topo)`` after a first compute on
    both backends, compute both, and return the port's and JAX's
    dispositions with the result held to the oracle."""
    tt, jt = _pair(seed)
    be, jbe, _, oracle = _backends()
    be.compute(tt)
    jbe.compute(jt)
    disp = _Dispositions(be)
    tn, jn = make(tt, jt, be)
    call = then or (lambda b, t: b.compute(t))
    got, want = call(be, tn), call(jbe, jn)
    ref = call(oracle, jn)
    for a, b, r in zip(*(x if isinstance(x, list) else [x] for x in (got, want, ref))):
        _same(a, b, "jax")
        _same(a, r, "oracle")
    return disp.step()


def _linked(spec_of, max_ops=512):
    def make(tt, jt, be):
        spec = spec_of(tt)
        tn, jn = tsynth.clone_topology(tt, **spec), jsynth.clone_topology(jt, **spec)
        tn.link_delta(tgraph.diff_topologies(tt, tn, max_ops=max_ops))
        jn.link_delta(jgraph.diff_topologies(jt, jn, max_ops=max_ops))
        return tn, jn
    return make


def _flood(tt):
    k_pad = tgraph.build_ell(tt).k_pad
    v = int(tt.edge_dst[0])
    return {"extra": [[(v + 1 + i) % tt.n_vertices, v, 7, -1] for i in range(k_pad + 4)]}


def _masks(topo, lanes=5):
    return tsynth.whatif_link_failure_masks(topo, lanes, seed=3)


def _whatif(be, topo):
    return be.compute_whatif(topo, _masks(topo))


def _masked(be, topo):
    return be.compute(topo, _masks(topo, 2)[1])


def _ghost_or_overload(case):
    def make(tt, jt, be):
        v = int(tt.edge_src[np.nonzero(tt.edge_src != tt.root)[0][0]])
        if case == "overload":
            tn = tsynth.clone_topology(tt, keep=tt.edge_src != v)
            jn = jsynth.clone_topology(jt, keep=jt.edge_src != v)
            tn.link_delta(_overload_delta(tgraph, tt, [v]))
            jn.link_delta(_overload_delta(jgraph, jt, [v]))
            return tn, jn
        # the removal of an edge the base does not have
        ghost = dict(r_src=np.int32([v]), r_dst=np.int32([1]), r_cost=np.int32([999]),
                     r_atom=np.int32([-1]), ids_stable=False)
        tn, jn = tsynth.clone_topology(tt), jsynth.clone_topology(jt)
        tn.link_delta(tgraph.TopologyDelta(base_key=tt.cache_key, **ghost))
        jn.link_delta(jgraph.TopologyDelta(base_key=jt.cache_key, **ghost))
        return tn, jn
    return make


def _without_base(tt, jt, be):
    be._gather_cache.clear()
    je.shared_graph_cache().clear()
    return _linked(lambda t: {"cost": {4: 50}})(tt, jt, be)


FALLBACKS = {
    # case: (make, call after it, the disposition it must count)
    "padding-overflow": (_linked(_flood, max_ops=256), None, ("struct", "full-padding-overflow")),
    "missing-edge": (_ghost_or_overload("missing-edge"), None, ("struct", "full-missing-edge")),
    "no-base": (_without_base, None, ("weight", "full-no-base")),
    "edge-ids-whatif": (_linked(_link_flap), _whatif, ("struct", "full-edge-ids")),
    "edge-ids-masked": (_linked(_link_flap), _masked, ("struct", "full-edge-ids")),
    "overload": (_ghost_or_overload("overload"), None, ("overload", "incremental")),
    "empty": (_linked(lambda t: {}), None, ("empty", "incremental")),
}


@pytest.mark.parametrize("case", sorted(FALLBACKS))
def test_fallback_dispositions_match_jax(case):
    make, then, want = FALLBACKS[case]
    port, jax_paths = _fallback(8, make, then=then)
    assert port == jax_paths
    assert port[want] == 1, port


def test_no_prev_disposition_matches_jax():
    """Backends that marshaled the base but kept no run of it."""
    tt, jt = _pair(8)
    be, jbe, oracle = TorchSpfBackend(device="cpu"), TpuSpfBackend(N_ATOMS), JScalar(N_ATOMS)
    be.prepare(tt)
    jbe.prepare(jt)
    disp = _Dispositions(be)
    tn, jn = _linked(lambda t: {"cost": {4: 50}})(tt, jt, be)
    got = be.compute(tn)
    _same(got, jbe.compute(jn), "jax")
    _same(got, oracle.compute(jn), "oracle")
    port, jax_paths = disp.step()
    assert port == jax_paths and port[("weight", "full-no-prev")] == 1, port


def test_empty_delta_marshals_nothing():
    tt, _ = _pair(2)
    be = TorchSpfBackend(device="cpu")
    be.compute(tt)
    tn = tsynth.clone_topology(tt)
    tn.link_delta(tgraph.diff_topologies(tt, tn))
    misses = be._gather_cache.lookups["miss"]
    _same(be.compute(tn), ScalarSpfBackend().compute(tn))
    assert be._gather_cache.lookups["miss"] == misses
    assert be.delta_paths == Counter({("empty", "apply"): 1, ("empty", "incremental"): 1})


def test_too_deep_chain_matches_jax():
    rng = np.random.default_rng(9)
    tt, jt = _pair(9)
    be, jbe, _, oracle = _backends()
    cache = je.shared_graph_cache()
    old = cache.max_delta_depth
    be._gather_cache.max_delta_depth = cache.max_delta_depth = 2
    try:
        be.compute(tt)
        jbe.compute(jt)
        disp = _Dispositions(be)
        for _ in range(6):
            tt, jt, _, _ = _step(tt, jt, cost={int(rng.integers(0, tt.n_edges)): 40})
            got = be.compute(tt)
            _same(got, jbe.compute(jt), "jax")
            _same(got, oracle.compute(jt), "oracle")
        port, jax_paths = disp.step()
    finally:
        cache.max_delta_depth = old
    assert port == jax_paths and port[("weight", "full-depth")] > 0


def test_atom_overflow_in_the_cache_matches_jax():
    """An added edge whose atom the resident's words cannot hold: both
    caches refuse the delta (and the rebuild at that width raises, as
    build_ell does); the backend, whose width follows the topology, serves
    it from a full marshal with the oracle's bits."""
    tt, jt = _pair(10)
    spec = {"extra": [[tt.root, 7, 2, N_ATOMS]]}
    tn, jn, _, _ = _step(tt, jt, **spec)
    tc = te.DeviceGraphCache("cpu")
    jc = je.DeviceGraphCache()
    tc.get(tt, N_ATOMS)
    jc.get(jt, N_ATOMS)
    before = _jax_paths()
    with pytest.raises(ValueError, match="bitmask width"):
        jc.get(jn, N_ATOMS)
    with pytest.raises(ValueError, match="bitmask width"):
        tc.get(tn, N_ATOMS)
    assert tc.delta_paths == _jax_paths() - before == Counter({("struct", "full-atom-overflow"): 1})
    be = TorchSpfBackend(device="cpu")
    be.compute(tt)
    _same(be.compute(tn), JScalar(N_ATOMS).compute(jn))


def test_whatif_rides_a_weight_delta_and_rebuilds_after_a_struct_one():
    tt, jt = _pair(11)
    be, jbe, _, oracle = _backends()
    be.compute(tt)
    jbe.compute(jt)
    for spec, how in (({"cost": {5: 33}}, "delta"), (_link_flap(tt), "miss"),
                      ({"cost": {6: 2}}, "delta")):
        tt, jt, _, _ = _step(tt, jt, **spec)
        lookups = Counter(be._gather_cache.lookups)
        masks = _masks(tt)
        got = be.compute_whatif(tt, masks)
        assert be._gather_cache.lookups - lookups == Counter({how: 1})
        for a, b, r in zip(got, jbe.compute_whatif(jt, masks), oracle.compute_whatif(jt, masks)):
            _same(a, b, "jax")
            _same(a, r, "oracle")
        _same(be.compute(tt), oracle.compute(jt), "compute after the what-if")


def test_multiroot_rides_the_chain():
    tt, jt = _pair(12)
    be = TorchSpfBackend(device="cpu")
    be.compute(tt)
    tt, jt, _, _ = _step(tt, jt, **_link_flap(tt))
    roots = [0, 3, tt.root]
    got = be.compute_multiroot(tt, roots)
    assert be.delta_paths[("struct", "apply")] == 1
    want = JScalar(N_ATOMS).compute_multiroot(jt, roots)
    for f in ("dist", "parent", "hops"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)


def test_earlier_results_hold_across_later_deltas():
    """On the CPU a result's planes alias the tensors kept as the next
    delta's seed: the incremental run must only read them."""
    tt, _ = _pair(13)
    be = TorchSpfBackend(device="cpu")
    first = be.compute(tt)
    kept = {f: getattr(first, f).copy() for f in FIELDS}
    for spec in ({"cost": {2: 60}}, _link_flap, {"cost": {8: 1}}):
        tn = tsynth.clone_topology(tt, **(spec(tt) if callable(spec) else spec))
        tn.link_delta(tgraph.diff_topologies(tt, tn))
        be.compute(tn)
        tt = tn
    assert be.delta_paths[("weight", "incremental")] == 2
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(first, f), kept[f], err_msg=f)


def test_disarmed_backend_keeps_nothing():
    tt, _ = _pair(14)
    be = TorchSpfBackend(device="cpu", incremental=False)
    be.compute(tt)
    tn = tsynth.clone_topology(tt, cost={1: int(tt.edge_cost[1]) + 7})
    tn.link_delta(tgraph.diff_topologies(tt, tn))
    _same(be.compute(tn), ScalarSpfBackend().compute(tn))
    assert not be._prev_one and not be.delta_paths
    assert be._gather_cache.lookups == Counter({"miss": 2})


def test_blocked_engine_keeps_no_run():
    tt, _ = _pair(15)
    be = TorchSpfBackend(engine="blocked", device="cpu")
    be.compute(tt)
    assert not be._prev_one and be.routed_to_gather == 0


def test_prev_capacity_bounds_the_kept_runs():
    be = TorchSpfBackend(device="cpu", prev_capacity=2)
    topos = [_pair(s)[0] for s in range(3)]
    for t in topos:
        be.compute(t)
    assert len(be._prev_one) == 2
    tn = tsynth.clone_topology(topos[0], cost={0: int(topos[0].edge_cost[0]) + 7})
    tn.link_delta(tgraph.diff_topologies(topos[0], tn))
    be.compute(tn)  # the full path, on the base's graph updated in place
    assert be.delta_paths == Counter({("weight", "full-no-prev"): 1, ("weight", "apply"): 1})


def test_cache_stats_and_lru():
    tt, _ = _pair(16)
    cache = te.DeviceGraphCache("cpu", capacity=2)
    g, how = cache.get(tt, N_ATOMS)
    assert how == "miss" and cache.get(tt, N_ATOMS) == (g, "hit")
    tn = tsynth.clone_topology(tt, **_link_flap(tt))
    tn.link_delta(tgraph.diff_topologies(tt, tn))
    g2, how = cache.get(tn, N_ATOMS)
    assert how == "delta" and g2 is g and len(cache) == 1
    st = cache.stats()
    assert st == {"entries": 1, "capacity": 2, "evictions": 0, "deltas-applied": 1,
                  "delta-entries": 1, "max-chain-depth": 1, "stale-id-entries": 1,
                  "tropical-entries": 0, "occupancy": st["occupancy"]}
    assert 0 < st["occupancy"] < 1
    for s in (20, 21):
        cache.get(_pair(s)[0], N_ATOMS)
    assert len(cache) == 2 and cache.stats()["evictions"] == 1
    assert cache.get(tn, N_ATOMS)[1] == "miss"  # tn's entry was the oldest
    cache.clear()
    assert len(cache) == 0


def test_spf_result_has_the_multipath_fields_as_none():
    """A single-path run (multipath_k=1, the default) leaves the five
    multipath fields None; multipath_k > 1 fills them
    (tests/test_torch_multipath.py)."""
    tt, _ = _pair(17)
    be = TorchSpfBackend(device="cpu")
    for res in (be.compute(tt), be.compute(tt, multipath_k=1)):
        assert isinstance(res, SpfResult)
        for f in ("parents", "pdist", "pweight", "npaths", "nh_weights"):
            assert getattr(res, f) is None, f


# ---------------------------------------------------------------------------
# The protocol seam and the two Topology classes


def test_holo_tpu_topology_and_delta_served_incrementally():
    _, jt = _pair(18)
    be = TorchSpfBackend(device="cpu")
    be.compute(jt)
    for i, spec in enumerate(({"cost": {3: 44}}, _link_flap(jt))):
        jn = jsynth.clone_topology(jt, **spec)
        jn.link_delta(jgraph.diff_topologies(jt, jn))
        _same(be.compute(jn), JScalar(N_ATOMS).compute(jn), f"step {i}")
        jt = jn
    assert be.delta_paths[("weight", "incremental")] == 1
    assert be.delta_paths[("struct", "incremental")] == 1


def test_ospfv2_seam_storm_matches_scalar():
    from holo_tpu.spf.synth_storm import StormNet

    def run(backend):
        net = StormNet(n_routers=50, seed=13, spf_backend=backend)
        for i in range(6):
            net.flap(net.flappable[i % len(net.flappable)], lost=False)
            net.loop.advance(12.0)
        net.loop.advance(40.0)
        return dict(net.kernel.fib)

    be = TorchSpfBackend(device="cpu")
    assert run(be) == run(None)
    assert sum(v for (_, path), v in be.delta_paths.items() if path == "incremental") > 0


@pytest.mark.parametrize("engine", ["gather", "blocked"])
def test_topology_classes_with_equal_keys_do_not_share_planes(engine):
    """A port topology and a holo_tpu topology whose (uid, generation) are
    equal -- the first of each class in a fresh process -- each get their
    own planes from one backend."""
    a = tsynth.random_ospf_topology(n_routers=12, n_networks=2, seed=1)
    b = jsynth.random_ospf_topology(n_routers=12, n_networks=2, seed=2)
    b._uid, b.generation = a._uid, a.generation
    assert a.cache_key == b.cache_key
    # b's borrowed uid may name a holo_tpu topology an earlier test of this
    # process left in the shared cache: start from an empty one.
    te.shared_graph_cache("cpu").clear()
    be = TorchSpfBackend(engine=engine, device="cpu")
    ra = be.compute(a)
    _same(be.compute(b), JScalar().compute(b), "holo_tpu topology")
    _same(be.compute(a), ra, "port topology again")
    _same(ra, ScalarSpfBackend().compute(a), "port topology")


def test_a_delta_of_the_other_class_is_never_applied():
    """A holo_tpu delta whose base_key is a port topology's key finds
    neither that topology's kept run nor its resident graph."""
    a, jb = _pair(19)
    be = TorchSpfBackend(device="cpu")
    ra = be.compute(a)
    jn = jsynth.clone_topology(jb, cost={e: int(jb.edge_cost[e]) + 5 for e in range(0, 40, 4)})
    d = jgraph.diff_topologies(jb, jn)
    d.base_key = a.cache_key
    jn.link_delta(d)
    _same(be.compute(jn), JScalar(N_ATOMS).compute(jn), "holo_tpu topology")
    assert be.delta_paths == Counter({("weight", "full-no-prev"): 1,
                                      ("weight", "full-no-base"): 1})
    resident = be.prepare(a)
    fresh = te.device_graph_from_ell(tgraph.build_ell(a, n_atoms=N_ATOMS), "cpu")
    for f in GRAPH_PLANES:
        assert torch.equal(getattr(resident, f), getattr(fresh, f)), f
    _same(be.compute(a), ra, "port topology again")
