"""The port's tropical engine (holo_tpu_torch.ops.tropical) against
holo_tpu.ops.tropical on JAX-CPU, bit for bit (tolerance: exact int32 on every
plane; the computation is integer-only).

- ``bandwidth_permutation``, ``build_tiles_host`` (planes and meta, the
  edgeless graph too) and ``repair_rows_host`` equal JAX's;
- ``lower_tile_delta`` / ``apply_tile_delta`` along mirrored delta chains
  (an overload strike, an addition without a tile) equal JAX's, the drops
  with the same reason;
- the plain T1 round (``trop_relax`` on CPU tensors) equals one body step
  of JAX's ``_tile_relax`` from JAX's own state of every round, with and
  without repair rows (JAX's explicit rows and the port's device-built
  set), in the new distances (written whole into ``out``), the changed flag
  and the next frontier;
- ``repair_set`` lists every repair bit once, in row-major order; with
  each round written only where the kernels write (the input frontier's
  (block, lane)s, the changed values and the repair pairs) into the buffer
  ``tile_relax`` passes as ``out``, that buffer equals the input outside
  the frontier every round, and the what-if, masked single, masked
  multiroot and incremental programs equal JAX's at ``max_iters`` None, 1
  and 2;
- ``tropical_spf_one``, ``tropical_whatif_batch``, ``tropical_multiroot``
  (masked and not) and ``tropical_spf_one_incremental`` equal JAX's on
  JAX's own tiles at ``max_iters`` None, 0, 1, 2 and 4, and the scalar
  oracle at convergence;
- the device-built repair set is the rows with a masked valid slot, within
  JAX's;
- ``TorchSpfBackend(one_engine="tropical")`` equals
  ``TpuSpfBackend(one_engine="tropical")`` on compute (masked too),
  compute_whatif, compute_multiroot and delta chains, with JAX's DeltaPath
  and tile-delta dispositions; at ``multipath_k`` > 1 its compute is
  ``mp_tropical`` (tests/test_torch_tropical_mp.py holds it), counted by no
  breaker, and its what-if is ``mp``.

JAX results are computed once per module where several tests read them.
"""

from collections import Counter

import jax
import numpy as np
import pytest
import torch

from holo_tpu import telemetry
from holo_tpu.ops import graph as jgraph
from holo_tpu.ops import spf_engine as je
from holo_tpu.ops import tropical as jtrop
from holo_tpu.spf import synth as jsynth
from holo_tpu.spf.backend import ScalarSpfBackend as JScalar
from holo_tpu.spf.backend import TpuSpfBackend
from holo_tpu_torch import pipeline
from holo_tpu_torch.kernels import ell
from holo_tpu_torch.kernels import tropical as kt
from holo_tpu_torch.ops import graph as tgraph
from holo_tpu_torch.ops import spf_engine as te
from holo_tpu_torch.ops import tropical as trop
from holo_tpu_torch.pipeline import tuner as ttuner
from holo_tpu_torch.resilience import tallies
from holo_tpu_torch.spf import synth as tsynth
from holo_tpu_torch.spf.backend import ScalarSpfBackend, TorchSpfBackend

N_ATOMS = 64
INF = 1 << 30
LIMITS = (None, 0, 1, 2, 4)
FIELDS = ("dist", "parent", "hops", "nexthop_words")
SHAPES = {
    "ospf30": lambda m: m.random_ospf_topology(n_routers=30, n_networks=6, extra_p2p=30, seed=3),
    "ospf60": lambda m: m.random_ospf_topology(n_routers=60, n_networks=12, extra_p2p=80,
                                               max_cost=4, seed=5),
    "fat8": lambda m: m.fat_tree_topology(k=8),
}
LANES = 40  # what-if scenarios: two mask words


class Case:
    """One topology in both packages, its graphs, JAX's tiles (host and
    device) and the port's copy of them, what-if masks and JAX's repair rows."""

    def __init__(self, shape: str):
        self.tt, self.jt = SHAPES[shape](tsynth), SHAPES[shape](jsynth)
        self.n = self.tt.n_vertices
        jell = jgraph.build_ell(self.jt, n_atoms=N_ATOMS)
        self.jg = je.device_graph_from_ell(jell)
        self.tg = te.device_graph_from_ell(tgraph.build_ell(self.tt, n_atoms=N_ATOMS), "cpu")
        self.host, self.meta = jtrop.build_tiles_host(jell.in_src, jell.in_cost, jell.in_valid)
        self.jtiles = jax.device_put(self.host)
        self.tiles = trop.tiles_on(self.host, "cpu")
        self.masks = jsynth.whatif_link_failure_masks(self.jt, LANES, seed=6)
        self.rr = jtrop.repair_rows_host(self.jt.edge_dst, self.masks, self.n)
        self.roots = np.sort(np.random.default_rng(2).choice(self.n, 5, replace=False)
                             ).astype(np.int32)


@pytest.fixture(scope="module", params=sorted(SHAPES))
def case(request):
    return Case(request.param)


@pytest.fixture(autouse=True)
def _reset_tuner():
    yield
    pipeline.reset_engine_tuner()


def _same_tensors(got, want, label, fields=("dist", "parent", "hops", "nexthops")):
    for f in fields:
        g = getattr(got, f).numpy()
        w = np.asarray(getattr(want, f))
        np.testing.assert_array_equal(g.view(np.uint32) if f == "nexthops" else g, w,
                                      err_msg=f"{label} {f}")


def _same(a, b, label):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, (label, f)
        np.testing.assert_array_equal(x, y, err_msg=f"{label} {f}")


# ---------------------------------------------------------------------------
# The marshal


@pytest.mark.parametrize("shape", sorted(SHAPES) + ["edgeless", "one", "ring"])
def test_bandwidth_permutation_matches_jax(shape):
    if shape in SHAPES:
        topo = SHAPES[shape](tsynth)
        args = (topo.n_vertices, topo.edge_src, topo.edge_dst)
    elif shape == "edgeless":
        args = (5, np.zeros(0, np.int32), np.zeros(0, np.int32))
    elif shape == "one":
        args = (1, np.zeros(0, np.int32), np.zeros(0, np.int32))
    else:
        src = np.arange(9, dtype=np.int32)
        args = (12, src, (src + 3) % 12)  # three isolated vertices too
    got = tgraph.bandwidth_permutation(*args)
    want = jgraph.bandwidth_permutation(*args)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert sorted(got.tolist()) == list(range(args[0]))


@pytest.mark.parametrize("block", [None, 8, 16, 32])
def test_build_tiles_host_matches_jax(case, block):
    ell_ = tgraph.build_ell(case.tt, n_atoms=N_ATOMS)
    got, meta = trop.build_tiles_host(ell_.in_src, ell_.in_cost, ell_.in_valid, block)
    jell = jgraph.build_ell(case.jt, n_atoms=N_ATOMS)
    want, jmeta = jtrop.build_tiles_host(jell.in_src, jell.in_cost, jell.in_valid, block)
    for f in trop.TropicalTiles._fields:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert meta.keys() == jmeta.keys()
    for k in meta:
        np.testing.assert_array_equal(meta[k], jmeta[k], err_msg=k)
    if block is None:
        assert meta["block"] == trop._pick_block(case.n, *_permuted_edges(ell_, meta))


def _permuted_edges(ell_, meta):
    rows, cols = np.nonzero(ell_.in_valid)
    srcs = ell_.in_src[rows, cols].astype(np.int64)
    return meta["inv"][rows].astype(np.int64), meta["inv"][srcs].astype(np.int64)


def test_build_tiles_host_edgeless_matches_jax():
    kw = dict(n_vertices=1, is_router=np.ones(1, bool), edge_src=np.zeros(0, np.int32),
              edge_dst=np.zeros(0, np.int32), edge_cost=np.zeros(0, np.int32), root=0)
    tt, jt = tgraph.Topology(**kw), jgraph.Topology(**kw)
    t_ell, j_ell = tgraph.build_ell(tt, n_atoms=N_ATOMS), jgraph.build_ell(jt, n_atoms=N_ATOMS)
    got, meta = trop.build_tiles_host(t_ell.in_src, t_ell.in_cost, t_ell.in_valid)
    want, jmeta = jtrop.build_tiles_host(j_ell.in_src, j_ell.in_cost, j_ell.in_valid)
    for f in trop.TropicalTiles._fields:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    assert (meta["tm"], meta["pairs"], meta["nb"]) == (jmeta["tm"], jmeta["pairs"], 1)
    assert (got.tiles == INF).all()
    res = TorchSpfBackend(one_engine="tropical", device="cpu").compute(tt)
    _same(res, TpuSpfBackend(N_ATOMS, one_engine="tropical").compute(jt), "edgeless jax")
    _same(res, ScalarSpfBackend().compute(tt), "edgeless oracle")


def test_repair_rows_host_matches_jax(case):
    for masks in (case.masks, case.masks[:1], np.ones((3, case.tt.n_edges), bool),
                  np.zeros((2, case.tt.n_edges), bool)):
        got = trop.repair_rows_host(case.tt.edge_dst, masks, case.n)
        want = jtrop.repair_rows_host(case.jt.edge_dst, masks, case.n)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# Tile deltas


def _mirrors(tt, jt):
    return (te._EllMirror(tgraph.build_ell(tt, n_atoms=N_ATOMS)),
            je._EllMirror(jgraph.build_ell(jt, n_atoms=N_ATOMS)))


def _tiles_of(tm, jm):
    """Both packages' tiles built from their mirrors: (port tensors, port
    meta, JAX device tiles, JAX meta)."""
    host, meta = trop.build_tiles_host(tm.in_src, tm.in_cost, tm.in_valid)
    jhost, jmeta = jtrop.build_tiles_host(jm.in_src, jm.in_cost, jm.in_valid)
    return trop.tiles_on(host, "cpu"), meta, jax.device_put(jhost), jmeta


def _missing_pair(mirror, meta):
    """(u, v): vertices whose block pair has no tile, v with a free slot."""
    inv, b, tm = meta["inv"], meta["block"], meta["tm"]
    n = mirror.in_src.shape[0]
    for v in range(n):
        if mirror.in_valid[v].all():
            continue
        for u in range(n):
            if u != v and meta["pos"][inv[v] // b, inv[u] // b] >= tm:
                return u, v
    raise AssertionError("every block pair has a tile")


@pytest.mark.parametrize("seed", range(3))
def test_tile_deltas_match_jax(seed):
    rng = np.random.default_rng(seed)
    kw = dict(n_routers=80, n_networks=8, extra_p2p=30)  # sparse: block pairs without tiles
    tt = tsynth.random_ospf_topology(seed=seed + 11, **kw)
    jt = jsynth.random_ospf_topology(seed=seed + 11, **kw)
    n = tt.n_vertices
    tm, jm = _mirrors(tt, jt)
    tiles, meta, jtiles, jmeta = _tiles_of(tm, jm)
    drops = applied = struck = 0
    for i in range(14):
        if i == 5:
            v = int(tt.edge_src[np.nonzero(tt.edge_src != tt.root)[0][0]])
            td = tgraph.TopologyDelta(base_key=tt.cache_key, overload=np.asarray([v], np.int32),
                                      ids_stable=False)
            jd = jgraph.TopologyDelta(base_key=jt.cache_key, overload=np.asarray([v], np.int32),
                                      ids_stable=False)
            tn, jn = tt, jt
            struck += 1
        else:
            if i == 9:
                u, v = _missing_pair(tm, meta)
                spec = {"extra": [[u, v, 3, -1]]}
            else:
                spec = _mutation(tt, rng)
            tn, jn = tsynth.clone_topology(tt, **spec), jsynth.clone_topology(jt, **spec)
            td, jd = tgraph.diff_topologies(tt, tn), jgraph.diff_topologies(jt, jn)
        try:
            je._lower_delta(jm, jd, n)
        except je._DeltaUnappliable:
            tm, jm = _mirrors(tn, jn)
            tiles, meta, jtiles, jmeta = _tiles_of(tm, jm)
            tt, jt = tn, jn
            continue
        te.lower_delta(tm, td, n)
        try:
            jops = jtrop.lower_tile_delta(jm, jd, jmeta)
        except jtrop.TileDeltaUnappliable as exc:
            with pytest.raises(trop.TileDeltaUnappliable) as got:
                trop.lower_tile_delta(tm, td, meta)
            assert got.value.reason == exc.reason == "tile-missing"
            drops += 1
            tiles, meta, jtiles, jmeta = _tiles_of(tm, jm)
        else:
            ops = trop.lower_tile_delta(tm, td, meta)
            real = jops[0] < jmeta["nb"]
            for k, name in enumerate(("rb", "slot", "i", "j", "val")):
                np.testing.assert_array_equal(getattr(ops, name), jops[k][real], err_msg=name)
            got_strike = np.zeros(jops[5].shape, bool) if ops.strike is None else ops.strike
            np.testing.assert_array_equal(got_strike, jops[5])
            trop.apply_tile_delta(tiles, ops)
            jtiles = jtrop.apply_tile_delta(jtiles, *jops)
            applied += 1
        np.testing.assert_array_equal(tiles.tiles.numpy(), np.asarray(jtiles.tiles),
                                      err_msg=f"seed {seed} step {i}")
        tt, jt = tn, jn
    assert drops >= 1 and applied >= 5 and struck == 1


def _mutation(topo, rng) -> dict:
    """A metric change, a link flap (both directions) or a fresh
    bidirectional edge, as clone_topology arguments."""
    roll = rng.random()
    if roll < 0.4:
        e = int(rng.integers(0, topo.n_edges))
        return {"cost": {e: int(rng.integers(1, 64))}}
    if roll < 0.8:
        e = int(rng.integers(0, topo.n_edges))
        s, d = int(topo.edge_src[e]), int(topo.edge_dst[e])
        keep = ~(((topo.edge_src == s) & (topo.edge_dst == d))
                 | ((topo.edge_src == d) & (topo.edge_dst == s)))
        return {"keep": keep}
    a, b = (int(x) for x in rng.integers(0, topo.n_vertices, 2))
    w = int(rng.integers(1, 32))
    return {"extra": [[a, b, w, -1], [b, a, w, -1]]}


# ---------------------------------------------------------------------------
# The plain T1 round against one body step of JAX's _tile_relax


# The round limits are traced (an int), so each function compiles once per
# shape and once more for max_iters None.
_JAX_RELAX = jax.jit(jtrop._tile_relax)


@pytest.mark.parametrize("repair", ["none", "jax-rows", "device-set"])
def test_plain_round_is_one_jax_body_step(case, repair):
    lanes = LANES if repair != "none" else 3
    n, tt = case.n, case.tiles
    nb, _, b, _ = tt.tiles.shape
    roots = np.full(lanes, case.tt.root) if repair != "none" else case.roots[:lanes]
    dist0 = np.full((n, lanes), INF, np.int32)
    dist0[roots, np.arange(lanes)] = 0
    masks = case.masks if repair != "none" else None
    rr = case.rr if repair != "none" else None
    mask_w = None if masks is None else te.pack_edge_masks(masks, "cpu")
    p = te.lane_planes(case.tg, mask_w)
    if repair == "jax-rows":
        rep = kt.repair_set(trop.rows_to_bits(rr, tt), lanes)
    elif repair == "device-set":
        rep = kt.repair_set(trop.repair_bits(p.slot, mask_w, lanes, tt), lanes)
    else:
        rep = None
    perm, inv = tt.perm.long(), tt.inv.long()
    states = [dist0]
    active = ell.full_frontier(nb, lanes, "cpu")
    for r in range(n):
        states.append(np.asarray(_JAX_RELAX(case.jg, case.jtiles, dist0, masks, rr, r + 1)))
        cur = torch.from_numpy(np.array(states[r]))[perm].contiguous()
        out = torch.full_like(cur, -3)  # the plain round writes out whole
        new, changed, active_out = kt.trop_relax(tt.tiles, tt.cb, cur, active, out, rep, p.src,
                                                 p.cost, p.slot, p.mask, tt.perm, tt.inv)
        assert new is out
        np.testing.assert_array_equal(new[inv].numpy(), states[r + 1], err_msg=f"round {r + 1}")
        moved = torch.from_numpy(states[r + 1] != states[r])[perm]
        moved[n:] = False  # padding rows read vertex 0 here; they never change
        moved = moved.view(nb, b, lanes).any(1)
        assert bool(changed) == bool(moved.any()), r
        np.testing.assert_array_equal(active_out.numpy(), ell.pack_lane_bits(moved).numpy())
        if not bool(changed):
            break
        active = active_out
    assert r >= 2


# ---------------------------------------------------------------------------
# The programs against JAX's, on JAX's tiles


_J_ONE = jax.jit(jtrop.tropical_spf_one)
_J_WHATIF = jax.jit(jtrop.tropical_whatif_batch)
_J_MULTIROOT = jax.jit(jtrop.tropical_multiroot)
_J_INCR = jax.jit(jtrop.tropical_spf_one_incremental)


@pytest.mark.parametrize("max_iters", LIMITS)
def test_tropical_spf_one_matches_jax(case, max_iters):
    root = case.tt.root
    want = _J_ONE(case.jg, case.jtiles, root, None, None, max_iters)
    _same_tensors(trop.tropical_spf_one(case.tg, case.tiles, root, None, None, max_iters), want,
                  "unmasked")
    mask = case.masks[1]
    rows = jtrop.repair_rows_host(case.jt.edge_dst, mask[None], case.n)[0]
    want = _J_ONE(case.jg, case.jtiles, root, mask, rows, max_iters)
    for label, got_rows in (("jax rows", rows), ("device set", None)):
        _same_tensors(trop.tropical_spf_one(case.tg, case.tiles, root, mask, got_rows,
                                            max_iters), want, f"masked, {label}")
    if max_iters is None:
        ref = JScalar(N_ATOMS).compute(case.jt, mask)
        got = trop.tropical_spf_one(case.tg, case.tiles, root, mask, None)
        np.testing.assert_array_equal(got.dist.numpy(), ref.dist)
        np.testing.assert_array_equal(got.nexthops.numpy().view(np.uint32), ref.nexthop_words)


@pytest.mark.parametrize("max_iters", LIMITS)
def test_tropical_whatif_batch_matches_jax(case, max_iters):
    root = case.tt.root
    want = _J_WHATIF(case.jg, case.jtiles, root, case.masks, case.rr, max_iters)
    for label, rows in (("jax rows", case.rr), ("device set", None)):
        got = trop.tropical_whatif_batch(case.tg, case.tiles, root, case.masks, rows, max_iters)
        _same_tensors(got, want, label)
    if max_iters is None:
        ref = JScalar(N_ATOMS).compute_whatif(case.jt, case.masks[:4])
        for b in range(4):
            np.testing.assert_array_equal(got.dist[b].numpy(), ref[b].dist)
            np.testing.assert_array_equal(got.parent[b].numpy(), ref[b].parent)


@pytest.mark.parametrize("max_iters", [None, 1, 2])
def test_whatif_across_jax_lane_chunks_matches_jax(max_iters):
    """160 scenarios: JAX runs them in two sequential chunks of LANE_CHUNK
    (128) lanes, each stopping when its own lanes converge; the port runs
    one lane set.  Truncated or not, every lane ends where JAX's does."""
    case = Case("ospf30")
    masks = jsynth.whatif_link_failure_masks(case.jt, 160, seed=8)
    assert masks.shape[0] > jtrop.LANE_CHUNK
    rr = jtrop.repair_rows_host(case.jt.edge_dst, masks, case.n)
    want = _J_WHATIF(case.jg, case.jtiles, case.jt.root, masks, rr, max_iters)
    got = trop.tropical_whatif_batch(case.tg, case.tiles, case.tt.root, masks, None, max_iters)
    _same_tensors(got, want, f"160 lanes, max_iters {max_iters}")


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("max_iters", LIMITS)
def test_tropical_multiroot_matches_jax(case, max_iters, masked):
    mask = case.masks[2] if masked else None
    rows = (jtrop.repair_rows_host(case.jt.edge_dst, mask[None], case.n)[0] if masked
            else None)
    want = _J_MULTIROOT(case.jg, case.jtiles, case.roots, mask, rows, max_iters)
    for label, got_rows in (("jax rows", rows), ("device set", None)):
        got = trop.tropical_multiroot(case.tg, case.tiles, case.roots, mask, got_rows, max_iters)
        assert got.nexthops is None
        _same_tensors(got, want, label, fields=("dist", "parent", "hops"))
    if max_iters is None and not masked:
        ref = JScalar(N_ATOMS).compute_multiroot(case.jt, case.roots)
        np.testing.assert_array_equal(got.dist.numpy(), ref.dist)
        np.testing.assert_array_equal(got.hops.numpy(), ref.hops)


def _incremental(case, max_iters, stats=None):
    """(port, JAX, new port topology): a link removal and a cost change
    after a converged run, JAX's incremental program on JAX's tiles of the
    new graph, the port's on its copy of them, from the same previous run."""
    tt, jt = case.tt, case.jt
    e = int(np.nonzero((tt.edge_src != tt.root) & (tt.edge_dst != tt.root))[0][3])
    s, d = int(tt.edge_src[e]), int(tt.edge_dst[e])
    keep = ~((tt.edge_src == s) & (tt.edge_dst == d))
    spec = {"keep": keep, "cost": {0: int(tt.edge_cost[0]) + 5}}
    tn, jn = tsynth.clone_topology(tt, **spec), jsynth.clone_topology(jt, **spec)
    jd = jgraph.diff_topologies(jt, jn)
    seeds = jd.seed_rows().astype(np.int32)
    jprev = _J_ONE(case.jg, case.jtiles, jt.root, None, None, None)
    prev = trop.tropical_spf_one(case.tg, case.tiles, tt.root)
    jell = jgraph.build_ell(jn, n_atoms=N_ATOMS)
    host, _ = jtrop.build_tiles_host(jell.in_src, jell.in_cost, jell.in_valid)
    jg2 = je.device_graph_from_ell(jell)
    tg2 = te.device_graph_from_ell(tgraph.build_ell(tn, n_atoms=N_ATOMS), "cpu")
    want = _J_INCR(jg2, jax.device_put(host), jt.root, jprev, seeds, max_iters)
    got = trop.tropical_spf_one_incremental(tg2, trop.tiles_on(host, "cpu"), tt.root, prev,
                                            seeds, max_iters, stats)
    return got, want, tn


@pytest.mark.parametrize("max_iters", LIMITS)
def test_tropical_incremental_matches_jax(case, max_iters):
    """A link removal and a cost change after a converged run: JAX's
    incremental program on JAX's tiles of the new graph, the port's on its
    copy of them, from the same previous run."""
    stats = {}
    got, want, tn = _incremental(case, max_iters, stats)
    _same_tensors(got, want, "incremental")
    assert stats["relax"] <= (case.n if max_iters is None else max_iters)
    if max_iters is None:
        ref = ScalarSpfBackend().compute(tn)
        np.testing.assert_array_equal(got.dist.numpy(), ref.dist)
        np.testing.assert_array_equal(got.parent.numpy(), ref.parent)


def test_repair_set_is_the_rows_with_a_masked_valid_slot(case):
    tt = case.tiles
    mask_w = te.pack_edge_masks(case.masks, "cpu")
    p = te.lane_planes(case.tg, mask_w)
    got = trop.repair_bits(p.slot, mask_w, LANES, tt)
    ell_ = tgraph.build_ell(case.tt, n_atoms=N_ATOMS)
    rows = np.full((LANES, case.n), case.n, np.int32)
    for s in range(LANES):
        hit = (ell_.in_valid & ~case.masks[s][ell_.in_edge_id]).any(1)
        rows[s, :hit.sum()] = np.nonzero(hit)[0]
    np.testing.assert_array_equal(got.numpy(), trop.rows_to_bits(rows, tt).numpy())
    jax_set = trop.rows_to_bits(case.rr, tt)
    assert not (got & ~jax_set).any()
    assert got.any() and (got[case.n:] == 0).all()


def test_repair_set_lists_every_bit_once_in_row_major_order(case):
    """repair_set's pairs: the (permuted row, lane) of every set bit, rows
    ascending and lanes ascending within a row, int32 [R, 2]; none for an
    empty plane.  Lane 39 of 40 is in the second word."""
    tt = case.tiles
    mask_w = te.pack_edge_masks(case.masks, "cpu")
    p = te.lane_planes(case.tg, mask_w)
    for bits in (trop.repair_bits(p.slot, mask_w, LANES, tt), trop.rows_to_bits(case.rr, tt),
                 torch.zeros_like(trop.rows_to_bits(case.rr, tt))):
        rep = kt.repair_set(bits, LANES)
        assert rep.bits is bits and rep.pairs.dtype == torch.int32 and rep.pairs.is_contiguous()
        flags = np.zeros((bits.shape[0], LANES), bool)
        for s in range(LANES):
            flags[:, s] = (bits[:, s // 32].numpy() >> (s % 32)) & 1
        np.testing.assert_array_equal(rep.pairs.numpy().reshape(-1, 2),
                                      np.argwhere(flags).astype(np.int32))
        assert torch.equal(ell.pack_lane_bits(torch.from_numpy(flags)), bits)


def _copy_rule(written: list):
    """trop_relax as the kernels write ``out``: the plain round into a
    scratch plane, then only the input frontier's (block, lane)s, the values
    that changed and the repair pairs written into ``out`` -- after checking
    the preconditions: ``out`` another buffer, equal to ``dist`` outside the
    frontier."""
    plain = kt.trop_relax_plain

    def run(tiles, cb, dist, active, out, repair=None, *rest):
        b, lanes = tiles.shape[2], dist.shape[1]
        assert out.data_ptr() != dist.data_ptr(), "out is the input buffer"
        front = ell._unpack(active, slice(0, lanes)).repeat_interleave(b, 0)  # [NB * B, S]
        assert torch.equal(out[~front], dist[~front]), "out differs outside the frontier"
        before = out.clone()
        new, changed, active_out = plain(tiles, cb, dist, active, torch.full_like(out, -5),
                                         repair, *rest)
        write = front | (new != dist)
        if repair is not None:
            write |= ell._unpack(repair.bits, slice(0, lanes))
        out.copy_(torch.where(write, new, before))
        written.append((int(write.sum()), write.numel()))
        return out, changed, active_out

    return run


@pytest.mark.parametrize("max_iters", [None, 1, 2])
@pytest.mark.parametrize("program", ["whatif", "one-masked", "multiroot-masked", "incremental"])
def test_copy_rule_rounds_match_jax(case, program, max_iters, monkeypatch):
    """Every round written only where the kernels write (the frontier's
    (block, lane)s, the changed values, the repair pairs) into the buffer
    that tile_relax passes as ``out``: the precondition holds every round,
    and each program, truncated or not, ends where JAX's does."""
    written = []
    monkeypatch.setattr(kt, "trop_relax", _copy_rule(written))
    root = case.tt.root
    if program == "whatif":
        want = _J_WHATIF(case.jg, case.jtiles, root, case.masks, case.rr, max_iters)
        got = trop.tropical_whatif_batch(case.tg, case.tiles, root, case.masks, None, max_iters)
        _same_tensors(got, want, program)
    elif program == "one-masked":
        mask = case.masks[5]
        rows = jtrop.repair_rows_host(case.jt.edge_dst, mask[None], case.n)[0]
        want = _J_ONE(case.jg, case.jtiles, root, mask, rows, max_iters)
        _same_tensors(trop.tropical_spf_one(case.tg, case.tiles, root, mask, None, max_iters),
                      want, program)
    elif program == "multiroot-masked":
        mask = case.masks[2]
        rows = jtrop.repair_rows_host(case.jt.edge_dst, mask[None], case.n)[0]
        want = _J_MULTIROOT(case.jg, case.jtiles, case.roots, mask, rows, max_iters)
        got = trop.tropical_multiroot(case.tg, case.tiles, case.roots, mask, None, max_iters)
        _same_tensors(got, want, program, fields=("dist", "parent", "hops"))
    else:
        got, want, _ = _incremental(case, max_iters)
        _same_tensors(got, want, program)
    assert written
    if max_iters is None:  # the last rounds rewrite only part of the plane
        assert min(w for w, _ in written) < written[0][1]


# ---------------------------------------------------------------------------
# The backend


def _jax_tile_deltas() -> Counter:
    out = Counter()
    for key, v in telemetry.snapshot(prefix="holo_spf_tropical_delta_total").items():
        out[key[key.index("path=") + 5:-1]] = int(v)
    return out


@pytest.mark.parametrize("max_iters", [None, 2])
def test_backend_matches_jax(case, max_iters):
    be = TorchSpfBackend(one_engine="tropical", device="cpu", max_iters=max_iters,
                         incremental=False)
    jbe = TpuSpfBackend(N_ATOMS, one_engine="tropical", max_iters=max_iters, incremental=False)
    _same(be.compute(case.tt), jbe.compute(case.jt), "compute")
    _same(be.compute(case.tt, case.masks[4]), jbe.compute(case.jt, case.masks[4]), "masked")
    for i, (a, b) in enumerate(zip(be.compute_whatif(case.tt, case.masks),
                                   jbe.compute_whatif(case.jt, case.masks))):
        _same(a, b, f"whatif {i}")
    got, want = be.compute_multiroot(case.tt, case.roots), jbe.compute_multiroot(case.jt,
                                                                                 case.roots)
    for f in ("dist", "parent", "hops"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    assert be._gather_cache.stats()["tropical-entries"] >= 1
    if max_iters is None:
        _same(be.compute(case.tt), ScalarSpfBackend().compute(case.tt), "oracle")


@pytest.mark.parametrize("max_iters", [None, 3])
@pytest.mark.parametrize("seed", range(3))
def test_backend_delta_chain_matches_jax(seed, max_iters):
    rng = np.random.default_rng(seed)
    kw = dict(n_routers=30, n_networks=6, extra_p2p=30)
    tt = tsynth.random_ospf_topology(seed=seed + 40, **kw)
    jt = jsynth.random_ospf_topology(seed=seed + 40, **kw)
    be = TorchSpfBackend(one_engine="tropical", device="cpu", max_iters=max_iters)
    jbe = TpuSpfBackend(N_ATOMS, one_engine="tropical", max_iters=max_iters)
    _same(be.compute(tt), jbe.compute(jt), "first")
    paths, jpaths, jtiles = Counter(be.delta_paths), _jax_delta_paths(), _jax_tile_deltas()
    for i in range(10):
        spec = _mutation(tt, rng)
        tn, jn = tsynth.clone_topology(tt, **spec), jsynth.clone_topology(jt, **spec)
        td, jd = tgraph.diff_topologies(tt, tn), jgraph.diff_topologies(jt, jn)
        if jd is not None:
            tn.link_delta(td)
            jn.link_delta(jd)
        tt, jt = tn, jn
        got = be.compute(tt)
        _same(got, jbe.compute(jt), f"seed {seed} step {i}")
        if max_iters is None:
            _same(got, ScalarSpfBackend().compute(tt), f"seed {seed} step {i} oracle")
    assert Counter(be.delta_paths) - paths == _jax_delta_paths() - jpaths
    assert be._gather_cache.tile_deltas == _jax_tile_deltas() - jtiles
    assert be.delta_paths[("weight", "incremental")] + be.delta_paths[("struct", "incremental")]
    assert be._gather_cache.tile_deltas["apply"] > 0


def _jax_delta_paths() -> Counter:
    out = Counter()
    for key, v in telemetry.snapshot(prefix="holo_spf_delta_total").items():
        labels = dict(x.split("=") for x in key[key.index("{") + 1:-1].split(","))
        out[(labels["kind"], labels["path"])] = int(v)
    return out


def test_overload_strike_chain_matches_jax_and_the_oracle():
    kw = dict(n_routers=14, n_networks=3)
    tt, jt = tsynth.random_ospf_topology(seed=9, **kw), jsynth.random_ospf_topology(seed=9, **kw)
    be = TorchSpfBackend(one_engine="tropical", device="cpu")
    jbe = TpuSpfBackend(N_ATOMS, one_engine="tropical")
    _same(be.compute(tt), jbe.compute(jt), "base")
    strike = next(v for v in range(tt.n_vertices) if tt.is_router[v] and v != tt.root)
    keep = tt.edge_src != strike
    tn, jn = tsynth.clone_topology(tt, keep=keep), jsynth.clone_topology(jt, keep=keep)
    tn.link_delta(tgraph.TopologyDelta(base_key=tt.cache_key,
                                       overload=np.asarray([strike], np.int32),
                                       ids_stable=False))
    jn.link_delta(jgraph.TopologyDelta(base_key=jt.cache_key,
                                       overload=np.asarray([strike], np.int32),
                                       ids_stable=False))
    got = be.compute(tn)
    _same(got, jbe.compute(jn), "struck")
    _same(got, ScalarSpfBackend().compute(tn), "struck oracle")
    assert be.delta_paths[("overload", "incremental")] == 1
    assert be._gather_cache.tile_deltas == {"apply": 1}


def test_multipath_is_refused_naming_a9b_before_the_breaker():
    """Since the multipath program landed, nothing is refused: a
    pinned-tropical compute at multipath_k 2 and 8 equals holo_tpu's
    mp_tropical and counts no breaker event."""
    kw = dict(n_routers=20, n_networks=4, seed=1)
    topo, jtopo = tsynth.random_ospf_topology(**kw), jsynth.random_ospf_topology(**kw)
    be = TorchSpfBackend(one_engine="tropical", device="cpu")
    jbe = TpuSpfBackend(N_ATOMS, one_engine="tropical")
    before = tallies()
    for k in (2, 8):
        got, want = be.compute(topo, multipath_k=k), jbe.compute(jtopo, multipath_k=k)
        _same(got, want, f"k={k}")
        for f in ("parents", "pdist", "pweight", "npaths", "nh_weights"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    snap = be.breaker.snapshot()
    assert not any(snap[k] for k in ("failures", "fallbacks", "refusals")), snap
    assert tallies() == before
    # A what-if at multipath_k > 1 runs mp, as holo_tpu's _pick_engine.
    masks = tsynth.whatif_link_failure_masks(topo, 3, seed=2)
    got = be.compute_whatif(topo, masks, multipath_k=2)
    want = TorchSpfBackend(device="cpu").compute_whatif(topo, masks, multipath_k=2)
    for a, b in zip(got, want):
        _same(a, b, "mp what-if")
        np.testing.assert_array_equal(a.nh_weights, b.nh_weights)
    _same(be.compute(topo, multipath_k=1), ScalarSpfBackend().compute(topo), "k=1")


def test_tuned_winner_routes_the_delta_chain_through_the_tiles():
    """A bucket whose measured compute() winner is tropical runs its
    DeltaPath relax on the tiles (holo_tpu's _trop_incremental)."""
    topo = tsynth.random_ospf_topology(n_routers=16, n_networks=4, seed=5)
    t = pipeline.configure_engine_tuner(explore_rounds=1, reprobe_every=0)
    b = ttuner.shape_bucket(topo.n_vertices, topo.n_edges, 1, None)
    for e in ttuner.ENGINES:
        t.observe("one", b, e, 0.001 if e == "tropical" else 0.1)
    be = TorchSpfBackend(device="cpu")
    assert be._trop_incremental(topo, 1)
    _same(be.compute(topo), ScalarSpfBackend().compute(topo), "base")
    nxt = tsynth.clone_topology(topo, cost={0: 7})
    nxt.link_delta(tgraph.diff_topologies(topo, nxt))
    _same(be.compute(nxt), ScalarSpfBackend().compute(nxt), "delta")
    assert be.delta_paths[("weight", "incremental")] == 1
    assert be._gather_cache.tile_deltas == {"apply": 1}
    pipeline.reset_engine_tuner()
    assert not TorchSpfBackend(device="cpu")._trop_incremental(topo, 1)


def test_lane_engine_names_the_tropical_module():
    g = te.device_graph_from_ell(tgraph.build_ell(tsynth.fat_tree_topology(k=4)), "cpu")
    with pytest.raises(ValueError, match="ops/tropical.py"):
        te.spf_whatif_batch(g, 0, np.ones((1, g.in_src.shape[0]), bool), engine="tropical")
    assert "tropical" not in te.LANE_ENGINES
