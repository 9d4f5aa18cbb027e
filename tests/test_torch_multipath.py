"""Multipath in the port against holo_tpu's, bit for bit.

- the round: ``te.mp_fixpoint`` over ``ell_mp_round``'s plain version equals
  JAX's ``_mp_fixpoint`` at ``limit`` 1, 2 and 3, from fresh seeds (first
  frontier: the root) and from stale ones brought across with ``convert``
  (first frontier: every lane);
- the parent sets: ``ell_parent_sets``' plain version (with
  ``ell_parent_weights``) and the reference ``parent_sets_plain`` equal
  JAX's ``_mp_parent_sets`` for kp 2, 4 and 8, with and without a scenario
  mask;
- the programs: ``spf_one_multipath`` and ``spf_multipath_batch`` (8 masks)
  equal JAX's at ``max_iters`` None, 1, 2 and 3, and
  ``spf_one_incremental_multipath`` equals JAX's seeded with the same
  previous run;
- the backend: ``compute`` / ``compute_whatif`` at ``multipath_k`` 2, 3 and
  8 equal ``TpuSpfBackend()`` (JAX-CPU) and both scalar oracles in all
  nine planes, also truncated; ``multipath_k=1`` is the single-path run; a
  delta chain at ``multipath_k=4`` is served ``incremental`` at every step
  with JAX's bits and dispositions; a change of width gives
  ``full-no-prev``; the blocked engine serves ``kp > 1`` through the gather
  program;
- the oracles: the port's ``spf_multipath_reference`` equals holo_tpu's;
- the protocol seam: the convergence storm's multipath arm (max-paths 2)
  gives the scalar run's causal timelines and FIB, with weighted installs.

Topologies: ``tied(seed)`` (36 routers, costs 1-4: real ECMP ties), the
saturating ladder of ``tests/test_multipath.py`` (path counts reach
MP_SAT) and a tied topology with parallel links.  Tolerance: exact
equality everywhere (the computation is integer-only).
"""

import json
from collections import Counter

import jax
import numpy as np
import pytest
import torch

from holo_tpu import telemetry
from holo_tpu.ops import graph as jgraph
from holo_tpu.ops import spf_engine as je
from holo_tpu.spf import scalar as jscalar
from holo_tpu.spf import synth as jsynth
from holo_tpu.spf import synth_storm
from holo_tpu.spf.backend import ScalarSpfBackend as JScalar
from holo_tpu.spf.backend import TpuSpfBackend
from holo_tpu_torch import convert
from holo_tpu_torch.kernels import ell
from holo_tpu_torch.ops import graph as tgraph
from holo_tpu_torch.ops import spf_engine as te
from holo_tpu_torch.spf import scalar as tscalar
from holo_tpu_torch.spf import synth as tsynth
from holo_tpu_torch.spf.backend import ScalarSpfBackend, TorchSpfBackend

N_ATOMS = 64
SP_FIELDS = ("dist", "parent", "hops", "nexthop_words")
MP_FIELDS = ("parents", "pdist", "pweight", "npaths", "nh_weights")
ALL_FIELDS = SP_FIELDS + MP_FIELDS
MP_SAT = int(tgraph.MP_SAT)


def _tied(mod, seed):
    return mod.random_ospf_topology(36, n_networks=7, extra_p2p=50, max_cost=4, seed=seed)


def _ladder(mod):
    # Parallel equal-cost two-hop ladders double the path count per stage:
    # 2^20 paths saturate at MP_SAT = 2^17.
    n = 44
    src, dst = [], []
    for i in range(0, n - 2, 2):
        for a in (i, i + 1):
            for b in (i + 2, i + 3):
                src += [a, b]
                dst += [b, a]
    topo = mod.Topology(n_vertices=n, is_router=np.ones(n, bool), edge_src=np.array(src),
                        edge_dst=np.array(dst), edge_cost=np.ones(len(src), np.int32), root=0)
    return topo


def _parallel(mod, synth):
    # tied(3) with a second edge beside every fifth one, at the same cost
    # or one more (root edges included: each gets its own direct atom).
    base = _tied(jsynth, 3)
    e = np.arange(0, base.n_edges, 5)
    src = np.r_[base.edge_src, base.edge_src[e]]
    dst = np.r_[base.edge_dst, base.edge_dst[e]]
    cost = np.r_[base.edge_cost, base.edge_cost[e] + (e // 5) % 2]
    topo = mod.Topology(n_vertices=base.n_vertices, is_router=base.is_router.copy(),
                        edge_src=src, edge_dst=dst, edge_cost=cost, root=base.root)
    synth.assign_direct_atoms(topo)
    return topo


def _topos(shape):
    """(port topology, holo_tpu topology) of one shape."""
    if shape.startswith("tied"):
        seed = int(shape[4:])
        return _tied(tsynth, seed), _tied(jsynth, seed)
    if shape == "ladder":
        tt, jt = _ladder(tgraph), _ladder(jgraph)
        tsynth.assign_direct_atoms(tt)
        jsynth.assign_direct_atoms(jt)
        return tt, jt
    return _parallel(tgraph, tsynth), _parallel(jgraph, jsynth)


SHAPES = ["tied0", "tied1", "ladder", "parallel"]


def test_shapes_exercise_what_they_are_for():
    tt, _ = _topos("ladder")
    assert int(tscalar.spf_multipath_reference(tt, 2)[1].npaths.max()) == MP_SAT
    tt, _ = _topos("parallel")
    pairs = Counter(zip(tt.edge_src.tolist(), tt.edge_dst.tolist()))
    assert max(pairs.values()) == 2
    res = ScalarSpfBackend().compute(tt, multipath_k=8)
    ecmp = (res.pdist == res.dist[:, None]) & (res.parents < tt.n_vertices)
    assert (ecmp.sum(axis=1) > 1).any()


def _graphs(tt, jt):
    jg = je.device_graph_from_ell(jgraph.build_ell(jt, n_atoms=N_ATOMS))
    tg = convert.device_graph_from_numpy({f: np.asarray(getattr(jg, f))
                                          for f in te.DeviceGraph._fields}, device="cpu")
    return tg, jg


def _assert_planes(got: dict, want: dict, label=""):
    for f, w in want.items():
        a, b = np.asarray(got[f]), np.asarray(w)
        if b.dtype == np.uint32:
            a = a.view(np.uint32)
        assert a.dtype == b.dtype, (label, f, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f"{label} {f}")


def _tensors(sp, mp=None) -> dict:
    """Planes of (SpfTensors, MultipathTensors) of either package as numpy."""
    out = {f: np.asarray(getattr(sp, f)) for f in ("dist", "parent", "hops", "nexthops")}
    if mp is not None:
        out.update({f: np.asarray(getattr(mp, f)) for f in MP_FIELDS})
    return out


# ---------------------------------------------------------------------------
# The round and the parent sets


def _seeds(jg, root, stale: bool, seed: int):
    """JAX's fresh seeds of _mp_fixpoint, or random stale ones."""
    n, _ = jg.in_src.shape
    w = jg.direct_nh_words.shape[2]
    if not stale:
        hops = np.where(np.arange(n) == root, 0, n + 1).astype(np.int32)
        return (hops, np.zeros((n, w), np.uint32), (np.arange(n) == root).astype(np.int32),
                np.zeros((n, 32 * w), np.int32))
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n + 2, n).astype(np.int32),
            rng.integers(0, 1 << 32, (n, w), dtype=np.uint64).astype(np.uint32),
            rng.integers(0, MP_SAT + 1, n).astype(np.int32),
            rng.integers(0, MP_SAT + 1, (n, 32 * w)).astype(np.int32))


@pytest.mark.parametrize("stale", [False, True])
@pytest.mark.parametrize("limit", [1, 2, 3])
@pytest.mark.parametrize("shape", SHAPES)
def test_mp_round_matches_jax_mp_fixpoint(shape, limit, stale):
    tt, jt = _topos(shape)
    tg, jg = _graphs(tt, jt)
    root = jt.root
    dist = je.sssp_distances(jg, root)
    dag = je._sp_dag(jg, dist, jg.in_valid, root)
    parent = je._first_parent(jg, dag, dist[jg.in_src])
    hops0, nh0, np0, aw0 = _seeds(jg, root, stale, limit)
    want = je._mp_fixpoint(jg, root, dag, parent, hops0, nh0.view(np.int32), np0, aw0, limit)
    # The same seeds through convert, as a previous run's planes.
    sp = convert.spf_tensors_from_numpy(
        {"dist": np.asarray(dist), "parent": np.asarray(parent), "hops": hops0,
         "nexthops": nh0}, device="cpu")
    mp = convert.multipath_tensors_from_numpy(
        {"parents": np.zeros((tt.n_vertices, 1)), "pdist": np.zeros((tt.n_vertices, 1)),
         "pweight": np.zeros((tt.n_vertices, 1)), "npaths": np0, "nh_weights": aw0},
        device="cpu")
    bits = ell.pack_lane_bits(torch.from_numpy(np.array(dag))[:, :, None])
    roots = torch.tensor([root], dtype=torch.int32)
    seeds = (sp.hops[:, None], sp.nexthops[:, :, None], mp.npaths[:, None],
             mp.nh_weights[:, :, None])
    # Fresh seeds start from the blank round before them (first frontier:
    # the root), stale ones from an all-ones frontier.
    if stale:
        start = te.mp_resume(seeds)
    else:
        start = te.mp_start(tt.n_vertices, tg.direct_nh_words.shape[2], roots)
        for a, b in zip(start[0], seeds):
            assert torch.equal(a, b)
    (hops, nh, npaths, aw), rounds = te.mp_fixpoint(tg, roots, bits, sp.parent[:, None],
                                                    *start, limit)
    assert 1 <= rounds <= limit
    _assert_planes({"hops": hops[:, 0], "nh": nh[:, :, 0], "npaths": npaths[:, 0],
                    "aw": aw[:, :, 0]},
                   {"hops": want[0], "nh": np.asarray(want[1]), "npaths": want[2],
                    "aw": want[3]}, f"{shape} limit={limit} stale={stale}")
    # Without the count and weight planes: _hops_nh_fixpoint.
    want2 = je._hops_nh_fixpoint(jg, root, dag, parent, hops0, nh0.view(np.int32), limit)
    (hops, nh, npaths, aw), _ = te.mp_fixpoint(
        tg, roots, bits, sp.parent[:, None], *te.mp_resume((*seeds[:2], None, None)), limit)
    assert npaths is None and aw is None
    _assert_planes({"hops": hops[:, 0], "nh": nh[:, :, 0]},
                   {"hops": want2[0], "nh": np.asarray(want2[1])}, "hops_nh")


def test_mp_round_plain_reads_direct_atom_31():
    """A direct atom on bit 31 (the int32 sign bit) counts on atom lane 31
    only, in the plain round as in JAX's one-hot expansion."""
    n, k = 3, 1
    src = torch.tensor([[0], [0], [1]], dtype=torch.int32)
    dag = torch.tensor([[[0]], [[1]], [[1]]], dtype=torch.int32)
    direct = torch.zeros((n, k, 2), dtype=torch.int32)
    direct[1, 0, 0] = -(1 << 31)
    inc = torch.ones(n, dtype=torch.int32)
    roots = torch.tensor([0], dtype=torch.int32)
    parent = torch.tensor([[n], [0], [1]], dtype=torch.int32)
    hops = torch.tensor([[0], [1], [2]], dtype=torch.int32)
    nh = torch.zeros((n, 2, 1), dtype=torch.int32)
    npaths = torch.tensor([[1], [1], [1]], dtype=torch.int32)
    aw = torch.zeros((n, 64, 1), dtype=torch.int32)
    state, out, front = te.mp_resume((hops, nh, npaths, aw))
    ell.ell_mp_round(src, dag, direct, inc, roots, parent, state, front, out)
    assert int(out[1][1, 0, 0]) == -(1 << 31)
    assert out[3][1, :, 0].tolist() == [0] * 31 + [1] + [0] * 32


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("kp", [2, 4, 8])
@pytest.mark.parametrize("shape", SHAPES)
def test_parent_sets_match_jax(shape, kp, masked):
    tt, jt = _topos(shape)
    tg, jg = _graphs(tt, jt)
    root = jt.root
    mask = None
    if masked:
        mask = jsynth.whatif_link_failure_masks(jt, 4, seed=kp)[3]
    dist = je.sssp_distances(jg, root, None if mask is None else mask)
    ok = je._slot_mask(jg, None if mask is None else mask)
    # Path counts drawn at random: pweight must read them at the emitted source.
    npaths = np.random.default_rng(kp).integers(0, MP_SAT + 1, tt.n_vertices).astype(np.int32)
    want = je._mp_parent_sets(jg, root, dist, ok, npaths, kp)
    tmask = None if mask is None else te.pack_edge_masks(mask[None], "cpu")
    p = te.lane_planes(tg, tmask)
    dist_t = torch.from_numpy(np.array(dist))[:, None].contiguous()
    npaths_t = torch.from_numpy(npaths)[:, None]
    roots = torch.tensor([root], dtype=torch.int32)
    names = ("parents", "pdist", "pweight")
    # The fused wrapper (parents, pdist; pweight gathered after the
    # fixpoint) and the reference it is held to on the card.
    _, _, parents, pdist = ell.ell_parent_sets(*p, dist_t, roots, kp)
    fused = (parents, pdist, ell.ell_parent_weights(parents, npaths_t))
    for label, got in (("fused", fused),
                       ("reference", ell.parent_sets_plain(*p, dist_t, npaths_t, roots, kp))):
        _assert_planes({f: g[:, :, 0] for f, g in zip(names, got)}, dict(zip(names, want)),
                       f"{shape} kp={kp} {label}")
        assert got[0].shape == (tt.n_vertices, kp, 1)


# ---------------------------------------------------------------------------
# The programs


@pytest.mark.parametrize("max_iters", [None, 1, 2, 3])
@pytest.mark.parametrize("shape", ["tied0", "ladder", "parallel"])
def test_spf_one_multipath_matches_jax(shape, max_iters):
    tt, jt = _topos(shape)
    tg, jg = _graphs(tt, jt)
    kp = 4
    want = jax.jit(lambda g, r: je.spf_one_multipath(g, r, kp, None, max_iters))(jg, jt.root)
    got = te.spf_one_multipath(tg, tt.root, kp, None, max_iters)
    _assert_planes(_tensors(*got), _tensors(*want), f"{shape} max_iters={max_iters}")
    mask = jsynth.whatif_link_failure_masks(jt, 2, seed=1)[1]
    want = jax.jit(lambda g, r, m: je.spf_one_multipath(g, r, kp, m, max_iters))(
        jg, jt.root, mask)
    got = te.spf_one_multipath(tg, tt.root, kp, mask, max_iters)
    _assert_planes(_tensors(*got), _tensors(*want), f"{shape} masked max_iters={max_iters}")


@pytest.mark.parametrize("max_iters", [None, 1, 2, 3])
@pytest.mark.parametrize("shape", ["tied1", "parallel"])
def test_spf_multipath_batch_matches_jax(shape, max_iters):
    tt, jt = _topos(shape)
    tg, jg = _graphs(tt, jt)
    masks = jsynth.whatif_link_failure_masks(jt, 8, seed=4)
    kp = 2
    want = jax.jit(lambda g, r, m: je.spf_multipath_batch(g, r, m, kp, max_iters))(
        jg, jt.root, masks)
    got = te.spf_multipath_batch(tg, tt.root, masks, kp, max_iters)
    assert got[1].parents.shape == (8, tt.n_vertices, kp)
    _assert_planes(_tensors(*got), _tensors(*want), f"{shape} max_iters={max_iters}")


@pytest.mark.parametrize("max_iters", [None, 2, 3])
@pytest.mark.parametrize("kind", ["weight", "struct"])
def test_spf_one_incremental_multipath_matches_jax(kind, max_iters):
    """Both packages seeded with the same previous run (JAX's, brought
    across with convert), one delta applied to both resident graphs."""
    tt, jt = _topos("tied2")
    tg, jg = _graphs(tt, jt)
    tm = te._EllMirror(tgraph.build_ell(tt, n_atoms=N_ATOMS))
    jm = je._EllMirror(jgraph.build_ell(jt, n_atoms=N_ATOMS))
    n, kp = tt.n_vertices, 4
    jprev, jmp = je.spf_one_multipath(jg, jt.root, kp, None, max_iters)
    prev = convert.spf_tensors_from_numpy({f: np.asarray(getattr(jprev, f))
                                           for f in jprev._fields}, device="cpu")
    pmp = convert.multipath_tensors_from_numpy({f: np.asarray(getattr(jmp, f))
                                                for f in jmp._fields}, device="cpu")
    if kind == "weight":
        spec = {"cost": {e: int(tt.edge_cost[e]) + 3 for e in (2, 30, 57)}}
    else:
        s, d = int(tt.edge_src[40]), int(tt.edge_dst[40])
        spec = {"keep": ~(((tt.edge_src == s) & (tt.edge_dst == d))
                          | ((tt.edge_src == d) & (tt.edge_dst == s)))}
    tn, jn = tsynth.clone_topology(tt, **spec), jsynth.clone_topology(jt, **spec)
    td, jd = tgraph.diff_topologies(tt, tn), jgraph.diff_topologies(jt, jn)
    te.apply_delta_slots(tg, te.lower_delta(tm, td, n))
    jg = je._apply_delta_slots(jg, *je._lower_delta(jm, jd, n))
    seeds = jd.seed_rows()
    padded = np.full(je._pad_pow2(seeds.shape[0]), n, np.int32)
    padded[: seeds.shape[0]] = seeds
    want = jax.jit(lambda g, r, p, a, b, s: je.spf_one_incremental_multipath(
        g, r, p, a, b, s, kp, max_iters))(jg, jt.root, jprev, jmp.npaths, jmp.nh_weights, padded)
    stats = {}
    got = te.spf_one_incremental_multipath(tg, tt.root, prev, pmp.npaths, pmp.nh_weights,
                                           td.seed_rows(), kp, max_iters, stats)
    _assert_planes(_tensors(*got), _tensors(*want), f"{kind} max_iters={max_iters}")
    assert stats["affected_rows"] >= len(seeds) and stats["hops_nh"] >= 1


# ---------------------------------------------------------------------------
# The backend


def _same(a, b, label="", fields=ALL_FIELDS):
    for f in fields:
        x, y = getattr(a, f), getattr(b, f)
        if x is None or y is None:
            assert x is None and y is None, (label, f)
            continue
        assert x.dtype == y.dtype, (label, f, x.dtype, y.dtype)
        np.testing.assert_array_equal(x, y, err_msg=f"{label} {f}")


@pytest.mark.parametrize("k", [2, 3, 8])
@pytest.mark.parametrize("shape", SHAPES)
def test_compute_matches_jax_and_oracles(shape, k):
    tt, jt = _topos(shape)
    got = TorchSpfBackend(device="cpu").compute(tt, multipath_k=k)
    assert got.parents.shape == (tt.n_vertices, te.mp_pad(k))
    _same(got, TpuSpfBackend().compute(jt, multipath_k=k), f"{shape} jax")
    _same(got, JScalar().compute(jt, multipath_k=k), f"{shape} jax oracle")
    _same(got, ScalarSpfBackend().compute(tt, multipath_k=k), f"{shape} port oracle")


@pytest.mark.parametrize("k", [2, 8])
def test_four_word_atom_planes_match_jax_and_oracles(k):
    """n_atoms 100: four next-hop words, 128 weight lanes."""
    tt, jt = _topos("tied1")
    got = TorchSpfBackend(device="cpu", n_atoms=100).compute(tt, multipath_k=k)
    assert got.nexthop_words.shape[1] == 4 and got.nh_weights.shape[1] == 128
    _same(got, TpuSpfBackend(100).compute(jt, multipath_k=k), "jax")
    _same(got, JScalar(100).compute(jt, multipath_k=k), "jax oracle")
    masks = jsynth.whatif_link_failure_masks(jt, 3, seed=k)
    for b, (x, y) in enumerate(zip(
            TorchSpfBackend(device="cpu", n_atoms=100).compute_whatif(tt, masks, multipath_k=k),
            TpuSpfBackend(100).compute_whatif(jt, masks, multipath_k=k))):
        _same(x, y, f"whatif b={b}")


@pytest.mark.parametrize("k", [2, 8])
@pytest.mark.parametrize("shape", ["tied0", "parallel"])
def test_compute_whatif_matches_jax_and_oracles(shape, k):
    tt, jt = _topos(shape)
    masks = jsynth.whatif_link_failure_masks(jt, 9, seed=k)
    got = TorchSpfBackend(device="cpu").compute_whatif(tt, masks, multipath_k=k)
    for name, want in (("jax", TpuSpfBackend().compute_whatif(jt, masks, multipath_k=k)),
                       ("jax oracle", JScalar().compute_whatif(jt, masks, multipath_k=k)),
                       ("port oracle",
                        ScalarSpfBackend().compute_whatif(tt, masks, multipath_k=k))):
        assert len(got) == len(want) == 9
        for b, (x, y) in enumerate(zip(got, want)):
            _same(x, y, f"{shape} {name} b={b}")


@pytest.mark.parametrize("max_iters", [1, 2, 3])
def test_truncated_backend_matches_jax(max_iters):
    tt, jt = _topos("tied1")
    masks = jsynth.whatif_link_failure_masks(jt, 5, seed=2)
    be, jbe = TorchSpfBackend(device="cpu", max_iters=max_iters), TpuSpfBackend(max_iters=max_iters)
    _same(be.compute(tt, multipath_k=4), jbe.compute(jt, multipath_k=4), "compute")
    for b, (x, y) in enumerate(zip(be.compute_whatif(tt, masks, multipath_k=4),
                                   jbe.compute_whatif(jt, masks, multipath_k=4))):
        _same(x, y, f"whatif b={b}")


def test_k1_is_the_single_path_run():
    tt, jt = _topos("tied0")
    be = TorchSpfBackend(device="cpu")
    plain, k1 = be.compute(tt), be.compute(tt, multipath_k=1)
    _same(plain, k1, "k=1")
    _same(k1, TpuSpfBackend().compute(jt, multipath_k=1), "jax k=1")
    for f in MP_FIELDS:
        assert getattr(k1, f) is None
    masks = jsynth.whatif_link_failure_masks(jt, 3, seed=1)
    for x, y in zip(be.compute_whatif(tt, masks, multipath_k=1), be.compute_whatif(tt, masks)):
        _same(x, y, "whatif k=1")
        assert x.parents is None


def test_mp_pad_matches_jax():
    for k in range(-1, 12):
        assert te.mp_pad(k) == je.mp_pad(k)


def _jax_paths() -> Counter:
    out = Counter()
    for key, v in telemetry.snapshot(prefix="holo_spf_delta_total").items():
        labels = dict(x.split("=") for x in key[key.index("{") + 1:-1].split(","))
        out[(labels["kind"], labels["path"])] = int(v)
    return out


def _step(tt, jt, spec):
    tn, jn = tsynth.clone_topology(tt, **spec), jsynth.clone_topology(jt, **spec)
    tn.link_delta(tgraph.diff_topologies(tt, tn))
    jn.link_delta(jgraph.diff_topologies(jt, jn))
    return tn, jn


def _chain_specs(tt):
    s, d = int(tt.edge_src[17]), int(tt.edge_dst[17])
    flap = ~(((tt.edge_src == s) & (tt.edge_dst == d)) | ((tt.edge_src == d) & (tt.edge_dst == s)))
    return [{"cost": {3: int(tt.edge_cost[3]) + 2}}, {"cost": {9: 1, 21: 4}}, {"keep": flap},
            {"cost": {0: int(tt.edge_cost[0]) + 1}}, {"cost": {12: 3}}]


@pytest.mark.parametrize("max_iters", [None, 2, 3])
@pytest.mark.parametrize("shape", ["tied2", "parallel"])
def test_delta_chain_is_incremental_and_matches_jax(shape, max_iters):
    """A 5-step chain at multipath_k=4: every step served incremental, with
    JAX's bits and dispositions, and (untruncated) the oracle's."""
    tt, jt = _topos(shape)
    be = TorchSpfBackend(device="cpu", max_iters=max_iters)
    jbe = TpuSpfBackend(N_ATOMS, max_iters=max_iters)
    _same(be.compute(tt, multipath_k=4), jbe.compute(jt, multipath_k=4), "first run")
    for i, spec in enumerate(_chain_specs(tt)):
        before_port, before_jax = Counter(be.delta_paths), _jax_paths()
        tt, jt = _step(tt, jt, spec)
        got = be.compute(tt, multipath_k=4)
        _same(got, jbe.compute(jt, multipath_k=4), f"step {i} jax")
        if max_iters is None:
            _same(got, JScalar(N_ATOMS).compute(jt, multipath_k=4), f"step {i} oracle")
        port = Counter(be.delta_paths) - before_port
        assert port == _jax_paths() - before_jax, i
        assert port[(tgraph.delta_kind(tt.delta_base), "incremental")] == 1, port


def test_width_change_mid_chain_gives_full_no_prev():
    tt, jt = _topos("tied1")
    be, jbe = TorchSpfBackend(device="cpu"), TpuSpfBackend(N_ATOMS)
    be.compute(tt, multipath_k=2)
    jbe.compute(jt, multipath_k=2)
    tn, jn = _step(tt, jt, {"cost": {0: int(tt.edge_cost[0]) + 2}})
    before_port, before_jax = Counter(be.delta_paths), _jax_paths()
    got = be.compute(tn, multipath_k=8)
    _same(got, jbe.compute(jn, multipath_k=8), "width change jax")
    port = Counter(be.delta_paths) - before_port
    assert port == _jax_paths() - before_jax
    assert port[("weight", "full-no-prev")] == 1 and port[("weight", "incremental")] == 0
    _same(got, JScalar(N_ATOMS).compute(jn, multipath_k=8), "width change")
    # The kp=8 run is kept: the next step of the chain rides it.
    t2, j2 = _step(tn, jn, {"cost": {1: int(tn.edge_cost[1]) + 1}})
    _same(be.compute(t2, multipath_k=8), JScalar(N_ATOMS).compute(j2, multipath_k=8), "next")
    assert be.delta_paths[("weight", "incremental")] == 1


def test_blocked_engine_serves_multipath_through_gather():
    tt, _ = _topos("tied0")
    masks = tsynth.whatif_link_failure_masks(tt, 4, seed=5)
    blocked = TorchSpfBackend(engine="blocked", device="cpu", incremental=False)
    gather = TorchSpfBackend(device="cpu", incremental=False)
    _same(blocked.compute(tt, multipath_k=4), gather.compute(tt, multipath_k=4), "compute")
    for x, y in zip(blocked.compute_whatif(tt, masks, multipath_k=2),
                    gather.compute_whatif(tt, masks, multipath_k=2)):
        _same(x, y, "whatif")
    assert blocked.routed_to_gather == 0
    assert blocked.prepare_blocked(tt) is not None  # within the blocked preconditions


@pytest.mark.parametrize("kp", [1, 2, 4, 8])
@pytest.mark.parametrize("shape", SHAPES)
def test_port_oracle_matches_holo_tpu_oracle(shape, kp):
    tt, jt = _topos(shape)
    masks = [None, jsynth.whatif_link_failure_masks(jt, 2, seed=kp)[1]]
    for mask in masks:
        for lanes in (None, 64):
            tb, tm = tscalar.spf_multipath_reference(tt, kp, mask, lanes)
            jb, jm = jscalar.spf_multipath_reference(jt, kp, mask, lanes)
            for f in ("dist", "parent", "hops"):
                np.testing.assert_array_equal(getattr(tb, f), getattr(jb, f))
            assert tb.nexthops == jb.nexthops
            for f in MP_FIELDS:
                a, b = getattr(tm, f), getattr(jm, f)
                assert a.dtype == b.dtype, f
                np.testing.assert_array_equal(a, b, err_msg=f)


# ---------------------------------------------------------------------------
# The protocol seam


def _causal_digest(timelines):
    out = []
    for rec in timelines:
        rec = {k: v for k, v in rec.items() if k != "dispatch"}
        rec["timeline"] = [e for e in rec["timeline"] if e[0] != "dispatch"]
        out.append(rec)
    return json.dumps(out, sort_keys=True)


def test_storm_multipath_arm_matches_scalar(monkeypatch):
    seen = []
    digest = synth_storm.storm_digest

    def recording_digest(timelines):
        seen.append(timelines)
        return digest(timelines)

    monkeypatch.setattr(synth_storm, "storm_digest", recording_digest)
    kw = dict(n_routers=60, events=24, seed=17, max_paths=2)
    r_s, _, net_s = synth_storm.run_convergence_storm(spf_backend=JScalar(), **kw)
    r_t, _, net_t = synth_storm.run_convergence_storm(
        spf_backend=TorchSpfBackend(device="cpu"), **kw)
    assert r_t["spf-runs"] == r_s["spf-runs"] > 0
    assert r_t["fib-multipath"] > 0 and r_t["fib-weighted"] > 0
    assert (r_t["fib-multipath"], r_t["fib-weighted"]) == (r_s["fib-multipath"],
                                                           r_s["fib-weighted"])
    assert dict(net_t.kernel.fib) == dict(net_s.kernel.fib) and len(net_s.kernel.fib) > 0
    scalar_tl, port_tl = seen
    assert _causal_digest(port_tl) == _causal_digest(scalar_tl)
