"""The tropical engine's multipath program (holo_tpu_torch.ops.tropical) against
holo_tpu.ops.tropical on JAX-CPU, bit for bit (tolerance: exact int32 on every
plane; the computation is integer-only).

- ``count_tiles`` equals JAX's ``_count_tiles`` at B = 8, 16 and 32, with
  padding slots and parallel edges (a pair joined by two flagged slots
  counts 2);
- one plain T2 round (``trop_count_round`` on CPU tensors) equals one body
  step of JAX's ``_np_tile_fixpoint`` and ``_aw_tile_fixpoint`` (each run
  with a limit of 1) from carries at and near ``MP_SAT``, in the new values
  and the changed flag; ``direct_atom_seed`` equals JAX's one-hot sum;
- ``tropical_spf_one_multipath`` equals JAX's on all nine planes at ``kp``
  2, 4 and 8, unmasked and masked (JAX's repair rows and the set built on
  the device), at ``max_iters`` None, 0, 1, 2 and 3 (three separately capped
  loops after the relax, so truncated bits are held to JAX's same engine);
  ``tropical_spf_one_incremental_multipath`` equals JAX's likewise;
- ``TorchSpfBackend(one_engine="tropical").compute(topo, multipath_k=k)``
  equals ``TpuSpfBackend(one_engine="tropical")`` and the scalar oracle (k 2
  and 8, seeds 0-2) with no breaker event, and an 8-step DeltaPath chain at
  ``multipath_k=4`` equals JAX's pinned-tropical backend step by step at
  ``max_iters`` None and 2, with JAX's dispositions and tile deltas.

JAX's jitted programs are built once per module.
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
from holo_tpu_torch.kernels import tropical as kt
from holo_tpu_torch.ops import graph as tgraph
from holo_tpu_torch.ops import spf_engine as te
from holo_tpu_torch.ops import tropical as trop
from holo_tpu_torch.resilience import tallies
from holo_tpu_torch.spf import synth as tsynth
from holo_tpu_torch.spf.backend import ScalarSpfBackend, TorchSpfBackend

N_ATOMS = 64
MP_SAT = int(tgraph.MP_SAT)
LIMITS = (None, 0, 1, 2, 3)
SP_FIELDS = ("dist", "parent", "hops", "nexthop_words")
MP_FIELDS = ("parents", "pdist", "pweight", "npaths", "nh_weights")


def _tied(mod, seed=1):
    return mod.random_ospf_topology(n_routers=30, n_networks=6, extra_p2p=40, max_cost=3,
                                    seed=seed)


def _parallel(mod, synth):
    """The tied topology with a second edge beside every fourth one, at the
    same cost or one more: parallel slots, some both in the DAG."""
    base = _tied(jsynth, 2)
    e = np.arange(0, base.n_edges, 4)
    topo = mod.Topology(n_vertices=base.n_vertices, is_router=base.is_router.copy(),
                        edge_src=np.r_[base.edge_src, base.edge_src[e]],
                        edge_dst=np.r_[base.edge_dst, base.edge_dst[e]],
                        edge_cost=np.r_[base.edge_cost, base.edge_cost[e] + (e // 4) % 2],
                        root=base.root)
    synth.assign_direct_atoms(topo)
    return topo


def _ladder(mod, synth):
    """Equal-cost two-hop ladders double the path count a stage: 2^20 paths
    saturate at MP_SAT = 2^17."""
    n = 44
    src, dst = [], []
    for i in range(0, n - 2, 2):
        for a in (i, i + 1):
            for b in (i + 2, i + 3):
                src += [a, b]
                dst += [b, a]
    topo = mod.Topology(n_vertices=n, is_router=np.ones(n, bool), edge_src=np.array(src),
                        edge_dst=np.array(dst), edge_cost=np.ones(len(src), np.int32), root=0)
    synth.assign_direct_atoms(topo)
    return topo


SHAPES = {
    "tied": lambda: (_tied(tsynth), _tied(jsynth)),
    "parallel": lambda: (_parallel(tgraph, tsynth), _parallel(jgraph, jsynth)),
    "ladder": lambda: (_ladder(tgraph, tsynth), _ladder(jgraph, jsynth)),
    "fat8": lambda: (tsynth.fat_tree_topology(k=8), jsynth.fat_tree_topology(k=8)),
}


class Case:
    """One topology in both packages at one tile size: the graphs, JAX's
    tiles (host and device), the port's copy of them, a mask failing edges
    and JAX's repair rows for it."""

    def __init__(self, shape: str, block=None):
        self.tt, self.jt = SHAPES[shape]()
        self.n = self.tt.n_vertices
        jell = jgraph.build_ell(self.jt, n_atoms=N_ATOMS)
        self.jg = je.device_graph_from_ell(jell)
        self.tg = te.device_graph_from_ell(tgraph.build_ell(self.tt, n_atoms=N_ATOMS), "cpu")
        self.host, _ = jtrop.build_tiles_host(jell.in_src, jell.in_cost, jell.in_valid, block)
        self.jtiles = jax.device_put(self.host)
        self.tiles = trop.tiles_on(self.host, "cpu")
        self.mask = jsynth.whatif_link_failure_masks(self.jt, 3, seed=6)[1]
        self.rows = jtrop.repair_rows_host(self.jt.edge_dst, self.mask[None], self.n)[0]


_CASES: dict = {}


def _case(shape: str, block=None) -> Case:
    if (shape, block) not in _CASES:
        _CASES[(shape, block)] = Case(shape, block)
    return _CASES[(shape, block)]


@pytest.fixture(autouse=True)
def _reset_tuner():
    yield
    pipeline.reset_engine_tuner()


def _same_planes(sp, mp, jsp, jmp, label):
    for f in ("dist", "parent", "hops"):
        np.testing.assert_array_equal(getattr(sp, f).numpy(), np.asarray(getattr(jsp, f)),
                                      err_msg=f"{label} {f}")
    np.testing.assert_array_equal(sp.nexthops.numpy().view(np.uint32), np.asarray(jsp.nexthops),
                                  err_msg=f"{label} nexthops")
    for f in MP_FIELDS:
        got, want = getattr(mp, f).numpy(), np.asarray(getattr(jmp, f))
        assert got.shape == want.shape, (label, f, got.shape, want.shape)
        np.testing.assert_array_equal(got, want, err_msg=f"{label} {f}")


def _same_result(a, b, label, fields=SP_FIELDS + MP_FIELDS):
    for f in fields:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, (label, f, x.dtype, y.dtype)
        np.testing.assert_array_equal(x, y, err_msg=f"{label} {f}")


def _flags(case, seed: int) -> np.ndarray:
    """A seeded boolean slot plane over the valid slots (about half)."""
    valid = np.asarray(case.jg.in_valid)
    return valid & (np.random.default_rng(seed).random(valid.shape) < 0.5)


# ---------------------------------------------------------------------------
# Count tiles and one round


@pytest.mark.parametrize("block", [8, 16, 32])
@pytest.mark.parametrize("shape", ["tied", "parallel", "fat8"])
def test_count_tiles_match_jax(shape, block):
    case = _case(shape, block)
    nb, tm = case.host.cb.shape
    assert (case.host.cb == nb).any() == (block < 32 or shape == "fat8")  # padding slots
    for seed, flag in ((0, _flags(case, 0)), (1, np.asarray(case.jg.in_valid))):
        want = np.asarray(jtrop._count_tiles(case.jg, case.jtiles, flag))
        got = trop.count_tiles(case.tg.in_src, case.tiles, torch.from_numpy(flag.copy()))
        assert got.dtype == torch.int32 and got.shape == (nb, tm, block, block)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"flag {seed}")
        assert int(got.sum()) == int(flag.sum())
    if shape == "parallel":  # two flagged slots of one pair count 2
        assert int(got.max()) == 2


def _jax_dag(case):
    """JAX's settled DAG (bool [N, K]) and raw phase-2 hops of the unmasked
    root run."""
    jd = jtrop._tile_relax(case.jg, case.jtiles,
                           jax.numpy.full((case.n, 1), int(tgraph.INF), jax.numpy.int32)
                           .at[case.jt.root, 0].set(0), None, None, case.n)[:, 0]
    _, dag, hops = jtrop._phase2(case.jg, case.jt.root, jd, case.jg.in_valid, case.n)
    return np.array(dag), np.array(hops)


@pytest.mark.parametrize("shape", ["tied", "parallel", "ladder"])
def test_plain_round_is_one_jax_body_step(shape):
    """One T2 round from carries drawn up to MP_SAT (a quarter of them at
    MP_SAT - 1, so sums saturate) against JAX's loop run with a limit of 1,
    in both modes; the changed flag too, and a fixpoint maps to itself."""
    case = _case(shape)
    tt, n = case.tiles, case.n
    dag, hops = _jax_dag(case)
    rng = np.random.default_rng(5)
    np0 = np.where(rng.random(n) < 0.25, MP_SAT - 1, rng.integers(0, MP_SAT, n)).astype(np.int32)
    a = 32 * case.tg.direct_nh_words.shape[2]
    aw0 = np.where(rng.random((n, a)) < 0.25, MP_SAT - 1,
                   rng.integers(0, MP_SAT, (n, a))).astype(np.int32)
    npaths = np.where(rng.random(n) < 0.25, MP_SAT - 1, rng.integers(0, 50, n)).astype(np.int32)
    flag = torch.from_numpy(dag.copy())
    # The path counts: 1 at the root, min(sum, MP_SAT) elsewhere.
    want = np.asarray(jtrop._np_tile_fixpoint(case.jg, case.jtiles, dag, case.jt.root, np0, 1))
    cnt = trop.count_tiles(case.tg.in_src, tt, flag)
    x = trop._to_tiles(torch.from_numpy(np0)[:, None], tt)
    out = torch.full_like(x, -5)  # written whole
    root_row = int(tt.inv[case.tt.root])
    new, changed = kt.trop_count_round(cnt, tt.cb, kt.count_list(cnt, tt.cb), x, None, out,
                                       root_row)
    assert new is out
    np.testing.assert_array_equal(new[tt.inv.long(), 0].numpy(), want)
    assert bool(changed) == bool((want != np0).any()) and bool(changed)
    assert (want == MP_SAT).any()  # the clamp is exercised
    assert not new[n:].any()  # padding rows stay 0
    # The weights: the direct-atom seed plus the inherit slots' sum.
    want = np.asarray(jtrop._aw_tile_fixpoint(case.jg, case.jtiles, dag, hops, npaths, aw0, 1))
    hop0 = torch.from_numpy(hops)[case.tg.in_src.long()] == 0
    seed = trop.direct_atom_seed(case.tg, flag & hop0, torch.from_numpy(npaths))
    onehot = np.asarray(je._slot_atom_onehot(case.jg))
    direct = dag & (hops[np.asarray(case.jg.in_src)] == 0)
    np.testing.assert_array_equal(
        seed.numpy(), (onehot * np.where(direct, npaths[np.asarray(case.jg.in_src)],
                                         0)[:, :, None]).sum(1))
    cnt = trop.count_tiles(case.tg.in_src, tt, flag & ~hop0)
    x = trop._to_tiles(torch.from_numpy(aw0), tt)
    new, changed = kt.trop_count_round(cnt, tt.cb, kt.count_list(cnt, tt.cb), x,
                                       trop._to_tiles(seed, tt), torch.empty_like(x), -1)
    np.testing.assert_array_equal(new[tt.inv.long()].numpy(), want)
    assert bool(changed) == bool((want != aw0).any())
    # A fixpoint maps to itself with the flag clear.
    fixed = trop._count_fixpoint(tt, cnt, torch.from_numpy(aw0), seed, -1, n)
    x = trop._to_tiles(fixed, tt)
    again, changed = kt.trop_count_round(cnt, tt.cb, kt.count_list(cnt, tt.cb), x,
                                         trop._to_tiles(seed, tt), torch.empty_like(x), -1)
    assert torch.equal(again, x) and not bool(changed)


def test_count_round_is_plain_on_the_cpu_only():
    """On CPU tensors the wrapper runs the plain version and counts no
    launch; a tensor off the CPU (meta here) takes the card's branch, whose
    device check raises (the kernel's shape checks: tests/test_torch_cuda.py)."""
    case = _case("tied")
    tt = case.tiles
    x = torch.zeros((tt.perm.shape[0], 1), dtype=torch.int32)
    cnt = trop.count_tiles(case.tg.in_src, tt, case.tg.in_valid)
    before = dict(kt.launches)
    kt.trop_count_round(cnt, tt.cb, kt.count_list(cnt, tt.cb), x, None, torch.empty_like(x))
    assert kt.launches == before  # the plain version counts no launch
    meta = [t.to("meta") for t in (cnt, tt.cb, x)]
    listed = kt.CountList(*(t.to("meta") for t in kt.count_list(cnt, tt.cb)))
    with pytest.raises(ValueError, match="one CUDA device"):
        kt.trop_count_round(*meta[:2], listed, meta[2], None, meta[2])


# ---------------------------------------------------------------------------
# The programs against JAX's, on JAX's tiles


_J_MP = jax.jit(jtrop.tropical_spf_one_multipath, static_argnums=(3,))
_J_ONE = jax.jit(jtrop.tropical_spf_one)
_J_INCR_MP = jax.jit(jtrop.tropical_spf_one_incremental_multipath, static_argnums=(7,))


@pytest.mark.parametrize("max_iters", LIMITS)
@pytest.mark.parametrize("kp", [2, 4, 8])
@pytest.mark.parametrize("shape", ["tied", "ladder"])
def test_tropical_multipath_matches_jax(shape, kp, max_iters):
    case = _case(shape)
    root = case.tt.root
    jsp, jmp = _J_MP(case.jg, case.jtiles, root, kp, None, None, max_iters)
    sp, mp = trop.tropical_spf_one_multipath(case.tg, case.tiles, root, kp, None, None, max_iters)
    _same_planes(sp, mp, jsp, jmp, "unmasked")
    jsp, jmp = _J_MP(case.jg, case.jtiles, root, kp, case.mask, case.rows, max_iters)
    for label, rows in (("jax rows", case.rows), ("device set", None)):
        sp, mp = trop.tropical_spf_one_multipath(case.tg, case.tiles, root, kp, case.mask, rows,
                                                 max_iters)
        _same_planes(sp, mp, jsp, jmp, f"masked, {label}")
    if max_iters is None:
        ref = JScalar(N_ATOMS).compute(case.jt, case.mask, multipath_k=kp)
        for f in MP_FIELDS:
            np.testing.assert_array_equal(getattr(mp, f).numpy(), getattr(ref, f), err_msg=f)
        assert (ref.npaths > 1).any()


@pytest.mark.parametrize("max_iters", LIMITS)
def test_tropical_incremental_multipath_matches_jax(max_iters):
    """A link removal and a cost change after a converged multipath run:
    JAX's incremental program on JAX's tiles of the new graph, the port's on
    its copy of them, seeded with the same previous planes."""
    case = _case("tied")
    tt, jt = case.tt, case.jt
    e = int(np.nonzero((tt.edge_src != tt.root) & (tt.edge_dst != tt.root))[0][3])
    s, d = int(tt.edge_src[e]), int(tt.edge_dst[e])
    spec = {"keep": ~((tt.edge_src == s) & (tt.edge_dst == d)),
            "cost": {0: int(tt.edge_cost[0]) + 5}}
    tn, jn = tsynth.clone_topology(tt, **spec), jsynth.clone_topology(jt, **spec)
    seeds = jgraph.diff_topologies(jt, jn).seed_rows().astype(np.int32)
    jprev, jprev_mp = _J_MP(case.jg, case.jtiles, jt.root, 4, None, None, None)
    prev, prev_mp = trop.tropical_spf_one_multipath(case.tg, case.tiles, tt.root, 4)
    jell = jgraph.build_ell(jn, n_atoms=N_ATOMS)
    host, _ = jtrop.build_tiles_host(jell.in_src, jell.in_cost, jell.in_valid)
    tg2 = te.device_graph_from_ell(tgraph.build_ell(tn, n_atoms=N_ATOMS), "cpu")
    jsp, jmp = _J_INCR_MP(je.device_graph_from_ell(jell), jax.device_put(host), jt.root, jprev,
                          jprev_mp.npaths, jprev_mp.nh_weights, seeds, 4, max_iters)
    stats = {}
    sp, mp = trop.tropical_spf_one_incremental_multipath(
        tg2, trop.tiles_on(host, "cpu"), tt.root, prev, prev_mp.npaths, prev_mp.nh_weights,
        seeds, 4, max_iters, stats)
    _same_planes(sp, mp, jsp, jmp, "incremental")
    assert {"affected", "relax", "hops_nh", "affected_rows"} <= set(stats)
    if max_iters is None:
        ref = ScalarSpfBackend().compute(tn, multipath_k=4)
        for f in MP_FIELDS:
            np.testing.assert_array_equal(getattr(mp, f).numpy(), getattr(ref, f), err_msg=f)


# ---------------------------------------------------------------------------
# The backend


def _jax_counts(prefix: str, key: str) -> Counter:
    out = Counter()
    for k, v in telemetry.snapshot(prefix=prefix).items():
        labels = dict(x.split("=") for x in k[k.index("{") + 1:-1].split(","))
        out[labels[key] if key != "kind-path" else (labels["kind"], labels["path"])] = int(v)
    return out


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("k", [2, 8])
def test_backend_multipath_matches_jax_and_the_oracle(k, seed):
    """tests/test_tropical.py's test_multipath_parity on the port: no
    ValueError, all nine planes equal to JAX's mp_tropical and the oracle,
    no breaker event."""
    kw = dict(n_routers=20, n_networks=5, extra_p2p=30, max_cost=3, seed=seed)
    tt, jt = tsynth.random_ospf_topology(**kw), jsynth.random_ospf_topology(**kw)
    before = tallies()
    be = TorchSpfBackend(one_engine="tropical", device="cpu")
    got = be.compute(tt, multipath_k=k)
    _same_result(got, TpuSpfBackend(N_ATOMS, one_engine="tropical").compute(jt, multipath_k=k),
                 f"k={k} jax")
    _same_result(got, ScalarSpfBackend().compute(tt, multipath_k=k), f"k={k} oracle")
    snap = be.breaker.snapshot()
    assert not any(snap[x] for x in ("failures", "fallbacks", "refusals")), snap
    assert tallies() == before
    assert be._pick_engine("one", tt, kp=te.mp_pad(k)) == ("mp_tropical", None)
    assert be._pick_engine("whatif", tt, 3, kp=te.mp_pad(k)) == ("mp", None)


@pytest.mark.parametrize("max_iters", [None, 2])
def test_backend_delta_chain_at_kp4_matches_jax(max_iters):
    """tests/test_tropical.py's 8-step chain (weight changes, a dropped and
    an added edge) at multipath_k=4 on the pinned-tropical backends: every
    step's nine planes equal JAX's, with JAX's DeltaPath dispositions and
    tile deltas; at convergence the oracle's too."""
    kw = dict(n_routers=18, n_networks=4, extra_p2p=10, max_cost=5, seed=7)
    tt, jt = tsynth.random_ospf_topology(**kw), jsynth.random_ospf_topology(**kw)
    be = TorchSpfBackend(one_engine="tropical", device="cpu", max_iters=max_iters)
    jbe = TpuSpfBackend(N_ATOMS, one_engine="tropical", max_iters=max_iters)
    _same_result(be.compute(tt, multipath_k=4), jbe.compute(jt, multipath_k=4), "base")
    paths = _jax_counts("holo_spf_delta_total", "kind-path")
    tiles = _jax_counts("holo_spf_tropical_delta_total", "path")
    for step in range(8):
        op = step % 3
        if op == 0:
            spec = {"cost": {(step * 3) % tt.n_edges: 1 + step}}
        elif op == 1:
            keep = np.ones(tt.n_edges, bool)
            keep[(step * 5) % tt.n_edges] = False
            spec = {"keep": keep}
        else:
            spec = {"extra": [[step % tt.n_vertices, (step + 3) % tt.n_vertices, 2, -1]]}
        tn, jn = tsynth.clone_topology(tt, **spec), jsynth.clone_topology(jt, **spec)
        td, jd = tgraph.diff_topologies(tt, tn), jgraph.diff_topologies(jt, jn)
        assert td is not None and jd is not None
        tn.link_delta(td)
        jn.link_delta(jd)
        tt, jt = tn, jn
        got = be.compute(tt, multipath_k=4)
        _same_result(got, jbe.compute(jt, multipath_k=4), f"step {step}")
        if max_iters is None:
            _same_result(got, ScalarSpfBackend().compute(tt, multipath_k=4),
                         f"step {step} oracle")
    assert Counter(be.delta_paths) == _jax_counts("holo_spf_delta_total", "kind-path") - paths
    assert be._gather_cache.tile_deltas == (
        _jax_counts("holo_spf_tropical_delta_total", "path") - tiles)
    assert sum(v for (_, path), v in be.delta_paths.items() if path == "incremental") >= 4
    assert not any(be.breaker.snapshot()[x] for x in ("failures", "fallbacks", "refusals"))
