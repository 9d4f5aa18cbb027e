"""The kernel wrappers' work tallies (``holo_tpu_torch.kernels.work``), the
port's cost source, on the CPU.

One small seeded workload runs through every wrapper of the port (the gather
engines seq, fused, packed, hybrid and tropical, multipath and tropical
multipath, the blocked engine, and the BGP fold), each call recorded with its
arguments and the tally it added.  Then:

- each call's tally equals an independent count from its tensors' shapes
  (each input byte read once, each output byte written once, the ops per
  element PERF.md section 3 prices the kernel's bound at);
- replayed down the kernel branch (the launch stubbed: no card here), each
  call tallies what it tallied on the plain branch;
- a call's tally does not change with its frontier, nor a dispatch's
  per-call tallies with ``max_iters``;
- tallies are per thread: a dispatch on another thread, or on the dispatch
  pipeline's worker, moves none of the caller's.

Tolerance: exact equality.
"""

from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

from holo_tpu_torch.kernels import bgp, blocked, build, ell, work
from holo_tpu_torch.kernels import tropical as kt
from holo_tpu_torch.pipeline import AsyncSpfBackend, DispatchPipeline
from holo_tpu_torch.spf import synth
from holo_tpu_torch.spf.backend import TorchSpfBackend
from holo_tpu_torch.telemetry import observatory, profiling
from test_torch_cuda import _bgp_planes, _bgp_vectors

# wrapper -> (module, the name its tally is kept under)
WRAPPERS = {
    "ell_relax": (ell, "ell_relax"),
    "ell_first_parent": (ell, "ell_first_parent"),
    "ell_nh_seed": (ell, "ell_nh_seed"),
    "ell_nh_round": (ell, "ell_nh_round"),
    "ell_mp_round": (ell, "ell_mp_round"),
    "ell_parent_sets": (ell, "ell_parent_sets"),
    "ell_parent_weights": (ell, "ell_parent_weights"),
    "ell_fused_round": (ell, "ell_fused_round"),
    "trop_relax": (kt, "trop_relax"),
    "count_list": (kt, "count_list"),
    "trop_count_round": (kt, "trop_count"),
    "relax": (blocked, "relax"),
    "dmin_parent": (blocked, "dmin_parent"),
    "nh_or": (blocked, "nh_or"),
    "bgp_fold": (bgp, "bgp_fold"),
}


def _nb(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def _words(lanes: int) -> int:
    return (lanes + 31) // 32


def _planes(state) -> tuple:
    return (state,) if torch.is_tensor(state) else tuple(state)


def expected(fn: str, a: tuple, kw: dict) -> tuple[int, int]:
    """(ops, bytes) of one call, counted from its tensors' shapes."""
    if fn == "ell_relax":
        src, cost, slot, mask, dist, front = a
        pairs = src.numel() * dist.shape[1]
        return 3 * pairs, _nb(src, cost, slot, mask, dist, front) + _nb(dist, front) + 4
    if fn == "ell_first_parent":
        src, cost, slot, mask, dist, roots = a
        b = dist.shape[1]
        return 6 * src.numel() * b, (_nb(src, cost, slot, mask, dist, roots) + _nb(dist)
                                     + 4 * src.numel() * _words(b))
    if fn == "ell_nh_seed":
        src, dag, hop0, direct, lanes = a
        w = direct.shape[2]
        return (2 * dag.numel() + w * src.numel() * lanes,
                _nb(src, dag, hop0, direct) + _nb(dag) + 4 * src.shape[0] * w * lanes)
    if fn == "ell_nh_round":
        src, inherit, nh, front = a
        w, b = nh.shape[1], nh.shape[2]
        return 2 * w * src.numel() * b + 2 * nh.numel(), _nb(src, inherit, nh, front) + _nb(
            nh, front) + 4
    if fn == "ell_mp_round":
        src, dag, direct, inc, roots, parent, state, front, out = a
        b, w = roots.shape[0], direct.shape[2]
        atoms = 32 * w if state[2] is not None else 0
        ops = (atoms + w + 2) * src.numel() * b + (2 * atoms + w + 4) * src.shape[0] * b
        return ops, _nb(src, dag, direct, inc, roots, parent, *state, front) + _nb(*out, front) + 4
    if fn == "ell_parent_sets":
        src, cost, slot, mask, dist, roots, kp = a
        n, b = src.shape[0], dist.shape[1]
        return (7 + 2 * kp) * src.numel() * b, (
            _nb(src, cost, slot, mask, dist, roots) + _nb(dist)
            + 4 * (src.numel() * _words(b) + 2 * n * kp * b))
    if fn == "ell_parent_weights":
        parents, npaths = a
        return parents.numel(), _nb(parents, npaths) + _nb(parents)
    if fn == "ell_fused_round":
        src, cost, slot, mask, direct, inc, roots, state, front, parent, out = a
        b, w = roots.shape[0], direct.shape[2]
        ops = (6 + w) * src.numel() * b + (6 + w) * src.shape[0] * b
        return ops, (_nb(src, cost, slot, mask, direct, inc, roots, *_planes(state), front)
                     + _nb(*_planes(out), parent, front) + 4)
    if fn == "trop_relax":
        tiles, cb, dist, active, out = a[:5]
        rep = dict(zip(("repair", "src", "cost", "slot", "mask", "perm", "inv"), a[5:]))
        rep.update(kw)
        r = rep.get("repair")
        pairs = 0 if r is None else r.pairs.shape[0] * rep["src"].shape[1]
        ins = [tiles, cb, dist, active]
        if r is not None:
            ins += [r.bits, r.pairs]
        ins += [rep.get(k) for k in ("src", "cost", "slot", "mask", "perm", "inv")]
        return 2 * tiles.numel() * dist.shape[1] + 3 * pairs, _nb(*ins) + _nb(out, active) + 4
    if fn == "count_list":
        cnt, cb = a
        return cnt.numel(), _nb(cnt, cb) + _nb(cb) + 4 * cb.shape[0]
    if fn == "trop_count_round":
        cnt, cb, listed, x, seed, out = a[:6]
        return (2 * cnt.numel() * x.shape[1] + 3 * x.numel(),
                _nb(cnt, cb, *listed, x, seed) + _nb(out) + 4)
    if fn in ("relax", "dmin_parent", "nh_or"):
        w, bsrc, bdst, seg, dist = a[:5]
        edges = kw.get("edges")
        nnz, wb = (w.numel(), _nb(w)) if edges is None else (edges[2].shape[0], _nb(*edges))
        lanes = dist.shape[1]
        if fn == "relax":
            return 2 * nnz * lanes, wb + _nb(bsrc, bdst, seg, dist) + _nb(dist)
        if fn == "dmin_parent":
            return 6 * nnz * lanes, wb + _nb(bsrc, bdst, seg, dist, a[5]) + 2 * _nb(dist)
        gate, nh, direct = a[5:8]
        words = nh.shape[1] // lanes
        return (4 + words) * nnz * lanes, wb + _nb(bsrc, bdst, seg, dist, gate, nh, direct) + _nb(
            nh)
    if fn == "bgp_fold":
        planes, idx, *vecs = a
        cells = idx.shape[0] * planes.shape[2]
        return 7 * cells, (4 * planes.shape[0] * cells + 6 * cells + 4 * idx.shape[0]
                           + _nb(idx, *vecs))
    raise AssertionError(fn)


def _workload() -> None:
    topo = synth.random_ospf_topology(24, 4, 12, max_cost=6, seed=5)
    masks = synth.whatif_link_failure_masks(topo, 40, seed=6)
    for engine in ("seq", "fused", "packed", "hybrid", "tropical"):
        be = TorchSpfBackend(device="cpu", one_engine=engine)
        be.compute(topo)
        be.compute(topo, masks[1])
        be.compute_whatif(topo, masks)
    be = TorchSpfBackend(device="cpu")
    be.compute(topo, multipath_k=4)
    be.compute_whatif(topo, masks[:6], multipath_k=4)
    TorchSpfBackend(device="cpu", one_engine="tropical").compute(topo, multipath_k=4)
    grid = synth.grid_topology(5, 5, seed=3)
    bl = TorchSpfBackend(device="cpu", engine="blocked")
    bl.compute_whatif(grid, synth.whatif_link_failure_masks(grid, 3, seed=2))
    assert bl.routed_to_gather == 0
    rng = np.random.default_rng(9)
    planes = torch.from_numpy(_bgp_planes(rng, 40, 5, 4))
    vecs = [torch.from_numpy(v) for v in _bgp_vectors(rng, 5, 4)]
    bgp.bgp_fold(planes, torch.arange(0, 40, 3, dtype=torch.int32), *vecs)


@pytest.fixture(scope="module")
def calls():
    """name -> [(args, kwargs, (ops, bytes) tallied)] over the workload,
    the observatory armed (so the tallies count, and ``costed`` holds the
    (site, kind, engine) of its cost entries)."""
    rec: dict = {name: [] for name in WRAPPERS}
    mp = pytest.MonkeyPatch()

    def spy(name, mod, key):
        orig = getattr(mod, name)

        def run(*a, **kw):
            before = work.tallies().get(key, (0, 0, 0))
            out = orig(*a, **kw)
            after = work.tallies()[key]
            rec[name].append((a, kw, (after[1] - before[1], after[2] - before[2])))
            return out

        return run

    for name, (mod, key) in WRAPPERS.items():
        mp.setattr(mod, name, spy(name, mod, key))
    obs = observatory.configure(check_every=0)
    try:
        work.reset()
        _workload()
        rec["costed"] = {(site, kind, engine) for site, engine, _b, kind in obs._costs}
    finally:
        mp.undo()
        observatory.configure(enabled=False)
        work.reset()
    return rec


@pytest.mark.parametrize("name", list(WRAPPERS))
def test_tally_equals_the_count_from_the_shapes(calls, name):
    assert calls[name], f"the workload made no {name} call"
    for a, kw, got in calls[name]:
        assert got == expected(name, a, kw)


def test_every_armed_site_is_costed(calls):
    assert calls["costed"] == {
        ("spf.one", "one", e) for e in ("seq", "fused", "packed", "hybrid", "tropical", "mp",
                                        "mp_tropical")} | {
        ("spf.whatif", "whatif", e) for e in ("seq", "fused", "packed", "hybrid", "tropical",
                                              "mp")} | {("spf.blocked", "blocked", "blocked")}


@pytest.mark.parametrize("name", list(WRAPPERS))
def test_tally_is_the_same_down_the_kernel_branch(calls, name, monkeypatch):
    """The tally is taken before the wrapper branches: replayed with the
    tensors taken for the card's (the launch a no-op), a call tallies what
    it did on the plain branch."""
    a, kw, want = calls[name][-1]
    mod, key = WRAPPERS[name]
    monkeypatch.setattr(build, "on_card", lambda *t: True)
    monkeypatch.setattr(build, "launch", lambda *args: None)
    monkeypatch.setattr(bgp, "_sm_count", lambda dev: bgp.H100_SMS)
    with work.counted():
        work.reset()
        getattr(mod, name)(*a, **kw)
        got = work.tallies()[key][1:]
        work.reset()
    assert got == want


FRONTIERS = {"ell_relax": 5, "ell_nh_round": 3, "ell_mp_round": 7, "ell_fused_round": 8,
             "trop_relax": 3}


@pytest.mark.parametrize("name", list(FRONTIERS))
def test_tally_does_not_change_with_the_frontier(calls, name):
    a, kw, want = calls[name][0]
    mod, key = WRAPPERS[name]
    i = FRONTIERS[name]
    for fill in (0, -1):
        args = list(a)
        args[i] = torch.full_like(a[i], fill)
        with work.counted():
            work.reset()
            getattr(mod, name)(*args, **kw)
            got = work.tallies()[key][1:]
            work.reset()
        assert got == want


def _per_call(max_iters) -> dict:
    """{wrapper: the distinct per-call tallies} of one compute and one
    what-if per engine, at ``max_iters``."""
    topo = synth.random_ospf_topology(24, 4, 12, max_cost=6, seed=5)
    masks = synth.whatif_link_failure_masks(topo, 8, seed=6)
    out: dict = {}
    with work.counted():
        for engine in ("seq", "fused", "tropical"):
            be = TorchSpfBackend(device="cpu", one_engine=engine, max_iters=max_iters)
            for call in (lambda: be.compute(topo), lambda: be.compute_whatif(topo, masks)):
                work.reset()
                call()
                for name, (n, ops, nb) in work.tallies().items():
                    out.setdefault(name, set()).add((ops // n, nb // n, ops % n, nb % n))
        work.reset()
    return out


def test_per_call_tallies_do_not_change_with_max_iters():
    capped, full = _per_call(1), _per_call(None)
    assert set(capped) == set(full)
    for name, tallies in capped.items():
        assert tallies <= full[name], name


def _dispatch_tally(topo) -> dict:
    work.reset()
    TorchSpfBackend(device="cpu").compute(topo)
    out = work.tallies()
    work.reset()
    return out


def test_tallies_do_not_mix_across_threads():
    topo = synth.random_ospf_topology(20, 4, 10, seed=11)
    box = {}
    with work.counted():
        solo = _dispatch_tally(topo)
        work.note("marker", 1, 1)  # the caller's own tally, left in place
        t = threading.Thread(target=lambda: box.update(t=_dispatch_tally(topo)))
        t.start()
        t.join()
        mine = work.tallies()
        work.reset()
    assert box["t"] == solo and solo
    assert mine == {"marker": (1, 1, 1)}


def test_tallies_stay_per_thread_under_a_stress():
    """More threads than cores note into their own tallies with a short
    switch interval: each thread's totals are exactly its own notes."""
    import os
    import sys

    n = 4 * (os.cpu_count() or 2)
    got, errors = {}, []

    def run(i):
        try:
            work.reset()
            for j in range(300):
                work.note(f"k{j % 3}", i, j)
            got[i] = work.totals()
            work.reset()
        except BaseException as exc:  # noqa: BLE001 -- reported below
            errors.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30.0)
    finally:
        sys.setswitchinterval(old)
    assert not errors and not any(t.is_alive() for t in threads)
    assert got == {i: (300 * i, sum(range(300))) for i in range(n)}


def test_a_pipelined_dispatch_counts_on_the_worker():
    topo = synth.random_ospf_topology(20, 4, 10, seed=12)
    obs = observatory.configure(check_every=0)
    pipe = DispatchPipeline(depth=2, name="work-tally")
    try:
        work.reset()
        abe = AsyncSpfBackend(TorchSpfBackend(device="cpu"), pipe)
        abe.compute(topo).wait()
        assert work.tallies() == {}  # nothing ran on the caller's thread
        costs = [c for (site, *_), c in obs._costs.items() if site == "spf.one"]
        assert len(costs) == 1 and costs[0]["flops"] > 0
    finally:
        pipe.close()
        observatory.configure(enabled=False)
        profiling.clear_cost_table()
