"""TorchSpfBackend's default gather engine against holo_tpu's default
TpuSpfBackend() (JAX-CPU) and both scalar oracles, on every plane (exact
equality); the blocked engine's route to the gather engine; its refusals;
and the protocol seam: a seeded convergence storm on the port's backend
gives the scalar run's causal timelines and FIB."""

import json

import numpy as np
import pytest
import torch

from holo_tpu.ops import graph as jgraph
from holo_tpu.spf import synth as jsynth
from holo_tpu.spf import synth_storm
from holo_tpu.spf.backend import ScalarSpfBackend as JScalar
from holo_tpu.spf.backend import TpuSpfBackend
from holo_tpu_torch.kernels import blocked as bkernels
from holo_tpu_torch.kernels import ell
from holo_tpu_torch.ops import graph as tgraph
from holo_tpu_torch.spf import synth as tsynth
from holo_tpu_torch.spf.backend import ScalarSpfBackend, TorchSpfBackend

FIELDS = ("dist", "parent", "hops", "nexthop_words")
MR_FIELDS = ("dist", "parent", "hops")


def _same(a, b, label="", fields=FIELDS):
    for f in fields:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, (label, f)
        np.testing.assert_array_equal(x, y, err_msg=f"{label} {f}")


def _topos(**kw):
    return tsynth.random_ospf_topology(**kw), jsynth.random_ospf_topology(**kw)


@pytest.mark.parametrize("seed", [4, 8])
def test_compute_matches_jax_and_scalars(seed):
    tt, jt = _topos(n_routers=150, n_networks=30, seed=seed)
    got = TorchSpfBackend(device="cpu").compute(tt)
    _same(got, TpuSpfBackend().compute(jt), "jax")
    _same(got, JScalar().compute(jt), "jax scalar")
    _same(got, ScalarSpfBackend().compute(tt), "port scalar")


@pytest.mark.parametrize("lanes", [1, 8, 33])
def test_compute_whatif_matches_jax_and_scalars(lanes):
    tt, jt = _topos(n_routers=150, n_networks=30, extra_p2p=200, max_cost=4, seed=lanes)
    masks = jsynth.whatif_link_failure_masks(jt, lanes, seed=lanes + 1)
    got = TorchSpfBackend(device="cpu").compute_whatif(tt, masks)
    jax_res = TpuSpfBackend().compute_whatif(jt, masks)
    scalar = JScalar().compute_whatif(jt, masks)
    port_scalar = ScalarSpfBackend().compute_whatif(tt, masks)
    assert len(got) == lanes
    for b in range(lanes):
        _same(got[b], jax_res[b], f"jax b={b}")
        _same(got[b], scalar[b], f"jax scalar b={b}")
        _same(got[b], port_scalar[b], f"port scalar b={b}")


def test_compute_masked_matches_scalar():
    tt, jt = _topos(n_routers=120, n_networks=20, seed=3)
    mask = jsynth.whatif_link_failure_masks(jt, 3, seed=5)[2]
    be = TorchSpfBackend(device="cpu")
    _same(be.compute(tt, mask), JScalar().compute(jt, mask))
    _same(be.compute(tt, mask), TpuSpfBackend().compute(jt, mask))


@pytest.mark.parametrize("n_roots", [1, 8, 33])
def test_compute_multiroot_matches_jax_and_scalars(n_roots):
    tt, jt = _topos(n_routers=150, n_networks=30, extra_p2p=200, seed=n_roots)
    roots = np.random.default_rng(n_roots).integers(0, tt.n_vertices, n_roots)
    got = TorchSpfBackend(device="cpu").compute_multiroot(tt, roots)
    assert got.dist.shape == (n_roots, tt.n_vertices)
    _same(got, TpuSpfBackend().compute_multiroot(jt, roots), "jax", MR_FIELDS)
    _same(got, JScalar().compute_multiroot(jt, roots), "jax scalar", MR_FIELDS)
    _same(got, ScalarSpfBackend().compute_multiroot(tt, roots), "port scalar", MR_FIELDS)


@pytest.mark.parametrize("max_iters", [1, 2, 3])
def test_truncated_backend_matches_jax(max_iters):
    tt, jt = _topos(n_routers=100, n_networks=20, seed=7)
    masks = jsynth.whatif_link_failure_masks(jt, 9, seed=2)
    be, jbe = TorchSpfBackend(device="cpu", max_iters=max_iters), TpuSpfBackend(max_iters=max_iters)
    for a, b in zip(be.compute_whatif(tt, masks), jbe.compute_whatif(jt, masks)):
        _same(a, b)
    _same(be.compute(tt), jbe.compute(jt))


def _parallel_pair(mod):
    # Two 0 -> 1 edges (costs 1 and 2): parallel (src, dst) pairs.
    return mod.Topology(
        n_vertices=3,
        is_router=np.ones(3, bool),
        edge_src=np.array([0, 0, 1, 1, 2, 0], np.int32),
        edge_dst=np.array([1, 1, 0, 2, 1, 2], np.int32),
        edge_cost=np.array([1, 2, 1, 1, 1, 9], np.int32),
        edge_direct_atom=np.array([0, 1, -1, -1, -1, 2], np.int32),
        root=0,
    )


def test_blocked_sends_parallel_edges_to_gather():
    tt, jt = _parallel_pair(tgraph), _parallel_pair(jgraph)
    be = TorchSpfBackend(engine="blocked", device="cpu")
    _same(be.compute(tt), JScalar().compute(jt))
    masks = np.ones((2, tt.n_edges), bool)
    masks[1, 0] = False
    for a, b in zip(be.compute_whatif(tt, masks), JScalar().compute_whatif(jt, masks)):
        _same(a, b)
    assert be.routed_to_gather == 2
    assert be.prepare_blocked(tt) is None  # cached: the marshal is not retried


def test_blocked_sends_five_failures_to_gather():
    tt, jt = _topos(n_routers=40, seed=1)
    masks = np.ones((3, tt.n_edges), bool)
    masks[1, :5] = False
    masks[2, 7] = False
    be = TorchSpfBackend(engine="blocked", device="cpu")
    got = be.compute_whatif(tt, masks)
    assert be.routed_to_gather == 1
    for a, b in zip(got, JScalar().compute_whatif(jt, masks)):
        _same(a, b)
    for a, b in zip(got, TpuSpfBackend(engine="blocked").compute_whatif(jt, masks)):
        _same(a, b)
    be.compute_whatif(tt, masks[[0, 2]])  # within the preconditions: blocked
    assert be.routed_to_gather == 1


def test_multipath_raises():
    """No entry point raises on multipath_k 2..8 any more: both engines and
    the port's oracle return the multipath planes at the padded width
    (the blocked engine through the gather engine's multipath program), and
    multipath_k=1 leaves them None."""
    tt, jt = _topos(n_routers=20, seed=1)
    n = tt.n_vertices
    masks = np.ones((2, tt.n_edges), bool)
    masks[1, :3] = False
    blocked = TorchSpfBackend(engine="blocked", device="cpu")
    for be in (TorchSpfBackend(device="cpu"), blocked, ScalarSpfBackend()):
        one = be.compute(tt, multipath_k=2)
        batch = be.compute_whatif(tt, masks, multipath_k=8)
        for res, kp in ((one, 2), (batch[0], 8), (batch[1], 8)):
            assert res.parents.shape == res.pdist.shape == res.pweight.shape == (n, kp)
            assert res.npaths.shape == (n,) and res.nh_weights.shape == (n, 64)
        _same(one, JScalar().compute(jt, multipath_k=2), "multipath_k=2",
              FIELDS + ("parents", "pdist", "pweight", "npaths", "nh_weights"))
        single = be.compute(tt, multipath_k=1)
        assert single.dist.shape == (n,) and single.parents is None
    assert blocked.routed_to_gather == 0  # kp > 1 never tries the blocked planes


@pytest.mark.parametrize("one_engine", ["tropical", "mp", "mp_tropical", "gather"])
def test_other_one_engines_raise(one_engine):
    # seq, fused, packed, hybrid (tests/test_torch_engines.py) and tropical
    # (tests/test_torch_tropical.py, its multipath program
    # tests/test_torch_tropical_mp.py) run: a pinned-tropical compute at
    # multipath_k 2 raises nothing and equals holo_tpu's mp_tropical.  A
    # multipath or engine name is no single-path formulation.
    if one_engine == "tropical":
        be = TorchSpfBackend(one_engine=one_engine, device="cpu")
        tt = tsynth.random_ospf_topology(n_routers=12, seed=1)
        jt = jsynth.random_ospf_topology(n_routers=12, seed=1)
        got = be.compute(tt, multipath_k=2)
        want = TpuSpfBackend(one_engine="tropical").compute(jt, multipath_k=2)
        for f in FIELDS + ("parents", "pdist", "pweight", "npaths", "nh_weights"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
        assert not any(be.breaker.snapshot()[k] for k in ("failures", "fallbacks", "refusals"))
        return
    with pytest.raises(ValueError, match="lane programs are"):
        TorchSpfBackend(one_engine=one_engine, device="cpu")


def test_gather_cache_is_per_topology_and_bounded():
    be = TorchSpfBackend(device="cpu")
    cap = be._gather_cache.capacity  # the device's shared cache, seen through a view
    topos = [tsynth.random_ospf_topology(n_routers=20, seed=s) for s in range(cap + 2)]
    g0 = be.prepare(topos[0])
    assert be.prepare(topos[0]) is g0
    for t in topos[1:]:
        be.prepare(t)
    assert len(be._gather_cache) == cap
    assert be._gather_cache.lookups == {"hit": 1, "miss": cap + 2}
    before = be.prepare(topos[-1])
    topos[-1].touch()  # a new generation marshals anew
    assert be.prepare(topos[-1]) is not before


@pytest.mark.parametrize("engine", ["gather", "blocked"])
def test_empty_whatif_batch_matches_jax(engine):
    tt, jt = _topos(n_routers=24, n_networks=8, extra_p2p=40, seed=3)
    masks = np.zeros((0, tt.n_edges), bool)
    got = TorchSpfBackend(engine=engine, device="cpu").compute_whatif(tt, masks)
    assert got == [] and TpuSpfBackend().compute_whatif(jt, masks) == []


@pytest.mark.parametrize("engine", ["gather", "blocked"])
def test_empty_multiroot_matches_jax(engine):
    tt, jt = _topos(n_routers=24, n_networks=8, extra_p2p=40, seed=3)
    roots = np.zeros(0, np.int32)
    got = TorchSpfBackend(engine=engine, device="cpu").compute_multiroot(tt, roots)
    assert got.dist.shape == (0, tt.n_vertices)
    _same(got, TpuSpfBackend().compute_multiroot(jt, roots), "jax", MR_FIELDS)


def test_cpu_path_launches_no_kernel():
    ell.reset_launches()
    bkernels.reset_launches()
    t = tsynth.random_ospf_topology(n_routers=30, seed=2)
    be = TorchSpfBackend(device="cpu")
    be.compute(t)
    be.compute_whatif(t, np.ones((3, t.n_edges), bool))
    be.compute_multiroot(t, [0, 1])
    assert all(v == 0 for v in ell.launches.values())
    assert all(v == 0 for v in bkernels.launches.values())


def test_ell_wrappers_refuse_other_devices():
    meta = torch.empty((4, 8), dtype=torch.int32, device="meta")
    cpu = torch.zeros((4, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA device"):
        ell.ell_relax(meta, meta, meta, None, meta, meta)
    with pytest.raises(ValueError, match="CUDA device"):
        ell.ell_first_parent(cpu, cpu, cpu, None, meta, cpu[0])
    with pytest.raises(ValueError, match="CUDA device"):
        ell.ell_nh_seed(cpu, meta, cpu, cpu, 8)
    with pytest.raises(ValueError, match="CUDA device"):
        ell.ell_nh_round(cpu, meta, cpu, cpu)


def _causal_digest(timelines):
    """storm_digest over the timelines without their engine attribution
    (the "dispatch" entries name the backend that served each SPF --
    "scalar" or "device" in holo_tpu; the port notes none)."""
    out = []
    for rec in timelines:
        rec = {k: v for k, v in rec.items() if k != "dispatch"}
        rec["timeline"] = [e for e in rec["timeline"] if e[0] != "dispatch"]
        out.append(rec)
    return json.dumps(out, sort_keys=True)


def test_convergence_storm_matches_scalar(monkeypatch):
    seen = []
    digest = synth_storm.storm_digest

    def recording_digest(timelines):
        seen.append(timelines)
        return digest(timelines)

    monkeypatch.setattr(synth_storm, "storm_digest", recording_digest)
    kw = dict(n_routers=120, events=40, seed=9)
    r_s, _, net_s = synth_storm.run_convergence_storm(spf_backend=JScalar(), **kw)
    r_t, _, net_t = synth_storm.run_convergence_storm(
        spf_backend=TorchSpfBackend(device="cpu"), **kw
    )
    assert r_t["spf-runs"] == r_s["spf-runs"] > 0
    assert dict(net_t.kernel.fib) == dict(net_s.kernel.fib) and len(net_s.kernel.fib) > 0
    scalar_tl, port_tl = seen
    assert all(e[2]["mode"] == "scalar" for r in scalar_tl for e in r["timeline"]
               if e[0] == "dispatch")
    assert _causal_digest(port_tl) == _causal_digest(scalar_tl)
    assert digest(json.loads(_causal_digest(port_tl))) == \
        digest(json.loads(_causal_digest(scalar_tl)))
