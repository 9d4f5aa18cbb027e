"""TorchSpfBackend(engine="blocked") against holo_tpu's
TpuSpfBackend(engine="blocked") and ScalarSpfBackend on all four planes
(exact equality), the blocked engine's preconditions (outside them the
backend sends the topology to the gather engine, tests/
test_torch_gather_backend.py), and its device rules: CPU only on request,
never a silent fallback."""

import numpy as np
import pytest
import torch

from holo_tpu.spf import synth as jsynth
from holo_tpu.spf.backend import ScalarSpfBackend as JScalar
from holo_tpu.spf.backend import TpuSpfBackend
from holo_tpu_torch.kernels import blocked as kernels
from holo_tpu_torch.ops.blocked_spf import failed_edges_perm, marshal_block_spf
from holo_tpu_torch.ops.graph import Topology
from holo_tpu_torch.spf import synth as tsynth
from holo_tpu_torch.spf.backend import ScalarSpfBackend, TorchSpfBackend

FIELDS = ("dist", "parent", "hops", "nexthop_words")


def _same(a, b, label=""):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, (label, f)
        np.testing.assert_array_equal(x, y, err_msg=f"{label} {f}")


@pytest.mark.parametrize("seed", [4, 8])
def test_whatif_and_compute_match_jax_and_scalar(seed):
    kw = dict(n_routers=150, n_networks=30, seed=seed)
    tt, jt = tsynth.random_ospf_topology(**kw), jsynth.random_ospf_topology(**kw)
    masks = jsynth.whatif_link_failure_masks(jt, n_scenarios=4, seed=seed + 1)
    be = TorchSpfBackend(engine="blocked", device="cpu")
    got = be.compute_whatif(tt, masks)
    jax_res = TpuSpfBackend(engine="blocked").compute_whatif(jt, masks)
    scalar = JScalar().compute_whatif(jt, masks)
    assert len(got) == len(masks)
    for b, (g, j, s) in enumerate(zip(got, jax_res, scalar)):
        _same(g, j, f"jax b={b}")
        _same(g, s, f"scalar b={b}")
    one = be.compute(tt)
    _same(one, TpuSpfBackend(engine="blocked").compute(jt), "compute jax")
    _same(one, JScalar().compute(jt), "compute scalar")
    _same(be.compute(tt, masks[2]), scalar[2], "compute masked")
    assert be.routed_to_gather == 0


def test_port_scalar_backend_matches_jax_scalar():
    kw = dict(n_routers=120, n_networks=25, extra_p2p=200, max_cost=4, seed=42)
    tt, jt = tsynth.random_ospf_topology(**kw), jsynth.random_ospf_topology(**kw)
    masks = jsynth.whatif_link_failure_masks(jt, n_scenarios=3, seed=2)
    for a, b in zip(ScalarSpfBackend().compute_whatif(tt, masks), JScalar().compute_whatif(jt, masks)):
        _same(a, b)


def test_fat_tree_matches_scalar():
    t = tsynth.fat_tree_topology(k=8)
    masks = tsynth.whatif_link_failure_masks(t, 5, seed=1)
    for a, b in zip(TorchSpfBackend(engine="blocked", device="cpu").compute_whatif(t, masks),
                    ScalarSpfBackend().compute_whatif(t, masks)):
        _same(a, b)


def test_marshal_cache_is_per_topology_and_bounded():
    be = TorchSpfBackend(engine="blocked", device="cpu")
    topos = [tsynth.random_ospf_topology(n_routers=20, seed=s) for s in range(6)]
    g0 = be.prepare_blocked(topos[0])
    assert be.prepare_blocked(topos[0]) is g0
    for t in topos[1:]:
        be.prepare_blocked(t)
    assert len(be._blocked_cache) == 4
    before = be.prepare_blocked(topos[5])
    topos[5].touch()  # a new generation marshals anew
    assert be.prepare_blocked(topos[5]) is not before
    assert len(be._blocked_cache) == 4


def test_parallel_edges_raise():
    par = Topology(
        n_vertices=3,
        is_router=np.ones(3, bool),
        edge_src=np.array([0, 0, 1, 1, 2, 0], np.int32),
        edge_dst=np.array([1, 1, 0, 2, 1, 2], np.int32),
        edge_cost=np.array([1, 2, 1, 1, 1, 9], np.int32),
        root=0,
    )
    with pytest.raises(ValueError, match="parallel"):
        marshal_block_spf(par, device="cpu")
    be = TorchSpfBackend(engine="blocked", device="cpu")
    assert be.prepare_blocked(par) is None  # the gather engine serves it
    _same(be.compute(par), ScalarSpfBackend().compute(par))
    assert be.routed_to_gather == 1


def test_too_many_failures_raise():
    t = tsynth.random_ospf_topology(n_routers=40, seed=1)
    masks = np.ones((2, t.n_edges), bool)
    masks[1, :5] = False
    with pytest.raises(ValueError, match="scenario 1: 5 failures > 4"):
        failed_edges_perm(np.arange(t.n_vertices), t, masks, device="cpu")
    be = TorchSpfBackend(engine="blocked", device="cpu")
    for a, b in zip(be.compute_whatif(t, masks), ScalarSpfBackend().compute_whatif(t, masks)):
        _same(a, b)
    assert be.routed_to_gather == 1


def test_no_device_and_no_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchSpfBackend()


def test_only_blocked_engine():
    # Besides 'blocked' the port runs only the gather engine.
    with pytest.raises(ValueError, match="'gather' and 'blocked'"):
        TorchSpfBackend(engine="tropical", device="cpu")
    assert TorchSpfBackend(device="cpu").engine == "gather"


def test_cpu_path_launches_no_kernel():
    kernels.reset_launches()
    t = tsynth.random_ospf_topology(n_routers=30, seed=2)
    TorchSpfBackend(engine="blocked", device="cpu").compute(t)
    assert all(v == 0 for v in kernels.launches.values())


def test_wrapper_refuses_other_devices():
    meta = torch.empty((1, 256, 256), dtype=torch.int32, device="meta")
    small = torch.zeros(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        kernels.relax(meta, small, small, small, meta)
    cpu = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA device"):
        kernels.dmin_parent(meta, cpu, cpu, cpu, meta, cpu)
