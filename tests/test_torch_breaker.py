"""The port's dispatch circuit breaker: its state machine (the breaker cases
of tests/test_resilience.py, on holo_tpu_torch.resilience.breaker), its
counts by cause, and its place in front of TorchSpfBackend and FrrEngine.
On the CPU with no max_iters cap a forced device failure is served
bit-identically by the scalar oracle and counted; on another device, or
under max_iters, it is counted and re-raises, and an open circuit refuses
the dispatch.  A passthrough error (ValueError included: the kernel
wrappers' device checks) and a kernel library that does not build re-raise
uncounted."""

import time

import numpy as np
import pytest
import torch

from holo_tpu_torch.frr import manager as frr_manager
from holo_tpu_torch.frr.manager import FrrConfig, FrrEngine
from holo_tpu_torch.frr.scalar import frr_reference
from holo_tpu_torch.kernels import build
from holo_tpu_torch.kernels.build import KernelBuildError
from holo_tpu_torch.resilience import CircuitBreaker, CircuitOpen, breakers, tallies
from holo_tpu_torch.resilience import breaker as breaker_mod
from holo_tpu_torch.spf import backend as spf_backend
from holo_tpu_torch.spf import synth
from holo_tpu_torch.spf.backend import ScalarSpfBackend, TorchSpfBackend

PLANES = ("lfa_adj", "lfa_nodeprot", "rlfa_pq", "tilfa_p", "tilfa_q", "post_dist", "post_nh")
SPF_FIELDS = ("dist", "parent", "hops", "nexthop_words")


def mkbreaker(name, **kw):
    kw.setdefault("failure_threshold", 3)
    kw.setdefault("recovery_timeout", 3600.0)
    return CircuitBreaker(name, **kw)


def expire(br):
    """Let the open circuit's recovery timeout elapse."""
    br._open_until = time.monotonic() - 1.0


def boom(exc=RuntimeError("CUDA error 700 at launch")):
    def fn():
        raise exc
    return fn


# -- the state machine


def test_opens_after_consecutive_failures_and_short_circuits():
    br = mkbreaker("t-open")
    calls = {"primary": 0, "fallback": 0}

    def bad():
        calls["primary"] += 1
        raise RuntimeError("device lost")

    def oracle():
        calls["fallback"] += 1
        return "scalar"

    for _ in range(3):
        assert br.call(bad, oracle) == "scalar"
    assert br.state == "open" and calls == {"primary": 3, "fallback": 3}
    assert br.call(bad, oracle) == "scalar"  # open: the device is not tried
    assert calls["primary"] == 3 and calls["fallback"] == 4
    snap = br.snapshot()
    assert snap["failures"] == {"exception": 3}
    assert snap["fallbacks"] == {"exception": 3, "open": 1}


def test_success_resets_failure_streak():
    br = mkbreaker("t-streak")
    br.call(boom(), lambda: None)
    br.call(boom(), lambda: None)
    assert br.consecutive_failures == 2
    assert br.call(lambda: "ok", lambda: "fb") == "ok"
    assert br.consecutive_failures == 0 and br.state == "closed"


def test_half_open_probe_restores_service():
    br = mkbreaker("t-probe")
    for _ in range(3):
        br.call(boom(), lambda: "fb")
    assert br.state == "open"
    assert br.call(lambda: "device", lambda: "fb") == "fb"  # still open
    expire(br)
    assert br.call(lambda: "device", lambda: "fb") == "device"
    assert br.state == "closed"
    assert br.call(lambda: "device", lambda: "fb") == "device"


def test_failed_probe_reopens():
    br = mkbreaker("t-reprobe")
    for _ in range(3):
        br.call(boom(), lambda: "fb")
    expire(br)
    assert br.call(boom(), lambda: "fb") == "fb"  # the probe fails
    assert br.state == "open"
    assert br.call(lambda: "dev", lambda: "fb") == "fb"  # a fresh timeout applies
    expire(br)
    assert br.call(lambda: "dev", lambda: "fb") == "dev"
    assert br.state == "closed"


def test_no_fallback_reraises_counted_and_open_refuses():
    """The card's contract: no oracle serves, the FSM and the counts stay."""
    br = mkbreaker("t-nofallback", failure_threshold=2)
    tried = []

    def bad():
        tried.append(1)
        raise RuntimeError("CUDA error 2: out of memory")

    for _ in range(2):
        with pytest.raises(RuntimeError, match="out of memory"):
            br.call(bad, None, "spf.whatif")
    assert br.state == "open" and len(tried) == 2
    with pytest.raises(CircuitOpen, match="spf.whatif"):
        br.call(bad, None, "spf.whatif")  # open: the device is not tried
    assert len(tried) == 2
    snap = br.snapshot()
    assert snap["failures"] == {"exception": 2} and snap["fallbacks"] == {}
    assert snap["refusals"] == {"open": 1} and "spf.whatif" in snap["last-error"]
    expire(br)
    assert br.call(lambda: "dev", None) == "dev" and br.state == "closed"


@pytest.mark.parametrize("exc", [TypeError("bug"), IndexError("bug"), KeyError("bug"),
                                 ValueError("kernel inputs must all lie on one CUDA device"),
                                 KernelBuildError("nvcc failed")],
                         ids=lambda e: type(e).__name__)
def test_passthrough_errors_reraise(exc):
    br = mkbreaker(f"t-pass-{type(exc).__name__}")
    with pytest.raises(type(exc)):
        br.call(boom(exc), lambda: "fb")
    assert br.consecutive_failures == 0 and br.state == "closed"
    assert br.snapshot()["fallbacks"] == {}


def test_probe_slot_released_when_passthrough_escapes():
    br = mkbreaker("t-probe-abort")
    for _ in range(3):
        br.call(boom(), lambda: "fb")
    expire(br)
    with pytest.raises(KernelBuildError):
        br.call(boom(KernelBuildError("no nvcc")), lambda: "fb")
    assert br.state == "half-open"
    assert br.call(lambda: "dev", lambda: "fb") == "dev"
    assert br.state == "closed"


def test_snapshot_registry_names_and_tallies():
    a = mkbreaker("t-named")
    b = mkbreaker("t-named")
    assert a.name == "t-named" and b.name == "t-named#2"
    assert breakers()["t-named#2"] is b
    b.call(boom(), lambda: None)
    snap = b.snapshot()
    assert snap["state"] == "closed" and snap["consecutive-failures"] == 1
    assert "CUDA error 700" in snap["last-error"]
    name = b.name
    del b
    assert tallies()[(name, "failures", "exception")] == 1
    assert tallies()[(name, "fallbacks", "exception")] == 1


# -- the breaker in front of the SPF backend


@pytest.fixture(scope="module")
def topo():
    return synth.random_ospf_topology(n_routers=30, n_networks=6, extra_p2p=20, seed=11)


def _same_spf(a, b, label=""):
    for f in SPF_FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f"{label} {f}")


def _failing(real, fails: list):
    """``real`` that raises a CUDA-shaped RuntimeError while ``fails`` has
    entries (one popped a call)."""
    def fn(*args, **kwargs):
        if fails:
            fails.pop()
            raise RuntimeError("holo_ell_relax: CUDA error 700 at launch")
        return real(*args, **kwargs)
    return fn


@pytest.mark.parametrize("engine", ["gather", "blocked"])
def test_spf_forced_failure_served_by_oracle_and_counted(monkeypatch, topo, engine):
    masks = synth.whatif_link_failure_masks(topo, 4, seed=2)
    oracle = ScalarSpfBackend()
    be = TorchSpfBackend(engine=engine, device="cpu")
    fails = [1, 1, 1]
    for name in ("spf_one", "spf_whatif_batch", "spf_multiroot", "whatif_spf_blocked"):
        monkeypatch.setattr(spf_backend, name, _failing(getattr(spf_backend, name), fails))
    _same_spf(be.compute(topo), oracle.compute(topo), "compute")
    for got, want in zip(be.compute_whatif(topo, masks), oracle.compute_whatif(topo, masks)):
        _same_spf(got, want, "whatif")
    roots = [0, 3, 5]
    mr, want = be.compute_multiroot(topo, roots), oracle.compute_multiroot(topo, roots)
    for f in ("dist", "parent", "hops"):
        np.testing.assert_array_equal(getattr(mr, f), getattr(want, f))
    snap = be.breaker.snapshot()
    assert snap["failures"] == {"exception": 3} and snap["fallbacks"] == {"exception": 3}
    assert be.breaker.state == "open" and be.breaker.name.startswith("spf-dispatch")
    assert not fails


def test_spf_breaker_recovers_and_composes_with_deltapath(monkeypatch, topo):
    """One failed dispatch mid-chain: the oracle serves it, the circuit
    stays closed, and the next delta-linked compute runs on the device."""
    be = TorchSpfBackend(device="cpu", breaker=CircuitBreaker("t-spf-delta"))
    be.compute(topo)
    t1 = synth.clone_topology(topo, cost={0: int(topo.edge_cost[0]) + 3})
    t1.link_delta(spf_backend_delta(topo, t1))
    fails = [1]
    monkeypatch.setattr(spf_backend, "spf_one_incremental",
                        _failing(spf_backend.spf_one_incremental, fails))
    _same_spf(be.compute(t1), ScalarSpfBackend().compute(t1), "failed step")
    assert be.breaker.consecutive_failures == 1 and be.breaker.state == "closed"
    t2 = synth.clone_topology(t1, cost={0: int(topo.edge_cost[0])})
    t2.link_delta(spf_backend_delta(t1, t2))
    be.compute(t1)  # device again: keeps the seed of the next step
    _same_spf(be.compute(t2), ScalarSpfBackend().compute(t2), "next step")
    assert be.breaker.consecutive_failures == 0
    assert be.delta_paths[("weight", "incremental")] >= 1


def spf_backend_delta(base, new):
    from holo_tpu_torch.ops.graph import diff_topologies

    return diff_topologies(base, new)


def test_spf_passthrough_and_device_check_reraise(monkeypatch, topo):
    be = TorchSpfBackend(device="cpu")
    monkeypatch.setattr(spf_backend, "spf_one", lambda *a, **k: build.load() and None)
    monkeypatch.setattr(build, "_LIB", None)
    monkeypatch.setattr(build, "build", lambda verbose=False: (_ for _ in ()).throw(
        KernelBuildError("nvcc failed on ell_kernels.cu")))
    with pytest.raises(KernelBuildError, match="nvcc failed"):
        be.compute(topo)
    monkeypatch.undo()
    # The wrappers' device check (a tensor off the card and off the CPU).
    meta = TorchSpfBackend(device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        meta.compute(topo)
    with pytest.raises(ValueError, match="CUDA device"):
        FrrEngine("torch", device="meta").compute(topo)
    for b in (be.breaker, meta.breaker):
        assert b.snapshot()["failures"] == {} and b.snapshot()["fallbacks"] == {}


# Where the oracle does not compute the device path's bits: tensors off the
# CPU ("meta" stands for the card here) or an iteration cap.
NO_ORACLE = [{"device": "meta"}, {"device": "cpu", "max_iters": 2}]


@pytest.mark.parametrize("kw", NO_ORACLE, ids=["off-cpu", "max_iters"])
def test_spf_failure_without_oracle_reraises_counted(monkeypatch, topo, kw):
    be = TorchSpfBackend(**kw, breaker=CircuitBreaker("t-spf-nofallback", failure_threshold=2))
    fails = [1, 1, 1]
    monkeypatch.setattr(spf_backend, "spf_one", _failing(spf_backend.spf_one, fails))
    monkeypatch.setattr(spf_backend, "spf_whatif_batch",
                        _failing(spf_backend.spf_whatif_batch, fails))
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        be.compute(topo)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        be.compute_whatif(topo, synth.whatif_link_failure_masks(topo, 2, seed=2))
    with pytest.raises(CircuitOpen):
        be.compute(topo)  # open: refused, the device not tried
    assert fails == [1]
    snap = be.breaker.snapshot()
    assert snap["failures"] == {"exception": 2} and snap["fallbacks"] == {}
    assert snap["refusals"] == {"open": 1}


# -- the breaker in front of the FRR engine


def test_frr_forced_failure_served_by_oracle_and_counted(monkeypatch):
    """test_frr_parity.py's forced-failure case on the port: the fallback
    runs the oracle over the same marshaled inputs and policy."""
    t = synth.random_ospf_topology(n_routers=14, n_networks=4, extra_p2p=8, seed=1)
    t.edge_srlg = np.random.default_rng(2).integers(0, 4, t.n_edges).astype(np.uint32)
    cfg = FrrConfig(enabled=True, node_protection=True, srlg_disjoint=True)
    want = frr_reference(t, 64, srlg_disjoint=True, node_protection=True)
    eng = FrrEngine("torch", device="cpu", breaker=CircuitBreaker("t-frr-fallback"))
    eng.set_policy(cfg)
    fails = [1]
    monkeypatch.setattr(frr_manager, "frr_batch", _failing(frr_manager.frr_batch, fails))
    got = eng.compute(t)
    for f in PLANES:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    assert eng.breaker.consecutive_failures == 1 and eng.breaker.state == "closed"
    assert eng.dispatches == {"fallback": 1}
    again = eng.compute(t)  # healthy: the batched path again
    for f in PLANES:
        np.testing.assert_array_equal(getattr(again, f), getattr(want, f), err_msg=f)
    assert eng.breaker.consecutive_failures == 0 and eng.dispatches["device"] == 1
    assert eng.breaker.snapshot()["fallbacks"] == {"exception": 1}


@pytest.mark.parametrize("kw", NO_ORACLE, ids=["off-cpu", "max_iters"])
def test_frr_failure_without_oracle_reraises_counted(monkeypatch, kw):
    t = synth.random_ospf_topology(n_routers=10, n_networks=2, seed=3)
    eng = FrrEngine("torch", **kw, breaker=CircuitBreaker("t-frr-nofallback"))
    eng.set_policy(FrrConfig(enabled=True))
    fails = [1]
    monkeypatch.setattr(frr_manager, "frr_batch", _failing(frr_manager.frr_batch, fails))
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        eng.compute(t)
    assert not fails and eng.dispatches == {}
    snap = eng.breaker.snapshot()
    assert snap["failures"] == {"exception": 1} and snap["fallbacks"] == {}
    assert eng.breaker.consecutive_failures == 1 and eng.breaker.state == "closed"


def test_frr_build_error_reraises(monkeypatch):
    t = synth.random_ospf_topology(n_routers=10, n_networks=2, seed=3)
    eng = FrrEngine("torch", device="cpu")
    monkeypatch.setattr(frr_manager, "frr_batch", lambda *a, **k: (_ for _ in ()).throw(
        KernelBuildError("kernel library does not load")))
    with pytest.raises(KernelBuildError):
        eng.compute(t)
    assert eng.dispatches == {} and eng.breaker.snapshot()["failures"] == {}


# -- the build errors themselves


def test_compile_failure_is_a_kernel_build_error(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "nvcc", lambda: "false")  # a compiler that always fails
    with pytest.raises(KernelBuildError, match="nvcc failed on"):
        build.build()
    monkeypatch.setattr(build, "nvcc", lambda: str(tmp_path / "no-such-nvcc"))
    with pytest.raises(KernelBuildError, match="could not start"):
        build.build()


def test_missing_nvcc_is_a_kernel_build_error(monkeypatch, tmp_path):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(build, "CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    with pytest.raises(KernelBuildError, match="nvcc not found"):
        build.nvcc()


def test_unloadable_library_is_a_kernel_build_error(monkeypatch, tmp_path):
    bad = tmp_path / "holo_kernels-bad.so"
    bad.write_text("not a shared library")
    monkeypatch.setattr(build, "_LIB", None)
    monkeypatch.setattr(build, "build", lambda verbose=False: bad)
    with pytest.raises(KernelBuildError, match="does not load"):
        build.load()
    assert build._LIB is None


def test_kernel_build_error_is_a_runtime_error():
    assert issubclass(KernelBuildError, RuntimeError)
    assert torch.cuda.OutOfMemoryError not in breaker_mod._PASSTHROUGH
