"""The port's runtime checks on the CPU: the donation guard and the transfer
sanitizer's window bookkeeping.

- the guard, reintroducing two orderings the port once had: the partitioned
  resident read on the caller's thread while the pipeline's worker re-solves
  it in place (the async facade's ``compute_partitioned`` on the caller's
  thread, as before the fix of ROADMAP C3), and a synchronous what-if or
  multi-root delegate reading a base's graph while the worker applies the
  chain's next delta to it in place.  Each raises ``DonatedBufferError``
  with its seam's reason instead of returning planes; the shipped code
  passes the same interleavings under the guard, and a delta chain with
  pipelined chains passes under the guard and the sanitizer;
- the guard's primitives: leases, version counters, generation stamps, raw
  writes, the disarmed fast path;
- the sanitizer: nesting depth, per-reason counts and windows across two
  threads, with the CUDA mode call replaced by a recorder (the CPU has no
  syncs to catch; the card test is in tests/test_torch_cuda.py).
"""

import threading

import numpy as np
import pytest
import torch

from holo_tpu_torch import testing
from holo_tpu_torch.analysis import runtime
from holo_tpu_torch.analysis.runtime import DonatedBufferError
from holo_tpu_torch.ops import graph as tgraph
from holo_tpu_torch.pipeline.dispatch import AsyncSpfBackend, DispatchPipeline
from holo_tpu_torch.spf import synth as tsynth
from holo_tpu_torch.spf.backend import TorchSpfBackend

FIELDS = ("dist", "parent", "hops", "nexthop_words")
KW = dict(n_routers=24, n_networks=6, extra_p2p=30)
WAIT = 60.0


@pytest.fixture
def pipe():
    p = DispatchPipeline(depth=2)
    yield p
    p.close()


def _tstep(tt, spec):
    tn = tsynth.clone_topology(tt, **spec)
    td = tgraph.diff_topologies(tt, tn)
    if td is not None:
        tn.link_delta(td)
    return tn


def _same(a, b, label):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f"{label} {f}")


def _force(lazy):
    return lazy._ticket.result(timeout=WAIT)


# -- the reintroduced orderings


def _on_callers_thread(monkeypatch, name):
    """The facade's ``name`` delegate run on the caller's thread, as before
    the delegates ran in their chain's order on the worker."""

    def direct(self, *a, **k):
        return getattr(self.inner, name)(*a, **k)

    monkeypatch.setattr(AsyncSpfBackend, name, direct)


def _partitioned_race(pipe, masked):
    """A delta of a partitioned chain is submitted; while it waits to
    re-solve the resident in place, the caller solves the delta's base.
    The solve's entry waits up to 1 s for the re-solve and the re-solve up
    to 1 s for the solve (tests/test_torch_pipeline.py's interleaving).
    Returns (the facade's result, the serial run's, the delta's lazy
    result)."""
    base = tsynth.multiarea_topology(4, 6, 6, seed=3)
    nxt = _tstep(base, {"cost": {e: 60 + e % 7 for e in range(0, base.n_edges, 3)}})
    mask = tsynth.whatif_link_failure_masks(base, 3, seed=5)[1] if masked else None
    want = TorchSpfBackend(device="cpu", partition_threshold=1,
                           incremental=False).compute_partitioned(base, mask)
    inner = TorchSpfBackend(device="cpu", partition_threshold=1)
    be = AsyncSpfBackend(inner, pipe)
    _force(be.compute(base))
    eng = inner._part_engine
    holds_base, applied = threading.Event(), threading.Event()
    real_solve, real_delta = eng.solve, eng.try_delta

    def solve(topo, *a, **k):
        if topo is base and not holds_base.is_set():
            holds_base.set()
            applied.wait(1.0)
        return real_solve(topo, *a, **k)

    def try_delta(topo, *a, **k):
        holds_base.wait(1.0)
        out = real_delta(topo, *a, **k)
        applied.set()
        return out

    eng.solve, eng.try_delta = solve, try_delta
    lazy = be.compute(nxt)
    return (lambda: be.compute_partitioned(base, mask)), want, lazy


@pytest.mark.parametrize("masked", [False, True])
def test_guard_catches_the_partitioned_read_on_the_callers_thread(pipe, monkeypatch, masked):
    _on_callers_thread(monkeypatch, "compute_partitioned")
    with testing.donation_guarded():
        call, _, lazy = _partitioned_race(pipe, masked)
        with pytest.raises(DonatedBufferError, match="spf.partitioned.readback"):
            call()
        _force(lazy)


@pytest.mark.parametrize("masked", [False, True])
def test_guard_passes_the_partitioned_call_in_chain_order(pipe, masked):
    with testing.donation_guarded():
        call, want, lazy = _partitioned_race(pipe, masked)
        _same(call(), want, f"compute_partitioned masked={masked}")
        _force(lazy)


def _delegate_race(pipe, call):
    """A delta of a chain is submitted; while it waits to apply itself, the
    caller runs ``compute_whatif`` / ``compute_multiroot`` on the delta's
    base, which holds the base's graph until the apply (up to 1 s each
    way).  Returns (the delegate, the serial run's results, the delta's
    lazy result)."""
    base = tsynth.random_ospf_topology(seed=11, **KW)
    nxt = _tstep(base, {"cost": {e: 60 + e for e in range(0, base.n_edges, 3)}})
    masks = tsynth.whatif_link_failure_masks(base, 3, seed=5)
    roots = [0, 3, 7]

    def delegate(be, topo):
        if call == "whatif":
            return be.compute_whatif(topo, masks)
        return [be.compute_multiroot(topo, roots)]

    want = delegate(TorchSpfBackend(device="cpu", incremental=False), base)
    inner = TorchSpfBackend(device="cpu")
    be = AsyncSpfBackend(inner, pipe)
    _force(be.compute(base))
    cache = inner._gather_cache
    holds_base, applied = threading.Event(), threading.Event()
    real_get, real_delta = cache.get, cache._try_delta

    def get(topo, *a, **k):
        out = real_get(topo, *a, **k)
        if topo is base and not holds_base.is_set():
            holds_base.set()
            applied.wait(1.0)
        return out

    def try_delta(topo, *a, **k):
        holds_base.wait(1.0)
        out = real_delta(topo, *a, **k)
        applied.set()
        return out

    cache.get, cache._try_delta = get, try_delta
    lazy = be.compute(nxt)
    return (lambda: delegate(be, base)), want, lazy


@pytest.mark.parametrize("call", ["whatif", "multiroot"])
def test_guard_catches_the_delegate_on_the_callers_thread(pipe, monkeypatch, call):
    _on_callers_thread(monkeypatch, f"compute_{call}")
    with testing.donation_guarded():
        run, _, lazy = _delegate_race(pipe, call)
        with pytest.raises(DonatedBufferError, match=f"spf.{call}.readback"):
            run()
        _force(lazy)


@pytest.mark.parametrize("call", ["whatif", "multiroot"])
def test_guard_passes_the_delegate_in_chain_order(pipe, call):
    with testing.donation_guarded():
        run, want, lazy = _delegate_race(pipe, call)
        fields = FIELDS if call == "whatif" else ("dist", "parent", "hops")
        for j, (g, w) in enumerate(zip(run(), want)):
            for f in fields:
                np.testing.assert_array_equal(getattr(g, f), getattr(w, f), err_msg=f"{j} {f}")
        _force(lazy)


def test_chains_pass_under_the_guard_and_the_sanitizer(pipe):
    """Two interleaved pipelined delta chains, and a synchronous one, under
    both checks: every result equals the serial run, nothing raises, and the
    seams counted."""
    rng = np.random.default_rng(3)
    ref = TorchSpfBackend(device="cpu", incremental=False)
    inner = TorchSpfBackend(device="cpu")
    be = AsyncSpfBackend(inner, pipe)
    sync = TorchSpfBackend(device="cpu")
    chains = [tsynth.random_ospf_topology(seed=s, **KW) for s in (21, 22, 23)]
    before = (runtime.consumed_counts(), runtime.donated_counts())
    with testing.donation_guarded(), testing.no_implicit_transfers():
        for step in range(5):
            lazies = [be.compute(t) for t in chains[:2]]
            for t, lazy in zip(chains[:2], lazies):
                _same(_force(lazy), ref.compute(t), f"pipelined step {step}")
            _same(sync.compute(chains[2]), ref.compute(chains[2]), f"sync step {step}")
            chains = [_tstep(t, {"cost": {int(rng.integers(0, t.n_edges)):
                                          int(rng.integers(1, 40))}}) for t in chains]
    consumed, donated = runtime.consumed_counts(), runtime.donated_counts()
    assert consumed.get("pipeline.key.handoff", 0) > before[0].get("pipeline.key.handoff", 0)
    assert donated.get("spf.graph.delta", 0) > before[1].get("spf.graph.delta", 0)
    assert inner.delta_paths[("weight", "incremental")] > 0


# -- the guard's primitives


def test_lease_sees_an_in_place_move_and_names_the_seam():
    t = torch.zeros(4, dtype=torch.int32)
    with runtime.donation_guard():
        ls = runtime.lease(t, (None, [t]), generation="g1")
        runtime.assert_live("site.readback", ls)
        t.add_(1)  # an in-place torch op bumps the version
        runtime.note_donated("test.seam", t, generation="g1")
        with pytest.raises(DonatedBufferError, match="site.readback.*test.seam"):
            runtime.assert_live("site.readback", ls)


def test_lease_sees_another_generation():
    t = torch.zeros(4, dtype=torch.int32)
    with runtime.donation_guard():
        runtime.note_donated("test.seam", t, generation="g2")
        ls = runtime.lease(t, generation="g1")
        with pytest.raises(DonatedBufferError, match="another generation"):
            runtime.assert_live("site.readback", ls)
        runtime.assert_live("site.readback", runtime.lease(t, generation="g2"))


def test_raw_writes_bump_the_version():
    """A kernel's write through a raw pointer moves no version counter: the
    seam bumps it (``raw=True``)."""
    t = torch.zeros(4, dtype=torch.int32)
    with runtime.donation_guard():
        ls = runtime.lease(t)
        t.numpy()[0] = 7  # a write past torch's view of the tensor
        runtime.assert_live("site.readback", ls)
        runtime.note_donated("test.raw", t, raw=True)
        with pytest.raises(DonatedBufferError, match="test.raw"):
            runtime.assert_live("site.readback", ls)


def test_stamps_of_an_earlier_arming_are_ignored():
    t = torch.zeros(2)
    with runtime.donation_guard():
        runtime.note_donated("test.seam", t, generation="old")
    with runtime.donation_guard():
        runtime.assert_live("site.readback", runtime.lease(t, generation="new"))


def test_disarmed_guard_does_nothing():
    t = torch.zeros(2)
    assert not runtime.donation_guard_armed()
    assert runtime.lease(t) is None
    before = runtime.donated_counts()
    runtime.note_donated("test.disarmed", t, generation="x")
    t.add_(1)
    runtime.assert_live("site.readback", None)
    assert runtime.donated_counts() == before
    assert not hasattr(t, "_holo_donation")


# -- the sanitizer's bookkeeping


@pytest.fixture
def modes(monkeypatch):
    """The sync debug modes the sanitizer sets, in order."""
    seen = []
    monkeypatch.setattr(runtime, "_set_mode", seen.append)
    return seen


def test_sanitizer_nests_and_restores(modes):
    with testing.no_implicit_transfers():
        assert runtime.sanitizer_state() == {"armed": 1, "open": 0}
        with testing.no_implicit_transfers():
            assert runtime.sanitizer_state()["armed"] == 2
        assert modes[-1] == "error"
    assert runtime.sanitizer_state() == {"armed": 0, "open": 0}
    assert modes == ["error", "error", "error", "default"]


def test_windows_count_by_reason_and_lift_the_mode(modes):
    before = runtime.sanctioned_counts()
    with testing.no_implicit_transfers():
        with runtime.sanctioned_transfer("test.window"):
            assert modes[-1] == "default"
            with runtime.sanctioned_transfer("test.inner"):
                assert runtime.sanitizer_state()["open"] == 2
            assert modes[-1] == "default"
        assert modes[-1] == "error"
        assert runtime.read_flag("test.flag", torch.tensor(True)) is True
        assert modes[-1] == "error"
    after = runtime.sanctioned_counts()
    for reason in ("test.window", "test.inner", "test.flag"):
        assert after[reason] == before.get(reason, 0) + 1
    # Disarmed, a window only counts.
    n = len(modes)
    with runtime.sanctioned_transfer("test.window"):
        pass
    assert len(modes) == n
    assert runtime.sanctioned_counts()["test.window"] == after["test.window"] + 1


def test_windows_on_two_threads_do_not_clobber_each_other(modes):
    """Thread A holds a window open while thread B opens and closes its own:
    the mode stays lifted until A closes, then returns to "error"."""
    a_open, b_done = threading.Event(), threading.Event()
    seen = {}

    def a():
        with runtime.sanctioned_transfer("test.a"):
            a_open.set()
            b_done.wait(5.0)
            seen["a-inside"] = modes[-1]

    with testing.no_implicit_transfers():
        ta = threading.Thread(target=a)
        ta.start()
        a_open.wait(5.0)
        with runtime.sanctioned_transfer("test.b"):
            pass
        seen["after-b"] = modes[-1]
        seen["open-after-b"] = runtime.sanitizer_state()["open"]
        b_done.set()
        ta.join(5.0)
        seen["after-a"] = modes[-1]
    assert seen == {"after-b": "default", "open-after-b": 1, "a-inside": "default",
                    "after-a": "error"}
    assert modes[-1] == "default"
