"""The port's dispatch survivability plane (``tests/test_overload.py``'s
contract): priority classes, graded shedding, advisory deadlines, close()
waking a blocked submitter, the hung-dispatch watchdog (abandon, fallback
or failure by the card rule, breaker strike, respawn), worker kills with
respawn, and the transient-retry taxonomy.  The watchdog's served fallback
is held to ``holo_tpu``'s scalar oracle bit for bit.
"""

import threading
import time

import numpy as np
import pytest

from holo_tpu.spf import synth as jsynth
from holo_tpu.spf.backend import ScalarSpfBackend as JScalar
from holo_tpu_torch import pipeline
from holo_tpu_torch.pipeline.dispatch import (
    AsyncSpfBackend,
    DispatchPipeline,
    PipelineClosed,
    _guarded_launch,
)
from holo_tpu_torch.resilience import overload
from holo_tpu_torch.resilience.breaker import CircuitBreaker
from holo_tpu_torch.resilience.faults import FaultInjector, FaultPlan, InjectedFault, inject
from holo_tpu_torch.resilience.watchdog import (
    DispatchWatchdog,
    WatchdogTimeout,
    configure_process_watchdog,
    process_watchdog,
    reset_process_watchdog,
)
from holo_tpu_torch.spf import synth as tsynth
from holo_tpu_torch.spf.backend import TorchSpfBackend

FIELDS = ("dist", "parent", "hops", "nexthop_words")
KW = dict(n_routers=24, n_networks=6, extra_p2p=30)
WAIT = 30.0


@pytest.fixture(autouse=True)
def _clean_process_state():
    yield
    reset_process_watchdog()
    pipeline.reset_process_pipeline()
    overload.configure_retry(None)


@pytest.fixture
def closing():
    """Pipelines made in a test, closed after it (blockers released)."""
    made = []

    def make(**kw):
        release = threading.Event()
        pipe = DispatchPipeline(**kw)
        made.append((pipe, release))
        return pipe, release

    yield make
    for pipe, release in made:
        release.set()
        pipe.close()


def _occupy(pipe, release):
    """Park the worker inside a blocker run: later submits queue behind it."""
    started = threading.Event()
    t = pipe.submit(("blocker", 0), "one", run=lambda: (started.set(), release.wait(WAIT)))
    assert started.wait(5), "worker never picked up the blocker"
    return t


def _release(inj, pipe, wd=None):
    """Free the wedged thread, stop the watchdog and close the pipeline, then
    join every worker thread it ever had: a disowned worker must not pass a
    later test's seams."""
    inj.release_hangs()
    if wd is not None:
        wd.stop()
    pipe.close()
    for t in threading.enumerate():
        if t.name == f"holo-pipeline-{pipe.name}":
            t.join(WAIT)


class _FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


# -- priority admission and shedding


def test_class_aware_dequeue_correctness_first_fifo_within_rank(closing):
    pipe, release = closing(depth=1, capacity=16)
    _occupy(pipe, release)
    order = []
    tickets = [pipe.submit((tag, 0), "one", run=lambda tag=tag: order.append(tag), cls=cls)
               for tag, cls in (("bg", "background"), ("a1", "advisory"), ("c1", "correctness"),
                                ("a2", "advisory"), ("c2", "correctness"))]
    release.set()
    for t in tickets:
        t.result(timeout=WAIT)
    assert order == ["c1", "c2", "a1", "a2", "bg"]


@pytest.mark.parametrize("kw,match", [
    ({"cls": "bogus"}, "unknown ticket class"),
    ({"deadline": 1.0}, "deadline"),
    ({"run": None, "launch": lambda: None}, "run=... OR"),
])
def test_submit_rejects_bad_tickets(closing, kw, match):
    pipe, _ = closing(depth=1)
    with pytest.raises(ValueError, match=match):
        pipe.submit(("k", 0), "one", **{"run": lambda: None, **kw})


def test_full_queue_sheds_worst_class_first(closing):
    pipe, release = closing(depth=1, capacity=2)
    _occupy(pipe, release)
    done = []
    bg = pipe.submit(("bg", 0), "one", run=lambda: done.append("bg"), cls="background")
    a1 = pipe.submit(("a1", 0), "one", run=lambda: done.append("a1"), cls="advisory")
    a2 = pipe.submit(("a2", 0), "one", run=lambda: done.append("a2"), cls="advisory")
    assert bg.shed == "capacity" and bg.skipped and bg.result(timeout=1) is None
    bg2 = pipe.submit(("bg2", 0), "one", run=lambda: done.append("bg2"), cls="background")
    assert bg2.shed == "capacity" and bg2.skipped
    c1 = pipe.submit(("c1", 0), "one", run=lambda: done.append("c1"))
    assert a1.shed == "capacity"
    release.set()
    c1.result(timeout=WAIT)
    a2.result(timeout=WAIT)
    st = pipe.stats()
    assert st["sheds"] == 3 and st["shed-by-class"] == {"background": 2, "advisory": 1}
    assert st["shed-by-reason"] == {"capacity": 3}
    assert "c1" in done and "a2" in done and "bg" not in done and "a1" not in done


def test_correctness_blocks_bounded_when_queue_all_correctness(closing):
    pipe, release = closing(depth=1, capacity=1)
    _occupy(pipe, release)
    first = pipe.submit(("c0", 0), "one", run=lambda: "c0")
    admitted, out = threading.Event(), {}

    def submitter():
        out["ticket"] = pipe.submit(("c1", 0), "one", run=lambda: "c1")
        admitted.set()

    threading.Thread(target=submitter, daemon=True).start()
    assert not admitted.wait(0.4), "a correctness submit must block, not shed"
    release.set()
    assert admitted.wait(WAIT)
    assert out["ticket"].result(timeout=WAIT) == "c1" and first.result(timeout=WAIT) == "c0"
    assert pipe.stats()["shed-by-class"].get("correctness", 0) == 0


def test_close_wakes_capacity_blocked_submitter_with_pipeline_closed(closing):
    pipe, release = closing(depth=1, capacity=1)
    _occupy(pipe, release)
    pipe.submit(("c0", 0), "one", run=lambda: None)
    failed, out = threading.Event(), {}

    def submitter():
        try:
            pipe.submit(("c1", 0), "one", run=lambda: None)
        except PipelineClosed as exc:
            out["exc"] = exc
            failed.set()

    threading.Thread(target=submitter, daemon=True).start()
    time.sleep(0.2)
    assert not failed.is_set()
    release.set()
    pipe.close(timeout=WAIT)
    assert failed.wait(5) and isinstance(out["exc"], PipelineClosed)
    with pytest.raises(PipelineClosed):
        pipe.submit(("c2", 0), "one", run=lambda: None)


@pytest.mark.parametrize("own_deadline", [True, False])
def test_advisory_deadline_expires_at_dequeue(closing, own_deadline):
    """An advisory ticket whose deadline (its own, or the pipeline's
    ``advisory_deadline``) lapsed while it queued is shed at dequeue;
    correctness behind it runs."""
    clk = _FakeClock()
    pipe, release = closing(depth=1, capacity=8, clock=clk,
                            advisory_deadline=None if own_deadline else 2.0)
    _occupy(pipe, release)
    done = []
    adv = pipe.submit(("a", 0), "one", run=lambda: done.append("a"), cls="advisory",
                      **({"deadline": 5.0} if own_deadline else {}))
    c = pipe.submit(("c", 0), "one", run=lambda: done.append("c"))
    clk.t = 100.0
    release.set()
    c.result(timeout=WAIT)
    assert adv.result(timeout=WAIT) is None and adv.shed == "expired" and adv.skipped
    assert done == ["c"]
    assert pipe.stats()["shed-by-class"] == {"advisory": 1}


def test_disarmed_path_never_reads_poisoned_clock(closing):
    def poisoned():
        raise AssertionError("deadline clock read on the disarmed path")

    pipe, _ = closing(depth=2, capacity=4, clock=poisoned)
    tickets = [pipe.submit(("k", i), "one", run=lambda i=i: i, cls=cls)
               for i, cls in enumerate(("correctness", "advisory", "background", "correctness"))]
    for i, t in enumerate(tickets):
        assert t.result(timeout=WAIT) == i
    assert pipe.stats()["sheds"] == 0


def test_advisory_flood_sheds_only_advisory(closing):
    """An advisory storm beside correctness dispatches sheds only
    advisory tickets, and every correctness result equals the flood-free
    control."""
    topos = [tsynth.random_ospf_topology(seed=60 + i, **KW) for i in range(6)]
    control = [TorchSpfBackend(device="cpu").compute(t) for t in topos]
    pipe, _ = closing(depth=2, capacity=8)
    be = AsyncSpfBackend(TorchSpfBackend(device="cpu"), pipe)
    got = []
    for j, t in enumerate(topos):
        for i in range(24):  # an advisory storm: sheds, never blocks
            pipe.submit(("flood", j, i), "chaos.flood", run=lambda: None, cls="advisory")
        got.append(be.compute(t))
    for g, w in zip(got, control):
        g = g._ticket.result(timeout=WAIT)
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f))
    pipe.drain(timeout=WAIT)
    st = pipe.stats()
    assert st["shed-by-class"].get("advisory", 0) > 0
    assert st["shed-by-class"].get("correctness", 0) == 0


# -- the hung-dispatch watchdog


@pytest.mark.parametrize("phase", ["launch", "finish"])
def test_watchdog_hang_serves_bit_identical_fallback_on_the_cpu(phase):
    """A wedged launch or finish on the CPU with no iteration cap: the
    watchdog abandons it, the oracle serves the ticket bit for bit (held to
    holo_tpu's), the breaker takes the hang (circuit open), and a respawned
    worker keeps serving."""
    tt = tsynth.random_ospf_topology(seed=11, **KW)
    ref = JScalar().compute(jsynth.random_ospf_topology(seed=11, **KW))
    pipe = pipeline.configure_process_pipeline(depth=2)
    br = CircuitBreaker(f"watchdog-hang-{phase}", failure_threshold=1, recovery_timeout=1e9)
    be = pipeline.wrap_spf_backend(TorchSpfBackend(device="cpu", breaker=br))
    wd = configure_process_watchdog(pipe, interval=0.05, floor=0.5)
    assert process_watchdog() is wd
    plan = FaultPlan(seed=1, dispatch_hang={f"pipeline.{phase}": 30.0})
    with inject(FaultInjector(plan)) as inj:
        try:
            res = be.compute(tt)._ticket.result(timeout=WAIT)
            for f in FIELDS:
                np.testing.assert_array_equal(getattr(res, f), getattr(ref, f))
            assert inj.injected[f"hang:pipeline.{phase}"] == 1 and wd.hangs == 1
            assert br.state == "open" and br.last_error.startswith("hang:")
            snap = br.snapshot()
            assert snap["failures"] == {"hang": 1} and snap["fallbacks"] == {"hang": 1}
            st = pipe.stats()
            assert st["hangs"] == 1 and st["worker-respawns"] >= 1
            # The respawned worker owns the queue: more work flows.
            assert pipe.submit(("k", 1), "one", run=lambda: 2).result(timeout=WAIT) == 2
            assert pipe.stats()["max-inflight-per-key"] <= 1
        finally:
            _release(inj, pipe, wd)


def test_watchdog_hang_fails_the_ticket_without_a_fallback():
    """The card rule: with no fallback (``max_iters`` set), a hung dispatch
    fails its ticket with WatchdogTimeout, counted as a hang, never served
    from the oracle."""
    tt = tsynth.random_ospf_topology(seed=12, **KW)
    pipe = DispatchPipeline(depth=2, name="wd-card-rule")
    br = CircuitBreaker("watchdog-card-rule", failure_threshold=3, recovery_timeout=1e9)
    be = AsyncSpfBackend(TorchSpfBackend(device="cpu", max_iters=5, breaker=br), pipe)
    wd = DispatchWatchdog(pipe, interval=0.05, budgets={"spf.one": 0.5}).start()
    plan = FaultPlan(seed=2, dispatch_hang={"pipeline.launch": 30.0})
    with inject(FaultInjector(plan)) as inj:
        try:
            res = be.compute(tt)
            with pytest.raises(WatchdogTimeout):
                res._ticket.result(timeout=WAIT)
            snap = br.snapshot()
            assert snap["failures"] == {"hang": 1} and not snap["fallbacks"]
            assert wd.stats()["hangs"] == 1 and wd.budget("spf.one") == 0.5
        finally:
            _release(inj, pipe, wd)


def test_watchdog_check_is_noop_without_overrun(closing):
    pipe, _ = closing(depth=1, name="wd-quiet")
    wd = DispatchWatchdog(pipe, interval=0.05, floor=5.0)
    assert wd.budget("spf.one") == 5.0
    assert wd.check() is False
    assert pipe.submit(("k", 0), "one", run=lambda: 7).result(timeout=WAIT) == 7
    assert wd.check() is False and wd.hangs == 0


# -- worker kills


def test_worker_kill_respawns_and_queued_tickets_survive(closing):
    pipe, _ = closing(depth=2, capacity=16, name="kill-test")
    with inject(FaultInjector(FaultPlan(seed=3, worker_kill={"pipeline.worker": 1}))) as inj:
        tickets = [pipe.submit(("k", i), "one", run=lambda i=i: i * i) for i in range(6)]
        for i, t in enumerate(tickets):
            assert t.result(timeout=WAIT) == i * i
        assert inj.injected["kill:pipeline.worker"] == 1
    pipe.drain(timeout=WAIT)
    st = pipe.stats()
    assert st["worker-crashes"] == 1 and st["worker-respawns"] >= 1
    assert st["max-inflight-per-key"] <= 1


def test_worker_crash_marshals_through_on_worker_crash(closing):
    """A crash seam set on the pipeline receives the worker's death; its
    respawn() brings a fresh worker over the surviving queue."""
    pipe, _ = closing(depth=2, name="crash-seam")
    seen = []
    pipe.on_worker_crash = seen.append
    assert pipe.submit(("k", 0), "one", run=lambda: 1).result(timeout=WAIT) == 1
    with inject(FaultInjector(FaultPlan(seed=3, worker_kill={"pipeline.worker": 1}))):
        deadline = time.monotonic() + WAIT
        while not seen and time.monotonic() < deadline:
            time.sleep(0.01)
    assert len(seen) == 1 and isinstance(seen[0], InjectedFault)
    assert pipe.respawn()
    assert pipe.submit(("k", 1), "one", run=lambda: 2).result(timeout=WAIT) == 2
    assert pipe.stats()["worker-respawns"] >= 1


# -- the transient-retry taxonomy


def _retry_policy():
    overload.configure_retry(overload.RetryPolicy(retries=1, base_delay=0.0, jitter=0.0))


@pytest.mark.parametrize("fallback", [True, False])
def test_transient_error_retried_before_breaker_counts(fallback):
    _retry_policy()
    br = CircuitBreaker(f"retry-transient-{fallback}", failure_threshold=3, recovery_timeout=1e9)
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) == 1:
            raise OSError("connection reset by peer")
        return "handle"

    before = overload.RETRIES["recovered"]
    verdict, guard, handle = _guarded_launch(br, "test.flaky", flaky,
                                             (lambda: None) if fallback else None)
    assert verdict == "ok" and handle == "handle" and len(calls) == 2
    assert br.consecutive_failures == 0 and br.state == "closed"
    assert overload.RETRIES["recovered"] == before + 1
    guard.success()


def test_deterministic_error_goes_straight_to_fallback_or_reraises():
    """Not retried: one call, one strike.  With a fallback the verdict is
    ``fallback``; without one (the card) the error re-raises, counted."""
    _retry_policy()
    br = CircuitBreaker("retry-deterministic", failure_threshold=3, recovery_timeout=1e9)
    calls = []

    def broken():
        calls.append(1)
        raise RuntimeError("dimension mismatch in gather")

    verdict, _guard, handle = _guarded_launch(br, "test.broken", broken, lambda: None)
    assert verdict == "fallback" and handle is None and len(calls) == 1
    with pytest.raises(RuntimeError, match="dimension mismatch"):
        _guarded_launch(br, "test.broken", broken)
    assert len(calls) == 2 and br.consecutive_failures == 2
    assert br.snapshot()["fallbacks"] == {"exception": 1}


def test_transient_exhaustion_still_strikes_breaker():
    _retry_policy()
    br = CircuitBreaker("retry-exhausted", failure_threshold=3, recovery_timeout=1e9)
    calls = []

    def down():
        calls.append(1)
        raise OSError("UNAVAILABLE: relay endpoint down")

    before = overload.RETRIES["exhausted"]
    verdict, _guard, _handle = _guarded_launch(br, "test.down", down, lambda: None)
    assert verdict == "fallback" and len(calls) == 2 and br.consecutive_failures == 1
    assert overload.RETRIES["exhausted"] == before + 1


def test_is_transient_classification():
    assert overload.is_transient(OSError("boom"))
    assert overload.is_transient(RuntimeError("DEADLINE_EXCEEDED: slow"))
    assert overload.is_transient(RuntimeError("the launch timed out and was terminated"))
    assert not overload.is_transient(RuntimeError("bad gather shape"))
    assert not overload.is_transient(InjectedFault("forced failure"))


def test_retry_backoff_is_deterministic_and_jittered():
    p = overload.RetryPolicy(retries=2, base_delay=0.1, jitter=0.5)
    a, b, c = p.backoff("spf.one", 1), p.backoff("spf.one", 1), p.backoff("spf.one", 2)
    assert a == b and 0.1 <= a <= 0.15 and c >= 0.2
    assert overload.RetryPolicy(jitter=0.0).backoff("x", 3) == 0.05 * 4
