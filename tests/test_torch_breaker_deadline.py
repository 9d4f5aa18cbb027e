"""The port's breaker deadline and process-wide defaults against
holo_tpu.resilience.breaker, on one injected clock.

- a seeded script of dispatches (fast successes, exceptions, overruns of the
  deadline, clock steps past the recovery timeout) drives both breakers:
  after every step the state, the failure streak and what served the
  dispatch are equal.  With a fallback the port keeps an overrun's result,
  as holo_tpu does; without one (the card) the overrun raises
  DeadlineOverrun once counted, an open circuit raises CircuitOpen, and no
  oracle runs;
- the split-phase guard measures the deadline from launch to finish;
- ``configure_defaults`` reaches the breakers built after it, as holo_tpu's.

Tolerance: exact (states, streaks, counts).
"""

from __future__ import annotations

import numpy as np
import pytest

from holo_tpu.resilience import breaker as jbreaker
from holo_tpu_torch.resilience import breaker as tbreaker
from holo_tpu_torch.resilience.breaker import CircuitOpen, DeadlineOverrun


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


def _script(seed: int, n: int = 80) -> list[str]:
    rng = np.random.default_rng(seed)
    return [str(x) for x in rng.choice(["ok", "fail", "slow", "wait"], n, p=[0.4, 0.2, 0.3, 0.1])]


def _primary(step: str, clock: Clock, deadline: float):
    def fn():
        if step == "fail":
            raise RuntimeError("CUDA error 700 at launch")
        clock.t += deadline * (2.5 if step == "slow" else 0.25)
        return "device"
    return fn


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("served", [True, False], ids=["fallback", "card"])
def test_deadline_fsm_matches_holo_tpu(seed, served):
    deadline, recovery = 1.0, 5.0
    jc, tc = Clock(), Clock()
    jb = jbreaker.CircuitBreaker(f"jdl-{seed}-{served}", failure_threshold=2,
                                 recovery_timeout=recovery, deadline=deadline, clock=jc)
    tb = tbreaker.CircuitBreaker(f"tdl-{seed}-{served}", failure_threshold=2,
                                 recovery_timeout=recovery, deadline=deadline, clock=tc)
    counts = {"deadline": 0, "exception": 0, "open": 0}
    for step in _script(seed):
        if step == "wait":
            jc.t += recovery
            tc.t += recovery
            continue
        want = jb.call(_primary(step, jc, deadline), lambda: "oracle")
        if served:
            got = tb.call(_primary(step, tc, deadline), lambda: "oracle")
        else:
            try:
                got = tb.call(_primary(step, tc, deadline), None, "spf.one")
            except DeadlineOverrun:
                got = "device"  # completed on the device, then raised
                counts["deadline"] += 1
            except CircuitOpen:
                got = "oracle"  # holo_tpu's oracle served; the card refused
                counts["open"] += 1
            except RuntimeError:
                got = "oracle"
                counts["exception"] += 1
        assert (got, tb.state, tb.consecutive_failures) == (
            want, jb.state, jb.consecutive_failures), step
        assert tc.t == jc.t
    snap = tb.snapshot()
    if not served:
        assert snap["failures"] == {k: v for k, v in (("deadline", counts["deadline"]),
                                                      ("exception", counts["exception"])) if v}
        assert snap["fallbacks"] == {}
        assert snap["refusals"] == ({"open": counts["open"]} if counts["open"] else {})
        assert counts["deadline"] and counts["open"]
    else:
        assert snap["refusals"] == {} and "deadline" in snap["failures"]
        # holo_tpu serves no fallback for an overrun: its result is kept.
        assert "deadline" not in snap["fallbacks"]


@pytest.mark.parametrize("served", [True, False], ids=["fallback", "card"])
def test_split_guard_deadline_spans_launch_to_finish(served):
    clock = Clock()
    jc = Clock()
    tb = tbreaker.CircuitBreaker(f"tsplit-{served}", failure_threshold=1, deadline=1.0,
                                 clock=clock)
    jb = jbreaker.CircuitBreaker(f"jsplit-{served}", failure_threshold=1, deadline=1.0,
                                 clock=jc)
    for b, c in ((tb, clock), (jb, jc)):
        g = b.split("spf.one", served) if b is tb else b.split("spf.one")
        assert g.admitted
        c.t += 0.6  # launch
        c.t += 0.6  # finish: 1.2 s > 1.0 s across both phases
        if b is tb and not served:
            with pytest.raises(DeadlineOverrun):
                g.success()
        else:
            g.success()
    assert tb.state == jb.state == "open"
    assert tb.snapshot()["failures"] == {"deadline": 1}
    g = tb.split("spf.one", served)
    assert not g.admitted
    assert tb.snapshot()["fallbacks" if served else "refusals"] == {"open": 1}


def test_configure_defaults_reach_later_breakers_as_holo_tpu():
    saved = (dict(tbreaker.DEFAULTS), dict(jbreaker.DEFAULTS))
    try:
        early = tbreaker.CircuitBreaker("t-defaults-early")
        for mod in (tbreaker, jbreaker):
            mod.configure_defaults(failure_threshold=5, recovery_timeout=2.5, deadline=0.25)
            mod.configure_defaults(recovery_timeout=None)  # None leaves a knob as it is
        assert tbreaker.DEFAULTS == jbreaker.DEFAULTS
        late = tbreaker.CircuitBreaker("t-defaults-late")
        jlate = jbreaker.CircuitBreaker("j-defaults-late")
        for b in (late, jlate):
            assert (b.failure_threshold, b.recovery_timeout, b.deadline) == (5, 2.5, 0.25)
        assert (early.failure_threshold, early.recovery_timeout, early.deadline) == (3, 30.0,
                                                                                   None)
        pinned = tbreaker.CircuitBreaker("t-defaults-pinned", failure_threshold=1, deadline=None)
        assert (pinned.failure_threshold, pinned.deadline) == (1, None)
    finally:
        tbreaker.DEFAULTS.clear()
        tbreaker.DEFAULTS.update(saved[0])
        jbreaker.DEFAULTS.clear()
        jbreaker.DEFAULTS.update(saved[1])
