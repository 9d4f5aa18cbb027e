"""Device-dispatch circuit breaker.

The port's copy of ``holo_tpu.resilience.breaker``.  The device dispatch
in ``spf/backend.py`` and ``frr/manager.py`` is where the CUDA runtime can
fail underneath a routing computation.  The breaker counts those failures
and stops a failing device from being tried on every dispatch:

- **closed**: dispatches run on the device; a device failure (an exception
  outside :data:`_PASSTHROUGH`) counts, and ``failure_threshold``
  consecutive failures open the circuit.
- **open**: dispatches do not try the device until ``recovery_timeout``
  elapses.
- **half-open**: exactly one probe dispatch is allowed through; success
  closes the circuit, failure re-opens it.

What serves a dispatch the device did not is the caller's choice.  With a
``fallback`` (the scalar oracle, where it computes the same bits as the
device path: the CPU path with no iteration cap), the fallback serves it;
without one (tensors on the card, whose work the host oracle cannot do in
the same time), the device failure re-raises once counted and an open
circuit raises :class:`CircuitOpen`.

The counts are ``holo_tpu``'s metrics (``holo_resilience_breaker_state``,
``_transitions_total``, ``_failures_total`` and ``holo_resilience_fallback_
total``), and the breaker also keeps them (``failures``, ``fallbacks`` and
``refusals`` by cause, in :meth:`snapshot`), as do process-wide tallies by
breaker name (:func:`tallies`), which outlive the breaker; refusals, a card
dispatch refused with no fallback, have no ``holo_tpu`` series.  The causes: ``exception`` (a guarded dispatch
raised), ``open`` (the circuit refused it) and ``hang`` (the pipeline's
watchdog abandoned it, :meth:`CircuitBreaker.force_failure`).  State mutates
under an owning lock; the primary and fallback callables run outside it.

The split-phase guard (:meth:`CircuitBreaker.split`, :class:`SplitGuard`)
unbundles :meth:`CircuitBreaker.call` for the dispatch pipeline's launch and
finish phases under the same rule: the caller says whether a fallback
serves, and the guard counts a fallback or a refusal accordingly.

Every state transition is a ``breaker`` event in the flight recorder's ring
(:mod:`holo_tpu_torch.telemetry.flight`; no-ops while it is disarmed), and
the open transition is a postmortem trigger, emitted outside the breaker's
lock.

The deadline budget and the process-wide defaults are ``holo_tpu``'s
(:data:`DEFAULTS`, :func:`configure_defaults`: a daemon's ``[resilience]``
section sets them at boot, for the breakers the engines build without
explicit parameters).  A guarded dispatch that completes after ``deadline``
(in ``clock`` units, launch to finish for a split guard) counts a
``deadline`` failure.  With a fallback the completed result is kept, as in
``holo_tpu``; without one (the card) the overrun re-raises as
:class:`DeadlineOverrun` once counted, and no oracle runs.
"""

from __future__ import annotations

import logging
import threading
import time
import weakref
from collections import Counter
from typing import Callable

from holo_tpu_torch import telemetry
from holo_tpu_torch.analysis.runtime import DonatedBufferError
from holo_tpu_torch.kernels.build import KernelBuildError
from holo_tpu_torch.telemetry import flight

log = logging.getLogger("holo_tpu_torch.resilience.breaker")

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half-open"

# Live breakers by name; weak values so short-lived backends (tests, chip
# runs) do not accumulate.  The lock guards the name-uniquify + insert pair.
_REGISTRY: "weakref.WeakValueDictionary[str, CircuitBreaker]" = weakref.WeakValueDictionary()
_REGISTRY_LOCK = threading.Lock()
# (breaker name, "failures" | "fallbacks" | "refusals", cause) -> count.
_TALLIES: Counter = Counter()

_STATE_CODE = {CLOSED: 0, OPEN: 1, HALF_OPEN: 2}
_STATE = telemetry.gauge(
    "holo_resilience_breaker_state",
    "Dispatch circuit-breaker state (0=closed, 1=open, 2=half-open)", ("breaker",))
_TRANSITIONS = telemetry.counter(
    "holo_resilience_breaker_transitions_total", "Breaker state transitions by target state",
    ("breaker", "to"))
_FAILURES = telemetry.counter(
    "holo_resilience_breaker_failures_total", "Guarded dispatch failures by cause",
    ("breaker", "cause"))
_FALLBACKS = telemetry.counter(
    "holo_resilience_fallback_total", "Dispatches served by the scalar oracle instead of the device",
    ("breaker", "cause"))
# The tallies' kinds that holo_tpu exports (refusals are the port's own: a
# card dispatch with no fallback).
_FAMILY = {"failures": _FAILURES, "fallbacks": _FALLBACKS}


def breakers() -> dict[str, "CircuitBreaker"]:
    """Snapshot of live breakers by name."""
    return dict(_REGISTRY)


def tallies() -> dict[tuple[str, str, str], int]:
    """Failures, fallbacks and refusals of every breaker built in this
    process, dead or alive: (breaker name, kind, cause) -> count."""
    with _REGISTRY_LOCK:
        return dict(_TALLIES)


class CircuitOpen(RuntimeError):
    """A dispatch with no fallback was refused: the circuit is open."""


class DeadlineOverrun(RuntimeError):
    """A guarded dispatch finished but blew its deadline budget."""


# Process-wide defaults for breakers built without explicit parameters: the
# engines build theirs internally, so a daemon's [resilience] section lands
# here at boot.
_UNSET = object()
DEFAULTS = {"failure_threshold": 3, "recovery_timeout": 30.0, "deadline": None}


def configure_defaults(failure_threshold: int | None = None,
                       recovery_timeout: float | None = None, deadline=_UNSET) -> None:
    """Update the process-wide breaker defaults (boot only: breakers already
    built keep their parameters)."""
    if failure_threshold is not None:
        DEFAULTS["failure_threshold"] = int(failure_threshold)
    if recovery_timeout is not None:
        DEFAULTS["recovery_timeout"] = float(recovery_timeout)
    if deadline is not _UNSET:
        DEFAULTS["deadline"] = deadline


# Exception types that are never how a device failure presents at this
# boundary: programming or input errors (``ValueError`` is what the kernel
# wrappers raise for inputs split across devices, of the wrong type or
# shape), a kernel library that does not build, and the donation guard's
# verdict (a use-after-donate is an ordering bug, not a device failure).
# They re-raise without counting: a fallback would either hit the same bug
# or hide a missing card path behind a healthy-looking result.
_PASSTHROUGH = (TypeError, AttributeError, NameError, IndexError, KeyError, ValueError,
                KernelBuildError, DonatedBufferError)


class CircuitBreaker:
    """Guard one dispatch site; see the module docstring for the FSM."""

    def __init__(self, name: str, failure_threshold: int | None = None,
                 recovery_timeout: float | None = None, deadline=_UNSET,
                 clock: Callable[[], float] = time.monotonic):
        """Two breakers never share a name: a taken name gets a ``#n``
        suffix.  ``deadline`` is a dispatch's budget in ``clock`` units
        (None: no budget); ``clock`` is injectable so tests drive recovery
        and overruns deterministically.  Parameters left unset take the
        process-wide :data:`DEFAULTS`."""
        with _REGISTRY_LOCK:
            base, n = name, 2
            while name in _REGISTRY:
                name = f"{base}#{n}"
                n += 1
            self.name = name
            _REGISTRY[name] = self
        self.failure_threshold = int(failure_threshold if failure_threshold is not None
                                     else DEFAULTS["failure_threshold"])
        self.recovery_timeout = float(recovery_timeout if recovery_timeout is not None
                                      else DEFAULTS["recovery_timeout"])
        self.deadline = DEFAULTS["deadline"] if deadline is _UNSET else deadline
        self._clock = clock
        self._lock = threading.Lock()
        self.state = CLOSED
        self.consecutive_failures = 0
        self.last_error: str | None = None
        self._open_until = 0.0
        self._probing = False
        self.failures: Counter = Counter()  # cause -> guarded failures
        self.fallbacks: Counter = Counter()  # cause -> dispatches the fallback served
        self.refusals: Counter = Counter()  # cause -> dispatches refused (no fallback)
        _STATE.labels(breaker=name).set(_STATE_CODE[CLOSED])
        # No series removal in the registry: a breaker that dies open must
        # not leave an "open" gauge behind.
        weakref.finalize(self, _STATE.labels(breaker=name).set, _STATE_CODE[CLOSED])

    # -- bookkeeping

    def _count(self, kind: str, cause: str) -> None:
        with _REGISTRY_LOCK:
            getattr(self, kind)[cause] += 1
            _TALLIES[(self.name, kind, cause)] += 1
        fam = _FAMILY.get(kind)
        if fam is not None:
            fam.labels(breaker=self.name, cause=cause).inc()

    def _transition_locked(self, to: str) -> None:
        self.state = to
        _STATE.labels(breaker=self.name).set(_STATE_CODE[to])
        _TRANSITIONS.labels(breaker=self.name, to=to).inc()
        if to == OPEN:
            self._open_until = self._clock() + self.recovery_timeout

    def _emit(self, to: str) -> None:
        """A transition's flight-recorder forensics (outside the lock: the
        postmortem reads every breaker's snapshot)."""
        flight.event("breaker", breaker=self.name, to=to)
        if to == OPEN:
            flight.trigger(f"breaker-open:{self.name}",
                           extra={"last-error": self.last_error or ""})

    def _admit(self) -> bool:
        """Whether this call may try the device (closed, or the single
        half-open probe)."""
        emit = False
        with self._lock:
            if self.state == OPEN and self._clock() >= self._open_until:
                self._transition_locked(HALF_OPEN)
                self._probing = False
                emit = True
            if self.state == CLOSED:
                admitted = True
            elif self.state == HALF_OPEN and not self._probing:
                self._probing = True
                admitted = True
            else:
                admitted = False
        if emit:
            self._emit(HALF_OPEN)
        return admitted

    def _on_failure(self, context: str, error: BaseException, cause: str = "exception") -> None:
        opened = False
        with self._lock:
            self.consecutive_failures += 1
            self.last_error = f"{context or 'dispatch'}: {error!r}"
            if self.state == HALF_OPEN:
                # The probe failed: back to open for a fresh timeout.
                self._probing = False
                self._transition_locked(OPEN)
                opened = True
            elif self.state == CLOSED and self.consecutive_failures >= self.failure_threshold:
                self._transition_locked(OPEN)
                opened = True
        self._count("failures", cause)
        if opened:
            self._emit(OPEN)
            log.error("breaker %s OPEN after %d consecutive failures (%s) for %.1fs",
                      self.name, self.consecutive_failures, self.last_error,
                      self.recovery_timeout)
        else:
            log.warning("breaker %s: dispatch failure %d/%d (%s)", self.name,
                        self.consecutive_failures, self.failure_threshold, self.last_error)

    def _abort_probe(self) -> None:
        """An admitted call exited without a device verdict (a passthrough
        exception or an interrupt): release the half-open probe slot so the
        next call may probe again."""
        with self._lock:
            self._probing = False

    def _on_success(self) -> None:
        restored = False
        with self._lock:
            self.consecutive_failures = 0
            if self.state != CLOSED:
                self._probing = False
                self._transition_locked(CLOSED)
                restored = True
        if restored:
            self._emit(CLOSED)
            log.info("breaker %s: probe dispatch succeeded, device service restored",
                     self.name)

    def force_failure(self, cause: str, error: BaseException, served: bool = False) -> None:
        """Count a failure that raised nothing through a guard: a hung
        dispatch the watchdog abandoned (cause ``hang``) is a device failure
        all the same.  The FSM moves as for a guarded exception; ``served``
        (a fallback serves the dispatch) also counts the fallback."""
        self._on_failure(cause, error, cause)
        if served:
            self._count("fallbacks", cause)

    # -- the guard

    def call(self, primary: Callable, fallback: Callable | None, context: str = ""):
        """Run ``primary`` under the breaker.  On a device failure or an
        open circuit, ``fallback`` serves the dispatch; with no fallback the
        failure re-raises (counted) and an open circuit raises
        :class:`CircuitOpen`.  A deadline overrun counts a failure and keeps
        the completed result, or with no fallback raises
        :class:`DeadlineOverrun`."""
        if not self._admit():
            if fallback is None:
                self._count("refusals", "open")
                raise CircuitOpen(f"breaker {self.name} is open ({self.last_error}); "
                                  f"{context or 'the dispatch'} was not tried")
            self._count("fallbacks", "open")
            return fallback()
        t0 = self._clock()
        try:
            result = primary()
        except _PASSTHROUGH:
            # A bug or a missing kernel library, not a device failure: never
            # mask it, but release the probe slot.
            self._abort_probe()
            raise
        except Exception as exc:
            self._on_failure(context, exc)
            if fallback is None:
                raise
            self._count("fallbacks", "exception")
            return fallback()
        except BaseException:
            self._abort_probe()
            raise
        self._settle(t0, context, fallback is not None)
        return result

    def _settle(self, t0: float, context: str, served: bool) -> None:
        """A completed dispatch's verdict: a success, or a ``deadline``
        failure when it took longer than the budget, which re-raises unless
        a fallback could have served (the completed result is kept)."""
        elapsed = self._clock() - t0
        if self.deadline is None or elapsed <= self.deadline:
            self._on_success()
            return
        err = DeadlineOverrun(f"{elapsed:.3f}s > {self.deadline}s")
        self._on_failure(context, err, "deadline")
        if not served:
            raise err

    def split(self, context: str = "", fallback: bool = False) -> "SplitGuard":
        """:meth:`call` unbundled for a two-phase (launch, finish) dispatch:
        the guard admits at launch, and either phase reports a failure or the
        finish a success.  ``fallback``: whether the caller serves a refused
        or failed dispatch from a fallback, which decides what is counted;
        the caller runs it (``pipeline/dispatch.py``)."""
        return SplitGuard(self, context, fallback)

    def snapshot(self) -> dict:
        """Health view: state, streak, parameters, counts by cause."""
        with self._lock:
            return {
                "state": self.state,
                "consecutive-failures": self.consecutive_failures,
                "failure-threshold": self.failure_threshold,
                "recovery-timeout": self.recovery_timeout,
                "last-error": self.last_error or "",
                "failures": dict(self.failures),
                "fallbacks": dict(self.fallbacks),
                "refusals": dict(self.refusals),
            }


class SplitGuard:
    """One guarded dispatch split across two phases (see
    :meth:`CircuitBreaker.split`).

    Construct (admits or refuses), then exactly one of :meth:`failure`,
    :meth:`success` or :meth:`abort`.  ``admitted`` False means the circuit
    is open: the refusal (no fallback) or the ``open`` fallback is already
    counted, and the caller raises :class:`CircuitOpen` or serves the
    fallback.
    """

    __slots__ = ("breaker", "context", "fallback", "admitted", "_settled", "_t0")

    def __init__(self, breaker: CircuitBreaker, context: str = "", fallback: bool = False):
        self.breaker = breaker
        self.context = context
        self.fallback = fallback
        self._t0 = breaker._clock()
        self.admitted = breaker._admit()
        self._settled = not self.admitted
        if not self.admitted:
            breaker._count("fallbacks" if fallback else "refusals", "open")

    def refused(self) -> CircuitOpen:
        """The error a refused dispatch with no fallback raises."""
        b = self.breaker
        return CircuitOpen(f"breaker {b.name} is open ({b.last_error}); "
                           f"{self.context or 'the dispatch'} was not tried")

    def failure(self, exc: BaseException, cause: str = "exception") -> None:
        """A phase failed with a device error: count it, and the fallback
        where one serves."""
        if self._settled:
            return
        self._settled = True
        self.breaker._on_failure(self.context, exc, cause)
        if self.fallback:
            self.breaker._count("fallbacks", cause)

    def abort(self) -> None:
        """A passthrough exception escaped with no device verdict: release
        the half-open probe slot, count nothing."""
        if self._settled:
            return
        self._settled = True
        self.breaker._abort_probe()

    def success(self) -> None:
        """Both phases completed.  The deadline spans launch through finish,
        the window :meth:`CircuitBreaker.call` measures; an overrun with no
        fallback raises :class:`DeadlineOverrun` once counted."""
        if self._settled:
            return
        self._settled = True
        self.breaker._settle(self._t0, self.context, self.fallback)
