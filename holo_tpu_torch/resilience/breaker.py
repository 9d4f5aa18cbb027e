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
``holo_tpu``'s deadline budget (``DeadlineOverrun``, ``configure_defaults``)
is not carried: no caller of the port sets one.
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

    def __init__(self, name: str, failure_threshold: int = 3,
                 recovery_timeout: float = 30.0):
        """Two breakers never share a name: a taken name gets a ``#n``
        suffix."""
        with _REGISTRY_LOCK:
            base, n = name, 2
            while name in _REGISTRY:
                name = f"{base}#{n}"
                n += 1
            self.name = name
            _REGISTRY[name] = self
        self.failure_threshold = int(failure_threshold)
        self.recovery_timeout = float(recovery_timeout)
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
            self._open_until = time.monotonic() + self.recovery_timeout

    def _admit(self) -> bool:
        """Whether this call may try the device (closed, or the single
        half-open probe)."""
        with self._lock:
            if self.state == OPEN and time.monotonic() >= self._open_until:
                self._transition_locked(HALF_OPEN)
                self._probing = False
            if self.state == CLOSED:
                return True
            if self.state == HALF_OPEN and not self._probing:
                self._probing = True
                return True
            return False

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
        :class:`CircuitOpen`."""
        if not self._admit():
            if fallback is None:
                self._count("refusals", "open")
                raise CircuitOpen(f"breaker {self.name} is open ({self.last_error}); "
                                  f"{context or 'the dispatch'} was not tried")
            self._count("fallbacks", "open")
            return fallback()
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
        self._on_success()
        return result

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

    __slots__ = ("breaker", "context", "fallback", "admitted", "_settled")

    def __init__(self, breaker: CircuitBreaker, context: str = "", fallback: bool = False):
        self.breaker = breaker
        self.context = context
        self.fallback = fallback
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
        """Both phases completed."""
        if self._settled:
            return
        self._settled = True
        self.breaker._on_success()
