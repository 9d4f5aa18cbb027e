"""Overload policy vocabulary: priority classes and the transient-retry
taxonomy (the port's copy of ``holo_tpu.resilience.overload``).

- **priority classes**: every pipeline ticket carries one of
  :data:`CLASSES`.  ``correctness`` is FIB-feeding work (SPF, FRR): it keeps
  the bounded-blocking submit and is never shed.  ``advisory`` is what-if
  traffic: it may carry a submit-time deadline and is shed first under
  overload.  ``background`` ranks below it.  Lower rank is more important;
  the pipeline's dequeue serves the lowest rank first, FIFO within a rank.
- **transient against deterministic failures**: :func:`is_transient` splits
  the device errors worth an immediate retry (a transport reset, a timeout,
  ``cudaErrorLaunchTimeout``-style "timed out" text) from deterministic ones
  (a shape bug, an injected fault), which reproduce identically.  The
  pipeline's ``_guarded_launch`` grants a transient error the policy's
  jittered-backoff retries before the breaker counts it.

Jitter is deterministic, a hash of (context, attempt), so a chaos run
replays exactly.  The retry verdicts count in
``holo_pipeline_transient_retries_total{outcome}`` and in the module's
:data:`RETRIES` (``recovered`` | ``exhausted``).
"""

from __future__ import annotations

import hashlib
from collections import Counter
from dataclasses import dataclass

from holo_tpu_torch import telemetry

_RETRIES = telemetry.counter(
    "holo_pipeline_transient_retries_total",
    "Transient-classified launch failures retried once before the breaker counts, by outcome",
    ("outcome",))

#: ticket classes, most to least important (index = rank)
CLASSES = ("correctness", "advisory", "background")
#: class name -> rank (0 = never shed, keeps the bounded-blocking submit)
CLASS_RANK = {c: i for i, c in enumerate(CLASSES)}

#: retry verdicts by outcome, process-wide
RETRIES: Counter = Counter()

#: lowercase substrings of error text that name a retryable service
#: condition (gRPC-style status names and the socket layer's phrasings).
_TRANSIENT_MARKERS = (
    "unavailable",
    "deadline_exceeded",
    "deadline exceeded",
    "resource_exhausted",
    "resource exhausted",
    "timed out",
    "timeout",
    "connection reset",
    "connection refused",
    "temporarily",
    "transient",
)


def is_transient(exc: BaseException) -> bool:
    """True when ``exc`` looks like a retryable service hiccup.

    OS-level transport errors (``ConnectionError``, ``TimeoutError``, any
    other ``OSError``) are transient by type; everything else is classified
    by its message against :data:`_TRANSIENT_MARKERS`, conservatively: a
    wrong "transient" costs one wasted retry.  ``InjectedFault`` carries none
    of the markers, so chaos plans keep their exact breaker strike counts."""
    if isinstance(exc, OSError):
        return True
    msg = str(exc).lower()
    return any(m in msg for m in _TRANSIENT_MARKERS)


@dataclass(frozen=True)
class RetryPolicy:
    """Backoff budget for transient launch failures; ``retries=0`` turns
    the taxonomy off (every failure counts at once)."""

    retries: int = 1
    base_delay: float = 0.05
    jitter: float = 0.5  # + fraction of the backoff delay (never early)

    def backoff(self, context: str, attempt: int) -> float:
        """Delay before retry ``attempt`` (1-based) at ``context``:
        exponential, with a jitter hashed from (context, attempt)."""
        d = self.base_delay * (2.0 ** (attempt - 1))
        if not self.jitter:
            return d
        h = int.from_bytes(hashlib.sha256(f"{context}:{attempt}".encode()).digest()[:4], "big")
        return d * (1.0 + self.jitter * (h / 0xFFFFFFFF))


_DEFAULT_RETRY = RetryPolicy()


def configure_retry(policy: RetryPolicy | None) -> RetryPolicy:
    """Install the process-wide transient-retry policy (None restores the
    default)."""
    global _DEFAULT_RETRY
    _DEFAULT_RETRY = policy if policy is not None else RetryPolicy()
    return _DEFAULT_RETRY


def default_retry_policy() -> RetryPolicy:
    return _DEFAULT_RETRY


def note_retry(outcome: str) -> None:
    """Tally one retry verdict (``recovered`` | ``exhausted``)."""
    RETRIES[outcome] += 1
    _RETRIES.labels(outcome=outcome).inc()
