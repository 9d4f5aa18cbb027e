"""Dispatch resilience of the port: the circuit breaker around the CUDA
device dispatch (``holo_tpu.resilience.breaker``'s counterpart)."""

from holo_tpu_torch.resilience.breaker import (  # noqa: F401 (public API)
    CLOSED,
    HALF_OPEN,
    OPEN,
    CircuitBreaker,
    CircuitOpen,
    breakers,
    tallies,
)
