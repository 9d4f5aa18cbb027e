"""Dispatch resilience of the port (``holo_tpu.resilience``'s counterpart):
the circuit breaker around the CUDA device dispatch and its split-phase
guard, the overload vocabulary (priority classes, transient retries), the
dispatch chaos seams and the hung-dispatch watchdog."""

from holo_tpu_torch.resilience.breaker import (  # noqa: F401 (public API)
    CLOSED,
    HALF_OPEN,
    OPEN,
    DEFAULTS,
    CircuitBreaker,
    CircuitOpen,
    DeadlineOverrun,
    SplitGuard,
    breakers,
    configure_defaults,
    tallies,
)
from holo_tpu_torch.resilience.faults import (  # noqa: F401 (public API)
    FaultInjector,
    FaultPlan,
    InjectedFault,
    inject,
)
from holo_tpu_torch.resilience.watchdog import (  # noqa: F401 (public API)
    DispatchWatchdog,
    WatchdogTimeout,
    configure_process_watchdog,
    process_watchdog,
    reset_process_watchdog,
)
