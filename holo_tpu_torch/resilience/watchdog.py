"""Hung-dispatch watchdog: a wall budget for each in-flight pipeline phase
(the port's copy of ``holo_tpu.resilience.watchdog``).

The breaker counts exceptions; a device call that never returns raises
none, and the pipeline's one worker would block behind it while the bounded
queue walls the submitters.  The watchdog closes that gap:

- the worker stamps ``pipeline._active = (item, phase, since)`` around every
  launch and finish phase (one tuple store, only while a watchdog is armed);
- a sentinel thread compares each stamp's age with the site's budget;
- on an overrun it abandons the phase
  (:meth:`~holo_tpu_torch.pipeline.dispatch.DispatchPipeline.abandon_active`:
  the wedged thread is disowned and exits at its next ownership check, and
  the ticket's key is released), strikes the ticket's breaker with
  :meth:`~holo_tpu_torch.resilience.breaker.CircuitBreaker.force_failure`
  (cause ``hang``), serves the ticket from its fallback where it has one (the
  CPU path with no iteration cap) or fails it with :class:`WatchdogTimeout`
  (the card), and respawns the worker.

The budget is a fixed value per site (``budgets``, else ``floor``): the
dispatch observatory whose p99 sketches calibrate ``holo_tpu``'s comes with
ROADMAP A13b.  Each abandoned phase counts in
``holo_pipeline_watchdog_hangs_total{phase}``, and
``holo_pipeline_watchdog_budget_seconds`` holds the last verdict's budget.  ``Supervisor.watch_worker`` is not ported either: a sentinel or
worker death marshals through ``on_worker_crash`` when set, and respawns
directly otherwise.
"""

from __future__ import annotations

import logging
import threading
import time

from holo_tpu_torch import telemetry

_HANGS = telemetry.counter(
    "holo_pipeline_watchdog_hangs_total",
    "In-flight pipeline phases abandoned by the hung-dispatch watchdog", ("phase",))
_BUDGET = telemetry.gauge(
    "holo_pipeline_watchdog_budget_seconds",
    "Hang budget the watchdog applied on its most recent verdict")

log = logging.getLogger("holo_tpu_torch.resilience.watchdog")


class WatchdogTimeout(RuntimeError):
    """An in-flight launch or finish phase overran its hang budget."""


class DispatchWatchdog:
    """Sentinel for one :class:`DispatchPipeline`.  ``budgets`` maps a
    ticket's site to its hang budget in seconds; any other site gets
    ``floor``.  ``clock`` is injectable for deterministic tests."""

    def __init__(self, pipeline, interval: float = 0.25, floor: float = 5.0,
                 budgets: dict | None = None, clock=time.monotonic):
        self.pipeline = pipeline
        self.interval = float(interval)
        self.floor = float(floor)
        self.budgets = dict(budgets or {})
        self._clock = clock
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.hangs = 0
        self.on_worker_crash = None  # a sentinel crash marshals through it

    @property
    def name(self) -> str:
        return f"watchdog:{self.pipeline.name}"

    def start(self) -> "DispatchWatchdog":
        """Arm the pipeline's phase stamps and spawn the sentinel."""
        self.pipeline.arm_watchdog(self._clock)
        self._spawn()
        return self

    def _spawn(self) -> None:
        self._thread = threading.Thread(target=self._sentinel, name=f"holo-{self.name}",
                                        daemon=True)
        self._thread.start()

    def respawn(self) -> bool:
        """Restart the sentinel unless stopped or already running."""
        if self._stop.is_set():
            return False
        t = self._thread
        if t is not None and t.is_alive() and t is not threading.current_thread():
            return True
        self._spawn()
        return True

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        self.pipeline.disarm_watchdog()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout)

    def _sentinel(self) -> None:
        try:
            while not self._stop.wait(self.interval):
                self.check()
        except BaseException as exc:  # noqa: BLE001 -- the pipeline must not
            # lose its guard silently.
            log.exception("dispatch watchdog %s crashed", self.name)
            cb = self.on_worker_crash
            if cb is not None:
                cb(exc)
            elif not self._stop.is_set():
                self._spawn()

    def budget(self, site: str | None) -> float:
        """The hang budget of ``site``."""
        return float(self.budgets.get(site, self.floor))

    def check(self, now: float | None = None) -> bool:
        """One sentinel pass: True when a hang was declared and served.
        Tests call it directly; the sentinel every ``interval``."""
        active = self.pipeline._active
        if active is None:
            return False
        item, phase, since = active
        if now is None:
            now = self._clock()
        budget = self.budget(item.site)
        if now - since < budget:
            return False
        return self._fire(item, phase, now - since, budget)

    def _fire(self, item, phase: str, age: float, budget: float) -> bool:
        if not self.pipeline.abandon_active(item, phase):
            return False  # the phase completed while we decided
        self.hangs += 1
        _HANGS.labels(phase=phase).inc()
        _BUDGET.set(budget)
        exc = WatchdogTimeout(f"{phase} phase for {item.key}/{item.kind} hung {age:.3f}s "
                              f"(> budget {budget:.3f}s at site {item.site or '-'})")
        log.error("%s", exc)
        if item.breaker is not None:
            # A hang is a device failure: repeated hangs open the circuit.
            item.breaker.force_failure("hang", exc, served=item.fallback is not None)
        # Settle the ticket now; the wedged thread's late completion loses
        # the ticket's first-settler claim.
        if item.fallback is not None:
            try:
                item.ticket._complete(item.fallback())
            except BaseException as fexc:  # noqa: BLE001 -- to the caller
                item.ticket._fail(fexc)
        else:
            item.ticket._fail(exc)
        cb = self.pipeline.on_worker_crash
        if cb is not None:
            cb(exc)
        else:
            self.pipeline.respawn()
        return True

    def stats(self) -> dict:
        return {"pipeline": self.pipeline.name, "interval": self.interval,
                "floor": self.floor, "budgets": dict(self.budgets), "hangs": self.hangs}


_WATCHDOG: DispatchWatchdog | None = None


def configure_process_watchdog(pipeline, **kw) -> DispatchWatchdog:
    """Arm the process-wide watchdog over ``pipeline``; stops any previous
    sentinel first."""
    global _WATCHDOG
    if _WATCHDOG is not None:
        _WATCHDOG.stop()
    _WATCHDOG = DispatchWatchdog(pipeline, **kw).start()
    return _WATCHDOG


def process_watchdog() -> DispatchWatchdog | None:
    return _WATCHDOG


def reset_process_watchdog() -> None:
    """Stop and uninstall the process-wide watchdog."""
    global _WATCHDOG
    if _WATCHDOG is not None:
        _WATCHDOG.stop()
        _WATCHDOG = None
