"""The port's telemetry: a process-wide metrics registry and span tracer
(``holo_tpu.telemetry``'s surface, on the port's own copies).

One import surface for every instrumentation site::

    from holo_tpu_torch import telemetry

    _DISPATCHES = telemetry.counter(
        "holo_spf_dispatch_total", "SPF device dispatches", ("engine",))
    _DISPATCHES.labels(engine="torch").inc()

    with telemetry.span("spf.dispatch", kind="one"):
        ...

The metric names and label sets are ``holo_tpu``'s, so one dashboard reads
either package.  The two packages keep separate registries: a process that
imports both (the parity tests) holds two of them, each counting its own
package's dispatches.

Exports: :func:`holo_tpu_torch.telemetry.prometheus.render_text` (the
Prometheus 0.0.4 / OpenMetrics text; the HTTP endpoint is the daemon's),
Chrome trace-event JSON span dumps (:mod:`holo_tpu_torch.telemetry.trace`)
and ``HOLO_TPU_TORCH_TRACE_DUMP=<path>``, which dumps the default tracer at
process exit (an env name of its own, so that the two packages never dump
into one file).  Per-dispatch stage timing is
:mod:`holo_tpu_torch.telemetry.profiling`, the device-residency ledger
:mod:`holo_tpu_torch.telemetry.residency`.

The dispatch analytics, each off by default and one module-global check a
seam while disarmed: the flight recorder
(:mod:`~holo_tpu_torch.telemetry.flight`), the convergence tracker
(:mod:`~holo_tpu_torch.telemetry.convergence`), the dispatch observatory
(:mod:`~holo_tpu_torch.telemetry.observatory`, whose roofline join reads the
kernel wrappers' work tallies through ``profiling.record_cost``), the
critical-path ledger (:mod:`~holo_tpu_torch.telemetry.critpath`) and the SLO
engine (:mod:`~holo_tpu_torch.telemetry.slo`).  Arm them in this order::

    flight.configure(entries=4096, postmortem_dir=tmp)
    convergence.configure(capacity=512)
    observatory.configure(check_every=0, ledger_path=tmp / "ledger.json")
    critpath.configure(capacity=1024)
    slo.configure()

Everything here is stdlib-only and import-light: an instrumented dispatch
pays a dict hit and a locked float add per event, and :func:`set_enabled`
(False) turns every update into an early return.
"""

from __future__ import annotations

import os

from holo_tpu_torch.telemetry import registry as _registry_mod
from holo_tpu_torch.telemetry.registry import (  # noqa: F401 -- public API
    DEFAULT_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    deferred_mean,
    enabled,
    volatile_children,
    write_stamp,
)
from holo_tpu_torch.telemetry.trace import SpanTracer

_registry = MetricsRegistry()
_tracer = SpanTracer()


def set_enabled(on: bool) -> None:
    """Global kill switch for BOTH the metrics registry and the default
    span tracer."""
    _registry_mod.set_enabled(on)
    _tracer.enabled = bool(on)


def registry() -> MetricsRegistry:
    """The process-wide default registry."""
    return _registry


def tracer() -> SpanTracer:
    """The process-wide default span tracer."""
    return _tracer


def counter(name: str, help: str = "", labelnames=(), stamped: bool = True):
    return _registry.counter(name, help, tuple(labelnames), stamped=stamped)


def gauge(name: str, help: str = "", labelnames=(), stamped: bool = True):
    return _registry.gauge(name, help, tuple(labelnames), stamped=stamped)


def histogram(name: str, help: str = "", labelnames=(), buckets=None, stamped: bool = True):
    return _registry.histogram(name, help, tuple(labelnames), buckets, stamped=stamped)


def span(name: str, **attrs):
    """Context manager recording one span on the default tracer."""
    return _tracer.span(name, **attrs)


def current_span_id():
    return _tracer.current_span_id()


def current_instance():
    return _tracer.current_instance()


def snapshot(prefix: str | None = None) -> dict:
    """Flat metrics view (counters/gauges -> number, histograms -> {count,
    sum}); tests compare deltas of two snapshots."""
    return _registry.snapshot(prefix)


_dump_path = os.environ.get("HOLO_TPU_TORCH_TRACE_DUMP")
if _dump_path:  # pragma: no cover -- exercised through a subprocess
    import atexit

    atexit.register(lambda: _tracer.dump(_dump_path))
