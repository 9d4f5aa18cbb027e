"""Process-wide metrics registry: counters, gauges, histograms (the port's
copy of ``holo_tpu.telemetry.registry``, stdlib only).

The observability analog of the reference's tokio-console/tracing
instrumentation, shaped for the dispatch hot paths: every metric is a named
family with optional label dimensions; children are created lazily per
label-value tuple and updated under a per-child lock (increments are a
couple of dict hits + a float add, cheap enough for the dispatch path —
gated by :func:`holo_tpu_torch.telemetry.set_enabled` so the overhead bench
can A/B a disabled registry).

Naming convention (documented in COMPONENTS.md):

    holo_<subsystem>_<what>[_<unit>][_total]

e.g. ``holo_spf_dispatch_seconds`` (histogram),
``holo_rib_route_adds_total`` (counter), ``holo_ibus_subscribers``
(gauge).  Counters end in ``_total``; histograms of durations end in
``_seconds`` — both Prometheus conventions, so the text exposition
(:mod:`holo_tpu_torch.telemetry.prometheus`) needs no renaming pass.
"""

from __future__ import annotations

import threading
from typing import Callable, Iterable

# Default histogram buckets: SPF dispatches span ~100us (tiny LSDB,
# warm jit) to minutes (50k-vertex cold compile) — log-spaced seconds.
DEFAULT_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 120.0,
)

_enabled = True

# Leaf-version stamping: every metric write advances a
# process-wide monotonic stamp and records it on the child.  The gNMI
# shared-delta fan-out engine compares stamps instead of re-walking the
# subtree: an unchanged stamp proves the whole registry-backed state
# surface is byte-identical to the previous tick (suppress-redundant
# and heartbeat become epoch comparisons).  A single-element list keeps
# the read-modify-write GIL-atomic enough: racing writers may coalesce
# increments, but the stamp always ADVANCES when anything was written,
# which is the only property the delta engine needs.
_WRITE_STAMP = [0]
# Callback-backed gauges (``set_fn``) change value at COLLECT time with
# no write to stamp — their existence disables the stamp short-circuit.
_VOLATILE = [0]


def write_stamp() -> int:
    """Monotonic stamp of the last registry write (any child)."""
    return _WRITE_STAMP[0]


def volatile_children() -> int:
    """Number of live callback-backed gauge children (their values move
    without a write, so a non-zero count voids the stamp contract)."""
    return _VOLATILE[0]


def _bump_stamp() -> int:
    s = _WRITE_STAMP[0] + 1
    _WRITE_STAMP[0] = s
    return s


# Families registered with ``stamped=False`` update their children
# WITHOUT advancing the global write stamp: the delta engine's own
# bookkeeping (render counters, sample-update tallies) must not re-arm
# the walk it instruments — otherwise every heartbeat served from the
# render cache would wake the next tick's walk, which would see the
# counter leaves changed, advance the epoch, deliver, bump again, and
# never quiesce.  Unstamped children still render on every export
# surface; their changes reach suppress-redundant subscribers
# piggybacked on the next stamped write.


def set_enabled(on: bool) -> None:
    """Global kill switch: disabled metrics become no-ops (the overhead
    bench's control arm).  Collection still works — values just freeze."""
    global _enabled
    _enabled = bool(on)


def enabled() -> bool:
    return _enabled


class Counter:
    """Monotonic counter child.  ``inc`` only accepts non-negative deltas."""

    __slots__ = ("_lock", "_value", "_stamp", "_stamped")

    def __init__(self, stamped: bool = True) -> None:
        self._lock = threading.Lock()
        self._value = 0.0
        self._stamp = 0
        self._stamped = stamped

    def inc(self, amount: float = 1.0) -> None:
        if not _enabled:
            return
        if amount < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._value += amount
            self._stamp = _bump_stamp() if self._stamped else _WRITE_STAMP[0]

    @property
    def value(self) -> float:
        return self._value

    @property
    def stamp(self) -> int:
        """Write-time version: the global stamp of the last mutation."""
        return self._stamp


class Gauge:
    """Point-in-time value child.  ``set_fn`` makes it callback-backed
    (sampled at collect time — queue depths, cache sizes)."""

    __slots__ = ("_lock", "_value", "_fn", "_stamp", "_stamped")

    def __init__(self, stamped: bool = True) -> None:
        self._lock = threading.Lock()
        self._value = 0.0
        self._fn: Callable[[], float] | None = None
        self._stamp = 0
        self._stamped = stamped

    def set(self, value: float) -> None:
        if not _enabled:
            return
        with self._lock:
            self._value = float(value)
            self._stamp = _bump_stamp() if self._stamped else _WRITE_STAMP[0]

    def inc(self, amount: float = 1.0) -> None:
        if not _enabled:
            return
        with self._lock:
            self._value += amount
            self._stamp = _bump_stamp() if self._stamped else _WRITE_STAMP[0]

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    def set_fn(self, fn: Callable[[], float] | None) -> None:
        # Volatility accounting: a live callback makes this child's
        # value move without a stamped write, voiding the delta
        # engine's skip-the-walk short-circuit.
        if fn is not None and self._fn is None:
            _VOLATILE[0] += 1
        elif fn is None and self._fn is not None:
            _VOLATILE[0] -= 1
        self._fn = fn

    @property
    def stamp(self) -> int:
        return self._stamp

    @property
    def value(self) -> float:
        # The kill switch covers callback-backed gauges too: the
        # overhead bench's disabled arm must not run deferred O(N)
        # sampling closures at collect time.
        if self._fn is not None and _enabled:
            try:
                return float(self._fn())
            except Exception:  # noqa: BLE001 — sampling must never raise
                return 0.0
        return self._value


class Histogram:
    """Fixed-boundary histogram child (cumulative at render time).

    ``observe(..., exemplar={...})`` attaches an OpenMetrics exemplar to
    the bucket the observation lands in (last writer wins): a small
    label dict — in this codebase ``{"span_id": <trace span id>}`` — so
    a scrape can jump from a latency bucket straight to the trace span
    that produced it.  Storage is lazy (one list allocated on the first
    exemplar) and O(1) per observe: just a tuple swap under the lock.
    """

    __slots__ = (
        "_lock", "buckets", "_counts", "_sum", "_count", "_exemplars",
        "_stamp", "_stamped",
    )

    def __init__(
        self,
        buckets: tuple[float, ...] = DEFAULT_BUCKETS,
        stamped: bool = True,
    ) -> None:
        self._lock = threading.Lock()
        self.buckets = tuple(sorted(buckets))
        self._counts = [0] * (len(self.buckets) + 1)  # +1: the +Inf bucket
        self._sum = 0.0
        self._count = 0
        self._exemplars: list | None = None  # lazy: [(labels, value)|None]
        self._stamp = 0
        self._stamped = stamped

    def observe(self, value: float, exemplar: dict | None = None) -> None:
        if not _enabled:
            return
        i = 0
        for i, b in enumerate(self.buckets):  # noqa: B007 — small, fixed
            if value <= b:
                break
        else:
            i = len(self.buckets)
        with self._lock:
            self._counts[i] += 1
            self._sum += value
            self._count += 1
            self._stamp = _bump_stamp() if self._stamped else _WRITE_STAMP[0]
            if exemplar is not None:
                if self._exemplars is None:
                    self._exemplars = [None] * (len(self.buckets) + 1)
                self._exemplars[i] = (
                    tuple((str(k), str(v)) for k, v in exemplar.items()),
                    float(value),
                )

    def exemplars(self) -> dict[float, tuple]:
        """{bucket le -> (label pairs, observed value)} for buckets that
        have one; the +Inf bucket keys as ``float('inf')``."""
        with self._lock:
            ex = list(self._exemplars) if self._exemplars is not None else []
        out: dict[float, tuple] = {}
        for i, e in enumerate(ex):
            if e is not None:
                le = (
                    self.buckets[i]
                    if i < len(self.buckets)
                    else float("inf")
                )
                out[le] = e
        return out

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def stamp(self) -> int:
        return self._stamp

    def cumulative(self) -> list[tuple[float, int]]:
        """[(le, cumulative_count)] including the +Inf bucket."""
        with self._lock:
            counts = list(self._counts)
        out = []
        acc = 0
        for b, c in zip(self.buckets, counts):
            acc += c
            out.append((b, acc))
        out.append((float("inf"), acc + counts[-1]))
        return out


def deferred_mean(arr) -> Callable[[], float]:
    """One-shot lazy occupancy sampler for ``Gauge.set_fn``.

    Computes ``arr.mean()`` on the FIRST call (scrape time — off the
    dispatch path), caches the float, and releases the
    array reference so a marshal-time closure does not pin a padded
    plane for the rest of the process lifetime.
    """
    cell: list = [arr, None]

    def sample() -> float:
        if cell[1] is None:
            a, cell[0] = cell[0], None
            cell[1] = float(a.mean()) if a is not None and a.size else 0.0
        return cell[1]

    return sample


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricFamily:
    """A named metric with label dimensions; children per label tuple."""

    def __init__(
        self,
        name: str,
        kind: str,
        help: str = "",
        labelnames: tuple[str, ...] = (),
        buckets: tuple[float, ...] | None = None,
        stamped: bool = True,
    ):
        self.name = name
        self.kind = kind
        self.help = help
        self.labelnames = tuple(labelnames)
        self._buckets = buckets
        self._stamped = stamped
        self._lock = threading.Lock()
        self._children: dict[tuple, object] = {}

    def labels(self, *values, **kv):
        if kv:
            if values:
                raise ValueError("pass label values positionally OR by name")
            values = tuple(kv[n] for n in self.labelnames)
        key = tuple(str(v) for v in values)
        if len(key) != len(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, got {key}"
            )
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.get(key)
                if child is None:
                    if self.kind == "histogram":
                        child = Histogram(
                            self._buckets or DEFAULT_BUCKETS,
                            stamped=self._stamped,
                        )
                    else:
                        child = _KINDS[self.kind](stamped=self._stamped)
                    self._children[key] = child
        return child

    # Label-less families proxy the single child's API so call sites
    # read `family.inc()` instead of `family.labels().inc()`.

    def _default(self):
        return self.labels()

    def inc(self, amount: float = 1.0) -> None:
        self._default().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._default().dec(amount)

    def set(self, value: float) -> None:
        self._default().set(value)

    def set_fn(self, fn) -> None:
        self._default().set_fn(fn)

    def observe(self, value: float, exemplar: dict | None = None) -> None:
        self._default().observe(value, exemplar)

    @property
    def value(self):
        return self._default().value

    @property
    def count(self):
        return self._default().count

    @property
    def sum(self):
        return self._default().sum

    def cumulative(self):
        return self._default().cumulative()

    def children(self) -> Iterable[tuple[tuple, object]]:
        with self._lock:
            return list(self._children.items())


class MetricsRegistry:
    """Get-or-create registry of metric families (process-wide default in
    :mod:`holo_tpu_torch.telemetry`)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._families: dict[str, MetricFamily] = {}

    def _get(
        self,
        name: str,
        kind: str,
        help: str,
        labelnames: tuple[str, ...],
        buckets: tuple[float, ...] | None = None,
        stamped: bool = True,
    ) -> MetricFamily:
        fam = self._families.get(name)
        if fam is not None:
            if fam.kind != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {fam.kind}"
                )
            return fam
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = MetricFamily(
                    name, kind, help, labelnames, buckets, stamped=stamped
                )
                self._families[name] = fam
        return fam

    def counter(
        self,
        name: str,
        help: str = "",
        labelnames: tuple[str, ...] = (),
        stamped: bool = True,
    ) -> MetricFamily:
        return self._get(name, "counter", help, labelnames, stamped=stamped)

    def gauge(
        self,
        name: str,
        help: str = "",
        labelnames: tuple[str, ...] = (),
        stamped: bool = True,
    ) -> MetricFamily:
        return self._get(name, "gauge", help, labelnames, stamped=stamped)

    def histogram(
        self,
        name: str,
        help: str = "",
        labelnames: tuple[str, ...] = (),
        buckets: tuple[float, ...] | None = None,
        stamped: bool = True,
    ) -> MetricFamily:
        return self._get(
            name, "histogram", help, labelnames, buckets, stamped=stamped
        )

    def families(self) -> list[MetricFamily]:
        with self._lock:
            return sorted(self._families.values(), key=lambda f: f.name)

    def snapshot(self, prefix: str | None = None) -> dict:
        """Flat JSON-able view: counters/gauges -> number, histograms ->
        {count, sum} — what bench stages attach to their emitted rows."""
        out: dict = {}
        for fam in self.families():
            if prefix is not None and not fam.name.startswith(prefix):
                continue
            for key, child in fam.children():
                label = ",".join(
                    f"{n}={v}" for n, v in zip(fam.labelnames, key)
                )
                name = f"{fam.name}{{{label}}}" if label else fam.name
                if fam.kind == "histogram":
                    out[name] = {
                        "count": child.count,
                        "sum": round(child.sum, 6),
                    }
                else:
                    out[name] = child.value
        return out

    def clear(self) -> None:
        """Drop every family (tests only — live handles go stale)."""
        with self._lock:
            self._families.clear()
