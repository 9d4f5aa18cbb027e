"""SLO plane: error budgets and multi-window burn-rate sentinels (the port's
copy of ``holo_tpu.telemetry.slo``).

Declared objectives grade the existing streams (convergence end cuts, the
pipeline's served and shed tickets, relay and canary probes) into rolling
good / bad counts; the counts become error budgets, and budget spend rate
("burn") is watched by the classic multi-window sentinel, warn-only.

Objective model
---------------
An :class:`Objective` declares what is graded and how:

- ``kind="latency"``: per-event grading of trigger-to-FIB end cuts
  (:func:`note_endcut`, fed by the convergence tracker's ``fib_commit``
  under a one-global-check hook) or of synthetic canary probes
  (:func:`note_probe`).  An event is good when its latency is at most
  ``threshold_s``; ``target`` is the good-fraction objective.
- ``kind="availability"``: continuous up / down grading
  (:func:`note_relay`); the budget is down seconds over the window.
- ``kind="delivery"``: per-ticket grading by the dispatch pipeline's
  priority class (:func:`note_served` / :func:`note_shed`): good = served,
  bad = shed.

``source`` scopes the stream: a trigger class, a priority class, ``relay``,
or ``"*"`` (every trigger but the canary's own).  The canary objective,
:func:`note_probe` and the background-delivery objective are kept for the
canary prober, which is not ported yet (ROADMAP A4b).

Burn-rate math
--------------
Events land in fixed-width buckets of the engine clock (``fast_window /
60`` wide, trimmed past ``slow_window``).  Over a window W: ``bad_frac =
bad / (good + bad)`` and ``burn = bad_frac / (1 - target)``;
``budget_remaining = 1 - bad_frac_slow / (1 - target)``, clamped to [0, 1].
The clock is :func:`profiling.clock` unless one is passed.  The fast-window
sentinel latches: one ``holo_slo_sentinel_fires_total`` increment and one
``slo-burn`` flight event per excursion, never a breaker.  At a checkpoint
the latency sketches seed ``slo.<objective>`` rows through the observatory's
ledger.

Off by default; disarmed, every seam costs one module-global ``None``
check and reads no clock.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

from holo_tpu_torch import telemetry
from holo_tpu_torch.telemetry import flight, profiling
from holo_tpu_torch.telemetry.observatory import DDSketch

log = logging.getLogger("holo_tpu_torch.telemetry")

#: objective kinds (a closed set)
KINDS = ("latency", "availability", "delivery")
#: burn windows (the gauge label vocabulary)
WINDOWS = ("fast", "slow")

_BURN = telemetry.gauge(
    "holo_slo_burn_rate",
    "Error-budget burn rate per objective and window (1.0 spends the "
    "budget exactly over the compliance window)",
    ("objective", "window"),
    stamped=False,
)
_BUDGET = telemetry.gauge(
    "holo_slo_budget_remaining",
    "Fraction of the slow-window error budget left per objective",
    ("objective",),
    stamped=False,
)
_SENTINEL_FIRES = telemetry.counter(
    "holo_slo_sentinel_fires_total",
    "Burn-rate sentinel excursions per objective and window "
    "(latched: one fire per crossing, warn-only)",
    ("objective", "window"),
)


@dataclass(frozen=True)
class Objective:
    """One declared service-level objective (see the module docstring)."""

    name: str
    kind: str = "latency"  # latency | availability | delivery
    source: str = "*"  # trigger class | priority class | relay | "*"
    quantile: float = 0.99
    threshold_s: float = 1.0
    target: float = 0.999

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown SLO kind {self.kind!r}")
        if not 0.0 < self.target < 1.0:
            raise ValueError(f"SLO target must be in (0, 1), got {self.target}")
        if not 0.0 < self.quantile < 1.0:
            raise ValueError(f"SLO quantile must be in (0, 1), got {self.quantile}")
        if self.threshold_s <= 0.0:
            raise ValueError(f"SLO threshold must be positive, got {self.threshold_s}")

    @classmethod
    def from_config(cls, raw: dict) -> "Objective":
        """One objective table with kebab keys (``threshold-ms``)."""
        return cls(name=str(raw["name"]), kind=str(raw.get("kind", "latency")),
                   source=str(raw.get("source", "*")), quantile=float(raw.get("quantile", 0.99)),
                   threshold_s=float(raw.get("threshold-ms", 1000.0)) / 1e3,
                   target=float(raw.get("target", 0.999)))


def default_objectives() -> tuple[Objective, ...]:
    """``holo_tpu``'s defaults: production trigger-to-FIB latency, the
    canary's probe latency, relay availability and background delivery."""
    return (
        # Every convergence end cut graded at p99; the threshold covers a
        # full delay-FSM SPF under loss.
        Objective("trigger-fib", "latency", "*", 0.99, 15.0, 0.99),
        # The canary's probes through the live dispatch path.
        Objective("canary", "latency", "canary", 0.99, 0.25, 0.99),
        # Relay availability (budget = down seconds over the window).
        Objective("relay", "availability", "relay", 0.99, 1.0, 0.999),
        # Background admission: its shed rate is the saturation budget.
        Objective("background-delivery", "delivery", "background", 0.99, 1.0, 0.99),
    )


class _ObjState:
    """Rolling state for one objective, mutated on the feeding threads
    without locks (GIL-atomic dict and scalar updates)."""

    __slots__ = ("obj", "buckets", "sketch", "fallbacks", "events", "latched", "fires",
                 "down_spans", "up", "since")

    def __init__(self, obj: Objective, alpha: float, max_bins: int):
        self.obj = obj
        # bucket index -> [good, bad] (latency, delivery) or [up_s, down_s]
        self.buckets: dict[int, list] = {}
        self.sketch = DDSketch(alpha, max_bins)
        self.fallbacks = 0
        self.events = 0
        self.latched = {"fast": False, "slow": False}
        self.fires = {"fast": 0, "slow": 0}
        # availability only: closed down spans and the current state
        self.down_spans: list = []  # [start, end] pairs
        self.up: bool | None = None
        self.since: float | None = None


class SloEngine:
    """Process-wide SLO engine (module singleton via :func:`configure`).
    The hot path is the ``note_*`` methods; everything else is cold
    reporting."""

    def __init__(self, objectives=None, clock=None, fast_window: float = 3600.0,
                 slow_window: float = 86400.0, fast_burn: float = 14.4, slow_burn: float = 1.0,
                 check_every: int = 16, alpha: float = 0.01, max_bins: int = 512):
        objs = tuple(objectives) if objectives else default_objectives()
        names = [o.name for o in objs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO objective names: {names}")
        self.fast_window = float(fast_window)
        self.slow_window = float(slow_window)
        if self.fast_window <= 0 or self.slow_window < self.fast_window:
            raise ValueError("SLO windows must satisfy 0 < fast <= slow, got "
                             f"{fast_window}/{slow_window}")
        self.fast_burn = float(fast_burn)
        self.slow_burn = float(slow_burn)
        self.check_every = int(check_every)
        self.bucket_w = self.fast_window / 60.0
        self._clock = clock if clock is not None else profiling.clock
        self._states = {o.name: _ObjState(o, alpha, max_bins) for o in objs}
        # Routing tables, computed once: the hot path walks a tuple.
        self._latency_any = tuple(s for s in self._states.values()
                                  if s.obj.kind == "latency" and s.obj.source == "*")
        self._latency_by_src: dict[str, tuple] = {}
        for s in self._states.values():
            if s.obj.kind == "latency" and s.obj.source != "*":
                self._latency_by_src[s.obj.source] = self._latency_by_src.get(s.obj.source,
                                                                              ()) + (s,)
        self._avail = tuple(s for s in self._states.values() if s.obj.kind == "availability")
        self._delivery_by_cls = {s.obj.source: s for s in self._states.values()
                                 if s.obj.kind == "delivery"}
        self._sheds: dict[tuple, int] = {}  # (class, reason) -> count
        self._notes = 0

    # -- hot path: grading -----------------------------------------------

    def _grade(self, st: _ObjState, good: bool, now: float) -> None:
        b = self.buckets_for(st, now)
        b[0 if good else 1] += 1
        st.events += 1
        self._notes += 1
        if not good or (self.check_every and self._notes % self.check_every == 0):
            self._check(st, now)

    def buckets_for(self, st: _ObjState, now: float) -> list:
        i = int(now // self.bucket_w)
        b = st.buckets.get(i)
        if b is None:
            b = st.buckets.setdefault(i, [0, 0])
            if len(st.buckets) > 2 * int(self.slow_window / self.bucket_w) + 4:
                self._trim(st, now)
        return b

    def _trim(self, st: _ObjState, now: float) -> None:
        floor = int((now - self.slow_window) // self.bucket_w)
        for i in [i for i in st.buckets if i < floor]:
            st.buckets.pop(i, None)
        if st.down_spans:
            t_floor = now - self.slow_window
            st.down_spans = [sp for sp in st.down_spans if sp[1] >= t_floor]

    def note_endcut(self, trigger: str, seconds: float, fallback: bool) -> None:
        """One trigger-to-FIB end cut (the convergence tracker's close
        hook).  Canary end cuts are graded only through :meth:`note_probe`."""
        if trigger == "canary":
            return
        now = self._clock()
        states = self._latency_by_src.get(trigger, ()) + self._latency_any
        for st in states:
            st.sketch.observe(max(seconds, 0.0))
            if fallback:
                st.fallbacks += 1
            self._grade(st, seconds <= st.obj.threshold_s, now)

    def note_probe(self, ok: bool, seconds: float | None) -> None:
        """One synthetic canary probe verdict."""
        now = self._clock()
        for st in self._latency_by_src.get("canary", ()):
            good = bool(ok)
            if seconds is not None:
                st.sketch.observe(max(seconds, 0.0))
                good = good and seconds <= st.obj.threshold_s
            self._grade(st, good, now)

    def note_served(self, cls: str) -> None:
        """One pipeline ticket settled successfully, by class."""
        st = self._delivery_by_cls.get(cls)
        if st is not None:
            self._grade(st, True, self._clock())

    def note_shed(self, cls: str, reason: str) -> None:
        """One pipeline ticket shed (capacity eviction or deadline expiry),
        by class."""
        key = (cls, reason)
        self._sheds[key] = self._sheds.get(key, 0) + 1
        st = self._delivery_by_cls.get(cls)
        if st is not None:
            self._grade(st, False, self._clock())

    def note_relay(self, up: bool) -> None:
        """One relay probe verdict."""
        now = self._clock()
        for st in self._avail:
            if st.up is None:
                st.up, st.since = bool(up), now
            elif st.up and not up:
                st.up, st.since = False, now
            elif not st.up and up:
                st.down_spans.append([st.since, now])
                st.up, st.since = True, now
            st.events += 1
            self._check(st, now)

    # -- burn math -------------------------------------------------------

    def _down_seconds(self, st: _ObjState, now: float, window: float) -> float:
        lo = now - window
        down = 0.0
        for a, b in st.down_spans:
            down += max(0.0, min(b, now) - max(a, lo))
        if st.up is False and st.since is not None:
            down += max(0.0, now - max(st.since, lo))
        return down

    def _bad_frac(self, st: _ObjState, now: float, window: float):
        """(bad fraction, good, bad) over ``[now - window, now]``; a None
        fraction when the window saw no events."""
        if st.obj.kind == "availability":
            if st.up is None:
                return None, 0, 0
            down = self._down_seconds(st, now, window)
            return min(down / window, 1.0), 0, 0
        lo = int((now - window) // self.bucket_w)
        good = bad = 0
        for i, b in list(st.buckets.items()):
            if i >= lo:
                good += b[0]
                bad += b[1]
        if good + bad == 0:
            return None, 0, 0
        return bad / (good + bad), good, bad

    def burn(self, st: _ObjState, now: float, window: float) -> float | None:
        frac, _g, _b = self._bad_frac(st, now, window)
        if frac is None:
            return None
        return frac / max(1.0 - st.obj.target, 1e-9)

    def budget_remaining(self, st: _ObjState, now: float) -> float | None:
        frac, _g, _b = self._bad_frac(st, now, self.slow_window)
        if frac is None:
            return None
        spent = frac / max(1.0 - st.obj.target, 1e-9)
        return min(max(1.0 - spent, 0.0), 1.0)

    # -- sentinel --------------------------------------------------------

    def _check(self, st: _ObjState, now: float) -> None:
        for window, span, limit in (("fast", self.fast_window, self.fast_burn),
                                    ("slow", self.slow_window, self.slow_burn)):
            b = self.burn(st, now, span)
            if b is None:
                continue
            _BURN.labels(objective=st.obj.name, window=window).set(b)
            breached = b > limit
            if breached and not st.latched[window]:
                st.latched[window] = True
                st.fires[window] += 1
                _SENTINEL_FIRES.labels(objective=st.obj.name, window=window).inc()
                flight.event("slo-burn", objective=st.obj.name, window=window, burn=round(b, 3),
                             limit=limit)
                log.warning("slo: objective %r %s-window burn %.2f exceeds %.2f -- warn-only, "
                            "dispatch unaffected", st.obj.name, window, b, limit)
            elif not breached and st.latched[window]:
                st.latched[window] = False
        rem = self.budget_remaining(st, now)
        if rem is not None:
            _BUDGET.labels(objective=st.obj.name).set(rem)

    def checkpoint(self) -> None:
        """One sentinel pass over every objective now, the bucket tails
        trimmed, and the latency sketches seeded as ``slo.<objective>`` rows
        of the observatory's ledger (when armed)."""
        from holo_tpu_torch.telemetry import observatory

        now = self._clock()
        obs = observatory.active()
        for st in self._states.values():
            self._trim(st, now)
            self._check(st, now)
            if obs is not None and st.sketch.count:
                try:
                    obs._sentinel_check((f"slo.{st.obj.name}", "latency", "-", "-", "-"),
                                        st.sketch)
                except Exception:  # noqa: BLE001 -- warn-only
                    log.debug("slo sentinel pass failed", exc_info=True)

    # -- cold reporting --------------------------------------------------

    def _objective_row(self, st: _ObjState, now: float) -> dict:
        o = st.obj
        fast_frac, fg, fb = self._bad_frac(st, now, self.fast_window)
        slow_frac, sg, sb = self._bad_frac(st, now, self.slow_window)
        row = {
            "objective": o.name,
            "kind": o.kind,
            "source": o.source,
            "target": o.target,
            "threshold_ms": round(o.threshold_s * 1e3, 3),
            "quantile": o.quantile,
            "events": st.events,
            "good_fast": fg,
            "bad_fast": fb,
            "good_slow": sg,
            "bad_slow": sb,
            "burn_fast": (round(self.burn(st, now, self.fast_window), 6)
                          if fast_frac is not None else None),
            "burn_slow": (round(self.burn(st, now, self.slow_window), 6)
                          if slow_frac is not None else None),
            "budget_remaining": (round(self.budget_remaining(st, now), 6)
                                 if slow_frac is not None else None),
            "sentinel_fires_fast": st.fires["fast"],
            "sentinel_fires_slow": st.fires["slow"],
            "latched_fast": bool(st.latched["fast"]),
        }
        if o.kind == "latency":
            row["fallbacks"] = st.fallbacks
            if st.sketch.count:
                row["measured_ms"] = {
                    "p50": round((st.sketch.quantile(0.5) or 0.0) * 1e3, 3),
                    f"p{round(o.quantile * 100)}": round(
                        (st.sketch.quantile(o.quantile) or 0.0) * 1e3, 3),
                    "p99": round((st.sketch.quantile(0.99) or 0.0) * 1e3, 3),
                }
        if o.kind == "availability":
            row["down_s_fast"] = round(self._down_seconds(st, now, self.fast_window), 3)
            row["down_s_slow"] = round(self._down_seconds(st, now, self.slow_window), 3)
            row["state"] = "unknown" if st.up is None else ("up" if st.up else "down")
        return row

    def report(self) -> dict:
        """The deterministic report document: one row per objective in
        declaration order and the shed tally by (class, reason)."""
        now = self._clock()
        return {
            "windows": {
                "fast_s": self.fast_window,
                "slow_s": self.slow_window,
                "fast_burn_limit": self.fast_burn,
                "slow_burn_limit": self.slow_burn,
            },
            "objectives": [self._objective_row(st, now) for st in self._states.values()],
            "sheds": {f"{cls}/{reason}": n for (cls, reason), n in sorted(self._sheds.items())},
        }

    def stats(self) -> dict:
        now = self._clock()
        out = {"objectives": {}, "sheds": {}}
        for st in self._states.values():
            b = self.burn(st, now, self.fast_window)
            rem = self.budget_remaining(st, now)
            out["objectives"][st.obj.name] = {
                "kind": st.obj.kind,
                "events": st.events,
                "burn-fast": round(b, 6) if b is not None else None,
                "budget-remaining": round(rem, 6) if rem is not None else None,
                "sentinel-fires": st.fires["fast"] + st.fires["slow"],
            }
        for (cls, reason), n in sorted(self._sheds.items()):
            out["sheds"][f"{cls}/{reason}"] = n
        return out

    def objective(self, name: str) -> _ObjState | None:
        """The state of one objective."""
        return self._states.get(name)


# -- process-wide singleton + one-global-check seams ---------------------

_SLO: SloEngine | None = None


def configure(enabled=True, objectives=None, **kw) -> SloEngine | None:
    """Arm (truthy ``enabled``) or disarm the process-wide engine and
    (un)install the convergence end-cut hook.  ``kw`` passes through to
    :class:`SloEngine` (clock, windows, burn limits)."""
    global _SLO
    from holo_tpu_torch.telemetry import convergence

    if enabled:
        _SLO = SloEngine(objectives=objectives, **kw)
        convergence.set_slo_hook(_SLO)
    else:
        _SLO = None
        convergence.set_slo_hook(None)
    return _SLO


def active() -> SloEngine | None:
    return _SLO


def enabled() -> bool:
    return _SLO is not None


def note_probe(ok: bool, seconds: float | None = None) -> None:
    """Canary probe verdict (a no-op while disarmed)."""
    sl = _SLO
    if sl is None:
        return
    sl.note_probe(ok, seconds)


def note_served(cls: str) -> None:
    """Pipeline ticket served, by class (a no-op while disarmed)."""
    sl = _SLO
    if sl is None:
        return
    sl.note_served(cls)


def note_shed(cls: str, reason: str) -> None:
    """Pipeline ticket shed, by class and reason (a no-op while disarmed)."""
    sl = _SLO
    if sl is None:
        return
    sl.note_shed(cls, reason)


def note_relay(up: bool) -> None:
    """Relay probe verdict (a no-op while disarmed)."""
    sl = _SLO
    if sl is None:
        return
    sl.note_relay(up)
