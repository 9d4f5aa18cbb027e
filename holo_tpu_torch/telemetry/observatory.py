"""Dispatch observatory (the port's copy of
``holo_tpu.telemetry.observatory``): streaming quantile sketches of every
dispatch stage, roofline attribution and an online regression sentinel.

- **Streaming quantile sketches** (:class:`DDSketch`): each value lands in
  the log-spaced bucket ``ceil(log_gamma(v))`` with ``gamma = (1 + alpha) /
  (1 - alpha)``, so a quantile estimate is within ``alpha`` relative error
  of the sample quantile.  Sketches are deterministic, mergeable (bucket
  counts add) and bounded (``max_bins``, the lowest buckets collapse).  One
  sketch per key ``(site, stage, engine, shape bucket, kind)``, fed by
  :func:`holo_tpu_torch.telemetry.profiling.stage` through the profiling
  stage observer: armed, a dict hit and integer adds per stage; disarmed,
  one module-global check.  No locks: sketch updates ride the GIL's atomic
  dict and int operations (a racing observe may coalesce one count, inside
  the sketch's own ``alpha`` envelope).

- **Roofline attribution** (:meth:`Observatory.roofline`): the cost entry
  of each (site, engine, shape bucket, kind) joined with its measured
  ``device``-stage sketch into achieved op/s and bytes/s, arithmetic
  intensity and a memory- or compute-bound verdict, the ridge-point test
  (intensity below ``peak ops / peak bytes``: the kernel cannot be
  compute-bound on that machine).  ``holo_tpu``'s numerators are XLA's
  compile-time ``cost_analysis()``; the port's are the kernel wrappers' work
  tallies (:mod:`holo_tpu_torch.kernels.work`) over the dispatch, which the
  backends forward through :func:`note_cost`.  The key ``"flops"`` is
  kept: the port counts int32 operations under it.  The default
  :class:`RooflinePeaks` are ``holo_tpu``'s CPU guess; the package states no
  peak for a GPU, and callers on a card pass their own (``chip_smoke.py``
  passes the H100's).

- **Regression sentinel**: every ``check_every`` observations of a key, its
  p50 and p99 are compared with a persisted baseline (``ledger_path``):
  unseen keys are seeded, more than 10% drift past an absolute floor flags a
  regression (a warn-only ``observatory-regression`` flight event and
  ``holo_observatory_regressions_total{bucket,quantile}``), more than 5%
  improvement ratchets the baseline down.  Never a breaker, never a
  fallback.

:class:`DeterministicTimer` swaps the profiling stage timer for a counter
clock, so a seeded workload gives byte-identical sketch serializations and
reports across runs (``report()["timing"] == "deterministic"``).
"""

from __future__ import annotations

import json
import logging
import math
import os
import threading
from dataclasses import dataclass
from pathlib import Path

from holo_tpu_torch import telemetry
from holo_tpu_torch.telemetry import flight, profiling

log = logging.getLogger("holo_tpu_torch.telemetry")

#: sketch values at or below this are exact zeros (a stage wall of 0.0 only
#: happens under a deterministic timer that was never advanced)
MIN_TRACKABLE = 1e-9

#: sentinel drift thresholds: > 10% worse flags, > 5% better ratchets, and
#: an absolute floor of 5 ms below which scheduler noise lives
DRIFT_FLAG = 0.10
DRIFT_RATCHET = 0.05
DRIFT_FLOOR_S = 5e-3

_REGRESSIONS = telemetry.counter(
    "holo_observatory_regressions_total",
    "Sketch-bucket quantiles that drifted >10% past the persisted "
    "runtime baseline (warn-only; ledger-seeded keys never flag on "
    "their seeding run)",
    ("bucket", "quantile"),
)
# Population gauges update from the sentinel tick and stats() only:
# stamped=False keeps observatory bookkeeping off the write stamp.
_SKETCHES = telemetry.gauge(
    "holo_observatory_sketches",
    "Live (site, stage, engine, shape-bucket, kind) sketch keys",
    stamped=False,
)
_OBSERVATIONS = telemetry.gauge(
    "holo_observatory_observations",
    "Total stage observations folded into the sketches",
    stamped=False,
)


class DDSketch:
    """Relative-error streaming quantile sketch (DDSketch-style).

    ``quantile(q)`` is within ``alpha`` relative error of the sample
    quantile; memory is bounded by ``max_bins`` (the lowest buckets
    collapse); two sketches of one ``alpha`` merge by bucket-count addition;
    :meth:`serialize` is byte-identical for identical observation
    multisets.
    """

    __slots__ = ("alpha", "max_bins", "_gamma", "_log_gamma", "bins", "zero", "count",
                 "total", "vmin", "vmax")

    def __init__(self, alpha: float = 0.01, max_bins: int = 512):
        if not 0.0 < alpha < 1.0:
            raise ValueError(f"alpha must be in (0, 1), got {alpha}")
        self.alpha = float(alpha)
        self.max_bins = int(max_bins)
        self._gamma = (1.0 + self.alpha) / (1.0 - self.alpha)
        self._log_gamma = math.log(self._gamma)
        self.bins: dict[int, int] = {}
        self.zero = 0
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    def observe(self, value: float) -> None:
        v = float(value)
        if v < 0.0:
            v = 0.0  # durations: a clock step backwards clamps
        self.count += 1
        self.total += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v
        if v <= MIN_TRACKABLE:
            self.zero += 1
            return
        i = math.ceil(math.log(v) / self._log_gamma)
        self.bins[i] = self.bins.get(i, 0) + 1
        if len(self.bins) > self.max_bins:
            self._collapse()

    def _collapse(self) -> None:
        # Collapse the two lowest buckets (the tail the p99 sentinel reads
        # keeps full accuracy).  pop(lo, 0) and get(nxt, 0) tolerate a
        # racing collapse.
        idxs = sorted(self.bins)
        lo, nxt = idxs[0], idxs[1]
        self.bins[nxt] = self.bins.get(nxt, 0) + self.bins.pop(lo, 0)

    def _bucket_value(self, i: int) -> float:
        # The midpoint of bucket (gamma^(i-1), gamma^i]: within alpha
        # relative of every value the bucket holds.
        return 2.0 * self._gamma ** i / (self._gamma + 1.0)

    def quantile(self, q: float) -> float | None:
        """Estimate the ``q``-quantile (None on an empty sketch)."""
        if not self.count:
            return None
        rank = q * (self.count - 1)
        acc = self.zero
        if acc > rank:
            return 0.0
        for i, c in sorted(self.bins.items()):
            acc += c
            if acc > rank:
                return self._bucket_value(i)
        return float(self.vmax)

    def merge(self, other: "DDSketch") -> "DDSketch":
        """Fold ``other`` into self (the same ``alpha`` required)."""
        if abs(other.alpha - self.alpha) > 1e-12:
            raise ValueError(f"cannot merge sketches with alpha {self.alpha} != {other.alpha}")
        for i, c in other.bins.items():
            self.bins[i] = self.bins.get(i, 0) + c
        while len(self.bins) > self.max_bins:
            self._collapse()
        self.zero += other.zero
        self.count += other.count
        self.total += other.total
        self.vmin = min(self.vmin, other.vmin)
        self.vmax = max(self.vmax, other.vmax)
        return self

    def to_doc(self) -> dict:
        """Canonical JSON-able state (sorted bins, rounded floats)."""
        return {
            "alpha": self.alpha,
            "zero": self.zero,
            "count": self.count,
            "sum": round(self.total, 9),
            "min": round(self.vmin, 9) if self.count else None,
            "max": round(self.vmax, 9) if self.count else None,
            "bins": [[i, self.bins[i]] for i in sorted(self.bins)],
        }

    @classmethod
    def from_doc(cls, doc: dict, max_bins: int = 512) -> "DDSketch":
        sk = cls(float(doc["alpha"]), max_bins)
        sk.zero = int(doc.get("zero", 0))
        sk.count = int(doc.get("count", 0))
        sk.total = float(doc.get("sum", 0.0))
        sk.vmin = float(doc["min"]) if doc.get("min") is not None else math.inf
        sk.vmax = float(doc["max"]) if doc.get("max") is not None else -math.inf
        sk.bins = {int(i): int(c) for i, c in doc.get("bins", [])}
        return sk

    def serialize(self) -> bytes:
        """Byte-identical canonical encoding of :meth:`to_doc`."""
        return json.dumps(self.to_doc(), sort_keys=True, separators=(",", ":")).encode()


@dataclass(frozen=True)
class RooflinePeaks:
    """The peak rates the roofline verdict tests against.  The default is
    ``holo_tpu``'s commodity-CPU guess, under its own label; a caller on a
    card passes that card's (``from_config``)."""

    flops_per_sec: float = 5.0e10  # ~50 GFLOP/s sustained scalar+SIMD
    bytes_per_sec: float = 1.0e10  # ~10 GB/s sustained DRAM stream
    source: str = "cpu-default (relay: not-used)"

    @property
    def ridge(self) -> float:
        """Arithmetic intensity (ops / byte) where the machine stops being
        bandwidth-limited: below it, memory-bound."""
        return self.flops_per_sec / self.bytes_per_sec

    @classmethod
    def from_config(cls, raw) -> "RooflinePeaks":
        """A ``{"flops", "bytes", "name"}`` dict, a RooflinePeaks, or None
        (the default)."""
        if raw is None:
            return cls()
        if isinstance(raw, RooflinePeaks):
            return raw
        return cls(flops_per_sec=float(raw["flops"]), bytes_per_sec=float(raw["bytes"]),
                   source=str(raw.get("name", "configured")))


def key_str(key: tuple) -> str:
    """Canonical string form of a sketch key: the ledger key, the metric
    ``bucket`` label and the report row id.  Square brackets render as
    parens (gNMI list-key path segments reserve ``[``/``]``)."""
    site, stage, engine, bucket, kind = key
    b = ("-" if bucket in (None, "-")
         else json.dumps(list(bucket), separators=(",", ":"), default=str)
         .replace("[", "(").replace("]", ")"))
    return f"{site}/{stage}|{engine}|{kind}|{b}"


class DeterministicTimer:
    """Counter clock for byte-identical observatory runs: every read
    advances ``quantum``, so stage walls count timer reads instead of wall
    time.  Install with ``profiling.set_stage_timer``."""

    def __init__(self, quantum: float = 1e-4):
        self.t = 0.0
        self.quantum = float(quantum)

    def __call__(self) -> float:
        self.t += self.quantum
        return self.t


class Observatory:
    """One process-wide instrument (module singleton via :func:`configure`).
    The hot path is :meth:`_observe`, installed as the profiling stage
    observer; everything else is cold reporting."""

    def __init__(self, alpha: float = 0.01, max_bins: int = 512, check_every: int = 32,
                 ledger_path: str | Path | None = None, peaks: RooflinePeaks | dict | None = None):
        self.alpha = float(alpha)
        self.max_bins = int(max_bins)
        self.check_every = int(check_every)
        self.peaks = RooflinePeaks.from_config(peaks)
        self.ledger_path = Path(ledger_path) if ledger_path else None
        self._sketches: dict[tuple, DDSketch] = {}
        self._costs: dict[tuple, dict] = {}
        # Sentinel state: the persisted quantile baseline and the
        # per-(key, quantile) regressed latch (events fire on the transition
        # into regressed, not on every re-check).
        self._ledger: dict[str, dict] = {}
        self._regressed: dict[tuple, bool] = {}
        self._seeded = 0
        self._ratcheted = 0
        self._flags = 0
        self._n_obs = 0
        self._dirty = False
        if self.ledger_path is not None:
            self.load_ledger()

    # -- hot path (no locks) ---------------------------------------------

    def _observe(self, site: str, stage: str, device: str, seconds: float):
        """The profiling stage observer.  ``device != "-"`` rows are the
        per-shard split of one already-observed mesh dispatch: folding them
        in would count the dispatch twice."""
        if device != "-":
            return
        ctx = profiling.dispatch_ctx()
        if ctx is None:
            engine = kind = "-"
            bucket = "-"
        else:
            engine = ctx.get("engine", "-")
            kind = ctx.get("kind", "-")
            bucket = ctx.get("bucket") or "-"
        key = (site, stage, engine, bucket, kind)
        sk = self._sketches.get(key)
        if sk is None:
            # setdefault is atomic under the GIL: two racing first observers
            # both get the one surviving sketch.
            sk = self._sketches.setdefault(key, DDSketch(self.alpha, self.max_bins))
        sk.observe(seconds)
        self._n_obs += 1
        if self.check_every and sk.count % self.check_every == 0:
            self._sentinel_check(key, sk)

    # -- cost join (the backends call it where they feed cost_prior) -----

    def note_cost(self, site: str, kind: str, engine: str, bucket, entry: dict | None) -> None:
        """Attach the cost entry (``{"flops", "bytes"}``) of one (site,
        engine, shape bucket, kind): the roofline numerator."""
        if not entry:
            return
        self._costs[(site, str(engine), bucket or "-", str(kind))] = {
            "flops": float(entry.get("flops", 0.0)),
            "bytes": float(entry.get("bytes", 0.0)),
        }

    # -- regression sentinel ---------------------------------------------

    def _sentinel_check(self, key: tuple, sk: DDSketch) -> None:
        p50 = sk.quantile(0.5)
        p99 = sk.quantile(0.99)
        if p50 is None:
            return
        ks = key_str(key)
        ent = self._ledger.get(ks)
        if ent is None:
            self._ledger[ks] = {"p50": round(p50, 9), "p99": round(p99, 9)}
            self._seeded += 1
            self._dirty = True
            self._update_gauges()
            return
        dirty = False
        for qname, measured in (("p50", p50), ("p99", p99)):
            base = ent.get(qname)
            if base is None:
                ent[qname] = round(measured, 9)
                dirty = True
                continue
            floor = max(base * DRIFT_FLAG, DRIFT_FLOOR_S)
            regressed = measured > base + floor
            latch = (ks, qname)
            was = self._regressed.get(latch, False)
            if regressed and not was:
                self._regressed[latch] = True
                self._flags += 1
                _REGRESSIONS.labels(bucket=ks, quantile=qname).inc()
                flight.event("observatory-regression", bucket=ks, quantile=qname,
                             baseline=round(base, 6), measured=round(measured, 6))
                log.warning("observatory: %s %s regressed %.3fms -> %.3fms (baseline +%d%%) "
                            "-- warn-only, dispatch unaffected", ks, qname, base * 1e3,
                            measured * 1e3, int(DRIFT_FLAG * 100))
            elif not regressed:
                if was:
                    self._regressed[latch] = False
                if measured < base - max(base * DRIFT_RATCHET, DRIFT_FLOOR_S):
                    ent[qname] = round(measured, 9)
                    self._ratcheted += 1
                    dirty = True
        if dirty:
            self._dirty = True
        self._update_gauges()

    def checkpoint(self) -> dict:
        """One sentinel pass over every populated sketch now, then the
        ledger written if dirty.  Returns :meth:`sentinel`."""
        for key, sk in list(self._sketches.items()):
            if sk.count:
                self._sentinel_check(key, sk)
        if self._dirty and self.ledger_path is not None:
            self.save_ledger()
        return self.sentinel()

    def _update_gauges(self) -> None:
        _SKETCHES.set(len(self._sketches))
        _OBSERVATIONS.set(self._n_obs)

    def load_ledger(self, path: str | Path | None = None) -> bool:
        """Load the persisted quantile baseline; a corrupt file is
        discarded (the sentinel re-seeds)."""
        p = Path(path) if path is not None else self.ledger_path
        if p is None or not p.exists():
            return False
        try:
            doc = json.loads(p.read_text())
        except (OSError, ValueError) as e:
            log.warning("observatory ledger load from %s failed: %s", p, e)
            return False
        if not isinstance(doc, dict):
            return False
        self._ledger = {str(k): dict(v) for k, v in doc.items() if isinstance(v, dict)}
        return True

    def save_ledger(self, path: str | Path | None = None) -> bool:
        """Atomic (tmp + rename) write of the baseline; never raises."""
        p = Path(path) if path is not None else self.ledger_path
        if p is None:
            return False
        try:
            doc = json.dumps(self._ledger, sort_keys=True, indent=1)
            tmp = p.with_suffix(p.suffix + ".tmp")
            tmp.write_text(doc + "\n")
            os.replace(tmp, p)
            self._dirty = False
            return True
        except OSError as e:
            log.warning("observatory ledger save to %s failed: %s", p, e)
            return False

    # -- reporting (cold path) -------------------------------------------

    def quantiles(self, key: tuple) -> dict | None:
        sk = self._sketches.get(key)
        if sk is None or not sk.count:
            return None
        return {"count": sk.count, "total_s": round(sk.total, 9),
                "p50_s": round(sk.quantile(0.5), 9), "p99_s": round(sk.quantile(0.99), 9)}

    def site_p99(self, site: str) -> float | None:
        """The worst p99 seconds across every sketch at ``site``: the
        watchdog's budget base.  None while the site is cold."""
        worst = None
        for key, sk in list(self._sketches.items()):
            if key[0] != site or not sk.count:
                continue
            q = sk.quantile(0.99)
            if worst is None or q > worst:
                worst = q
        return worst

    def cost_centers(self, top: int | None = None) -> list[dict]:
        """Sketch keys ranked by total attributed seconds."""
        rows = []
        for key, sk in list(self._sketches.items()):
            if not sk.count:
                continue
            site, stage, engine, bucket, kind = key
            rows.append({
                "key": key_str(key),
                "site": site,
                "stage": stage,
                "engine": engine,
                "kind": kind,
                "bucket": list(bucket) if isinstance(bucket, tuple) else bucket,
                "count": sk.count,
                "total_s": round(sk.total, 9),
                "p50_s": round(sk.quantile(0.5), 9),
                "p99_s": round(sk.quantile(0.99), 9),
            })
        rows.sort(key=lambda r: (-r["total_s"], r["key"]))
        return rows[:top] if top else rows

    def roofline(self) -> list[dict]:
        """Per (site, engine, shape bucket, kind): the cost join.  The
        verdict is the ridge-point test on the entry's intensity; the
        achieved rates divide the entry by the device-stage sketch's p50."""
        rows = []
        for (site, engine, bucket, kind), cost in list(self._costs.items()):
            flops, nbytes = cost["flops"], cost["bytes"]
            ai = flops / nbytes if nbytes else math.inf
            verdict = "memory-bound" if ai < self.peaks.ridge else "compute-bound"
            row = {
                "site": site,
                "engine": engine,
                "kind": kind,
                "bucket": list(bucket) if isinstance(bucket, tuple) else bucket,
                "flops": flops,
                "bytes": nbytes,
                "ai_flops_per_byte": round(ai, 6) if math.isfinite(ai) else None,
                "verdict": verdict,
                "peaks": self.peaks.source,
            }
            q = self.quantiles((site, "device", engine, bucket, kind))
            if q is not None and q["p50_s"] > 0:
                p50 = q["p50_s"]
                achieved_flops = flops / p50
                achieved_bytes = nbytes / p50
                # The attainable ceiling: bandwidth-capped below the ridge,
                # compute-capped above it.
                attainable = min(self.peaks.flops_per_sec, ai * self.peaks.bytes_per_sec)
                row.update(
                    device_p50_s=p50,
                    device_p99_s=q["p99_s"],
                    dispatches=q["count"],
                    achieved_flops_per_sec=round(achieved_flops, 3),
                    achieved_bytes_per_sec=round(achieved_bytes, 3),
                    roofline_fraction=(round(achieved_flops / attainable, 9)
                                       if attainable else None),
                )
            rows.append(row)
        rows.sort(key=lambda r: (r["site"], str(r["bucket"]), r["engine"], r["kind"]))
        return rows

    def sentinel(self) -> dict:
        regressed = sorted(f"{ks}:{q}" for (ks, q), on in list(self._regressed.items()) if on)
        return {
            "ledger-entries": len(self._ledger),
            "seeded": self._seeded,
            "ratcheted": self._ratcheted,
            "flags": self._flags,
            "regressed": regressed,
            "path": str(self.ledger_path) if self.ledger_path else None,
        }

    def report(self, top: int | None = None) -> dict:
        """The full explain document (canonical field order)."""
        return {
            "timing": "deterministic" if profiling.stage_timer_overridden() else "wall",
            "peaks": {
                "flops_per_sec": self.peaks.flops_per_sec,
                "bytes_per_sec": self.peaks.bytes_per_sec,
                "ridge_flops_per_byte": round(self.peaks.ridge, 6),
                "source": self.peaks.source,
            },
            "cost_centers": self.cost_centers(top),
            "roofline": self.roofline(),
            "sentinel": self.sentinel(),
        }

    def serialize(self) -> bytes:
        """Canonical byte encoding of every sketch: the byte-identity
        surface (two same-seed deterministic runs compare equal)."""
        doc = {key_str(k): sk.to_doc() for k, sk in list(self._sketches.items()) if sk.count}
        return json.dumps(doc, sort_keys=True, separators=(",", ":")).encode()

    def stats(self) -> dict:
        self._update_gauges()
        return {
            "sketches": len(self._sketches),
            "observations": self._n_obs,
            "cost-buckets": len(self._costs),
            "alpha": self.alpha,
            "check-every": self.check_every,
            "peaks-source": self.peaks.source,
            "sentinel": self.sentinel(),
        }


# -- process-wide singleton ---------------------------------------------

_ACTIVE: Observatory | None = None
_CONFIG_LOCK = threading.Lock()


def configure(enabled: bool = True, *, alpha: float = 0.01, max_bins: int = 512,
              check_every: int = 32, ledger_path: str | Path | None = None,
              peaks: RooflinePeaks | dict | None = None) -> Observatory | None:
    """Arm (install the profiling stage observer) or disarm the process-wide
    observatory.  Disarming restores the one-global-check stage path."""
    global _ACTIVE
    with _CONFIG_LOCK:
        if not enabled:
            _ACTIVE = None
            profiling.set_observer(None)
            return None
        obs = Observatory(alpha=alpha, max_bins=max_bins, check_every=check_every,
                          ledger_path=ledger_path, peaks=peaks)
        _ACTIVE = obs
        profiling.set_observer(obs._observe)
        return obs


def active() -> Observatory | None:
    return _ACTIVE


def note_cost(site: str, kind: str, engine: str, bucket, entry: dict | None) -> None:
    """Backend seam: forward a cost entry when armed."""
    obs = _ACTIVE
    if obs is not None:
        obs.note_cost(site, kind, engine, bucket, entry)
