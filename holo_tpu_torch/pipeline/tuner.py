"""Per-shape engine tuner of the port: ``holo_tpu/pipeline/tuner.py``'s
``EngineTuner``, its schedule, constants and table format.

The single-path engines (``seq``, ``fused``, ``packed``, ``hybrid``,
``tropical``) compute the same bits, so which one runs is a latency choice.
The tuner makes it per **shape bucket**::

    bucket = (pow2(V), pow2(E), pow2(batch), mesh identity, multipath width)

For each (kind, bucket) it runs a deterministic explore / exploit schedule
over measured dispatch walls:

- **explore**: until every candidate has ``explore_rounds`` samples, pick
  the candidates round-robin (cheapest estimated bytes first where a cost
  prior was attached);
- **exploit**: the candidate with the lowest median wall; every
  ``reprobe_every`` dispatches one other candidate is measured again
  (round-robin), so a winner that drifts can be overtaken.

The same table carries the DeltaPath depth cap: the backend feeds the walls
of delta-linked and full-rebuild dispatches per bucket, and
:meth:`EngineTuner.max_delta_depth` derives the chain-depth cap from their
ratio (``ops.spf_engine.DeviceGraphCache._depth_cap`` consults it through
:func:`active_tuner`), and the partitioned path's warm full solves under
their own kind.

The table round-trips through a versioned JSON file (``TABLE_VERSION`` 3,
``holo_tpu``'s format: one file reads the same in both packages), written
atomically; a version mismatch or a corrupt file is discarded.  The
candidates of a multipath ``compute()`` bucket are ``holo_tpu``'s pair,
``mp`` (the gather engine's program) and ``mp_tropical`` (the tropical
engine's, on its tiles).  An engine that a loaded table names but this
package does not run stays in the table and its saves, and is never
picked.

Decisions, promotions and the tracked buckets are ``holo_tpu``'s
``holo_pipeline_tuner_{decisions_total,promotions_total,buckets}``;
:meth:`EngineTuner.stats` also counts the decisions by (kind, engine, phase).
"""

from __future__ import annotations

import json
import logging
import os
import threading
from collections import Counter, deque
from pathlib import Path

from holo_tpu_torch import telemetry
from holo_tpu_torch.telemetry import profiling

log = logging.getLogger("holo_tpu_torch.pipeline.tuner")

_DECISIONS = telemetry.counter(
    "holo_pipeline_tuner_decisions_total", "Engine-tuner picks by schedule phase",
    ("kind", "engine", "phase"))
_PROMOTIONS = telemetry.counter(
    "holo_pipeline_tuner_promotions_total", "Shape buckets whose measured winner changed",
    ("kind",))
_BUCKETS = telemetry.gauge("holo_pipeline_tuner_buckets", "Shape buckets the tuner currently tracks")

#: persisted-table format version (``holo_tpu``'s: its tables load here)
TABLE_VERSION = 3

#: the single-path engines (``holo_tpu``'s)
ENGINES = ("seq", "fused", "packed", "hybrid", "tropical")

#: the multipath formulations of a ``compute()`` (``holo_tpu``'s): the
#: gather program and the one on the tropical tiles
MP_ENGINES = ("mp", "mp_tropical")

#: samples kept per (kind, bucket, engine)
SAMPLE_WINDOW = 9

#: DeltaPath depth cap: clamp(round(full / delta) * DEPTH_SCALE)
DEPTH_SCALE = 32
DEPTH_MIN = 32
DEPTH_MAX = 4096
#: samples of each arm required before the cap leaves the default
DEPTH_MIN_SAMPLES = 3


def _pow2(n: int) -> int:
    """Smallest power of two >= n (>= 1)."""
    out = 1
    n = max(int(n), 1)
    while out < n:
        out *= 2
    return out


def shape_bucket(
    n_vertices: int, n_edges: int, batch: int = 1, mesh=None, k: int = 1
) -> tuple:
    """The tuner's shape key: pow2-quantized (V, E, batch), the mesh
    identity (None on one device) and the multipath parent-set width ``k``
    (a 1024-lane what-if and a 1-lane ``compute()`` never share medians, nor
    k = 1 and k = 8)."""
    return (_pow2(n_vertices), _pow2(n_edges), _pow2(batch), mesh, int(k))


def bgp_shape_bucket(n_prefixes: int, n_peers: int) -> tuple:
    """The BGP table's bucket: pow2-quantized (prefixes, peers) behind a
    leading ``"bgp"``, disjoint from every SPF bucket."""
    return ("bgp", _pow2(max(1, n_prefixes)), _pow2(max(1, n_peers)))


def _median(vals) -> float | None:
    """Lower median: of an even count the smaller middle value."""
    if not vals:
        return None
    s = sorted(vals)
    return float(s[(len(s) - 1) // 2])


class _BucketState:
    """Per-(kind, bucket) state (mutated under the tuner lock)."""

    __slots__ = ("dispatches", "samples", "cost", "winner", "explored")

    def __init__(self):
        self.dispatches = 0
        self.samples: dict[str, deque] = {}  # engine -> wall seconds, newest last
        self.cost: dict[str, dict] = {}  # engine -> {"flops": f, "bytes": b}
        self.winner: str | None = None
        self.explored = 0  # decisions spent exploring


class EngineTuner:
    """Measured per-shape engine selection and DeltaPath depth tuning.  All
    state mutates under one lock; a decision is O(1)."""

    def __init__(
        self,
        path: str | Path | None = None,
        engines: tuple[str, ...] = ENGINES,
        mp_engines: tuple[str, ...] = MP_ENGINES,
        explore_rounds: int = 2,
        reprobe_every: int = 64,
        default_engine: str = "seq",
        default_delta_depth: int = 256,
    ):
        self.engines = tuple(engines)
        self.mp_engines = tuple(mp_engines)
        self.explore_rounds = int(explore_rounds)
        self.reprobe_every = int(reprobe_every)
        self.default_engine = default_engine
        self.default_delta_depth = int(default_delta_depth)
        self.path = Path(path) if path is not None else None
        self._lock = threading.Lock()
        self._table: dict[tuple, _BucketState] = {}
        self._depth: dict[tuple, dict[str, deque]] = {}  # bucket -> delta / full walls
        self._promotions = 0
        self._decisions: Counter = Counter()  # (kind, engine, phase) -> picks
        self._loaded = False
        if self.path is not None:
            self.load()

    @staticmethod
    def _key(kind: str, bucket: tuple) -> tuple:
        return (str(kind), *bucket)

    def _state(self, key: tuple) -> _BucketState:
        st = self._table.get(key)
        if st is None:
            st = self._table[key] = _BucketState()
            _BUCKETS.set(len(self._table))
        return st

    # -- engine selection ----------------------------------------------

    def _candidates(self, kind: str, bucket: tuple) -> tuple[str, ...]:
        """The single-path engines, or for k > 1 the multipath ones (what-if
        batches stay on ``mp``)."""
        k = bucket[4] if len(bucket) > 4 and isinstance(bucket[4], int) else 1
        if k > 1:
            return self.mp_engines if kind == "one" else ("mp",)
        return self.engines

    def pick(self, kind: str, bucket: tuple) -> str:
        """The engine this dispatch should run.  Deterministic: it depends
        only on the bucket's dispatch count and the recorded samples."""
        key = self._key(kind, bucket)
        cands = self._candidates(kind, bucket)
        with self._lock:
            st = self._state(key)
            st.dispatches += 1
            needy = [e for e in self._explore_order(st, cands)
                     if len(st.samples.get(e, ())) < self.explore_rounds]
            if needy:
                engine = needy[st.explored % len(needy)]
                st.explored += 1
                phase = "explore"
            else:
                winner = self._winner_locked(st, cands)
                if (self.reprobe_every and st.dispatches % self.reprobe_every == 0
                        and len(cands) > 1):
                    others = [e for e in cands if e != winner]
                    engine = others[(st.dispatches // self.reprobe_every) % len(others)]
                    phase = "reprobe"
                else:
                    engine = winner
                    phase = "exploit"
            self._decisions[(kind, engine, phase)] += 1
        _DECISIONS.labels(kind=kind, engine=engine, phase=phase).inc()
        return engine

    def _explore_order(self, st: _BucketState, cands: tuple[str, ...] | None = None):
        """Candidates with a cost prior first, cheapest estimated bytes
        leading."""
        if cands is None:
            cands = self.engines
        if not st.cost:
            return cands
        return tuple(sorted(cands, key=lambda e: st.cost.get(e, {}).get("bytes", float("inf"))))

    def _winner_locked(self, st: _BucketState, cands: tuple[str, ...] | None = None) -> str:
        if cands is None:
            # Measured engines outside the single-path set (mp, or an engine
            # of a loaded table) can still be a bucket's recorded winner.
            cands = tuple(dict.fromkeys(self.engines + tuple(sorted(st.samples))))
        best, best_med = None, None
        for e in cands:
            med = _median(st.samples.get(e))
            if med is not None and (best_med is None or med < best_med):
                best, best_med = e, med
        if best is not None:
            return best
        return self.default_engine if self.default_engine in cands else cands[0]

    def current_winner(self, kind: str, bucket: tuple) -> str | None:
        """A bucket's measured winner among its candidates, without
        advancing the schedule; None before any sample."""
        key = self._key(kind, bucket)
        with self._lock:
            st = self._table.get(key)
            if st is None or not st.samples:
                return None
            return self._winner_locked(st, self._candidates(kind, bucket))

    def observe(self, kind: str, bucket: tuple, engine: str, seconds: float) -> None:
        """Record one measured dispatch wall; a change of winner is a
        promotion, counted and saved."""
        key = self._key(kind, bucket)
        promoted = False
        with self._lock:
            st = self._state(key)
            dq = st.samples.get(engine)
            if dq is None:
                dq = st.samples[engine] = deque(maxlen=SAMPLE_WINDOW)
            dq.append(float(seconds))
            new_winner = self._winner_locked(st)
            if new_winner != st.winner:
                promoted = st.winner is not None
                st.winner = new_winner
                if promoted:
                    self._promotions += 1
        if promoted:
            _PROMOTIONS.labels(kind=kind).inc()
            self.save()

    def cost_prior(self, kind: str, bucket: tuple, engine: str, entry: dict | None) -> None:
        """Attach a cost estimate ({"flops", "bytes"}) that orders the
        exploration; None is a no-op."""
        if not entry:
            return
        key = self._key(kind, bucket)
        with self._lock:
            self._state(key).cost[engine] = {
                "flops": float(entry.get("flops", 0.0)),
                "bytes": float(entry.get("bytes", 0.0)),
            }

    # -- partitioned SPF -------------------------------------------------

    def observe_partitioned(self, bucket: tuple, seconds: float) -> None:
        """One warm full partitioned solve's wall, under its own kind: the
        single-path schedule never picks it (``partition_threshold`` routes)."""
        self.observe("partitioned", bucket, "partitioned", seconds)

    def partitioned_advantage(self, bucket: tuple) -> float | None:
        """median(monolithic winner) / median(partitioned) of one bucket; > 1
        means the partitioned path measured faster.  None until both have
        samples."""
        with self._lock:
            st_p = self._table.get(self._key("partitioned", bucket))
            p_med = _median(st_p.samples.get("partitioned", ())) if st_p is not None else None
            st_o = self._table.get(self._key("one", bucket))
            o_med = None
            if st_o is not None:
                w = self._winner_locked(st_o)
                if w is not None:
                    o_med = _median(st_o.samples.get(w, ()))
        if not p_med or not o_med:
            return None
        return o_med / p_med

    # -- DeltaPath depth -------------------------------------------------

    def observe_delta(self, bucket: tuple, seconds: float) -> None:
        """One delta-linked (incremental) dispatch wall."""
        self._observe_depth(bucket, "delta", seconds)

    def observe_full(self, bucket: tuple, seconds: float) -> None:
        """One full-rebuild (re-marshal) dispatch wall."""
        self._observe_depth(bucket, "full", seconds)

    def _observe_depth(self, bucket: tuple, arm: str, seconds: float) -> None:
        with self._lock:
            d = self._depth.setdefault(tuple(bucket), {
                "delta": deque(maxlen=SAMPLE_WINDOW),
                "full": deque(maxlen=SAMPLE_WINDOW),
            })
            d[arm].append(float(seconds))

    def max_delta_depth(self, bucket: tuple, default: int | None = None) -> int:
        """The chain-depth cap of a bucket: round(full / delta) x
        DEPTH_SCALE, clamped to [DEPTH_MIN, DEPTH_MAX], once both arms have
        DEPTH_MIN_SAMPLES walls.  Before that, as ``holo_tpu``: the
        process-wide ``holo_profile_stage_seconds`` medians of the
        ``spf.one`` delta and marshal stages while device profiling is
        armed, and ``default`` without them."""
        if default is None:
            default = self.default_delta_depth
        with self._lock:
            d = self._depth.get(tuple(bucket))
            delta_med = _median(d["delta"]) if d else None
            full_med = _median(d["full"]) if d else None
            enough = d is not None and (len(d["delta"]) >= DEPTH_MIN_SAMPLES
                                        and len(d["full"]) >= DEPTH_MIN_SAMPLES)
        if not enough or not delta_med or full_med is None:
            if not profiling.device_profiling():
                return int(default)
            delta_med = profiling.stage_median("spf.one", "delta")
            full_med = profiling.stage_median("spf.one", "marshal")
            if not delta_med or full_med is None:
                return int(default)
        ratio = max(full_med / delta_med, 1.0)
        return max(DEPTH_MIN, min(DEPTH_MAX, int(round(ratio)) * DEPTH_SCALE))

    # -- persistence -----------------------------------------------------

    @staticmethod
    def _bucket_str(key: tuple) -> str:
        return json.dumps(list(key))

    @staticmethod
    def _bucket_from_str(s: str) -> tuple:
        return tuple(tuple(v) if isinstance(v, list) else v for v in json.loads(s))

    def snapshot(self) -> dict:
        """The persisted document."""
        with self._lock:
            buckets = {
                self._bucket_str(key): {
                    "dispatches": st.dispatches,
                    "winner": st.winner,
                    "samples": {e: [round(v, 9) for v in dq] for e, dq in st.samples.items()},
                    "cost": dict(st.cost),
                }
                for key, st in self._table.items()
            }
            depth = {
                self._bucket_str(b): {arm: [round(v, 9) for v in dq] for arm, dq in d.items()}
                for b, d in self._depth.items()
            }
        return {"version": TABLE_VERSION, "engines": list(self.engines), "buckets": buckets,
                "depth": depth}

    def save(self, path: str | Path | None = None) -> bool:
        """Atomic write (tmp + rename) of the table; False without a path or
        on an OS error (a full disk must not fail a dispatch)."""
        p = Path(path) if path is not None else self.path
        if p is None:
            return False
        try:
            doc = json.dumps(self.snapshot(), sort_keys=True, indent=1)
            tmp = p.with_suffix(p.suffix + ".tmp")
            tmp.write_text(doc + "\n")
            os.replace(tmp, p)
            return True
        except OSError as e:
            log.warning("tuner table save to %s failed: %s", p, e)
            return False

    def load(self, path: str | Path | None = None) -> bool:
        """Load a persisted table; a version mismatch or a corrupt file is
        discarded.  True when state was restored."""
        p = Path(path) if path is not None else self.path
        if p is None or not p.exists():
            return False
        try:
            doc = json.loads(p.read_text())
        except (OSError, ValueError) as e:
            log.warning("tuner table load from %s failed: %s", p, e)
            return False
        if not isinstance(doc, dict) or doc.get("version") != TABLE_VERSION:
            log.info("tuner table %s has version %r (want %d); discarding", p,
                     doc.get("version") if isinstance(doc, dict) else None, TABLE_VERSION)
            return False
        with self._lock:
            self._table.clear()
            for bstr, entry in doc.get("buckets", {}).items():
                try:
                    key = self._bucket_from_str(bstr)
                except ValueError:
                    continue
                st = _BucketState()
                st.dispatches = int(entry.get("dispatches", 0))
                st.winner = entry.get("winner")
                for e, vals in entry.get("samples", {}).items():
                    st.samples[e] = deque([float(v) for v in vals], maxlen=SAMPLE_WINDOW)
                st.cost = {e: dict(c) for e, c in entry.get("cost", {}).items()}
                self._table[key] = st
            self._depth.clear()
            for bstr, d in doc.get("depth", {}).items():
                try:
                    b = self._bucket_from_str(bstr)
                except ValueError:
                    continue
                self._depth[b] = {arm: deque([float(v) for v in vals], maxlen=SAMPLE_WINDOW)
                                  for arm, vals in d.items()}
            self._loaded = True
            _BUCKETS.set(len(self._table))
        return True

    # -- introspection ---------------------------------------------------

    def ledger(self) -> list[dict]:
        """Per-bucket rows: the winner, each measured engine's median wall,
        sample count and cost prior, and what the win rests on."""
        rows = []
        with self._lock:
            for key, st in sorted(self._table.items(), key=lambda kv: self._bucket_str(kv[0])):
                kind, bucket = key[0], key[1:]
                winner = st.winner or self.default_engine
                measured = [e for e in st.samples if _median(st.samples[e]) is not None]
                if len(measured) == 1 and winner not in measured:
                    winner = measured[0]  # a bucket with one formulation (mp)
                engines = {}
                for e in sorted(st.samples):
                    med = _median(st.samples[e])
                    engines[e] = {
                        "median_ms": round(med * 1e3, 4) if med is not None else None,
                        "samples": len(st.samples[e]),
                        "cost": st.cost.get(e),
                    }
                rows.append({"kind": kind, "bucket": list(bucket), "winner": winner,
                             "dispatches": st.dispatches, "engines": engines,
                             "basis": self._win_basis(st, winner)})
        return rows

    def _win_basis(self, st: _BucketState, winner: str) -> str:
        """Why the winner wins: strictly the least estimated bytes ->
        "bytes", the least flops -> "flops", else the wall (under the lock)."""
        if _median(st.samples.get(winner)) is None:
            return "default (no samples)"
        rivals = [e for e in st.samples if e != winner and _median(st.samples[e]) is not None]
        if not rivals:
            return "only measured engine"
        wc = st.cost.get(winner)
        priced = [e for e in rivals if st.cost.get(e)]
        basis = "wall"
        if wc and priced:
            inf = float("inf")
            if all(wc.get("bytes", inf) < st.cost[e].get("bytes", inf) for e in priced):
                basis = "bytes"
            elif all(wc.get("flops", inf) < st.cost[e].get("flops", inf) for e in priced):
                basis = "flops"
        named = sorted(priced if basis in ("bytes", "flops") else rivals)
        return f"{winner} beat {', '.join(named)} on {basis}"

    def stats(self) -> dict:
        """Summary: buckets, promotions, winners, and the decisions by
        (kind, engine, phase)."""
        with self._lock:
            winners = {
                self._bucket_str(key): {
                    "winner": st.winner or self.default_engine,
                    "dispatches": st.dispatches,
                    "measured-engines": sorted(st.samples),
                }
                for key, st in self._table.items()
            }
            return {
                "buckets": len(self._table),
                "promotions": self._promotions,
                "loaded-from-disk": self._loaded,
                "path": str(self.path) if self.path else None,
                "winners": winners,
                "depth-buckets": len(self._depth),
                "decisions": dict(self._decisions),
            }


# -- the process-wide tuner --------------------------------------------

_TUNER: EngineTuner | None = None
_TUNER_LOCK = threading.Lock()


def configure_engine_tuner(path: str | Path | None = None, **kw) -> EngineTuner:
    """Install the process-wide tuner (replacing any previous one)."""
    global _TUNER
    with _TUNER_LOCK:
        _TUNER = EngineTuner(path=path, **kw)
        return _TUNER


def active_tuner() -> EngineTuner | None:
    """The installed tuner, or None (backends keep their pinned engine and
    graph caches their static depth cap)."""
    return _TUNER


def reset_engine_tuner() -> None:
    """Uninstall the process-wide tuner."""
    global _TUNER
    with _TUNER_LOCK:
        _TUNER = None
