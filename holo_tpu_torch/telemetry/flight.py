"""Flight recorder (the port's copy of ``holo_tpu.telemetry.flight``): a
bounded in-memory ring of recent observability events, dumped as a
**postmortem bundle** when something goes wrong.

The ring keeps the last ``capacity`` entries: completed trace spans (tapped
off the default :class:`~holo_tpu_torch.telemetry.trace.SpanTracer`),
event-journal sequence markers (:func:`journal_mark`) and discrete events
(breaker transitions, pipeline sheds and worker crashes, watchdog hangs,
closed convergence events, observatory and SLO sentinel fires).  It is off
by default: disarmed, every seam costs one module-global ``None`` check.

A **postmortem trigger** (:func:`trigger`; the breaker's open transition
calls it) snapshots the ring and, when the caller configured a
``postmortem_dir``, writes one JSON bundle there:

- ``ring``: the recent-event window, spans renumbered from the first
  recorded span, so two runs of one seeded scenario give identical bundles;
- ``metrics``: counter and histogram-count deltas since the recorder was
  armed (gauges and histogram sums depend on wall time and stay on the
  scrape surface);
- ``health``: the breakers that are not closed or have a failure streak;
- ``journal-tail``: the last :data:`JOURNAL_TAIL` journal markers.

Timestamps come from an injectable clock; breaker-name ``#N`` suffixes and
``0x...`` addresses inside strings are scrubbed.  The bundle format
(``holo-postmortem/1``) is ``holo_tpu``'s.  Nothing is written unless the
caller passes a directory.
"""

from __future__ import annotations

import json
import logging
import re
import threading
import time
from collections import deque
from pathlib import Path

from holo_tpu_torch import telemetry

log = logging.getLogger("holo_tpu_torch.telemetry")

#: journal seq markers preserved verbatim in the bundle tail
JOURNAL_TAIL = 32

# Cross-run noise scrubbing for bundle strings: breaker-name "#N" instance
# uniquifiers and object addresses inside reprs.
_UNIQ = re.compile(r"#\d+$")
_ADDR = re.compile(r"0x[0-9a-fA-F]+")


def _scrub(v):
    if isinstance(v, str):
        return _ADDR.sub("0x?", _UNIQ.sub("", v))
    if isinstance(v, (int, float, bool)) or v is None:
        return v
    return _ADDR.sub("0x?", str(v))


class FlightRecorder:
    """One process-wide ring (module singleton via :func:`configure`)."""

    def __init__(self, capacity: int = 2048, postmortem_dir: str | Path | None = None,
                 clock=time.monotonic, min_dump_interval: float = 60.0):
        """``min_dump_interval`` (clock seconds) debounces repeat dumps for
        the same reason: a breaker flapping open over a long outage writes
        one bundle; repeats within the window only land an event in the
        ring."""
        self.capacity = int(capacity)
        self.postmortem_dir = Path(postmortem_dir) if postmortem_dir is not None else None
        self.min_dump_interval = float(min_dump_interval)
        self._clock = clock
        self._t0 = clock()
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=self.capacity)
        self._span_base: int | None = None
        self._dumps = 0
        self._last_dump: dict[str, float] = {}  # scrubbed reason -> clock
        # The metric baseline of the bundle's delta section, taken at arm
        # time with the dump-time walk's normalization.
        self._baseline = self._counts()

    # -- hot-path taps (O(1) each, an append under a short lock)

    def note_span(self, sp) -> None:
        """Tracer completion tap (installed by :func:`configure`)."""
        attrs = {str(k): _scrub(v) for k, v in sp.attrs.items()}
        with self._lock:
            if self._span_base is None:
                self._span_base = sp.span_id
            base = self._span_base
            parent = (sp.parent_id - base
                      if sp.parent_id is not None and sp.parent_id >= base else None)
            self._ring.append(("span", sp.name, sp.span_id - base, parent,
                               round(sp.start_us, 3), round(sp.dur_us, 3), attrs))

    def journal_mark(self, seq: int, actor: str = "") -> None:
        """Event-journal position marker."""
        t = round(self._clock() - self._t0, 6)
        with self._lock:
            self._ring.append(("journal", int(seq), str(actor), t))

    def event(self, kind: str, **fields) -> None:
        """A discrete event (breaker transition, postmortem trigger, ...)."""
        t = round(self._clock() - self._t0, 6)
        clean = {str(k): _scrub(v) for k, v in sorted(fields.items())}
        with self._lock:
            self._ring.append(("event", kind, clean, t))

    # -- bundle assembly (cold path)

    @staticmethod
    def _counts() -> dict[str, float]:
        """{normalized series name -> monotone count}: counter values and
        histogram counts; normalized-name collisions (breaker uniquifiers)
        sum."""
        out: dict[str, float] = {}
        for fam in telemetry.registry().families():
            if fam.kind == "gauge":
                continue
            for key, child in fam.children():
                labels = ",".join(_UNIQ.sub("", f"{n}={v}") for n, v in zip(fam.labelnames, key))
                name = f"{fam.name}{{{labels}}}" if labels else fam.name
                cur = child.count if fam.kind == "histogram" else child.value
                out[name] = out.get(name, 0) + cur
        return out

    def metric_deltas(self) -> dict[str, float]:
        cur = self._counts()
        out = {}
        for name, v in cur.items():
            d = v - self._baseline.get(name, 0)
            if d:
                out[name] = int(d) if float(d).is_integer() else d
        return out

    @staticmethod
    def _health() -> dict:
        """The breakers a postmortem reader cares about: not closed, or
        with a failure streak (names normalized).  The port has no actor
        supervisor, so there is no ``supervision`` entry."""
        from holo_tpu_torch.resilience.breaker import breakers

        brs = {}
        for name, br in breakers().items():
            snap = br.snapshot()
            if snap["state"] == "closed" and not snap["consecutive-failures"]:
                continue
            snap["last-error"] = _scrub(snap.get("last-error", ""))
            brs[_UNIQ.sub("", name)] = snap
        return {"breakers": brs} if brs else {}

    def snapshot_ring(self) -> list:
        with self._lock:
            return list(self._ring)

    def postmortem(self, reason: str, extra: dict | None = None):
        """Assemble and (with a directory) write one bundle.  Returns
        ``(path | None, bundle)``, or ``(None, None)`` when the same reason
        already dumped within ``min_dump_interval``.  File names are a dump
        ordinal and a reason slug: no wall-clock component."""
        ring = self.snapshot_ring()
        with self._lock:
            key = _scrub(reason)
            now = self._clock()
            last = self._last_dump.get(key)
            if last is not None and now - last < self.min_dump_interval:
                log.debug("postmortem for %r debounced (%.1fs since last)", key, now - last)
                return None, None
            self._last_dump[key] = now
            self._dumps += 1
            n = self._dumps
        tail = [e for e in ring if e[0] == "journal"][-JOURNAL_TAIL:]
        bundle = {
            "schema": "holo-postmortem/1",
            "reason": _scrub(reason),
            "dump": n,
            "ring": [list(e) for e in ring],
            "metrics": self.metric_deltas(),
            "health": self._health(),
            "journal-tail": [[e[1], e[2]] for e in tail],
        }
        if extra:
            bundle["extra"] = {str(k): _scrub(v) for k, v in extra.items()}
        path = None
        if self.postmortem_dir is not None:
            text = json.dumps(bundle, sort_keys=True, indent=2)
            slug = re.sub(r"[^A-Za-z0-9._-]+", "-", bundle["reason"])[:48]
            self.postmortem_dir.mkdir(parents=True, exist_ok=True)
            path = self.postmortem_dir / f"postmortem-{n:03d}-{slug}.json"
            path.write_text(text + "\n")
            log.warning("postmortem bundle written: %s", path)
        return path, bundle

    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._ring), "capacity": self.capacity, "dumps": self._dumps}


# -- process-wide singleton ---------------------------------------------

_RECORDER: FlightRecorder | None = None


def configure(entries: int = 0, postmortem_dir: str | Path | None = None,
              clock=None) -> FlightRecorder | None:
    """Arm (``entries`` > 0) or disarm (0) the process-wide recorder and
    (un)install the tracer completion tap.  Arming also swaps the default
    tracer onto the same clock (epoch reset), so the spans and the event
    stamps of one bundle share a timebase; disarming restores
    ``time.monotonic``."""
    global _RECORDER
    tracer = telemetry.tracer()
    if entries and int(entries) > 0:
        clk = clock or time.monotonic
        _RECORDER = FlightRecorder(int(entries), postmortem_dir, clk)
        tracer.use_clock(clk)
        tracer.on_complete = _RECORDER.note_span
    else:
        _RECORDER = None
        tracer.on_complete = None
        tracer.use_clock(time.monotonic)
    return _RECORDER


def recorder() -> FlightRecorder | None:
    return _RECORDER


def enabled() -> bool:
    return _RECORDER is not None


def journal_mark(seq: int, actor: str = "") -> None:
    r = _RECORDER
    if r is not None:
        r.journal_mark(seq, actor)


def event(kind: str, **fields) -> None:
    r = _RECORDER
    if r is not None:
        r.event(kind, **fields)


def trigger(reason: str, extra: dict | None = None) -> Path | None:
    """Postmortem capture: record the trigger in the ring, then dump a
    bundle (armed, with a directory).  The callers are failure paths, so a
    dump failure is logged, never raised."""
    r = _RECORDER
    if r is None:
        return None
    r.event("postmortem-trigger", reason=reason)
    try:
        path, _ = r.postmortem(reason, extra=extra)
        return path
    except Exception:  # noqa: BLE001 -- forensics must not worsen faults
        log.exception("postmortem dump failed (reason=%s)", reason)
        return None
