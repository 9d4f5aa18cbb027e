"""Lightweight span tracer: bounded ring of completed spans, exported
as Chrome trace-event JSON (load in chrome://tracing or Perfetto).

Spans nest per thread (a threadlocal stack); the active span id is
exposed for log correlation (the daemon's JSON log formatter stamps it
on every record so log lines join against trace dumps).  The ring is
bounded — a long-running daemon keeps the most recent ``capacity``
spans, never unbounded memory.

``HOLO_TPU_TORCH_TRACE_DUMP=<path>`` (checked at package import) registers an
atexit dump of the default tracer, so any run — bench stage, test,
daemon — can be traced without code changes.
"""

from __future__ import annotations

import itertools
import json
import logging
import threading
import time
from collections import deque
from contextlib import contextmanager

log = logging.getLogger("holo_tpu_torch.telemetry")


class Span:
    __slots__ = (
        "span_id", "parent_id", "name", "start_us", "dur_us", "tid", "attrs"
    )

    def __init__(self, span_id, parent_id, name, start_us, dur_us, tid, attrs):
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.start_us = start_us
        self.dur_us = dur_us
        self.tid = tid
        self.attrs = attrs


class SpanTracer:
    def __init__(self, capacity: int = 4096):
        self.capacity = capacity
        self._spans: deque[Span] = deque(maxlen=capacity)
        self._ids = itertools.count(1)
        self._lock = threading.Lock()
        self._tls = threading.local()
        self.clock = time.monotonic
        self._epoch = time.monotonic()
        self.enabled = True
        # Completion tap (the flight recorder): called with each Span
        # AFTER it is appended to the ring, outside the ring lock.
        self.on_complete = None

    def use_clock(self, clock, epoch: float | None = None) -> None:
        """Swap the time source (chaos tests pass the virtual loop
        clock so span start/duration — and everything downstream, the
        flight-recorder ring included — becomes deterministic).  The
        epoch defaults to ``clock()`` at the swap, so timestamps start
        near zero under either source."""
        self.clock = clock
        self._epoch = clock() if epoch is None else epoch

    # -- context (threadlocal span stack + instance name)

    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def current_span_id(self) -> int | None:
        st = getattr(self._tls, "stack", None)
        return st[-1][0] if st else None

    def current_instance(self) -> str | None:
        """Innermost enclosing span's ``instance`` attribute (protocol
        instances tag their spans; log records inherit the tag)."""
        st = getattr(self._tls, "stack", None)
        if not st:
            return None
        for span_id, attrs in reversed(st):
            inst = attrs.get("instance")
            if inst is not None:
                return str(inst)
        return None

    # -- recording

    @contextmanager
    def span(self, name: str, **attrs):
        if not self.enabled:
            yield None
            return
        span_id = next(self._ids)
        st = self._stack()
        parent = st[-1][0] if st else None
        st.append((span_id, attrs))
        t0 = self.clock()
        try:
            yield span_id
        finally:
            dur = self.clock() - t0
            st.pop()
            sp = Span(
                span_id,
                parent,
                name,
                (t0 - self._epoch) * 1e6,
                dur * 1e6,
                threading.get_ident() & 0xFFFFFFFF,
                attrs,
            )
            with self._lock:
                self._spans.append(sp)
            hook = self.on_complete
            if hook is not None:
                try:
                    hook(sp)
                except Exception:  # noqa: BLE001 — a tap must never
                    # break the traced code path (the failure is still
                    # surfaced, at debug level).
                    log.debug("span completion tap failed", exc_info=True)

    def spans(self) -> list[Span]:
        with self._lock:
            return list(self._spans)

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()

    # -- export

    def to_chrome_trace(
        self, process_name: str = "holo_tpu_torch", spans: list[Span] | None = None
    ) -> dict:
        """Chrome trace-event JSON object format (perfetto-loadable):
        one complete ('X') event per span, µs timestamps.  ``spans``
        lets a caller render a snapshot it already took (dump() —
        otherwise a span completing concurrently could make the counted
        and rendered sets differ)."""
        events = [
            {
                "name": "process_name",
                "ph": "M",
                "pid": 1,
                "tid": 0,
                "args": {"name": process_name},
            }
        ]
        for sp in self.spans() if spans is None else spans:
            args = {
                k: (v if isinstance(v, (int, float, bool, str)) else str(v))
                for k, v in sp.attrs.items()
            }
            args["span_id"] = sp.span_id
            if sp.parent_id is not None:
                args["parent_id"] = sp.parent_id
            events.append(
                {
                    "name": sp.name,
                    "ph": "X",
                    "ts": round(sp.start_us, 3),
                    "dur": round(sp.dur_us, 3),
                    "pid": 1,
                    "tid": sp.tid,
                    "args": args,
                }
            )
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def dump(self, path) -> int:
        """Write the Chrome trace JSON; returns the span count dumped."""
        spans = self.spans()
        with open(path, "w") as fh:
            json.dump(self.to_chrome_trace(spans=spans), fh)
        return len(spans)
