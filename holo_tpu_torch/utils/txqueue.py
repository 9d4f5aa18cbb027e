"""Per-interface transmit tasks with bounded backpressure.

The reference gives every interface a dedicated Tx task fed over a
bounded channel (holo-ospf/src/tasks.rs:288-348): packet production is
decoupled from the kernel send, a slow interface exerts backpressure on
its own producers only, and per-interface ordering is preserved.

:class:`TxTaskNetIo` is the NetIo-wrapping analog: one daemon thread +
bounded queue per interface, created lazily on first send.  By default
a full queue blocks the producer (the reference's bounded mpsc
semantics); an optional ``put_timeout`` bounds that blocking and drops
on expiry instead.  `close()` drains each queue before joining.  Every
drop is cause-attributed (``overflow`` / ``send_error`` for a packet
the wire send lost / ``closed`` for late sends after teardown).
"""

from __future__ import annotations

import queue
import threading

from holo_tpu_torch import telemetry
from holo_tpu_torch.utils.netio import NetIo

_STOP = object()

# Per-interface Tx task observability: queue depth is the backpressure
# signal (a climbing depth = the wire can't keep up with production).
# Drops carry a cause so an incident can be attributed without a
# packet capture: "overflow" (bounded enqueue timed out against a
# wedged wire), "send_error" (the kernel send raised — the breaker's
# degraded path surfaces here when a dead interface eats the retry),
# "closed" (late send after teardown).
_TX_SENT = telemetry.counter(
    "holo_txqueue_sent_total", "Packets sent by per-interface Tx tasks", ("ifname",)
)
_TX_ERRORS = telemetry.counter(
    "holo_txqueue_errors_total", "Tx task sends that raised", ("ifname",)
)
_TX_DROPPED = telemetry.counter(
    "holo_txqueue_dropped_total",
    "Packets dropped by per-interface Tx tasks, by cause",
    ("ifname", "cause"),
)
_TX_DEPTH = telemetry.gauge(
    "holo_txqueue_depth", "Tx queue depth at last enqueue", ("ifname",)
)


class _IfaceTxTask:
    def __init__(self, ifname: str, inner: NetIo, maxsize: int):
        self.ifname = ifname
        self.inner = inner
        self.q: queue.Queue = queue.Queue(maxsize=maxsize)
        self.sent = 0
        self.thread = threading.Thread(
            target=self._pump, name=f"tx-{ifname}", daemon=True
        )
        self.thread.start()

    def _pump(self) -> None:
        while True:
            item = self.q.get()
            if item is _STOP:
                return
            src, dst, data = item
            try:
                self.inner.send(self.ifname, src, dst, data)
                self.sent += 1
                _TX_SENT.labels(ifname=self.ifname).inc()
            except Exception:  # noqa: BLE001 — a bad send must not kill tx
                # The accepted packet is gone: attribute the loss.
                _TX_ERRORS.labels(ifname=self.ifname).inc()
                _TX_DROPPED.labels(
                    ifname=self.ifname, cause="send_error"
                ).inc()

    def request_stop(self) -> None:
        try:
            # Bounded put with a timeout: a wedged wire (consumer stuck
            # in a kernel send) must not hang daemon teardown forever.
            self.q.put(_STOP, timeout=5)
        except queue.Full:
            pass

    def join(self) -> None:
        self.thread.join(timeout=5)

    def stop(self) -> None:
        self.request_stop()
        self.join()


class TxTaskNetIo(NetIo):
    """NetIo decorator: routes each interface's sends through its own
    bounded Tx task (reference tasks.rs per-interface Tx channels)."""

    def __init__(
        self,
        inner: NetIo,
        maxsize: int = 256,
        put_timeout: float | None = None,
    ):
        """``put_timeout`` bounds how long a producer blocks against a
        full queue: None (default) keeps the reference's block-forever
        backpressure; a number makes the enqueue drop after that many
        seconds with cause="overflow" — the posture for producers that
        must not wedge behind a dead wire (e.g. a degraded daemon
        draining at shutdown)."""
        self.inner = inner
        self.maxsize = maxsize
        self.put_timeout = put_timeout
        self._tasks: dict[str, _IfaceTxTask] = {}
        self._lock = threading.Lock()
        self._closed = False

    def _task(self, ifname: str) -> "_IfaceTxTask | None":
        t = self._tasks.get(ifname)
        if t is None:
            with self._lock:
                if self._closed:
                    return None
                t = self._tasks.get(ifname)
                if t is None:
                    t = _IfaceTxTask(ifname, self.inner, self.maxsize)
                    self._tasks[ifname] = t
        return t

    def send(self, ifname, src, dst, data) -> None:
        # Bounded put: a slow interface applies backpressure to ITS
        # producer only (block, never drop) — other interfaces' tasks
        # keep draining independently.  A late send after close() (an
        # instance handler that outlived its 5s teardown join) is
        # dropped: resurrecting a task here would leak its thread.
        t = self._task(ifname)
        if t is None:
            _TX_DROPPED.labels(ifname=ifname, cause="closed").inc()
            return
        try:
            if self.put_timeout is None:
                t.q.put((src, dst, data))
            else:
                t.q.put((src, dst, data), timeout=self.put_timeout)
        except queue.Full:
            _TX_DROPPED.labels(ifname=ifname, cause="overflow").inc()
            # The gauge must show the pinned-full queue during the very
            # incident the drop cause attributes, not the depth of the
            # last successful enqueue.
            _TX_DEPTH.labels(ifname=ifname).set(t.q.qsize())
            return
        _TX_DEPTH.labels(ifname=ifname).set(t.q.qsize())

    def __getattr__(self, name: str):
        # Forward everything we don't override to the wrapped NetIo:
        # protocol engines probe transport-specific surface (e.g. BGP's
        # session_reset on BgpTcpIo) via getattr, and wrapping under
        # threaded isolation must not hide it.
        inner = self.__dict__.get("inner")
        if inner is None:
            raise AttributeError(name)
        return getattr(inner, name)

    def queue_depth(self, ifname: str) -> int:
        t = self._tasks.get(ifname)
        return t.q.qsize() if t is not None else 0

    def close(self) -> None:
        # Two-phase: request every stop FIRST, then join — teardown cost
        # is the slowest single task, not the sum over interfaces.
        with self._lock:
            self._closed = True
            tasks = list(self._tasks.values())
            self._tasks.clear()
        for t in tasks:
            t.request_stop()
        for t in tasks:
            t.join()
