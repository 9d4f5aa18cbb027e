"""Preemptive instance isolation: one event loop per OS thread.

The reference runs every protocol instance on a dedicated OS thread via
``spawn_blocking`` so a long computation in one instance cannot stall
another's hello/dead-timer processing (holo-protocol/src/lib.rs:419-430;
its ``testing`` feature downgrades to cooperative scheduling, exactly
like our single EventLoop).  This module is the production-side analog:

- :class:`ThreadedLoop` hosts ONE EventLoop (real clock) on its own
  thread, waking on cross-thread sends and on timer deadlines;
- :class:`LoopRouter` routes the primary loop's sends to the loop that
  hosts each instance, and :class:`InstanceHandle` marshals the providers'
  calls onto it.

(The port's copy of ``holo_tpu.utils.preempt``, without its test-only
cross-thread mock wire.)

Python's GIL means CPU-bound work still serializes, but any blocking
call (kernel IO, the device backend round-trip, a C extension releasing the
GIL) no longer freezes unrelated instances — which is precisely the
reference's isolation property.
"""

from __future__ import annotations

import threading
from typing import Any

from holo_tpu_torch.utils.runtime import Actor, EventLoop, RealClock


class ThreadedLoop:
    """An EventLoop pumped by a dedicated thread.

    ``send`` is thread-safe: it enqueues under the loop's lock and wakes
    the pump.  All actor callbacks run on this loop's thread only — the
    single-writer actor discipline is preserved per thread.
    """

    def __init__(self, name: str = "threaded-loop"):
        self.loop = EventLoop(clock=RealClock())
        self.name = name
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._stop = False
        # Pump-death containment: an exception escaping the loop
        # machinery itself (not a handler — those are contained by the
        # EventLoop) kills the pump thread.  The callback lets a
        # supervisor respawn it under its restart policy instead of the
        # instance silently going deaf.
        self.on_pump_crash = None  # callable(exc) | None
        self.pump_crashes = 0
        self._thread = threading.Thread(
            target=self._pump, name=name, daemon=True
        )

    def start(self) -> "ThreadedLoop":
        self._thread.start()
        return self

    def pump_alive(self) -> bool:
        return self._thread.is_alive()

    def respawn(self) -> bool:
        """Start a fresh pump thread after a pump crash (the supervisor
        restart primitive for the pump itself).  The loop's actors,
        inboxes, and timers are untouched — only the thread died — so
        pending mail drains as soon as the new pump runs.  False when
        the old thread is still alive (nothing to do) or the loop was
        stopped on purpose."""
        with self._wake:
            if self._stop or self._thread.is_alive():
                return False
            self._thread = threading.Thread(
                target=self._pump, name=self.name, daemon=True
            )
        self._thread.start()
        return True

    def register(self, actor: Actor, name: str | None = None) -> None:
        with self._lock:
            self.loop.register(actor, name=name)

    def send(self, actor: str, msg: Any) -> bool:
        # Enqueue WITHOUT the lock (deque appends are GIL-atomic and the
        # pump never holds the lock while running handlers — holding it
        # there would AB-BA deadlock two loops sending to each other).
        ok = self.loop.send(actor, msg)
        with self._wake:
            self._wake.notify()
        return ok

    def call(self, fn, *args) -> Any:
        """Run ``fn(*args)`` on the loop thread and return its result.

        Exceptions raised by ``fn`` propagate to the caller (a commit-time
        reconfiguration error must fail the commit, exactly as it would
        under cooperative scheduling), and a pump that never answers
        raises ``TimeoutError`` rather than silently returning ``None``.
        """
        done = threading.Event()
        box: list = []
        err: list = []
        # pending -> running -> finished, or pending -> cancelled: a call
        # that times out before the pump picked it up is CANCELLED so the
        # closure can never run after the caller was told it failed; only
        # a closure already mid-run at the deadline may still complete
        # (nothing can preempt it), and the TimeoutError says which case
        # happened.
        state = {"v": "pending"}
        state_lock = threading.Lock()

        class _Call(Actor):
            name = f"_call_{id(done)}"

            def handle(self, msg):
                with state_lock:
                    if state["v"] == "cancelled":
                        return
                    state["v"] = "running"
                try:
                    box.append(fn(*args))
                except BaseException as exc:  # noqa: BLE001 — re-raised in caller
                    err.append(exc)
                finally:
                    state["v"] = "finished"
                    done.set()

        with self._lock:
            self.loop.register(_Call())
        self.send(_Call.name, ())
        ok = done.wait(timeout=10)
        with self._lock:
            self.loop.unregister(_Call.name)
        if not ok:
            with state_lock:
                current = state["v"]
                if current == "pending":
                    state["v"] = "cancelled"
                started = current != "pending"
            if current == "finished":
                # Finished in the race window between wait() and here:
                # it's a success, report it as one.
                if err:
                    raise err[0]
                return box[0] if box else None
            raise TimeoutError(
                f"{self.name}: call() timed out after 10s "
                + (
                    "(closure still running; its effects may still apply)"
                    if started
                    else "(closure cancelled before starting)"
                )
            )
        if err:
            raise err[0]
        return box[0] if box else None

    def introspect(self) -> dict:
        """Snapshot of the inner loop plus thread liveness.  Taken under
        the loop lock: register/unregister mutate the actor dict from
        other threads, and iterating it unlocked could see a resize."""
        with self._lock:
            out = self.loop.introspect()
        out["thread-alive"] = self._thread.is_alive()
        return out

    def stop(self) -> None:
        with self._wake:
            self._stop = True
            self._wake.notify()
        self._thread.join(timeout=5)

    def _pump(self) -> None:
        try:
            self._pump_body()
        except Exception as exc:  # noqa: BLE001 — pump-death containment
            # Handler exceptions never reach here (EventLoop contains
            # them); this is the loop machinery itself dying (a raising
            # timer msg_fn, a broken clock).  Report to the supervisor
            # hook so the pump can be respawned under policy.
            self.pump_crashes += 1
            import logging

            logging.getLogger("holo_tpu_torch.runtime").exception(
                "pump thread %s died", self.name
            )
            hook = self.on_pump_crash
            if hook is not None:
                hook(exc)

    def _pump_body(self) -> None:
        while True:
            with self._wake:
                if self._stop:
                    return
            # Handlers run with NO lock held: a handler's cross-loop send
            # (fabric delivery to a peer loop) must never wait on us.
            self.loop.run_until_idle()
            nd = self.loop.next_deadline()
            now = self.loop.clock.now()
            timeout = max(nd - now, 0.0) if nd is not None else 0.5
            with self._wake:
                if self._stop:
                    return
                if not self.loop._ready:
                    # A send landing between run_until_idle and here
                    # leaves _ready non-empty and we skip the wait.
                    self._wake.wait(timeout=min(timeout, 0.5))


class LoopRouter:
    """EventLoop facade that routes per-actor sends across loops.

    The daemon's shared components (ibus, providers, netio pumps) talk to
    ONE loop object; with preemptive isolation each protocol instance
    actually lives on its own :class:`ThreadedLoop`.  The router keeps a
    name -> owning-loop map: ``send`` posts to the owner (waking its pump
    thread), everything else (timers, registration of main-loop actors,
    clock, idle pumping) delegates to the primary loop.  This mirrors the
    reference's channel topology, where per-instance threads receive
    their messages over dedicated channels while shared services stay on
    the main runtime (holo-protocol/src/lib.rs:419-430).
    """

    def __init__(self, primary: EventLoop):
        self.primary = primary
        self._remote: dict[str, ThreadedLoop] = {}

    def register_remote(self, name: str, owner: ThreadedLoop) -> None:
        self._remote[name] = owner

    def unregister_remote(self, name: str) -> None:
        self._remote.pop(name, None)

    def send(self, actor: str, msg: Any) -> bool:
        owner = self._remote.get(actor)
        if owner is not None:
            return owner.send(actor, msg)
        return self.primary.send(actor, msg)

    def register(self, actor: Actor, name: str | None = None) -> None:
        """Register on the primary loop but attach the ROUTER as the
        actor's loop, so the actor's own sends keep routing to remote
        instances (EventLoop.register would attach the raw loop)."""
        self.primary.register(actor, name=name)
        actor.loop = self

    def __getattr__(self, attr):
        return getattr(self.primary, attr)


class _MarshalCall:
    """Message processed on the primary loop: run a stored closure.

    Instance-side callbacks (route_cb and friends) must not mutate
    provider/RIB state from the instance's thread — they are marshalled
    back to the primary loop as these messages and executed there, under
    the same serialization as every other provider message.
    """

    __slots__ = ("fn", "args", "event_id")

    def __init__(self, fn, args):
        self.fn = fn
        self.args = args
        # Causal stamp: a route_cb marshalled off an instance thread
        # mid-SPF carries the convergence event ids across the thread
        # hop (the primary loop's delivery hook re-activates them).
        from holo_tpu_torch.telemetry import convergence

        self.event_id = convergence.current() or None


class CallRunner(Actor):
    """Primary-loop actor executing marshalled closures."""

    name = "call-runner"

    def handle(self, msg) -> None:
        if isinstance(msg, _MarshalCall):
            msg.fn(*msg.args)


class InstanceHandle:
    """Provider-side proxy for an instance living on a ThreadedLoop.

    Method calls are marshalled onto the instance's own thread
    (synchronously, via :meth:`ThreadedLoop.call`) so commit-time
    reconfiguration never races the instance's handlers; attribute reads
    pass through (operational-state rendering reads are point-in-time
    snapshots — same guarantees the reference's state queries have).
    """

    _PASSTHROUGH = {"_inst", "_tl"}

    def __init__(self, inst: Actor, tl: ThreadedLoop):
        object.__setattr__(self, "_inst", inst)
        object.__setattr__(self, "_tl", tl)

    def __getattr__(self, attr):
        val = getattr(self._inst, attr)
        if callable(val) and not attr.startswith("__"):
            tl = self._tl

            def marshalled(*args, **kwargs):
                return tl.call(lambda: val(*args, **kwargs))

            return marshalled
        return val

    def __setattr__(self, attr, value):
        setattr(self._inst, attr, value)
