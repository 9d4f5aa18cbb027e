"""Actor runtime: event loop, typed messages, timers, deterministic clock.

Design (vs reference holo-protocol/src/lib.rs:383-435 + holo-utils/src/task.rs):
the reference gives each protocol instance an OS thread with a Tokio event
loop and swaps timers/sockets for no-ops under its `testing` feature.  Here
every actor shares one cooperative event loop whose clock is pluggable:

- ``RealClock`` — wall time; the loop sleeps until the next timer/IO.
- ``VirtualClock`` — tests advance time explicitly; timers fire in exact
  deadline order, messages deliver FIFO — fully reproducible runs without
  mocking timers away (stronger determinism than the reference's no-op
  timers, since timer-driven behavior is actually exercised).

Messages are plain dataclasses; delivery is per-actor FIFO.  Panic
containment mirrors holo-protocol/src/lib.rs:344-360: an exception in one
actor's handler stops that actor only and notifies its supervisor.
"""

from __future__ import annotations

import heapq
import itertools
import logging
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable

log = logging.getLogger("holo_tpu_torch.runtime")

# Delivery-context hook (the convergence observatory's propagation
# seam): when installed, every message delivery asks the hook for a
# context manager derived from the message (e.g. re-activating the
# causal event ids an IbusMsg was stamped with) and runs the handler
# inside it.  None (the default) costs one module-global check per
# delivery; the hook returning None means "no context for this message".
_DELIVERY_CONTEXT = None


def set_delivery_context(fn) -> None:
    """Install/clear the delivery-context hook (``fn(msg) -> context
    manager | None``).  Installed by
    :func:`holo_tpu_torch.telemetry.convergence.configure`; tests may stack
    their own as long as they restore the previous value."""
    global _DELIVERY_CONTEXT
    _DELIVERY_CONTEXT = fn


class RealClock:
    def now(self) -> float:
        return time.monotonic()


class VirtualClock:
    """Deterministic clock; time moves only via advance()."""

    def __init__(self) -> None:
        self._now = 0.0

    def now(self) -> float:
        return self._now

    def advance(self, dt: float) -> None:
        self._now += dt


@dataclass(order=True)
class _TimerEntry:
    deadline: float
    seq: int
    timer: "Timer" = field(compare=False)


class Timer:
    """One-shot timer delivering a message to an actor; reset/cancel-able.

    Equivalent of TimeoutTask (holo-utils/src/task.rs:167-233); IntervalTask
    is modeled by the actor re-arming in its handler (keeps re-arm policy —
    jitter, backoff — in protocol code where the RFCs put it).
    """

    def __init__(self, loop_: "EventLoop", actor: str, msg_fn: Callable[[], Any]):
        self._loop = loop_
        self._actor = actor
        self._msg_fn = msg_fn
        self._armed_seq: int | None = None
        self.deadline: float | None = None

    @property
    def armed(self) -> bool:
        return self._armed_seq is not None

    def remaining(self) -> float | None:
        if self.deadline is None:
            return None
        return max(0.0, self.deadline - self._loop.clock.now())

    def start(self, delay: float) -> None:
        self.cancel()
        self.deadline = self._loop.clock.now() + delay
        self._armed_seq = self._loop._arm(self)

    reset = start

    def cancel(self) -> None:
        self._armed_seq = None
        self.deadline = None

    def _fire(self, seq: int) -> None:
        if self._armed_seq != seq:
            return  # canceled or reset since arming
        self._armed_seq = None
        self.deadline = None
        self._loop.send(self._actor, self._msg_fn())


class Actor:
    """Base actor: single-writer state, message handler, crash containment."""

    name: str = "actor"

    def attach(self, loop_: "EventLoop") -> None:
        self.loop = loop_

    def handle(self, msg: Any) -> None:  # pragma: no cover - interface
        raise NotImplementedError

    def on_stop(self) -> None:
        """Cleanup hook (channel-drop cascade equivalent)."""

    def on_restart(self) -> None:
        """Supervised-restart hook: called after a crash, before held
        mail is redelivered.  Default is a no-op — actor state survives
        the crash (single-writer discipline means it was only ever
        mutated by the handler that raised); override to re-arm
        resources the crash may have orphaned."""


@dataclass
class ActorCrashed:
    """Supervision notice (panic containment, holo-protocol/src/lib.rs:344-360)."""

    actor: str
    error: BaseException


@dataclass
class PoisonPill:
    """Fault-injection message: its delivery raises inside the target
    actor's handler frame, exercising the crash-containment and
    supervision path exactly as a real handler exception would — the
    actor-kill seam of ``holo_tpu``'s chaos harness (its
    ``resilience.faults``; the port's copy keeps only the dispatch seams).  Serializes through the event recorder like any message."""

    reason: str = "injected"


class InjectedCrash(RuntimeError):
    """The exception a delivered :class:`PoisonPill` raises."""


class EventLoop:
    """Cooperative scheduler: per-actor FIFO inboxes + timer heap + IO.

    IO sources register a (fileno, callback) pair; in virtual-clock mode IO
    is driven by tests injecting messages instead (mock sockets).
    """

    # Bound on mail held for a crashed-but-supervised actor: a restart
    # policy that never fires (or a long backoff) must not let one dead
    # actor's inbox grow without limit.
    held_mail_limit = 4096

    def __init__(self, clock=None):
        self.clock = clock if clock is not None else RealClock()
        self.actors: dict[str, Actor] = {}
        self._inboxes: dict[str, deque] = {}
        self._ready: deque[str] = deque()
        self._timers: list[_TimerEntry] = []
        self._seq = itertools.count()
        self._crashed: dict[str, BaseException] = {}
        self._supervisor: Callable[[ActorCrashed], None] | None = None
        self._stopping = False
        self._delivered: dict[str, int] = {}
        # Supervised loops hold mail for crashed actors (redelivered on
        # restart) instead of refusing it; plain loops keep the original
        # drop semantics.  Abandoned actors (crash-loop -> permanent
        # degraded) refuse mail even on supervised loops.
        self._hold_crashed = False
        self._abandoned: set[str] = set()
        self._held_dropped: dict[str, int] = {}

    # -- actors

    def register(self, actor: Actor, name: str | None = None) -> None:
        name = name or actor.name
        if name in self.actors:
            raise ValueError(f"actor {name!r} already registered")
        actor.name = name
        actor.attach(self)
        self.actors[name] = actor
        self._inboxes[name] = deque()

    def unregister(self, name: str) -> None:
        actor = self.actors.pop(name, None)
        self._inboxes.pop(name, None)
        self._crashed.pop(name, None)
        self._delivered.pop(name, None)
        self._abandoned.discard(name)
        self._held_dropped.pop(name, None)
        if actor is not None:
            actor.on_stop()

    def set_supervisor(
        self,
        fn: Callable[[ActorCrashed], None],
        hold_crashed: bool = False,
    ) -> None:
        """Install the crash-notice callback.  ``hold_crashed`` opts the
        loop into held mail: sends to a crashed actor queue (bounded by
        :attr:`held_mail_limit`) for redelivery at :meth:`restart_actor`
        — the timer re-arm chains protocol actors depend on (hello ->
        handler -> re-arm) survive a supervised restart this way."""
        self._supervisor = fn
        self._hold_crashed = bool(hold_crashed)

    def restart_actor(self, name: str) -> bool:
        """Clear an actor's crashed state and redeliver held mail.

        The supervision restart primitive: state is NOT reset (single
        writer means only the raising handler touched it); the actor's
        :meth:`Actor.on_restart` hook runs first and a raise there
        counts as a fresh crash (notifying the supervisor again)."""
        if name not in self._crashed or name in self._abandoned:
            return False
        actor = self.actors.get(name)
        if actor is None:
            return False
        del self._crashed[name]
        try:
            actor.on_restart()
        except Exception as exc:
            log.exception("actor %s crashed in on_restart", name)
            self._crashed[name] = exc
            if self._supervisor:
                self._supervisor(ActorCrashed(name, exc))
            return False
        inbox = self._inboxes.get(name)
        if inbox:
            self._ready.extend([name] * len(inbox))
        return True

    def abandon_actor(self, name: str) -> None:
        """Permanent-degraded: drop held mail and refuse future sends
        (the crash-loop terminal state; only unregister clears it)."""
        self._abandoned.add(name)
        inbox = self._inboxes.get(name)
        if inbox:
            inbox.clear()

    # -- messaging

    def send(self, actor: str, msg: Any) -> bool:
        """Enqueue msg to actor's inbox; False if actor unknown/crashed
        (crashed-but-supervised actors hold mail, see set_supervisor)."""
        inbox = self._inboxes.get(actor)
        if inbox is None or actor in self._abandoned:
            return False
        if actor in self._crashed:
            if self._hold_crashed:
                if len(inbox) >= self.held_mail_limit:
                    self._held_dropped[actor] = (
                        self._held_dropped.get(actor, 0) + 1
                    )
                    return False
                inbox.append(msg)  # no _ready entry until restart
                if actor not in self._crashed:
                    # Cross-thread race: restart_actor cleared the crash
                    # between our check and the append.  restart deletes
                    # _crashed BEFORE it counts the inbox, so seeing it
                    # cleared here means its token sweep may have missed
                    # this message — schedule it (surplus tokens are
                    # harmless, an unscheduled message is lost).
                    self._ready.append(actor)
                return True
            return False
        inbox.append(msg)
        self._ready.append(actor)
        return True

    # -- timers

    def timer(self, actor: str, msg_fn: Callable[[], Any]) -> Timer:
        return Timer(self, actor, msg_fn)

    def _arm(self, t: Timer) -> int:
        seq = next(self._seq)
        heapq.heappush(self._timers, _TimerEntry(t.deadline, seq, t))
        return seq

    def next_deadline(self) -> float | None:
        while self._timers:
            e = self._timers[0]
            if e.timer._armed_seq == e.seq:
                return e.deadline
            heapq.heappop(self._timers)  # stale (canceled/reset)
        return None

    # -- introspection

    def introspect(self) -> dict:
        """Live scheduler snapshot — the reference gates the equivalent
        behind its tokio_console feature (holo-daemon/src/main.rs:115-133);
        here it is always-on state the management plane can serve.

        Read-only by design: it scans the timer heap instead of calling
        :meth:`next_deadline` (whose stale-entry pops would race the
        pump thread when a ThreadedLoop is inspected cross-thread)."""
        now = self.clock.now()
        armed = sum(
            1 for e in self._timers if e.timer._armed_seq == e.seq
        )
        nd = min(
            (
                e.deadline
                for e in self._timers
                if e.timer._armed_seq == e.seq
            ),
            default=None,
        )
        return {
            "actors": {
                name: {
                    "inbox-depth": len(self._inboxes.get(name, ())),
                    "messages-delivered": self._delivered.get(name, 0),
                    "crashed": name in self._crashed,
                    # Mail refused at held_mail_limit while the actor
                    # was down — the operator's lost-messages signal
                    # during a long restart backoff.
                    "held-mail-dropped": self._held_dropped.get(name, 0),
                }
                for name in self.actors
            },
            "timers-armed": armed,
            "next-timer-in-ms": (
                round(max(nd - now, 0.0) * 1e3, 1) if nd is not None else None
            ),
        }

    # -- scheduling

    def _deliver_one(self) -> bool:
        while self._ready:
            name = self._ready.popleft()
            if name in self._crashed:
                # Crash containment covers the whole backlog: messages
                # queued BEFORE the crash stay in the inbox (their ready
                # tokens are consumed here; restart_actor re-readies the
                # full inbox), a crashed handler must not keep running.
                continue
            inbox = self._inboxes.get(name)
            if not inbox:
                continue
            msg = inbox.popleft()
            actor = self.actors.get(name)
            if actor is None:
                continue
            self._delivered[name] = self._delivered.get(name, 0) + 1
            try:
                if isinstance(msg, PoisonPill):
                    raise InjectedCrash(msg.reason)
                hook = _DELIVERY_CONTEXT
                ctx = hook(msg) if hook is not None else None
                if ctx is None:
                    actor.handle(msg)
                else:
                    with ctx:
                        actor.handle(msg)
            except Exception as exc:  # crash containment
                log.exception("actor %s crashed", name)
                self._crashed[name] = exc
                if self._supervisor:
                    self._supervisor(ActorCrashed(name, exc))
            return True
        return False

    def _fire_due_timers(self) -> bool:
        fired = False
        now = self.clock.now()
        while self._timers:
            e = self._timers[0]
            if e.timer._armed_seq != e.seq:
                heapq.heappop(self._timers)
                continue
            if e.deadline > now:
                break
            heapq.heappop(self._timers)
            e.timer._fire(e.seq)
            fired = True
        return fired

    def run_until_idle(self) -> int:
        """Deliver messages + due timers until quiescent.  Returns count."""
        n = 0
        progress = True
        while progress:
            progress = False
            if self._fire_due_timers():
                progress = True
            while self._deliver_one():
                n += 1
                progress = True
        return n

    def advance(self, dt: float) -> int:
        """(Virtual clock) move time forward, firing timers in deadline
        order and draining all resulting messages at each firing instant."""
        if not isinstance(self.clock, VirtualClock):
            raise RuntimeError("advance() requires VirtualClock")
        target = self.clock.now() + dt
        n = self.run_until_idle()
        while True:
            nd = self.next_deadline()
            if nd is None or nd > target:
                break
            self.clock._now = max(self.clock._now, nd)
            n += self.run_until_idle()
        self.clock._now = target
        return n
