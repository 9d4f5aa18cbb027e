"""Actor supervision: restart policy + crash-loop detection.

The reference contains a protocol crash to its own instance task
(holo-protocol/src/lib.rs:344-360) but leaves restart to the operator;
here the daemon installs a real policy: a crashed protocol actor is
restarted after an exponential backoff with *deterministic* jitter
(reproducible under the virtual clock and in event-recorder replays),
and a crash loop — too many crashes inside a sliding window — parks the
actor in a permanent degraded state instead of flapping forever.

The :class:`Supervisor` is itself an actor on the daemon's primary
loop: crash notices and restart-due ticks arrive as ordinary messages,
so when the ``[event_recorder]`` journal is enabled every supervision
decision is journaled and replayable for free.  Mail sent to a crashed
actor is held (bounded) and redelivered on restart — the timer re-arm
chains protocol actors depend on (hello fires -> handler re-arms)
survive the restart.
"""

from __future__ import annotations

import hashlib
import logging
import weakref
from dataclasses import dataclass

from holo_tpu_torch import telemetry
from holo_tpu_torch.telemetry import flight
from holo_tpu_torch.utils.runtime import Actor, EventLoop

log = logging.getLogger("holo_tpu_torch.resilience.supervisor")

_CRASHES = telemetry.counter(
    "holo_resilience_actor_crashes_total",
    "Actor crashes seen by a supervisor",
    ("actor",),
)
_RESTARTS = telemetry.counter(
    "holo_resilience_actor_restarts_total",
    "Supervised actor restarts",
    ("actor",),
)
_DEGRADED = telemetry.gauge(
    "holo_resilience_actor_degraded",
    "1 while the actor is parked in the permanent-degraded state",
    ("actor",),
)

# Live supervisors for the health leaf (weak: test daemons come and go).
_SUPERVISORS: "weakref.WeakSet[Supervisor]" = weakref.WeakSet()


def supervisors() -> list["Supervisor"]:
    return list(_SUPERVISORS)


@dataclass
class RestartPolicy:
    """Backoff + crash-loop policy.  All delays in loop-clock seconds.

    Jitter is deterministic — a hash of (actor, attempt) — so two runs
    of the same scenario restart at identical virtual times (the chaos
    determinism contract), while distinct actors still de-synchronize
    their restarts after a correlated crash."""

    base_delay: float = 0.5
    max_delay: float = 30.0
    multiplier: float = 2.0
    jitter: float = 0.1  # +/- fraction of the backoff delay
    crash_loop_window: float = 60.0
    crash_loop_threshold: int = 5

    def delay(self, actor: str, attempt: int) -> float:
        """Backoff before restart ``attempt`` (0-based) of ``actor``."""
        d = min(self.base_delay * self.multiplier ** attempt, self.max_delay)
        if not self.jitter:
            return d
        h = int.from_bytes(
            hashlib.sha256(f"{actor}:{attempt}".encode()).digest()[:4], "big"
        )
        return d * (1.0 + self.jitter * (2.0 * h / 0xFFFFFFFF - 1.0))


@dataclass
class CrashNotice:
    """Supervision input, journaled like any actor message."""

    actor: str
    error: str


@dataclass
class RestartDue:
    """Backoff expiry tick, journaled like any actor message."""

    actor: str


@dataclass
class RestartDone:
    """Completion notice from an adopted loop's restart runner."""

    actor: str
    ok: bool


class _RestartRunner(Actor):
    """Per-adopted-loop actor: executes restarts on that loop's OWN
    pump thread — ``on_restart`` and held-mail re-readying must run
    under the loop's single-writer discipline, not the supervisor's
    thread.  Reports completion back to the supervisor's home loop."""

    def __init__(self, loop: EventLoop, report) -> None:
        self._loop = loop
        self._report = report  # callable(RestartDone)

    def handle(self, msg) -> None:
        if isinstance(msg, RestartDue):
            self._report(RestartDone(msg.actor, self._loop.restart_actor(msg.actor)))


class Supervisor(Actor):
    """Restart-policy actor; install on the daemon's primary loop, adopt
    any per-instance :class:`ThreadedLoop` loops as they are placed."""

    name = "supervisor"

    RUNNER = "resilience-restart-runner"

    def __init__(self, policy: RestartPolicy | None = None, name: str = "supervisor"):
        self.policy = policy or RestartPolicy()
        self.name = name
        # (loop, sender): sender is the cross-thread post-and-wake
        # callable for adopted ThreadedLoops (None = same-thread loop).
        self._loops: list[tuple[EventLoop, object]] = []
        self.restarts: dict[str, int] = {}
        self.crashes: dict[str, int] = {}
        self.degraded: set[str] = set()
        self._recent: dict[str, list[float]] = {}  # crash times in window
        self._timers: dict[str, object] = {}
        # Watched ThreadedLoop pumps: pseudo-actor name -> ThreadedLoop.
        # A dead pump thread is restarted through the same policy
        # machinery as a crashed actor (backoff, crash-loop degrade).
        self._pumps: dict[str, object] = {}
        _SUPERVISORS.add(self)

    # -- wiring

    def install(self, loop: EventLoop) -> "Supervisor":
        """Register on ``loop`` (the home loop: timers + crash messages
        run here) and adopt it for supervision."""
        loop.register(self, name=self.name)
        self.adopt(loop)
        return self

    def adopt(self, loop: EventLoop, sender=None) -> None:
        """Supervise ``loop``'s actors.  Crash notices marshal to the
        home loop as messages, so a ThreadedLoop's crash (raised on its
        pump thread) is handled under the primary loop's single-writer
        discipline like everything else.

        For a loop pumped by its own thread, pass ``sender`` — the
        owner's post-and-wake callable (``ThreadedLoop.send``): the
        restart itself then executes on THAT thread via a registered
        runner actor (on_restart + held-mail redelivery stay
        single-writer, and the pump wakes immediately instead of on its
        next poll)."""
        home = self._loops[0][0] if self._loops else loop
        self._loops.append((loop, sender))
        if sender is not None:
            loop.register(
                _RestartRunner(
                    loop, lambda done: home.send(self.name, done)
                ),
                name=self.RUNNER,
            )

        def notify(notice) -> None:
            if notice.actor == self.RUNNER:
                # The restart marshal target cannot be restarted through
                # itself (its RestartDue would sit held in its own dead
                # inbox, wedging supervision for this whole loop).  Heal
                # it here, on the loop's own thread — this callback runs
                # synchronously inside the loop's delivery — and the
                # runner is stateless (on_restart is a no-op).
                _CRASHES.labels(actor=self.RUNNER).inc()
                self.crashes[self.RUNNER] = self.crashes.get(self.RUNNER, 0) + 1
                log.error(
                    "restart runner crashed (%s); self-healed",
                    notice.error,
                )
                loop.restart_actor(self.RUNNER)
                return
            if notice.actor == self.name:
                # The supervisor cannot supervise itself through its
                # own (now crashed) inbox — the notice would be held
                # there forever and ALL supervision silently dies.
                # Self-heal on the spot: no backoff, crash cleared,
                # held notices re-readied.  No loop risk: the message
                # that crashed the handler was already consumed.
                _CRASHES.labels(actor=self.name).inc()
                self.crashes[self.name] = self.crashes.get(self.name, 0) + 1
                log.error(
                    "supervisor %s crashed (%s); self-healed",
                    self.name, notice.error,
                )
                home.restart_actor(self.name)
                return
            home.send(
                self.name, CrashNotice(notice.actor, repr(notice.error))
            )

        loop.set_supervisor(notify, hold_crashed=True)

    def watch_pump(self, tl) -> str:
        """Supervise a :class:`~holo_tpu_torch.utils.preempt.ThreadedLoop`'s
        pump THREAD itself (the detected-but-not-respawned gap: a pump
        dying to a loop-machinery exception used to leave the instance
        deaf until unplacement).  The pump is modeled as a pseudo-actor
        ``pump:<loop name>`` under the same :class:`RestartPolicy` —
        exponential backoff with deterministic jitter, crash-loop →
        permanent degraded.  Returns the pseudo-actor name."""
        name = f"pump:{tl.name}"
        self._pumps[name] = tl
        home = self._loops[0][0] if self._loops else self.loop

        def on_crash(exc, n=name) -> None:
            # Runs on the dying pump thread: marshal to the home loop
            # like every other crash notice (journaled + replayable).
            flight.event("pump-crash", loop=n, error=repr(exc))
            home.send(self.name, CrashNotice(n, repr(exc)))

        tl.on_pump_crash = on_crash
        return name

    def watch_worker(self, worker, name: str | None = None) -> str:
        """Supervise a dispatch-plane worker THREAD (``watch_pump``
        parity for non-EventLoop pumps): anything exposing
        ``on_worker_crash`` (crash callback slot) + ``respawn()`` —
        the :class:`~holo_tpu_torch.pipeline.dispatch.DispatchPipeline`
        worker and the hung-dispatch watchdog sentinel both qualify.
        Modeled as pseudo-actor ``worker:<name>`` under the same
        :class:`RestartPolicy` (backoff, crash-loop → degraded).
        Queued tickets survive the respawn: the queue lives on the
        pipeline object, not the thread."""
        pname = f"worker:{name or getattr(worker, 'name', 'anon')}"
        self._pumps[pname] = worker
        home = self._loops[0][0] if self._loops else self.loop

        def on_crash(exc, n=pname) -> None:
            # Runs on the dying worker thread: marshal to the home loop
            # like every other crash notice (journaled + replayable).
            flight.event("worker-crash", worker=n, error=repr(exc))
            home.send(self.name, CrashNotice(n, repr(exc)))

        worker.on_worker_crash = on_crash
        return pname

    def unadopt(self, loop: EventLoop) -> None:
        """Stop supervising ``loop`` (instance unplacement): drop the
        reference (the daemon churns instances over a long lifetime —
        dead loops must not accumulate) and forget per-actor state for
        its actors, so a re-created instance under the same name starts
        with a clean slate instead of inheriting a degraded verdict or
        stale crash history."""
        for name in list(loop.actors):
            self.forget(name)
        for pname, tl in list(self._pumps.items()):
            # Dispatch-plane workers (watch_worker) have no .loop — they
            # belong to no EventLoop and are never dropped by unadopt.
            if getattr(tl, "loop", None) is loop:
                tl.on_pump_crash = None
                del self._pumps[pname]
                self.forget(pname)
        self._loops = [(lp, s) for lp, s in self._loops if lp is not loop]

    def forget(self, actor: str) -> None:
        """Clear ``actor``'s supervision state (it was torn down on
        purpose; a future same-named actor is a different incarnation).
        Historical crash/restart tallies are kept — they are counters,
        not verdicts."""
        if actor in self.degraded:
            self.degraded.discard(actor)
            _DEGRADED.labels(actor=actor).set(0)
        self._recent.pop(actor, None)
        t = self._timers.pop(actor, None)
        if t is not None:
            t.cancel()

    def _owning(self, actor: str) -> tuple[EventLoop, object] | None:
        for lp, sender in self._loops:
            if actor in lp.actors:
                return lp, sender
        return None

    # -- policy

    def handle(self, msg) -> None:
        if isinstance(msg, CrashNotice):
            self._on_crash(msg)
        elif isinstance(msg, RestartDue):
            self._restart(msg.actor)
        elif isinstance(msg, RestartDone):
            self._restarted(msg.actor, msg.ok)

    def _on_crash(self, msg: CrashNotice) -> None:
        actor = msg.actor
        _CRASHES.labels(actor=actor).inc()
        flight.event("actor-crash", actor=actor, error=msg.error)
        self.crashes[actor] = self.crashes.get(actor, 0) + 1
        if actor in self.degraded:
            return
        now = self.loop.clock.now()
        recent = self._recent.setdefault(actor, [])
        recent.append(now)
        recent[:] = [t for t in recent if now - t <= self.policy.crash_loop_window]
        if len(recent) >= self.policy.crash_loop_threshold:
            self._degrade(actor, msg.error)
            return
        attempt = len(recent) - 1
        delay = self.policy.delay(actor, attempt)
        t = self.loop.timer(self.name, lambda a=actor: RestartDue(a))
        t.start(delay)
        self._timers[actor] = t
        log.warning(
            "actor %s crashed (%s); restart %d in %.2fs",
            actor, msg.error, attempt + 1, delay,
        )

    def _degrade(self, actor: str, error: str) -> None:
        self.degraded.add(actor)
        # Crash-loop → permanent degraded is a postmortem trigger: the
        # crash cadence and the mail that provoked it are still in the
        # flight ring right now (no-op while the recorder is disarmed).
        flight.trigger(f"crash-loop:{actor}", extra={"error": error})
        owning = self._owning(actor)
        if owning is not None:
            # abandon_actor only marks a set + clears a deque (both
            # GIL-atomic, no handler interaction) — safe cross-thread.
            owning[0].abandon_actor(actor)
        _DEGRADED.labels(actor=actor).set(1)
        log.error(
            "actor %s crash-looped (%d crashes within %.0fs; last: %s) — "
            "parked in permanent-degraded state, mail refused",
            actor, self.policy.crash_loop_threshold,
            self.policy.crash_loop_window, error,
        )

    def _restart(self, actor: str) -> None:
        self._timers.pop(actor, None)
        if actor in self.degraded:
            return
        tl = self._pumps.get(actor)
        if tl is not None:
            # Pump respawn: a fresh thread over the same EventLoop —
            # actors/inboxes/timers survive, pending mail drains as
            # soon as the new pump runs.
            self._restarted(actor, tl.respawn())
            return
        owning = self._owning(actor)
        if owning is None:
            return
        loop, sender = owning
        if sender is not None:
            # Marshal onto the owning loop's pump thread (and wake it);
            # the runner reports back with RestartDone.
            sender(self.RUNNER, RestartDue(actor))
            return
        self._restarted(actor, loop.restart_actor(actor))

    def _restarted(self, actor: str, ok: bool) -> None:
        if not ok:
            return  # e.g. on_restart re-crashed: a fresh CrashNotice follows
        self.restarts[actor] = self.restarts.get(actor, 0) + 1
        _RESTARTS.labels(actor=actor).inc()
        flight.event("actor-restart", actor=actor, n=self.restarts[actor])
        log.info(
            "actor %s restarted (restart %d); held mail redelivered",
            actor, self.restarts[actor],
        )

    def snapshot(self) -> dict:
        """Health-leaf view (served under holo-telemetry/health)."""
        return {
            "degraded-actors": sorted(self.degraded),
            "restarts": dict(self.restarts),
            "crashes": dict(self.crashes),
        }
