"""Double-buffered async dispatch pipeline (the port's copy of
``holo_tpu.pipeline.dispatch``).

A bounded dispatch queue and one worker thread sit between the callers (the
protocol actors) and the device:

- callers **submit** work (:meth:`DispatchPipeline.submit`) and get a ticket
  back at once; :class:`LazySpfResult` and :class:`LazyBackupTable` defer the
  wait to the first use of the result;
- the worker runs the split-phase backend API (``TorchSpfBackend.launch_one``
  / ``finish_one``, ``FrrEngine._launch_device`` / ``_finish_device``): while
  one dispatch's device-to-host copies are in flight, the next one launches.
  ``depth`` bounds the launched-but-unfinished entries (2: double
  buffering);
- **ordering** is strict per key: results complete in submission order for
  a key, and at most one entry per key is ever in flight.  This is the
  DeltaPath ownership handoff: a delta launch takes its chain's previous run
  out of the backend and updates the resident graph in place, so the next
  delta of the chain launches only after the previous one's finish has put
  its run back.  ``AsyncSpfBackend._key`` makes the key the delta chain and
  the root;
- superseded **what-if batches coalesce**: a queued advisory batch of a key
  is dropped when a batch of a newer generation arrives, and a resubmission
  of the same generation shares the queued ticket;
- **breaker awareness**: while a breaker is open, advisory batches are
  skipped at submit, and ``compute`` runs on the caller's thread (where the
  breaker refuses it on the card, or the oracle serves it on the CPU);
- **priority classes** (:data:`holo_tpu_torch.resilience.overload.CLASSES`):
  the dequeue serves ``correctness`` first, FIFO within a class; a full queue
  sheds the worst class first, never ``correctness``, which blocks instead;
  advisory tickets may carry a deadline and are shed at dequeue once
  expired;
- the **watchdog hooks** (:meth:`arm_watchdog`, :meth:`abandon_active`,
  :meth:`respawn`) let :class:`~holo_tpu_torch.resilience.watchdog.DispatchWatchdog`
  abandon a wedged phase and revive the worker;
- ``_guarded_launch`` grants a transient device error
  (:func:`~holo_tpu_torch.resilience.overload.is_transient`) the retry
  policy's backoff retries before the breaker counts it.

Chaos seams: ``faults.crashpoint("pipeline.dispatch")`` inside the breaker
guard, ``faults.killpoint("pipeline.worker")`` at the top of the worker loop
and ``faults.hangpoint("pipeline.launch" / "pipeline.finish")`` inside the
phases.

Differences from ``holo_tpu``:

- the wraps accept the port's classes (``TorchSpfBackend``, whose ``name``
  is ``"torch"``, and ``FrrEngine("torch")``);
- fallbacks follow the port's card rule: a submit passes the oracle as its
  fallback only where it computes the same bits (the CPU, no
  ``max_iters``).  Without one, a failure in either phase is counted by the
  breaker and re-raised at ``result()`` or attribute access, an open circuit
  raises ``CircuitOpen``, and a hang fails the ticket with
  ``WatchdogTimeout``: no dispatch on the card is served by the host oracle;
- the pipeline's analytics (``convergence``, ``critpath``, ``flight``,
  ``slo``) come with ROADMAP A13b; the ten ``holo_pipeline_*`` families this
  module declares in ``holo_tpu`` (queue depth, in flight, dispatches,
  coalesced, breaker skips, caller wait, overlap ratio, sheds, shed margin,
  worker respawns) are exported here, beside :meth:`DispatchPipeline.stats`,
  and a finish runs in the donation guard's ``pipeline.key.handoff``
  window.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import Counter, deque
from contextlib import nullcontext

from holo_tpu_torch import telemetry
from holo_tpu_torch.analysis.runtime import consumes_donated
from holo_tpu_torch.ops.graph import topology_namespace
from holo_tpu_torch.resilience import faults, overload
from holo_tpu_torch.resilience.breaker import _PASSTHROUGH
from holo_tpu_torch.resilience.overload import CLASS_RANK, CLASSES

log = logging.getLogger("holo_tpu_torch.pipeline")

_QUEUE_DEPTH = telemetry.gauge(
    "holo_pipeline_queue_depth", "Entries waiting in the dispatch pipeline queue")
_INFLIGHT = telemetry.gauge(
    "holo_pipeline_inflight", "Launched-but-unfinished pipeline entries (device in flight)")
_DISPATCHES = telemetry.counter(
    "holo_pipeline_dispatch_total", "Pipeline entries completed, by dispatch kind", ("kind",))
_COALESCED = telemetry.counter(
    "holo_pipeline_coalesced_total", "Queued what-if batches coalesced (shared or superseded)",
    ("reason",))
_BREAKER_SKIPS = telemetry.counter(
    "holo_pipeline_breaker_skip_total",
    "Advisory batches skipped at submit because the circuit was open")
_WAIT_SECONDS = telemetry.histogram(
    "holo_pipeline_wait_seconds", "Caller-side wait from result force to completion", ("kind",))
_OVERLAP_RATIO = telemetry.gauge(
    "holo_pipeline_overlap_ratio",
    "Fraction of device-in-flight time overlapped with other host work")
_SHED = telemetry.counter(
    "holo_pipeline_shed_total", "Tickets shed by the overload plane, by ticket class and reason",
    ("class", "reason"))
_SHED_MARGIN = telemetry.histogram(
    "holo_pipeline_shed_margin_seconds",
    "How far past its deadline an expired ticket already was at "
    "dequeue (near-miss sheds vs hopeless ones)", ("class",))
_WORKER_RESPAWNS = telemetry.counter(
    "holo_pipeline_worker_respawns_total",
    "Pipeline worker threads respawned after a crash or abandoned hang")


class PipelineClosed(RuntimeError):
    """Submit against a closed pipeline."""


class PipelineTicket:
    """Completion handle for one submitted dispatch."""

    __slots__ = ("key", "kind", "generation", "cls", "_event", "_value", "_exc", "skipped",
                 "superseded", "shed", "_done", "_pipeline", "_cbs", "_cb_lock")

    def __init__(self, pipeline, key, kind: str, generation: int, cls: str = "correctness"):
        self.key = key
        self.kind = kind
        self.generation = generation
        self.cls = cls
        self._pipeline = pipeline
        self._event = threading.Event()
        self._value = None
        self._exc: BaseException | None = None
        self.skipped = False  # breaker-open skip or shed: never executed
        self.superseded = False  # coalesced away by a newer generation
        self.shed = None  # overload shed reason ("capacity" | "expired")
        # First settler wins: the watchdog serving a fallback can race the
        # wedged worker finally returning.
        self._done = False
        self._cbs: list = []
        self._cb_lock = threading.Lock()

    def add_done_callback(self, fn) -> None:
        """Run ``fn(ticket)`` at completion (at once when already done), on
        the completing thread: the pipeline worker for queued work.
        Callback exceptions are logged and swallowed."""
        with self._cb_lock:
            if not self._event.is_set():
                self._cbs.append(fn)
                return
        self._run_cb(fn)

    def _run_cb(self, fn) -> None:
        try:
            fn(self)
        except Exception:  # noqa: BLE001 -- see add_done_callback
            log.exception("pipeline ticket done-callback failed")

    def _fire_cbs(self) -> None:
        with self._cb_lock:
            cbs, self._cbs = self._cbs, []
        for fn in cbs:
            self._run_cb(fn)

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: float | None = None):
        """Block until completion; re-raise the dispatch's exception on the
        caller's thread.  Skipped and superseded tickets return None."""
        if not self._event.is_set():
            t0 = time.perf_counter()
            if not self._event.wait(timeout):
                raise TimeoutError(f"pipeline result for {self.key}/{self.kind} not ready")
            if self._pipeline is not None:
                self._pipeline._note_wait(self.kind, time.perf_counter() - t0)
        if self._exc is not None:
            raise self._exc
        return self._value

    def _claim(self) -> bool:
        with self._cb_lock:
            if self._done:
                return False
            self._done = True
            return True

    def _complete(self, value) -> None:
        if not self._claim():
            return
        self._value = value
        self._event.set()
        self._fire_cbs()

    def _fail(self, exc: BaseException) -> None:
        if not self._claim():
            return
        self._exc = exc
        self._event.set()
        self._fire_cbs()

    def _skip(self, superseded: bool = False) -> None:
        if not self._claim():
            return
        if superseded:
            self.superseded = True
        else:
            self.skipped = True
        self._event.set()
        self._fire_cbs()

    def _shed(self, reason: str) -> None:
        """Overload shed: settled without running, like a breaker skip."""
        if not self._claim():
            return
        self.shed = reason
        self.skipped = True
        self._event.set()
        self._fire_cbs()


class _Item:
    """One queued dispatch."""

    __slots__ = ("key", "kind", "generation", "ticket", "run", "launch", "finish", "coalesce",
                 "handle", "t_launch_end", "cls", "rank", "deadline", "site", "fallback",
                 "breaker", "abandoned")

    def __init__(self, ticket, run=None, launch=None, finish=None, coalesce=False, site=None,
                 fallback=None, breaker=None):
        self.ticket = ticket
        self.key = ticket.key
        self.kind = ticket.kind
        self.generation = ticket.generation
        self.cls = ticket.cls
        self.rank = CLASS_RANK[ticket.cls]
        self.run = run
        self.launch = launch
        self.finish = finish
        self.coalesce = coalesce
        self.handle = None
        self.t_launch_end = 0.0
        # Absolute expiry on the pipeline's clock (None: none); the site
        # the watchdog budgets; what the watchdog serves and strikes on a
        # hang; the abandoned latch abandon_active sets.
        self.deadline = None
        self.site = site
        self.fallback = fallback
        self.breaker = breaker
        self.abandoned = False


class DispatchPipeline:
    """Bounded dispatch queue and one worker thread.

    ``depth`` bounds the launched-but-unfinished entries (2: double
    buffering); ``capacity`` bounds the queue.  ``guard`` is an optional
    zero-argument callable returning a context manager entered around every
    worker-side phase.  ``clock`` is read only for tickets with a deadline;
    ``advisory_deadline`` is the relative deadline stamped on advisory
    tickets that pass none (None: they never expire).
    """

    def __init__(self, depth: int = 2, capacity: int = 32, name: str = "pipeline", guard=None,
                 clock=time.monotonic, advisory_deadline: float | None = None):
        self.depth = max(int(depth), 1)
        self.capacity = max(int(capacity), 1)
        self.name = name
        self.guard = guard
        self._clock = clock
        self.advisory_deadline = advisory_deadline
        self._cv = threading.Condition()
        self._queue: deque[_Item] = deque()
        self._inflight: list[_Item] = []
        self._inflight_keys: set = set()
        # Items the worker popped and has not yet parked in _inflight or
        # finalized: drain() must not report empty while one runs.
        self._working = 0
        self._closed = False
        self._thread: threading.Thread | None = None
        self._worker_spawned = False
        # Watchdog plane: the (item, phase, since) stamp of the running
        # phase, stored only while armed (_watch_clock not None).
        self._watch_clock = None
        self._active = None
        # A worker death marshals through this callback when set, else the
        # pipeline respawns its worker itself.
        self.on_worker_crash = None
        self._submitted = 0
        self._completed = 0
        self._coalesced: Counter = Counter()  # reason -> tickets
        self._skipped = 0
        self._sheds: Counter = Counter()  # (class, reason) -> tickets
        self._hangs = 0
        self._worker_crashes = 0
        self._worker_respawns = 0
        self._dispatches: Counter = Counter()  # kind -> completed entries
        self._wait_seconds: Counter = Counter()  # kind -> caller wait at force
        self._launch_seconds = 0.0
        self._finish_seconds = 0.0
        self._overlap_seconds = 0.0
        self._max_inflight_per_key = 0  # the ownership invariant: <= 1
        _QUEUE_DEPTH.set_fn(lambda: float(len(self._queue)))
        _INFLIGHT.set_fn(lambda: float(len(self._inflight)))

    # -- submit side

    def submit(self, key, kind: str, run=None, launch=None, finish=None, generation: int = 0,
               coalesce: bool = False, skip_when_open=None, cls: str = "correctness",
               deadline: float | None = None, site: str | None = None, fallback=None,
               breaker=None) -> PipelineTicket:
        """Enqueue one dispatch and return its ticket.

        Exactly one of ``run`` (single phase: the worker runs it whole) or
        the ``launch`` / ``finish`` pair (split phase) must be given.
        ``coalesce=True`` marks an advisory what-if batch: same (key,
        generation) resubmissions share the queued ticket, a newer
        generation supersedes a queued older one, and ``skip_when_open`` (a
        breaker) skips the submit while its circuit is open.  ``cls`` is the
        priority class; ``deadline`` (relative seconds, not for
        ``correctness``) expires the ticket at dequeue.  ``site``,
        ``fallback`` and ``breaker`` are what the watchdog budgets, serves
        and strikes when it abandons a hung phase."""
        if cls not in CLASS_RANK:
            raise ValueError(f"unknown ticket class {cls!r} (one of {CLASSES})")
        if (run is None) == (launch is None or finish is None):
            raise ValueError("pass run=... OR launch=.../finish=...")
        if deadline is not None and cls == "correctness":
            raise ValueError("correctness tickets cannot carry a deadline")
        if deadline is None and cls == "advisory":
            deadline = self.advisory_deadline
        ticket = PipelineTicket(self, key, kind, int(generation), cls=cls)
        if skip_when_open is not None and skip_when_open.state == "open":
            ticket._skip()
            with self._cv:
                self._skipped += 1
            _BREAKER_SKIPS.inc()
            return ticket
        item = _Item(ticket, run=run, launch=launch, finish=finish, coalesce=coalesce, site=site,
                     fallback=fallback, breaker=breaker)
        if deadline is not None:
            # The only clock read on the submit path.
            item.deadline = self._clock() + float(deadline)
        shed_self = False
        victims: list = []
        try:
            with self._cv:
                if self._closed:
                    raise PipelineClosed(self.name)
                if coalesce:
                    for old in list(self._queue):
                        if not (old.coalesce and old.key == key and old.kind == kind):
                            continue
                        if old.generation == item.generation:
                            self._coalesced["shared"] += 1
                            _COALESCED.labels(reason="shared").inc()
                            return old.ticket
                        if old.generation < item.generation:
                            self._queue.remove(old)
                            old.ticket._skip(superseded=True)
                            self._coalesced["superseded"] += 1
                            _COALESCED.labels(reason="superseded").inc()
                while len(self._queue) >= self.capacity and not self._closed:
                    victim = self._capacity_victim_locked(item.rank)
                    if victim is not None:
                        self._queue.remove(victim)
                        self._note_shed(victim.cls, "capacity")
                        victims.append(victim)
                        continue
                    if item.rank > 0:
                        # Full of equal-or-better work: shed the incoming
                        # sheddable ticket rather than block the caller.
                        self._note_shed(item.cls, "capacity")
                        shed_self = True
                        break
                    # Correctness blocks until space frees or close().
                    self._cv.wait(0.5)
                if self._closed:
                    raise PipelineClosed(self.name)
                if not shed_self:
                    self._queue.append(item)
                    self._submitted += 1
                    self._ensure_worker_locked()
                    self._cv.notify_all()
        finally:
            # Settle outside the lock: done-callbacks never run under _cv.
            for v in victims:
                v.ticket._shed("capacity")
        if shed_self:
            ticket._shed("capacity")
        return ticket

    def _capacity_victim_locked(self, incoming_rank: int):
        """The worst-class queued ticket (oldest within its class) a full
        queue gives up for an incoming ticket of ``incoming_rank``, ranked
        at least as low; never ``correctness``.  None: nothing sheddable."""
        victim = None
        for item in self._queue:
            if item.rank == 0 or item.rank < incoming_rank:
                continue
            if victim is None or item.rank > victim.rank:
                victim = item
        return victim

    def _note_shed(self, cls: str, reason: str, margin: float | None = None) -> None:
        """Count a shed ticket (under ``_cv``); ``margin``, seconds past its
        deadline at dequeue, exists for expiry sheds only."""
        self._sheds[(cls, reason)] += 1
        _SHED.labels(**{"class": cls, "reason": reason}).inc()
        if margin is not None:
            _SHED_MARGIN.labels(**{"class": cls}).observe(margin)

    def _note_wait(self, kind: str, seconds: float) -> None:
        with self._cv:
            self._wait_seconds[kind] += seconds
        sid = telemetry.current_span_id()
        _WAIT_SECONDS.labels(kind=kind).observe(
            seconds, exemplar=None if sid is None else {"span_id": sid})

    def on_worker(self) -> bool:
        """Is the calling thread this pipeline's worker?"""
        return self._thread is threading.current_thread()

    def _ensure_worker_locked(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._spawn_worker_locked()

    def _spawn_worker_locked(self) -> None:
        with self._cv:  # reentrant: the Condition's lock is an RLock
            if self._worker_spawned:
                self._worker_respawns += 1
                _WORKER_RESPAWNS.inc()
            self._worker_spawned = True
            self._thread = threading.Thread(target=self._worker_main,
                                            name=f"holo-pipeline-{self.name}", daemon=True)
            self._thread.start()

    def respawn(self) -> bool:
        """Start a fresh worker over the surviving queue (the watchdog's
        revival, a supervisor's restart).  A no-op while a healthy worker
        runs; False once closed."""
        with self._cv:
            if self._closed:
                return False
            t = self._thread
            if t is not None and t.is_alive() and t is not threading.current_thread():
                return True
            self._spawn_worker_locked()
            self._cv.notify_all()
            return True

    # -- worker side

    def _worker_main(self) -> None:
        """The worker loop and its crash seam: a worker death never strands
        the queued tickets."""
        try:
            self._worker()
        except BaseException as exc:  # noqa: BLE001 -- last-resort seam
            with self._cv:
                self._worker_crashes += 1
                if self._thread is threading.current_thread():
                    self._thread = None
                self._cv.notify_all()
            log.exception("pipeline %s worker crashed", self.name)
            cb = self.on_worker_crash
            if cb is not None:
                cb(exc)
            elif not self._closed:
                self.respawn()

    def _next_launchable_locked(self, expired: list) -> _Item | None:
        """The best launchable queued item: lowest class rank first, FIFO
        within a rank, never a key already in flight.  Expired items move to
        ``expired``."""
        with self._cv:
            best = None
            now = None
            for item in list(self._queue):
                if item.deadline is not None:
                    if now is None:
                        now = self._clock()
                    if now >= item.deadline:
                        self._queue.remove(item)
                        self._note_shed(item.cls, "expired", now - item.deadline)
                        expired.append(item)
                        continue
                if item.key in self._inflight_keys:
                    continue
                if best is None or item.rank < best.rank:
                    best = item
                    if best.rank == 0:
                        break
            if best is not None:
                self._queue.remove(best)
            return best

    def _worker(self) -> None:
        while True:
            # Chaos seam: with no item in hand, so queued tickets survive.
            faults.killpoint("pipeline.worker")
            launch_item = finish_item = None
            expired: list = []
            with self._cv:
                if self._thread is not threading.current_thread():
                    return  # disowned: a replacement owns the queue
                if self._closed and not self._queue and not self._inflight:
                    self._cv.notify_all()
                    return
                if len(self._inflight) < self.depth:
                    launch_item = self._next_launchable_locked(expired)
                if launch_item is None:
                    if self._inflight:
                        finish_item = self._inflight.pop(0)
                        self._working += 1
                    elif not expired:
                        self._cv.wait(0.5)
                else:
                    self._working += 1
            for it in expired:
                it.ticket._shed("expired")
            if launch_item is not None:
                self._do_launch(launch_item)
            elif finish_item is not None:
                self._do_finish(finish_item)

    def _ctx(self):
        return self.guard() if self.guard is not None else nullcontext()

    # -- watchdog plane

    def arm_watchdog(self, clock) -> None:
        """Begin stamping in-flight phase walls (DispatchWatchdog)."""
        self._watch_clock = clock

    def disarm_watchdog(self) -> None:
        self._watch_clock = None
        self._active = None

    def _begin_phase(self, item: _Item, phase: str) -> None:
        wc = self._watch_clock
        if wc is None:
            return
        self._active = (item, phase, wc())

    def _end_phase(self, item: _Item) -> bool:
        """True while this thread still owns ``item``; False when the
        watchdog abandoned the phase (the ticket and the bookkeeping are
        settled, and this thread exits at its next ownership check)."""
        if self._watch_clock is None and not item.abandoned:
            return True
        with self._cv:
            act = self._active
            if act is not None and act[0] is item:
                self._active = None
            return not item.abandoned

    def abandon_active(self, item, phase: str) -> bool:
        """The watchdog's verdict: give up on the running ``phase`` of
        ``item``.  False when the phase is no longer running.  Otherwise the
        worker thread is disowned, the item is booked as completed, and for
        a finish the key is released, so a queued dispatch of the same chain
        may launch on the respawned worker."""
        with self._cv:
            act = self._active
            if act is None or act[0] is not item or act[1] != phase:
                return False
            item.abandoned = True
            self._active = None
            self._hangs += 1
            if self._thread is not None and self._thread is not threading.current_thread():
                self._thread = None
            self._working -= 1
            self._completed += 1
            self._dispatches[item.kind] += 1
            self._cv.notify_all()
        if phase == "finish":
            # The wedged finish never put the chain's run back; the key
            # passes on through the same hand-over window as a healthy one.
            with consumes_donated("pipeline.key.handoff"), self._cv:
                self._inflight_keys.discard(item.key)
                self._cv.notify_all()
        _DISPATCHES.labels(kind=item.kind).inc()
        return True

    # -- phases

    def _do_launch(self, item: _Item) -> None:
        t0 = time.perf_counter()
        try:
            with self._ctx():
                self._begin_phase(item, "launch")
                faults.hangpoint("pipeline.launch")
                if item.run is not None:
                    value = item.run()
                    if not self._end_phase(item):
                        return  # abandoned: the watchdog settled everything
                    item.ticket._complete(value)
                    self._finalize(item)
                    return
                item.handle = item.launch()
                if not self._end_phase(item):
                    return
        except BaseException as exc:  # noqa: BLE001 -- to ticket.result()
            if not self._end_phase(item):
                return
            item.ticket._fail(exc)
            self._finalize(item)
            return
        finally:
            self._launch_seconds += time.perf_counter() - t0
        item.t_launch_end = time.perf_counter()
        with self._cv:
            self._inflight.append(item)
            self._inflight_keys.add(item.key)
            self._working -= 1
            per_key = sum(1 for i in self._inflight if i.key == item.key)
            self._max_inflight_per_key = max(self._max_inflight_per_key, per_key)
            self._cv.notify_all()

    def _do_finish(self, item: _Item) -> None:
        t_fs = time.perf_counter()
        # The time the entry sat launched while the worker did other work:
        # the overlap the double buffer exists to create.
        self._overlap_seconds += max(t_fs - item.t_launch_end, 0.0)
        owned = True
        try:
            # The per-key hand-over: the finish puts the chain's new run
            # back, and only then may a queued delta of the chain launch.
            with self._ctx(), consumes_donated("pipeline.key.handoff"):
                self._begin_phase(item, "finish")
                faults.hangpoint("pipeline.finish")
                value = item.finish(item.handle)
                owned = self._end_phase(item)
                if owned:
                    item.ticket._complete(value)
        except BaseException as exc:  # noqa: BLE001 -- see _do_launch
            owned = self._end_phase(item)
            if owned:
                item.ticket._fail(exc)
        finally:
            self._finish_seconds += time.perf_counter() - t_fs
            if owned:
                self._finalize(item)

    def _finalize(self, item: _Item) -> None:
        with self._cv:
            self._inflight_keys.discard(item.key)
            self._working -= 1
            self._completed += 1
            self._dispatches[item.kind] += 1
            denom = self._overlap_seconds + self._finish_seconds
            self._cv.notify_all()
        _DISPATCHES.labels(kind=item.kind).inc()
        if denom > 0:
            _OVERLAP_RATIO.set(self._overlap_seconds / denom)

    # -- lifecycle

    def drain(self, timeout: float | None = None) -> bool:
        """Block until the queue and the in-flight entries are empty (True
        on success)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while self._queue or self._inflight_keys or self._working:
                wait = 0.5
                if deadline is not None:
                    wait = deadline - time.monotonic()
                    if wait <= 0:
                        return False
                self._cv.wait(min(wait, 0.5))
        return True

    def close(self, timeout: float = 10.0) -> None:
        """Refuse new submits, drain, stop the worker."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout)
        # Detach the sampled gauges: a closure over a closed pipeline would
        # pin it and keep sampling its dead queue.
        _QUEUE_DEPTH.set_fn(None)
        _QUEUE_DEPTH.set(0.0)
        _INFLIGHT.set_fn(None)
        _INFLIGHT.set(0.0)

    @property
    def closed(self) -> bool:
        return self._closed

    def stats(self) -> dict:
        with self._cv:
            denom = self._overlap_seconds + self._finish_seconds
            by_class, by_reason = Counter(), Counter()
            for (cls, reason), n in self._sheds.items():
                by_class[cls] += n
                by_reason[reason] += n
            return {
                "depth": self.depth,
                "capacity": self.capacity,
                "queued": len(self._queue),
                "inflight": len(self._inflight),
                "submitted": self._submitted,
                "completed": self._completed,
                "dispatches": dict(self._dispatches),
                "coalesced": sum(self._coalesced.values()),
                "coalesced-by-reason": dict(self._coalesced),
                "breaker-skipped": self._skipped,
                "launch-seconds": round(self._launch_seconds, 6),
                "finish-seconds": round(self._finish_seconds, 6),
                "overlap-seconds": round(self._overlap_seconds, 6),
                "overlap-ratio": round(self._overlap_seconds / denom, 4) if denom > 0 else 0.0,
                "wait-seconds": {k: round(v, 6) for k, v in self._wait_seconds.items()},
                "max-inflight-per-key": self._max_inflight_per_key,
                "sheds": sum(self._sheds.values()),
                "shed-by-class": dict(by_class),
                "shed-by-reason": dict(by_reason),
                "hangs": self._hangs,
                "worker-crashes": self._worker_crashes,
                "worker-respawns": self._worker_respawns,
            }


# -- lazy results


class LazySpfResult:
    """Duck-typed ``SpfResult``: reading a plane forces the ticket."""

    __slots__ = ("_ticket",)

    _FIELDS = ("dist", "parent", "hops", "nexthop_words", "parents", "pdist", "pweight",
               "npaths", "nh_weights")

    def __init__(self, ticket: PipelineTicket):
        self._ticket = ticket

    def _force(self):
        res = self._ticket.result()
        if res is None:
            raise RuntimeError(
                f"pipelined SPF dispatch for {self._ticket.key} was "
                f"{'skipped' if self._ticket.skipped else 'superseded'}")
        return res

    def __getattr__(self, name):
        if name in self._FIELDS:
            return getattr(self._force(), name)
        raise AttributeError(name)

    def wait(self):
        """Explicit force (returns the real SpfResult)."""
        return self._force()


class LazyBackupTable:
    """Duck-typed ``BackupTable``: any attribute access forces the FRR
    ticket."""

    __slots__ = ("_ticket",)

    def __init__(self, ticket: PipelineTicket):
        self._ticket = ticket

    def _force(self):
        res = self._ticket.result()
        if res is None:
            raise RuntimeError(f"pipelined FRR dispatch for {self._ticket.key} skipped")
        return res

    def pending(self) -> bool:
        """True while the dispatch is still in flight."""
        return not self._ticket.done()

    def on_done(self, fn) -> None:
        """Completion hook (fires on the pipeline worker thread)."""
        self._ticket.add_done_callback(fn)

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self._force(), name)

    def wait(self):
        return self._force()


# -- the split breaker guard, shared by both facades


def _guarded_launch(breaker, context: str, launch_fn, fallback=None) -> tuple:
    """Phase 1 of a split breaker-guarded dispatch: admit, the chaos seam,
    the transient retries, the launch.  Returns the ``(verdict, guard,
    handle)`` state :func:`_guarded_finish` completes.

    With a ``fallback`` (the CPU, no ``max_iters``), a refused or failed
    launch gives the ``"fallback"`` verdict; without one, a refusal raises
    ``CircuitOpen`` and a failure re-raises, both counted.  Passthrough
    exceptions (bugs, a library that does not build) re-raise uncounted."""
    guard = breaker.split(context, fallback is not None)
    if not guard.admitted:
        if fallback is None:
            raise guard.refused()
        return ("fallback", guard, None)
    policy = overload.default_retry_policy()
    attempt = 0
    while True:
        try:
            faults.crashpoint("pipeline.dispatch")
            handle = launch_fn()
        except _PASSTHROUGH:
            guard.abort()
            raise
        except Exception as exc:  # noqa: BLE001 -- the breaker's contract
            if attempt < policy.retries and overload.is_transient(exc):
                attempt += 1
                time.sleep(policy.backoff(context, attempt))
                continue
            if attempt:
                overload.note_retry("exhausted")
            guard.failure(exc)
            if fallback is None:
                raise
            return ("fallback", guard, None)
        except BaseException:
            guard.abort()
            raise
        if attempt:
            overload.note_retry("recovered")
        return ("ok", guard, handle)


def _guarded_finish(state: tuple, finish_fn, fallback=None):
    """Phase 2: complete the device dispatch, or serve the fallback; with
    none, a failure re-raises once counted."""
    verdict, guard, handle = state
    if verdict == "fallback":
        return fallback()
    try:
        res = finish_fn(handle)
    except _PASSTHROUGH:
        guard.abort()
        raise
    except Exception as exc:  # noqa: BLE001 -- the breaker's contract
        guard.failure(exc)
        if fallback is None:
            raise
        return fallback()
    except BaseException:
        guard.abort()
        raise
    guard.success()
    return res


# -- async facades


class AsyncSpfBackend:
    """``SpfBackend`` facade routing ``compute`` through a pipeline.

    ``compute`` submits a split-phase dispatch (``launch_one`` /
    ``finish_one``) and returns a :class:`LazySpfResult`; the breaker guards
    it phase by phase.  The blocked engine at ``multipath_k`` 1 and the
    partitioned path have no split and run whole on the worker.
    ``compute_whatif_async`` adds the advisory-batch semantics (coalescing,
    the breaker-open skip).  ``compute_whatif``, ``compute_multiroot`` and
    ``compute_partitioned`` stay synchronous, but run on the worker in their
    chain's order (see :meth:`_in_chain`), where ``holo_tpu``'s run on the
    caller's thread.  The split-phase seam and the graph lookup
    (:attr:`WORKER_ONLY`) are refused on the facade: they read, and may
    update in place, the resident graph that the chain's deltas rewrite.
    """

    #: the inner backend's methods that read or update a chain's resident
    #: graph and return device state: only the worker calls them
    WORKER_ONLY = frozenset({"launch_one", "finish_one", "prepare"})

    #: retained chain-root entries (one live dispatch chain per entry)
    CHAIN_CAPACITY = 512

    def __init__(self, inner, pipeline: DispatchPipeline):
        self.inner = inner
        self.pipeline = pipeline
        # Topology uid -> chain-root uid: a topology carrying delta lineage
        # joins its base's chain, any other roots a new one.
        self._chains: dict = {}
        self._chains_lock = threading.Lock()

    @property
    def name(self) -> str:
        return f"{self.inner.name}-async"

    def __getattr__(self, attr):
        # breaker, engine, delta_paths ...: the facade adds scheduling, not
        # behaviour.
        if attr in AsyncSpfBackend.WORKER_ONLY:
            raise AttributeError(
                f"{attr} is not served through {type(self).__name__}: it reads the chain's "
                "resident graph off the pipeline's worker; use compute(), or call it on the "
                "inner backend where no pipeline runs its chain")
        return getattr(self.inner, attr)

    def _key(self, topo) -> tuple:
        """The ordering and ownership unit: (delta-chain root uid, root
        vertex).  Generations of one chain serialize; unrelated chains
        overlap.  The topology's class is part of the uid, as the port's
        caches key it."""
        ns = topology_namespace(topo)
        uid = (ns, topo.cache_key[0])
        delta = getattr(topo, "delta_base", None)
        with self._chains_lock:
            if delta is not None:
                base_uid = (ns, delta.base_key[0])
                chain = self._chains.get(base_uid, base_uid)
            else:
                chain = self._chains.get(uid, uid)
            self._chains[uid] = chain
            while len(self._chains) > self.CHAIN_CAPACITY:
                self._chains.pop(next(iter(self._chains)))
        return (chain, int(topo.root))

    def _fallback(self, topo, edge_mask, multipath_k: int):
        """The oracle where it serves (the CPU, no ``max_iters``), else
        None."""
        inner = self.inner
        if not inner.fallback_serves():
            return None
        return lambda: inner._oracle.compute(topo, edge_mask, multipath_k=multipath_k)

    def compute(self, topo, edge_mask=None, multipath_k: int = 1):
        inner = self.inner
        pipe = self.pipeline
        if pipe is None or pipe.closed or inner.breaker.state == "open":
            # Degraded mode runs on the caller's thread, as the unpipelined
            # breaker: the oracle serves on the CPU, the card refuses.
            return inner.compute(topo, edge_mask, multipath_k=multipath_k)
        fallback = self._fallback(topo, edge_mask, multipath_k)
        if (inner.engine == "blocked" and multipath_k <= 1) or inner._use_partitioned(topo):
            # No split-phase path: run whole on the worker, still ordered
            # by the key (the partitioned resident's in-place updates).
            site = "spf.blocked" if inner.engine == "blocked" else "spf.partitioned"
            ticket = pipe.submit(
                self._key(topo), "one",
                run=lambda: inner.compute(topo, edge_mask, multipath_k=multipath_k),
                cls="correctness", site=site, fallback=fallback, breaker=inner.breaker)
            return LazySpfResult(ticket)
        ticket = pipe.submit(
            self._key(topo), "one",
            launch=lambda: _guarded_launch(
                inner.breaker, "spf.one",
                lambda: inner.launch_one(topo, edge_mask, multipath_k=multipath_k), fallback),
            finish=lambda st: _guarded_finish(st, inner.finish_one, fallback),
            cls="correctness", site="spf.one", fallback=fallback, breaker=inner.breaker)
        return LazySpfResult(ticket)

    def compute_whatif(self, topo, edge_masks, multipath_k: int = 1):
        inner = self.inner
        return self._in_chain(
            topo, "whatif-sync", "spf.whatif",
            lambda: inner.compute_whatif(topo, edge_masks, multipath_k=multipath_k),
            lambda: inner._oracle.compute_whatif(topo, edge_masks, multipath_k=multipath_k))

    def compute_multiroot(self, topo, roots):
        inner = self.inner
        return self._in_chain(topo, "multiroot", "spf.multiroot",
                              lambda: inner.compute_multiroot(topo, roots),
                              lambda: inner._oracle.compute_multiroot(topo, roots))

    def compute_partitioned(self, topo, edge_mask=None, multipath_k: int = 1):
        inner = self.inner
        return self._in_chain(
            topo, "partitioned", "spf.partitioned",
            lambda: inner.compute_partitioned(topo, edge_mask, multipath_k=multipath_k),
            lambda: inner._oracle.compute(topo, edge_mask, multipath_k=multipath_k))

    def _in_chain(self, topo, kind: str, site: str, fn, oracle):
        """Run a synchronous delegate on the worker, ordered with the
        dispatches of its chain, and wait for it.  A delta of the chain
        rewrites the resident graph's planes in place when it launches, and
        the port's programs read those planes round by round on the host's
        clock: a delegate on the caller's thread could run its last rounds
        on the next generation's costs.  (``holo_tpu``'s one JAX dispatch
        holds its buffers, so it runs these on the caller's thread.)  The
        delegate guards itself with the breaker; ``oracle`` is what the
        watchdog serves for a hang where the oracle serves.  With no open
        pipeline, or on the worker itself (a done-callback), the delegate
        runs where it is called."""
        pipe = self.pipeline
        if pipe is None or pipe.closed or pipe.on_worker():
            return fn()
        inner = self.inner
        ticket = pipe.submit(self._key(topo), kind, run=fn, cls="correctness", site=site,
                             fallback=oracle if inner.fallback_serves() else None,
                             breaker=inner.breaker)
        return ticket.result()

    def compute_whatif_async(self, topo, edge_masks,
                             generation: int | None = None) -> PipelineTicket:
        """Submit an advisory what-if batch.  ``result()`` yields the list of
        SpfResults, or None when the batch was skipped (circuit open), shed
        or superseded by a newer generation's batch of the same key.
        ``generation`` defaults to the topology's own; callers that marshal
        a fresh topology per run pass a monotonic stamp of their own."""
        inner = self.inner
        pipe = self.pipeline
        gen = int(topo.cache_key[1] if generation is None else generation)
        if pipe is None or pipe.closed:
            t = PipelineTicket(None, self._key(topo), "whatif", gen)
            t._complete(inner.compute_whatif(topo, edge_masks))
            return t
        return pipe.submit(
            self._key(topo), "whatif",
            run=lambda: inner.compute_whatif(topo, edge_masks),
            generation=gen, coalesce=True, skip_when_open=inner.breaker,
            # Advisory: shed first, expires at the pipeline's advisory
            # deadline; no fallback (a hung batch fails its ticket).
            cls="advisory", site="spf.whatif")


class AsyncFrrEngine:
    """``FrrEngine`` facade: ``compute`` submits the batched backup-table
    dispatch (split phase on the ``torch`` engine) and returns a
    :class:`LazyBackupTable`, so the SPF and FRR dispatches of one topology
    overlap: the FRR planes derive from the topology, not the SPF result."""

    def __init__(self, inner, pipeline: DispatchPipeline):
        self.inner = inner
        self.pipeline = pipeline

    def __getattr__(self, attr):
        return getattr(self.inner, attr)

    @property
    def name(self) -> str:
        return f"{getattr(self.inner, 'engine', 'frr')}-async"

    def compute(self, topo):
        inner = self.inner
        pipe = self.pipeline
        if (pipe is None or pipe.closed or getattr(inner, "engine", "scalar") != "torch"
                or inner.breaker.state == "open"):
            return inner.compute(topo)
        # A key of its own: FRR reads the resident graph and changes nothing
        # of the SPF chain, and the shared graph cache takes its own lock.
        # The planes are marshaled on the worker; a failure marshals them
        # again for the oracle.
        fallback = None
        if inner.fallback_serves():
            fallback = lambda: inner._scalar_fallback(topo, inner.marshal_inputs(topo))  # noqa: E731
        key = ("frr", topology_namespace(topo), topo.cache_key[0], int(topo.root))
        ticket = pipe.submit(
            key, "frr",
            launch=lambda: _guarded_launch(
                inner.breaker, "frr.batch",
                lambda: inner._launch_device(topo, inner.marshal_inputs(topo)), fallback),
            finish=lambda st: _guarded_finish(st, inner._finish_device, fallback),
            cls="correctness", site="frr.batch", fallback=fallback, breaker=inner.breaker)
        return LazyBackupTable(ticket)


# -- the process-wide pipeline

_PIPELINE: DispatchPipeline | None = None
_PIPELINE_LOCK = threading.Lock()


def configure_process_pipeline(depth: int = 2, capacity: int = 32, guard=None,
                               advisory_deadline: float | None = None) -> DispatchPipeline:
    """Install the process-wide dispatch pipeline, closing any previous one
    first."""
    global _PIPELINE
    with _PIPELINE_LOCK:
        if _PIPELINE is not None:
            _PIPELINE.close()
        _PIPELINE = DispatchPipeline(depth=depth, capacity=capacity, name="process",
                                     guard=guard, advisory_deadline=advisory_deadline)
        return _PIPELINE


def process_pipeline() -> DispatchPipeline | None:
    return _PIPELINE


def reset_process_pipeline() -> None:
    """Close and uninstall the process-wide pipeline."""
    global _PIPELINE
    with _PIPELINE_LOCK:
        if _PIPELINE is not None:
            _PIPELINE.close()
        _PIPELINE = None


def wrap_spf_backend(backend):
    """Route a ``TorchSpfBackend`` through the process pipeline when one is
    armed; other backends and an unarmed process pass through unchanged."""
    pipe = _PIPELINE
    if pipe is None or pipe.closed:
        return backend
    if backend is None or getattr(backend, "name", "") != "torch":
        return backend
    return AsyncSpfBackend(backend, pipe)


def wrap_frr_engine(engine):
    """FRR analog of :func:`wrap_spf_backend` (``FrrEngine("torch")``)."""
    pipe = _PIPELINE
    if pipe is None or pipe.closed:
        return engine
    if engine is None or getattr(engine, "engine", "scalar") != "torch":
        return engine
    return AsyncFrrEngine(engine, pipe)
