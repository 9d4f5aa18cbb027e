"""Daemon assembly: loop + ibus + providers + northbound + gRPC (the
port's copy of ``holo_tpu.daemon.daemon``).

Reference startup order: holo-daemon/src/northbound/core.rs:670-731
(interface → keychain → policy → system → routing), clients after
providers (:734-755).

The daemon runs on one device (``Daemon(device=...)``, resolved by
:func:`~holo_tpu_torch.device.resolve_device`: the card unless the caller
asks for the CPU): ``spf-control/backend tpu`` is a ``TorchSpfBackend`` and
``fast-reroute/engine tpu`` a ``FrrEngine("torch")`` there.  :func:`main`
arms the port's breaker defaults, dispatch mesh, engine tuner, pipeline and
watchdog from the static config.

Not ported (ROADMAP A4b): the gNMI server, the event recorder, the canary
prober and the boot device trace.  Their sections are dropped with a
warning (:func:`_drop_unported`).
"""

from __future__ import annotations

import logging
import os
import time
from pathlib import Path

from holo_tpu_torch import telemetry
from holo_tpu_torch.daemon.config import DaemonConfig
from holo_tpu_torch.daemon.providers import (
    InterfaceProvider,
    KeychainProvider,
    PolicyProvider,
    RoutingProvider,
    SystemProvider,
)
from holo_tpu_torch.northbound.core import Northbound
from holo_tpu_torch.northbound.provider import Provider as NbProvider
from holo_tpu_torch.device import resolve_device
from holo_tpu_torch.routing.rib import Kernel
from holo_tpu_torch.telemetry.provider import TelemetryStateProvider
from holo_tpu_torch.utils.ibus import Ibus
from holo_tpu_torch.utils.netio import MockFabric, NetIo
from holo_tpu_torch.utils.runtime import EventLoop, RealClock
from holo_tpu_torch.yang.modules import full_schema

log = logging.getLogger("holo_tpu_torch.daemon")


def _drop_unported(cfg: DaemonConfig) -> None:
    """Warn of each configured surface that is not ported (ROADMAP A4b); the
    daemon runs without it."""
    tc = cfg.telemetry
    for on, what in ((cfg.gnmi.enabled, "[gnmi]: the gNMI server"),
                     (cfg.event_recorder.enabled, "[event_recorder]: the event recorder"),
                     (tc.canary, "[telemetry] canary: the canary prober"),
                     (tc.device_trace_dir, "[telemetry] device-trace-dir: the boot device trace")):
        if on:
            log.warning("%s is not ported (ROADMAP A4b); not started", what)


class Daemon:
    """One daemon process (testable in-process: pass a virtual clock, a
    MockFabric netio and ``device="cpu"``)."""

    def __init__(
        self,
        config: DaemonConfig | None = None,
        clock=None,
        netio: NetIo | None = None,
        kernel: Kernel | None = None,
        loop: EventLoop | None = None,
        name: str = "",
        device=None,
    ):
        """``loop``/``name`` support multi-daemon simulations: several
        daemons sharing one virtual-clock loop get name-prefixed actors.
        ``device``: where the SPF and FRR engines of ``tpu`` run (None is
        the card, and raises with no card)."""
        import threading

        self.device = resolve_device(device)
        self.config = config or DaemonConfig()
        _drop_unported(self.config)
        self.loop = loop if loop is not None else EventLoop(clock=clock or RealClock())
        # The EventLoop is single-threaded by design; every external entry
        # point (gRPC worker threads, the main timer loop) must hold this
        # lock around loop access.
        self.lock = threading.RLock()
        self.name = name
        self._p = f"{name}." if name else ""

        # Preemptive isolation (reference holo-protocol/src/lib.rs:419-430,
        # [runtime] isolation = "threaded"): protocol instances each get
        # their own OS thread + loop; shared services stay on the primary
        # loop and reach instances through the router.  Requires the real
        # clock — virtual-clock (test) daemons stay cooperative, like the
        # reference's `testing` feature.
        self.instance_loops: dict = {}
        self.loop_router = None
        send_loop = self.loop
        if self.config.runtime.isolation == "threaded":
            if not isinstance(self.loop.clock, RealClock):
                # The reference's `testing` feature makes the same
                # downgrade: deterministic single-loop scheduling under
                # a virtual clock, threaded in production.  An operator
                # who EXPLICITLY asked for threaded deserves the
                # warning; the defaulted case downgrades quietly.
                msg = (
                    "isolation=threaded requires the real clock; "
                    "falling back to cooperative scheduling"
                )
                if self.config.runtime.isolation_explicit:
                    log.warning(msg)
                else:
                    log.debug(msg)
            else:
                from holo_tpu_torch.utils.preempt import CallRunner, LoopRouter

                self.loop_router = LoopRouter(self.loop)
                send_loop = self.loop_router
                self.loop.register(
                    CallRunner(), name=f"{self._p}call-runner"
                )
        self.ibus = Ibus(send_loop)
        self.fabric = None
        if netio is None:
            self.fabric = MockFabric(send_loop)
            netio = self.fabric.sender_for
        elif isinstance(netio, MockFabric):
            self.fabric = netio
            netio = netio.sender_for
        self.netio = netio

        # Providers in reference startup order.
        self.interface = InterfaceProvider(self.ibus)
        self.keychain = KeychainProvider(self.ibus)
        self.policy = PolicyProvider(self.ibus)
        self.system = SystemProvider(self.ibus)
        # Durable state store (boot counters, GR info) next to the txn db
        # (reference: pickledb, holo-daemon/src/main.rs:148-157).
        self.nvstore = None
        if self.config.db_path:
            from holo_tpu_torch.utils.nvstore import NvStore

            nv = Path(self.config.db_path)
            self.nvstore = NvStore(nv.with_name(nv.stem + "_nv.json"))
        self.routing = RoutingProvider(
            send_loop, self.ibus, netio, self.interface, kernel,
            prefix=self._p, policy_engine=self.policy.engine,
            keychains=self.keychain, nvstore=self.nvstore,
            yang_notify=self._dispatch_yang_notification, device=self.device,
        )
        if self.loop_router is not None:
            self.routing.instance_placer = self._place_instance
            self.routing.instance_unplacer = self._unplace_instance
        self.interface.routing_actor = f"{self._p}routing-rib"
        for p in (self.interface, self.keychain, self.policy, self.system, self.routing):
            # Through send_loop: with isolation the router's register()
            # attaches ITSELF as the provider's loop, so provider sends
            # keep reaching instances that live on their own threads.
            send_loop.register(p, name=self._p + p.name)

        db = Path(self.config.db_path) if self.config.db_path else None
        self.northbound = Northbound(
            full_schema(),
            [self.interface, self.keychain, self.policy, self.system,
             self.routing, _RuntimeStateProvider(self),
             TelemetryStateProvider(self.device)],
            db_path=db,
        )
        self._grpc_server = None
        self._telemetry_server = None

        # Flight recorder + deep profiling ([telemetry]): the
        # ring is armed here (process-wide — breaker/supervisor/SIGTERM
        # postmortem triggers all reach the same recorder) with THIS
        # daemon's loop clock, so virtual-clock runs produce
        # deterministic bundles and production stamps real time.
        tcfg = self.config.telemetry
        if tcfg.flight_buffer_entries:
            from holo_tpu_torch.telemetry import flight

            flight.configure(
                entries=tcfg.flight_buffer_entries,
                postmortem_dir=tcfg.postmortem_dir,
                clock=self.loop.clock.now,
            )
        if tcfg.profile_device_time:
            from holo_tpu_torch.telemetry import profiling

            profiling.set_device_profiling(True)
        # Dispatch observatory ([telemetry] observatory):
        # streaming sketches + roofline attribution + the warn-only
        # regression sentinel.  It feeds off the profiling sub-span
        # walls, so arming it arms device profiling too.
        if tcfg.observatory:
            from holo_tpu_torch.telemetry import observatory, profiling

            profiling.set_device_profiling(True)
            observatory.configure(
                ledger_path=tcfg.observatory_ledger,
                peaks=tcfg.roofline_peaks,
            )
        # Convergence observatory ([telemetry] convergence-events):
        # causal event→FIB tracing on this daemon's loop clock;
        # timelines land in the flight ring when it is armed.
        if tcfg.convergence_events:
            from holo_tpu_torch.telemetry import convergence

            convergence.configure(
                tcfg.convergence_events, clock=self.loop.clock.now
            )
        # SLO plane ([telemetry] slo): error budgets +
        # burn-rate sentinels graded from the convergence / shed /
        # relay streams the subsystems above produce.  The engine keeps
        # its default profiling clock (burn windows are REAL-time
        # quantities even when the loop clock is virtual).
        if tcfg.slo:
            from holo_tpu_torch.telemetry import slo

            slo.configure(
                True,
                objectives=tcfg.slo_objectives or None,
                fast_window=tcfg.slo_fast_window,
                slow_window=tcfg.slo_slow_window,
                fast_burn=tcfg.slo_fast_burn,
            )
        # Actor supervision ([resilience], resilience/supervisor.py):
        # crashed protocol actors restart under an exponential-backoff
        # policy with deterministic jitter; crash loops park the actor in
        # a permanent degraded state.  The supervisor is itself an actor
        # on the primary loop.
        self.supervisor = None
        rc = self.config.resilience
        if rc.supervision:
            from holo_tpu_torch.resilience.supervisor import (
                RestartPolicy,
                Supervisor,
            )

            self.supervisor = Supervisor(
                policy=RestartPolicy(
                    base_delay=rc.restart_base_delay,
                    max_delay=rc.restart_max_delay,
                    crash_loop_threshold=rc.crash_loop_threshold,
                    crash_loop_window=rc.crash_loop_window,
                ),
                name=f"{self._p}supervisor",
            ).install(self.loop)
            # Dispatch survivability: the process pipeline's
            # worker thread and the hung-dispatch sentinel ride the
            # same RestartPolicy as the protocol pumps (watch_pump
            # parity) — a worker death from any cause respawns under
            # backoff with the queued tickets intact.
            from holo_tpu_torch.pipeline import process_pipeline
            from holo_tpu_torch.resilience.watchdog import process_watchdog

            pipe = process_pipeline()
            if pipe is not None and not pipe.closed:
                self.supervisor.watch_worker(pipe, "pipeline")
            wd = process_watchdog()
            if wd is not None:
                self.supervisor.watch_worker(wd, wd.name)

    # -- preemptive instance placement ([runtime] isolation = "threaded")

    # Instance-side callbacks the providers install (OspfInstance's): these
    # mutate shared provider/RIB state and must run on the primary loop,
    # not on the instance's thread.
    _MARSHALLED_CALLBACKS = ("route_cb", "notif_cb")

    def _place_instance(self, inst):
        from holo_tpu_torch.utils.preempt import (
            InstanceHandle,
            ThreadedLoop,
            _MarshalCall,
        )

        tl = ThreadedLoop(name=f"{self._p}inst-{inst.name}")
        if self.supervisor is not None:
            # Crashes on the instance's own thread marshal back to the
            # primary-loop supervisor as messages; the restart itself is
            # marshaled the other way (tl.send posts + wakes the pump)
            # so on_restart and held-mail redelivery run single-writer
            # on the instance's thread.
            self.supervisor.adopt(tl.loop, sender=tl.send)
            # The pump THREAD itself is supervised too: a loop-machinery
            # exception killing the pump respawns it under the same
            # restart policy instead of leaving the instance deaf.
            self.supervisor.watch_pump(tl)
        # Route BEFORE the pump starts: a send in the window lands on the
        # (not yet registered) remote loop and is reported undeliverable,
        # never silently swallowed by the primary loop.
        self.loop_router.register_remote(inst.name, tl)
        # Per-interface Tx tasks (reference tasks.rs:288-348): packet
        # production decouples from the wire send; a slow interface
        # backpressures its own producer only.
        if getattr(inst, "netio", None) is not None:
            from holo_tpu_torch.utils.txqueue import TxTaskNetIo

            inst.netio = TxTaskNetIo(inst.netio)
        tl.register(inst)
        # Provider-installed callbacks run as primary-loop messages.
        runner = f"{self._p}call-runner"
        for attr in self._MARSHALLED_CALLBACKS:
            cb = getattr(inst, attr, None)
            if cb is None or not callable(cb):
                continue
            setattr(
                inst,
                attr,
                (lambda cb: lambda *a: self.loop.send(
                    runner, _MarshalCall(cb, a)
                ))(cb),
            )
        tl.start()
        self.instance_loops[inst.name] = tl
        return InstanceHandle(inst, tl)

    def _unplace_instance(self, name: str) -> None:
        # Stop routing first (no new messages), then kill the pump, THEN
        # unregister: pending messages are dropped, matching cooperative
        # unregister semantics — a queued SPF result must not re-install
        # routes after _drop_instance_routes purged them.
        self.loop_router.unregister_remote(name)
        tl = self.instance_loops.pop(name, None)
        if tl is not None:
            if self.supervisor is not None:
                # Deliberate teardown is not a crash: drop the loop and
                # per-actor verdicts so a re-created instance under the
                # same name is supervised afresh.
                self.supervisor.unadopt(tl.loop)
            inst = tl.loop.actors.get(name)
            tl.stop()
            tl.loop.unregister(name)
            netio = getattr(inst, "netio", None)
            if netio is not None and hasattr(netio, "close"):
                netio.close()  # drain + join the per-interface Tx tasks

    # -- config entry points

    def candidate(self):
        with self.lock:
            return self.northbound.running.copy()

    def commit(self, candidate, **kw):
        with self.lock:
            txn = self.northbound.commit(candidate, **kw)
            # Commit atomicity REQUIRES pumping the loop under the lock:
            # a gRPC Get between commit and convergence would render
            # half-applied state.  self.lock is a reentrant RLock and
            # handlers run on THIS thread, so re-acquisition cannot
            # deadlock; the cost is commit-latency for concurrent
            # readers, which is the documented semantics.
            self.loop.run_until_idle()  # holo-lint: disable=HL202
        # Commit notifications fan out to every management surface
        # (gRPC Subscribe), regardless of which one performed the commit.
        for listener in list(getattr(self, "commit_listeners", [])):
            try:
                listener(txn)
            except Exception:
                log.exception("commit listener failed")
        return txn

    def add_commit_listener(self, fn) -> None:
        if not hasattr(self, "commit_listeners"):
            self.commit_listeners = []
        self.commit_listeners.append(fn)

    # -- YANG notifications (reference holo-northbound/src/notification.rs:
    # protocol instances emit, the daemon fans out to every management
    # surface's Subscribe stream)

    def _dispatch_yang_notification(self, payload: dict) -> None:
        for fn in list(getattr(self, "notification_listeners", [])):
            try:
                fn(payload)
            except Exception:
                log.exception("notification listener failed")

    def add_notification_listener(self, fn) -> None:
        if not hasattr(self, "notification_listeners"):
            self.notification_listeners = []
        self.notification_listeners.append(fn)

    # -- gRPC

    def start_grpc(self, address: str | None = None):
        from holo_tpu_torch.daemon.grpc_server import serve

        self._grpc_server = serve(
            self,
            address or self.config.grpc.address,
            tls_cert=self.config.grpc.tls_cert,
            tls_key=self.config.grpc.tls_key,
        )
        return self._grpc_server

    def start_telemetry(self, address: str | None = None):
        """Prometheus text endpoint on a stdlib HTTP thread ([telemetry]
        config section; the gRPC state subtree is always served)."""
        from holo_tpu_torch.telemetry.prometheus import start_http_server

        self._telemetry_server = start_http_server(
            telemetry.registry(),
            address or self.config.telemetry.address,
        )
        return self._telemetry_server

    def stop(self):
        if self._telemetry_server is not None:
            self._telemetry_server.shutdown()
            # shutdown() only exits serve_forever; the listening fd must
            # be closed explicitly or a stop/start cycle races GC for
            # the port (EADDRINUSE).
            self._telemetry_server.server_close()
            self._telemetry_server = None
        if self.config.telemetry.trace_dump:
            try:
                telemetry.tracer().dump(self.config.telemetry.trace_dump)
            except OSError:
                log.exception("trace dump failed")
        if self.config.telemetry.observatory:
            # Close the final sentinel window: checkpoint() seeds and
            # compares every key once more and persists the baseline
            # when anything changed (writes only ever happen at
            # checkpoint boundaries — never on the dispatch thread).
            from holo_tpu_torch.telemetry import observatory

            if observatory.active() is not None:
                observatory.active().checkpoint()
        if self.config.telemetry.slo:
            # Final budget settlement: trim windows, run every sentinel
            # check once more, and feed the latency sketches through the
            # observatory ledger (warn-only) so a short-lived daemon
            # still leaves one baseline row per objective behind.
            from holo_tpu_torch.telemetry import slo

            if slo.active() is not None:
                slo.active().checkpoint()
                slo.configure(False)
        if self._grpc_server is not None:
            self._grpc_server.stop(grace=0.5)
        for name, tl in list(self.instance_loops.items()):
            if self.loop_router is not None:
                self.loop_router.unregister_remote(name)
            if self.supervisor is not None:
                self.supervisor.unadopt(tl.loop)
            inst = tl.loop.actors.get(name)
            tl.stop()
            netio = getattr(inst, "netio", None)
            if netio is not None and hasattr(netio, "close"):
                netio.close()  # drain + join the per-interface Tx tasks
        self.instance_loops.clear()


class _RuntimeStateProvider(NbProvider):
    """Scheduler introspection served as operational state — the
    always-on analog of the reference's optional tokio-console runtime
    instrumentation (holo-daemon/src/main.rs:115-133).  Read-only: it
    owns no config subtree and vetoes nothing (base-class defaults)."""

    name = "runtime"

    def __init__(self, daemon: "Daemon"):
        self._daemon = daemon

    def filter_changes(self, changes):
        return []  # no config subtree: never part of a commit fan-out

    def get_state(self, path: str | None = None) -> dict:
        if path and not "holo-runtime".startswith(path.split("/")[0]):
            return {}
        d = self._daemon
        out = {"main-loop": d.loop.introspect()}
        if d.instance_loops:
            out["instance-loops"] = {
                name: tl.introspect()
                for name, tl in d.instance_loops.items()
            }
        return {"holo-runtime": out}


def _resolve_level(level, fallback: int, what: str) -> int:
    """Level-name → logging constant.  "trace" maps to DEBUG (Python
    logging's most verbose level); an unknown name is a config error
    worth a visible warning, not a silent fallback.  One resolver for
    the root level and the per-subsystem overrides so the two accept
    the same vocabulary."""
    lname = str(level).upper()
    resolved = {"TRACE": logging.DEBUG}.get(lname, getattr(logging, lname, None))
    if not isinstance(resolved, int):
        logging.getLogger(__name__).warning(
            "unknown log level %r for %s; using %s",
            level, what, logging.getLevelName(fallback),
        )
        resolved = fallback
    return resolved


def setup_logging(cfg) -> None:
    """Apply [logging]: root level, output style (compact / full / json),
    optional file sink, and per-subsystem level overrides — the
    reference's tracing-subscriber configuration (main.rs:59-146)."""
    lvl = _resolve_level(cfg.logging.level, logging.INFO, "root logger")
    if cfg.logging.style == "json":
        import json as _json

        class _JsonFormatter(logging.Formatter):
            def format(self, record):
                # Correlation keys: the active telemetry span id (join
                # log lines against Chrome trace dumps) and the protocol
                # instance name (an explicit ``instance`` record attr
                # wins; else the innermost span's instance tag).
                out = {
                    "ts": self.formatTime(record),
                    "level": record.levelname.lower(),
                    "target": record.name,
                    "message": record.getMessage(),
                    "instance": getattr(record, "instance", None)
                    or telemetry.current_instance(),
                    "span": telemetry.current_span_id(),
                }
                if record.exc_info:
                    out["exception"] = self.formatException(record.exc_info)
                if record.stack_info:
                    out["stack"] = record.stack_info
                return _json.dumps(out)

        fmt: logging.Formatter = _JsonFormatter()
    elif cfg.logging.style == "full":
        fmt = logging.Formatter(
            "%(asctime)s %(levelname)-7s %(name)s "
            "[%(filename)s:%(lineno)d] %(message)s"
        )
    else:  # compact
        fmt = logging.Formatter("%(asctime)s %(levelname).1s %(name)s %(message)s")
    handler: logging.Handler = (
        logging.FileHandler(cfg.logging.file)
        if cfg.logging.file
        else logging.StreamHandler()
    )
    handler.setFormatter(fmt)
    root = logging.getLogger()
    for old in root.handlers:
        if isinstance(old, logging.FileHandler):
            old.close()  # re-config must not leak the previous sink's fd
    root.handlers[:] = [handler]
    root.setLevel(lvl)
    # Per-subsystem overrides: "ospf" -> holo_tpu_torch.ospf / providers etc.
    for name, level in cfg.logging.subsystems.items():
        target = name if name.startswith("holo_tpu") else f"holo_tpu_torch.{name}"
        logging.getLogger(target).setLevel(
            _resolve_level(level, logging.DEBUG, f"subsystem {name}")
        )


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(prog="holod_torch")
    ap.add_argument("-f", "--config", default=None, help="TOML static config")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; refuses to start without a card) or cpu")
    args = ap.parse_args(argv)
    # "cuda" with no card raises here, before anything is armed: there is
    # no quiet CPU run.
    device = resolve_device(None if args.device == "cuda" else args.device)
    cfg = DaemonConfig.load(args.config)
    setup_logging(cfg)
    # Dispatch-breaker knobs apply process-wide (protocol code builds
    # its SPF/FRR engines — and so their breakers — internally).  Set
    # at daemon BOOT only: merely constructing a Daemon object (tests,
    # simulations) must not rewrite process globals.
    from holo_tpu_torch.resilience.breaker import configure_defaults

    deadline = cfg.resilience.breaker_deadline
    if deadline is not None and device.type == "cuda":
        # A dispatch on the card has no fallback: an overrun would turn a
        # slow but correct SPF into an error in the protocol.
        log.warning("[resilience] breaker-deadline: a card dispatch has no "
                    "fallback to serve an overrun; not armed")
        deadline = None
    configure_defaults(
        failure_threshold=cfg.resilience.breaker_failure_threshold,
        recovery_timeout=cfg.resilience.breaker_recovery_timeout,
        deadline=deadline,
    )
    # Dispatch mesh ([parallel]): process-wide like the breaker knobs,
    # installed at BOOT only (constructing a Daemon object must not
    # rewrite process globals); on the CPU over virtual devices of the
    # host.  A shape that does not fit the device count degrades to
    # single-device dispatch with a warning rather than refusing to boot.
    if cfg.parallel.enabled:
        try:
            from holo_tpu_torch.parallel import mesh as _mesh

            devices = None
            if device.type != "cuda":
                devices = _mesh.virtual_devices(
                    (cfg.parallel.batch or 1) * (cfg.parallel.node or 1), device
                )
            mesh = _mesh.configure_process_mesh(
                cfg.parallel.batch, cfg.parallel.node, devices
            )
            log.info(
                "parallel dispatch mesh %s over %d device(s)",
                dict(mesh.shape),
                mesh.size,
            )
        except Exception as e:  # noqa: BLE001 — mesh is an optimization
            log.warning(
                "parallel mesh unavailable (%s); single-device dispatch", e
            )
    # Async dispatch pipeline + engine auto-tuner ([pipeline]):
    # process-wide like the mesh, installed at BOOT only.  The tuner can
    # arm independently (the synchronous dispatch path consults it too);
    # a configured tuner-cache path restores the learned per-shape
    # winners so restarts don't re-learn.
    if cfg.pipeline.enabled or cfg.pipeline.tuner:
        from holo_tpu_torch import pipeline as _pipeline

        if cfg.pipeline.tuner:
            tuner = _pipeline.configure_engine_tuner(
                path=cfg.pipeline.tuner_cache
            )
            log.info(
                "engine auto-tuner armed (%d persisted shape buckets)",
                tuner.stats()["buckets"],
            )
        if cfg.pipeline.enabled:
            _pipe = _pipeline.configure_process_pipeline(
                depth=cfg.pipeline.depth, capacity=cfg.pipeline.queue,
                advisory_deadline=cfg.pipeline.advisory_deadline,
            )
            log.info(
                "async dispatch pipeline armed (depth=%d queue=%d "
                "advisory-deadline=%s)",
                cfg.pipeline.depth, cfg.pipeline.queue,
                cfg.pipeline.advisory_deadline,
            )
            if cfg.pipeline.watchdog:
                # Hung-dispatch sentinel ([pipeline] watchdog): budgets
                # learned from the observatory's p99 sketches,
                # floor-clamped while sites are cold.
                from holo_tpu_torch.resilience.watchdog import (
                    configure_process_watchdog,
                )

                configure_process_watchdog(
                    _pipe,
                    multiplier=cfg.pipeline.watchdog_multiplier,
                    floor=cfg.pipeline.watchdog_floor,
                )
                log.info(
                    "dispatch watchdog armed (multiplier=%.1f "
                    "floor=%.1fs)",
                    cfg.pipeline.watchdog_multiplier,
                    cfg.pipeline.watchdog_floor,
                )
    from holo_tpu_torch.daemon import hardening

    lock_fd = None
    if cfg.lock_path:
        lock_fd = hardening.acquire_instance_lock(cfg.lock_path)
    daemon = Daemon(config=cfg, device=device)
    if cfg.grpc.enabled:
        try:
            daemon.start_grpc()
            log.info("gRPC northbound on %s", cfg.grpc.address)
        except ImportError as e:
            # The machine lacks the grpc package: configuration reaches
            # the daemon through [database] instead.
            log.warning("[grpc]: %s; the gRPC northbound is not served", e)
    if cfg.telemetry.enabled:
        daemon.start_telemetry()
        log.info("telemetry /metrics on %s", cfg.telemetry.address)
    log.info("holo_tpu_torch daemon running on %s", device)
    # Kernel link/address monitor (production path; requires NETLINK).
    monitor = None
    if os.geteuid() == 0:
        try:
            from holo_tpu_torch.routing.netlink import (
                LinkManager,
                NetlinkMonitor,
            )

            monitor = NetlinkMonitor()
            # Real link actuation: admin/MTU and vlan apply.
            lm = LinkManager()
            daemon.routing.link_mgr = lm
            daemon.interface.link_mgr = lm
            log.info("kernel interface monitor + link actuation active")
        except OSError as e:
            log.warning("kernel monitor unavailable: %s", e)

    if cfg.user:
        # Privileged sockets (raw, netlink) are open; drop now.
        hardening.drop_privileges(cfg.user)
    stopping = []
    # The dump queries ONLY the runtime provider — a full get_state fan-out
    # would render every provider's whole tree inside a signal handler.
    rt_provider = next(
        p for p in daemon.northbound.providers
        if isinstance(p, _RuntimeStateProvider)
    )
    from holo_tpu_torch.telemetry import flight as _flight

    hardening.install_signal_handlers(
        lambda: stopping.append(True),
        dump_cb=lambda: rt_provider.get_state().get("holo-runtime"),
        # Freeze the flight ring to a bundle (no-op unless [telemetry]
        # flight-buffer-entries + postmortem-dir are set).
        postmortem_cb=lambda: _flight.trigger("sigterm"),
    )
    try:
        while not stopping:
            with daemon.lock:
                if monitor is not None:
                    events = monitor.drain()
                    if monitor.overflowed:
                        log.warning("netlink queue overflow: full resync")
                        monitor.overflowed = False
                        events = monitor.resync()
                    for ev in events:
                        daemon.interface.apply_kernel_event(ev)
                daemon.loop.run_until_idle()
                daemon.northbound.check_confirmed_timeout(time.time())
                nd = daemon.loop.next_deadline()
                now = daemon.loop.clock.now()
            time.sleep(min(max(nd - now, 0.01), 0.2) if nd else 0.2)
        daemon.stop()
        log.info("daemon stopped")
    except KeyboardInterrupt:
        daemon.stop()
    finally:
        if cfg.pipeline.tuner and cfg.pipeline.tuner_cache:
            # Final table flush (promotions already saved eagerly):
            # the learned winners must survive an orderly shutdown.
            from holo_tpu_torch.pipeline import active_tuner

            t = active_tuner()
            if t is not None:
                t.save()
        if lock_fd is not None:
            os.close(lock_fd)


if __name__ == "__main__":
    main()
