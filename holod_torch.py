#!/usr/bin/env python3
"""Run ``holo_tpu``'s routing daemon with the PyTorch/CUDA port behind
``spf-control/backend tpu``.

    python3 holod_torch.py -f holod.toml [--device cuda|cpu]

This is ``holo_tpu.daemon.daemon.main`` itself, run while :func:`launched`
binds the names it reads late to the port's counterparts: the breaker
defaults of ``[resilience]``, the dispatch mesh of ``[parallel]``, and the
dispatch pipeline, engine tuner (with its ``tuner-cache`` table) and
watchdog of ``[pipeline]`` are the port's, and ``holo_tpu``'s own stay
unarmed.  The daemon, its protocols, its main loop (BGP's TCP pump
included), northbound, gRPC and gNMI are ``holo_tpu``'s, so this file needs
JAX installed beside torch (the daemon's modules import it); it is the one
module that imports both packages.

Selection.  The names bound for the lifetime of :func:`launched`, and
restored when it exits (:data:`SEAMS`):

- ``holo_tpu.daemon.providers.TpuSpfBackend`` (read on each commit) becomes
  the launcher's subclass of ``TorchSpfBackend`` whose no-argument
  constructor runs on the launcher's device, so the provider's reuse check
  keeps one backend per OSPFv2 instance across commits;
- ``holo_tpu.pipeline.wrap_spf_backend`` / ``wrap_frr_engine`` become the
  port's (an armed port pipeline wraps the port's backend and FRR engine);
- ``holo_tpu.frr.manager.ensure_engine`` maps ``engine tpu`` to one kept
  port ``FrrEngine("torch")`` per instance, with ``holo_tpu``'s policy
  translated to the port's, and ``scalar`` to ``holo_tpu``'s scalar engine;
- the boot calls of ``main`` (``configure_defaults``,
  ``configure_process_mesh``, ``configure_engine_tuner``,
  ``configure_process_pipeline``, ``configure_process_watchdog``,
  ``active_tuner``) reach the port's;
- ``holo_tpu.daemon.daemon.Daemon`` becomes a subclass that attaches each
  daemon it builds to the port (:meth:`Launcher.attach`) and serves
  ``/metrics`` over both registries.

Only OSPFv2 has a ``backend`` leaf: IS-IS and OSPFv3 keep their scalar SPF
and take the port through their fast-reroute engine slot.

Device.  ``--device`` defaults to ``cuda``: with no card the launcher
refuses to start (there is no quiet CPU run); ``--device cpu`` runs the
port's plain PyTorch versions of the kernels on the host.  On the card a
dispatch has no fallback, so a breaker deadline would turn a slow but
correct SPF into an error in the protocol: ``[resilience] breaker-deadline``
is dropped there with a warning (on the CPU the oracle serves, and an
overrun keeps its result, as in ``holo_tpu``).

Telemetry.  ``/metrics`` serves the port's registry and ``holo_tpu``'s as
one (each family once; where both declare one, the port's samples serve).
The ``holo-telemetry`` state leaf reports the port's stats (pipeline, tuner,
graph cache with per-device placement, residency, observatory, critical
path, SLO, breakers) under ``holo_tpu``'s keys, and names the device.  With
``[telemetry] convergence-events`` armed, both convergence trackers run: a
dispatch of the port joins, as events of the port's tracker, the
``holo_tpu`` events active on its caller, each opened on first sight and
closed when ``holo_tpu`` commits its FIB (:class:`ConvergenceBridge`).
The pipeline worker and the watchdog run under ``holo_tpu``'s actor
supervisor (``Supervisor.watch_worker``).

Not ported (ROADMAP A4b): the canary prober, the gNMI shared fan-out,
relay and ``explain`` surfaces, and the boot device trace; the launcher
drops ``[telemetry] canary`` and ``device-trace-dir`` with a warning.
"""

from __future__ import annotations

import argparse
import functools
import logging
import threading
from contextlib import contextmanager
from dataclasses import fields, replace
from pathlib import Path

import holo_tpu.daemon.daemon as _jdaemon
import holo_tpu.daemon.providers as _jproviders
import holo_tpu.frr.manager as _jfrr
import holo_tpu.parallel.mesh as _jmesh
import holo_tpu.pipeline as _jpipeline
import holo_tpu.resilience.breaker as _jbreaker
import holo_tpu.resilience.watchdog as _jwatchdog
from holo_tpu import telemetry as _jtelemetry
from holo_tpu.daemon.config import DaemonConfig
from holo_tpu.telemetry import convergence as _jconv
from holo_tpu.telemetry.provider import ROOT, TelemetryStateProvider

from holo_tpu_torch import telemetry as _ttelemetry
from holo_tpu_torch.device import resolve_device
from holo_tpu_torch.frr.manager import FrrConfig, FrrEngine
from holo_tpu_torch.parallel import mesh as _tmesh
from holo_tpu_torch.pipeline import dispatch as _tdispatch
from holo_tpu_torch.pipeline import tuner as _ttuner
from holo_tpu_torch.resilience import breaker as _tbreaker
from holo_tpu_torch.resilience import watchdog as _twatchdog
from holo_tpu_torch.spf.backend import TorchSpfBackend
from holo_tpu_torch.telemetry import convergence as _tconv
from holo_tpu_torch.telemetry import flight as _tflight
from holo_tpu_torch.telemetry import observatory as _tobs
from holo_tpu_torch.telemetry import profiling as _tprof
from holo_tpu_torch.telemetry import provider as _tprovider
from holo_tpu_torch.telemetry import slo as _tslo
from holo_tpu_torch.telemetry.prometheus import MergedRegistry


log = logging.getLogger("holo_tpu.daemon.torch")


class ConvergenceBridge:
    """Carries ``holo_tpu``'s convergence events into the port's tracker.

    :meth:`activation` wraps each call into the port: every ``holo_tpu``
    event active on the caller's thread gets one port event (opened on first
    sight, under its trigger), and the call runs under the port's
    activation of those, so the port's dispatch sites, pipeline, critical
    path and SLO engine see them.  The bridge sits in ``holo_tpu``'s
    tracker as its critical-path hook (chained to any hook already there):
    when ``holo_tpu`` observes an event's ``fib`` or ``fallback`` phase the
    port's event is committed too, and an event ``holo_tpu`` closes any
    other way closes the port's with the same outcome."""

    def __init__(self):
        self._lock = threading.Lock()
        self._port_of: dict[int, int] = {}  # holo_tpu event id -> port event id
        self._prev = None
        self.armed = False

    def arm(self) -> None:
        if not self.armed:
            self._prev = _jconv._CP_HOOK
            _jconv.set_critpath_hook(self)
            self.armed = True

    def disarm(self) -> None:
        if self.armed:
            if _jconv._CP_HOOK is self:
                _jconv.set_critpath_hook(self._prev)
            self._prev = None
            self.armed = False
        with self._lock:
            self._port_of.clear()

    def port_events(self) -> dict[int, int]:
        """The open pairs: ``holo_tpu`` event id -> port event id."""
        with self._lock:
            return dict(self._port_of)

    @contextmanager
    def activation(self):
        jt, tt = _jconv.tracker(), _tconv.tracker()
        eids = jt.current() if self.armed and jt is not None and tt is not None else ()
        if not eids:
            yield
            return
        ports = []
        for ev in jt._events(eids):
            with self._lock:
                pe = self._port_of.get(ev.eid)
                if pe is None:
                    pe = self._port_of[ev.eid] = tt.begin(ev.trigger, holo_event=ev.eid)
            ports.append(pe)
        with _tconv.activation(tuple(ports)):
            yield

    def _pop(self, eid: int) -> int | None:
        with self._lock:
            return self._port_of.pop(eid, None)

    # -- holo_tpu's critical-path hook seam (each call forwarded first)

    def ev_begin(self, eid: int, trigger: str) -> None:
        if self._prev is not None:
            self._prev.ev_begin(eid, trigger)

    def ev_sched(self, eid: int) -> None:
        if self._prev is not None:
            self._prev.ev_sched(eid)

    def ev_phase(self, eid: int, phase: str) -> None:
        if self._prev is not None:
            self._prev.ev_phase(eid, phase)
        if phase in (_jconv.PHASE_FIB, _jconv.PHASE_FALLBACK):
            pe = self._pop(eid)
            if pe is not None:
                _tconv.fib_commit(eids=(pe,))

    def ev_done(self, eid: int, outcome: str, fallback: bool) -> None:
        if self._prev is not None:
            self._prev.ev_done(eid, outcome, fallback)
        pe = self._pop(eid)
        if pe is not None:
            _tconv.close((pe,), outcome)


def _bridged(fn):
    """``fn`` (a method of a launcher class) run under its launcher's
    convergence bridge."""
    @functools.wraps(fn)
    def call(self, *args, **kwargs):
        with self.launcher.bridge.activation():
            return fn(self, *args, **kwargs)
    return call


def _bridge_methods(base, names, launcher, doc: str) -> type:
    """A subclass of ``base`` whose ``names`` run under the bridge."""
    attrs = {name: _bridged(getattr(base, name)) for name in names}
    attrs.update(launcher=launcher, __doc__=doc, __module__=__name__)
    return type(f"Launched{base.__name__}", (base,), attrs)




class LaunchedDaemon(_jdaemon.Daemon):
    """``holo_tpu``'s daemon attached to a launcher when built: the
    unported ``[telemetry]`` surfaces dropped, then :meth:`Launcher.attach`.
    Each launcher makes its own subclass (:attr:`Launcher.daemon_class`)."""

    launcher: "Launcher"

    def __init__(self, config: DaemonConfig | None = None, **kwargs):
        super().__init__(config=_unported(config or DaemonConfig()), **kwargs)
        self.launcher.attach(self)

    def start_telemetry(self, address: str | None = None):
        """``/metrics`` over the port's registry and ``holo_tpu``'s."""
        from holo_tpu.telemetry.prometheus import start_http_server

        self._telemetry_server = start_http_server(
            merged_registry(), address or self.config.telemetry.address)
        return self._telemetry_server


class Launcher:
    """The port's side of a launched daemon: the device, the replacements
    of :data:`SEAMS`, the convergence bridge, and the process state they
    arm (undone by :meth:`disarm`)."""

    SPF_METHODS = ("compute", "compute_whatif", "compute_multiroot", "compute_partitioned")

    def __init__(self, device="cuda"):
        # "cuda" with no card raises here: no quiet CPU run.
        self.device = resolve_device(None if str(device) == "cuda" else device)
        self.bridge = ConvergenceBridge()
        self.spf_backend_class = _bridge_methods(
            TorchSpfBackend.bound_to(self.device), self.SPF_METHODS, self,
            "TorchSpfBackend on the launcher's device (no-argument constructor).")
        self.async_spf_class = _bridge_methods(
            _tdispatch.AsyncSpfBackend, self.SPF_METHODS + ("compute_whatif_async",), self,
            "The port's pipelined facade, its calls under the bridge.")
        self.frr_engine_class = _bridge_methods(FrrEngine, ("compute",), self,
                                                "The port's FRR engine under the bridge.")
        self.async_frr_class = _bridge_methods(_tdispatch.AsyncFrrEngine, ("compute",), self,
                                               "The port's pipelined FRR facade.")
        self.daemon_class = type("LaunchedDaemon", (LaunchedDaemon,),
                                 {"launcher": self, "__module__": __name__})
        self._armed: list = []  # undo steps, run in reverse by disarm()

    def replacements(self) -> dict:
        """Name in :data:`SEAMS` -> what the launcher binds there."""
        return {
            "TpuSpfBackend": self.spf_backend_class,
            "wrap_spf_backend": self.wrap_spf_backend,
            "wrap_frr_engine": self.wrap_frr_engine,
            "ensure_engine": self.ensure_engine,
            "configure_defaults": self.configure_defaults,
            "configure_process_mesh": self.configure_process_mesh,
            "configure_engine_tuner": self.configure_engine_tuner,
            "configure_process_pipeline": self.configure_process_pipeline,
            "configure_process_watchdog": self.configure_process_watchdog,
            "active_tuner": _ttuner.active_tuner,
            "Daemon": self.daemon_class,
        }

    # -- the selection seams

    def wrap_spf_backend(self, backend):
        """``holo_tpu.pipeline.wrap_spf_backend``'s replacement: the port's
        pipeline facade (bridged) over a port backend while a port pipeline
        is armed; anything else unchanged."""
        out = _tdispatch.wrap_spf_backend(backend)
        if out is backend:
            return out
        return self.async_spf_class(out.inner, out.pipeline)

    def wrap_frr_engine(self, engine):
        out = _tdispatch.wrap_frr_engine(engine)
        if out is engine:
            return out
        return self.async_frr_class(out.inner, out.pipeline)

    def ensure_engine(self, current, cfg):
        """``holo_tpu.frr.manager.ensure_engine``'s replacement: ``engine
        tpu`` keeps (or makes) one port ``FrrEngine("torch")`` in the slot,
        with ``cfg`` translated to the port's policy; ``scalar`` goes to
        ``holo_tpu``'s own step."""
        if cfg.engine != "tpu":
            return _ORIGINALS["ensure_engine"](current, cfg)
        if current is None or getattr(current, "engine", None) != "torch":
            current = self.wrap_frr_engine(self.frr_engine_class("torch", device=self.device))
        current.set_policy(FrrConfig.from_policy(cfg))
        return current

    # -- the boot seams: what holo_tpu's main arms, armed in the port

    def configure_defaults(self, **kwargs) -> None:
        """The port's breaker defaults.  A deadline is dropped on the card,
        where no fallback serves an overrun (see the module docstring)."""
        if kwargs.get("deadline") is not None and self.device.type == "cuda":
            log.warning("[resilience] breaker-deadline: a card dispatch has no fallback to "
                        "serve an overrun; not armed")
            kwargs["deadline"] = None
        saved = dict(_tbreaker.DEFAULTS)
        _tbreaker.configure_defaults(**kwargs)
        self._armed.append(lambda: _tbreaker.DEFAULTS.update(saved))

    def configure_process_mesh(self, n_batch=None, n_node=None, devices=None):
        """The port's mesh; on the CPU over virtual devices of the host."""
        if devices is None and self.device.type != "cuda":
            devices = _tmesh.virtual_devices((n_batch or 1) * (n_node or 1), self.device)
        mesh = _tmesh.configure_process_mesh(n_batch, n_node, devices)
        self._armed.append(_tmesh.reset_process_mesh)
        return mesh

    def configure_engine_tuner(self, path=None, **kwargs):
        tuner = _ttuner.configure_engine_tuner(path=path, **kwargs)
        self._armed.append(_ttuner.reset_engine_tuner)
        return tuner

    def configure_process_pipeline(self, **kwargs):
        pipe = _tdispatch.configure_process_pipeline(**kwargs)
        self._armed.append(_tdispatch.reset_process_pipeline)
        return pipe

    def configure_process_watchdog(self, pipeline, **kwargs):
        wd = _twatchdog.configure_process_watchdog(pipeline, **kwargs)
        self._armed.append(_twatchdog.reset_process_watchdog)
        return wd

    # -- a built daemon

    def attach(self, daemon) -> None:
        """Wire one built ``Daemon`` to the port, as ``holo_tpu``'s
        ``Daemon.__init__`` wires its own: the port's flight recorder,
        device profiling, observatory and SLO engine from the daemon's
        ``[telemetry]``, the pipeline worker and the watchdog under its
        supervisor, the merged ``holo-telemetry`` leaf, and, with
        ``convergence-events`` armed, the port's tracker on the daemon's
        loop clock with the bridge."""
        tc = daemon.config.telemetry
        if tc.flight_buffer_entries:
            pm_dir = str(Path(tc.postmortem_dir) / "torch") if tc.postmortem_dir else None
            _tflight.configure(entries=tc.flight_buffer_entries, postmortem_dir=pm_dir)
            self._armed.append(lambda: _tflight.configure(entries=0))
        if tc.profile_device_time or tc.observatory:
            _tprof.set_device_profiling(True)
            self._armed.append(lambda: _tprof.set_device_profiling(False))
        if tc.observatory:
            ledger = None
            if tc.observatory_ledger:
                p = Path(tc.observatory_ledger)
                ledger = p.with_name(f"{p.stem}_torch{p.suffix}")
            _tobs.configure(ledger_path=ledger, peaks=tc.roofline_peaks)
            self._armed.append(lambda: _tobs.configure(enabled=False))
        if tc.slo:
            names = {f.name for f in fields(_tslo.Objective)}
            objectives = tuple(_tslo.Objective(**{k: getattr(o, k) for k in names})
                               for o in tc.slo_objectives) or None
            _tslo.configure(True, objectives=objectives, fast_window=tc.slo_fast_window,
                            slow_window=tc.slo_slow_window, fast_burn=tc.slo_fast_burn)
            self._armed.append(lambda: _tslo.configure(False))
        if daemon.supervisor is not None:
            pipe = _tdispatch.process_pipeline()
            if pipe is not None and not pipe.closed:
                daemon.supervisor.watch_worker(pipe, "pipeline")
            wd = _twatchdog.process_watchdog()
            if wd is not None:
                daemon.supervisor.watch_worker(wd, wd.name)
        provs = daemon.northbound.providers
        for i, p in enumerate(provs):
            if type(p) is TelemetryStateProvider:
                provs[i] = PortTelemetryStateProvider(self)
        if tc.convergence_events:
            if _tconv.tracker() is None:
                self._armed.append(lambda: _tconv.configure(0))
            _tconv.configure(tc.convergence_events, clock=daemon.loop.clock.now)
            self.bridge.arm()

    def disarm(self) -> None:
        self.bridge.disarm()
        while self._armed:
            self._armed.pop()()


def merged_registry() -> MergedRegistry:
    """The port's process registry and ``holo_tpu``'s, the port's first."""
    return MergedRegistry(_ttelemetry.registry(), _jtelemetry.registry())


class PortTelemetryStateProvider(TelemetryStateProvider):
    """``holo_tpu``'s telemetry leaf over the merged registry, with the
    port's leaf (``holo_tpu_torch.telemetry.provider``) laid over it."""

    def __init__(self, launcher: Launcher):
        super().__init__(merged_registry())
        self.launcher = launcher

    def get_state(self, path: str | None = None) -> dict:
        out = super().get_state(path)
        if ROOT in out:
            port = _tprovider.state_leaf(device=self.launcher.device, metrics=False)
            out[ROOT] = _tprovider.merge_leaves(out[ROOT], port)
        return out


#: The names ``holo_tpu`` reads late, by module; a launcher binds each.
SEAMS = (
    (_jproviders, "TpuSpfBackend"),  # on each commit (providers.py:803)
    (_jpipeline, "wrap_spf_backend"),
    (_jpipeline, "wrap_frr_engine"),
    (_jfrr, "ensure_engine"),  # in each instance's _frr_engine_for
    # holo_tpu.daemon.daemon.main's boot, and its tuner flush at exit
    (_jbreaker, "configure_defaults"),
    (_jmesh, "configure_process_mesh"),
    (_jpipeline, "configure_engine_tuner"),
    (_jpipeline, "configure_process_pipeline"),
    (_jwatchdog, "configure_process_watchdog"),
    (_jpipeline, "active_tuner"),
    (_jdaemon, "Daemon"),
)
_ORIGINALS = {name: getattr(mod, name) for mod, name in SEAMS}
_LOCK = threading.Lock()
_ACTIVE: list = []  # the launcher bound now (at most one)


def bindings() -> dict:
    """The names of :data:`SEAMS` as ``holo_tpu`` reads them now."""
    return {name: getattr(mod, name) for mod, name in SEAMS}


@contextmanager
def launched(device="cuda"):
    """Bind :data:`SEAMS` to a :class:`Launcher` on ``device`` for the
    block's extent; the originals, and the port's process state that the
    launcher armed, are restored on exit, also when the block raises.  One
    launcher is bound at a time."""
    launcher = Launcher(device)
    with _LOCK:
        if _ACTIVE:
            raise RuntimeError("a launcher is already bound in this process")
        _ACTIVE.append(launcher)
    try:
        swap = launcher.replacements()
        for mod, name in SEAMS:
            setattr(mod, name, swap[name])
        yield launcher
    finally:
        for mod, name in SEAMS:
            setattr(mod, name, _ORIGINALS[name])
        try:
            launcher.disarm()
        finally:
            with _LOCK:
                _ACTIVE.clear()


def _unported(cfg: DaemonConfig) -> DaemonConfig:
    """``cfg`` without the ``[telemetry]`` surfaces that would run
    ``holo_tpu``'s JAX dispatch path (ROADMAP A4b), each dropped with a
    warning."""
    tc = cfg.telemetry
    drop = {}
    if tc.canary:
        log.warning("[telemetry] canary: the canary prober is not ported; not armed")
        drop["canary"] = False
    if tc.device_trace_dir:
        log.warning("[telemetry] device-trace-dir: the boot device trace is not ported; "
                    "not captured")
        drop["device_trace_dir"] = None
    if drop:
        cfg.telemetry = replace(tc, **drop)
    return cfg


def main(argv=None) -> None:
    """``holo_tpu.daemon.daemon.main`` (its arguments: ``-f``) under
    :func:`launched` on ``--device``."""
    ap = argparse.ArgumentParser(
        prog="holod_torch",
        epilog="Every other argument is holo_tpu.daemon.daemon.main's (-f/--config TOML).")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; refuses to start without a card) or cpu")
    args, rest = ap.parse_known_args(argv)
    with launched(args.device):
        _jdaemon.main(rest)


if __name__ == "__main__":
    main()
