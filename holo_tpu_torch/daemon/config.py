"""Static daemon config (TOML), parsed at boot (the port's copy of
``holo_tpu.daemon.config``: one ``holod.toml`` configures either daemon).

Reference: holo-daemon/src/config.rs + holod.toml — user/group, db path,
logging, plugin addresses.  Runtime routing config flows through the
northbound transaction engine instead.  The port parses every section;
the daemon warns of and skips those whose surface is not ported
(``[gnmi]``, ``[event_recorder]``, ``[telemetry]`` canary and
device-trace-dir: ROADMAP A4b).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

try:
    import tomllib  # Python >= 3.11
except ImportError:  # pragma: no cover - interpreter-dependent
    # tomli is the stdlib module's upstream: a drop-in loads() for
    # pre-3.11 interpreters (a hand-rolled parser silently mis-handles
    # real TOML — escaped quotes, commas inside array strings).
    import tomli as tomllib


@dataclass
class LoggingConfig:
    level: str = "info"
    style: str = "compact"  # compact | full | json
    file: str | None = None
    # Per-subsystem level overrides (the reference's per-target tracing
    # directives, main.rs:59-146): {"ospf": "debug", "bgp.fsm": "trace"}.
    # Keys address holo_tpu_torch logger names below the package root.
    subsystems: dict = field(default_factory=dict)


@dataclass
class GrpcConfig:
    enabled: bool = True
    address: str = "127.0.0.1:50051"
    # TLS (holo-daemon grpc.rs TLS option): both paths set = secure port.
    tls_cert: str | None = None
    tls_key: str | None = None


@dataclass
class GnmiConfig:
    enabled: bool = False
    address: str = "127.0.0.1:50052"
    tls_cert: str | None = None
    tls_key: str | None = None


@dataclass
class EventRecorderConfig:
    enabled: bool = False
    dir: str = "/tmp/holo_tpu-events"


@dataclass
class TelemetryConfig:
    # The registry itself is always on (metrics cost nanoseconds and the
    # gNMI state subtree serves them regardless); this section gates the
    # Prometheus scrape endpoint and the exit trace dump.
    enabled: bool = False
    address: str = "127.0.0.1:9464"  # Prometheus /metrics endpoint
    # Path for a Chrome trace-event JSON span dump written at daemon
    # stop (None = no dump; HOLO_TPU_TORCH_TRACE_DUMP env overrides).
    trace_dump: str | None = None
    # Flight recorder: > 0 arms a bounded in-memory ring of
    # recent spans / journal markers / resilience events; breaker-open,
    # crash-loop degrade, and SIGTERM then dump a postmortem JSON
    # bundle to postmortem-dir (render: holo-tpu-tools postmortem).
    flight_buffer_entries: int = 0
    postmortem_dir: str | None = None
    # Per-dispatch device-time breakdown (marshal / device / readback
    # sub-spans + compile-time FLOP/bytes cost capture).  Off by
    # default: the enabled path times each dispatch's device stage on
    # CUDA events.
    profile_device_time: bool = False
    # Convergence observatory: > 0 arms the causal event→FIB tracker
    # with that many open-event/timeline slots —
    # holo_convergence_seconds{trigger,phase} histograms, causal ids on
    # ibus envelopes, per-event timelines into the flight ring.  Off by
    # default.
    convergence_events: int = 0
    # Shared-delta gNMI fan-out (parsed; the gNMI server is not ported).
    gnmi_shared_fanout: bool = True
    # Base tick (seconds) for ON_CHANGE delta delivery and the fan-out
    # coalescing cadence floor.
    fanout_tick: float = 1.0
    # Boot device trace directory (parsed; not ported: the daemon warns
    # and captures nothing).
    device_trace_dir: str | None = None
    # Dispatch observatory: streaming quantile sketches per
    # (site, stage, engine, shape-bucket, kind) fed from the profiling
    # sub-span path, roofline attribution against the compile-time
    # cost model, and the warn-only regression sentinel.  Arming it
    # also arms profile-device-time (the observatory feeds off the
    # sub-span walls).
    observatory: bool = False
    # Persisted sentinel baseline (seed unseen keys, flag >10% drift,
    # ratchet improvements).  None keeps the ledger in memory only.
    observatory_ledger: str | None = None
    # Roofline peak specs {flops=<per sec>, bytes=<per sec>, name=...};
    # None = the observatory's defaults.
    roofline_peaks: dict | None = None
    # SLO plane: error budgets + multi-window burn-rate
    # sentinels graded from the convergence end-cut / pipeline shed /
    # relay watch streams.  Objectives come from
    # [[telemetry.slo-objectives]] tables (name, kind, source,
    # quantile, threshold-ms, target); empty = the shipped default set
    # (trigger-fib latency, canary, relay availability, background
    # delivery).  Warn-only by contract.
    slo: bool = False
    slo_objectives: tuple = ()
    slo_fast_window: float = 3600.0
    slo_slow_window: float = 86400.0
    slo_fast_burn: float = 14.4
    # Synthetic canary prober (parsed and validated; not ported: the
    # daemon warns and starts none).  Requires convergence-events > 0.
    canary: bool = False
    canary_period: float = 5.0
    canary_deadline: float = 0.25


@dataclass
class ResilienceConfig:
    # Actor supervision ([resilience] in holod.toml): restart crashed
    # protocol actors with exponential backoff + deterministic jitter;
    # a crash loop (threshold crashes within window) parks the actor in
    # a permanent degraded state instead of flapping.
    supervision: bool = True
    restart_base_delay: float = 0.5
    restart_max_delay: float = 30.0
    crash_loop_threshold: int = 5
    crash_loop_window: float = 60.0
    # Dispatch circuit breaker defaults (TorchSpfBackend / FrrEngine):
    # consecutive failures before the circuit opens, seconds before a
    # half-open probe, optional per-dispatch deadline budget (seconds;
    # an overrun counts as a failure).  On the card a dispatch has no
    # fallback, and main() arms no deadline there.
    breaker_failure_threshold: int = 3
    breaker_recovery_timeout: float = 30.0
    breaker_deadline: float | None = None


@dataclass
class ParallelConfig:
    # Dispatch mesh ([parallel] in holod.toml): the daemon installs one
    # process-wide (batch, node) mesh at boot and TorchSpfBackend /
    # FrrEngine / the shared DeviceGraphCache dispatch over it
    # (parallel/mesh.py).  Default: enabled, all devices on the batch
    # axis — a 1-device host runs the single-device program.
    enabled: bool = True
    # Axis sizes; None = derive (both None -> all devices on batch;
    # one set -> the other is devices/that).  batch*node must equal the
    # device count or boot logs a warning and stays single-device.
    batch: int | None = None
    node: int | None = None


@dataclass
class PipelineConfig:
    # Async dispatch pipeline + engine auto-tuner ([pipeline] in
    # holod.toml): when enabled, the daemon installs one process-wide
    # dispatch pipeline at boot and TorchSpfBackend / FrrEngine
    # instances built by the providers are wrapped so protocol actors
    # enqueue SPF/FRR work instead of blocking on the device
    # (pipeline/dispatch.py).  Off by default.
    enabled: bool = False
    # Launched-but-unfinished entries (2 = double buffering) and the
    # bounded queue (a full queue backpressures the submitting actor).
    depth: int = 2
    queue: int = 32
    # Per-shape engine auto-tuner (pipeline/tuner.py): can be
    # armed independently of the async pipeline — the synchronous
    # dispatch path consults it too.
    tuner: bool = False
    # Versioned on-disk tuner table (restarts don't re-learn); None
    # keeps the table in memory only.
    tuner_cache: str | None = None
    # Survivability plane.  Default relative deadline
    # (seconds) stamped onto advisory what-if tickets — expired batches
    # are shed at dequeue; None = advisory work never expires.
    advisory_deadline: float | None = None
    # Hung-dispatch watchdog: a supervised sentinel abandons a
    # launch/finish phase that overruns max(site-p99 × multiplier,
    # floor) — the breaker escalates, and the worker respawns under
    # the Supervisor RestartPolicy.  Off by default (the stamps cost
    # nothing while disarmed, but a hang budget is policy).
    watchdog: bool = False
    watchdog_multiplier: float = 4.0
    watchdog_floor: float = 5.0


@dataclass
class RuntimeConfig:
    # "threaded" (default): each protocol instance on its own OS thread
    # — the reference's PRODUCTION posture (per-instance spawn_blocking,
    # holo-protocol/src/lib.rs:419-430).  Requires the real clock;
    # virtual-clock (test) daemons automatically fall back to
    # "cooperative" single-loop scheduling, the analog of the
    # reference's `testing` feature.
    isolation: str = "threaded"
    # True when [runtime] isolation was explicitly configured (vs the
    # default): an EXPLICIT threaded request that must downgrade (no
    # real clock) warns; the defaulted case downgrades silently.
    isolation_explicit: bool = False


@dataclass
class DaemonConfig:
    db_path: str | None = None
    # Production hardening (holo-daemon/src/main.rs:28-209 equivalents).
    lock_path: str | None = None  # flock single-instance (None = off)
    user: str | None = None  # drop privileges to this user after setup
    logging: LoggingConfig = field(default_factory=LoggingConfig)
    grpc: GrpcConfig = field(default_factory=GrpcConfig)
    gnmi: GnmiConfig = field(default_factory=GnmiConfig)
    event_recorder: EventRecorderConfig = field(default_factory=EventRecorderConfig)
    telemetry: TelemetryConfig = field(default_factory=TelemetryConfig)
    runtime: RuntimeConfig = field(default_factory=RuntimeConfig)
    resilience: ResilienceConfig = field(default_factory=ResilienceConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    pipeline: PipelineConfig = field(default_factory=PipelineConfig)

    @classmethod
    def load(cls, path: str | Path | None) -> "DaemonConfig":
        cfg = cls()
        if path is None or not Path(path).exists():
            return cfg
        raw = tomllib.loads(Path(path).read_text())
        if "database" in raw:
            cfg.db_path = raw["database"].get("path")
        if "daemon" in raw:
            cfg.lock_path = raw["daemon"].get("lock-path")
            cfg.user = raw["daemon"].get("user")
        if "logging" in raw:
            for k in ("level", "style", "file"):
                if k in raw["logging"]:
                    setattr(cfg.logging, k, raw["logging"][k])
            subs = raw["logging"].get("subsystems")
            if isinstance(subs, dict):
                cfg.logging.subsystems = dict(subs)
        if "grpc" in raw:
            g = raw["grpc"]
            cfg.grpc.enabled = g.get("enabled", True)
            cfg.grpc.address = g.get("address", cfg.grpc.address)
            cfg.grpc.tls_cert = g.get("tls-cert")
            cfg.grpc.tls_key = g.get("tls-key")
        if "gnmi" in raw:
            g = raw["gnmi"]
            cfg.gnmi.enabled = g.get("enabled", False)
            cfg.gnmi.address = g.get("address", cfg.gnmi.address)
            cfg.gnmi.tls_cert = g.get("tls-cert")
            cfg.gnmi.tls_key = g.get("tls-key")
        if "event_recorder" in raw:
            e = raw["event_recorder"]
            cfg.event_recorder.enabled = e.get("enabled", False)
            cfg.event_recorder.dir = e.get("dir", cfg.event_recorder.dir)
        if "telemetry" in raw:
            t = raw["telemetry"]
            cfg.telemetry.enabled = t.get("enabled", False)
            cfg.telemetry.address = t.get("address", cfg.telemetry.address)
            cfg.telemetry.trace_dump = t.get("trace-dump")
            cfg.telemetry.flight_buffer_entries = int(
                t.get("flight-buffer-entries", 0)
            )
            cfg.telemetry.postmortem_dir = t.get("postmortem-dir")
            cfg.telemetry.convergence_events = int(
                t.get("convergence-events", 0)
            )
            cfg.telemetry.profile_device_time = t.get(
                "profile-device-time", False
            )
            cfg.telemetry.gnmi_shared_fanout = t.get(
                "gnmi-shared-fanout", True
            )
            cfg.telemetry.fanout_tick = float(t.get("fanout-tick", 1.0))
            cfg.telemetry.device_trace_dir = t.get("device-trace-dir")
            cfg.telemetry.observatory = t.get("observatory", False)
            cfg.telemetry.observatory_ledger = t.get("observatory-ledger")
            rp = t.get("roofline-peaks")
            if rp is not None:
                ok = isinstance(rp, dict) and all(
                    isinstance(rp.get(k), (int, float))
                    and not isinstance(rp.get(k), bool)
                    and rp.get(k) > 0
                    for k in ("flops", "bytes")
                )
                if not ok:
                    raise ValueError(
                        "[telemetry] roofline-peaks must be a table with "
                        f"positive 'flops' and 'bytes', got {rp!r}"
                    )
                cfg.telemetry.roofline_peaks = dict(rp)
            cfg.telemetry.slo = t.get("slo", False)
            objs = t.get("slo-objectives")
            if objs is not None:
                from holo_tpu_torch.telemetry.slo import Objective

                if not isinstance(objs, list):
                    raise ValueError(
                        "[telemetry] slo-objectives must be an array of "
                        f"tables, got {objs!r}"
                    )
                try:
                    cfg.telemetry.slo_objectives = tuple(
                        Objective.from_config(o) for o in objs
                    )
                except (KeyError, TypeError, ValueError) as exc:
                    raise ValueError(
                        f"[telemetry] slo-objectives invalid: {exc!r}"
                    ) from exc
            cfg.telemetry.slo_fast_window = float(
                t.get("slo-fast-window", 3600.0)
            )
            cfg.telemetry.slo_slow_window = float(
                t.get("slo-slow-window", 86400.0)
            )
            cfg.telemetry.slo_fast_burn = float(t.get("slo-fast-burn", 14.4))
            if (
                cfg.telemetry.slo_fast_window <= 0
                or cfg.telemetry.slo_slow_window
                < cfg.telemetry.slo_fast_window
                or cfg.telemetry.slo_fast_burn <= 0
            ):
                raise ValueError(
                    "[telemetry] slo windows must satisfy 0 < "
                    "slo-fast-window <= slo-slow-window and "
                    "slo-fast-burn > 0"
                )
            cfg.telemetry.canary = t.get("canary", False)
            cfg.telemetry.canary_period = float(t.get("canary-period", 5.0))
            cfg.telemetry.canary_deadline = float(
                t.get("canary-deadline", 0.25)
            )
            if cfg.telemetry.canary_period <= 0:
                raise ValueError(
                    "[telemetry] canary-period must be positive, got "
                    f"{cfg.telemetry.canary_period}"
                )
            if (
                cfg.telemetry.canary
                and cfg.telemetry.convergence_events <= 0
            ):
                raise ValueError(
                    "[telemetry] canary requires convergence-events > 0 "
                    "(probes close at fib_commit through the causal "
                    "tracker)"
                )
        if "resilience" in raw:
            r = raw["resilience"]
            res = cfg.resilience
            res.supervision = r.get("supervision", True)
            for toml_key, attr in (
                ("restart-base-delay", "restart_base_delay"),
                ("restart-max-delay", "restart_max_delay"),
                ("crash-loop-threshold", "crash_loop_threshold"),
                ("crash-loop-window", "crash_loop_window"),
                ("breaker-failure-threshold", "breaker_failure_threshold"),
                ("breaker-recovery-timeout", "breaker_recovery_timeout"),
                ("breaker-deadline", "breaker_deadline"),
            ):
                if toml_key in r:
                    setattr(res, attr, r[toml_key])
        if "parallel" in raw:
            p = raw["parallel"]
            cfg.parallel.enabled = p.get("enabled", True)
            for key in ("batch", "node"):
                if key in p:
                    v = p[key]
                    # bool is an int subclass: `batch = true` must be
                    # rejected, not silently installed as batch=1.
                    if (
                        isinstance(v, bool)
                        or not isinstance(v, int)
                        or v < 1
                    ):
                        raise ValueError(
                            f"[parallel] {key} must be a positive "
                            f"integer, got {v!r}"
                        )
                    setattr(cfg.parallel, key, v)
        if "pipeline" in raw:
            p = raw["pipeline"]
            cfg.pipeline.enabled = p.get("enabled", False)
            cfg.pipeline.tuner = p.get("tuner", cfg.pipeline.enabled)
            cfg.pipeline.tuner_cache = p.get("tuner-cache")
            for key in ("depth", "queue"):
                if key in p:
                    v = p[key]
                    # bool is an int subclass: `depth = true` must be
                    # rejected, not silently installed as depth=1.
                    if (
                        isinstance(v, bool)
                        or not isinstance(v, int)
                        or v < 1
                    ):
                        raise ValueError(
                            f"[pipeline] {key} must be a positive "
                            f"integer, got {v!r}"
                        )
                    setattr(cfg.pipeline, key, v)
            cfg.pipeline.watchdog = p.get("watchdog", False)
            for key, toml_key in (
                ("advisory_deadline", "advisory-deadline"),
                ("watchdog_multiplier", "watchdog-multiplier"),
                ("watchdog_floor", "watchdog-floor"),
            ):
                if toml_key in p:
                    v = p[toml_key]
                    if isinstance(v, bool) or not isinstance(
                        v, (int, float)
                    ) or v <= 0:
                        raise ValueError(
                            f"[pipeline] {toml_key} must be a positive "
                            f"number, got {v!r}"
                        )
                    setattr(cfg.pipeline, key, float(v))
        if "runtime" in raw:
            iso = raw["runtime"].get("isolation")
            if iso is not None:
                if iso not in ("cooperative", "threaded"):
                    raise ValueError(
                        f"[runtime] isolation must be 'cooperative' or "
                        f"'threaded', got {iso!r}"
                    )
                cfg.runtime.isolation = iso
                cfg.runtime.isolation_explicit = True
        return cfg
