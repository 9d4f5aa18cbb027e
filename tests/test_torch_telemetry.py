"""The port's telemetry against holo_tpu's on the CPU.

- render parity: one sequence of metric operations on
  ``holo_tpu.telemetry.registry.MetricsRegistry`` and on the port's renders
  byte-identical Prometheus text, 0.0.4 and OpenMetrics, and the same flat
  snapshot; the span tracers under one deterministic clock give equal chrome
  traces;
- counter parity: one seeded sequence through ``TpuSpfBackend`` on JAX-CPU
  and ``TorchSpfBackend(device="cpu")`` (a DeltaPath chain, a what-if
  batch, a multi-root batch, multipath, a masked compute, partitioned SPF
  with a delta, FRR, a BGP batch, and full dispatches under an armed engine
  tuner), profiling armed on both, moves each exported family by the same
  counts.  The two packages keep separate process-wide registries, and
  tests share worker processes, so only deltas of snapshots are compared.

Tolerance: exact equality (counts and rendered bytes).
"""

import importlib
import json
import time

import numpy as np
import pytest

from holo_tpu import telemetry as jtel
from holo_tpu.frr.manager import FrrEngine as JFrrEngine
from holo_tpu.ops import bgp_table as jbt
from holo_tpu.pipeline import tuner as jtuner
from holo_tpu.spf import synth as jsynth
from holo_tpu.spf.backend import TpuSpfBackend
from holo_tpu.telemetry import profiling as jprof
from holo_tpu.telemetry import prometheus as jprom
from holo_tpu.telemetry import trace as jtrace
from holo_tpu_torch import telemetry as ttel
from holo_tpu_torch.frr.manager import FrrEngine
from holo_tpu_torch.ops import bgp_table as tbt
from holo_tpu_torch.pipeline import tuner as ttuner
from holo_tpu_torch.spf import backend as tbackend
from holo_tpu_torch.spf import synth as tsynth
from holo_tpu_torch.spf.backend import TorchSpfBackend
from holo_tpu_torch.telemetry import profiling as tprof
from holo_tpu_torch.telemetry import prometheus as tprom
from holo_tpu_torch.telemetry import trace as ttrace
from test_torch_bgp_table import ATTR, install, mk_engine, seg
from test_torch_delta import _mutation, _step
from test_torch_frr import port_topology

# The packages' ``registry()`` functions shadow the submodules' names.
jreg = importlib.import_module("holo_tpu.telemetry.registry")
treg = importlib.import_module("holo_tpu_torch.telemetry.registry")

# -- render parity


def _drive(reg) -> None:
    """One fixed sequence of metric operations (labels to escape, +Inf,
    floats, exemplars, callback gauges, an empty label-less family)."""
    c = reg.counter("holo_x_events_total", "Events by kind", ("kind",))
    c.labels(kind="a").inc()
    c.labels(kind='q"uote\\back\nline').inc(2.5)
    c.labels("b").inc(0)
    reg.counter("holo_x_empty_total", "Declared, never written")
    g = reg.gauge("holo_x_depth", "A depth", ("queue",))
    g.labels(queue="q0").set(3)
    g.labels(queue="q0").inc(0.25)
    g.labels(queue="q1").dec(7)
    g.labels(queue="q2").set_fn(lambda: 1.5e-7)
    g.labels(queue="q3").set(float("inf"))
    h = reg.histogram("holo_x_seconds", "Latency", ("site",), buckets=(0.001, 0.01, 0.1, 1.0))
    for v, sid in ((0.0005, 1), (0.005, 2), (0.005, 3), (0.5, None), (7.0, 9)):
        h.labels(site="s").observe(v, exemplar=None if sid is None else {"span_id": sid})
    h2 = reg.histogram("holo_x_default_seconds", "Default ladder")
    h2.observe(0.0003)
    h2.observe(200.0)
    reg.gauge("holo_x_plain", "No labels").set(-2)


@pytest.mark.parametrize("openmetrics", [False, True])
def test_render_text_matches_holo_tpu(openmetrics):
    jr, tr = jreg.MetricsRegistry(), treg.MetricsRegistry()
    _drive(jr)
    _drive(tr)
    want = jprom.render_text(jr, openmetrics=openmetrics)
    got = tprom.render_text(tr, openmetrics=openmetrics)
    assert got == want
    assert ("# {" in got) == openmetrics  # exemplars only under OpenMetrics


def test_snapshot_and_kill_switch_match_holo_tpu():
    jr, tr = jreg.MetricsRegistry(), treg.MetricsRegistry()
    _drive(jr)
    _drive(tr)
    assert tr.snapshot() == jr.snapshot()
    assert tr.snapshot("holo_x_d") == jr.snapshot("holo_x_d")
    treg.set_enabled(False)
    jreg.set_enabled(False)
    try:
        for reg in (jr, tr):
            reg.counter("holo_x_events_total", "", ("kind",)).labels(kind="a").inc(5)
        # Frozen alike: no write lands, a callback gauge reads its last set.
        assert tr.snapshot() == jr.snapshot()
        assert tr.snapshot()["holo_x_events_total{kind=a}"] == 1.0
    finally:
        treg.set_enabled(True)
        jreg.set_enabled(True)


class _Clock:
    """A deterministic clock: each read advances by 1.25 ms."""

    def __init__(self):
        self.t = 100.0

    def __call__(self):
        self.t += 0.00125
        return self.t


def _spans(tracer) -> None:
    tracer.use_clock(_Clock())
    with tracer.span("spf.dispatch", kind="one", backend="x", batch=4):
        with tracer.span("spf.one.marshal", stage="marshal", device="-"):
            pass
        with tracer.span("spf.one.device", stage="device", device="0", obj=(1, 2)):
            pass
    with tracer.span("frr.dispatch", engine="x"):
        pass


def test_chrome_trace_matches_holo_tpu(tmp_path):
    jt, tt = jtrace.SpanTracer(), ttrace.SpanTracer()
    _spans(jt)
    _spans(tt)
    assert tt.to_chrome_trace("p") == jt.to_chrome_trace("p")
    assert tt.dump(tmp_path / "t.json") == jt.dump(tmp_path / "j.json") == 4
    assert (json.loads((tmp_path / "t.json").read_text())["traceEvents"][1:]
            == json.loads((tmp_path / "j.json").read_text())["traceEvents"][1:])


# -- counter parity

#: the families compared, holo_tpu's names
FAMILIES = (
    "holo_spf_dispatch_seconds",
    "holo_profile_stage_seconds",
    "holo_spf_graph_cache_total",
    "holo_spf_delta_total",
    "holo_spf_scenarios_total",
    "holo_spf_tropical_marshal_total",
    "holo_spf_tropical_delta_total",
    "holo_spf_partition_total",
    "holo_frr_dispatch_seconds",
    "holo_frr_graph_cache_total",
    "holo_bgp_table_dispatch_total",
    "holo_bgp_table_update_rows",
    "holo_bgp_table_recomputed_prefixes",
    "holo_bgp_table_fallback_total",
    "holo_pipeline_tuner_decisions_total",
)
# Families that stay at 0 in the sequence (no failure, no fault, no retry).
QUIET = ("holo_resilience_", "holo_pipeline_transient_retries_total",
         "holo_pipeline_watchdog_hangs_total")


def _counts(snap: dict) -> dict:
    return {k: (v["count"] if isinstance(v, dict) else v) for k, v in snap.items()}


def _delta(before: dict, after: dict) -> dict:
    b, a = _counts(before), _counts(after)
    return {k: v - b.get(k, 0) for k, v in a.items() if v != b.get(k, 0)}


def _family(delta: dict, name: str) -> dict:
    """The series of ``name`` in a delta, the backend and engine label values
    (``tpu`` in holo_tpu, ``torch`` in the port) read as ``device``."""
    out = {}
    for k, v in delta.items():
        if k == name or k.startswith(name + "{"):
            out[k.replace("=tpu", "=device").replace("=torch", "=device")] = v
    return out


def _bgp(backend) -> None:
    eng, _ = mk_engine(backend=backend)
    routes = [(f"10.{i}.0.0/24", f"1.1.1.{j}",
               ATTR.__class__(origin="Igp", as_path=seg(100 + j), nexthop=f"9.9.9.{j}",
                              med=j), "External", f"1.1.1.{j}")
              for i in range(4) for j in (1, 2, 3)]
    # A med past the lane contract poisons its prefix back to the oracle.
    routes.append(("10.9.0.0/24", "1.1.1.1",
                   ATTR.__class__(origin="Igp", as_path=seg(9), nexthop="9.9.9.1", med=2**32),
                   "External", "1.1.1.1"))
    install(eng, routes)
    eng.run_decision_process()


def _sequence(side: str) -> None:
    """The seeded dispatch sequence through one package (``side``), both
    packages fed the same topologies, masks and roots."""
    tt = tsynth.random_ospf_topology(40, 8, 60, max_cost=3, seed=100)
    jt = jsynth.random_ospf_topology(40, 8, 60, max_cost=3, seed=100)
    make = (lambda **kw: TorchSpfBackend(device="cpu", **kw)) if side == "torch" else (
        lambda **kw: TpuSpfBackend(**kw))
    pick = (lambda t, j: t) if side == "torch" else (lambda t, j: j)
    be = make()
    be.compute(pick(tt, jt))
    rng = np.random.default_rng(4)
    for _ in range(6):
        tt, jt, _, _ = _step(tt, jt, **_mutation(tt, rng))
        be.compute(pick(tt, jt))
    # A pinned-tropical chain: its deltas ride the tile attachment too.
    trop = make(one_engine="tropical")
    ct, cj = tt, jt
    trop.compute(pick(ct, cj))
    for _ in range(2):
        ct, cj, _, _ = _step(ct, cj, **_mutation(ct, rng))
        trop.compute(pick(ct, cj))
    masks = tsynth.whatif_link_failure_masks(tt, 4, seed=5)
    be.compute_whatif(pick(tt, jt), masks)
    be.compute_multiroot(pick(tt, jt), np.array([0, 3, 7, 11], np.int32))
    be.compute(pick(tt, jt), multipath_k=4)
    be.compute(pick(tt, jt), masks[1])
    # Partitioned: a full solve, a masked one, a delta re-solve.
    ta, ja = (tsynth.multiarea_topology(4, 6, 6, seed=3),
              jsynth.multiarea_topology(4, 6, 6, seed=3))
    pb = make(partition_threshold=1)
    pb.compute(pick(ta, ja))
    pb.compute(pick(ta, ja), tsynth.whatif_link_failure_masks(ta, 3, seed=5)[1])
    ta, ja, _, _ = _step(ta, ja, cost={e: 60 + e % 7 for e in range(0, ta.n_edges, 3)})
    pb.compute(pick(ta, ja))
    # FRR and BGP on their small fixtures.
    jf = jsynth.random_ospf_topology(n_routers=10, n_networks=3, seed=0)
    if side == "torch":
        FrrEngine("torch", device="cpu").compute(port_topology(jf))
        _bgp(tbt.TorchBgpTableBackend(device="cpu"))
    else:
        JFrrEngine("tpu").compute(jf)
        _bgp(jbt.TpuBgpTableBackend())
    # Full dispatches under an armed tuner: explore_rounds 100 keeps every
    # pick in the explore phase, whose order depends on no timing.
    mod = ttuner if side == "torch" else jtuner
    mod.configure_engine_tuner(explore_rounds=100)
    try:
        tb = make()
        ut = tsynth.random_ospf_topology(30, 4, 20, max_cost=5, seed=8)
        uj = jsynth.random_ospf_topology(30, 4, 20, max_cost=5, seed=8)
        for i in range(6):
            tb.compute(pick(ut, uj), tsynth.whatif_link_failure_masks(ut, 2, seed=i)[1])
        tb.compute_whatif(pick(ut, uj), tsynth.whatif_link_failure_masks(ut, 3, seed=9))
    finally:
        mod.reset_engine_tuner()


@pytest.fixture(scope="module")
def parity(request):
    """Each package's snapshot delta over the sequence, profiling armed on
    both.  holo_tpu's compile-time cost capture is stubbed: it re-lowers
    every fresh jit (seconds on the CPU) and feeds no compared family.  The
    port's cost source is stubbed alike, so that neither tuner gets a cost
    prior and both explore in the same order."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jprof, "record_cost", lambda *a, **k: None)
    mp.setattr(tprof, "record_cost", lambda *a, **k: None)
    mp.setattr(tbackend, "_DISPATCHED", set())
    jprof.set_device_profiling(True)
    tprof.set_device_profiling(True)
    try:
        out = {}
        for side, tel in (("jax", jtel), ("torch", ttel)):
            before = tel.snapshot()
            t0 = time.perf_counter()
            _sequence(side)
            out[side] = _delta(before, tel.snapshot())
            out[side + "-seconds"] = time.perf_counter() - t0
        return out
    finally:
        jprof.set_device_profiling(False)
        tprof.set_device_profiling(False)
        mp.undo()


@pytest.mark.parametrize("family", FAMILIES)
def test_counter_deltas_match_holo_tpu(parity, family):
    want = _family(parity["jax"], family)
    got = _family(parity["torch"], family)
    assert want, f"{family}: holo_tpu's sequence moved nothing"
    assert got == want


def test_resilience_counters_stay_zero(parity):
    moved = {k: v for k, v in parity["torch"].items() if k.startswith(QUIET)}
    assert moved == {}
