"""The port's per-dispatch stage timing (``telemetry.profiling``) on the CPU.

- disarmed, a stage reads no timer, records nothing and creates no device
  clock (so no CUDA event on the card: tests/test_torch_cuda.py);
- armed, every dispatch site of the port records its stages, and a
  deterministic timer makes two runs of one seeded sequence byte-identical
  (the observer's stream, and the rendered stage histograms);
- ``stage_median`` equals ``holo_tpu``'s on the same observations, and so
  does the engine tuner's ``max_delta_depth`` fallback to the ``spf.one``
  delta and marshal stage medians;
- hooks are warn-only; an error of the dispatch itself propagates;
- ``HOLO_TPU_TORCH_TRACE_DUMP`` dumps the spans at exit, and
  ``capture_device_trace`` returns its "no CUDA device" row here.

Tolerance: exact equality.
"""

import importlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from holo_tpu.pipeline import tuner as jtuner
from holo_tpu.telemetry import profiling as jprof
from holo_tpu_torch import telemetry
from holo_tpu_torch.pipeline import tuner as ttuner
from holo_tpu_torch.spf import synth as tsynth
from holo_tpu_torch.spf.backend import TorchSpfBackend
from holo_tpu_torch.telemetry import profiling
from holo_tpu_torch.telemetry import prometheus

ROOT = Path(__file__).resolve().parent.parent
jreg = importlib.import_module("holo_tpu.telemetry.registry")
treg = importlib.import_module("holo_tpu_torch.telemetry.registry")


@pytest.fixture
def armed():
    profiling.set_device_profiling(True)
    yield
    profiling.set_device_profiling(False)
    profiling.set_stage_timer(None)
    profiling.set_observer(None)
    profiling.set_phase_hook(None)


class _Timer:
    """Deterministic: each read advances 1 ms; counts its reads."""

    def __init__(self):
        self.t = 0.0
        self.reads = 0

    def __call__(self):
        self.reads += 1
        self.t += 0.001
        return self.t


def test_disarmed_stage_reads_no_timer_and_records_nothing():
    timer = _Timer()
    profiling.set_stage_timer(timer)
    try:
        before = telemetry.snapshot("holo_profile_stage_seconds")
        with profiling.stage("spf.one", "marshal") as sid:
            assert sid is None
        clk = profiling.device_clock("spf.one")
        assert clk is None
        profiling.sync(clk)
        assert profiling.settle(clk, 1.0) is None
        assert not profiling.device_stages("spf.whatif", [clk, clk])
        assert timer.reads == 0
        # A dispatch reads the timer for its walls only (as holo_tpu's), and
        # records no stage.
        TorchSpfBackend(device="cpu").compute(tsynth.random_ospf_topology(12, 2, 6, seed=1))
        assert telemetry.snapshot("holo_profile_stage_seconds") == before
    finally:
        profiling.set_stage_timer(None)


def _sequence(seed: int = 2) -> None:
    """Every kind of SPF dispatch the backend has, on one seeded chain."""
    topo = tsynth.random_ospf_topology(20, 4, 16, max_cost=9, seed=seed)
    be = TorchSpfBackend(device="cpu")
    be.compute(topo)
    nxt = tsynth.clone_topology(topo, cost={0: 7, 3: 11})
    from holo_tpu_torch.ops import graph as tgraph

    nxt.link_delta(tgraph.diff_topologies(topo, nxt))
    be.compute(nxt)
    be.compute(nxt, multipath_k=2)
    masks = tsynth.whatif_link_failure_masks(nxt, 3, seed=seed)
    be.compute_whatif(nxt, masks)
    be.compute_multiroot(nxt, np.array([0, 2, 5], np.int32))
    be.finish_one(be.launch_one(nxt, masks[1]))
    TorchSpfBackend(device="cpu", engine="blocked").compute(nxt)
    TorchSpfBackend(device="cpu", partition_threshold=1).compute(
        tsynth.multiarea_topology(2, 4, 4, seed=seed))


def _run_observed() -> tuple[str, list]:
    stream = []
    profiling.set_stage_timer(_Timer())
    profiling.set_observer(lambda *row: stream.append(row))
    reg_before = telemetry.snapshot("holo_profile_stage_seconds")
    _sequence()
    delta = {k: v["count"] - reg_before.get(k, {"count": 0})["count"]
             for k, v in telemetry.snapshot("holo_profile_stage_seconds").items()}
    return json.dumps(stream), delta


def test_deterministic_timer_makes_two_runs_byte_identical(armed):
    first, d1 = _run_observed()
    second, d2 = _run_observed()
    assert first == second
    assert {k: v for k, v in d1.items() if v} == {k: v for k, v in d2.items() if v}
    sites = {row[0] for row in json.loads(first)}
    assert {"spf.one", "spf.whatif", "spf.multiroot", "spf.blocked",
            "spf.partitioned"} <= sites
    stages = {(row[0], row[1]) for row in json.loads(first)}
    for site in ("spf.one", "spf.whatif", "spf.multiroot", "spf.blocked"):
        assert {(site, "device"), (site, "readback")} <= stages
    assert ("spf.one", "delta") in stages and ("spf.one", "marshal") in stages


def test_device_stage_keeps_its_wall_on_the_cpu(armed):
    """On the CPU a device stage has no events: settle observes the stage's
    host wall and records it beside the dispatch wall."""
    profiling.set_stage_timer(_Timer())
    clk = profiling.device_clock("test.site")
    assert clk is not None and clk.start is None
    with profiling.stage("test.site", "device", clock=clk) as sid:
        profiling.sync(clk)
    assert clk.span_id == sid and clk.end is None
    assert profiling.settle(clk, 0.5) == pytest.approx(0.001)
    assert profiling.settle(clk, 0.5) is None  # once
    site, dev, dt, host, wall = profiling.settled()[-1]
    assert (site, dev, wall) == ("test.site", "-", 0.5) and dt == host
    assert profiling.event_records() == 0  # no card, no event


@pytest.mark.parametrize("values", [
    (0.0003,), (0.0003, 0.002, 0.002), (0.05, 0.0001, 7.0, 7.0, 0.3), (200.0, 1e-6, 0.01, 0.01),
])
def test_stage_median_matches_holo_tpu(monkeypatch, values):
    hj = jreg.MetricsRegistry().histogram("holo_profile_stage_seconds", "",
                                          ("site", "stage", "device"))
    ht = treg.MetricsRegistry().histogram("holo_profile_stage_seconds", "",
                                          ("site", "stage", "device"))
    monkeypatch.setattr(jprof, "_STAGE_SECONDS", hj)
    monkeypatch.setattr(profiling, "_STAGE_SECONDS", ht)
    assert profiling.stage_median("s", "x") is None is jprof.stage_median("s", "x")
    for v in values:
        hj.labels(site="s", stage="x", device="-").observe(v)
        ht.labels(site="s", stage="x", device="-").observe(v)
    assert profiling.stage_median("s", "x") == jprof.stage_median("s", "x")


@pytest.mark.parametrize("delta,marshal", [
    ((0.001, 0.001, 0.002), (0.05, 0.04)), ((0.01,), (0.01,)), ((0.0002,), (2.0, 2.0)),
    ((), (0.01,)),
])
def test_max_delta_depth_fallback_matches_holo_tpu(monkeypatch, delta, marshal):
    """A bucket with too few walls falls back to the spf.one delta / marshal
    stage medians while profiling is armed, in both packages."""
    hj = jreg.MetricsRegistry().histogram("holo_profile_stage_seconds", "",
                                          ("site", "stage", "device"))
    ht = treg.MetricsRegistry().histogram("holo_profile_stage_seconds", "",
                                          ("site", "stage", "device"))
    monkeypatch.setattr(jprof, "_STAGE_SECONDS", hj)
    monkeypatch.setattr(profiling, "_STAGE_SECONDS", ht)
    for stage, vals in (("delta", delta), ("marshal", marshal)):
        for v in vals:
            hj.labels(site="spf.one", stage=stage, device="-").observe(v)
            ht.labels(site="spf.one", stage=stage, device="-").observe(v)
    bucket = (64, 256, 1, None, 1)
    jt, tt = jtuner.EngineTuner(), ttuner.EngineTuner()
    jt.observe_delta(bucket, 0.001)
    tt.observe_delta(bucket, 0.001)
    jprof.set_device_profiling(True)
    profiling.set_device_profiling(True)
    try:
        want = jt.max_delta_depth(bucket, default=77)
        assert tt.max_delta_depth(bucket, default=77) == want
    finally:
        jprof.set_device_profiling(False)
        profiling.set_device_profiling(False)
    assert tt.max_delta_depth(bucket, default=77) == 77  # disarmed: the default


def test_hooks_are_warn_only_and_dispatch_errors_propagate(armed):
    def bad(*_):
        raise RuntimeError("hook bug")

    profiling.set_observer(bad)
    profiling.set_phase_hook(bad)
    with profiling.stage("test.site", "marshal"):
        pass
    with pytest.raises(KeyError, match="dispatch"):
        with profiling.stage("test.site", "marshal"):
            raise KeyError("dispatch")
    clk = profiling.device_clock("test.site")
    with profiling.stage("test.site", "device", clock=clk):
        pass
    profiling.settle(clk)


def test_annotation_is_a_profiler_range_only_while_armed():
    assert profiling.annotation("x") is profiling._NULLCTX
    profiling.set_device_profiling(True)
    try:
        import torch

        assert isinstance(profiling.annotation("x"), torch.profiler.record_function)
    finally:
        profiling.set_device_profiling(False)


def test_stage_spans_carry_exemplars(armed):
    reg = treg.MetricsRegistry()
    h = reg.histogram("holo_profile_stage_seconds", "", ("site", "stage", "device"))
    old = profiling._STAGE_SECONDS
    profiling._STAGE_SECONDS = h
    try:
        with profiling.stage("spf.one", "readback") as sid:
            pass
    finally:
        profiling._STAGE_SECONDS = old
    text = prometheus.render_text(reg, openmetrics=True)
    assert f'# {{span_id="{sid}"}}' in text
    assert telemetry.tracer().spans()[-1].name == "spf.one.readback"


def test_capture_device_trace_without_a_card(tmp_path):
    row = profiling.capture_device_trace(tmp_path / "trace")
    assert row == {"captured": False, "trace_dir": str(tmp_path / "trace"),
                   "reason": "no CUDA device"}
    assert not (tmp_path / "trace").exists()


def test_trace_dump_env(tmp_path):
    path = tmp_path / "spans.json"
    code = ("from holo_tpu_torch import telemetry\n"
            "with telemetry.span('spf.dispatch', kind='one'):\n"
            "    pass\n")
    env = {"HOLO_TPU_TORCH_TRACE_DUMP": str(path), "PATH": "/usr/bin:/bin",
           "PYTHONPATH": str(ROOT)}
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    events = json.loads(path.read_text())["traceEvents"]
    assert [e["name"] for e in events if e["ph"] == "X"] == ["spf.dispatch"]
