"""The port's convergence storm (``holo_tpu_torch.spf.synth_storm``) against
``holo_tpu``'s on the CPU: seeded flap storms over one synthetic OSPFv2 LSDB
from LSA install to FIB commit, on the scalar oracle and on the device
backends (the port's ``TorchSpfBackend`` on the CPU against ``holo_tpu``'s
``TpuSpfBackend`` on JAX-CPU), single path and at ``max_paths=2``: FIB,
SPF runs, report and causal digest equal."""

import json

import pytest
import torch

from holo_tpu.resilience.faults import FaultPlan as JFaultPlan
from holo_tpu.spf import synth_storm as jstorm
from holo_tpu.spf.backend import ScalarSpfBackend as JScalar
from holo_tpu.spf.backend import TpuSpfBackend
from holo_tpu_torch.resilience.faults import FaultPlan
from holo_tpu_torch.spf import synth_storm as tstorm
from holo_tpu_torch.spf.backend import ScalarSpfBackend, TorchSpfBackend
from holo_tpu_torch.telemetry import convergence
from holo_tpu_torch.utils import runtime


def _fib(kernel):
    """The storm's FIB as plain values (the two packages' next-hop classes
    never compare equal)."""
    return {str(p): (sorted((str(nh.addr), nh.ifname, nh.ifindex) for nh in nhs), proto.name)
            for p, (nhs, proto) in kernel.fib.items()}


def _causal(timelines):
    """The timelines without their engine attribution, as
    ``tests/test_torch_gather_backend.py`` reads them."""
    out = []
    for rec in timelines:
        rec = {k: v for k, v in rec.items() if k != "dispatch"}
        rec["timeline"] = [e for e in rec["timeline"] if e[0] != "dispatch"]
        out.append(rec)
    return json.dumps(out, sort_keys=True)


def _run(mod, backend, monkeypatch, **kw):
    seen = []
    digest = mod.storm_digest

    def recording(timelines):
        seen.append(timelines)
        return digest(timelines)

    monkeypatch.setattr(mod, "storm_digest", recording)
    report, dig, net = mod.run_convergence_storm(spf_backend=backend, **kw)
    monkeypatch.setattr(mod, "storm_digest", digest)
    return report, dig, net, seen[0]


def _virtual(report):
    """The report without its host-clock dispatch seconds."""
    return {k: v for k, v in report.items() if k != "dispatch-wall"}


SIZES = [(120, 40, 9), (400, 120, 17)]


@pytest.mark.parametrize("max_paths", [None, 2])
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}r-{s[1]}ev-seed{s[2]}")
@pytest.mark.parametrize("arm", ["scalar", "device"])
def test_storm_matches_holo_tpu(arm, size, max_paths, monkeypatch):
    n, events, seed = size
    kw = dict(n_routers=n, events=events, seed=seed, max_paths=max_paths)
    if arm == "scalar":
        jbe, tbe = JScalar(), ScalarSpfBackend()
    else:
        jbe, tbe = TpuSpfBackend(), TorchSpfBackend(device="cpu")
    jr, jd, jnet, jtl = _run(jstorm, jbe, monkeypatch, **kw)
    tr, td, tnet, ttl = _run(tstorm, tbe, monkeypatch, **kw)
    assert tr["spf-runs"] == jr["spf-runs"] > 0
    assert _fib(tnet.kernel) == _fib(jnet.kernel) and len(tnet.kernel.fib) > 0
    assert _causal(ttl) == _causal(jtl)
    # The dispatch entries agree too: "scalar" on the oracles, "device" on
    # the device backends.
    assert td == jd
    modes = {e[2]["mode"] for r in ttl for e in r["timeline"] if e[0] == "dispatch"}
    assert modes == ({"scalar"} if arm == "scalar" else {"device"})
    assert _virtual(tr) == _virtual(jr)
    assert set(tr["dispatch-wall"]) == set(jr["dispatch-wall"])
    if max_paths:
        assert tr["fib-multipath"] > 0 and tr["fib-weighted"] > 0
    if arm == "device":
        assert tbe.delta_paths[("struct", "incremental")] > 0  # DeltaPath steps
        snap = tbe.breaker.snapshot()
        assert snap["failures"] == snap["fallbacks"] == snap["refusals"] == {}
        assert tbe.compute.__func__ is TorchSpfBackend.compute  # the wrapper is gone


def test_storm_is_deterministic_on_the_port(monkeypatch):
    kw = dict(n_routers=120, events=40, seed=9, max_paths=2)
    first = tstorm.run_convergence_storm(spf_backend=TorchSpfBackend(device="cpu"), **kw)
    second = tstorm.run_convergence_storm(spf_backend=TorchSpfBackend(device="cpu"), **kw)
    assert first[1] == second[1]
    assert _fib(first[2].kernel) == _fib(second[2].kernel)
    assert _virtual(first[0]) == _virtual(second[0])
    assert convergence.tracker() is None  # the storm disarms its tracker


def test_storm_runs_the_device_backend_by_default(monkeypatch):
    """No ``spf_backend``: a ``TorchSpfBackend`` on ``device``, the card
    unless the caller asks for the CPU; no card and no device raises."""
    net = tstorm.StormNet(n_routers=40, seed=3, device="cpu")
    assert type(net.inst.backend) is TorchSpfBackend
    assert net.inst.backend.device == torch.device("cpu")
    assert len(net.kernel.fib) > 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tstorm.run_convergence_storm(n_routers=40, events=4, seed=3)
    assert convergence.tracker() is None
    report, _, net = tstorm.run_convergence_storm(n_routers=40, events=4, seed=3, device="cpu")
    assert type(net.inst.backend) is TorchSpfBackend and report["spf-runs"] > 0


def test_fault_plan_streams_match_holo_tpu():
    for seed in (0, 9, 17):
        plan, jplan = FaultPlan(seed=seed, drop_prob=0.1), JFaultPlan(seed=seed, drop_prob=0.1)
        assert plan.drop_prob == jplan.drop_prob
        for site in ("storm.mix", "storm.loss", "storm.gap"):
            a, b = plan.rng(site), jplan.rng(site)
            assert [a.random() for _ in range(16)] == [b.random() for _ in range(16)]


def test_convergence_configure_installs_the_delivery_hook():
    """Arming the port's tracker installs the port loop's delivery hook, so
    a message's event ids are active on the actor that handles it."""
    seen = []

    class Probe(runtime.Actor):
        def handle(self, msg):
            seen.append(convergence.current())

    class Msg:
        def __init__(self, eid):
            self.event_id = (eid,)

    loop = runtime.EventLoop(clock=runtime.VirtualClock())
    loop.register(Probe(), name="probe")
    try:
        convergence.configure(16, clock=loop.clock.now)
        eid = convergence.begin(convergence.TRIGGER_LSA)
        loop.send("probe", Msg(eid))
        loop.run_until_idle()
        assert seen == [(eid,)]
    finally:
        convergence.configure(0)
    loop.send("probe", Msg(eid))
    loop.run_until_idle()
    assert seen == [(eid,), ()]
