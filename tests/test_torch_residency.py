"""The port's device-residency ledger (``telemetry.residency``) on the CPU:
each plane row equals an independent sum over the tensors it names (the
shared graph caches' ELL entries and tile attachments, their partitioned
residents, the backends' kept DeltaPath runs, the BGP lane planes), the
gauge family reads the same rows, and a dropped backend leaves the
``spf-prev`` row.  Tolerance: exact byte counts.
"""

import gc

import numpy as np
import pytest

from holo_tpu_torch import telemetry
from holo_tpu_torch.ops import bgp_table as tbt
from holo_tpu_torch.ops import spf_engine as se
from holo_tpu_torch.spf import synth as tsynth
from holo_tpu_torch.spf.backend import TorchSpfBackend
from holo_tpu_torch.telemetry import residency
from test_torch_bgp_table import ATTR, install, mk_engine


def _independent() -> dict:
    """The rows summed here, tensor by tensor, without the ledger's walk."""
    out = dict.fromkeys(residency.PLANES, 0)
    for cache in list(se._SHARED_CACHES.values()):
        for e in list(cache._cache.values()):
            out["spf-graph"] += sum(t.numel() * t.element_size() for t in e.graph)
            if e.tropical is not None:
                out["tropical"] += sum(t.numel() * t.element_size() for t in e.tropical)
        for r in list(cache._part.values()):
            out["spf-graph-partitioned"] += sum(t.numel() * t.element_size() for t in r.graph)
    for ref in residency._SPF_BACKENDS:
        b = ref()
        if b is None:
            continue
        for run in b._prev_one.values():
            parts = run if isinstance(run[0], tuple) else (run,)
            out["spf-prev"] += sum(t.numel() * t.element_size()
                                   for p in parts for t in p if t is not None)
    for b in tbt.live_backends():
        for dt in b._tables.values():
            out["bgp-table"] += dt.planes.numel() * dt.planes.element_size()
    return out


@pytest.fixture(scope="module")
def residents():
    """Every plane populated: a chain with kept runs (single and multipath),
    tiles, a partitioned resident and a BGP table."""
    topo = tsynth.random_ospf_topology(30, 4, 20, max_cost=5, seed=17)
    be = TorchSpfBackend(device="cpu")
    be.compute(topo)
    be.compute(topo, multipath_k=4)
    trop = TorchSpfBackend(device="cpu", one_engine="tropical")
    trop.compute(topo)
    part = TorchSpfBackend(device="cpu", partition_threshold=1)
    part.compute(tsynth.multiarea_topology(2, 4, 4, seed=17))
    bgp = tbt.TorchBgpTableBackend(device="cpu")
    eng, _ = mk_engine(backend=bgp)
    install(eng, [("10.0.0.0/24", "1.1.1.1", ATTR, "External", "1.1.1.1")])
    eng.run_decision_process()
    return {"be": be, "trop": trop, "part": part, "bgp": bgp, "eng": eng}


def test_rows_equal_independent_sums(residents):
    rows = residency.rows()
    want = _independent()
    assert {p: r["bytes"] for p, r in rows.items()} == want
    assert all(want[p] > 0 for p in residency.PLANES), want
    snap = residency.snapshot()
    assert snap["total-bytes"] == sum(want.values())
    assert rows["spf-prev"]["entries"] >= 2  # the kp=1 and kp=4 runs


def test_gauge_reads_the_rows(residents):
    snap = telemetry.snapshot("holo_device_resident_bytes")
    for plane in residency.PLANES:
        assert snap[f"holo_device_resident_bytes{{plane={plane}}}"] == residency.rows()[plane]["bytes"]


def test_dropped_backend_leaves_spf_prev():
    topo = tsynth.random_ospf_topology(20, 2, 10, seed=23)
    be = TorchSpfBackend(device="cpu")
    be.compute(topo)
    kept = sum(residency.nbytes(run) for run in be._prev_one.values())
    assert kept > 0
    before = residency.rows()["spf-prev"]["bytes"]
    del be
    gc.collect()
    assert residency.rows()["spf-prev"]["bytes"] == before - kept
    assert residency.rows()["spf-prev"]["bytes"] == _independent()["spf-prev"]


@pytest.mark.parametrize("obj,want", [
    (None, 0), ((np.zeros(3, np.int32), [np.zeros((2, 2), np.int64)]), 12 + 32),
    ({"a": np.zeros(5, np.uint8), "b": "x"}, 5),
])
def test_nbytes_walk(obj, want):
    assert residency.nbytes(obj) == want
