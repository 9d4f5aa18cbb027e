"""The port's kernel-contract audit (HL301-HL305), the twin of
``tests/test_jaxpr_audit.py``: golden fixtures per rule on small torch
programs, seeded mutations of real seams, registry inertness and parity
with ``holo_tpu``'s, the per-kernel cache, and the repo-wide clean gate.

The fixtures build :class:`KernelSpec` rows by hand and drive
``audit_kernel`` / ``audit_entries`` directly (no registry, no cache), so
each rule's fire / clean / suppressed behavior is shown alone.  The repo
audit runs cold once for the module; the cache tests run on a registry of a
few real programs.
"""

import dataclasses
import json
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from holo_tpu_torch.analysis import kernel_audit as ka
from holo_tpu_torch.analysis import runtime
from holo_tpu_torch.analysis.cache import run_audit_cached, self_check
from holo_tpu_torch.analysis.core import gate_findings, parse_suppressions
from holo_tpu_torch.analysis.kernels import KernelSpec, register_kernel, registry
from holo_tpu_torch.analysis.kernel_audit import (
    SEAM_MODULES,
    apply_suppressions,
    audit_entries,
    audit_kernel,
    audit_mesh,
    load_registry,
    spec_signature,
)
from holo_tpu_torch.parallel.mesh import gather_batch

REPO = Path(__file__).resolve().parent.parent
HERE = "tests/test_torch_kernel_audit.py"


def _vec(device="cpu", n=64):
    return (torch.arange(n, dtype=torch.int32, device=device),)


def _entry(name, program, specs=_vec, **kw):
    kw.setdefault("buckets", 1)
    kw.setdefault("module", "fixture_mod.py")
    kw.setdefault("line", 3)
    builder = (lambda mesh: program) if kw.get("needs_mesh") else (lambda: program)
    return KernelSpec(name=name, builder=builder, specs=specs, **kw)


def _fired(entry, mesh=None):
    findings, wall = audit_kernel(entry, mesh=mesh)
    assert wall >= 0.0
    return {f.rule for f in findings}, findings


# -- golden fixtures: one flagged + one clean per rule ------------------


def test_clean_kernel_produces_no_findings():
    fired, findings = _fired(_entry("fix.clean", lambda x: x.add_(1), donate=(0,)))
    assert fired == set(), [f.render() for f in findings]


def test_hl301_copy_where_in_place_was_declared_fires():
    fired, findings = _fired(_entry("fix.donation.copy", lambda x: x + 1, donate=(0,)))
    assert fired == {"HL301"}
    (f,) = findings
    assert f.severity == "error"
    assert "0/1" in f.message


def test_hl301_partial_donation_counts_leaves():
    # Two donated leaves: the first moved in place and returned, the
    # second handed back as a fresh copy.
    def program(pair):
        pair[0].add_(1)
        return pair[0], pair[1].clone()

    entry = _entry("fix.donation.partial", program,
                   specs=lambda device: ((_vec(device)[0], _vec(device)[0].clone()),),
                   donate=(0,))
    fired, findings = _fired(entry)
    assert fired == {"HL301"}
    assert "1/2" in findings[0].message


def test_hl301_in_place_program_returning_nothing_is_clean():
    def program(x):
        x.mul_(2)

    fired, _ = _fired(_entry("fix.donation.none", program, donate=(0,)))
    assert fired == set()


def _item(x):
    return x + int(x[0].item())


def _bool(x):
    return x + 1 if bool((x > 3).any()) else x


def _item_in_window(x):
    with runtime.sanctioned_transfer("test.audit"):
        k = int(x[0].item())
    return x + k


def _bool_in_read_flag(x):
    return x + 1 if runtime.read_flag("test.audit", (x > 3).any()) else x


def _readback(x):
    return torch.from_numpy(x.cpu().numpy() + 1)


def _upload(x):
    return x + torch.as_tensor(np.arange(64, dtype=np.int32)).to(x.device)


def _upload_in_window(x):
    with runtime.sanctioned_transfer("test.audit"):
        y = torch.as_tensor(np.arange(64, dtype=np.int32)).to(x.device)
    return x + y


def _scalar_write(x):
    x = x.clone()
    x[torch.arange(4, device=x.device)] = 0
    return x


@pytest.mark.parametrize("program,fires,what", [
    (_item, True, "_local_scalar_dense"),
    (_bool, True, "_local_scalar_dense"),
    (lambda x: torch.nonzero(x > 3), True, "nonzero"),
    (lambda x: x[x > 3], True, "boolean-mask index"),
    (lambda x: torch.repeat_interleave(x, (x % 2).long()), True, "repeat_interleave"),
    (_readback, True, "Tensor.cpu"),
    (_upload, True, "host data uploaded"),
    (_scalar_write, True, "host scalar written"),
    (_item_in_window, False, None),
    (_bool_in_read_flag, False, None),
    (_upload_in_window, False, None),
    (lambda x: torch.where(x > 3, x, 0), False, None),
], ids=["item", "bool", "nonzero", "mask-index", "repeat-interleave", "readback", "upload",
        "scalar-write", "item-in-window", "bool-in-read-flag", "upload-in-window", "where"])
def test_hl302_host_round_trips(program, fires, what):
    fired, findings = _fired(_entry("fix.hostleak", program))
    if not fires:
        assert fired == set(), [f.render() for f in findings]
        return
    assert fired == {"HL302"}
    (f,) = findings
    assert f.severity == "error"
    assert what in f.message


def test_hl303_int32_sum_fires():
    fired, findings = _fired(_entry("fix.widen.sum", lambda x: x + x.sum()))
    assert fired == {"HL303"}
    (f,) = findings
    assert f.severity == "warn"
    assert "int64 (from `sum`)" in f.message


def test_hl303_float_mean_fires():
    fired, findings = _fired(_entry("fix.widen.mean", lambda x: (x + 1, x.float().mean())))
    assert fired == {"HL303"}
    assert "float32" in findings[0].message


def test_hl303_mixed_int32_int64_arithmetic_fires():
    fired, findings = _fired(_entry("fix.widen.mixed",
                                    lambda x: x + torch.arange(64, device=x.device)))
    assert fired == {"HL303"}
    assert "int64 (from `add`)" in findings[0].message


def test_hl303_index_lanes_and_narrow_sums_are_clean():
    def program(x):
        idx = (x % 7).long()  # an explicit cast: an index lane
        return torch.gather(x, 0, idx + 1), x.sum(dtype=torch.int32), x.argmax()

    fired, findings = _fired(_entry("fix.index", program))
    assert fired == set(), [f.render() for f in findings]


def test_hl303_respects_widened_declaration():
    entry = _entry("fix.widen.ok", lambda x: (x + x.sum(), x.float().mean()),
                   dtypes=("int32", "uint32", "bool", "int64", "float32"))
    fired, _ = _fired(entry)
    assert fired == set()


def test_hl304_unbounded_buckets_fires():
    fired, findings = _fired(_entry("fix.unbounded", lambda x: x + 1, buckets=None))
    assert fired == {"HL304"}
    assert "unbounded" in findings[0].message


def test_hl304_over_budget_fires():
    fired, findings = _fired(_entry("fix.overbudget", lambda x: x + 1, buckets=80, budget=64))
    assert fired == {"HL304"}
    assert "80" in findings[0].message


def _shards(x):
    return [x[:32] + 1, x[32:] + 1]


def test_hl305_missing_join_fires_on_a_two_device_mesh():
    mesh = audit_mesh("cpu")
    assert mesh.size == 2
    entry = _entry("fix.unjoined", lambda x: _shards(x), fences=1, needs_mesh=True)
    fired, findings = _fired(entry, mesh=mesh)
    assert fired == {"HL305"}
    assert findings[0].severity == "warn"
    assert "0 time(s)" in findings[0].message


def test_hl305_realized_join_is_clean():
    mesh = audit_mesh("cpu")
    entry = _entry("fix.joined", lambda x: gather_batch(mesh, _shards(x), 64), fences=1,
                   needs_mesh=True)
    fired, _ = _fired(entry, mesh=mesh)
    assert fired == set()


def test_hl305_mesh_needing_kernel_skipped_without_mesh():
    entry = _entry("fix.meshonly", lambda x: x + 1, fences=1, needs_mesh=True)
    per_kernel, seconds, skipped = audit_entries([entry], mesh=None)
    assert skipped == ["fix.meshonly"]
    assert per_kernel == {} and seconds == {}


# -- suppression flow ---------------------------------------------------


def test_audit_findings_honor_disable_comments(tmp_path):
    (tmp_path / "fixture_mod.py").write_text(
        "# fixture seam module\n"
        "# holo-lint: disable=HL304\n"
        "register_kernel_call_site = None\n"
    )
    entry = _entry("fix.suppressed", lambda x: x + 1, buckets=None, line=3)
    findings, _ = audit_kernel(entry)
    live, suppressed = apply_suppressions(findings, str(tmp_path))
    assert live == []
    assert [f.rule for f in suppressed] == ["HL304"]

    # A different rule id on the same line stays live.
    other = dataclasses.replace(entry, name="fix.other", buckets=1, donate=(0,),
                                builder=lambda: (lambda x: x + 1))
    findings, _ = audit_kernel(other)
    live, suppressed = apply_suppressions(findings, str(tmp_path))
    assert [f.rule for f in live] == ["HL301"]
    assert suppressed == []
    assert parse_suppressions("x = 1  # holo-lint: disable=HL301, HL302\n") == {
        1: {"HL301", "HL302"}}


# -- seeded mutations of REAL registered programs -----------------------


def test_mutation_apply_delta_rebuilt_out_of_place(monkeypatch):
    from holo_tpu_torch.ops import spf_engine as se

    def out_of_place(g, ops):
        at = (torch.from_numpy(ops.rows).to(g.in_src.device),
              torch.from_numpy(ops.cols).to(g.in_src.device))
        return g._replace(
            in_src=g.in_src.index_put(at, torch.from_numpy(ops.src)),
            in_cost=g.in_cost.index_put(at, torch.from_numpy(ops.cost)),
            in_valid=g.in_valid.index_put(at, torch.from_numpy(ops.valid)),
        )

    entry = load_registry()["spf.delta.apply"]
    assert audit_kernel(entry)[0] == []
    monkeypatch.setattr(se, "apply_delta_slots", out_of_place)
    findings, _ = audit_kernel(entry)
    assert "HL301" in {f.rule for f in findings}
    (f,) = [f for f in findings if f.rule == "HL301"]
    assert "0/6" in f.message


def test_mutation_sharded_whatif_without_its_join():
    from holo_tpu_torch.ops.spf_engine import spf_whatif_batch

    entry = load_registry()["spf.shard.whatif"]
    mutated = dataclasses.replace(
        entry, builder=lambda mesh: lambda g, r, ms: spf_whatif_batch(g, r, ms, None))
    findings, _ = audit_kernel(mutated, mesh=audit_mesh("cpu"))
    assert {f.rule for f in findings} == {"HL305"}


def test_mutation_real_kernel_with_unbounded_buckets():
    entry = load_registry()["spf.tropical.one"]
    findings, _ = audit_kernel(dataclasses.replace(entry, buckets=None))
    assert {f.rule for f in findings} == {"HL304"}


def test_mutation_widened_lane_in_a_real_program(monkeypatch):
    # The BGP plain fold's multipath rank with torch's default cumsum, which
    # promotes the int32 counts to int64 (what this audit first found).
    from holo_tpu_torch.kernels import bgp

    real = torch.cumsum
    monkeypatch.setattr(bgp.torch, "cumsum",
                        lambda x, dim, dtype=None: real(x, dim=dim))
    findings, _ = audit_kernel(load_registry()["bgp.table.fold"])
    assert {f.rule for f in findings} == {"HL303"}


# -- the faults the audit found (ROADMAP C4-C8), each at its function -------


def _graph_inputs():
    from holo_tpu_torch.ops import spf_engine as se

    a = se.audit_specs("cpu")
    return a, se.lane_planes(a["g"], se.pack_edge_masks(a["masks"], torch.device("cpu")))


def _c4_lane_tests():
    from holo_tpu_torch.kernels import ell

    _, p = _graph_inputs()
    return lambda: (ell._usable(p.slot, p.mask, slice(0, 8)),
                    ell._unpack(p.mask, slice(0, 8)))


def _c5_direct_atom_seed():
    from holo_tpu_torch.ops import tropical

    a, _ = _graph_inputs()
    g = a["g"]
    npaths = torch.ones(g.in_src.shape[0], dtype=torch.int32)
    return lambda: tropical.direct_atom_seed(g, g.in_valid, npaths)


def _c6_plain_fold():
    from holo_tpu_torch.kernels import bgp
    from holo_tpu_torch.ops import bgp_table

    args = bgp_table._pick("sub", "order", "rank", "has", "nht_enc", "nht_res", "mp")("cpu")
    return lambda: bgp.fold_plain(*args)


def _c7_repair_rows():
    from holo_tpu_torch.ops import tropical

    a = tropical._audit_specs("cpu")
    return lambda: tropical.rows_to_bits(a["rrs"], a["tt"])


def _c7_plain_repair_pass():
    from holo_tpu_torch.kernels import ell
    from holo_tpu_torch.kernels import tropical as kt
    from holo_tpu_torch.ops import spf_engine as se
    from holo_tpu_torch.ops import tropical

    a = tropical._audit_specs("cpu")
    tt, g = a["tt"], a["g"]
    mask = se.pack_edge_masks(a["masks"], torch.device("cpu"))
    p = se.lane_planes(g, mask)
    rep = kt.repair_set(tropical.repair_bits(p.slot, mask, 8, tt), 8)
    dist = se.distance_seed(g.in_src.shape[0], torch.zeros(8, dtype=torch.int32))[0]
    dist = tropical._pad_rows(dist, tt.perm.shape[0], se.INF)[tt.perm.long()].contiguous()
    active = ell.full_frontier(tt.tiles.shape[0], 8, torch.device("cpu"))
    return lambda: kt.trop_relax_plain(tt.tiles, tt.cb, dist, active, dist.clone(), rep,
                                       p.src, p.cost, p.slot, p.mask, tt.perm, tt.inv)


def _c8_pinned_fixpoint():
    from holo_tpu_torch.ops import partition as pt

    a = pt._audit_part_specs("cpu")
    return lambda: pt.pinned_fixpoint(a["st"], pt.stack_dag(a["plan"], a["st"], a["dist"], 1),
                                      a["pin"], a["pins"], 1, 32)


def _c8_boundary_seed():
    from holo_tpu_torch.ops import partition as pt

    a = pt._audit_part_specs("cpu")
    return lambda: (pt.boundary_dist(a["st"], a["rows"], a["cols"], a["lanes"], 32),
                    pt.part_stack(a["plan"], a["g"], [0, 3]))


@pytest.mark.parametrize("make", [_c4_lane_tests, _c5_direct_atom_seed, _c6_plain_fold,
                                  _c7_repair_rows, _c7_plain_repair_pass, _c8_pinned_fixpoint,
                                  _c8_boundary_seed],
                         ids=["C4-lane-tests", "C5-direct-atom-seed", "C6-plain-fold",
                              "C7-repair-rows", "C7-plain-repair-pass", "C8-pinned-fixpoint",
                              "C8-boundary-seed"])
def test_fixed_faults_stay_fixed(make):
    """Each function the audit found at fault runs with no host round-trip
    outside a window and no widened lane (ROADMAP section C, C4-C8)."""
    _, rec = ka.record(make())
    assert dict(rec.leaks) == {}
    assert rec.widened == {}


# -- registry: inert outside the audit ------------------------------------


def _restore_registry(saved):
    from holo_tpu_torch.analysis import kernels

    kernels._REGISTRY.clear()
    kernels._REGISTRY.update(saved)


def test_registration_never_invokes_thunks():
    saved = registry()

    def boom(*a, **k):  # pragma: no cover - the assertion IS the test
        raise AssertionError("audit thunk invoked outside the audit")

    try:
        register_kernel("test.inert", builder=boom, specs=boom, buckets=1)
        entry = registry()["test.inert"]
        assert entry.builder is boom and entry.specs is boom
        assert entry.module == HERE
        assert entry.line > 0
    finally:
        _restore_registry(saved)


def test_importing_the_seam_modules_allocates_nothing():
    code = (
        "import sys, torch\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "made = []\n"
        "import torch.utils._python_dispatch as d\n"
        "class M(d.TorchDispatchMode):\n"
        "    def __torch_dispatch__(self, f, t, a=(), k=None):\n"
        "        made.append(str(f)); return f(*a, **(k or {}))\n"
        "with M():\n"
        "    from holo_tpu_torch.analysis.kernel_audit import load_registry\n"
        "    n = len(load_registry())\n"
        "print(n, len(made))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["33", "0"]


def test_register_decorator_form_and_overwrite():
    saved = registry()
    try:

        @register_kernel("test.deco", specs=lambda device: (), buckets=1)
        def build():  # pragma: no cover - never invoked
            raise AssertionError("invoked")

        assert registry()["test.deco"].builder is build
        assert registry()["test.deco"].module == HERE
        register_kernel("test.deco", builder=build, specs=lambda device: (), buckets=2)
        assert registry()["test.deco"].buckets == 2
    finally:
        _restore_registry(saved)


def test_every_seam_module_registers_kernels():
    entries = load_registry()
    assert len(entries) == 33
    by_module = {e.module for e in entries.values()}
    for mod in SEAM_MODULES:
        assert mod.replace(".", "/") + ".py" in by_module, mod
    for e in entries.values():
        src = (REPO / e.module).read_text().splitlines()
        assert 0 < e.line <= len(src), (e.name, e.module, e.line)
        assert "_register_kernel(" in src[e.line - 1] or "_register_kernel(" in src[e.line - 2]


def test_spec_signature_is_stable_and_contract_sensitive():
    entry = load_registry()["spf.one.incremental"]
    sig = spec_signature(entry)
    assert sig == spec_signature(entry)
    for change in ({"donate": (2,)}, {"fences": 1}, {"dtypes": ("int32",)}, {"buckets": 8},
                   {"budget": 8}, {"needs_mesh": True}):
        assert spec_signature(dataclasses.replace(entry, **change)) != sig, change
    wider = dataclasses.replace(
        entry, specs=lambda device: entry.specs(device)[:3] + (np.zeros(7, np.int32),))
    assert spec_signature(wider) != sig


# The table of every registration whose donate or dtypes differs from
# holo_tpu's: (holo_tpu's donate, the port's).  The port's DeltaPath reads the
# previous planes and makes new ones, where holo_tpu's jits donate them.
DONATE_DIFFERS = {
    "spf.one.incremental": ((2,), ()),
    "spf.one.incremental.multipath.k2": ((2, 3, 4), ()),
    "spf.tropical.incremental": ((3,), ()),
    "spf.tropical.incremental.multipath.k2": ((3, 4, 5), ()),
}
DTYPES_DIFFER: dict = {}


def test_registry_parity_with_holo_tpu():
    from holo_tpu.analysis.jaxpr_audit import load_registry as jax_registry

    jax_entries = jax_registry()
    ours = load_registry()
    assert sorted(ours) == sorted(jax_entries)
    for name, e in ours.items():
        j = jax_entries[name]
        assert (e.buckets, e.budget, e.fences, e.needs_mesh) == (
            j.buckets, j.budget, j.fences, j.needs_mesh), name
        assert (j.donate, e.donate) == DONATE_DIFFERS.get(name, (j.donate, j.donate)), name
        assert (j.dtypes, e.dtypes) == DTYPES_DIFFER.get(name, (j.dtypes, j.dtypes)), name
        if name in DONATE_DIFFERS:
            src = (REPO / e.module).read_text().splitlines()
            above = "\n".join(src[max(e.line - 6, 0): e.line - 1])
            assert "holo_tpu donates" in above, name


# -- the window depth of analysis.runtime ---------------------------------


def test_window_depth_is_per_thread_and_counts_nothing_extra():
    before = runtime.sanctioned_counts()
    seen = {}
    entered, release = threading.Event(), threading.Event()

    def other():
        seen["start"] = runtime.window_depth()
        entered.wait()
        seen["during"] = runtime.window_depth()
        release.set()

    t = threading.Thread(target=other)
    t.start()
    assert runtime.window_depth() == 0
    with runtime.sanctioned_transfer("test.depth"):
        assert runtime.window_depth() == 1
        with runtime.sanctioned_transfer("test.depth"):
            assert runtime.window_depth() == 2
        entered.set()
        release.wait()
        assert runtime.read_flag("test.depth", torch.ones(1, dtype=torch.bool))
        assert runtime.window_depth() == 1
    t.join()
    assert runtime.window_depth() == 0
    assert seen == {"start": 0, "during": 0}
    after = runtime.sanctioned_counts()
    assert after["test.depth"] == before.get("test.depth", 0) + 3
    assert {k: v for k, v in after.items() if k != "test.depth"} == {
        k: v for k, v in before.items() if k != "test.depth"}
    with pytest.raises(ValueError):
        with runtime.sanctioned_transfer("test.depth"):
            raise ValueError("the depth unwinds on an error")
    assert runtime.window_depth() == 0


# -- the repo-wide gate ---------------------------------------------------


@pytest.fixture(scope="module")
def repo_audit():
    """The audit of the tree through the default cache (cold in a fresh
    checkout), which leaves the cache warm for the replay test."""
    return run_audit_cached(REPO)


def test_repo_audit_error_tier_is_clean(repo_audit):
    assert repo_audit.kernels_checked == 33
    assert repo_audit.skipped == [], repo_audit.skipped
    errors = gate_findings(repo_audit.findings)
    assert errors == [], "\n".join(f.render() for f in errors)


def test_repo_audit_currently_warn_clean(repo_audit):
    assert repo_audit.findings == [], "\n".join(f.render() for f in repo_audit.findings)
    assert repo_audit.suppressed == []


def test_warm_audit_replay_never_imports_torch(repo_audit):
    probe = (
        "import sys\n"
        "from pathlib import Path\n"
        "from holo_tpu_torch.analysis.cache import run_audit_cached\n"
        f"res = run_audit_cached(Path({str(REPO)!r}))\n"
        "assert res.kernels_checked == 33, res.kernels_checked\n"
        "assert res.kernels_cached == res.kernels_checked\n"
        "assert 'torch' not in sys.modules, 'warm replay imported torch'\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", probe], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "ok" in proc.stdout


# -- the per-kernel cache, on a registry of a few real programs -----------

# holo-lint: disable=HL304
SUPPRESSED_SITE = None

_SMALL = ("bgp.table.grow", "bgp.table.scatter", "spf.delta.apply", "spf.partition.gather")


@pytest.fixture
def small_registry(monkeypatch):
    """Four real programs plus two fixture rows anchored in this file: one
    with a live HL304 and one under the disable comment above."""
    entries = {k: v for k, v in load_registry().items() if k in _SMALL}
    line = next(i for i, s in enumerate((REPO / HERE).read_text().splitlines(), start=1)
                if s.startswith("SUPPRESSED_SITE"))
    for name, at in (("fix.live", 1), ("fix.suppressed", line)):
        entries[name] = _entry(name, lambda x: x + 1, buckets=None, module=HERE, line=at)
    monkeypatch.setattr(ka, "load_registry", lambda: dict(entries))
    return entries


def test_audit_cache_cold_then_warm(tmp_path, small_registry):
    cache = tmp_path / "audit_cache.json"
    cold = run_audit_cached(REPO, cache_path=cache)
    assert cache.exists()
    assert cold.kernels_checked == 6 and cold.kernels_cached == 0
    assert [f.context for f in cold.findings] == ["kernel:fix.live"]
    assert [f.context for f in cold.suppressed] == ["kernel:fix.suppressed"]
    warm = run_audit_cached(REPO, cache_path=cache)
    assert warm.kernels_cached == warm.kernels_checked == 6
    assert [f.render() for f in warm.findings] == [f.render() for f in cold.findings]
    assert [f.render() for f in warm.suppressed] == [f.render() for f in cold.suppressed]
    assert set(warm.kernel_seconds) == set(cold.kernel_seconds)


def test_audit_cache_no_cache_bypasses_read_and_write(tmp_path, small_registry):
    cache = tmp_path / "audit_cache.json"
    run_audit_cached(REPO, cache_path=cache)
    before = cache.read_bytes()
    fresh = run_audit_cached(REPO, cache_path=cache, no_cache=True)
    assert fresh.kernels_cached == 0 and fresh.kernels_checked == 6
    assert cache.read_bytes() == before


def test_audit_cache_per_kernel_fingerprint_reuse(tmp_path, small_registry):
    cache = tmp_path / "audit_cache.json"
    run_audit_cached(REPO, cache_path=cache)
    doc = json.loads(cache.read_text())
    victim = sorted(doc["kernels"])[0]
    doc["kernels"][victim]["fingerprint"] = "stale"
    # Break the fully warm path so the fingerprints are consulted.
    a_file = sorted(doc["files"])[0]
    doc["files"][a_file].update(mtime_ns=1, size=1, sha256="not-the-real-hash")
    cache.write_text(json.dumps(doc))
    result = run_audit_cached(REPO, cache_path=cache)
    assert result.kernels_cached == result.kernels_checked - 1


def test_self_check_audit_arm_is_faithful(tmp_path, small_registry):
    cache = tmp_path / "audit_cache.json"
    run_audit_cached(REPO, cache_path=cache)  # warm: self_check replays it
    assert self_check(REPO, cache_path=cache) == []
    # A stale replay is caught: the stored result loses its live finding.
    doc = json.loads(cache.read_text())
    doc["result"]["findings"] = []
    cache.write_text(json.dumps(doc))
    assert any("audit cold only" in line for line in self_check(REPO, cache_path=cache))
