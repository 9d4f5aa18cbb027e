"""The port's dispatch mesh (``holo_tpu_torch.parallel.mesh``) against
holo_tpu's, bit for bit (tolerance: exact equality everywhere; the
computation is integer-only).

Every case installs the port's mesh over ``virtual_devices(8, "cpu")`` (one
entry for the (1, 1) shape) and ``holo_tpu``'s ``configure_process_mesh`` of
the same shape over the conftest's 8 virtual CPU devices, and holds the
port's ``TorchSpfBackend`` / ``FrrEngine`` to ``TpuSpfBackend`` /
``FrrEngine("tpu")`` and to the scalar oracle, under the shapes (8, 1),
(4, 2), (2, 4) and (1, 1): the what-if on each engine, multipath what-if and
``compute`` at ``multipath_k`` 2 and 4, multi-root (seq, tropical),
``compute``, a masked ``compute`` (also split, ``launch_one`` /
``finish_one``), FRR and partitioned ``compute`` -- on
a 24-router, 31-vertex LSDB, whose rows a node axis of 2 or 4 pads to 32, so
the no-parent and unreachable sentinels come back renormalized to N.  Each
dispatch moves ``shard_dispatches`` by one.  Then the twins of
``tests/test_shard_spf.py``: 13 vertices at node 4, an odd scenario batch,
a DeltaPath chain on a padded resident (seq and tropical), cache-key
separation between meshes; ``make_spf_mesh``'s errors; the shard chaos
seams; a size-1 mesh's kernel calls equal to the plain path's; the dry run.
"""

from contextlib import contextmanager

import jax
import numpy as np
import pytest
import torch

from holo_tpu.frr.manager import FrrEngine as JFrrEngine
from holo_tpu.ops import graph as jgraph
from holo_tpu.parallel import mesh as jmesh
from holo_tpu.spf import synth as jsynth
from holo_tpu.spf.backend import TpuSpfBackend
from holo_tpu_torch.frr.kernel import TABLE_PLANES
from holo_tpu_torch.frr.manager import FrrEngine
from holo_tpu_torch.graft_entry import dryrun_multichip
from holo_tpu_torch.kernels import ell
from holo_tpu_torch.kernels import tropical as kt
from holo_tpu_torch.ops import graph as tgraph
from holo_tpu_torch.ops.spf_engine import shared_graph_cache
from holo_tpu_torch.parallel import mesh as pm
from holo_tpu_torch.resilience.breaker import CircuitBreaker
from holo_tpu_torch.resilience.faults import FaultInjector, FaultPlan, InjectedFault, inject
from holo_tpu_torch.spf import synth as tsynth
from holo_tpu_torch.spf.backend import ScalarSpfBackend, TorchSpfBackend

SHAPES = [(8, 1), (4, 2), (2, 4), (1, 1)]
ENGINES = ("seq", "fused", "packed", "hybrid", "tropical")
FIELDS = ("dist", "parent", "hops", "nexthop_words")
MP_FIELDS = ("parents", "pdist", "pweight", "npaths", "nh_weights")
MR_FIELDS = ("dist", "parent", "hops")
KW = dict(n_routers=24, n_networks=7, extra_p2p=40)  # 31 vertices
ROOTS = np.array([0, 3, 7, 11, 30], np.int32)  # 30 is a network vertex


@pytest.fixture(autouse=True)
def _no_leaked_mesh():
    yield
    leaked = pm.process_mesh() is not None or jmesh.process_mesh() is not None
    pm.reset_process_mesh()
    jmesh.reset_process_mesh()
    assert not leaked, "a test leaked the process mesh"


@contextmanager
def meshes(shape):
    """The port's mesh over virtual CPU devices and holo_tpu's over the
    conftest's, both of ``shape``; both reset whatever happens."""
    n = shape[0] * shape[1]
    mesh = pm.configure_process_mesh(*shape, devices=pm.virtual_devices(n, "cpu"))
    try:
        jmesh.configure_process_mesh(*shape, devices=jax.devices()[:n])
        yield mesh
    finally:
        pm.reset_process_mesh()
        jmesh.reset_process_mesh()


def _pair(seed=3, **kw):
    kw = {**KW, **kw}
    return (tsynth.random_ospf_topology(seed=seed, **kw),
            jsynth.random_ospf_topology(seed=seed, **kw))


def _masks(tt, n, seed=4):
    masks = tsynth.whatif_link_failure_masks(tt, n, seed=seed)
    # Scenario 0 cuts a stub network off: its vertex is unreachable there.
    stub = [e for e in range(tt.n_edges) if tt.edge_dst[e] == tt.n_vertices - 1]
    masks[0, stub] = False
    return masks


def same(a, b, tag, fields=FIELDS):
    for f in fields:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype and x.shape == y.shape, (tag, f, x.shape, y.shape)
        np.testing.assert_array_equal(x, y, err_msg=f"{tag} {f}")


def same_all(got, jax_out, oracle, tag, fields=FIELDS):
    for i, (g, j, o) in enumerate(zip(got, jax_out, oracle, strict=True)):
        same(g, j, f"{tag} [{i}] jax", fields)
        same(g, o, f"{tag} [{i}] oracle", fields)


@pytest.fixture(scope="module")
def case():
    """The topology pair, the masks, and the oracle's results (the mesh does
    not change them)."""
    tt, jt = _pair()
    masks = _masks(tt, 8)
    sc = ScalarSpfBackend()
    return {
        "tt": tt, "jt": jt, "masks": masks,
        "whatif": sc.compute_whatif(tt, masks),
        "mp": {k: sc.compute_whatif(tt, masks, multipath_k=k) for k in (2, 4)},
        "mp_one": {k: sc.compute(tt, multipath_k=k) for k in (2, 4)},
        "multiroot": sc.compute_multiroot(tt, ROOTS),
        "one": sc.compute(tt), "masked": sc.compute(tt, masks[1]),
        "frr": FrrEngine("scalar").compute(tt),
    }


def test_the_case_exercises_padding_and_sentinels(case):
    tt, masks = case["tt"], case["masks"]
    n = tt.n_vertices
    assert n % 2 and pm.padded_rows(n, pm.make_spf_mesh(4, 2, pm.virtual_devices(8, "cpu"))) == 32
    assert (case["whatif"][0].parent == n).sum() >= 2  # the root and the cut vertex
    assert (case["whatif"][0].hops == n + 1).any()
    assert not masks.all(axis=1).any()


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("shape", SHAPES)
def test_whatif_matches_jax_mesh_and_oracle(case, shape, engine):
    with meshes(shape):
        be = TorchSpfBackend(device="cpu", one_engine=engine)
        got = be.compute_whatif(case["tt"], case["masks"])
        want = TpuSpfBackend(one_engine=engine).compute_whatif(case["jt"], case["masks"])
    same_all(got, want, case["whatif"], f"{shape} {engine}")
    assert be.shard_dispatches == {"whatif": 1}
    assert be.stats() == {"mesh": {"batch": 0, "node": 0}, "shard-dispatches": {"whatif": 1}}


@pytest.mark.parametrize("kp", [2, 4])
@pytest.mark.parametrize("shape", SHAPES)
def test_multipath_whatif_and_compute_match(case, shape, kp):
    tt, jt, masks = case["tt"], case["jt"], case["masks"]
    fields = FIELDS + MP_FIELDS
    with meshes(shape):
        be = TorchSpfBackend(device="cpu")
        got = be.compute_whatif(tt, masks, multipath_k=kp)
        assert be.shard_dispatches == {"whatif": 1}
        one = be.compute(tt, multipath_k=kp)
        assert be.shard_dispatches == {"whatif": 1, "one": 1}
        jbe = TpuSpfBackend()
        want = jbe.compute_whatif(jt, masks, multipath_k=kp)
        jone = jbe.compute(jt, multipath_k=kp)
    same_all(got, want, case["mp"][kp], f"{shape} kp={kp}", fields)
    same_all([one], [jone], [case["mp_one"][kp]], f"{shape} compute kp={kp}", fields)


@pytest.mark.parametrize("engine", ["seq", "tropical"])
@pytest.mark.parametrize("shape", SHAPES)
def test_multiroot_matches(case, shape, engine):
    with meshes(shape):
        be = TorchSpfBackend(device="cpu", one_engine=engine)
        got = be.compute_multiroot(case["tt"], ROOTS)
        want = TpuSpfBackend(one_engine=engine).compute_multiroot(case["jt"], ROOTS)
    same_all([got], [want], [case["multiroot"]], f"{shape} {engine}", MR_FIELDS)
    assert got.dist.shape == (len(ROOTS), case["tt"].n_vertices)
    assert be.shard_dispatches == {"multiroot": 1}


@pytest.mark.parametrize("shape", SHAPES)
def test_compute_and_masked_compute_match(case, shape):
    tt, jt, masks = case["tt"], case["jt"], case["masks"]
    with meshes(shape):
        be = TorchSpfBackend(device="cpu")
        got = [be.compute(tt), be.compute(tt, masks[1])]
        split = be.finish_one(be.launch_one(tt, masks[1]))  # the pipeline's seam
        jbe = TpuSpfBackend()
        want = [jbe.compute(jt), jbe.compute(jt, masks[1])]
    same_all(got, want, [case["one"], case["masked"]], f"{shape} compute")
    same(split, case["masked"], f"{shape} launch_one / finish_one")
    assert be.shard_dispatches == {"one": 3}


@pytest.mark.parametrize("shape", SHAPES)
def test_frr_matches(case, shape):
    with meshes(shape):
        eng = FrrEngine("torch", device="cpu")
        got = eng.compute(case["tt"])
        want = JFrrEngine("tpu").compute(case["jt"])
    for f in TABLE_PLANES:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f"{shape} {f}")
        np.testing.assert_array_equal(getattr(got, f), getattr(case["frr"], f),
                                      err_msg=f"{shape} {f} oracle")
    assert eng.shard_dispatches == {"frr": 1} and eng.dispatches == {"device": 1}


def test_frr_computes_d_once_a_physical_device(case, monkeypatch):
    """Four batch shards on one device read one all-roots matrix."""
    from holo_tpu_torch.frr import manager

    calls = []
    real = manager.all_roots
    monkeypatch.setattr(manager, "all_roots", lambda g, m=None: calls.append(1) or real(g, m))
    with meshes((4, 2)):
        got = FrrEngine("torch", device="cpu").compute(case["tt"])
    assert len(calls) == 1
    np.testing.assert_array_equal(got.lfa_adj, case["frr"].lfa_adj)


@pytest.mark.parametrize("shape", SHAPES)
def test_partitioned_compute_matches(case, shape):
    tt, jt = case["tt"], case["jt"]
    kw = dict(partition_threshold=1, partition_max_part=12)
    with meshes(shape) as mesh:
        be = TorchSpfBackend(device="cpu", **kw)
        got = [be.compute(tt), be.compute_partitioned(tt, case["masks"][1])]
        want = TpuSpfBackend(**kw).compute(jt)
        (key,) = shared_graph_cache("cpu").partitioned_entries(be._part_ns)
        assert key[-1] == pm.mesh_cache_key(mesh)
        assert be.partition_residents()[0].plan.n_parts > 1
    same_all(got[:1], [want], [case["one"]], f"{shape} partitioned")
    same(got[1], case["masked"], f"{shape} partitioned masked oracle")
    assert be.shard_dispatches == {"partitioned": 2}


def test_row_padding_and_sentinel_renorm():
    """Node 4 over a 13-vertex LSDB pads rows to 16: every plane comes back
    at N, the sentinels at N and N + 1."""
    tt, jt = tsynth.random_ospf_topology(n_routers=11, n_networks=2, seed=9), \
        jsynth.random_ospf_topology(n_routers=11, n_networks=2, seed=9)
    n = tt.n_vertices
    assert n % 4
    masks = _masks(tt, 4, seed=0)
    sc = ScalarSpfBackend()
    with meshes((2, 4)):
        be = TorchSpfBackend(device="cpu")
        got = [be.compute(tt)] + be.compute_whatif(tt, masks)
        g = be.prepare(tt)
        jbe = TpuSpfBackend()
        want = [jbe.compute(jt)] + jbe.compute_whatif(jt, masks)
    assert g.in_src.shape[0] == 16
    assert not g.in_valid[n:].any() and not g.is_router[n:].any()
    assert not g.direct_nh_words[n:].any()
    same_all(got, want, [sc.compute(tt)] + sc.compute_whatif(tt, masks), "padded")
    assert got[1].parent.max() == n and got[1].hops.max() == n + 1
    assert got[0].dist.shape == (n,) and got[0].nexthop_words.shape[0] == n


def test_odd_scenario_batch_pads_and_slices(case):
    tt, jt = case["tt"], case["jt"]
    masks = _masks(tt, 5, seed=1)
    with meshes((8, 1)):
        got = TorchSpfBackend(device="cpu").compute_whatif(tt, masks)
        want = TpuSpfBackend().compute_whatif(jt, masks)
    assert len(got) == 5
    same_all(got, want, ScalarSpfBackend().compute_whatif(tt, masks), "odd batch")


def test_shard_helpers_pad_as_holo_tpu():
    mesh = pm.make_spf_mesh(4, 2, pm.virtual_devices(8, "cpu"))
    masks = np.zeros((5, 3), bool)
    shards = pm.shard_scenarios(mesh, masks)
    assert [s.shape for s in shards] == [(2, 3)] * 4
    assert np.concatenate(shards)[5:].all() and not np.concatenate(shards)[:5].any()
    assert np.concatenate(pm.shard_roots(mesh, [4, 5, 6])).tolist() == [4, 5, 6, 0]
    rows = np.concatenate(pm.shard_repair_rows(mesh, np.ones((3, 2), np.int32), 9))
    assert rows.tolist() == [[1, 1]] * 3 + [[9, 9]]
    one = pm.make_spf_mesh(1, 1, pm.virtual_devices(1, "cpu"))
    assert len(pm.shard_scenarios(one, masks)) == 1 and pm.shard_scenarios(one, masks)[0] is not None
    assert pm.gather_batch(one, ["x"], 1) == "x"


@pytest.mark.parametrize("engine", ["seq", "tropical"])
def test_delta_chain_on_padded_resident_stays_incremental(engine):
    """A weight-delta chain on a node-padded resident: the in-place apply and
    the seeded incremental SPF serve every step, equal to JAX's chain under
    the same mesh and to the oracle."""
    tt, jt = _pair(seed=13)
    rng = np.random.default_rng(13)
    sc = ScalarSpfBackend()
    with meshes((4, 2)) as mesh:
        be = TorchSpfBackend(device="cpu", one_engine=engine)
        jbe = TpuSpfBackend(one_engine=engine)
        same(be.compute(tt), jbe.compute(jt), "base")
        for step in range(4):
            spec = {"cost": {int(rng.integers(0, tt.n_edges)): int(rng.integers(1, 64))}}
            tn, jn = tsynth.clone_topology(tt, **spec), jsynth.clone_topology(jt, **spec)
            tn.link_delta(tgraph.diff_topologies(tt, tn))
            jn.link_delta(jgraph.diff_topologies(jt, jn))
            got = be.compute(tn)
            same_all([got], [jbe.compute(jn)], [sc.compute(tn)], f"{engine} step {step}")
            tt, jt = tn, jn
        g = be.prepare(tt)
        assert g.in_src.shape[0] == pm.padded_rows(tt.n_vertices, mesh) == 32
    assert be.delta_paths[("weight", "incremental")] == 4
    assert be.delta_paths[("weight", "apply")] == 4
    assert be.shard_dispatches == {"one": 5}


def test_cache_keys_separate_meshes(case):
    """A resident laid out for one mesh serves that mesh alone: another mesh
    and the plain path marshal their own; the same mesh installed again
    hits its warm entry."""
    tt = tsynth.clone_topology(case["tt"])  # a uid of its own
    be = TorchSpfBackend(device="cpu")
    rows = {}
    for shape in [(4, 2), (2, 4), None, (4, 2)]:
        if shape is None:
            rows[shape] = be.prepare(tt).in_src.shape[0]
            continue
        with meshes(shape) as mesh:
            rows[shape] = be.prepare(tt).in_src.shape[0]
            assert be._gather_cache.key(tt, 64, mesh)[-1] == pm.mesh_cache_key(mesh)
    assert rows == {(4, 2): 32, (2, 4): 32, None: 31}
    assert be._gather_cache.lookups == {"miss": 3, "hit": 1}
    assert pm.mesh_cache_key(pm.make_spf_mesh(2, 1, pm.virtual_devices(2, "cpu"))) == (
        2, 1, "cpu", "cpu")


def test_make_spf_mesh_rules_and_errors(monkeypatch):
    devs = pm.virtual_devices(8, "cpu")
    assert pm.make_spf_mesh(devices=devs).shape == {"batch": 8, "node": 1}
    assert pm.make_spf_mesh(None, 4, devs).shape == {"batch": 2, "node": 4}
    assert pm.make_spf_mesh(2, None, devs).shape == {"batch": 2, "node": 4}
    for bad in [(3, 3), (3, None), (16, 1)]:
        with pytest.raises(ValueError) as port:
            pm.make_spf_mesh(*bad, devs)
        with pytest.raises(ValueError) as ref:
            jmesh.make_spf_mesh(*bad, jax.devices()[:8])
        assert str(port.value) == str(ref.value)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pm.make_spf_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pm.configure_process_mesh(2, 1)
    assert pm.process_mesh() is None and pm.mesh_stats() == {"batch": 0, "node": 0}


@pytest.mark.parametrize("site,call", [
    ("spf.shard", lambda be, eng, tt, m: be.compute_whatif(tt, m)),
    ("spf.shard", lambda be, eng, tt, m: be.compute(tt)),
    ("frr.shard", lambda be, eng, tt, m: eng.compute(tt)),
])
def test_shard_seam_is_counted_and_reraises_without_fallback(case, site, call):
    """An injected shard failure is a counted device failure: with no oracle
    fallback (a ``max_iters`` cap) it re-raises, as on the card."""
    br = CircuitBreaker(f"mesh-{site}", failure_threshold=10)
    be = TorchSpfBackend(device="cpu", max_iters=3, breaker=br)
    eng = FrrEngine("torch", device="cpu", max_iters=3, breaker=br)
    with meshes((4, 2)), inject(FaultInjector(FaultPlan(seed=1, dispatch_fail={site: 1}))) as inj:
        with pytest.raises(InjectedFault):
            call(be, eng, case["tt"], case["masks"])
    assert inj.injected[site] == 1 and br.snapshot()["failures"] == {"exception": 1}


def test_shard_seam_is_quiet_without_a_mesh(case):
    br = CircuitBreaker("mesh-quiet")
    with inject(FaultInjector(FaultPlan(seed=1, dispatch_fail={"spf.shard": 1}))) as inj:
        TorchSpfBackend(device="cpu", breaker=br).compute_whatif(case["tt"], case["masks"])
    assert not inj.injected and not br.snapshot()["failures"]


def test_size_one_mesh_calls_the_plain_kernels(case, monkeypatch):
    """A (1, 1) mesh runs the plain programs: the same kernel wrappers, the
    same number of times, as with no mesh, on every path."""
    calls = {}
    for mod, names in ((ell, ("ell_relax", "ell_first_parent", "ell_nh_seed", "ell_nh_round",
                              "ell_mp_round", "ell_parent_sets", "ell_parent_weights",
                              "ell_fused_round")),
                       (kt, ("trop_relax", "trop_count_round"))):
        for name in names:
            def counted(*a, _real=getattr(mod, name), _name=name, **k):
                calls[_name] = calls.get(_name, 0) + 1
                return _real(*a, **k)

            monkeypatch.setattr(mod, name, counted)
    tt, masks = case["tt"], case["masks"]

    def drive():
        calls.clear()
        trop = TorchSpfBackend(device="cpu", one_engine="tropical")
        seq = TorchSpfBackend(device="cpu", one_engine="fused")
        out = [seq.compute_whatif(tt, masks), trop.compute_whatif(tt, masks),
               seq.compute_whatif(tt, masks, multipath_k=4), seq.compute(tt),
               seq.compute(tt, masks[1]), trop.compute(tt, multipath_k=4),
               [trop.compute_multiroot(tt, ROOTS)],
               [TorchSpfBackend(device="cpu").compute_multiroot(tt, ROOTS)],
               [FrrEngine("torch", device="cpu").compute(tt)]]
        return dict(calls), out

    plain, want = drive()
    with meshes((1, 1)):
        meshed, got = drive()
    assert plain == meshed and len(plain) == 10
    for w, g in zip(want, got):
        for a, b in zip(w if isinstance(w, list) else [w], g if isinstance(g, list) else [g]):
            for f in set(vars(a)) - {"inputs"}:
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


def test_dryrun_multichip_on_the_cpu():
    text = dryrun_multichip(4, device="cpu")
    assert pm.process_mesh() is None
    assert "virtual mesh {'batch': 2, 'node': 2}" in text and "A12b" in text
    assert "multi-chip" not in text and "shard dispatches: 1" in text


def test_sharded_tropical_program_takes_explicit_repair_rows(case):
    """Explicit repair rows (``holo_tpu``'s host set, sharded with the
    resident's row count as the sentinel) give the bits of the repair set
    built on each shard's device, on a padded resident."""
    from holo_tpu_torch.ops.tropical import repair_rows_host

    tt, masks = case["tt"], case["masks"][:5]
    be = TorchSpfBackend(device="cpu", one_engine="tropical")
    with meshes((4, 2)) as mesh:
        res = be._resident(mesh, tt, need_edge_ids=True, tiles=True)
        rows = repair_rows_host(tt.edge_dst, masks, 32)
        got = pm.sharded_tropical_whatif_program(mesh, res, tt.root, masks, rows)
        built = pm.sharded_tropical_whatif_program(mesh, res, tt.root, masks)
    assert got.dist.shape == (5, 32)
    for f in ("dist", "parent", "hops", "nexthops"):
        assert torch.equal(getattr(got, f), getattr(built, f)), f
    np.testing.assert_array_equal(got.dist[:, :tt.n_vertices].numpy(),
                                  np.stack([r.dist for r in case["whatif"][:5]]))
