"""The port's gather SPF engine against the JAX package, bit for bit.

- device_graph_from_ell: the six planes equal field by field (and
  convert.device_graph_from_numpy builds the same graph from JAX's);
- sssp_distances, _first_parent, spf_one, spf_whatif_batch and
  spf_multiroot against the jitted JAX functions on JAX-CPU and against
  the scalar oracle: max_iters in {1, 2, 3, None}, lane counts 1, 8, 33
  and 64, an edgeless graph, and a graph whose next-hop words converge in
  different rounds (the port runs both words in one loop, JAX one loop a
  word);
- the plain G-kernels (kernels/ell.py) against numpy walks of their
  formulas, and the mask bit packing.

Tolerance: exact equality everywhere (the computation is integer-only).
"""

import jax
import numpy as np
import pytest
import torch

from holo_tpu.ops import graph as jgraph
from holo_tpu.ops import spf_engine as je
from holo_tpu.spf import synth as jsynth
from holo_tpu.spf.scalar import spf_reference
from holo_tpu_torch import convert
from holo_tpu_torch.kernels import ell
from holo_tpu_torch.ops import graph as tgraph
from holo_tpu_torch.ops import spf_engine as te
from holo_tpu_torch.spf import synth as tsynth

INF = 1 << 30
KW = dict(n_routers=200, n_networks=40, extra_p2p=300, seed=3)


def _graphs(jt, tt, n_atoms=64):
    jg = je.device_graph_from_ell(jgraph.build_ell(jt, n_atoms=n_atoms))
    tg = te.device_graph_from_ell(tgraph.build_ell(tt, n_atoms=n_atoms), device="cpu")
    return jg, tg


def _pair(**kw):
    jt, tt = jsynth.random_ospf_topology(**kw), tsynth.random_ospf_topology(**kw)
    return jt, tt, *_graphs(jt, tt)


def _same(jax_out, port_out, fields=("dist", "parent", "hops", "nexthops"), label=""):
    for f in fields:
        a, b = np.asarray(getattr(jax_out, f)), getattr(port_out, f).numpy()
        if f == "nexthops":
            b = b.view(np.uint32)
        assert a.dtype == b.dtype, (label, f)
        np.testing.assert_array_equal(a, b, err_msg=f"{label} {f}")


def _wide_star(mod, graph_mod):
    """Root 0 with 40 router neighbours (40 atoms: W = 2), a chain behind
    each -- short behind atoms 0-31, long behind 32-39 -- and one sink that
    all 40 chains reach at equal cost, so the sink's word 0 settles rounds
    before its word 1."""
    src, dst, cost = [], [], []

    def link(a, b, c):
        src.extend((a, b))
        dst.extend((b, a))
        cost.extend((c, c))

    nxt = 41
    sink = 1000
    for i in range(1, 41):
        link(0, i, 1)
        length = 1 + i % 2 if i <= 32 else 5 + i % 3
        prev = i
        for _ in range(length):
            link(prev, nxt, 1)
            prev, nxt = nxt, nxt + 1
        link(prev, sink, 20 - length)
    n = sink + 1
    topo = graph_mod.Topology(n_vertices=n, is_router=np.ones(n, bool), edge_src=src,
                              edge_dst=dst, edge_cost=cost, root=0)
    mod.assign_direct_atoms(topo)
    return topo


def test_device_graph_from_ell_matches_jax():
    _, _, jg, tg = _pair(**KW)
    for f in je.DeviceGraph._fields:
        a, b = np.asarray(getattr(jg, f)), getattr(tg, f).numpy()
        if a.dtype == np.uint32:
            b = b.view(np.uint32)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    c = convert.device_graph_from_numpy({f: np.asarray(x) for f, x in jg._asdict().items()},
                                        device="cpu")
    for f in te.DeviceGraph._fields:
        assert torch.equal(getattr(c, f), getattr(tg, f)), f


@pytest.mark.parametrize("max_iters", [1, 2, 3, None])
def test_sssp_distances_matches_jax(max_iters):
    jt, tt, jg, tg = _pair(**KW)
    mask = jsynth.whatif_link_failure_masks(jt, 3, seed=2)[2]
    want = jax.jit(lambda g, m: je.sssp_distances(g, jt.root, m, max_iters))(jg, mask)
    got = te.sssp_distances(tg, tt.root, mask, max_iters)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("masked", [False, True])
def test_first_parent_matches_jax(masked):
    jt, tt, jg, tg = _pair(n_routers=150, n_networks=30, extra_p2p=250, max_cost=3, seed=5)
    mask = jsynth.whatif_link_failure_masks(jt, 2, seed=1)[1] if masked else None

    def jax_parent(g, m):
        dist = je.sssp_distances(g, jt.root, m)
        dag = je._sp_dag(g, dist, je._slot_mask(g, m), jt.root)
        return dist, je._first_parent(g, dag, dist[g.in_src])

    dist, want = jax.jit(jax_parent)(jg, mask)
    got = te.first_parent(tg, torch.from_numpy(np.array(dist)), tt.root, mask)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("max_iters", [1, 2, 3, None])
def test_spf_one_matches_jax(max_iters):
    jt, tt, jg, tg = _pair(**KW)
    want = jax.jit(lambda g: je.spf_one(g, jt.root, None, max_iters))(jg)
    _same(want, te.spf_one(tg, tt.root, max_iters=max_iters), label=f"max_iters={max_iters}")


def test_spf_one_matches_scalar():
    jt, tt, _, tg = _pair(**KW)
    for mask in (None, jsynth.whatif_link_failure_masks(jt, 2, seed=6)[1]):
        ref = spf_reference(jt, mask)
        got = te.spf_one(tg, tt.root, mask)
        np.testing.assert_array_equal(got.dist.numpy(), ref.dist)
        np.testing.assert_array_equal(got.parent.numpy(), ref.parent)
        np.testing.assert_array_equal(got.hops.numpy(), ref.hops)
        np.testing.assert_array_equal(got.nexthops.numpy().view(np.uint32),
                                      ref.nexthop_words(64))


@pytest.mark.parametrize("lanes", [1, 8, 33, 64])
def test_spf_whatif_batch_matches_jax_and_scalar(lanes):
    jt, tt, jg, tg = _pair(**KW)
    masks = jsynth.whatif_link_failure_masks(jt, lanes, seed=lanes)
    want = jax.jit(lambda g, m: je.spf_whatif_batch(g, jt.root, m))(jg, masks)
    got = te.spf_whatif_batch(tg, tt.root, masks)
    _same(want, got, label=f"lanes={lanes}")
    for b in (0, lanes - 1):
        ref = spf_reference(jt, masks[b])
        np.testing.assert_array_equal(got.dist[b].numpy(), ref.dist)
        np.testing.assert_array_equal(got.parent[b].numpy(), ref.parent)
        np.testing.assert_array_equal(got.hops[b].numpy(), ref.hops)
        np.testing.assert_array_equal(got.nexthops[b].numpy().view(np.uint32),
                                      ref.nexthop_words(64))


@pytest.mark.parametrize("max_iters", [1, 2, 3])
def test_spf_whatif_batch_truncated_matches_jax(max_iters):
    jt, tt, jg, tg = _pair(**KW)
    masks = jsynth.whatif_link_failure_masks(jt, 33, seed=4)
    want = jax.jit(lambda g, m: je.spf_whatif_batch(g, jt.root, m, max_iters))(jg, masks)
    _same(want, te.spf_whatif_batch(tg, tt.root, masks, max_iters), label=str(max_iters))


@pytest.mark.parametrize("max_iters", [2, 3, 5, 7, None])
def test_both_words_in_one_loop_match_one_loop_a_word(max_iters):
    jt, tt = _wide_star(jsynth, jgraph), _wide_star(tsynth, tgraph)
    jg, tg = _graphs(jt, tt)
    assert tg.direct_nh_words.shape[2] == 2
    want = jax.jit(lambda g: je.spf_one(g, jt.root, None, max_iters))(jg)
    got = te.spf_one(tg, tt.root, max_iters=max_iters)
    _same(want, got, label=str(max_iters))
    if max_iters is None:
        words = got.nexthops[-1].numpy().view(np.uint32)
        assert words[0] == 0xFFFFFFFF and words[1] == 0xFF  # the sink sees all 40


@pytest.mark.parametrize("lanes", [1, 8, 33, 64])
def test_spf_multiroot_matches_jax_and_scalar(lanes):
    jt, tt, jg, tg = _pair(**KW)
    roots = np.random.default_rng(lanes).integers(0, jt.n_vertices, lanes).astype(np.int32)
    want = jax.jit(lambda g, r: je.spf_multiroot(g, r))(jg, roots)
    got = te.spf_multiroot(tg, roots)
    assert got.nexthops is None
    _same(want, got, fields=("dist", "parent", "hops"), label=f"lanes={lanes}")
    t = tsynth.random_ospf_topology(**KW)
    t.root = int(roots[-1])
    ref = spf_reference(t)
    np.testing.assert_array_equal(got.dist[-1].numpy(), ref.dist)
    np.testing.assert_array_equal(got.parent[-1].numpy(), ref.parent)
    np.testing.assert_array_equal(got.hops[-1].numpy(), ref.hops)


@pytest.mark.parametrize("max_iters", [1, 2])
def test_spf_multiroot_masked_truncated_matches_jax(max_iters):
    jt, tt, jg, tg = _pair(**KW)
    roots = np.array([0, 7, 100, 199], np.int32)
    mask = jsynth.whatif_link_failure_masks(jt, 2, seed=9)[1]
    want = jax.jit(lambda g, r, m: je.spf_multiroot(g, r, m, max_iters))(jg, roots, mask)
    _same(want, te.spf_multiroot(tg, roots, mask, max_iters), fields=("dist", "parent", "hops"))


def test_edgeless_graph_matches_jax():
    kw = dict(n_vertices=5, is_router=np.ones(5, bool), edge_src=np.zeros(0, np.int32),
              edge_dst=np.zeros(0, np.int32), edge_cost=np.zeros(0, np.int32), root=2)
    jt, tt = jgraph.Topology(**kw), tgraph.Topology(**kw)
    jg, tg = _graphs(jt, tt)
    masks = np.ones((3, 0), bool)
    _same(jax.jit(lambda g: je.spf_whatif_batch(g, 2, masks))(jg),
          te.spf_whatif_batch(tg, 2, masks))
    got = te.spf_one(tg, 2)
    assert got.dist.tolist() == [INF, INF, 0, INF, INF]
    assert got.parent.tolist() == [5] * 5 and got.hops.tolist() == [6, 6, 0, 6, 6]
    assert te.pack_edge_masks(masks, "cpu") is None


@pytest.mark.parametrize("engine", ["tropical", "mp", "bogus"])
def test_other_one_engines_raise(engine):
    # fused, packed and hybrid run since ROADMAP A6 (tests/test_torch_engines.py);
    # tropical takes tiles and repair rows (ops/tropical.py), not a lane program.
    _, tt, _, tg = _pair(n_routers=20, seed=1)
    with pytest.raises(ValueError,
                       match="ops/tropical.py" if engine == "tropical" else "lane programs"):
        te.spf_whatif_batch(tg, tt.root, np.ones((2, tt.n_edges), bool), engine=engine)


# ---------------------------------------------------------------------------
# The plain G-kernels against numpy walks of their formulas.


def _walk_inputs(lanes, seed=11):
    jt, tt, _, tg = _pair(n_routers=60, n_networks=10, extra_p2p=80, max_cost=3, seed=seed)
    masks = jsynth.whatif_link_failure_masks(jt, lanes, seed=seed)
    p = te.lane_planes(tg, te.pack_edge_masks(masks, "cpu"))
    roots = torch.full((lanes,), tt.root, dtype=torch.int32)
    roots[-1] = 3  # one lane rooted elsewhere
    dist = te.distance_fixpoint(p, roots, tt.n_vertices)
    src, cost = tg.in_src.numpy(), tg.in_cost.numpy()
    valid, eid = tg.in_valid.numpy(), tg.in_edge_id.numpy()
    return tg, p, masks, roots, dist, src, cost, valid, eid


def _np_dag(v, k, b, src, cost, valid, eid, masks, dist, roots):
    u = src[v, k]
    return (valid[v, k] and masks[b, eid[v, k]] and dist[u, b] < INF and dist[v, b] < INF
            and dist[u, b] + cost[v, k] == dist[v, b] and v != roots[b])


@pytest.mark.parametrize("lanes", [1, 40])
def test_relax_plain_matches_numpy_walk(lanes):
    tg, p, masks, roots, _, src, cost, valid, eid = _walk_inputs(lanes)
    dist = te.distance_fixpoint(p, roots, 2).numpy()  # mid-fixpoint
    out, changed, front = ell.relax_plain(*p, torch.from_numpy(dist))
    want = dist.copy()
    n, k = src.shape
    for v in range(n):
        for b in range(lanes):
            for j in range(k):
                u = src[v, j]
                if valid[v, j] and masks[b, eid[v, j]] and dist[u, b] < INF:
                    want[v, b] = min(want[v, b], dist[u, b] + cost[v, j])
    np.testing.assert_array_equal(out.numpy(), want)
    assert int(changed) == int((want != dist).any())
    moved = np.zeros((n, 32 * front.shape[1]), bool)
    moved[:, :lanes] = want != dist
    np.testing.assert_array_equal(np.packbits(moved, axis=1, bitorder="little").view(np.int32),
                                  front.numpy())


@pytest.mark.parametrize("lanes", [1, 40])
def test_first_parent_plain_matches_numpy_walk(lanes):
    tg, p, masks, roots, dist, src, cost, valid, eid = _walk_inputs(lanes)
    got, dag = ell.first_parent_plain(*p, dist, roots)
    d, r = dist.numpy(), roots.numpy()
    n, k = src.shape
    want_bits = np.zeros(dag.shape, np.int64)
    for v in range(n):
        for b in range(lanes):
            best = (INF, n)
            for j in range(k):
                if _np_dag(v, j, b, src, cost, valid, eid, masks, d, r):
                    best = min(best, (d[src[v, j], b], src[v, j]))
                    want_bits[v, j, b // 32] |= 1 << (b % 32)
            assert got[v, b] == best[1], (v, b)
    np.testing.assert_array_equal(dag.numpy().view(np.uint32), want_bits.astype(np.uint32))


@pytest.mark.parametrize("lanes", [1, 40])
def test_nh_seed_and_round_plain_match_numpy_walk(lanes):
    tg, p, masks, roots, dist, src, cost, valid, eid = _walk_inputs(lanes)
    parent, dag = ell.first_parent_plain(*p, dist, roots)
    hops = te.hops_fixpoint(tg, parent, roots, tg.in_src.shape[0])
    direct = tg.direct_nh_words
    seed, inherit = ell.nh_seed_plain(p.src, dag, ell.pack_lane_bits(hops == 0), direct, lanes)
    nh1, changed, front = ell.nh_round_plain(p.src, inherit, seed)
    d, h, r, dw = dist.numpy(), hops.numpy(), roots.numpy(), direct.numpy()
    n, k = src.shape
    words = dw.shape[2]
    want_seed = np.zeros((n, words, lanes), np.int32)
    want_bits = np.zeros(inherit.shape, np.int64)
    for v in range(n):
        for b in range(lanes):
            for j in range(k):
                if not _np_dag(v, j, b, src, cost, valid, eid, masks, d, r):
                    continue
                if h[src[v, j], b] == 0:
                    want_seed[v, :, b] |= dw[v, j]
                else:
                    want_bits[v, j, b // 32] |= 1 << (b % 32)
    np.testing.assert_array_equal(seed.numpy(), want_seed)
    np.testing.assert_array_equal(inherit.numpy().view(np.uint32), want_bits.astype(np.uint32))
    want_nh = want_seed.copy()
    for v in range(n):
        for j in range(k):
            for b in range(lanes):
                if (want_bits[v, j, b // 32] >> (b % 32)) & 1:
                    want_nh[v, :, b] |= want_seed[src[v, j], :, b]
    np.testing.assert_array_equal(nh1.numpy(), want_nh)
    assert int(changed) == int((want_nh != want_seed).any())
    moved = (want_nh != want_seed).any(1)
    for b in range(lanes):
        assert ((front.numpy()[:, b // 32].view(np.uint32) >> (b % 32)) & 1 == 1).tolist() == \
            moved[:, b].tolist(), b


@pytest.mark.parametrize("lanes", [1, 31, 32, 33, 100])
def test_mask_bits_round_trip(lanes):
    masks = np.random.default_rng(lanes).random((lanes, 77)) < 0.7
    words = te.pack_edge_masks(masks, "cpu")
    assert words.shape == (77, (lanes + 31) // 32) and words.dtype == torch.int32
    bits = (words.numpy().view(np.uint32)[:, np.arange(lanes) // 32]
            >> (np.arange(lanes) % 32)) & 1
    np.testing.assert_array_equal(bits.T.astype(bool), masks)
    lane_words = ell.pack_lane_bits(torch.from_numpy(masks.T.copy()))
    assert torch.equal(lane_words, words)


def test_pack_lane_bits_of_no_lanes():
    words = ell.pack_lane_bits(torch.zeros((5, 0), dtype=torch.bool))
    assert words.shape == (5, 0) and words.dtype == torch.int32
    assert te.pack_edge_masks(np.zeros((0, 7), bool), "cpu").shape == (7, 0)


def test_plain_versions_chunk_the_lanes(monkeypatch):
    # A chunk of 32 lanes: 64 lanes take two chunks, with equal results.
    tg, p, masks, roots, dist, *_ = _walk_inputs(64)
    parent, _ = ell.first_parent_plain(*p, dist, roots)
    hops = te.hops_fixpoint(tg, parent, roots, tg.in_src.shape[0])
    hop0 = ell.pack_lane_bits(hops == 0)

    def run():
        parent, dag = ell.first_parent_plain(*p, dist, roots)
        seed, inherit = ell.nh_seed_plain(p.src, dag, hop0, tg.direct_nh_words, 64)
        return (*ell.relax_plain(*p, dist), parent, dag, seed, inherit,
                *ell.nh_round_plain(p.src, inherit, seed))

    full = run()
    monkeypatch.setattr(ell, "_TEMP", 1)
    for a, b in zip(full, run()):
        assert torch.equal(a, b)
