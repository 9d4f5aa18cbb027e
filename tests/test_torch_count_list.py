"""The count list of the tropical multipath rounds (T2), on the CPU.

On the card ``trop_count_round`` walks only the tiles of ``count_list``:
each row block's real slots whose count tile holds a nonzero entry, built
once per fixpoint; within a listed tile it reads only the source rows of the
nonzero columns.  Zero tiles and zero columns add 0, so the skips are exact.
Tolerance: exact int32 everywhere (the computation is integer-only).

- ``count_list`` holds exactly those slots, in slot order, with their
  number; a padding slot with counts in it is left out, and a row block with
  no nonzero tile lists nothing;
- a numpy walk of the kernel's skip rules (listed tiles only, nonzero
  columns only) equals ``trop_count_plain`` on the full tiles at B 8-128,
  with parallel edges (counts 2 and 3), padding slots, the root row, a seed
  plane and sums that saturate at ``MP_SAT``, at lane counts on both sides
  of the row / lane form switch (8);
- ``np_tile_fixpoint`` and ``aw_tile_fixpoint`` (which build the list once
  and run T2 rounds) equal JAX's ``_np_tile_fixpoint`` /
  ``_aw_tile_fixpoint`` on JAX's tiles at limits N (``max_iters`` None) and
  0-3, from fresh and from stale carries.
"""

import jax
import numpy as np
import pytest
import torch

from holo_tpu.ops import graph as jgraph
from holo_tpu.ops import spf_engine as je
from holo_tpu.ops import tropical as jtrop
from holo_tpu.spf import synth as jsynth
from holo_tpu_torch.kernels import tropical as kt
from holo_tpu_torch.ops import graph as tgraph
from holo_tpu_torch.ops import spf_engine as te
from holo_tpu_torch.ops import tropical as trop
from holo_tpu_torch.spf import synth as tsynth

N_ATOMS = 64
MP_SAT = kt.MP_SAT
BLOCKS = (8, 16, 32, 64, 128)


def _parallel_topology(mod, synth, n_routers=200, seed=3):
    """A random OSPF topology with a second edge beside every third one and
    a third beside every ninth (same source and destination): counts 2 and
    3 in the DAG's tiles."""
    base = synth.random_ospf_topology(n_routers=n_routers, n_networks=n_routers // 7,
                                      extra_p2p=3 * n_routers // 2, max_cost=3, seed=seed)
    e2, e3 = np.arange(0, base.n_edges, 3), np.arange(0, base.n_edges, 9)
    extra = np.r_[e2, e3]
    topo = mod.Topology(n_vertices=base.n_vertices, is_router=base.is_router.copy(),
                        edge_src=np.r_[base.edge_src, base.edge_src[extra]],
                        edge_dst=np.r_[base.edge_dst, base.edge_dst[extra]],
                        edge_cost=np.r_[base.edge_cost, base.edge_cost[extra]],
                        root=base.root)
    synth.assign_direct_atoms(topo)
    return topo


_LAYOUTS: dict = {}


def _layout(block: int):
    """(port graph, port tiles) of the parallel topology at tile size
    ``block``."""
    if block not in _LAYOUTS:
        topo = _parallel_topology(tgraph, tsynth)
        ell = tgraph.build_ell(topo, n_atoms=N_ATOMS)
        host, _ = trop.build_tiles_host(ell.in_src, ell.in_cost, ell.in_valid, block)
        _LAYOUTS[block] = (te.device_graph_from_ell(ell, "cpu"), trop.tiles_on(host, "cpu"))
    return _LAYOUTS[block]


def _counts(block: int, seed: int):
    """Count tiles over a seeded half of the valid slots, with a padding
    slot appended to every row block whose tile holds counts (a padding
    slot's counts must never be read) and one row block emptied: (cnt, cb,
    the emptied row block)."""
    g, tt = _layout(block)
    rng = np.random.default_rng(seed)
    flag = g.in_valid & torch.from_numpy(rng.random(tuple(g.in_valid.shape)) < 0.6)
    cnt = trop.count_tiles(g.in_src, tt, flag)
    nb, tm, b, _ = cnt.shape
    assert int(cnt.max()) == 3  # parallel slots count 2 and 3
    empty = int(rng.integers(0, nb))
    cnt[empty] = 0
    junk = torch.from_numpy(rng.integers(1, 4, (nb, 1, b, b)).astype(np.int32))
    cnt = torch.cat([cnt, junk], 1).contiguous()
    cb = torch.cat([tt.cb, torch.full((nb, 1), nb, dtype=torch.int32)], 1).contiguous()
    return cnt, cb, empty


def _carry(rng, npad: int, n: int, lanes: int) -> torch.Tensor:
    """Values drawn up to MP_SAT, a quarter at MP_SAT - 1 (sums saturate),
    padding rows 0."""
    x = np.where(rng.random((npad, lanes)) < 0.25, MP_SAT - 1,
                 rng.integers(0, MP_SAT, (npad, lanes)))
    x[n:] = 0
    return torch.from_numpy(x.astype(np.int32))


@pytest.mark.parametrize("block", BLOCKS)
def test_count_list_holds_the_nonzero_real_tiles(block):
    for seed in range(2):
        cnt, cb, empty = _counts(block, seed)
        nb, tm = cb.shape
        listed = kt.count_list(cnt, cb)
        assert listed.slots.dtype == listed.n.dtype == torch.int32
        assert listed.slots.shape == (nb, tm) and listed.n.shape == (nb,)
        assert listed.slots.is_contiguous()
        c, cbn = cnt.numpy(), cb.numpy()
        for rb in range(nb):
            want = [t for t in range(tm) if cbn[rb, t] < nb and c[rb, t].any()]
            n = int(listed.n[rb])
            assert n == len(want), (rb, n, want)
            assert listed.slots[rb, :n].tolist() == want, rb
            assert sorted(listed.slots[rb].tolist()) == list(range(tm))  # a permutation
        assert int(listed.n[empty]) == 0
        assert int(listed.n.sum()) < int((cb < nb).sum())  # some real tiles hold no count


def _walk(cnt, cb, listed, x, seed, root):
    """The kernel's skip rules in numpy: per row block only the listed
    tiles, per tile only its nonzero columns' source rows; then the seed,
    the clamp and the root, as the kernel finishes."""
    c, cbn, xn = cnt.numpy(), cb.numpy(), x.numpy().astype(np.int64)
    nb, _, b, _ = c.shape
    tot = np.zeros_like(xn)
    for rb in range(nb):
        for t in listed.slots[rb, :int(listed.n[rb])].tolist():
            tile = c[rb, t].astype(np.int64)
            for j in np.nonzero(tile.any(0))[0]:
                tot[rb * b:(rb + 1) * b] += tile[:, j, None] * xn[cbn[rb, t] * b + j]
    assert tot.max() < 2 ** 31  # int32 sums are exact
    if seed is not None:
        tot += seed.numpy()
    new = np.minimum(tot, MP_SAT).astype(np.int32)
    if root >= 0:
        new[root] = 1
    return new, bool((new != x.numpy()).any())


@pytest.mark.parametrize("lanes", [1, 8, 9, 64])
@pytest.mark.parametrize("block", BLOCKS)
def test_skip_rules_walk_equals_the_plain_round(block, lanes):
    g, tt = _layout(block)
    n = g.in_src.shape[0]
    cnt, cb, empty = _counts(block, lanes)
    listed = kt.count_list(cnt, cb)
    npad = cb.shape[0] * block
    rng = np.random.default_rng(block * 100 + lanes)
    x = _carry(rng, npad, n, lanes)
    root = int(tt.inv[int(rng.integers(0, n))])
    seeds = 0
    for seed_plane, root_row in ((None, root), (_carry(rng, npad, n, lanes), -1), (None, -1)):
        want, changed = kt.trop_count_plain(cnt, cb, listed, x, seed_plane,
                                            torch.full_like(x, -7), root_row)
        got, moved = _walk(cnt, cb, listed, x, seed_plane, root_row)
        np.testing.assert_array_equal(got, want.numpy())
        assert moved == bool(changed)
        assert int(want.max()) == MP_SAT  # sums saturate
        if root_row >= 0:
            assert (want[root_row] == 1).all()
        rows = slice(empty * block, (empty + 1) * block)  # no listed tile: the seed alone
        base = 0 if seed_plane is None else seed_plane[rows].clamp_max(MP_SAT)
        if not (root_row >= 0 and rows.start <= root_row < rows.stop):
            assert torch.equal(want[rows], torch.zeros_like(want[rows]) + base)
        seeds += seed_plane is not None
    assert seeds == 1


# ---------------------------------------------------------------------------
# The fixpoints against JAX's, on JAX's tiles


class _Case:
    """One topology in both packages (tiles from JAX's builder), JAX's
    settled DAG and raw phase-2 hops of the unmasked root run."""

    def __init__(self, shape: str):
        tt, jt = {
            "tied": lambda: tuple(m.random_ospf_topology(n_routers=30, n_networks=6,
                                                         extra_p2p=40, max_cost=3, seed=1)
                                  for m in (tsynth, jsynth)),
            "parallel": lambda: (_parallel_topology(tgraph, tsynth, 40, 5),
                                 _parallel_topology(jgraph, jsynth, 40, 5)),
        }[shape]()
        self.n, self.root = tt.n_vertices, tt.root
        jell = jgraph.build_ell(jt, n_atoms=N_ATOMS)
        self.jg = je.device_graph_from_ell(jell)
        self.tg = te.device_graph_from_ell(tgraph.build_ell(tt, n_atoms=N_ATOMS), "cpu")
        host, _ = jtrop.build_tiles_host(jell.in_src, jell.in_cost, jell.in_valid)
        self.jtiles = jax.device_put(host)
        self.tiles = trop.tiles_on(host, "cpu")
        jd = jtrop._tile_relax(self.jg, self.jtiles,
                               jax.numpy.full((self.n, 1), int(tgraph.INF), jax.numpy.int32)
                               .at[self.root, 0].set(0), None, None, self.n)[:, 0]
        _, dag, hops = jtrop._phase2(self.jg, self.root, jd, self.jg.in_valid, self.n)
        self.dag, self.hops = np.array(dag), np.array(hops)


_CASES: dict = {}


def _case(shape: str) -> _Case:
    if shape not in _CASES:
        _CASES[shape] = _Case(shape)
    return _CASES[shape]


@pytest.mark.parametrize("stale", [False, True])
@pytest.mark.parametrize("max_iters", [None, 0, 1, 2, 3])
@pytest.mark.parametrize("shape", ["tied", "parallel"])
def test_tile_fixpoints_match_jax(shape, max_iters, stale):
    case = _case(shape)
    n = case.n
    limit = n if max_iters is None else max_iters
    a = 32 * case.tg.direct_nh_words.shape[2]
    rng = np.random.default_rng(limit + 10 * stale)
    if stale:
        np0 = rng.integers(0, 5, n).astype(np.int32)
        aw0 = rng.integers(0, 9, (n, a)).astype(np.int32)
    else:
        np0 = (np.arange(n) == case.root).astype(np.int32)
        aw0 = np.zeros((n, a), np.int32)
    flag = torch.from_numpy(case.dag.copy())
    want = np.asarray(jtrop._np_tile_fixpoint(case.jg, case.jtiles, case.dag, case.root, np0,
                                              limit))
    got = trop.np_tile_fixpoint(case.tg, case.tiles, flag, case.root, torch.from_numpy(np0),
                                limit)
    np.testing.assert_array_equal(got[:, 0].numpy(), want)
    npaths = want.astype(np.int32)
    want = np.asarray(jtrop._aw_tile_fixpoint(case.jg, case.jtiles, case.dag, case.hops, npaths,
                                              aw0, limit))
    got = trop.aw_tile_fixpoint(case.tg, case.tiles, flag, torch.from_numpy(case.hops),
                                torch.from_numpy(npaths), torch.from_numpy(aw0), limit)
    np.testing.assert_array_equal(got.numpy(), want)
    if max_iters is None and not stale:
        assert (want > 0).any()
