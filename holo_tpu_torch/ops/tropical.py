"""The tropical (min-plus) SPF engine, single path: ``holo_tpu/ops/tropical.py``.

The distance phase relaxes over **tiles** instead of ELL rows: the directed
adjacency, relabeled by the reverse Cuthill-McKee order
(:func:`~holo_tpu_torch.ops.graph.bandwidth_permutation`) and cut into [B, B]
blocks, keeps only the blocks that hold an edge, grouped by destination row
block (:class:`TropicalTiles`; an entry is the least cost over parallel
edges).  One round (kernel T1, ``kernels/tropical.py`` ``trop_relax``)
computes, per row block and lane, the min-plus product of its tiles with the
source blocks' distances, reading each tile once for many lanes, skipping
the source blocks that did not change in the round before (per block and
lane), and takes the min with the old distances, writing into the buffer of
the round before only what differs from it.

Edge masks cannot be applied to a min over parallel edges, so a (row, lane)
one of whose in-edges is down in the lane is a **repair row**: its value is
the exact masked ELL row relax instead (JAX's ``repair_rows``).  The port
builds that set on the device from the packed mask words
(:func:`repair_bits`): the rows with a valid slot whose edge is down in the
lane.  JAX's host set (:func:`repair_rows_host`, the destinations of every
masked-out edge) is a superset; on a row with no masked slot the exact relax
equals the tiles' value, so both give the same bits, and explicit rows are
accepted too.

Phase 2 is the port's own machinery, as ``hybrid_lanes`` runs it
(``_phase2``, ``tropical.py:634``): ``ell_first_parent`` once, then the joint
hops + next-hop fixpoint (``mp_fixpoint`` from ``mp_start(counts=False)``).
The relax runs at most ``limit`` rounds (N, or ``max_iters``) and stops after
a round that changed nothing, one flag read a round.  Its first frontier
marks the blocks with a finite value (JAX's is all ones; a block of INF
offers nothing, so the rounds are the same).  JAX runs a batch in sequential
chunks of ``LANE_CHUNK`` lanes, a bound on its memory: lanes are
independent and a converged lane is a fixpoint, so here one lane set runs
the whole batch, each lane seeing the rounds JAX gives it.

The multipath program (``tropical_spf_one_multipath`` and its incremental
twin, ``tropical.py:809`` and ``:903``) runs the tile relax and phase 2
(``ell_parent_sets``: first parent, DAG bits and parent sets; the hops +
next-hop fixpoint), then two more fixpoints on the tiles, each a loop of
kernel T2 (``kernels/tropical.py`` ``trop_count_round``) over integer
**count tiles** (:func:`count_tiles`: how many DAG slots join each (row,
source) pair; on the card a round walks only the tiles of the fixpoint's
count list, ``kernels/tropical.py`` ``count_list``, built once): the
saturated path counts (:func:`np_tile_fixpoint`) and the per-atom UCMP
weights (:func:`aw_tile_fixpoint`, over the inherit slots, from the
direct-atom seed).  Each is capped at ``limit`` rounds on its own, as in
JAX: three capped loops after the relax, where the gather engine's ``mp``
runs one joint loop, so truncated bits differ between the two engines.  The
loops keep their carry in the permuted space (padding rows 0): one gather in
and one out give JAX's bits, whose carry is gathered every round.

The tiles are an attachment of a ``DeviceGraphCache`` entry
(``get_tropical``), updated in place by lowered tile deltas
(:func:`lower_tile_delta`, :func:`apply_tile_delta`) along a DeltaPath chain.

Under a dispatch mesh whose node axis pads the resident's rows
(``parallel.mesh.pad_graph_rows``), the program mixes three row counts: the
tiles' NB * B permuted rows, the N real vertices of the permutation, and the
graph's R rows.  The entry gathers read the R-row planes through ``perm``
(whose entries are below N); the exit gathers give N rows, padded back to R
(distances INF, counts 0) as ``holo_tpu`` pads them (``tropical.py:358-364``,
``:481``); the repair pass and the count scatter read the N real rows of the
slot planes, which are the only ones with a valid slot.  ``holo_tpu``'s
``_constrain_replicated`` (``:486-497``) pins the tile loop's carry
replicated against GSPMD's row sharding; the port has no GSPMD and each
batch shard runs the whole loop on its own device, so it has no counterpart.
A batch shard's tiles are those of its device's cache entry: one copy per
physical device, shared by the shards on it.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from holo_tpu_torch.analysis.runtime import read_flag, sanctioned_transfer
from holo_tpu_torch import telemetry
from holo_tpu_torch.device import resolve_device
from holo_tpu_torch.kernels import ell
from holo_tpu_torch.kernels import tropical as kt
from holo_tpu_torch.kernels.blocked import or_reduce
from holo_tpu_torch.ops import spf_engine as se
from holo_tpu_torch.ops.graph import INF as _INF
from holo_tpu_torch.ops.graph import bandwidth_permutation

INF = int(_INF)

#: candidate tile block sizes the marshal scores (:func:`_pick_block`)
_BLOCKS = (8, 16, 32, 64, 128)


_MARSHALS = telemetry.counter("holo_spf_tropical_marshal_total", "Tropical tile-plane marshals")
_MARSHAL_SECONDS = telemetry.histogram(
    "holo_spf_tropical_marshal_seconds", "Host-side mirror -> tile-plane marshal time")
_TILE_OCCUPANCY = telemetry.gauge(
    "holo_spf_tropical_tile_occupancy",
    "Real-edge fraction of materialized tile entries (last marshal)")
_TILE_DELTAS = telemetry.counter(
    "holo_spf_tropical_delta_total",
    "Tile-attachment delta dispositions (in-place scatter vs drop)", ("path",))


def note_tile_delta(counts, path: str) -> None:
    """One tile-attachment delta disposition: ``counts[path]`` (a graph
    cache's ``tile_deltas``) and ``holo_spf_tropical_delta_total{path}``."""
    counts[path] += 1
    _TILE_DELTAS.labels(path=path).inc()


class TropicalTiles(NamedTuple):
    """Blocked min-plus planes grouped by destination row block, in the
    permuted vertex space (numpy planes from :func:`build_tiles_host`,
    tensors from :func:`tiles_on`).  Vertices pad to NB * B rows; a padding
    slot's ``cb`` is NB and its tile all INF."""

    tiles: torch.Tensor  # int32 [NB, Tm, B, B]: tiles[rb, t, i, j], edge cb*B+j -> rb*B+i
    cb: torch.Tensor  # int32 [NB, Tm]: source block of each slot, NB for padding
    pos: torch.Tensor  # int32 [NB, NB]: slot of block pair (rb, c), Tm for none
    perm: torch.Tensor  # int32 [NB * B]: permuted row -> vertex (padding rows: 0)
    inv: torch.Tensor  # int32 [N]: vertex -> permuted row


class TileDeltaUnappliable(Exception):
    """A topology delta the tile attachment cannot absorb in place (an added
    edge in a block pair without a tile): the attachment is dropped and
    rebuilt from the mirror on next use; the ELL entry keeps serving."""

    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


class TileDelta(NamedTuple):
    """A lowered tile delta: the final cost of every touched (src, dst) pair
    at its tile entry, and the overload strike."""

    rb: np.ndarray  # int32 [T] row block
    slot: np.ndarray  # int32 [T]
    i: np.ndarray  # int32 [T] row within the block
    j: np.ndarray  # int32 [T] column within the block
    val: np.ndarray  # int32 [T] least cost over the pair's parallel edges, INF for none
    strike: np.ndarray | None  # bool [NB * B] struck permuted rows, None if none


def _pad_rows(x: torch.Tensor, rows: int, fill: int) -> torch.Tensor:
    """``x`` with ``fill`` rows appended up to ``rows`` (``_pad_rows_to``);
    ``x`` itself where it has them."""
    if x.shape[0] == rows:
        return x
    return torch.cat([x, x.new_full((rows - x.shape[0], *x.shape[1:]), fill)])


def _pick_block(n: int, rows: np.ndarray, srcs: np.ndarray) -> int:
    """The tile size with the least padded tile work ``NB * Tm * B^2`` plus a
    source-gather tax ``8 * NB * Tm * B``; tiny graphs take one block
    (``holo_tpu``'s choice, ``tropical.py:160``)."""
    cap = 8
    while cap < min(n, _BLOCKS[-1]):
        cap *= 2
    best_b, best_score = cap, None
    for b in _BLOCKS:
        if b > cap:
            break
        nb = -(-n // b)
        pair = np.unique((rows // b).astype(np.int64) * nb + srcs // b)
        tm = int(np.bincount(pair // nb, minlength=nb).max()) if pair.size else 1
        score = nb * tm * b * b + 8 * nb * tm * b
        if best_score is None or score < best_score:
            best_b, best_score = b, score
    return best_b


def build_tiles_host(in_src: np.ndarray, in_cost: np.ndarray, in_valid: np.ndarray,
                     block: int | None = None) -> tuple[TropicalTiles, dict]:
    """ELL slot planes (numpy) -> (tile planes as numpy, meta), the marshal
    of ``holo_tpu``'s ``build_tiles_host``: the vertices relabeled by RCM,
    then blocked; parallel edges collapse onto their least cost.  ``meta``
    (block, nb, tm, the pos grid, n, pairs, perm, inv) stays on the host for
    delta lowering."""
    t0 = time.perf_counter()
    n = int(in_src.shape[0])
    rows, cols = np.nonzero(in_valid)
    srcs = in_src[rows, cols].astype(np.int64)
    costs = in_cost[rows, cols]
    perm = bandwidth_permutation(n, srcs, rows)  # perm[new] = old
    inv = np.empty(n, np.int32)
    inv[perm] = np.arange(n, dtype=np.int32)
    rows = inv[rows].astype(np.int64)
    srcs = inv[srcs].astype(np.int64)
    b = int(block) if block is not None else _pick_block(n, rows, srcs)
    nb = max(-(-n // b), 1)
    if rows.size:
        pair = np.unique((rows // b) * nb + srcs // b)
        prb, pcb = pair // nb, pair % nb
        tm = max(int(np.bincount(prb, minlength=nb).max()), 1)
        # A pair's slot is its rank in its row block (pairs sorted: cb ascends).
        slot = np.arange(pair.size, dtype=np.int64) - np.searchsorted(prb, prb, side="left")
        pos = np.full((nb, nb), tm, np.int32)
        pos[prb, pcb] = slot
        cb = np.full((nb, tm), nb, np.int32)
        cb[prb, slot] = pcb
        tiles = np.full((nb, tm, b, b), INF, np.int32)
        np.minimum.at(tiles, (rows // b, pos[rows // b, srcs // b], rows % b, srcs % b), costs)
        n_pairs = int(pair.size)
    else:
        # Edgeless: one all-INF padding slot a row block keeps every shape whole.
        tm = 1
        pos = np.full((nb, nb), 1, np.int32)
        cb = np.full((nb, 1), nb, np.int32)
        tiles = np.full((nb, 1, b, b), INF, np.int32)
        n_pairs = 0
    perm_pad = np.zeros(nb * b, np.int32)
    perm_pad[:n] = perm
    tt = TropicalTiles(tiles=tiles, cb=cb, pos=pos, perm=perm_pad, inv=inv)
    meta = {"block": b, "nb": nb, "tm": tm, "pos": pos.copy(), "n": n, "pairs": n_pairs,
            "perm": perm.copy(), "inv": inv.copy()}
    _MARSHALS.inc()
    _MARSHAL_SECONDS.observe(time.perf_counter() - t0)
    _TILE_OCCUPANCY.set(rows.size / tiles.size if tiles.size else 0.0)
    return tt, meta


def tiles_on(tt, device=None) -> TropicalTiles:
    """The five planes of ``tt`` (this module's host tiles, or ``holo_tpu``'s:
    any object with the same fields) as int32 tensors on ``device``."""
    dev = resolve_device(device)
    with sanctioned_transfer("spf.tiles.upload"):
        return TropicalTiles(*(torch.from_numpy(np.ascontiguousarray(np.asarray(x), np.int32))
                               .to(dev) for x in (tt.tiles, tt.cb, tt.pos, tt.perm, tt.inv)))


def lower_tile_delta(mirror, delta, meta: dict) -> TileDelta:
    """A topology delta as tile writes, against the POST-delta mirror (call
    after ``lower_delta`` moved it; ``tropical.py:269``): every touched
    (src, dst) pair takes its least remaining cost (INF when none is left),
    and the overloaded vertices are a column strike.  Raises
    :class:`TileDeltaUnappliable` when an added edge lands in a block pair
    without a tile.  Only the touched entries are written (no padding)."""
    b, tm, grid, inv = meta["block"], meta["tm"], meta["pos"], meta["inv"]
    pairs = set()
    for srcs, dsts in ((delta.r_src, delta.r_dst), (delta.w_src, delta.w_dst),
                       (delta.a_src, delta.a_dst)):
        pairs.update(zip(map(int, srcs), map(int, dsts)))
    ops = []
    for u, v in sorted(pairs):
        pu, pv = int(inv[u]), int(inv[v])
        slot = int(grid[pv // b, pu // b])
        if slot >= tm:
            # Only an addition can miss: a removed or re-costed edge has a tile.
            raise TileDeltaUnappliable("tile-missing")
        m = mirror.in_valid[v] & (mirror.in_src[v] == u)
        ops.append((pv // b, slot, pv % b, pu % b, int(mirror.in_cost[v][m].min()) if m.any()
                    else INF))
    strike = None
    if len(delta.overload):
        strike = np.zeros(meta["nb"] * b, bool)
        strike[inv[np.asarray(delta.overload)]] = True
    cols = np.array(ops, np.int32).reshape(-1, 5).T
    return TileDelta(*cols, strike)


def apply_tile_delta(tt: TropicalTiles, ops: TileDelta) -> TropicalTiles:
    """Write a lowered tile delta into the resident tiles in place
    (``tropical.py:316``): the strike first (a struck vertex's tile columns
    go to INF), then the entries, which hold the final mirror state.
    Returns ``tt``."""
    nb, _, b, _ = tt.tiles.shape
    dev = tt.tiles.device
    if ops.strike is not None:
        with sanctioned_transfer("spf.tiles.delta"):
            strike = torch.from_numpy(ops.strike).to(dev)
        # Padding slots read block 0's columns: they are all INF already.
        colv = (torch.where(tt.cb < nb, tt.cb, 0).long()[:, :, None] * b
                + torch.arange(b, device=dev))
        tt.tiles.masked_fill_(strike[colv][:, :, None, :], INF)
    if ops.rb.shape[0]:
        with sanctioned_transfer("spf.tiles.delta"):
            up = torch.from_numpy(np.stack([ops.rb, ops.slot, ops.i, ops.j, ops.val])).to(dev)
        tt.tiles.index_put_(tuple(up[:4].long()), up[4])
    return tt


def repair_rows_host(edge_dst, masks, sentinel: int) -> np.ndarray:
    """int32 [S, M]: per scenario the distinct destinations of its masked-out
    edges, padded with ``sentinel``; M the power of two (at least 8) above
    the largest count, 0 when no edge fails anywhere (``tropical.py:335``)."""
    masks = np.asarray(masks, bool)
    dst = np.asarray(edge_dst, np.int32)
    per = [np.unique(dst[~m]) for m in masks]
    worst = max((r.shape[0] for r in per), default=0)
    if worst == 0:
        return np.zeros((masks.shape[0], 0), np.int32)
    m = 8
    while m < worst:
        m *= 2
    out = np.full((masks.shape[0], m), sentinel, np.int32)
    for i, r in enumerate(per):
        out[i, : r.shape[0]] = r
    return out


def repair_bits(slot: torch.Tensor, mask: torch.Tensor, lanes: int,
                tt: TropicalTiles) -> torch.Tensor:
    """int32 [NB * B, ceil(lanes / 32)]: the repair set built on the device
    from the packed mask words [E, ceil(lanes / 32)] -- bit s of a permuted
    row set where one of its vertex's valid slots (``slot`` >= 0, the edge
    id) is down in lane s."""
    lane_words = ell.full_frontier(1, lanes, slot.device)[0]
    down = torch.where((slot >= 0)[:, :, None], ~mask[slot.clamp_min(0).long()] & lane_words, 0)
    out = or_reduce(down, 1)[tt.perm.long()]
    out[tt.inv.shape[0]:] = 0  # padding rows read vertex 0
    return out


def rows_to_bits(rows, tt: TropicalTiles) -> torch.Tensor:
    """Explicit repair rows (int32 [S, M] vertex ids, each lane's; ids at or
    past N are padding) -> the lane-bit plane [NB * B, ceil(S / 32)]."""
    dev = tt.inv.device
    with sanctioned_transfer("spf.tiles.repair_rows"):
        rows = torch.as_tensor(np.asarray(rows, np.int64)).to(dev)
    n, npad = tt.inv.shape[0], tt.perm.shape[0]
    # Padding ids land in a spare row past the planes, which is dropped: no
    # boolean-mask index (a data-dependent shape) and no host scalar.
    flags = torch.zeros((npad + 1, rows.shape[0]), dtype=torch.bool, device=dev)
    if rows.numel() and n:
        keep = (rows >= 0) & (rows < n)
        prow = torch.where(keep, tt.inv[rows.clamp(0, n - 1)].long(), npad)
        lane = torch.arange(rows.shape[0], device=dev)[:, None].expand_as(rows)
        flags.index_put_((prow, lane), torch.ones_like(keep))
    return ell.pack_lane_bits(flags[:npad])


def tile_relax(g, tt: TropicalTiles, dist0: torch.Tensor, mask=None, repair=None,
               limit: int | None = None):
    """The blocked min-plus fixpoint of every lane (``_tile_relax``):
    (dist [N, S], rounds) from ``dist0`` [N, S].

    ``mask`` [E, ceil(S / 32)] or None holds the lanes' edge masks;
    ``repair`` is None (the repair set from ``mask``, :func:`repair_bits`) or
    explicit rows [S, M] (:func:`repair_rows_host`); its (row, lane) list is
    built once.  At most ``limit`` rounds (N when None), stopping after a
    round that changed nothing.  The rounds write into two buffers in turn:
    each into the one the round before read, which differs from its input
    only at its input frontier (the first into a copy of the input)."""
    n = g.in_src.shape[0]
    limit = n if limit is None else limit
    nb, _, b, _ = tt.tiles.shape
    lanes = dist0.shape[1]
    n_true = tt.inv.shape[0]
    p = se.lane_planes(g, mask)
    if n_true < n:  # row-padded: the repair pass reads the real rows' slots
        p = p._replace(src=p.src[:n_true], cost=p.cost[:n_true], slot=p.slot[:n_true])
    if repair is not None:
        bits = rows_to_bits(repair, tt)
    elif mask is not None:
        bits = repair_bits(p.slot, mask, lanes, tt)
    else:
        bits = None
    rep = None if bits is None else kt.repair_set(bits, lanes)
    dist = dist0[tt.perm.long()].contiguous()
    spare = dist.clone()  # the first round's out, equal to dist everywhere
    active = ell.pack_lane_bits((dist < INF).view(nb, b, lanes).any(1))
    rounds = 0
    while rounds < limit:
        new, changed, active = kt.trop_relax(tt.tiles, tt.cb, dist, active, spare, rep, p.src,
                                             p.cost, p.slot, p.mask, tt.perm, tt.inv)
        dist, spare = new, dist
        rounds += 1
        if not read_flag("spf.flag.tile_relax", changed):
            break
    return _pad_rows(dist[tt.inv.long()], n, INF).contiguous(), rounds


def tropical_lanes(g, tt: TropicalTiles, roots: torch.Tensor, mask, repair=None,
                   max_iters=None):
    """The lane-batched tropical SPF: (dist, parent, hops [N, B], nexthops [N,
    W, B]), lane b rooted at ``roots[b]`` under mask bit b: the tile relax,
    then ``ell_first_parent`` and the joint hops + next-hop fixpoint from
    fresh seeds (JAX's ``_phase2``), each loop limited to N rounds
    (``max_iters``)."""
    n = g.in_src.shape[0]
    limit = n if max_iters is None else max_iters
    dist0, _ = se.distance_seed(n, roots)
    dist, _ = tile_relax(g, tt, dist0, mask, repair, limit)
    parent, dag = ell.ell_first_parent(*se.lane_planes(g, mask), dist, roots)
    start = se.mp_start(n, g.direct_nh_words.shape[2], roots, counts=False)
    (hops, nh, _, _), _ = se.mp_fixpoint(g, roots, dag, parent, *start, limit)
    return dist, parent, torch.where(dist < INF, hops, n + 1), nh


def _lane_rows(repair_rows, lanes: int):
    """Explicit repair rows [M] shared by ``lanes`` lanes -> [lanes, M]; None
    stays None."""
    if repair_rows is None:
        return None
    rows = np.asarray(repair_rows, np.int64).reshape(1, -1)
    return np.repeat(rows, lanes, axis=0)


def tropical_spf_one(g, tt: TropicalTiles, root: int, edge_mask=None, repair_rows=None,
                     max_iters=None) -> se.SpfTensors:
    """Full SPF with the distances on the tiles (``tropical_spf_one``).
    ``repair_rows`` [M] (the masked edges' destinations) or None: the repair
    set from ``edge_mask``, built on the device."""
    dev = g.in_src.device
    mask = None if edge_mask is None else se.pack_edge_masks(np.asarray(edge_mask)[None], dev)
    out = se._batch_major(*tropical_lanes(g, tt, se._roots(root, 1, dev), mask,
                                          _lane_rows(repair_rows, 1), max_iters))
    return se.SpfTensors(*(x[0] for x in out))


def tropical_whatif_batch(g, tt: TropicalTiles, root: int, edge_masks, repair_rows=None,
                          max_iters=None) -> se.SpfTensors:
    """Batched what-if SPF on the tiles over scenario masks (bool [B, E]):
    [B, N] planes, next hops [B, N, W] (``tropical_whatif_batch``), every
    scenario a lane of one program.  ``repair_rows`` [B, M] or None (built on
    the device from the masks)."""
    dev = g.in_src.device
    mask = se.pack_edge_masks(edge_masks, dev)
    batch = int(np.shape(edge_masks)[0])
    return se._batch_major(*tropical_lanes(g, tt, se._roots(root, batch, dev), mask,
                                           repair_rows, max_iters))


def tropical_multiroot(g, tt: TropicalTiles, roots, edge_mask=None, repair_rows=None,
                       max_iters=None) -> se.SpfTensors:
    """SPF from many roots on the tiles (``tropical_multiroot``): [R, N]
    dist, parent and hops, each root a lane, ``edge_mask`` [E] shared by
    all (``repair_rows`` [M] or None, as in :func:`tropical_spf_one`).  No
    next-hop plane, as ``spf_multiroot``."""
    dev = g.in_src.device
    with sanctioned_transfer("spf.roots.upload"):
        roots_t = torch.as_tensor(np.asarray(roots, np.int32)).to(dev)
    lanes = roots_t.shape[0]
    mask = None
    if edge_mask is not None:
        shared = np.repeat(np.asarray(edge_mask, bool)[None], lanes, axis=0)
        mask = se.pack_edge_masks(shared, dev)
    dist, parent, hops, _ = tropical_lanes(g, tt, roots_t, mask, _lane_rows(repair_rows, lanes),
                                           max_iters)
    return se._batch_major(dist, parent, hops, None)


def tropical_spf_one_incremental(g, tt: TropicalTiles, root: int, prev: se.SpfTensors,
                                 seed_rows, max_iters=None, stats: dict | None = None):
    """DeltaPath on the tiles (``tropical_spf_one_incremental``):
    ``spf_one_incremental``'s affected set, the seeded relax on the tiles
    (no mask), then ``ell_first_parent`` and ``hops_nh_recompute`` seeded
    with the previous hops and next hops.  ``stats`` as there."""
    return se.spf_one_incremental(
        g, root, prev, seed_rows, max_iters, stats,
        relax=lambda dist0, limit: tile_relax(g, tt, dist0, None, None, limit))


# ---------------------------------------------------------------------------
# The multipath program: count tiles and the two tile fixpoints (T2)


def count_tiles(src: torch.Tensor, tt: TropicalTiles, flag: torch.Tensor) -> torch.Tensor:
    """``_count_tiles`` (``tropical.py:510``): int32 [NB, Tm, B, B] whose
    entry (rb, t, i, j) is how many flagged ELL slots (``flag`` bool [N, K],
    ``src`` the slots' sources [N, K]) join source ``cb[rb, t] * B + j`` to
    row ``rb * B + i`` of the permuted space; parallel edges count once each.
    A flagged slot whose block pair has no tile drops, as JAX's scatter
    drops it (never: a flagged slot is a valid edge).  Integer adds, so the
    scatter's order does not matter."""
    nb, tm, b, _ = tt.tiles.shape
    n = tt.inv.shape[0]  # a padded resident's pad rows flag no slot
    flag, src = flag[:n], src[:n]
    k = flag.shape[1]
    inv = tt.inv.long()
    pv = inv[:, None].expand(n, k)
    ps = inv[src.long()]
    slot = torch.where(flag, tt.pos.long()[pv // b, ps // b], tm)  # Tm: dropped
    out = torch.zeros((nb, tm + 1, b, b), dtype=torch.int32, device=flag.device)
    out.index_put_((pv // b, slot, pv % b, ps % b), flag.to(torch.int32), accumulate=True)
    return out[:, :tm].contiguous()


def direct_atom_seed(g, direct: torch.Tensor, npaths: torch.Tensor) -> torch.Tensor:
    """The fixed seed of the weight fixpoint (``tropical.py:598-603``), int32
    [N, A] with A = 32 W: ``seed[v, a]`` is the sum of ``npaths[src]`` over
    the slots of v flagged in ``direct`` (bool [N, K]: DAG slots whose source
    has hops 0) whose direct-atom words hold bit a.  One pass a bit, over
    all words at once: JAX's [N, K, A] one-hot is never built."""
    n, _ = direct.shape
    words = g.direct_nh_words
    val = torch.where(direct, npaths[g.in_src.long()], 0)  # [N, K]
    seed = torch.empty((n, words.shape[2], 32), dtype=torch.int32, device=direct.device)
    for bit in range(32):
        seed[:, :, bit] = (((words >> bit) & 1) * val[:, :, None]).sum(1, dtype=torch.int32)
    return seed.view(n, -1)


def _to_tiles(v: torch.Tensor, tt: TropicalTiles) -> torch.Tensor:
    """Vertex rows [N, A] -> the permuted rows [NB * B, A], padding rows 0."""
    out = v[tt.perm.long()]
    out[tt.inv.shape[0]:] = 0  # padding rows read vertex 0
    return out


def _count_fixpoint(tt: TropicalTiles, cnt, x0, seed, root_row: int, limit: int):
    """Values [R, A]: T2 rounds from ``x0`` [R, A] (only read; R the graph's
    rows, N or more) between two permuted buffers, while a round changed
    something and fewer than ``limit`` ran, one flag read a round; rows past
    N are 0.  The count list (the nonzero tiles, the same for every round)
    is built once, before the first."""
    rows = x0.shape[0]
    x = _to_tiles(x0, tt)
    if limit <= 0:
        return _pad_rows(x[tt.inv.long()], rows, 0)
    spare = torch.empty_like(x)
    seed_p = None if seed is None else _to_tiles(seed, tt)
    listed = kt.count_list(cnt, tt.cb)
    rounds = 0
    changed = True
    while changed and rounds < limit:
        new, flag = kt.trop_count_round(cnt, tt.cb, listed, x, seed_p, spare, root_row)
        x, spare = new, x
        changed = read_flag("spf.flag.tile_count", flag)
        rounds += 1
    return _pad_rows(x[tt.inv.long()], rows, 0)


def np_tile_fixpoint(g, tt: TropicalTiles, dag: torch.Tensor, root: int, np0: torch.Tensor,
                     limit: int):
    """``_np_tile_fixpoint`` (``tropical.py:539``): npaths [N, 1], the
    saturated shortest-path counts ``min(sum of npaths[src] over the DAG
    slots, MP_SAT)``, 1 at the root, a Jacobi loop from ``np0`` [N] over the
    count tiles of ``dag`` (bool [N, K])."""
    cnt = count_tiles(g.in_src, tt, dag)
    with sanctioned_transfer("spf.tiles.root_row"):
        root_row = int(tt.inv[root])
    return _count_fixpoint(tt, cnt, np0[:, None], None, root_row, limit)


def aw_tile_fixpoint(g, tt: TropicalTiles, dag: torch.Tensor, hops: torch.Tensor,
                     npaths: torch.Tensor, aw0: torch.Tensor, limit: int):
    """``_aw_tile_fixpoint`` (``tropical.py:580``): nh_weights [N, A], the
    per-atom UCMP weights ``min(seed + sum of aw[src] over the
    inherit slots, MP_SAT)``, a Jacobi loop from ``aw0`` [N, A].  ``hops``
    [N] and ``npaths`` [N] are phase 2's raw planes: the DAG slots whose
    source has hops 0 seed the direct atoms, the others inherit."""
    hop0 = hops[g.in_src.long()] == 0
    seed = direct_atom_seed(g, dag & hop0, npaths)
    cnt = count_tiles(g.in_src, tt, dag & ~hop0)
    return _count_fixpoint(tt, cnt, aw0, seed, -1, limit)


def _multipath_on_tiles(g, tt: TropicalTiles, p, dist, root: int, start, np0, aw0, kp: int,
                        limit: int):
    """The rest of a one-lane multipath program after the tile relax, over
    its distances ``dist`` [N, 1]: ``ell_parent_sets`` (first parent, DAG
    bits, parent sets), the hops + next-hop fixpoint from ``start``
    (``mp_start`` / ``mp_resume`` without count planes), the path counts
    from ``np0`` [N] and the weights from ``aw0`` [N, A] on the tiles, and
    the parent weights from the raw path counts: (SpfTensors,
    MultipathTensors, phase-2 rounds)."""
    n = g.in_src.shape[0]
    roots = se._roots(root, 1, g.in_src.device)
    parent, dag, parents, pdist = ell.ell_parent_sets(*p, dist, roots, kp)
    (hops, nh, _, _), rounds = se.mp_fixpoint(g, roots, dag, parent, *start, limit)
    flag = (dag[:, :, 0] & 1) != 0  # lane 0's bit of the DAG words
    npaths = np_tile_fixpoint(g, tt, flag, root, np0, limit)
    aw = aw_tile_fixpoint(g, tt, flag, hops[:, 0], npaths[:, 0], aw0, limit)
    pweight = ell.ell_parent_weights(parents, npaths)
    d = dist[:, 0]
    reach = d < INF
    sp = se.SpfTensors(dist=d, parent=parent[:, 0], hops=torch.where(reach, hops[:, 0], n + 1),
                       nexthops=nh[:, :, 0])
    mp = se.MultipathTensors(parents=parents[:, :, 0], pdist=pdist[:, :, 0],
                             pweight=pweight[:, :, 0],
                             npaths=torch.where(reach, npaths[:, 0], 0), nh_weights=aw)
    return sp, mp, rounds


def tropical_spf_one_multipath(g, tt: TropicalTiles, root: int, kp: int, edge_mask=None,
                               repair_rows=None, max_iters=None):
    """The multipath program on the tiles (``tropical_spf_one_multipath``):
    (SpfTensors, MultipathTensors) of one run, the distances by the tile
    relax (``edge_mask`` and ``repair_rows`` as in
    :func:`tropical_spf_one`), then phase 2 and the count and weight planes
    on the tiles from fresh seeds.  ``npaths`` is 0 where unreachable;
    ``nh_weights`` is the weight fixpoint's value as it is."""
    n = g.in_src.shape[0]
    limit = n if max_iters is None else max_iters
    dev = g.in_src.device
    mask = None if edge_mask is None else se.pack_edge_masks(np.asarray(edge_mask)[None], dev)
    roots = se._roots(root, 1, dev)
    dist0, _ = se.distance_seed(n, roots)
    dist, _ = tile_relax(g, tt, dist0, mask, _lane_rows(repair_rows, 1), limit)
    words = g.direct_nh_words.shape[2]
    start = se.mp_start(n, words, roots, counts=False)
    np0 = (torch.arange(n, device=dev) == int(root)).to(torch.int32)
    aw0 = torch.zeros((n, 32 * words), dtype=torch.int32, device=dev)
    sp, mp, _ = _multipath_on_tiles(g, tt, se.lane_planes(g, mask), dist, root, start, np0,
                                    aw0, kp, limit)
    return sp, mp


def tropical_spf_one_incremental_multipath(g, tt: TropicalTiles, root: int,
                                           prev: se.SpfTensors, prev_npaths, prev_nh_weights,
                                           seed_rows, kp: int, max_iters=None,
                                           stats: dict | None = None):
    """DeltaPath multipath on the tiles
    (``tropical_spf_one_incremental_multipath``): ``spf_one_incremental``'s
    affected set and the seeded relax on the tiles (no mask), phase 2 seeded
    with the previous hops and next hops, and the count and weight
    fixpoints seeded with the previous run's output planes ``prev_npaths``
    [N] and ``prev_nh_weights`` [N, A] (only read).  (SpfTensors,
    MultipathTensors); ``stats`` as in ``spf_one_incremental_multipath``
    (its ``hops_nh`` phase also holds the parent sets and the tile
    fixpoints)."""
    n = g.in_src.shape[0]
    limit = n if max_iters is None else max_iters
    p, dist, record = se._incremental_relax(
        g, root, prev, seed_rows, limit,
        relax=lambda dist0, lim: tile_relax(g, tt, dist0, None, None, lim))
    start = se.mp_resume((prev.hops[:, None], prev.nexthops[:, :, None], None, None))
    sp, mp, rounds = _multipath_on_tiles(g, tt, p, dist, root, start, prev_npaths,
                                         prev_nh_weights, kp, limit)
    se._note_phases(stats, record, rounds)
    return sp, mp


# -- kernel-contract audit registrations (HL3xx) ------------------------
# Inert contract descriptors for holo_tpu_torch.analysis.kernel_audit: the
# programs are the backend's tropical calls (same argument order,
# max_iters=None), with holo_tpu's explicit repair rows.  The thunks run
# only when the audit runs.
from holo_tpu_torch.analysis.kernels import register_kernel as _register_kernel  # noqa: E402

_AUDIT_RR = 8  # repair-row pad lanes


def audit_tiles(ell_graph, device) -> TropicalTiles:
    """The tile planes of an ELL marshal, on ``device``."""
    host, _ = build_tiles_host(ell_graph.in_src, ell_graph.in_cost, ell_graph.in_valid)
    return tiles_on(host, device)


def _audit_specs(device) -> dict:
    """``spf_engine.audit_specs`` plus the tiles and the repair rows of the
    mask ([M]) and of the masks ([B, M])."""
    a = se.audit_specs(device)
    topo = a["topo"]
    a["tt"] = audit_tiles(se.audit_ell(topo), device)
    rows = repair_rows_host(topo.edge_dst, a["masks"], topo.n_vertices)
    a["rrs"] = _pad_lanes(rows, _AUDIT_RR, topo.n_vertices)
    a["rr"] = a["rrs"][1]
    return a


def _pad_lanes(rows: np.ndarray, m: int, sentinel: int) -> np.ndarray:
    out = np.full((rows.shape[0], max(m, rows.shape[1])), sentinel, np.int32)
    out[:, : rows.shape[1]] = rows
    return out


def _audit_incremental_specs(device, kp: int = 1) -> tuple:
    a = se.audit_incremental_specs(device, kp)
    tt = audit_tiles(se.audit_ell(a["topo"]), device)
    head = (a["g"], tt, a["root"], a["sp"])
    if kp > 1:
        head += (a["mp"].npaths, a["mp"].nh_weights)
    return head + (a["seeds"],)


def _audit_tile_delta_specs(device) -> tuple:
    """(resident tiles, lowered tile delta): the base topology's tiles, the
    delta lowered against the post-delta mirror, as the graph cache does."""
    base = se.audit_topology()
    ell_graph = se.audit_ell(base)
    host, meta = build_tiles_host(ell_graph.in_src, ell_graph.in_cost, ell_graph.in_valid)
    new = se.audit_delta_topology(base)
    mirror = se._EllMirror(ell_graph)
    se.lower_delta(mirror, new.delta_base, base.n_vertices)
    return tiles_on(host, device), lower_tile_delta(mirror, new.delta_base, meta)


def _pick(*keys):
    return lambda device: (lambda a: tuple(a[k] for k in keys))(_audit_specs(device))


_register_kernel(
    "spf.delta.apply_tiles",
    builder=lambda: apply_tile_delta,
    specs=_audit_tile_delta_specs,
    donate=(0,),
    buckets=16,  # pow2 delta-row pads x block-size buckets
)

_register_kernel(
    "spf.tropical.one",
    builder=lambda: lambda g, tt, r, m, rr: tropical_spf_one(g, tt, r, m, rr, None),
    specs=_pick("g", "tt", "root", "mask", "rr"),
    buckets=5,  # one program per pow2 tile block size (8..128)
)

_register_kernel(
    "spf.tropical.whatif",
    builder=lambda: lambda g, tt, r, ms, rr: tropical_whatif_batch(g, tt, r, ms, rr, None),
    specs=_pick("g", "tt", "root", "masks", "rrs"),
    buckets=16,  # block-size x scenario-chunk buckets
)

_register_kernel(
    "spf.tropical.multiroot",
    builder=lambda: lambda g, tt, rs, m, rr: tropical_multiroot(g, tt, rs, m, rr, None),
    specs=_pick("g", "tt", "roots", "mask", "rr"),
    buckets=16,
)

_register_kernel(
    "spf.tropical.multipath.k2",
    builder=lambda: lambda g, tt, r, m, rr: tropical_spf_one_multipath(
        g, tt, r, 2, m, rr, None),
    specs=_pick("g", "tt", "root", "mask", "rr"),
    buckets=20,  # block-size x kp {1,2,4,8} buckets
)

# holo_tpu donates the previous planes (argument 3); the port's tropical
# DeltaPath reads them and makes new planes, so it declares no donation.
_register_kernel(
    "spf.tropical.incremental",
    builder=lambda: lambda g, tt, r, prev, seeds: tropical_spf_one_incremental(
        g, tt, r, prev, seeds, None),
    specs=_audit_incremental_specs,
    buckets=16,  # block-size x pow2 seed-row pads
)

# holo_tpu donates the previous planes, npaths and nh_weights (arguments 3,
# 4 and 5); the port only reads them (the tile fixpoints copy their seeds),
# so it declares no donation.
_register_kernel(
    "spf.tropical.incremental.multipath.k2",
    builder=lambda: lambda g, tt, r, prev, np_p, aw_p, seeds: (
        tropical_spf_one_incremental_multipath(g, tt, r, prev, np_p, aw_p, seeds, 2, None)),
    specs=lambda device: _audit_incremental_specs(device, 2),
    buckets=32,
)
