"""The tropical engine's CUDA kernels, beside their plain PyTorch versions.

Two wrappers over ``csrc/tropical_kernels.cu``:

- :func:`trop_relax` (T1): one round of the blocked min-plus fixpoint of
  ``holo_tpu/ops/tropical.py`` (``_tile_relax``'s loop body, ``:423-464``, an
  XLA fusion in the JAX package, not a Pallas kernel).  On the card it
  launches the tile pass and, where the round has repair (row, lane)s, the
  repair pass after it on the same stream;
- :func:`trop_count_round` (T2): one round of the multipath tile fixpoints
  (``_np_tile_fixpoint`` / ``_aw_tile_fixpoint``'s loop bodies, ``:559-572``
  and ``:608-623``, int32 einsums in XLA): the integer contraction of
  count tiles with the source blocks' values, clamped at ``MP_SAT``.

A wrapper given CPU tensors computes the plain version
(:func:`trop_relax_plain`, :func:`trop_count_plain`); given CUDA tensors it
launches the kernels on the current stream or raises.  It never falls back.
:data:`launches` counts kernel launches: ``trop_relax`` one a wrapper call,
``trop_repair`` one a repair pass, ``trop_count`` one a T2 call.

Planes (all int32, INF = 1 << 30 unreachable; the vertex space is the
tiles' permuted one, padded to NB * B rows):

- ``tiles`` [NB, Tm, B, B]: ``tiles[rb, t, i, j]`` the least cost of an edge
  ``cb[rb, t] * B + j -> rb * B + i``, INF where there is none;
- ``cb`` [NB, Tm]: the source block of each slot, NB for a padding slot;
- ``dist`` [NB * B, S]: the lanes' distances, lanes minor;
- ``active`` [NB, ceil(S / 32)]: bit s % 32 of word [c, s // 32] set where
  a row of block c changed in lane s in the round before (the frontier);
- ``out`` [NB * B, S]: another buffer, equal to ``dist`` outside the (block,
  lane)s of ``active`` (the copy rule: the kernel writes only the frontier's
  (block, lane)s and the values that change; a fixpoint passes the buffer
  of the round before, its first round a copy of ``dist``); it receives the
  new distances;
- ``repair`` (:class:`RepairSet`) or None: the (row, lane)s whose value is
  the exact masked ELL row relax instead of the tiles' (a row one of whose
  in-edges is down in the lane), as bits and as a list built once per
  fixpoint (:func:`repair_set`); the repair pass reads the ELL planes
  ``src``, ``cost``, ``slot`` [N, K] (slot: the edge id, -1 for padding),
  the mask words ``mask`` [E, ceil(S / 32)] (None: every edge up), ``perm``
  [NB * B] (permuted row -> vertex) and ``inv`` [N] (vertex -> permuted
  row), as the gather kernels do (``kernels/ell.py``);
- ``cnt`` [NB, Tm, B, B] (T2): ``cnt[rb, t, i, j]`` how many flagged ELL slots
  join ``cb[rb, t] * B + j`` to ``rb * B + i`` (0 on a padding slot);
- ``listed`` (T2, :class:`CountList`): each row block's real slots whose
  count tile holds a nonzero entry, built once per fixpoint
  (:func:`count_list`); the kernel walks only those.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from holo_tpu_torch.analysis.runtime import sanctioned_transfer
from holo_tpu_torch.kernels import build, work
from holo_tpu_torch.kernels.ell import (
    _round_result,
    _unpack,
    mask_words,
)

INF = 1 << 30
MP_SAT = 1 << 17  # the multipath counts' saturation (holo_tpu/ops/graph.py:36)
BLOCKS = (8, 16, 32, 64, 128)  # the tile sizes the kernel is built for
_TEMP = 1 << 26  # elements of the largest [NB, B, B, lanes] temporary of the plain version

#: kernel launches since the last :func:`reset_launches`
launches = {"trop_relax": 0, "trop_repair": 0, "trop_count": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


class RepairSet(NamedTuple):
    """The repair (row, lane)s of a fixpoint, fixed for all its rounds."""

    bits: torch.Tensor  # int32 [NB * B, ceil(S / 32)]: bit s of row p's word s // 32
    pairs: torch.Tensor  # int32 [R, 2]: (permuted row, lane) of every set bit, row-major


def repair_set(bits: torch.Tensor, lanes: int) -> RepairSet:
    """The repair plane ``bits`` [NB * B, ceil(lanes / 32)] with its list of
    (row, lane) pairs, in row-major order (one host sync: a fixpoint builds
    it once)."""
    with sanctioned_transfer("spf.tiles.repair_set"):
        pairs = _unpack(bits, slice(0, lanes)).nonzero().to(torch.int32)
    return RepairSet(bits, pairs.contiguous())


def repair_plain(dist, pairs, src, cost, slot, mask, perm, inv):
    """int32 [R]: the plain repair pass -- for each listed repair (row, lane)
    pair (``pairs`` int32 [R, 2], :func:`repair_set`'s), the exact masked ELL
    relax of the row's vertex in that lane (``holo_tpu/ops/tropical.py:445-457``):
    the least ``dist[inv[src], lane] + cost`` over its usable slots whose
    source is reached, INF where there is none.  Gathers only, as the
    kernel's warp a pair: the list is the fixpoint's, built once."""
    row, lane = pairs[:, 0].long(), pairs[:, 1]
    v = perm[row].long()
    vslot = slot[v]  # [R, K]
    dn = dist[inv[src[v].long()].long(), lane.long()[:, None]]  # [R, K]
    ok = (vslot >= 0) & (dn < INF)
    if mask is not None:
        words = mask[vslot.clamp_min(0).long(), (lane // 32).long()[:, None]]
        ok &= ((words >> (lane % 32)[:, None]) & 1) != 0
    return torch.where(ok, dn + cost[v], INF).amin(1)


def trop_relax_plain(tiles, cb, dist, active, out, repair=None, src=None, cost=None, slot=None,
                     mask=None, perm=None, inv=None):
    """One round of ``_tile_relax``: (out holding the new distances [NB * B,
    S], changed int32 [1], active_out [NB, ceil(S / 32)]).

    ``agg[rb * B + i, s]`` is the least ``tiles[rb, t, i, j] + dist[cb * B +
    j, s]`` over the slots t whose source block ``cb[rb, t]`` is real and
    active in lane s and over j, the sum saturated at INF (INF + INF does not
    fit int32, so the sums are taken in int64).  Where ``repair`` has the
    bit of (row, lane), the exact masked ELL relax of the row's vertex
    replaces ``agg``: the least ``dist[inv[src], s] + cost`` over its usable
    slots whose source is reached.  Then ``new = min(dist, agg)``, written
    whole into ``out`` (whatever it held); ``active_out`` marks the (block,
    lane)s where a row changed."""
    nb, tm, b, _ = tiles.shape
    npad, lanes = dist.shape
    dev = dist.device
    act = _unpack(active, slice(0, lanes))  # [NB, S]
    real = cb < nb
    csafe = torch.where(real, cb, 0).long()
    db = dist.view(nb, b, lanes)
    agg = torch.empty((nb, b, lanes), dtype=torch.int32, device=dev)
    step = max(1, _TEMP // max(nb * b * b, 1))
    for s0 in range(0, lanes, step):
        sl = slice(s0, min(s0 + step, lanes))
        acc = torch.full((nb, b, sl.stop - sl.start), INF, dtype=torch.int64, device=dev)
        for t in range(tm):
            c = csafe[:, t]
            use = real[:, t, None] & act[c][:, sl]  # [NB, S']
            srcb = torch.where(use[:, None, :], db[c][:, :, sl], INF).long()  # [NB, B(j), S']
            cand = (tiles[:, t].long()[:, :, :, None] + srcb[:, None, :, :]).amin(2)
            acc = torch.minimum(acc, cand)
        agg[:, :, sl] = acc.clamp_max(INF).to(torch.int32)
    agg = agg.view(npad, lanes)
    if repair is not None and repair.pairs.shape[0]:
        vals = repair_plain(dist, repair.pairs, src, cost, slot, mask, perm, inv)
        agg[repair.pairs[:, 0].long(), repair.pairs[:, 1].long()] = vals
    new = torch.minimum(dist, agg)
    out.copy_(new)
    return out, *_round_result((new != dist).view(nb, b, lanes).any(1))


def _launch(name: str, *args) -> None:
    """Launch ``holo_<name>`` (raises on a CUDA error) and count it."""
    build.launch(f"holo_{name}", *args)
    launches[name] += 1


# Work tallies (:mod:`holo_tpu_torch.kernels.work`), as PERF.md section 3
# prices T1 and T2: every tile entry of every slot in every lane.
TILE_OPS = 2  # T1 a (tile entry, lane): an add and a min
REPAIR_OPS = 3  # T1's repair pass a (slot, lane) of a repair pair
COUNT_OPS, COUNT_CELL_OPS = 2, 3  # T2 a (count entry, lane); an output entry
LIST_OPS = 1  # the count list: a test a count entry


def trop_relax(tiles, cb, dist, active, out, repair=None, src=None, cost=None, slot=None,
               mask=None, perm=None, inv=None):
    """(out holding the new distances [NB * B, S], changed int32 [1],
    active_out [NB, ceil(S / 32)]): one round of the tile relax, see
    :func:`trop_relax_plain`.  On the card the kernels write only the
    entries of ``active``'s (block, lanes) and those that change, so
    ``out`` must equal ``dist`` elsewhere.  The ELL planes, ``mask``,
    ``perm`` and ``inv`` are read only for the pairs of ``repair`` (None:
    no row is repaired)."""
    rp = (None, None) if repair is None else tuple(repair)
    planes = (tiles, cb, dist, active, out, *rp, src, cost, slot, mask, perm, inv)
    if work.COUNTING:
        pairs = 0 if repair is None else repair.pairs.shape[0] * src.shape[1]
        work.note("trop_relax", TILE_OPS * tiles.numel() * dist.shape[1] + REPAIR_OPS * pairs,
                  work.nbytes(tiles, cb, dist, active, *rp, src, cost, slot, mask, perm, inv,
                              out, active) + 4)
    if not build.on_card(*planes):
        return trop_relax_plain(tiles, cb, dist, active, out, repair, src, cost, slot, mask,
                                perm, inv)
    nb, tm, b, b2 = tiles.shape if tiles.dim() == 4 else (0, 0, 0, -1)
    npad, lanes = dist.shape
    words = mask_words(lanes)
    bad = b != b2 or b not in BLOCKS or cb.shape != (nb, tm) or npad != nb * b
    bad |= active.shape != (nb, words)
    bad |= out.shape != dist.shape or out.data_ptr() == dist.data_ptr()
    k = 0
    if repair is not None:
        n, k = src.shape
        bad |= repair.bits.shape != (npad, words) or cost.shape != (n, k)
        bad |= slot.shape != (n, k) or repair.pairs.dim() != 2 or repair.pairs.shape[1] != 2
        bad |= perm.shape != (npad,) or inv.shape != (n,)
        bad |= mask is not None and (mask.dim() != 2 or mask.shape[1] != words)
    if bad:
        raise ValueError(
            f"trop_relax planes disagree (tiles [NB, Tm, B, B] with B in {BLOCKS}, out another "
            f"buffer of dist's shape): tiles {tuple(tiles.shape)}, cb {tuple(cb.shape)}, dist "
            f"{tuple(dist.shape)}, active {tuple(active.shape)}, out {tuple(out.shape)}, "
            f"repair {None if repair is None else tuple(repair.bits.shape)} / "
            f"{None if repair is None else tuple(repair.pairs.shape)}, src "
            f"{None if src is None else tuple(src.shape)}, mask "
            f"{None if mask is None else tuple(mask.shape)}"
        )
    changed = torch.zeros(1, dtype=torch.int32, device=dist.device)
    active_out = torch.empty_like(active)
    _launch("trop_relax", tiles, cb, dist, active, rp[0], out, changed, active_out, nb, tm, b,
            lanes)
    if repair is not None and repair.pairs.shape[0]:
        _launch("trop_repair", repair.pairs, repair.pairs.shape[0], dist, src, cost, slot, mask,
                perm, inv, out, changed, active_out, b, lanes, k)
    return out, changed, active_out


class CountList(NamedTuple):
    """The count tiles of a fixpoint that can add something, fixed for all
    its rounds (:func:`count_list`)."""

    slots: torch.Tensor  # int32 [NB, Tm]: first, in slot order, the listed slots of each row block
    n: torch.Tensor  # int32 [NB]: how many each row block lists


def count_list(cnt: torch.Tensor, cb: torch.Tensor) -> CountList:
    """Each row block's real slots (``cb < NB``) whose count tile holds a
    nonzero entry, in slot order, at the front of its row of ``slots`` (the
    rest of the row is never read), and their number ``n``: the tiles a T2
    round walks (a zero tile adds 0).  A stable sort on the card, with no
    host sync; a fixpoint builds it once, after the count tiles."""
    if work.COUNTING:
        work.note("count_list", LIST_OPS * cnt.numel(), work.nbytes(cnt, cb, cb) + 4 * cb.shape[0])
    nb = cb.shape[0]
    listed = cnt.flatten(2).any(2) & (cb < nb)  # [NB, Tm]
    order = torch.sort(listed.to(torch.uint8), dim=1, descending=True, stable=True).indices
    return CountList(order.to(torch.int32), listed.sum(1, dtype=torch.int32))


def trop_count_plain(cnt, cb, listed, x, seed, out, root: int = -1):
    """One round of the multipath tile fixpoints (``_np_tile_fixpoint`` /
    ``_aw_tile_fixpoint``'s loop bodies): (out holding the new values [NB *
    B, A], changed int32 [1]).

    ``tot[rb * B + i, a]`` is the sum over the slots t whose source block
    ``cb[rb, t]`` is real and over j of ``cnt[rb, t, i, j] * x[cb * B + j,
    a]``, in int64 (exact: it is below 2**31); ``new = min(seed + tot,
    MP_SAT)`` (``seed`` None: 0), and 1 at the permuted row ``root`` (-1:
    none); written whole into ``out``; changed where ``new != x``.  It walks
    every slot: ``listed`` (the kernel's :class:`CountList`) is ignored."""
    nb, tm, b, _ = cnt.shape
    npad, lanes = x.shape
    real = cb < nb
    csafe = torch.where(real, cb, 0).long()
    xb = x.view(nb, b, lanes)
    tot = torch.zeros((nb, b, lanes), dtype=torch.int64, device=x.device)
    step = max(1, _TEMP // max(nb * b * b, 1))
    for s0 in range(0, lanes, step):
        sl = slice(s0, min(s0 + step, lanes))
        for t in range(tm):
            w = torch.where(real[:, t, None, None], cnt[:, t], 0).long()  # [NB, B(i), B(j)]
            src = xb[csafe[:, t]][:, :, sl].long()  # [NB, B(j), S']
            tot[:, :, sl] += (w[:, :, :, None] * src[:, None, :, :]).sum(2)
    tot = tot.view(npad, lanes)
    if seed is not None:
        tot = tot + seed.long()  # the int64 accumulator, as the products
    new = tot.clamp_max(MP_SAT).to(torch.int32)
    if root >= 0:
        new[root] = 1
    out.copy_(new)
    return out, (new != x).any().to(torch.int32).reshape(1)


def trop_count_round(cnt, cb, listed, x, seed, out, root: int = -1):
    """(out holding the new values [NB * B, A], changed int32 [1]): one
    round of the multipath tile fixpoints, see :func:`trop_count_plain`.  On
    the card the kernel (T2) walks only the tiles of ``listed``, which must be
    :func:`count_list` of ``cnt`` and ``cb``, writes ``out`` whole and
    accumulates in int32 (exact, as JAX's int32 einsum)."""
    lp = (None, None) if listed is None else tuple(listed)
    if work.COUNTING:
        lanes = x.shape[1]
        work.note("trop_count", COUNT_OPS * cnt.numel() * lanes + COUNT_CELL_OPS * x.numel(),
                  work.nbytes(cnt, cb, *lp, x, seed, out) + 4)
    if not build.on_card(cnt, cb, *lp, x, seed, out):
        return trop_count_plain(cnt, cb, listed, x, seed, out, root)
    nb, tm, b, b2 = cnt.shape if cnt.dim() == 4 else (0, 0, 0, -1)
    npad, lanes = x.shape if x.dim() == 2 else (-1, 0)
    bad = b != b2 or b not in BLOCKS or cb.shape != (nb, tm) or npad != nb * b
    bad |= listed is None or listed.slots.shape != (nb, tm) or listed.n.shape != (nb,)
    bad |= out.shape != x.shape or out.data_ptr() == x.data_ptr()
    bad |= seed is not None and seed.shape != x.shape
    bad |= not -1 <= root < npad
    if bad:
        raise ValueError(
            f"trop_count planes disagree (cnt [NB, Tm, B, B] with B in {BLOCKS}, the count "
            f"list [NB, Tm] and [NB], x [NB * B, A], seed None or x's shape, out another buffer "
            f"of x's shape, root -1 or a row): cnt {tuple(cnt.shape)}, cb {tuple(cb.shape)}, "
            f"list {None if listed is None else tuple(tuple(p.shape) for p in listed)}, "
            f"x {tuple(x.shape)}, seed {None if seed is None else tuple(seed.shape)}, out "
            f"{tuple(out.shape)}, root {root}"
        )
    changed = torch.zeros(1, dtype=torch.int32, device=x.device)
    _launch("trop_count", cnt, cb, *lp, x, seed, out, changed, nb, tm, b, lanes, int(root))
    return out, changed


def count_geometry(b: int, lanes: int, nb: int) -> dict:
    """T2's launch geometry at tile size ``b``, ``lanes`` lanes and ``nb``
    row blocks, read from the library (``holo_trop_count_info``): the form
    (``lane`` or ``row``), blocks, threads a block, shared bytes a block
    (static and dynamic), registers a thread, blocks an SM, lanes a block,
    rows a thread, listed tiles a chunk and (tile, column) pairs a pass (the
    last two 0 in the row form)."""
    info = (ctypes.c_int * 10)()
    lib = build.load()
    build.check(lib, lib.holo_trop_count_info(b, lanes, nb, info), "holo_trop_count_info")
    keys = ("form", "blocks", "threads", "shared_bytes", "registers", "blocks_per_sm",
            "lanes_a_block", "rows_a_thread", "tiles_a_chunk", "pairs_a_pass")
    out = dict(zip(keys, info))
    out["form"] = "lane" if out["form"] else "row"
    return out


def geometry(b: int, lanes: int, nb: int) -> dict:
    """The launch geometry of a round at tile size ``b``, ``lanes`` lanes and
    ``nb`` row blocks, read from the library (``holo_trop_info``): the form
    (``tile`` or ``row``), blocks, threads a block, dynamic shared bytes a
    block, registers a thread, blocks an SM, lanes and rows a thread, lanes
    a block, and the repair pass's registers a thread."""
    info = (ctypes.c_int * 10)()
    lib = build.load()
    build.check(lib, lib.holo_trop_info(b, lanes, nb, info), "holo_trop_info")
    keys = ("form", "blocks", "threads", "shared_bytes", "registers", "blocks_per_sm",
            "lanes_a_thread", "rows_a_thread", "lanes_a_block", "repair_registers")
    out = dict(zip(keys, info))
    out["form"] = "tile" if out["form"] else "row"
    return out
