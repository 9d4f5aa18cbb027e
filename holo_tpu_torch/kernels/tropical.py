"""The tropical engine's CUDA kernel, beside its plain PyTorch version.

One wrapper over ``csrc/tropical_kernels.cu``, :func:`trop_relax` (T1): one
round of the blocked min-plus fixpoint of ``holo_tpu/ops/tropical.py``
(``_tile_relax``'s loop body, ``:423-464``, an XLA fusion in the JAX package,
not a Pallas kernel).  A wrapper given CPU tensors computes the plain
version (:func:`trop_relax_plain`); given CUDA tensors it launches the kernel
on the current stream or raises.  It never falls back.  :data:`launches`
counts kernel launches.

Planes (all int32, INF = 1 << 30 unreachable; the vertex space is the
tiles' permuted one, padded to NB * B rows):

- ``tiles`` [NB, Tm, B, B]: ``tiles[rb, t, i, j]`` the least cost of an edge
  ``cb[rb, t] * B + j -> rb * B + i``, INF where there is none;
- ``cb`` [NB, Tm]: the source block of each slot, NB for a padding slot;
- ``dist`` [NB * B, S]: the lanes' distances, lanes minor;
- ``active`` [NB, ceil(S / 32)]: bit s % 32 of word [c, s // 32] set where
  a row of block c changed in lane s in the round before (the frontier);
- ``repair`` [NB * B, ceil(S / 32)] or None: bit s set where the row's value
  in lane s is the exact masked ELL row relax instead of the tiles' (a row
  one of whose in-edges is down in the lane); it reads the ELL planes
  ``src``, ``cost``, ``slot`` [N, K] (slot: the edge id, -1 for padding),
  the mask words ``mask`` [E, ceil(S / 32)] (None: every edge up), ``perm``
  [NB * B] (permuted row -> vertex) and ``inv`` [N] (vertex -> permuted
  row), as the gather kernels do (``kernels/ell.py``).
"""

from __future__ import annotations

import torch

from holo_tpu_torch.kernels import build
from holo_tpu_torch.kernels.ell import (
    _round_result,
    _unpack,
    _usable,
    lane_chunks,
    mask_words,
)

INF = 1 << 30
BLOCKS = (8, 16, 32, 64, 128)  # the tile sizes the kernel is built for
_TEMP = 1 << 26  # elements of the largest [NB, B, B, lanes] temporary of the plain version

#: kernel launches since the last :func:`reset_launches`
launches = {"trop_relax": 0}


def reset_launches() -> None:
    launches["trop_relax"] = 0


def trop_relax_plain(tiles, cb, dist, active, repair=None, src=None, cost=None, slot=None,
                     mask=None, perm=None, inv=None):
    """One round of ``_tile_relax``: (new [NB * B, S], changed int32 [1],
    active_out [NB, ceil(S / 32)]).

    ``agg[rb * B + i, s]`` is the least ``tiles[rb, t, i, j] + dist[cb * B +
    j, s]`` over the slots t whose source block ``cb[rb, t]`` is real and
    active in lane s and over j, the sum saturated at INF (INF + INF does not
    fit int32, so the sums are taken in int64).  Where ``repair`` has the
    bit of (row, lane), the exact masked ELL relax of the row's vertex
    replaces ``agg``: the least ``dist[inv[src], s] + cost`` over its usable
    slots whose source is reached.  Then ``new = min(dist, agg)``;
    ``active_out`` marks the (block, lane)s where a row changed."""
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
    if repair is not None:
        bits = _unpack(repair, slice(0, lanes))  # [NB * B, S]
        rows = bits.any(1).nonzero()[:, 0]
        if rows.numel():
            v = perm[rows].long()
            vsrc = inv[src[v].long()].long()  # [R, K] permuted sources
            vslot, vcost = slot[v], cost[v]
            for sl in lane_chunks(*vsrc.shape, lanes):
                dn = dist[:, sl][vsrc]  # [R, K, S']
                ok = _usable(vslot, mask, sl) & (dn < INF)
                cr = torch.where(ok, dn + vcost[:, :, None], INF).amin(1)
                agg[rows, sl] = torch.where(bits[rows][:, sl], cr, agg[rows, sl])
    new = torch.minimum(dist, agg)
    return new, *_round_result((new != dist).view(nb, b, lanes).any(1))


def _launch(name: str, *args) -> None:
    """Launch ``holo_<name>`` (raises on a CUDA error) and count it."""
    build.launch(f"holo_{name}", *args)
    launches[name] += 1


def trop_relax(tiles, cb, dist, active, repair=None, src=None, cost=None, slot=None, mask=None,
               perm=None, inv=None):
    """(new [NB * B, S], changed int32 [1], active_out [NB, ceil(S / 32)]):
    one round of the tile relax, see :func:`trop_relax_plain`.  The ELL
    planes, ``mask``, ``perm`` and ``inv`` are read only for the rows of
    ``repair`` (None: no row is repaired)."""
    planes = (tiles, cb, dist, active, repair, src, cost, slot, mask, perm, inv)
    if not build.on_card(*planes):
        return trop_relax_plain(*planes)
    nb, tm, b, b2 = tiles.shape if tiles.dim() == 4 else (0, 0, 0, -1)
    npad, lanes = dist.shape
    words = mask_words(lanes)
    bad = b != b2 or b not in BLOCKS or cb.shape != (nb, tm) or npad != nb * b
    bad |= active.shape != (nb, words)
    k = 0
    if repair is not None:
        n, k = src.shape
        bad |= repair.shape != (npad, words) or cost.shape != (n, k) or slot.shape != (n, k)
        bad |= perm.shape != (npad,) or inv.shape != (n,)
        bad |= mask is not None and (mask.dim() != 2 or mask.shape[1] != words)
    if bad:
        raise ValueError(
            f"trop_relax planes disagree (tiles [NB, Tm, B, B] with B in {BLOCKS}): tiles "
            f"{tuple(tiles.shape)}, cb {tuple(cb.shape)}, dist {tuple(dist.shape)}, active "
            f"{tuple(active.shape)}, repair {None if repair is None else tuple(repair.shape)}, "
            f"src {None if src is None else tuple(src.shape)}, mask "
            f"{None if mask is None else tuple(mask.shape)}"
        )
    out = torch.empty_like(dist)
    changed = torch.zeros(1, dtype=torch.int32, device=dist.device)
    active_out = torch.empty_like(active)
    _launch("trop_relax", tiles, cb, dist, active, repair, src, cost, slot, mask, perm, inv,
            out, changed, active_out, nb, tm, b, lanes, k)
    return out, changed, active_out
