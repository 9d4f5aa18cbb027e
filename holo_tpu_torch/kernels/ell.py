"""The gather SPF engine's CUDA kernels, each beside its plain PyTorch version.

Four wrappers over ``csrc/ell_kernels.cu`` -- :func:`ell_relax`,
:func:`ell_first_parent`, :func:`ell_nh_seed`, :func:`ell_nh_round` -- one
per ``[N, K] x lanes`` step of the fixpoints in ``spf_one``.  In the JAX
package each step is an XLA loop fusion, not a Pallas kernel: the source
file names the lines each one stands for.  A wrapper given CPU tensors
computes the plain version; given CUDA tensors it launches the kernel on the
current stream or raises.  It never falls back.  :data:`launches` counts
kernel launches per wrapper.

Plane conventions (all int32, INF = 1 << 30 as unreachable):

- ``src``, ``cost`` [N, K]: the ELL in-edge planes (``in_src``,
  ``in_cost``);
- ``slot`` [N, K]: the slot's original edge id, -1 where the slot is
  padding (``in_edge_id`` where ``in_valid``);
- ``mask`` [E, ceil(B / 32)] or None: scenario edge masks as bit words,
  bit ``b % 32`` of word ``[e, b // 32]`` set where edge e is up in lane b
  (``ops.spf_engine.pack_edge_masks``).  None means every edge is up.
  Slot (v, k) is usable in lane b iff ``slot >= 0`` and that bit is set
  (JAX's ``_slot_mask``);
- vertex planes are [N, B] with the lanes (scenarios or roots) minor;
  next-hop planes are [N, W, B] (uint32 words as int32 bit patterns);
- ``dag`` [N, K, ceil(B / 32)]: bit b of word [v, k, b // 32] set where
  slot (v, k) is a DAG in-edge of v in lane b (JAX's ``_sp_dag``), written
  by :func:`ell_first_parent`; bits past B are 0;
- ``hop0`` [N, ceil(B / 32)]: bit b of word [u, b // 32] set where vertex u
  has hops 0 in lane b (``pack_lane_bits(hops == 0)``);
- ``inherit`` [N, K, ceil(B / 32)]: ``dag & ~hop0[src]``, the DAG slots
  whose source has hops != 0 (written by :func:`ell_nh_seed`);
- ``frontier`` [N, ceil(B / 32)]: bit b % 32 of word [v, b // 32] set where
  lane b of row v changed in the previous round (or may have: a bit set
  where nothing changed only costs the kernel work).  :func:`ell_relax` and
  :func:`ell_nh_round` take one and return the next; their kernels gather
  only from the sources it marks, their plain versions ignore it and
  return exactly the changes of the full round.
"""

from __future__ import annotations

import torch

from holo_tpu_torch.kernels import build
from holo_tpu_torch.kernels.blocked import or_reduce

INF = 1 << 30
SMALL = 8  # lane counts up to this run the kernels' per-row form
_TEMP = 1 << 26  # elements of the largest [N, K, lanes] temporary of a plain version

#: kernel launches per wrapper since the last :func:`reset_launches`
launches = {"ell_relax": 0, "ell_first_parent": 0, "ell_nh_seed": 0, "ell_nh_round": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def mask_words(lanes: int) -> int:
    """Bit words per edge (or slot) for ``lanes`` lanes."""
    return (lanes + 31) // 32


def _check_frontier(frontier, n: int, lanes: int) -> None:
    if frontier.shape != (n, mask_words(lanes)):
        raise ValueError(
            f"frontier {tuple(frontier.shape)} is not [{n}, {mask_words(lanes)}] "
            f"for {n} rows and {lanes} lanes"
        )


def _check_planes(src, cost, slot, mask, lanes: int, plane=None, roots=None) -> None:
    n, k = src.shape
    bad = cost.shape != (n, k) or slot.shape != (n, k)
    bad |= mask is not None and (mask.dim() != 2 or mask.shape[1] != mask_words(lanes))
    bad |= plane is not None and plane.shape != (n, lanes)
    if bad or (roots is not None and roots.shape != (lanes,)):
        raise ValueError(
            f"ELL planes disagree: src {tuple(src.shape)}, cost {tuple(cost.shape)}, "
            f"slot {tuple(slot.shape)}, mask "
            f"{None if mask is None else tuple(mask.shape)}, vertex plane "
            f"{None if plane is None else tuple(plane.shape)}, roots "
            f"{None if roots is None else tuple(roots.shape)} for {lanes} lanes"
        )


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path, and the card's reference).  Each
# walks the lanes in chunks (multiples of 32) so that no [N, K, chunk]
# temporary exceeds _TEMP elements.


def lane_chunks(n: int, k: int, lanes: int):
    """Lane slices (multiples of 32) that keep [N, K, chunk] under _TEMP."""
    step = max(32, (_TEMP // max(n * k, 1)) // 32 * 32)
    for b0 in range(0, lanes, step):
        yield slice(b0, min(b0 + step, lanes))


def _usable(slot, mask, sl: slice):
    """bool [N, K, chunk]: slot usable in the lanes of ``sl``."""
    valid = (slot >= 0)[:, :, None]
    if mask is None:
        return valid
    lane = torch.arange(sl.start, sl.stop, device=slot.device)
    words = mask[slot.clamp_min(0).long()][:, :, lane // 32]
    return valid & (((words >> (lane % 32)) & 1) != 0)


def dag_slots(src, cost, slot, mask, dist, roots, sl: slice):
    """(dag [N, K, chunk], d_nbr): JAX's ``_sp_dag`` per lane of ``sl``."""
    n = src.shape[0]
    d_nbr = dist[:, sl][src.long()]
    dv = dist[:, sl][:, None, :]
    not_root = torch.arange(n, device=src.device)[:, None, None] != roots[sl][None, None, :]
    dag = (
        _usable(slot, mask, sl)
        & (d_nbr < INF)
        & (dv < INF)
        & (d_nbr + cost[:, :, None] == dv)
        & not_root
    )
    return dag, d_nbr


def pack_lane_bits(bits: torch.Tensor) -> torch.Tensor:
    """bool [..., L] -> int32 [..., ceil(L / 32)]: bit l % 32 of word l // 32.

    Bytes are assembled as the sum of their bits shifted into place and read
    as little-endian int32 words (byte j of a word holds its bits 8j .. 8j +
    7), as both the host and the card store them.
    """
    *lead, lanes = bits.shape
    if lanes == 0:
        return torch.zeros((*lead, 0), dtype=torch.int32, device=bits.device)
    padded = mask_words(lanes) * 32
    b = bits.to(torch.uint8)
    if padded != lanes:
        b = torch.cat([b, b.new_zeros((*lead, padded - lanes))], dim=-1)
    shift = torch.arange(8, dtype=torch.uint8, device=bits.device)
    byte = (b.reshape(*lead, padded // 8, 8) << shift).sum(-1, dtype=torch.uint8)
    return byte.view(torch.int32)


def _unpack(words, sl: slice):
    """bool [..., chunk]: the bits of ``sl``'s lanes from int32 [..., words]."""
    lane = torch.arange(sl.start, sl.stop, device=words.device)
    return ((words[..., lane // 32] >> (lane % 32)) & 1) != 0


def _round_result(moved: torch.Tensor):
    """(changed int32 [1], frontier [N, ceil(B / 32)]) of a round whose
    changed elements are ``moved`` (bool [N, B])."""
    return moved.any().to(torch.int32).reshape(1), pack_lane_bits(moved)


def relax_plain(src, cost, slot, mask, dist, frontier=None):
    """One full Jacobi Bellman-Ford round: (out, changed int32 [1],
    frontier_out).  ``frontier`` is ignored: every source is gathered."""
    out = dist.clone()
    for sl in lane_chunks(*src.shape, dist.shape[1]):
        d_nbr = dist[:, sl][src.long()]
        ok = _usable(slot, mask, sl) & (d_nbr < INF)
        cand = torch.where(ok, d_nbr + cost[:, :, None], INF).amin(1)
        out[:, sl] = torch.minimum(dist[:, sl], cand)
    return out, *_round_result(out != dist)


def first_parent_plain(src, cost, slot, mask, dist, roots):
    """(parent [N, B], dag [N, K, ceil(B / 32)]): the DAG parent minimizing
    (dist[u], u) per lane, N where none, and the DAG bits."""
    n, k = src.shape
    lanes = dist.shape[1]
    parent = torch.empty_like(dist)
    bits = torch.empty((n, k, mask_words(lanes)), dtype=torch.int32, device=dist.device)
    for sl in lane_chunks(n, k, lanes):
        dag, d_nbr = dag_slots(src, cost, slot, mask, dist, roots, sl)
        dmin = torch.where(dag, d_nbr, INF).amin(1)
        at_min = dag & (d_nbr == dmin[:, None, :])
        parent[:, sl] = torch.where(at_min, src[:, :, None], n).amin(1)
        bits[:, :, sl.start // 32 : mask_words(sl.stop)] = pack_lane_bits(dag)
    return parent, bits


def nh_seed_plain(src, dag, hop0, direct, lanes: int):
    """(seed [N, W, lanes], inherit [N, K, ceil(lanes / 32)]): per lane, the
    OR of the direct words over the DAG slots whose source has hops 0
    (``dag & hop0[src]``), and the bits of the other DAG slots."""
    n, k = src.shape
    words = direct.shape[2]
    h = hop0[src.long()]  # [N, K, ceil(lanes / 32)]
    direct_bits = dag & h
    seed = torch.empty((n, words, lanes), dtype=torch.int32, device=dag.device)
    for sl in lane_chunks(n, k, lanes):
        direct_slot = _unpack(direct_bits, sl)
        for w in range(words):
            seed[:, w, sl] = or_reduce(torch.where(direct_slot, direct[:, :, w, None], 0), 1)
    return seed, dag & ~h


def nh_round_plain(src, inherit, nh, frontier=None):
    """One full Jacobi round ``nh | OR nh[src]`` over the inherit slots:
    (out, changed int32 [1], frontier_out, the OR over words of out != nh).
    ``frontier`` is ignored: every inherit source is gathered."""
    out = nh.clone()
    for sl in lane_chunks(*src.shape, nh.shape[2]):
        use = _unpack(inherit, sl)
        for w in range(nh.shape[1]):
            gathered = nh[:, w, sl][src.long()]
            out[:, w, sl] |= or_reduce(torch.where(use, gathered, 0), 1)
    return out, *_round_result((out != nh).any(1))


# ---------------------------------------------------------------------------
# Wrappers: CPU tensors -> plain version; CUDA tensors -> the kernel.


def _launch(name: str, *args) -> None:
    """Launch ``holo_<name>`` (raises on a CUDA error) and count it."""
    build.launch(f"holo_{name}", *args)
    launches[name] += 1


def ell_relax(src, cost, slot, mask, dist, frontier):
    """(new [N, B], changed int32 [1], frontier_out): new[v, b] = min(dist[v,
    b], min over usable slots with dist[src] < INF of dist[src, b] + cost)
    (``spf_engine.py:860-866``); the kernel gathers only sources marked in
    ``frontier``, which must hold every change of the round that made
    ``dist``."""
    if not build.on_card(src, cost, slot, mask, dist, frontier):
        return relax_plain(src, cost, slot, mask, dist, frontier)
    n, lanes = dist.shape
    _check_planes(src, cost, slot, mask, lanes, plane=dist)
    _check_frontier(frontier, n, lanes)
    out = torch.empty_like(dist)
    changed = torch.zeros(1, dtype=torch.int32, device=dist.device)
    front_out = torch.empty_like(frontier)
    _launch("ell_relax", src, cost, slot, mask, dist, frontier, out, changed, front_out,
            *src.shape, lanes)
    return out, changed, front_out


def ell_first_parent(src, cost, slot, mask, dist, roots):
    """(parent [N, B], dag [N, K, ceil(B / 32)]): the DAG in-edge source u
    minimizing (dist[u, b], u), N where v has none or is lane b's root, and
    the DAG bits (``_sp_dag`` + ``_first_parent``, ``spf_engine.py:872-894``)."""
    if not build.on_card(src, cost, slot, mask, dist, roots):
        return first_parent_plain(src, cost, slot, mask, dist, roots)
    n, k = src.shape
    lanes = dist.shape[1]
    _check_planes(src, cost, slot, mask, lanes, plane=dist, roots=roots)
    parent = torch.empty_like(dist)
    dag = torch.empty((n, k, mask_words(lanes)), dtype=torch.int32, device=dist.device)
    _launch("ell_first_parent", src, cost, slot, mask, dist, roots, parent, dag, n, k, lanes)
    return parent, dag


def ell_nh_seed(src, dag, hop0, direct, lanes: int):
    """(seed [N, W, lanes], inherit [N, K, ceil(lanes / 32)]): per lane, the
    OR of ``direct`` [N, K, W] over the DAG slots whose source has hops 0,
    and the bits of the other DAG slots, ``dag & ~hop0[src]``
    (``spf_engine.py:976-991``).  ``lanes`` is B, which the bit planes round
    up to words."""
    if not build.on_card(src, dag, hop0, direct):
        return nh_seed_plain(src, dag, hop0, direct, lanes)
    n, k = src.shape
    words = mask_words(lanes)
    if (dag.shape != (n, k, words) or hop0.shape != (n, words) or direct.dim() != 3
            or direct.shape[:2] != (n, k)):
        raise ValueError(
            f"nh_seed planes disagree: src {tuple(src.shape)}, dag {tuple(dag.shape)}, "
            f"hop0 {tuple(hop0.shape)}, direct {tuple(direct.shape)} for {lanes} lanes"
        )
    nwords = direct.shape[2]
    seed = torch.empty((n, nwords, lanes), dtype=torch.int32, device=dag.device)
    inherit = torch.empty_like(dag)
    _launch("ell_nh_seed", src, dag, hop0, direct, seed, inherit, n, k, lanes, nwords)
    return seed, inherit


def ell_nh_round(src, inherit, nh, frontier):
    """(new [N, W, B], changed int32 [1], frontier_out): new = nh | OR of
    nh[src] over the slots whose ``inherit`` bit is set, all words in one
    round (``spf_engine.py:993-1005``); the kernel gathers only sources
    marked in ``frontier`` (changes in any word)."""
    if not build.on_card(src, inherit, nh, frontier):
        return nh_round_plain(src, inherit, nh, frontier)
    n, k = src.shape
    words, lanes = nh.shape[1], nh.shape[2]
    if nh.shape[0] != n or inherit.shape != (n, k, mask_words(lanes)):
        raise ValueError(
            f"nh_round planes disagree: src {tuple(src.shape)}, inherit "
            f"{tuple(inherit.shape)}, nh {tuple(nh.shape)}"
        )
    _check_frontier(frontier, n, lanes)
    out = torch.empty_like(nh)
    changed = torch.zeros(1, dtype=torch.int32, device=nh.device)
    front_out = torch.empty_like(frontier)
    _launch("ell_nh_round", src, inherit, nh, frontier, out, changed, front_out, n, k,
            lanes, words)
    return out, changed, front_out
