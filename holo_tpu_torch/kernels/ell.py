"""The gather SPF engine's CUDA kernels, each beside its plain PyTorch version.

Four wrappers over ``csrc/ell_kernels.cu`` -- :func:`ell_relax`,
:func:`ell_first_parent`, :func:`ell_nh_seed`, :func:`ell_nh_round` -- one
per ``[N, K] x lanes`` step of the fixpoints in ``spf_one``, and two over
``csrc/mp_kernels.cu`` for the multipath program (``spf_one_multipath``):
:func:`ell_mp_round`, one row-frontier Jacobi round of hops, next hops,
path counts and per-atom weights over two ping-pong state buffers (without
the last two planes it is the hops + next-hop round of the incremental
path), and :func:`ell_parent_sets`, the first parent, the DAG bits and the
parent sets from one walk, and :func:`ell_parent_weights`, the sets' path
counts once the fixpoint has them; and one over ``csrc/fused_kernels.cu``,
:func:`ell_fused_round`, one Jacobi round of the ``fused`` / ``packed``
engines (every quantity of a row recomputed from one state).  In the JAX package
each step is an XLA loop fusion, not a Pallas kernel: the source files
name the lines each one stands for.  A wrapper given CPU tensors
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
- path counts [N, B] and per-atom weights [N, A, B] (A = 32 W), saturated
  at ``MP_SAT``; parent-set planes [N, Kp, B];
- ``frontier`` [N, ceil(B / 32)]: bit b % 32 of word [v, b // 32] set where
  lane b of row v changed in the previous round (or may have: a bit set
  where nothing changed only costs the kernel work).  :func:`ell_relax` and
  :func:`ell_nh_round` take one and return the next; their kernels gather
  only from the sources it marks, their plain versions ignore it and
  return exactly the changes of the full round.  :func:`ell_mp_round`
  takes one too, and its plain version honours it as the kernel does
  (:func:`mp_round_plain`; :func:`mp_round_full` is the full round).
  :func:`ell_fused_round` takes one and returns the next; its kernel
  recomputes only the rows :func:`fused_row_frontier` marks, its plain
  version ignores it.
"""

from __future__ import annotations

import ctypes

import torch

from holo_tpu_torch.kernels import build
from holo_tpu_torch.kernels.blocked import or_reduce

INF = 1 << 30
MP_SAT = 1 << 17  # ops.graph.MP_SAT
SMALL = 8  # lane counts up to this run the kernels' per-row form
_TEMP = 1 << 26  # elements of the largest [N, K, lanes] temporary of a plain version

#: kernel launches per wrapper since the last :func:`reset_launches`
launches = {"ell_relax": 0, "ell_first_parent": 0, "ell_nh_seed": 0, "ell_nh_round": 0,
            "ell_mp_round": 0, "ell_parent_sets": 0, "ell_parent_weights": 0,
            "ell_fused_round": 0}
#: ``ell_fused_round`` launches by state layout (their sum is its count above)
fused_layouts = {"planar": 0, "interleaved": 0}


def reset_launches() -> None:
    for counts in (launches, fused_layouts):
        for name in counts:
            counts[name] = 0


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


def full_frontier(n: int, lanes: int, device) -> torch.Tensor:
    """int32 [n, ceil(lanes / 32)]: every lane's bit set, the bits past
    ``lanes`` clear (``pack_lane_bits`` of all-true bools, in two ops)."""
    out = torch.full((n, mask_words(lanes)), -1, dtype=torch.int32, device=device)
    if lanes % 32:
        out[:, -1] = (1 << (lanes % 32)) - 1
    return out


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


def mp_round_full(src, dag, direct, inc, roots, parent, state):
    """One full Jacobi round of the multipath fixpoint (``_mp_fixpoint``'s
    body) from ``state`` = (hops, nh, npaths, aw), every value recomputed:
    (hops, nh, npaths, aw, changed int32 [1], frontier [N, ceil(B / 32)],
    the lanes of each row that changed in any plane).  Without ``npaths``
    and ``aw`` (None) the hops + next-hop round (``_hops_nh_fixpoint``),
    their outputs None.

    - hops: the first parent's hops plus ``inc`` (1 at a router), 0 at the
      lane's root, N + 1 without a parent or where the parent has N + 1;
    - next-hop words: per word, the OR of the slot's direct words over the
      DAG slots whose source has hops 0 and of the source's words over the
      other DAG slots (``_nh_words_round``);
    - npaths: ``min(sum over DAG slots of npaths[src], MP_SAT)``, 1 at the
      root;
    - aw: ``min(sum over DAG slots of (hops[src] == 0 ? npaths[src] on the
      slot's direct atoms : aw[src]), MP_SAT)``.

    The per-atom sums walk the slots one at a time, so no temporary is
    larger than [N, max(K, A), chunk] (chunk from :func:`lane_chunks`)."""
    hops, nh, npaths, aw = state
    n, k = src.shape
    lanes = hops.shape[1]
    words = direct.shape[2]
    big = n + 1
    dev = src.device
    s = src.long()
    is_root = torch.arange(n, device=dev)[:, None] == roots.long()[None, :]
    ext = torch.cat([hops, hops.new_full((1, lanes), big)])
    ph = torch.gather(ext, 0, torch.where((parent >= 0) & (parent < n), parent, n).long())
    hops_new = torch.where(is_root, 0, torch.where(ph < big, ph + inc[:, None], big))
    nh_new = torch.empty_like(nh)
    np_new = None if npaths is None else torch.empty_like(npaths)
    aw_new = None if aw is None else torch.empty_like(aw)
    atoms = 0 if aw is None else aw.shape[1]
    shift = torch.arange(32, dtype=torch.int32, device=dev)
    for sl in lane_chunks(n, max(k, atoms), lanes):
        dag_sl = _unpack(dag, sl)
        h_nbr = hops[:, sl][s]
        direct_slot = dag_sl & (h_nbr == 0)
        inherit_slot = dag_sl & (h_nbr != 0)
        for w in range(words):
            take = torch.where(direct_slot, direct[:, :, w, None],
                               torch.where(inherit_slot, nh[:, w, sl][s], 0))
            nh_new[:, w, sl] = or_reduce(take, 1)
        if npaths is None:
            continue
        np_nbr = torch.where(dag_sl, npaths[:, sl][s], 0)
        np_sum = np_nbr.sum(1, dtype=torch.int32)
        np_new[:, sl] = torch.where(is_root[:, sl], 1, torch.clamp_max(np_sum, MP_SAT))
        direct_np = torch.where(direct_slot, np_nbr, 0)
        aw_sl = aw[:, :, sl]
        acc = torch.zeros((n, atoms, sl.stop - sl.start), dtype=torch.int32, device=dev)
        for kk in range(k):
            onehot = ((direct[:, kk, :, None] >> shift) & 1).reshape(n, atoms)
            acc += onehot[:, :, None] * direct_np[:, kk, None, :]
            acc += torch.where(inherit_slot[:, kk, None, :], aw_sl[s[:, kk]], 0)
        aw_new[:, :, sl] = torch.clamp_max(acc, MP_SAT)
    new = (hops_new, nh_new, np_new, aw_new)
    moved = torch.zeros((n, lanes), dtype=torch.bool, device=dev)
    for x, y in zip(state, new):
        if x is not None:
            moved |= (y != x) if x.dim() == 2 else (y != x).any(1)
    return (*new, *_round_result(moved))


def mp_row_frontier(src, dag, frontier):
    """(recompute, copy) int32 [N, ceil(B / 32)]: the lanes of each row that
    a frontier round of ``ell_mp_round`` recomputes -- some DAG slot's
    source is marked in ``frontier``, or the row is marked and has no DAG
    slot in that lane (its value is then a constant: a seed there may be
    stale) -- and the other marked lanes, which it copies from its input."""
    has = or_reduce(dag, 1)
    rec = or_reduce(dag & frontier[src.long()], 1) | (frontier & ~has)
    return rec, frontier & ~rec


def mp_round_plain(src, dag, direct, inc, roots, parent, state, frontier, out):
    """One row-frontier round of the multipath fixpoint, as ``ell_mp_round``
    runs it: (changed int32 [1], frontier_out), and ``out`` = (hops, nh,
    npaths, aw) written in place.

    ``state`` holds the planes S of round r - 1, ``frontier`` the lanes of
    each row that changed in round r - 1 (or may have), ``out`` the planes
    of round r - 2.  The lanes that :func:`mp_row_frontier` marks for
    recompute get the full round's values (:func:`mp_round_full`), the
    other marked lanes a copy of ``state``; every other entry of ``out`` is
    left as it is, which is the round's value when ``frontier`` holds every
    change of round r - 1.  ``frontier_out`` marks the recomputed lanes
    whose value differs from ``state``."""
    full = mp_round_full(src, dag, direct, inc, roots, parent, state)
    lanes = state[0].shape[1]
    rec_w, copy_w = mp_row_frontier(src, dag, frontier)
    rec, keep = _unpack(rec_w, slice(0, lanes)), _unpack(copy_w, slice(0, lanes))
    moved = torch.zeros_like(rec)
    for x, y, o in zip(state, full[:4], out):
        if x is None:
            continue
        r, c = (rec, keep) if x.dim() == 2 else (rec[:, None, :], keep[:, None, :])
        moved |= rec & ((y != x) if x.dim() == 2 else (y != x).any(1))
        o.copy_(torch.where(r, y, torch.where(c, x, o)))
    return _round_result(moved)


def parent_sets_plain(src, cost, slot, mask, dist, npaths, roots, kp: int):
    """(parents, pdist, pweight) [N, kp, B]: ``_mp_parent_sets`` per lane.
    ``kp`` rounds of a masked lexicographic min of (path cost, source) over
    the admissible slots (usable, source reached, v reached and not the
    lane's root, and either tight, ``dist[src] + cost == dist[v]``, or
    strictly downward, ``dist[src] < dist[v]``); each round retires every
    slot of the source it emits.  Past the set: N, INF, 0."""
    n, k = src.shape
    lanes = dist.shape[1]
    dev = src.device
    shape = (n, kp, lanes)
    parents = torch.empty(shape, dtype=torch.int32, device=dev)
    pdist = torch.empty(shape, dtype=torch.int32, device=dev)
    pweight = torch.empty(shape, dtype=torch.int32, device=dev)
    src3 = src[:, :, None]
    for sl in lane_chunks(n, k, lanes):
        d_nbr = dist[:, sl][src.long()]
        dv = dist[:, sl][:, None, :]
        not_root = torch.arange(n, device=dev)[:, None, None] != roots[sl][None, None, :]
        ok = _usable(slot, mask, sl) & (d_nbr < INF) & (dv < INF) & not_root
        pathcost = d_nbr + cost[:, :, None]
        adm = ok & ((pathcost == dv) | (d_nbr < dv))
        pathcost = torch.where(adm, pathcost, INF)
        np_nbr = npaths[:, sl][src.long()]
        remaining = adm
        for r in range(kp):
            cmin = torch.where(remaining, pathcost, INF).amin(1)
            tie = remaining & (pathcost == cmin[:, None, :])
            smin = torch.where(tie, src3, n).amin(1)
            has = cmin < INF
            parents[:, r, sl] = torch.where(has, smin, n)
            pdist[:, r, sl] = torch.where(has, cmin, INF)
            sel = tie & (src3 == smin[:, None, :])
            pweight[:, r, sl] = torch.where(has, torch.where(sel, np_nbr, 0).amax(1), 0)
            remaining = remaining & (src3 != smin[:, None, :])
    return parents, pdist, pweight


def first_parent_sets_plain(src, cost, slot, mask, dist, roots, kp: int):
    """(parent [N, B], dag [N, K, ceil(B / 32)], parents, pdist [N, kp, B]):
    :func:`first_parent_plain`'s two outputs and the first two of
    :func:`parent_sets_plain`'s from one gather of ``dist[src]`` a lane
    chunk.  The DAG slots are the tight admissible ones, so both sets come
    from one test: usable, source reached, v reached and not the lane's
    root; then tight (the DAG), or strictly downward."""
    n, k = src.shape
    lanes = dist.shape[1]
    dev = src.device
    parent = torch.empty_like(dist)
    bits = torch.empty((n, k, mask_words(lanes)), dtype=torch.int32, device=dev)
    parents = torch.empty((n, kp, lanes), dtype=torch.int32, device=dev)
    pdist = torch.empty_like(parents)
    src3 = src[:, :, None]
    for sl in lane_chunks(n, k, lanes):
        d_nbr = dist[:, sl][src.long()]
        dv = dist[:, sl][:, None, :]
        not_root = torch.arange(n, device=dev)[:, None, None] != roots[sl][None, None, :]
        ok = _usable(slot, mask, sl) & (d_nbr < INF) & (dv < INF) & not_root
        pathcost = d_nbr + cost[:, :, None]
        dag = ok & (pathcost == dv)
        dmin = torch.where(dag, d_nbr, INF).amin(1)
        parent[:, sl] = torch.where(dag & (d_nbr == dmin[:, None, :]), src3, n).amin(1)
        bits[:, :, sl.start // 32 : mask_words(sl.stop)] = pack_lane_bits(dag)
        remaining = dag | (ok & (d_nbr < dv))
        pathcost = torch.where(remaining, pathcost, INF)
        for r in range(kp):
            cmin = torch.where(remaining, pathcost, INF).amin(1)
            smin = torch.where(remaining & (pathcost == cmin[:, None, :]), src3, n).amin(1)
            has = cmin < INF
            parents[:, r, sl] = torch.where(has, smin, n)
            pdist[:, r, sl] = torch.where(has, cmin, INF)
            remaining = remaining & (src3 != smin[:, None, :])
    return parent, bits, parents, pdist


def parent_weights_plain(parents, npaths):
    """pweight [N, kp, B]: ``npaths`` [N, B] of each parent-set entry in its
    lane, 0 past the set (parent N)."""
    n, kp, lanes = parents.shape
    ext = torch.cat([npaths, npaths.new_zeros((1, lanes))])
    return torch.gather(ext, 0, parents.reshape(n * kp, lanes).long()).reshape(n, kp, lanes)


def fused_planes(state):
    """(dist [N, B], hops [N, B], nh [N, W, B]) of a fused state: the planar
    tuple itself, or views of an interleaved [N, B, 2 + W] plane."""
    if torch.is_tensor(state):
        return state[:, :, 0], state[:, :, 1], state[:, :, 2:].permute(0, 2, 1)
    return state


def fused_state(dist, hops, nh, packed: bool):
    """The fused state of the three planes: the planar tuple, or (``packed``)
    one contiguous interleaved [N, B, 2 + W] plane."""
    if not packed:
        return dist, hops, nh
    return torch.cat([dist[:, :, None], hops[:, :, None], nh.permute(0, 2, 1)], 2).contiguous()


def fused_round_plain(src, cost, slot, mask, direct, inc, roots, state):
    """One Jacobi round of ``spf_one_fused`` (``round_fn``) for every lane:
    (new state in the layout of ``state``, parent [N, B], changed int32 [1],
    frontier_out [N, ceil(B / 32)]).

    ``state`` is (dist, hops, nh [N, W, B]) or one interleaved [N, B, 2 + W]
    plane (:func:`fused_planes`).  From the old planes:

    - dist' = min(dist, min over usable slots with dist[src] < INF of
      dist[src] + cost);
    - the DAG: those slots with dist' < INF and dist[src] + cost == dist'
      (the new distance, the old neighbour), v not the lane's root;
    - parent: the DAG slot's source minimizing (dist[src], src), N if none;
    - hops' (recomputed): 0 at the root, hops[parent] + ``inc`` where the
      parent exists and hops[parent] < N + 1, N + 1 elsewhere;
    - next-hop words: per word the OR over the DAG slots of the slot's
      direct word where the source's old hops is 0 and of the source's old
      word elsewhere (``_nh_words_round``).

    ``changed`` is set where dist', hops' or a word differs from the state,
    and ``frontier_out`` holds those (row, lane)s as lane bits
    (``pack_lane_bits``).  It takes no frontier: every row is recomputed
    and the parent returned fresh (see :func:`fused_row_frontier` for the
    rows the kernel recomputes)."""
    dist, hops, nh = fused_planes(state)
    n, k = src.shape
    lanes = dist.shape[1]
    big = n + 1
    dev = src.device
    s = src.long()
    is_root = torch.arange(n, device=dev)[:, None] == roots.long()[None, :]
    ext = torch.cat([hops, hops.new_full((1, lanes), big)])
    dist_new, parent = torch.empty_like(dist), torch.empty_like(dist)
    nh_new = torch.empty((n, nh.shape[1], lanes), dtype=torch.int32, device=dev)
    for sl in lane_chunks(n, k, lanes):
        d_nbr = dist[:, sl][s]
        h_nbr = hops[:, sl][s]
        usable = _usable(slot, mask, sl) & (d_nbr < INF)
        cand = d_nbr + cost[:, :, None]
        dn = torch.minimum(dist[:, sl], torch.where(usable, cand, INF).amin(1))
        dag = (usable & (dn < INF)[:, None, :] & (cand == dn[:, None, :])
               & ~is_root[:, None, sl])
        dmin = torch.where(dag, d_nbr, INF).amin(1)
        parent[:, sl] = torch.where(dag & (d_nbr == dmin[:, None, :]), src[:, :, None], n).amin(1)
        dist_new[:, sl] = dn
        direct_slot = dag & (h_nbr == 0)
        inherit_slot = dag & (h_nbr != 0)
        for w in range(nh.shape[1]):
            take = torch.where(direct_slot, direct[:, :, w, None],
                               torch.where(inherit_slot, nh[:, w, sl][s], 0))
            nh_new[:, w, sl] = or_reduce(take, 1)
    ph = torch.gather(ext, 0, parent.long())
    hops_new = torch.where(is_root, 0, torch.where((parent < n) & (ph < big),
                                                   ph + inc[:, None], big)).to(torch.int32)
    moved = (dist_new != dist) | (hops_new != hops) | (nh_new != nh).any(1)
    new = fused_state(dist_new, hops_new, nh_new, torch.is_tensor(state))
    return new, parent, *_round_result(moved)


def fused_row_frontier(src, slot, mask, frontier):
    """(recompute, copy) int32 [N, ceil(B / 32)]: the lanes of each row that
    a frontier round of ``ell_fused_round`` recomputes -- some valid slot
    whose edge is up in the lane has a source marked in ``frontier`` -- and
    the other marked lanes of the row, which it copies from its input."""
    fw = frontier[src.long()]
    if mask is not None:
        fw = fw & mask[slot.clamp_min(0).long()]
    rec = or_reduce(torch.where((slot >= 0)[:, :, None], fw, 0), 1)
    return rec, frontier & ~rec


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


def ell_mp_round(src, dag, direct, inc, roots, parent, state, frontier, out):
    """One row-frontier round of the multipath fixpoint over the DAG bits
    ``dag`` (``_mp_fixpoint``'s body, ``holo_tpu/ops/spf_engine.py:1281-1322``;
    with ``npaths`` and ``aw`` None the hops + next-hop round, ``:1211-1227``):
    (changed int32 [1], frontier_out), ``out`` written in place.  ``state``
    and ``out`` are (hops [N, B], nh [N, W, B], npaths [N, B] or None, aw [N,
    32 W, B] or None): the planes of the last round and of the round before
    it, where ``frontier`` marks every lane that changed between them.  See
    :func:`mp_round_plain`.  ``inc`` [N] is 1 at a router, ``parent`` [N, B]
    the first parent (N for none)."""
    if len(state) != 4 or len(out) != 4:
        raise ValueError("ell_mp_round takes (hops, nh, npaths, aw) in and out")
    if any((x is None) != (state[2] is None) for x in (*state[2:], *out[2:])):
        raise ValueError("ell_mp_round takes both npaths and aw, in and out, or neither")
    if not build.on_card(src, dag, direct, inc, roots, parent, *state, frontier, *out):
        return mp_round_plain(src, dag, direct, inc, roots, parent, state, frontier, out)
    n, k = src.shape
    hops, nh, npaths, aw = state
    lanes = hops.shape[1]
    words = direct.shape[2] if direct.dim() == 3 else -1
    bad = dag.shape != (n, k, mask_words(lanes)) or direct.shape != (n, k, words)
    bad |= inc.shape != (n,) or roots.shape != (lanes,) or parent.shape != (n, lanes)
    for x, o in zip(state, out):
        bad |= x is not None and o.shape != x.shape
    bad |= hops.shape != (n, lanes) or nh.shape != (n, words, lanes)
    if npaths is not None:
        bad |= npaths.shape != (n, lanes) or aw.shape != (n, 32 * words, lanes)
    if bad:
        raise ValueError(
            f"mp_round planes disagree: src {tuple(src.shape)}, dag {tuple(dag.shape)}, "
            f"direct {tuple(direct.shape)}, inc {tuple(inc.shape)}, roots "
            f"{tuple(roots.shape)}, parent {tuple(parent.shape)}, state "
            f"{[None if x is None else tuple(x.shape) for x in state]}, out "
            f"{[None if x is None else tuple(x.shape) for x in out]}"
        )
    _check_frontier(frontier, n, lanes)
    changed = torch.zeros(1, dtype=torch.int32, device=hops.device)
    front_out = torch.empty_like(frontier)
    # The tile form's plan: the (recompute, copy) words of each (row, tile).
    plan = torch.empty(2 * frontier.numel() if lanes > SMALL else 0, dtype=torch.int32,
                       device=hops.device)
    _launch("ell_mp_round", src, dag, direct, inc, roots, parent, *state, frontier, *out,
            changed, front_out, plan, n, k, lanes, words)
    return changed, front_out


def ell_parent_sets(src, cost, slot, mask, dist, roots, kp: int):
    """(parent [N, B], dag [N, K, ceil(B / 32)], parents, pdist [N, kp, B]):
    :func:`ell_first_parent`'s outputs and, per (vertex, lane), the ``kp``
    smallest (path cost, source) pairs over the admissible slots, one per
    source at its cheapest slot; N, INF past the set (``_sp_dag`` +
    ``_first_parent``, ``holo_tpu/ops/spf_engine.py:872-894``, and
    ``_mp_parent_sets`` without ``pweight``, ``:1327-1372``), from one walk
    over the slots.  See :func:`first_parent_sets_plain`."""
    if kp not in (2, 4, 8):
        raise ValueError(f"kp={kp}: parent sets are 2, 4 or 8 wide (mp_pad past single path)")
    if not build.on_card(src, cost, slot, mask, dist, roots):
        return first_parent_sets_plain(src, cost, slot, mask, dist, roots, kp)
    n, k = src.shape
    lanes = dist.shape[1]
    _check_planes(src, cost, slot, mask, lanes, plane=dist, roots=roots)
    parent = torch.empty_like(dist)
    dag = torch.empty((n, k, mask_words(lanes)), dtype=torch.int32, device=dist.device)
    parents = torch.empty((n, kp, lanes), dtype=torch.int32, device=dist.device)
    pdist = torch.empty_like(parents)
    _launch("ell_parent_sets", src, cost, slot, mask, dist, roots, parent, dag, parents, pdist,
            n, k, lanes, kp)
    return parent, dag, parents, pdist


def ell_parent_weights(parents, npaths):
    """pweight [N, kp, B]: ``npaths[parents[v, i, b], b]``, 0 past the set
    (``_mp_parent_sets``' pweight, ``holo_tpu/ops/spf_engine.py:1361-1366``,
    which needs the fixpoint's path counts).  See :func:`parent_weights_plain`."""
    if not build.on_card(parents, npaths):
        return parent_weights_plain(parents, npaths)
    n, kp, lanes = parents.shape
    if npaths.shape != (n, lanes):
        raise ValueError(f"npaths {tuple(npaths.shape)} is not [{n}, {lanes}] for parents "
                         f"{tuple(parents.shape)}")
    pweight = torch.empty_like(parents)
    _launch("ell_parent_weights", parents, npaths, pweight, n, kp, lanes)
    return pweight


def fused_geometry(state, out) -> dict:
    """What ``ell_fused_round`` launches from ``state`` into ``out`` (CUDA
    tensors), as the built library decides it for the launch: the form
    (``row``, a warp a row and all its lanes, or ``tile``), the 32-lane
    tiles a warp of the tile form takes, whether an interleaved lane's
    vector is one int4 load and the kernel's registers a thread."""
    packed = torch.is_tensor(state)
    dist, _, nh = fused_planes(state)
    dest = out if packed else out[0]
    info = (ctypes.c_int * 3)()
    lib = build.load()
    build.check(lib, lib.holo_ell_fused_info(dist.shape[1], nh.shape[1], int(packed),
                                             dist.data_ptr(), dest.data_ptr(), info),
                "holo_ell_fused_info")
    return {"form": "tile" if info[0] else "row", "tiles": info[0], "vec4": bool(info[1]),
            "registers": info[2]}


def ell_fused_round(src, cost, slot, mask, direct, inc, roots, state, frontier, parent, out):
    """(new state, parent [N, B], changed int32 [1], frontier_out): one round
    of the fused fixpoint (``round_fn`` of ``spf_one_fused``,
    ``holo_tpu/ops/spf_engine.py:1071-1106``), see :func:`fused_round_plain`.
    ``state`` is planar, (dist [N, B], hops [N, B], nh [N, W, B]) (the
    ``fused`` engine), or one interleaved [N, B, 2 + W] plane (``packed``);
    ``direct`` [N, K, W], ``inc`` [N] (1 at a router), ``roots`` [B].

    ``frontier`` [N, ceil(B / 32)] marks the (row, lane)s that changed in the
    round that made ``state`` (all ones before the first round); ``out`` (the
    state's layout and shapes, another buffer: the fixpoint loop ping-pongs
    two) holds the state before that round, and ``parent`` [N, B] the parent
    that round returned.  On the card the kernel recomputes only the (row,
    lane)s of :func:`fused_row_frontier`, copies the other marked ones from
    ``state`` into ``out`` and leaves the rest of ``out`` as it is; it
    writes the recomputed lanes' parents into ``parent`` in place.  On the
    CPU ``frontier``, ``parent`` and ``out`` are not used."""
    packed = torch.is_tensor(state)
    planes = (state,) if packed else tuple(state)
    outs = (out,) if packed else tuple(out)
    if not build.on_card(src, cost, slot, mask, direct, inc, roots, *planes, frontier, parent,
                         *outs):
        return fused_round_plain(src, cost, slot, mask, direct, inc, roots, state)
    n, k = src.shape
    dist, hops, nh = fused_planes(state)
    lanes = dist.shape[1]
    words = direct.shape[2] if direct.dim() == 3 else -1
    _check_planes(src, cost, slot, mask, lanes, roots=roots)
    _check_frontier(frontier, n, lanes)
    bad = direct.shape != (n, k, words) or inc.shape != (n,) or parent.shape != (n, lanes)
    if packed:
        bad |= state.shape != (n, lanes, 2 + words)
    else:
        bad |= len(planes) != 3 or hops.shape != (n, lanes) or nh.shape != (n, words, lanes)
        bad |= dist.shape != (n, lanes)
    bad |= len(outs) != len(planes) or any(o.shape != x.shape for o, x in zip(outs, planes))
    ptrs = [x.data_ptr() for x in planes]
    bad |= any(o.data_ptr() in ptrs for o in outs) or parent.data_ptr() in ptrs
    bad |= any(o.data_ptr() == parent.data_ptr() for o in outs)
    if bad:
        raise ValueError(
            f"fused_round planes disagree: src {tuple(src.shape)}, direct "
            f"{tuple(direct.shape)}, inc {tuple(inc.shape)}, state "
            f"{[tuple(x.shape) for x in planes]}, out {[tuple(o.shape) for o in outs]}, "
            f"parent {tuple(parent.shape)} (out and parent must each be another buffer, out "
            f"of the state's shapes)"
        )
    changed = torch.zeros(1, dtype=torch.int32, device=src.device)
    front_out = torch.empty_like(frontier)
    ins = (state, None, None) if packed else planes
    dests = (outs[0], None, None) if packed else outs
    _launch("ell_fused_round", src, cost, slot, mask, direct, inc, roots, *ins, frontier, *dests,
            parent, changed, front_out, n, k, lanes, words, int(packed))
    fused_layouts["interleaved" if packed else "planar"] += 1
    return (outs[0] if packed else outs), parent, changed, front_out
