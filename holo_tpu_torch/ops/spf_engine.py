"""The gather SPF engine: exact int32 SSSP + ECMP next-hop extraction.

Port of the default engine of ``holo_tpu/ops/spf_engine.py`` (``spf_one``,
``one_engine="seq"``), with its batched forms ``spf_whatif_batch`` (lanes
carry scenario edge masks) and ``spf_multiroot`` (lanes carry roots).  The
fixpoints over the ELL in-edge layout are the same:

1. distances: Jacobi Bellman-Ford rounds (kernel ``ell_relax``), each of
   which gathers only from the sources the previous round changed (a
   frontier plane of lane bits carried from round to round);
2. first parent: the DAG in-edge source minimizing (dist[u], u), the
   reference's candidate pop order (holo-ospf/src/spf.rs:614-622)
   (``ell_first_parent``, which also returns the DAG as lane bits: the DAG
   test runs once a dispatch);
3. hops along the first-parent chain (plain torch: one gather of
   ``hops[parent]`` a round);
4. ECMP next-hop words: the direct atoms of DAG parents with hops 0 seed
   the words and the other DAG parents become inherit bits (``ell_nh_seed``,
   from the DAG bits and the lane bits of hops 0), then Jacobi OR rounds
   inherit their sets (``ell_nh_round``, with its own frontier).

The multipath program (``spf_one_multipath``, ``spf_multipath_batch``,
``spf_one_incremental_multipath``) runs step 1, then ``ell_parent_sets``
(step 2's first parent and DAG bits and the parent sets, from one walk),
then one joint Jacobi fixpoint of hops, next-hop words, saturated path
counts and per-atom UCMP weights (``ell_mp_round``, JAX's
``_mp_fixpoint``: one changed flag over the four planes, so truncated runs
stop where JAX's do; each round recomputes only the rows whose DAG
sources changed in the round before), then the parent weights
(``ell_parent_weights``, one gather of the path counts).

The other formulations of ``spf_one`` (``one_engine`` and the engine tuner
pick among them; all four agree at the fixpoint, and each follows its JAX
counterpart round for round under ``max_iters``):

- ``fused`` / ``packed`` (``spf_one_fused``, :func:`fused_lanes`): one
  Jacobi loop of ``ell_fused_round``, which recomputes dist, the DAG, the
  parent, hops and the next-hop words of a row from one state (three
  planes, or one interleaved [N, B, 2 + W] plane for ``packed``) in the
  lanes where one of its sources changed the round before, at most 3N + 6
  rounds;
- ``hybrid`` (``spf_one_hybrid``, :func:`hybrid_lanes`): step 1, then
  ``ell_first_parent`` once, then the joint hops + next-hop fixpoint
  (``ell_mp_round`` without the count and weight planes) from fresh seeds.

``torch.vmap`` cannot carry the data-dependent loops, so one program runs
every lane at once, with the lanes on the minor axis of [N, B] planes (the
reverse of JAX's [B, N]); the public functions return JAX's layout.  Each
fixpoint is a Python loop that reads the kernel's changed flag once a
round and stops at ``limit`` rounds (N, or ``max_iters``).  The loop stops
only when no lane changed, and a Jacobi round leaves a converged lane as it
is, so every lane sees exactly the rounds JAX's per-lane ``while_loop``
gives it, ``max_iters`` truncation included.

Scenario masks travel as edge-major bit words (:func:`pack_edge_masks`),
never as [B, N, K] bools.  All int32, exact: the next-hop words are uint32
bit patterns carried as int32 (torch has no uint32 min or OR reduction).
"""

from __future__ import annotations

import copy
import threading
import time
from collections import Counter
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from holo_tpu_torch import telemetry
from holo_tpu_torch.analysis.runtime import note_donated, read_flag, sanctioned_transfer
from holo_tpu_torch.device import resolve_device
from holo_tpu_torch.kernels import ell
from holo_tpu_torch.ops.graph import INF as _INF
from holo_tpu_torch.ops.graph import (
    EllGraph,
    build_ell,
    delta_kind,
    delta_seed_rows,
    topology_namespace,
)
from holo_tpu_torch.parallel.mesh import mesh_cache_key, pad_graph_rows
from holo_tpu_torch.pipeline.tuner import active_tuner, shape_bucket

INF = int(_INF)

_MARSHALS = telemetry.counter("holo_spf_marshal_total", "DeviceGraph marshals (ELL expansion)")
_MARSHAL_SECONDS = telemetry.histogram(
    "holo_spf_marshal_seconds", "Host-side ELL -> DeviceGraph marshal time")
_ELL_OCCUPANCY = telemetry.gauge(
    "holo_spf_ell_occupancy", "Valid fraction of padded ELL in-edge slots (last marshal)")
_MARSHAL_CACHE = telemetry.counter(
    "holo_spf_marshal_cache_total",
    "Shared marshaled-DeviceGraph cache lookups (SPF + FRR engines)", ("result",))
_DELTA_TOTAL = telemetry.counter(
    "holo_spf_delta_total",
    "DeltaPath topology-delta dispositions: in-place device-graph "
    "updates vs full-rebuild fallbacks, by delta taxonomy", ("kind", "path"))
_CACHE_EVICTIONS = telemetry.counter(
    "holo_spf_marshal_cache_evictions_total", "Shared marshaled-DeviceGraph cache LRU evictions")


def note_delta(counts, kind: str, path: str) -> None:
    """One DeltaPath disposition: ``counts[(kind, path)]`` (a cache view's
    or backend's ``delta_paths``) and ``holo_spf_delta_total{kind,path}``."""
    counts[(kind, path)] += 1
    _DELTA_TOTAL.labels(kind=kind, path=path).inc()


class DeviceGraph(NamedTuple):
    """The ELL planes of ``holo_tpu``'s DeviceGraph, on one device."""

    in_src: torch.Tensor  # int32[N, K]
    in_cost: torch.Tensor  # int32[N, K]
    in_valid: torch.Tensor  # bool[N, K]
    in_edge_id: torch.Tensor  # int32[N, K]
    direct_nh_words: torch.Tensor  # int32[N, K, W] one-hot atom words (uint32 bits)
    is_router: torch.Tensor  # bool[N]


class SpfTensors(NamedTuple):
    """Result of one SPF run (or a batch thereof, with a leading axis)."""

    dist: torch.Tensor  # int32[N]; INF if unreachable
    parent: torch.Tensor  # int32[N]; first parent, N (sentinel) if none
    hops: torch.Tensor  # int32[N]; router hops from root, N+1 if unreachable
    nexthops: torch.Tensor | None  # int32[N, W] atom words (uint32 bits)


class MultipathTensors(NamedTuple):
    """Multi-parent frontier planes of one SPF run (or a batch, with a
    leading axis), ``holo_tpu``'s ``MultipathTensors``.  ``Kp`` is the
    padded parent-set width (:func:`mp_pad`), ``A`` the atom lanes (32 W).

    - ``parents``: up to Kp admissible parents in ascending (path cost via
      the parent, parent id) order, N past the set.  Admissible: the
      shortest-path DAG parents and the loop-free diversity parents,
      sources of usable in-edges with ``dist[u] < dist[v]`` strictly;
    - ``pdist``: the path cost via that parent, INF past the set;
    - ``pweight``: the parent's saturated path count, 0 past the set;
    - ``npaths``: the vertex's saturated shortest-path count (0 where
      unreachable);
    - ``nh_weights``: per atom the saturated number of shortest paths whose
      first hop is that atom.
    """

    parents: torch.Tensor  # int32[N, Kp]
    pdist: torch.Tensor  # int32[N, Kp]
    pweight: torch.Tensor  # int32[N, Kp]
    npaths: torch.Tensor  # int32[N]; saturated at MP_SAT
    nh_weights: torch.Tensor  # int32[N, A]; saturated at MP_SAT


def mp_pad(k: int) -> int:
    """The padded parent-set width of a ``max-paths`` k: the power of two
    at or above k, within 1..8 (``holo_tpu``'s shape buckets)."""
    k = max(1, min(int(k), 8))
    kp = 1
    while kp < k:
        kp *= 2
    return kp


def device_graph_from_ell(ell_graph: EllGraph, device=None) -> DeviceGraph:
    """Expand per-slot direct atoms into one-hot words (host side), then
    upload the six planes."""
    t0 = time.perf_counter()
    dev = resolve_device(device)
    n, k = ell_graph.in_src.shape
    w = max((ell_graph.n_atoms + 31) // 32, 1)
    words = np.zeros((n, k, w), np.uint32)
    atom = ell_graph.in_direct_atom
    rows, cols = np.nonzero(atom >= 0)
    a = atom[rows, cols]
    words[rows, cols, a // 32] = np.uint32(1) << (a % 32).astype(np.uint32)
    planes = {
        "in_src": ell_graph.in_src,
        "in_cost": ell_graph.in_cost,
        "in_valid": ell_graph.in_valid,
        "in_edge_id": ell_graph.in_edge_id,
        "direct_nh_words": words.view(np.int32),
        "is_router": ell_graph.is_router,
    }
    with sanctioned_transfer("spf.graph.upload"):
        g = DeviceGraph(**{f: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                           for f, x in planes.items()})
    _MARSHALS.inc()
    _MARSHAL_SECONDS.observe(time.perf_counter() - t0)
    # Sampled at scrape time: no reduction on the marshal path.
    _ELL_OCCUPANCY.set_fn(telemetry.deferred_mean(ell_graph.in_valid))
    return g


def pack_edge_masks(edge_masks, device) -> torch.Tensor | None:
    """bool [B, E] scenario masks -> int32 [E, ceil(B / 32)] bit words on
    ``device``: bit b % 32 of word [e, b // 32] is set where edge e is up in
    scenario b.  None for an edgeless graph (no slot is valid, so the mask
    is never read, as in JAX's ``_slot_mask``).

    The bools are uploaded as they are and packed on the device, whose
    passes over them run at memory speed, not on the host.
    """
    m = torch.as_tensor(edge_masks, dtype=torch.bool)
    if m.dim() != 2:
        raise ValueError(f"edge masks must be [B, E], got {tuple(m.shape)}")
    batch, n_edges = m.shape
    if n_edges == 0:
        return None
    with sanctioned_transfer("spf.masks.upload"):
        m = m.to(device)
    return ell.pack_lane_bits(m.T)


class LanePlanes(NamedTuple):
    """What every ELL kernel reads besides the vertex planes."""

    src: torch.Tensor  # int32[N, K]
    cost: torch.Tensor  # int32[N, K]
    slot: torch.Tensor  # int32[N, K]: edge id, -1 for padding
    mask: torch.Tensor | None  # int32[E, ceil(B / 32)] or None (all edges up)


def lane_planes(g: DeviceGraph, mask: torch.Tensor | None) -> LanePlanes:
    """The kernels' planes: JAX's ``_slot_mask`` (``in_valid &
    edge_mask[in_edge_id]``) is the slot's edge id (-1 where not valid)
    tested against the lane's bit of ``mask`` inside each kernel."""
    slot = torch.where(g.in_valid, g.in_edge_id, -1).to(torch.int32)
    return LanePlanes(g.in_src, g.in_cost, slot, mask)


def distance_seed(n: int, roots: torch.Tensor):
    """(dist, frontier): 0 at each lane's root, INF elsewhere, and the
    lanes' first frontier, the roots (no other source is usable in round
    1)."""
    lanes = roots.shape[0]
    dist = torch.full((n, lanes), INF, dtype=torch.int32, device=roots.device)
    # A scalar assigned through tensor indices is copied to the card
    # synchronously.
    with sanctioned_transfer("spf.seed.roots"):
        dist[roots.long(), torch.arange(lanes, device=roots.device)] = 0
    return dist, ell.pack_lane_bits(dist < INF)


def nexthop_frontier(seed: torch.Tensor) -> torch.Tensor:
    """The first next-hop frontier: lanes of a row with a nonzero seed word
    (a source whose words are all 0 gives nothing)."""
    return ell.pack_lane_bits((seed != 0).any(1))


def distance_fixpoint(p: LanePlanes, roots: torch.Tensor, limit: int) -> torch.Tensor:
    """``sssp_distances`` for every lane: int32 [N, B], INF unreachable."""
    dist, front = distance_seed(p.src.shape[0], roots)
    for _ in range(limit):
        dist, changed, front = ell.ell_relax(*p, dist, front)
        if not read_flag("spf.flag.distance", changed):
            break
    return dist


def hops_fixpoint(g: DeviceGraph, parent, roots, limit: int) -> torch.Tensor:
    """Router hops along the first-parent chain, int32 [N, B] (N+1 where the
    chain does not reach the root within ``limit`` rounds).

    ``spf_engine.py:942-948`` takes the min over the ELL slots whose source
    is the parent; every such slot carries hops[parent], so this gathers
    hops[parent] directly, with the sentinel parent N reading N + 1.
    """
    n, batch = parent.shape
    big = n + 1
    ext = torch.full((n + 1, batch), big, dtype=torch.int32, device=parent.device)
    with sanctioned_transfer("spf.seed.roots"):
        ext[roots.long(), torch.arange(batch, device=parent.device)] = 0
    pidx = parent.long()
    inc = g.is_router.to(torch.int32)[:, None]
    for _ in range(limit):
        hops = ext[:n]
        ph = torch.gather(ext, 0, pidx)
        new = torch.minimum(hops, torch.where(ph < big, ph + inc, big))
        changed = read_flag("spf.flag.hops", (new != hops).any())
        ext[:n] = new
        if not changed:
            break
    return ext[:n].clone()


def nexthop_fixpoint(g: DeviceGraph, dag, hops, limit: int):
    """ECMP next-hop words, int32 [N, W, B], from the DAG bits ``dag`` [N, K,
    ceil(B / 32)] of ``ell_first_parent`` and the hops [N, B].

    The seed splits the DAG slots by ``hop0`` (lane bits of hops == 0), as
    JAX's ``dag & use_direct`` / ``dag & ~use_direct``.  JAX runs one
    ``while_loop`` per word; here every word moves in the same round.  Word
    w's round reads word w alone, so each word still follows its own Jacobi
    sequence; the shared loop runs until no word changed (or ``limit``), and
    a round leaves a word at its fixpoint unchanged, so each word ends where
    its own loop would have stopped.  The frontier carries the lanes that
    changed in any word.
    """
    hop0 = ell.pack_lane_bits(hops == 0)
    nh, inherit = ell.ell_nh_seed(g.in_src, dag, hop0, g.direct_nh_words, hops.shape[1])
    front = nexthop_frontier(nh)
    for _ in range(limit):
        nh, changed, front = ell.ell_nh_round(g.in_src, inherit, nh, front)
        if not read_flag("spf.flag.nexthop", changed):
            break
    return nh


def spf_lanes(g: DeviceGraph, roots: torch.Tensor, mask, max_iters=None, nexthops=True):
    """The lane-batched ``spf_one``: (dist, parent, hops [N, B], nexthops
    [N, W, B] or None), lane b rooted at ``roots[b]`` under mask bit b."""
    n = g.in_src.shape[0]
    limit = n if max_iters is None else max_iters
    p = lane_planes(g, mask)
    dist = distance_fixpoint(p, roots, limit)
    parent, dag = ell.ell_first_parent(*p, dist, roots)
    hops = hops_fixpoint(g, parent, roots, limit)
    nh = nexthop_fixpoint(g, dag, hops, limit) if nexthops else None
    return dist, parent, torch.where(dist < INF, hops, n + 1), nh


def fused_lanes(g: DeviceGraph, roots: torch.Tensor, mask, packed: bool = False,
                max_iters=None):
    """The lane-batched ``spf_one_fused``: (dist, parent, hops [N, B],
    nexthops [N, W, B]), lane b rooted at ``roots[b]`` under mask bit b.

    One loop of ``ell_fused_round`` over two state buffers (three planes, or
    with ``packed`` one interleaved [N, B, 2 + W] plane), from dist 0 / hops
    0 at the root (INF / N + 1 elsewhere), next hops 0 and the sentinel
    parent N, for at most 3N + 6 rounds (``max_iters`` if given), stopping
    after a round that changed nothing.  The first round takes an all-ones
    frontier (so it writes the spare buffer whole), each later one the
    frontier the round before returned; the parent plane is carried from
    round to round.  One changed flag over all lanes is exact: a round maps
    a fixpoint to itself, so a converged lane that runs on keeps its
    values, as under JAX's vmapped ``while_loop``."""
    n = g.in_src.shape[0]
    words = g.direct_nh_words.shape[2]
    limit = 3 * n + 6 if max_iters is None else max_iters
    p = lane_planes(g, mask)
    lanes = roots.shape[0]
    dev = roots.device
    at_root = torch.arange(n, device=dev)[:, None] == roots.long()[None, :]
    dist = torch.where(at_root, 0, INF).to(torch.int32)
    hops = torch.where(at_root, 0, n + 1).to(torch.int32)
    nh = torch.zeros((n, words, lanes), dtype=torch.int32, device=dev)
    state = ell.fused_state(dist, hops, nh, packed)
    spare = torch.empty_like(state) if packed else tuple(map(torch.empty_like, state))
    front = ell.full_frontier(n, lanes, dev)
    parent = torch.full((n, lanes), n, dtype=torch.int32, device=dev)
    inc = g.is_router.to(torch.int32)
    for _ in range(limit):
        new, parent, changed, front = ell.ell_fused_round(
            *p, g.direct_nh_words, inc, roots, state, front, parent, spare)
        state, spare = new, state
        if not read_flag("spf.flag.fused", changed):
            break
    dist, hops, nh = ell.fused_planes(state)
    return (dist.contiguous(), parent, torch.where(dist < INF, hops, n + 1),
            nh.contiguous())


def hybrid_lanes(g: DeviceGraph, roots: torch.Tensor, mask, max_iters=None):
    """The lane-batched ``spf_one_hybrid``: the distance fixpoint (G1), the
    DAG bits and first parent once (G2), then the joint hops + next-hop
    fixpoint (``_hops_nh_fixpoint``: M1 without the count and weight planes)
    from fresh seeds, each loop limited to N rounds (``max_iters``)."""
    n = g.in_src.shape[0]
    limit = n if max_iters is None else max_iters
    p = lane_planes(g, mask)
    dist = distance_fixpoint(p, roots, limit)
    parent, dag = ell.ell_first_parent(*p, dist, roots)
    start = mp_start(n, g.direct_nh_words.shape[2], roots, counts=False)
    (hops, nh, _, _), _ = mp_fixpoint(g, roots, dag, parent, *start, limit)
    return dist, parent, torch.where(dist < INF, hops, n + 1), nh


#: the lane programs of ``one_engine`` (``holo_tpu``'s ``_ONE_ENGINES``
#: vmapped): (g, roots [B], mask bit words, max_iters) -> [N, B] planes
LANE_ENGINES = {
    "seq": spf_lanes,
    "fused": fused_lanes,
    "packed": lambda g, roots, mask, max_iters=None: fused_lanes(g, roots, mask, True,
                                                                 max_iters),
    "hybrid": hybrid_lanes,
}


def mp_fixpoint(g: DeviceGraph, roots, dag, parent, state, before, front, limit: int):
    """JAX's ``_mp_fixpoint`` for every lane: (planes, rounds) over the DAG
    bits ``dag`` [N, K, ceil(B / 32)] and the first parents [N, B].

    ``state`` and ``before`` are (hops, nh, npaths, aw) buffers owned by the
    fixpoint: the seeds, and planes that equal them wherever ``front`` has
    no bit (the round before the seeds, as :func:`mp_start` and
    :func:`mp_resume` build them).  Each round (``ell_mp_round``) reads one
    buffer and writes the other, and recomputes only the lanes of the rows
    that a DAG source's change reaches; the loop runs while any value of
    any plane changed and fewer than ``limit`` rounds ran.  Without
    ``npaths`` and ``aw`` it is ``_hops_nh_fixpoint``."""
    inc = g.is_router.to(torch.int32)
    rounds = 0
    changed = True
    while changed and rounds < limit:
        flag, front = ell.ell_mp_round(g.in_src, dag, g.direct_nh_words, inc, roots, parent,
                                       state, front, before)
        state, before = before, state
        changed = read_flag("spf.flag.mp", flag)
        rounds += 1
    return state, rounds


def mp_start(n: int, words: int, roots: torch.Tensor, counts: bool = True):
    """The fresh start of the joint fixpoint for lanes rooted at ``roots``
    [B]: (seeds, blank, frontier).  The seeds are hops 0 at the root and N +
    1 elsewhere, next hops [N, words, B] 0, npaths 1 at the root and 0
    elsewhere, nh_weights [N, 32 words, B] 0 (without ``counts`` those two
    are None: ``_hops_nh_fixpoint``'s fresh seeds); the blank planes (hops N
    + 1, all else 0) are the round before them, which differs only at the
    roots, and a round maps the blank planes to the seeds: the root has no
    DAG slot, and a blank source offers nothing.  So the first frontier is
    the roots."""
    lanes = roots.shape[0]
    dev = roots.device
    at_root = torch.arange(n, device=dev)[:, None] == roots.long()[None, :]

    def planes():
        hops = torch.full((n, lanes), n + 1, dtype=torch.int32, device=dev)
        nh = torch.zeros((n, words, lanes), dtype=torch.int32, device=dev)
        if not counts:
            return hops, nh, None, None
        return (hops, nh, torch.zeros((n, lanes), dtype=torch.int32, device=dev),
                torch.zeros((n, 32 * words, lanes), dtype=torch.int32, device=dev))

    seeds = planes()
    seeds[0].masked_fill_(at_root, 0)
    if counts:
        seeds[2].masked_fill_(at_root, 1)
    return seeds, planes(), ell.pack_lane_bits(at_root)


def mp_resume(state):
    """The start of the joint fixpoint from a previous run's planes (hops,
    nh, npaths, aw; the last two may be None), which are only read: (their
    copy, a buffer of the same shapes, an all-ones frontier).  A seed is not
    the output of a round, so the first round recomputes every lane."""
    n, lanes = state[0].shape
    return (tuple(None if x is None else x.clone() for x in state),
            tuple(None if x is None else torch.empty_like(x) for x in state),
            ell.full_frontier(n, lanes, state[0].device))


def mp_lanes(g: DeviceGraph, roots: torch.Tensor, mask, kp: int, max_iters=None):
    """The lane-batched ``spf_one_multipath``: ((dist, parent, hops [N, B],
    nexthops [N, W, B]), (parents, pdist, pweight [N, kp, B], npaths [N, B],
    nh_weights [N, A, B])), lane b rooted at ``roots[b]`` under mask bit b."""
    n = g.in_src.shape[0]
    limit = n if max_iters is None else max_iters
    p = lane_planes(g, mask)
    dist = distance_fixpoint(p, roots, limit)
    parent, dag, parents, pdist = ell.ell_parent_sets(*p, dist, roots, kp)
    (hops, nh, npaths, aw), _ = mp_fixpoint(
        g, roots, dag, parent, *mp_start(n, g.direct_nh_words.shape[2], roots), limit)
    reach = dist < INF
    pweight = ell.ell_parent_weights(parents, npaths)
    return ((dist, parent, torch.where(reach, hops, n + 1), nh),
            (parents, pdist, pweight, torch.where(reach, npaths, 0), aw))


def _roots(root, batch: int, device) -> torch.Tensor:
    return torch.full((batch,), int(root), dtype=torch.int32, device=device)


def _batch_major(dist, parent, hops, nh) -> SpfTensors:
    """[N, B] lane planes -> JAX's [B, N] (next hops [B, N, W])."""
    return SpfTensors(
        dist=dist.T.contiguous(),
        parent=parent.T.contiguous(),
        hops=hops.T.contiguous(),
        nexthops=None if nh is None else nh.permute(2, 0, 1).contiguous(),
    )


def _mp_batch_major(parents, pdist, pweight, npaths, aw) -> MultipathTensors:
    """Lane-minor multipath planes -> JAX's [B, N, ...] layout."""
    return MultipathTensors(
        parents=parents.permute(2, 0, 1).contiguous(),
        pdist=pdist.permute(2, 0, 1).contiguous(),
        pweight=pweight.permute(2, 0, 1).contiguous(),
        npaths=npaths.T.contiguous(),
        nh_weights=aw.permute(2, 0, 1).contiguous(),
    )


def sssp_distances(g: DeviceGraph, root: int, edge_mask=None, max_iters=None):
    """Exact shortest-path distances from ``root`` (int32[N], INF unreachable)."""
    dev = g.in_src.device
    mask = None if edge_mask is None else pack_edge_masks(np.asarray(edge_mask)[None], dev)
    limit = g.in_src.shape[0] if max_iters is None else max_iters
    return distance_fixpoint(lane_planes(g, mask), _roots(root, 1, dev), limit)[:, 0]


def first_parent(g: DeviceGraph, dist: torch.Tensor, root: int, edge_mask=None):
    """int32[N]: ``_first_parent(g, _sp_dag(g, dist, ok, root), dist[in_src])``."""
    dev = g.in_src.device
    mask = None if edge_mask is None else pack_edge_masks(np.asarray(edge_mask)[None], dev)
    p = lane_planes(g, mask)
    parent, _ = ell.ell_first_parent(*p, dist[:, None].contiguous(), _roots(root, 1, dev))
    return parent[:, 0]


def _one(lanes_fn, g: DeviceGraph, root: int, edge_mask, *args) -> SpfTensors:
    """``lanes_fn(g, roots, mask, *args)`` at one lane, in JAX's layout."""
    dev = g.in_src.device
    mask = None if edge_mask is None else pack_edge_masks(np.asarray(edge_mask)[None], dev)
    out = _batch_major(*lanes_fn(g, _roots(root, 1, dev), mask, *args))
    return SpfTensors(*(x[0] for x in out))


def spf_one(g: DeviceGraph, root: int, edge_mask=None, max_iters=None) -> SpfTensors:
    """Full SPF: distances + first parent + hops + ECMP next-hop words."""
    return _one(spf_lanes, g, root, edge_mask, max_iters)


def spf_one_fused(g: DeviceGraph, root: int, edge_mask=None, max_iters=None,
                  packed: bool = False) -> SpfTensors:
    """Full SPF with every fixpoint in one Jacobi loop (:func:`fused_lanes`);
    ``packed`` keeps the state as one interleaved plane."""
    return _one(fused_lanes, g, root, edge_mask, packed, max_iters)


def spf_one_hybrid(g: DeviceGraph, root: int, edge_mask=None, max_iters=None) -> SpfTensors:
    """Full SPF in two loops, distances then hops + next hops
    (:func:`hybrid_lanes`)."""
    return _one(hybrid_lanes, g, root, edge_mask, max_iters)


#: ``holo_tpu``'s ``_ONE_ENGINES``: one_engine -> the single-SPF function
_ONE_ENGINES = {
    "seq": spf_one,
    "fused": spf_one_fused,
    "packed": lambda g, r, m=None, mi=None: spf_one_fused(g, r, m, mi, packed=True),
    "hybrid": spf_one_hybrid,
}


def lane_engine(engine: str):
    """The lane program of ``engine``; raises naming the ROADMAP item of an
    engine the port does not run yet."""
    if engine not in LANE_ENGINES:
        item = (" (the tropical engine takes tiles and repair rows: ops/tropical.py, "
                "tropical_whatif_batch)") if engine == "tropical" else ""
        raise ValueError(f"one_engine {engine!r}: the lane programs are {sorted(LANE_ENGINES)}"
                         f"{item}")
    return LANE_ENGINES[engine]


def spf_whatif_batch(
    g: DeviceGraph, root: int, edge_masks, max_iters=None, engine: str = "seq"
) -> SpfTensors:
    """Batched what-if SPF over scenario edge masks (bool [B, E]): [B, N]
    planes, next hops [B, N, W].  Mask *both* directions of a failed link.
    ``engine``: 'seq', 'fused', 'packed' or 'hybrid' (one lane program over
    every scenario)."""
    lanes_fn = lane_engine(engine)
    dev = g.in_src.device
    mask = pack_edge_masks(edge_masks, dev)
    batch = int(np.shape(edge_masks)[0])
    return _batch_major(*lanes_fn(g, _roots(root, batch, dev), mask, max_iters=max_iters))


def spf_one_multipath(g: DeviceGraph, root: int, kp: int, edge_mask=None, max_iters=None):
    """Full SPF and the multi-parent frontier: (SpfTensors, MultipathTensors)
    of one run.  The SpfTensors half comes from the joint fixpoint, as in
    JAX; it equals :func:`spf_one` wherever the fixpoints converge."""
    dev = g.in_src.device
    mask = None if edge_mask is None else pack_edge_masks(np.asarray(edge_mask)[None], dev)
    sp, mp = mp_lanes(g, _roots(root, 1, dev), mask, kp, max_iters)
    return (SpfTensors(*(x[0] for x in _batch_major(*sp))),
            MultipathTensors(*(x[0] for x in _mp_batch_major(*mp))))


def spf_multipath_batch(g: DeviceGraph, root: int, edge_masks, kp: int, max_iters=None):
    """The multipath what-if over scenario edge masks (bool [B, E]), one
    lane-batched program: (SpfTensors, MultipathTensors) with a leading
    batch axis."""
    dev = g.in_src.device
    mask = pack_edge_masks(edge_masks, dev)
    batch = int(np.shape(edge_masks)[0])
    sp, mp = mp_lanes(g, _roots(root, batch, dev), mask, kp, max_iters)
    return _batch_major(*sp), _mp_batch_major(*mp)


def spf_multiroot(g: DeviceGraph, roots, edge_mask=None, max_iters=None) -> SpfTensors:
    """SPF from many roots (int32 [R]): [R, N] dist, parent and hops.

    ``nexthops`` is None: the direct atoms are marshaled relative to the
    topology's own root, so next hops mean nothing for another root, and
    ``MultiRootResult`` has no next-hop plane.
    """
    dev = g.in_src.device
    with sanctioned_transfer("spf.roots.upload"):
        roots_t = torch.as_tensor(np.asarray(roots, np.int32)).to(dev)
    mask = None
    if edge_mask is not None:
        shared = np.repeat(np.asarray(edge_mask, bool)[None], roots_t.shape[0], axis=0)
        mask = pack_edge_masks(shared, dev)
    return _batch_major(*spf_lanes(g, roots_t, mask, max_iters, nexthops=False))


# ---------------------------------------------------------------------------
# DeltaPath: resident graphs updated in place, and the seeded incremental SPF
# (``holo_tpu/ops/spf_engine.py:171-829``, ``:1185-1232``, ``:1521-1605``).


class _EllMirror:
    """Host copy of a cached entry's ELL slot occupancy: the delta lowering
    resolves edge-level ops to (row, slot) targets and finds padding slack
    from it, without reading the device planes back.  It owns copies of
    the marshal-time arrays (on the CPU the planes alias them)."""

    def __init__(self, ell_graph: EllGraph):
        self.in_src = ell_graph.in_src.copy()
        self.in_cost = ell_graph.in_cost.copy()
        self.in_valid = ell_graph.in_valid.copy()
        self.in_atom = ell_graph.in_direct_atom.copy()
        self.n_atoms = int(ell_graph.n_atoms)
        self.n_valid = int(ell_graph.in_valid.sum())

    @property
    def occupancy(self) -> float:
        return self.n_valid / max(self.in_valid.size, 1)


@dataclass
class _CacheEntry:
    graph: DeviceGraph
    mirror: _EllMirror
    depth: int = 0  # delta-chain length since the last full marshal
    # in_edge_id no longer matches the serving topology's edge list (a
    # structural delta shifted edge indices): the entry serves mask-free
    # SPF but not edge-mask consumers (what-if, a masked compute).
    ids_stale: bool = False
    # The tropical tile attachment (ops.tropical.TropicalTiles) and its host
    # meta, built from the mirror on first use and updated in place by each
    # delta; a delta the tiles cannot absorb drops only the attachment.
    tropical: object | None = None
    trop_meta: dict | None = None


class _DeltaUnappliable(Exception):
    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


class DeltaSlots(NamedTuple):
    """A lowered delta: the final state of every touched slot, and the
    overload strike."""

    rows: np.ndarray  # int64[T]
    cols: np.ndarray  # int64[T]
    src: np.ndarray  # int32[T]
    cost: np.ndarray  # int32[T]
    valid: np.ndarray  # bool[T]
    words: np.ndarray  # int32[T, W] one-hot atom words (uint32 bits)
    strike: np.ndarray | None  # bool[N] overloaded vertices, None if none


def lower_delta(mirror: _EllMirror, delta, n_vertices: int) -> DeltaSlots:
    """Resolve a delta's edge-level ops to slot writes, moving the mirror to
    the post-delta state (``_lower_delta``).  Raises
    :class:`_DeltaUnappliable` on padding overflow, atom overflow, or an op
    that matches no mirrored slot.  Only the touched slots are written, each
    once with its final state: torch compiles nothing per shape, so the ops
    need no padding to a fixed bucket."""

    def find(dst, src, cost, atom) -> int:
        m = (
            mirror.in_valid[dst]
            & (mirror.in_src[dst] == src)
            & (mirror.in_cost[dst] == cost)
            & (mirror.in_atom[dst] == atom)
        )
        hit = np.nonzero(m)[0]
        if hit.shape[0] == 0:
            raise _DeltaUnappliable("missing-edge")
        return int(hit[0])

    touched: set[tuple[int, int]] = set()
    d = delta
    # Removals first: they free the padding slack additions reuse.
    for src, dst, cost, atom in zip(d.r_src, d.r_dst, d.r_cost, d.r_atom):
        col = find(dst, src, cost, atom)
        mirror.in_valid[dst, col] = False
        mirror.in_src[dst, col] = 0
        mirror.in_cost[dst, col] = 0
        mirror.in_atom[dst, col] = -1
        mirror.n_valid -= 1
        touched.add((int(dst), col))
    for src, dst, old, new, atom in zip(d.w_src, d.w_dst, d.w_old, d.w_new, d.w_atom):
        col = find(dst, src, old, atom)
        mirror.in_cost[dst, col] = new
        touched.add((int(dst), col))
    for src, dst, cost, atom in zip(d.a_src, d.a_dst, d.a_cost, d.a_atom):
        if atom >= mirror.n_atoms:
            raise _DeltaUnappliable("atom-overflow")
        free = np.nonzero(~mirror.in_valid[dst])[0]
        if free.shape[0] == 0:
            raise _DeltaUnappliable("padding-overflow")
        col = int(free[0])
        mirror.in_valid[dst, col] = True
        mirror.in_src[dst, col] = src
        mirror.in_cost[dst, col] = cost
        mirror.in_atom[dst, col] = atom
        mirror.n_valid += 1
        touched.add((int(dst), col))
    # Overload strikes are masked on the device through in_src; the mirror
    # keeps the struck slots invalid so later deltas see the occupancy.
    strike = None
    if len(d.overload):
        strike = np.zeros(n_vertices, bool)
        strike[np.asarray(d.overload)] = True
        hit = strike[mirror.in_src] & mirror.in_valid
        mirror.n_valid -= int(hit.sum())
        mirror.in_valid[hit] = False
    rc = np.array(sorted(touched), np.int64).reshape(-1, 2)
    rows, cols = rc[:, 0], rc[:, 1]
    atom = mirror.in_atom[rows, cols]
    w = max((mirror.n_atoms + 31) // 32, 1)
    words = np.zeros((rows.shape[0], w), np.uint32)
    has = np.nonzero(atom >= 0)[0]
    words[has, atom[has] // 32] = np.uint32(1) << (atom[has] % 32).astype(np.uint32)
    return DeltaSlots(
        rows=rows,
        cols=cols,
        src=mirror.in_src[rows, cols],
        cost=mirror.in_cost[rows, cols],
        valid=mirror.in_valid[rows, cols],
        words=words.view(np.int32),
        strike=strike,
    )


def apply_delta_slots(g: DeviceGraph, ops: DeltaSlots) -> DeviceGraph:
    """Write a lowered delta into the resident planes in place
    (``_apply_delta_slots``): ``in_src``, ``in_cost``, ``in_valid`` and
    ``direct_nh_words`` at the touched slots, then ``in_valid &=
    ~strike[in_src]``.  The slot ops go up in one int32 copy.  Returns
    ``g``, whose tensors every holder of them now sees updated."""
    dev = g.in_src.device
    t = ops.rows.shape[0]
    if t:
        packed = np.empty((5 + ops.words.shape[1], t), np.int32)
        packed[0], packed[1] = ops.rows, ops.cols
        packed[2], packed[3], packed[4] = ops.src, ops.cost, ops.valid
        packed[5:] = ops.words.T
        with sanctioned_transfer("spf.graph.delta"):
            up = torch.from_numpy(packed).to(dev)
        at = (up[0].long(), up[1].long())
        g.in_src.index_put_(at, up[2])
        g.in_cost.index_put_(at, up[3])
        g.in_valid.index_put_(at, up[4] != 0)
        g.direct_nh_words.index_put_(at, up[5:].T)
    if ops.strike is not None:
        with sanctioned_transfer("spf.graph.delta"):
            strike = torch.from_numpy(ops.strike).to(dev)
        g.in_valid.logical_and_(~strike[g.in_src.long()])
    return g


class DeviceGraphCache:
    """LRU of marshaled DeviceGraphs on one device, keyed by ``(topology
    class, uid, generation, n_atoms, mesh key)`` (``holo_tpu``'s
    ``DeviceGraphCache``).  In-place topology mutators must ``touch()``.

    Under a dispatch mesh (``mesh=`` of each call: the caller reads the
    process mesh once a dispatch) the mesh's identity
    (``parallel.mesh.mesh_cache_key``) joins the key, so a resident laid out
    for one mesh never serves another or the plain path, and a marshal pads
    the rows to a multiple of the node axis (``pad_graph_rows``).  The host
    mirror keeps the N real rows: a delta's slot writes and the tiles never
    touch a pad row.  Each device's cache holds its own residents, so a
    delta applied on one card leaves another card's copy of the base as it
    was (that cache applies the delta to its own copy when a dispatch there
    asks for the new generation).

    DeltaPath: when a lookup misses but the topology carries delta lineage
    (``Topology.link_delta``) to a resident base entry of its own class, the
    delta is lowered to slot writes and applied to the base's planes in
    place; the claimed entry leaves the cache under its old key and serves
    the new one.  Chains deeper than ``max_delta_depth``, padding or atom
    overflow, a missing edge, or an edge-mask consumer asking for an entry
    with stale edge ids fall back to a full rebuild.  With the engine tuner
    armed the depth cap is its per-shape one (:meth:`_depth_cap`).  Each disposition
    counts in ``delta_paths[(kind, path)]`` (``holo_spf_delta_total``);
    each lookup in ``lookups[hit | delta | miss]``.

    An entry may carry the tropical engine's tiles (:meth:`get_tropical`).
    A delta applied to it is lowered into tile writes too and applied in
    place; a delta the tiles cannot absorb drops them only.  Each counts in
    ``tile_deltas`` (``apply`` or ``drop-<reason>``, ``holo_tpu``'s
    ``holo_spf_tropical_delta_total``).

    A cache and its views (:meth:`view`) share one lock, as ``holo_tpu``'s:
    every lookup, marshal, delta apply, tile build, eviction and
    partitioned-store access runs under it, so threads may look up, marshal
    and evict at once.  The lock does not cover a graph once ``get()`` has
    returned it: a delta applied later to its entry rewrites its planes in
    place, while a dispatch may still read them round by round.  So nothing
    but the cache may hold a graph across calls, and a dispatch that reads a
    chain's graph must not run on one thread while a delta of that chain
    runs on another: the dispatch pipeline runs every dispatch of a chain,
    its synchronous what-if and multi-root delegates included, on its
    worker in the chain's order.

    Partitioned residents (``ops.partition.PartResident``) live beside the
    graphs, keyed by their backend (key[0] the backend's namespace), up to
    ``PART_CAPACITY`` of them (``holo_tpu``'s), LRU; a resident carries its
    own chain identity (``topo_key``), which its caller checks.
    """

    PART_CAPACITY = 8

    def __init__(self, device, capacity: int = 16, max_delta_depth: int = 256):
        self.device = resolve_device(device)
        self.capacity = int(capacity)
        self.max_delta_depth = int(max_delta_depth)
        self.delta_paths: Counter = Counter()
        self.lookups: Counter = Counter()
        self.tile_deltas: Counter = Counter()
        self._cache: dict[tuple, _CacheEntry] = {}
        self._part: dict[tuple, object] = {}
        self._evictions = 0
        self._deltas_applied = 0
        # Shared by the views (copy.copy keeps the reference); reentrant
        # because get_tropical may marshal through get.
        self._lock = threading.RLock()

    @staticmethod
    def key(topo, n_atoms: int, mesh=None) -> tuple:
        return (*topology_namespace(topo), *topo.cache_key, int(n_atoms), mesh_cache_key(mesh))

    def _depth_cap(self, topo, mesh=None) -> int:
        """The chain-depth cap of this topology's shape bucket: with the
        engine tuner armed, derived from its measured delta and full walls
        (``EngineTuner.max_delta_depth``), else ``max_delta_depth``, which
        is also the tuner's default."""
        t = active_tuner()
        if t is None:
            return self.max_delta_depth
        return t.max_delta_depth(
            shape_bucket(topo.n_vertices, topo.n_edges, 1, mesh_cache_key(mesh)),
            default=self.max_delta_depth)

    def get(self, topo, n_atoms: int, need_edge_ids: bool = False,
            allow_delta: bool = True, mesh=None) -> tuple[DeviceGraph, str]:
        """(device graph, 'hit' | 'delta' | 'miss').  ``need_edge_ids``:
        the caller gathers through ``in_edge_id`` (edge masks), so an entry
        whose edge ids went stale under a structural delta is rebuilt.
        ``mesh``: the dispatch mesh the resident is laid out for (None: the
        plain path)."""
        with self._lock:
            return self._get_locked(topo, n_atoms, need_edge_ids, allow_delta, mesh)

    def _get_locked(self, topo, n_atoms: int, need_edge_ids: bool,
                    allow_delta: bool, mesh) -> tuple[DeviceGraph, str]:
        key = self.key(topo, n_atoms, mesh)
        e = self._cache.pop(key, None)
        if e is not None and not (need_edge_ids and e.ids_stale):
            self._cache[key] = e  # the LRU's newest
            self._lookup("hit")
            return e.graph, "hit"
        if allow_delta:
            g = self._try_delta(topo, n_atoms, need_edge_ids, mesh)
            if g is not None:
                self._lookup("delta")
                return g, "delta"
        self._lookup("miss")
        ell_graph = build_ell(topo, n_atoms=n_atoms)
        g = pad_graph_rows(device_graph_from_ell(ell_graph, self.device), mesh)
        self._insert(key, _CacheEntry(graph=g, mirror=_EllMirror(ell_graph)))
        return g, "miss"

    def _try_delta(self, topo, n_atoms: int, need_edge_ids: bool, mesh) -> DeviceGraph | None:
        delta = getattr(topo, "delta_base", None)
        if delta is None:
            return None
        kind = delta_kind(delta)
        # The base is a topology of the delta carrier's own class, laid out
        # for the same mesh.
        base_key = (*topology_namespace(topo), *delta.base_key, int(n_atoms),
                    mesh_cache_key(mesh))
        base = self._cache.get(base_key)
        if base is None:
            path = "full-no-base"
        elif base.depth + 1 > self._depth_cap(topo, mesh):
            path, base = "full-depth", None
        elif need_edge_ids and (base.ids_stale or not delta.ids_stable):
            path, base = "full-edge-ids", None
        else:
            del self._cache[base_key]  # claimed: its planes change in place
            path = "apply"
        if base is None:
            note_delta(self.delta_paths, kind, path)
            return None
        try:
            ops = lower_delta(base.mirror, delta, topo.n_vertices)
        except _DeltaUnappliable as exc:
            # The mirror may be half-updated: the claimed entry is dropped
            # and the caller re-marshals.
            note_delta(self.delta_paths, kind, f"full-{exc.reason}")
            return None
        tile_ops = None
        if base.tropical is not None:
            from holo_tpu_torch.ops import tropical

            # Against the post-delta mirror, which lower_delta just moved.
            try:
                tile_ops = tropical.lower_tile_delta(base.mirror, delta, base.trop_meta)
            except tropical.TileDeltaUnappliable as exc:
                base.tropical = base.trop_meta = None
                tropical.note_tile_delta(self.tile_deltas, f"drop-{exc.reason}")
        new_key = self.key(topo, n_atoms, mesh)
        g = apply_delta_slots(base.graph, ops)
        # The base's planes now hold the new generation: a reader still
        # holding them for the base fails its finish under the guard.
        note_donated("spf.graph.delta", base.graph, generation=new_key)
        if tile_ops is not None:
            tropical.apply_tile_delta(base.tropical, tile_ops)
            tropical.note_tile_delta(self.tile_deltas, "apply")
            note_donated("spf.tiles.delta", base.tropical, generation=new_key)
        self._insert(new_key, _CacheEntry(
            graph=g, mirror=base.mirror, depth=base.depth + 1,
            ids_stale=base.ids_stale or not delta.ids_stable,
            tropical=base.tropical, trop_meta=base.trop_meta,
        ), applied=True)
        note_delta(self.delta_paths, kind, "apply")
        return g

    def get_tropical(self, topo, n_atoms: int, mesh=None):
        """The entry's tropical tiles (``ops.tropical.TropicalTiles`` on this
        device), built from its mirror on first use and kept; the entry is
        looked up (or marshaled) first if it is not resident.  The tiles
        cover the N real vertices, also on a row-padded resident."""
        from holo_tpu_torch.ops import tropical

        key = self.key(topo, n_atoms, mesh)
        with self._lock:
            e = self._cache.get(key)
            if e is None:
                self.get(topo, n_atoms, mesh=mesh)
                e = self._cache[key]
            if e.tropical is None:
                m = e.mirror
                host, e.trop_meta = tropical.build_tiles_host(m.in_src, m.in_cost, m.in_valid)
                e.tropical = tropical.tiles_on(host, self.device)
            return e.tropical

    def _lookup(self, how: str) -> None:
        self.lookups[how] += 1
        _MARSHAL_CACHE.labels(result=how).inc()

    def _insert(self, key: tuple, entry: _CacheEntry, applied: bool = False) -> None:
        self._cache[key] = entry
        while len(self._cache) > self.capacity:
            self._cache.pop(next(iter(self._cache)))
            self._evictions += 1
            _CACHE_EVICTIONS.inc()
        self._deltas_applied += applied

    def view(self, counts: "DeviceGraphCache | None" = None) -> "DeviceGraphCache":
        """A cache over this one's graphs (the same entries, capacity and
        depth limit) with lookup, DeltaPath, eviction and delta counts of its
        own: each engine counts its own lookups while engines on one device
        marshal a topology once.  ``counts``: another view whose lookup,
        DeltaPath and tile-delta counters this one shares (an engine's views
        of the caches of its mesh's devices)."""
        v = copy.copy(self)
        if counts is None:
            v.delta_paths, v.lookups, v.tile_deltas = Counter(), Counter(), Counter()
        else:
            v.delta_paths, v.lookups = counts.delta_paths, counts.lookups
            v.tile_deltas = counts.tile_deltas
        v._evictions = v._deltas_applied = 0
        return v

    def stats(self) -> dict:
        """Eviction, chain and occupancy summary (the counts this view's)."""
        with self._lock:
            entries = list(self._cache.values())
            depths = [e.depth for e in entries]
            occ = [e.mirror.occupancy for e in entries]
        return {
            "entries": len(entries),
            "capacity": self.capacity,
            "evictions": self._evictions,
            "deltas-applied": self._deltas_applied,
            "delta-entries": sum(1 for d in depths if d > 0),
            "max-chain-depth": max(depths, default=0),
            "stale-id-entries": sum(1 for e in entries if e.ids_stale),
            "tropical-entries": sum(1 for e in entries if e.tropical is not None),
            "occupancy": round(sum(occ) / len(occ), 4) if occ else 0.0,
        }

    def get_partitioned(self, key: tuple):
        """The partitioned resident under ``key`` (made the LRU's newest), or
        None."""
        with self._lock:
            res = self._part.pop(key, None)
            if res is not None:
                self._part[key] = res
            return res

    def put_partitioned(self, key: tuple, res) -> None:
        with self._lock:
            self._part.pop(key, None)
            self._part[key] = res
            while len(self._part) > self.PART_CAPACITY:
                self._part.pop(next(iter(self._part)))
                self._evictions += 1
                _CACHE_EVICTIONS.inc()

    def partitioned_entries(self, namespace=None) -> dict:
        """key -> resident, of one backend's ``namespace`` (key[0]) or all."""
        with self._lock:
            return {k: v for k, v in self._part.items()
                    if namespace is None or k[0] == namespace}

    def __len__(self) -> int:
        with self._lock:
            return len(self._cache)

    def clear(self) -> None:
        with self._lock:
            self._cache.clear()
            self._part.clear()


_SHARED_CACHES: dict[torch.device, DeviceGraphCache] = {}
_SHARED_LOCK = threading.Lock()


def shared_graph_cache(device=None) -> DeviceGraphCache:
    """The process-wide marshaled-graph cache of ``device`` (the card unless
    ``device="cpu"``), one per device: engines that run on one topology
    (``TorchSpfBackend`` through a :meth:`~DeviceGraphCache.view`, FRR
    beside it) marshal it once and keep one copy.  The registry creates an
    entry under a lock, and the cache takes its own, so threads may share it
    under the rule :class:`DeviceGraphCache` states: no dispatch reads a
    chain's graph while a delta of the chain runs on another thread."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    with _SHARED_LOCK:
        if dev not in _SHARED_CACHES:
            _SHARED_CACHES[dev] = DeviceGraphCache(dev)
        return _SHARED_CACHES[dev]


def hops_nh_recompute(g: DeviceGraph, root: int, dag, parent, hops0, nh0, limit: int):
    """Jacobi hops + next-hop fixpoint of one lane over a settled DAG (bits
    [N, K, 1]), seeded with ``hops0`` [N] and ``nh0`` [N, W]
    (``_hops_nh_fixpoint``): (hops, next hops, rounds).  Each round
    recomputes its values from the last (``ell_mp_round`` without the
    count and weight planes), so a stale seed value can fall, which
    ``ell_nh_round`` (OR into its input) could not do.  The seeds are only
    read."""
    roots = _roots(root, 1, g.in_src.device)
    start = mp_resume((hops0[:, None], nh0[:, :, None], None, None))
    (hops, nh, _, _), rounds = mp_fixpoint(g, roots, dag, parent[:, None], *start, limit)
    return hops[:, 0], nh[:, :, 0], rounds


def _ell_relax_loop(g: DeviceGraph, dist: torch.Tensor, limit: int):
    """(dist, rounds): ``ell_relax`` rounds from the seed ``dist`` [N, B], no
    mask, while a round changed something and fewer than ``limit`` ran.  The
    first frontier marks every row with a finite seed: a seed is not the
    output of a round, so no source of it may be skipped."""
    front = ell.pack_lane_bits(dist < INF)
    p = lane_planes(g, None)
    rounds = 0
    changed = True
    while changed and rounds < limit:
        dist, flag, front = ell.ell_relax(*p, dist, front)
        changed = read_flag("spf.flag.relax", flag)
        rounds += 1
    return dist, rounds


def _incremental_relax(g: DeviceGraph, root: int, prev: SpfTensors, seed_rows, limit: int,
                       relax=None):
    """Phases 1-2 of the incremental SPF: (planes, dist [N, 1], phase
    record).  The caller then runs the DAG step: ``ell_first_parent`` on
    the single-path path, ``ell_parent_sets`` on the multipath one.

    1. The affected set: the seed rows and their descendants in the
       previous first-parent tree (one gather of ``aff[parent]`` a round).
    2. The seeded relax from the previous distances with the affected rows
       at INF and the root at 0: ``relax(dist, limit) -> (dist, rounds)``,
       :func:`_ell_relax_loop` by default (the tropical engine's runs on its
       tiles)."""
    n = g.in_src.shape[0]
    dev = g.in_src.device
    t0 = time.perf_counter()
    has_par = prev.parent < n
    pidx = torch.where(has_par, prev.parent, 0).long()
    aff = torch.zeros(n, dtype=torch.bool, device=dev)
    with sanctioned_transfer("spf.delta.seeds"):
        aff[torch.as_tensor(np.asarray(seed_rows, np.int64)).to(dev)] = True
    aff_rounds = 0
    changed = True
    while changed and aff_rounds < limit:
        new = aff | (has_par & aff[pidx])
        changed = read_flag("spf.flag.affected", (new != aff).any())
        aff = new
        aff_rounds += 1
    t1 = time.perf_counter()
    dist = torch.where(aff, INF, prev.dist)
    with sanctioned_transfer("spf.seed.roots"):
        dist[int(root)] = 0
    seed = dist[:, None].contiguous()
    dist, relax_rounds = (_ell_relax_loop(g, seed, limit) if relax is None
                          else relax(seed, limit))
    p = lane_planes(g, None)
    t2 = time.perf_counter()
    record = dict(affected=aff_rounds, affected_ms=(t1 - t0) * 1e3, aff=aff,
                  relax=relax_rounds, relax_ms=(t2 - t1) * 1e3, t2=t2)
    return p, dist, record


def _note_phases(stats: dict | None, record: dict, rounds: int) -> None:
    """Fill ``stats`` (when given) with each phase's rounds and host
    milliseconds and the affected set's size (one more sync)."""
    if stats is not None:
        with sanctioned_transfer("spf.delta.stats"):
            affected_rows = int(record["aff"].sum())
        stats.update(affected=record["affected"], affected_ms=record["affected_ms"],
                     affected_rows=affected_rows, relax=record["relax"],
                     relax_ms=record["relax_ms"], hops_nh=rounds,
                     hops_nh_ms=(time.perf_counter() - record["t2"]) * 1e3)


def spf_one_incremental(g: DeviceGraph, root: int, prev: SpfTensors, seed_rows,
                        max_iters=None, stats: dict | None = None, relax=None) -> SpfTensors:
    """Incremental full SPF (``spf_one_incremental``, one lane): recompute
    only what a delta can have changed, seeded from the previous run.

    ``g`` is the delta-updated graph, ``prev`` the previous run's tensors
    on the base graph (only read), ``seed_rows`` the vertices whose
    previous distance may now be too small (``TopologyDelta.seed_rows``).
    Phases 1-2 are :func:`_incremental_relax`'s; then ``ell_first_parent``
    (parent and DAG bits), and phase 3 is :func:`hops_nh_recompute` seeded
    with the previous hops and next hops, as JAX seeds it.

    Every loop runs JAX's rounds (while changed and fewer than ``max_iters``
    or N), so the bits equal JAX's incremental path under truncation too.
    ``stats``, when given, receives each phase's rounds and host
    milliseconds (each phase ends on a host sync; the last, ``hops_nh``,
    includes ``ell_first_parent``) and the affected set's size (one more
    sync).  ``relax`` replaces phase 2's loop (:func:`_incremental_relax`).
    """
    n = g.in_src.shape[0]
    limit = n if max_iters is None else max_iters
    p, dist, record = _incremental_relax(g, root, prev, seed_rows, limit, relax)
    parent, dag = ell.ell_first_parent(*p, dist, _roots(root, 1, g.in_src.device))
    hops, nh, rounds = hops_nh_recompute(g, root, dag, parent[:, 0], prev.hops, prev.nexthops,
                                         limit)
    _note_phases(stats, record, rounds)
    dist = dist[:, 0]
    return SpfTensors(
        dist=dist,
        parent=parent[:, 0],
        hops=torch.where(dist < INF, hops, n + 1),
        nexthops=nh,
    )


def spf_one_incremental_multipath(g: DeviceGraph, root: int, prev: SpfTensors, prev_npaths,
                                  prev_nh_weights, seed_rows, kp: int, max_iters=None,
                                  stats: dict | None = None):
    """Incremental multipath SPF (``spf_one_incremental_multipath``):
    :func:`spf_one_incremental`'s phases 1-2, then ``ell_parent_sets``
    (first parent, DAG bits and parent sets: closed-form in the settled
    distances), the joint fixpoint seeded with the previous run's hops,
    next hops, ``npaths`` [N] and ``nh_weights`` [N, A], and the parent
    weights.  (SpfTensors, MultipathTensors); the seeds are only read;
    ``stats`` as in :func:`spf_one_incremental` (its ``hops_nh`` phase also
    holds the parent sets)."""
    n = g.in_src.shape[0]
    limit = n if max_iters is None else max_iters
    p, dist, record = _incremental_relax(g, root, prev, seed_rows, limit)
    roots = _roots(root, 1, g.in_src.device)
    parent, dag, parents, pdist = ell.ell_parent_sets(*p, dist, roots, kp)
    start = mp_resume((prev.hops[:, None], prev.nexthops[:, :, None], prev_npaths[:, None],
                       prev_nh_weights[:, :, None]))
    (hops, nh, npaths, aw), rounds = mp_fixpoint(g, roots, dag, parent, *start, limit)
    pweight = ell.ell_parent_weights(parents, npaths)
    _note_phases(stats, record, rounds)
    reach = dist[:, 0] < INF
    sp = SpfTensors(dist=dist[:, 0], parent=parent[:, 0],
                    hops=torch.where(reach, hops[:, 0], n + 1), nexthops=nh[:, :, 0])
    mp = MultipathTensors(parents=parents[:, :, 0], pdist=pdist[:, :, 0],
                          pweight=pweight[:, :, 0],
                          npaths=torch.where(reach, npaths[:, 0], 0),
                          nh_weights=aw[:, :, 0])
    return sp, mp


# -- kernel-contract audit registrations (HL3xx) ------------------------
# Inert contract descriptors for holo_tpu_torch.analysis.kernel_audit: the
# builder and spec thunks run only when the audit runs; registration is a
# dict write, so the dispatch path never pays for them.
from holo_tpu_torch.analysis.kernels import register_kernel as _register_kernel  # noqa: E402

#: ``holo_tpu``'s audit sizes: 64 vertices, ELL width 8, 2 next-hop words (64
#: atoms), 8 scenario / root lanes.  The graph is a seeded synthetic OSPF
#: topology (56 routers, 8 transit networks, 158 edges where ``holo_tpu``'s
#: abstract planes have 128), so every fixpoint converges as it does in use.
_AUDIT_N, _AUDIT_W = 64, 2
_AUDIT_B = 8  # scenario/root batch lanes
_AUDIT_SEED = 1


def audit_topology():
    """The audit's topology (root: router 0)."""
    from holo_tpu_torch.spf.synth import random_ospf_topology

    return random_ospf_topology(_AUDIT_N - 8, 8, extra_p2p=0, seed=_AUDIT_SEED)


def audit_delta_topology(base):
    """``base`` with edge 0's cost raised by 5 and edge 2 removed, linked to
    ``base`` as a delta (a weight op, a removal, three seed rows)."""
    from holo_tpu_torch.ops.graph import diff_topologies
    from holo_tpu_torch.spf.synth import clone_topology

    keep = np.ones(base.n_edges, bool)
    keep[2] = False
    new = clone_topology(base, keep=keep, cost={0: int(base.edge_cost[0]) + 5})
    new.link_delta(diff_topologies(base, new))
    return new


def audit_ell(topo) -> EllGraph:
    return build_ell(topo, n_atoms=32 * _AUDIT_W)


def audit_masks(topo) -> np.ndarray:
    """bool [B, E] single-link failures (scenario 0 fails nothing)."""
    from holo_tpu_torch.spf.synth import whatif_link_failure_masks

    return whatif_link_failure_masks(topo, _AUDIT_B, seed=_AUDIT_SEED)


def audit_roots(topo) -> np.ndarray:
    return np.sort(np.random.default_rng(_AUDIT_SEED).choice(
        topo.n_vertices, _AUDIT_B, replace=False)).astype(np.int32)


def audit_specs(device) -> dict:
    """The arguments the registered programs take, on ``device``: the graph,
    the root, roots [B], a mask [E] and masks [B, E] (host bools, as the
    backend passes them)."""
    topo = audit_topology()
    masks = audit_masks(topo)
    return {
        "topo": topo,
        "g": device_graph_from_ell(audit_ell(topo), device),
        "root": int(topo.root),
        "roots": audit_roots(topo),
        "mask": masks[1],
        "masks": masks,
    }


def audit_incremental_specs(device, kp: int = 1) -> dict:
    """The DeltaPath arguments on ``device``: the delta graph, the previous
    run's planes on the base graph (``spf_one``; for ``kp`` > 1 the
    multipath run's, with its ``npaths`` and ``nh_weights``) and the seed
    rows."""
    base = audit_topology()
    new = audit_delta_topology(base)
    g0 = device_graph_from_ell(audit_ell(base), device)
    out = {"base": base, "topo": new, "root": int(base.root),
           "g": device_graph_from_ell(audit_ell(new), device),
           "seeds": new.delta_base.seed_rows()}
    if kp > 1:
        out["sp"], out["mp"] = spf_one_multipath(g0, out["root"], kp)
    else:
        out["sp"] = spf_one(g0, out["root"])
    return out


def _audit_delta_specs(device) -> tuple:
    """(resident graph, lowered delta): the resident marshaled from the base
    topology, the delta lowered against its mirror."""
    base = audit_topology()
    ell_graph = audit_ell(base)
    g = device_graph_from_ell(ell_graph, device)
    new = audit_delta_topology(base)
    return g, lower_delta(_EllMirror(ell_graph), new.delta_base, base.n_vertices)


_register_kernel(
    "spf.delta.apply",
    builder=lambda: apply_delta_slots,
    specs=_audit_delta_specs,
    donate=(0,),
    buckets=16,  # pow2 delta-row pads above _DELTA_PAD_FLOOR, per shape
)
