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

from typing import NamedTuple

import numpy as np
import torch

from holo_tpu_torch.device import resolve_device
from holo_tpu_torch.kernels import ell
from holo_tpu_torch.ops.graph import INF as _INF
from holo_tpu_torch.ops.graph import EllGraph

INF = int(_INF)


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


def device_graph_from_ell(ell_graph: EllGraph, device=None) -> DeviceGraph:
    """Expand per-slot direct atoms into one-hot words (host side), then
    upload the six planes."""
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
    return DeviceGraph(**{f: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                          for f, x in planes.items()})


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
    return ell.pack_lane_bits(m.to(device).T)


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
        if not bool(changed):
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
    ext[roots.long(), torch.arange(batch, device=parent.device)] = 0
    pidx = parent.long()
    inc = g.is_router.to(torch.int32)[:, None]
    for _ in range(limit):
        hops = ext[:n]
        ph = torch.gather(ext, 0, pidx)
        new = torch.minimum(hops, torch.where(ph < big, ph + inc, big))
        changed = bool((new != hops).any())
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
        if not bool(changed):
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


def spf_one(g: DeviceGraph, root: int, edge_mask=None, max_iters=None) -> SpfTensors:
    """Full SPF: distances + first parent + hops + ECMP next-hop words."""
    dev = g.in_src.device
    mask = None if edge_mask is None else pack_edge_masks(np.asarray(edge_mask)[None], dev)
    out = _batch_major(*spf_lanes(g, _roots(root, 1, dev), mask, max_iters))
    return SpfTensors(*(x[0] for x in out))


def spf_whatif_batch(
    g: DeviceGraph, root: int, edge_masks, max_iters=None, engine: str = "seq"
) -> SpfTensors:
    """Batched what-if SPF over scenario edge masks (bool [B, E]): [B, N]
    planes, next hops [B, N, W].  Mask *both* directions of a failed link."""
    if engine != "seq":
        raise ValueError(
            f"one_engine {engine!r}: the port runs only 'seq' (the fused, packed "
            f"and hybrid formulations are ROADMAP queue A item 8)"
        )
    dev = g.in_src.device
    mask = pack_edge_masks(edge_masks, dev)
    batch = int(np.shape(edge_masks)[0])
    return _batch_major(*spf_lanes(g, _roots(root, batch, dev), mask, max_iters))


def spf_multiroot(g: DeviceGraph, roots, edge_mask=None, max_iters=None) -> SpfTensors:
    """SPF from many roots (int32 [R]): [R, N] dist, parent and hops.

    ``nexthops`` is None: the direct atoms are marshaled relative to the
    topology's own root, so next hops mean nothing for another root, and
    ``MultiRootResult`` has no next-hop plane.
    """
    dev = g.in_src.device
    roots_t = torch.as_tensor(np.asarray(roots, np.int32)).to(dev)
    mask = None
    if edge_mask is not None:
        shared = np.repeat(np.asarray(edge_mask, bool)[None], roots_t.shape[0], axis=0)
        mask = pack_edge_masks(shared, dev)
    return _batch_major(*spf_lanes(g, roots_t, mask, max_iters, nexthops=False))
