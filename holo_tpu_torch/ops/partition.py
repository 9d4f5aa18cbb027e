"""Partitioned SPF: a multi-area LSDB solved part by part, then stitched.

Port of ``holo_tpu/ops/partition.py``.  The topology is cut into P parts (its
native ``partition_hint``, or the greedy cut of
:func:`~holo_tpu_torch.ops.graph.partition_topology`) and solved in three
exact phases:

1. boundary solve: in every part, the distances from each of its skeleton
   vertices (the endpoints of cut edges, and the root) over its own edges;
2. skeleton stitch: a host Dijkstra over the skeleton, whose edges are those
   part-internal distances and the cut edges, gives every skeleton vertex its
   exact global distance (between two cut-edge crossings a shortest path
   stays inside one part);
3. final solve: every part relaxes from those seeds (3a); then its first
   parents, hops and next-hop words (for ``kp`` > 1 also path counts, per-atom
   weights and parent sets) come from the joint fixpoint with the halo rows
   pinned to values exchanged through the skeleton, and the host runs it
   again until the exchanged values stop changing (3b).  The DAG is acyclic,
   so the fixpoint is unique: the result equals the monolithic engine's and
   the scalar oracle's.

Layout.  JAX vmaps each program over a [P, L, K] partition axis.  Here the
parts are stacked into one block-diagonal ELL graph (a :class:`DeviceGraph`
of R rows, R the sum of the parts' sizes), which the gather engine's kernels
run as they run any graph.  Part p holds its own vertices and its halo (the
sources of cut edges into p) in rows ``[base[p], base[p + 1])``, in ascending
vertex id; every edge lands in the part of its destination, a cut edge with
its source's halo row as source.  Halo rows carry no slots, so no lane ever
leaves its part, and the smallest row among a row's DAG sources is the
smallest vertex id: the reference's tie-break (JAX's ``gid_nbr`` minimum)
with no id plane.  An invalid slot's source is its own row, so a stack of a
subset of the parts (:func:`part_stack`, JAX's ``gather_parts_kernel``) is a
row gather plus a shift of each part's sources.

The kernels, per phase (``holo_tpu_torch.kernels.ell``):

- phase 1: ``ell_relax`` (G1), lane c seeded at the c-th skeleton vertex of
  every part (JAX's ``boundary_dist_kernel``), the lanes in chunks of
  ``root_chunk``;
- phase 3a: ``ell_relax`` at one lane (``final_dist_kernel``);
- phase 3b: ``ell_first_parent`` (G2; for ``kp`` > 1 ``ell_parent_sets``,
  M2) once a stack, then ``ell_mp_round`` (M1; without the count and weight
  planes for ``kp`` = 1) rounds: JAX's ``phase2_kernel`` is the joint
  recompute round of hops and next-hop words (one changed flag over both,
  ``_hops_nh_fixpoint``'s round), whose truncated runs differ from the
  separate hops and next-hop OR rounds of ``spf_one``; then for ``kp`` > 1
  ``ell_parent_weights`` (M3, ``mp_sets_kernel``'s weights).

Every fixpoint stops where JAX's stops: at ``limit`` rounds (``l_pad``, JAX's
padded part size, or ``max_iters``) or when no lane changed.  A converged
part is left as it is by another Jacobi round, so running every part in one
loop gives each part JAX's own rounds.  Hops in the stack use the kernels'
sentinel R + 1 (unreached); the exchange tables and results use N + 1.
"""

from __future__ import annotations

import heapq
import time
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from holo_tpu_torch import telemetry
from holo_tpu_torch.analysis.runtime import note_donated, read_flag, sanctioned_transfer
from holo_tpu_torch.device import resolve_device
from holo_tpu_torch.kernels import ell
from holo_tpu_torch.ops.graph import INF as _INF
from holo_tpu_torch.ops.graph import EllGraph, Topology, partition_topology
from holo_tpu_torch.telemetry import profiling
from holo_tpu_torch.ops.spf_engine import (
    DeltaSlots,
    DeviceGraph,
    _EllMirror,
    apply_delta_slots,
    device_graph_from_ell,
    mp_fixpoint,
)

_PART_STAGES = telemetry.counter(
    "holo_spf_partition_total",
    "Partitioned-SPF stage dispatches (batched partition programs, "
    "skeleton stitches, exchange rounds, delta dispositions)", ("stage",))
_PART_PARTS = telemetry.gauge("holo_spf_partition_parts", "Partitions of the last partitioned solve")
_PART_SKEL = telemetry.gauge(
    "holo_spf_partition_skeleton", "Skeleton (boundary-contraction) vertices of the last solve")
_PART_ROUNDS = telemetry.gauge(
    "holo_spf_partition_exchange_rounds",
    "Halo-exchange outer rounds of the last partitioned phase 2")
_PART_RESOLVED = telemetry.gauge(
    "holo_spf_partition_resolved",
    "Partitions re-solved by the last partitioned dispatch (full solve: "
    "all of them; DeltaPath: the affected set + changed-seed closure)")
_PART_MARSHAL_SECONDS = telemetry.histogram(
    "holo_spf_partition_marshal_seconds",
    "Host-side partition marshal (stacked local ELL expansion)")


def note_partition(stage: str) -> None:
    """One partitioned-SPF stage, ``holo_spf_partition_total{stage}``."""
    _PART_STAGES.labels(stage=stage).inc()

INF = int(_INF)
# Elements of the largest [R, lanes] distance plane of one boundary-solve
# dispatch when ``root_chunk`` is None (1 GiB of int32).
_PLANE_ELEMENTS = 1 << 28


def _pow2(n: int, floor: int = 1) -> int:
    out = max(int(floor), 1)
    while out < n:
        out *= 2
    return out


@dataclass
class PartitionPlan:
    """Host-side geometry of a cut: JAX's ``PartitionPlan`` fields, then the
    stacked layout (:func:`stack_layout`)."""

    n_vertices: int
    n_parts: int
    root: int
    part_of: np.ndarray  # int32[N]
    verts: list  # [P] int32 own vertices, ascending
    halo: list  # [P] int32 halo vertices (cut-edge sources into p), ascending
    skel: np.ndarray  # int32[S] skeleton vertices, ascending
    skel_pos: np.ndarray  # int32[N]: index into skel, -1 elsewhere
    bnd: list  # [P] int32 the part's own skeleton vertices, ascending
    cut_src: np.ndarray  # int32[C] cut edges
    cut_dst: np.ndarray
    cut_cost: np.ndarray
    cut_eid: np.ndarray  # edge indices of the cut edges
    l_pad: int = 0  # JAX's padded part size: the fixpoints' round limit
    k_pad: int = 0
    b_pad: int = 0
    bnd_skel: list = field(default_factory=list)  # [P] skeleton positions of bnd
    halo_skel: list = field(default_factory=list)  # [P] skeleton positions of halo
    # The stacked layout.
    base: np.ndarray | None = None  # int64[P + 1]: part p's rows [base[p], base[p+1])
    gid: np.ndarray | None = None  # int32[R]: the vertex of each row
    pinned: np.ndarray | None = None  # bool[R]: halo rows
    row_of: np.ndarray | None = None  # int64[N]: each vertex's row in its own part
    bnd_rows: list = field(default_factory=list)  # [P] int64 rows of bnd[p]
    halo_rows: list = field(default_factory=list)  # [P] int64 rows of halo[p] in p

    @property
    def n_skel(self) -> int:
        return int(self.skel.shape[0])

    @property
    def n_rows(self) -> int:
        return int(self.base[-1])

    @property
    def root_row(self) -> int:
        return int(self.row_of[self.root])

    def row_keys(self) -> np.ndarray:
        """int64[R] ascending keys ``part * N + vertex`` of the rows."""
        part = np.repeat(np.arange(self.n_parts, dtype=np.int64), np.diff(self.base))
        return part * self.n_vertices + self.gid


def stack_layout(plan: PartitionPlan) -> PartitionPlan:
    """Fill ``plan``'s stacked layout from its parts' vertices and halos."""
    n = plan.n_vertices
    members = [np.sort(np.concatenate([plan.verts[p], plan.halo[p]])).astype(np.int32)
               for p in range(plan.n_parts)]
    plan.base = np.concatenate([[0], np.cumsum([m.shape[0] for m in members])]).astype(np.int64)
    plan.gid = (np.concatenate(members) if members else np.zeros(0, np.int32)).astype(np.int32)
    plan.pinned = np.zeros(plan.n_rows, bool)
    plan.row_of = np.full(n, -1, np.int64)
    plan.halo_rows = []
    for p, m in enumerate(members):
        plan.row_of[plan.verts[p]] = plan.base[p] + np.searchsorted(m, plan.verts[p])
        rows = plan.base[p] + np.searchsorted(m, plan.halo[p])
        plan.pinned[rows] = True
        plan.halo_rows.append(rows.astype(np.int64))
    plan.bnd_rows = [plan.row_of[b] for b in plan.bnd]
    return plan


def build_plan(topo: Topology, n_parts: int | None = None, max_part: int | None = None,
               part_of: np.ndarray | None = None) -> PartitionPlan:
    """Cut ``topo`` (``part_of`` overrides the cut) and derive the geometry:
    JAX's ``build_plan`` with the parts' vertices in ascending order (no RCM
    relabeling) and the stacked layout."""
    n = topo.n_vertices
    if part_of is None:
        part_of = partition_topology(topo, n_parts=n_parts, max_part=max_part)
    part_of = np.asarray(part_of, np.int32)
    n_p = int(part_of.max()) + 1 if n else 1
    cut_idx = np.nonzero(part_of[topo.edge_src] != part_of[topo.edge_dst])[0].astype(np.int32)
    skel = np.unique(np.concatenate([topo.edge_src[cut_idx], topo.edge_dst[cut_idx],
                                     np.asarray([topo.root], np.int32)])).astype(np.int32)
    skel_pos = np.full(n, -1, np.int32)
    skel_pos[skel] = np.arange(skel.shape[0], dtype=np.int32)
    halo_dst_part = part_of[topo.edge_dst[cut_idx]]
    verts, halo, bnd = [], [], []
    for p in range(n_p):
        verts.append(np.nonzero(part_of == p)[0].astype(np.int32))
        halo.append(np.unique(topo.edge_src[cut_idx[halo_dst_part == p]]).astype(np.int32))
        bnd.append(skel[part_of[skel] == p])
    plan = PartitionPlan(
        n_vertices=n, n_parts=n_p, root=int(topo.root), part_of=part_of, verts=verts,
        halo=halo, skel=skel, skel_pos=skel_pos, bnd=bnd,
        cut_src=topo.edge_src[cut_idx].copy(), cut_dst=topo.edge_dst[cut_idx].copy(),
        cut_cost=topo.edge_cost[cut_idx].copy(), cut_eid=cut_idx,
    )
    plan.l_pad = _pow2(max(verts[p].shape[0] + halo[p].shape[0] for p in range(n_p)), floor=8)
    plan.b_pad = _pow2(max(max(b.shape[0] for b in bnd), 1))
    plan.bnd_skel = [skel_pos[b].astype(np.int32) for b in bnd]
    plan.halo_skel = [skel_pos[h].astype(np.int32) for h in halo]
    return stack_layout(plan)


def marshal_partitions(topo: Topology, plan: PartitionPlan, n_atoms: int) -> EllGraph:
    """The stacked ELL planes of ``plan`` (host, numpy; ``build_ell`` over the
    R stacked rows): every edge in its destination's row, its source the
    source's row in the destination's part (a halo row for a cut edge), the
    slots of a row in ascending edge order; ``k_pad`` JAX's (the largest
    in-degree rounded up to 8).  An invalid slot's source is its own row."""
    t0 = time.perf_counter()
    if topo.n_atoms() > n_atoms:
        raise ValueError(f"topology references {topo.n_atoms()} next-hop atoms, "
                         f"bitmask width n_atoms={n_atoms} is too small")
    n, r = topo.n_vertices, plan.n_rows
    counts = np.bincount(topo.edge_dst, minlength=n)
    kmax = int(counts.max()) if topo.n_edges else 1
    k_pad = plan.k_pad = max(((max(kmax, 1) + 7) // 8) * 8, 8)
    in_src = np.repeat(np.arange(r, dtype=np.int32)[:, None], k_pad, axis=1)
    in_cost = np.zeros((r, k_pad), np.int32)
    in_valid = np.zeros((r, k_pad), bool)
    in_eid = np.zeros((r, k_pad), np.int32)
    in_atom = np.full((r, k_pad), -1, np.int32)
    if topo.n_edges:
        dst_rows = plan.row_of[topo.edge_dst]
        dpart = plan.part_of[topo.edge_dst].astype(np.int64)
        src_rows = np.searchsorted(plan.row_keys(), dpart * n + topo.edge_src)
        order = np.argsort(dst_rows, kind="stable")
        d_s = dst_rows[order]
        slots = np.arange(topo.n_edges, dtype=np.int64) - np.searchsorted(d_s, d_s, side="left")
        in_src[d_s, slots] = src_rows[order]
        in_cost[d_s, slots] = topo.edge_cost[order]
        in_valid[d_s, slots] = True
        in_eid[d_s, slots] = order.astype(np.int32)
        in_atom[d_s, slots] = topo.edge_direct_atom[order]
    note_partition("marshal")
    _PART_MARSHAL_SECONDS.observe(time.perf_counter() - t0)
    return EllGraph(in_src=in_src, in_cost=in_cost, in_valid=in_valid, in_edge_id=in_eid,
                    in_direct_atom=in_atom, is_router=topo.is_router[plan.gid].copy(),
                    n_atoms=n_atoms)


class PartStack(NamedTuple):
    """Parts of a plan stacked into one graph: all of them (the resident's
    planes) or a subset (:func:`part_stack`)."""

    parts: list  # plan partitions, in stack order
    base: np.ndarray  # int64[len(parts) + 1]: stack part i's rows
    rows: np.ndarray  # int64[R_sub]: each row's row in the full stack
    g: DeviceGraph
    slot: torch.Tensor  # int32[R_sub, K]: the slot's edge id where usable, else -1

    @property
    def n_rows(self) -> int:
        return int(self.base[-1])

    def local(self, plan: PartitionPlan, i: int, rows: np.ndarray) -> np.ndarray:
        """Stack rows of full-stack ``rows`` of stack part i."""
        return rows - plan.base[self.parts[i]] + self.base[i]

    def root_lane(self, plan: PartitionPlan) -> torch.Tensor:
        """int32 [1]: the root's stack row, R_sub (no row) where the root's
        part is not in the stack."""
        p = int(plan.part_of[plan.root])
        row = self.n_rows
        if p in self.parts:
            i = self.parts.index(p)
            row = int(self.local(plan, i, np.asarray([plan.root_row]))[0])
        # A fill on the device: no host tensor is copied up.
        return torch.full((1,), row, dtype=torch.int32, device=self.slot.device)


def slot_plane(g: DeviceGraph, edge_mask: torch.Tensor | None) -> torch.Tensor:
    """JAX's ``_slot_ok`` folded into the slot plane once a call: the edge id
    where the slot is valid and its edge up in ``edge_mask`` (bool [E] on the
    device, or None), -1 elsewhere.  Every lane shares it."""
    ok = g.in_valid
    if edge_mask is not None and edge_mask.numel() > 0:
        ok = ok & edge_mask[g.in_edge_id.long()]
    return torch.where(ok, g.in_edge_id, -1).to(torch.int32)


def part_stack(plan: PartitionPlan, g: DeviceGraph, parts, edge_mask=None) -> PartStack:
    """The stack of ``parts`` (all of them: ``g`` itself), JAX's
    ``gather_parts_kernel``: the parts' rows gathered on the device, each
    part's sources shifted to its rows in the stack."""
    parts = [int(p) for p in parts]
    if parts == list(range(plan.n_parts)):
        rows = np.arange(plan.n_rows, dtype=np.int64)
        return PartStack(parts, plan.base, rows, g, slot_plane(g, edge_mask))
    sizes = np.asarray([plan.base[p + 1] - plan.base[p] for p in parts], np.int64)
    base = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    rows = (np.concatenate([np.arange(plan.base[p], plan.base[p + 1]) for p in parts])
            if parts else np.zeros(0, np.int64)).astype(np.int64)
    shift = np.repeat(base[:-1] - plan.base[parts], sizes).astype(np.int32)
    dev = g.in_src.device
    with sanctioned_transfer("spf.partition.gather"):
        idx = torch.from_numpy(rows).to(dev)
        shift_t = torch.from_numpy(shift).to(dev)
    sub = DeviceGraph(
        in_src=(g.in_src[idx] + shift_t[:, None]).contiguous(),
        in_cost=g.in_cost[idx], in_valid=g.in_valid[idx], in_edge_id=g.in_edge_id[idx],
        direct_nh_words=g.direct_nh_words[idx], is_router=g.is_router[idx],
    )
    return PartStack(parts, base, rows, sub, slot_plane(sub, edge_mask))


def relax_fixpoint(st: PartStack, dist: torch.Tensor, limit: int) -> tuple[torch.Tensor, int]:
    """JAX's ``_relax_one`` for every lane of every stacked part: (dist,
    rounds) from the seed plane ``dist`` [R_sub, B].  The first frontier is
    every finite row: a seed is not the output of a round."""
    front = ell.pack_lane_bits(dist < INF)
    rounds = 0
    for _ in range(limit):
        dist, changed, front = ell.ell_relax(st.g.in_src, st.g.in_cost, st.slot, None, dist,
                                             front)
        rounds += 1
        if not read_flag("spf.flag.partition_relax", changed):
            break
    return dist, rounds


def boundary_dist(st: PartStack, rows: torch.Tensor, cols: torch.Tensor, lanes: int,
                  limit: int) -> tuple[torch.Tensor, int]:
    """Phase 1's device program for one chunk of lanes (JAX's
    ``boundary_dist_kernel``): (dist int32 [R_sub, lanes], relax rounds),
    lane ``cols[i]`` seeded 0 at stack row ``rows[i]`` (int64 tensors on the
    stack's device), INF elsewhere, then :func:`relax_fixpoint`."""
    dist = torch.full((st.n_rows, lanes), INF, dtype=torch.int32, device=rows.device)
    dist.index_put_((rows, cols), torch.zeros(rows.shape, dtype=torch.int32, device=rows.device))
    return relax_fixpoint(st, dist, limit)


def boundary_tables(plan: PartitionPlan, st: PartStack, limit: int,
                    root_chunk: int | None = None) -> tuple[np.ndarray, int]:
    """Phase 1 (JAX's ``boundary_dist_kernel`` over ``_root_chunks``):
    (btab int64[len(parts), b_pad, b_pad], relax rounds), ``btab[i, a, b]``
    the distance inside stack part i from its a-th skeleton vertex to its
    b-th, INF past the part's count.  Lane c is seeded at the c-th skeleton
    vertex of every part; the lanes go in chunks of ``root_chunk`` (None: as
    many as keep the plane under 1 GiB).  Each lane's fixpoint is its own,
    so the tables do not depend on the chunking."""
    counts = np.asarray([plan.bnd[p].shape[0] for p in st.parts], np.int64)
    btab = np.full((len(st.parts), plan.b_pad, plan.b_pad), INF, np.int64)
    lanes = int(counts.max()) if counts.shape[0] else 0
    if lanes == 0:
        return btab, 0
    if root_chunk is None:
        chunk = max(32, (_PLANE_ELEMENTS // max(st.n_rows, 1)) // 32 * 32)
    else:
        chunk = max(int(root_chunk), 1)
    rows = np.concatenate([st.local(plan, i, plan.bnd_rows[p]) for i, p in enumerate(st.parts)])
    owner = np.repeat(np.arange(len(st.parts)), counts)
    col = np.concatenate([np.arange(c) for c in counts]).astype(np.int64)
    dev = st.slot.device
    rows_t = torch.from_numpy(rows).to(dev)
    rounds = 0
    for c0 in range(0, lanes, chunk):
        c1 = min(c0 + chunk, lanes)
        sel = (col >= c0) & (col < c1)
        dist, r = boundary_dist(st, torch.from_numpy(rows[sel]).to(dev),
                                torch.from_numpy(col[sel] - c0).to(dev), c1 - c0, limit)
        rounds += r
        out = dist[rows_t].cpu().numpy()  # [S_sub, c1 - c0]
        note_partition("bdist")
        btab[owner[:, None], np.arange(c0, c1)[None, :], col[:, None]] = out
    return btab, rounds


def skeleton_solve(plan: PartitionPlan, btab: np.ndarray,
                   cut_mask: np.ndarray | None = None) -> np.ndarray:
    """Exact skeleton distances from the root (JAX's ``skeleton_solve``):
    int64[S], INF unreachable.  Edges: every part's finite skeleton-to-
    skeleton distances (``btab``, a row per part) and the cut edges
    (``cut_mask`` drops failed ones); Dijkstra over their CSR, each pop
    relaxing its out-edges as one numpy step."""
    s = plan.n_skel
    srcs, dsts, wgts = [], [], []
    for p in range(plan.n_parts):
        pos = plan.bnd_skel[p].astype(np.int64)
        b = pos.shape[0]
        tab = btab[p, :b, :b]
        i, j = np.nonzero((tab < INF) & ~np.eye(b, dtype=bool))
        srcs.append(pos[i])
        dsts.append(pos[j])
        wgts.append(tab[i, j])
    keep = np.ones(plan.cut_src.shape[0], bool) if cut_mask is None else np.asarray(cut_mask)
    srcs.append(plan.skel_pos[plan.cut_src[keep]].astype(np.int64))
    dsts.append(plan.skel_pos[plan.cut_dst[keep]].astype(np.int64))
    wgts.append(plan.cut_cost[keep].astype(np.int64))
    src, dst, wgt = (np.concatenate(x) for x in (srcs, dsts, wgts))
    order = np.argsort(src, kind="stable")
    dst, wgt = dst[order], wgt[order]
    indptr = np.searchsorted(src[order], np.arange(s + 1))
    dist = np.full(s, INF, np.int64)
    root_pos = int(plan.skel_pos[plan.root])
    dist[root_pos] = 0
    done = np.zeros(s, bool)
    heap = [(0, root_pos)]
    while heap:
        d, v = heapq.heappop(heap)
        if done[v]:
            continue
        done[v] = True
        nbr = dst[indptr[v]: indptr[v + 1]]
        nd = d + wgt[indptr[v]: indptr[v + 1]]
        better = nd < dist[nbr]
        if better.any():
            nbr, nd = nbr[better], nd[better]
            # a vertex listed twice keeps its smaller offer
            first = np.lexsort((nd, nbr))
            nbr, nd = nbr[first], nd[first]
            uniq = np.ones(nbr.shape[0], bool)
            uniq[1:] = nbr[1:] != nbr[:-1]
            nbr, nd = nbr[uniq], nd[uniq]
            dist[nbr] = nd
            for u, du in zip(nbr.tolist(), nd.tolist()):
                heapq.heappush(heap, (du, u))
    note_partition("skeleton")
    return dist


def final_seeds(plan: PartitionPlan, st: PartStack, skel_dist: np.ndarray) -> np.ndarray:
    """Phase 3 seeds int32[R_sub] (JAX's ``_seeds``): the exact skeleton
    distances at every part's own skeleton rows and halo rows, INF elsewhere."""
    out = np.full(st.n_rows, INF, np.int64)
    for i, p in enumerate(st.parts):
        out[st.local(plan, i, plan.bnd_rows[p])] = skel_dist[plan.bnd_skel[p]]
        out[st.local(plan, i, plan.halo_rows[p])] = skel_dist[plan.halo_skel[p]]
    return np.minimum(out, INF).astype(np.int32)


def final_distances(plan: PartitionPlan, st: PartStack, skel_dist: np.ndarray,
                    limit: int) -> tuple[torch.Tensor, int]:
    """Phase 3a (JAX's ``final_dist_kernel``): (dist int32 [R_sub, 1], relax
    rounds), every part relaxed from :func:`final_seeds`; halo rows have no
    slots, so their seeds stay."""
    seeds = torch.from_numpy(final_seeds(plan, st, skel_dist)).to(st.slot.device)
    return relax_fixpoint(st, seeds[:, None].contiguous(), limit)


class _Dag(NamedTuple):
    """A stack's settled DAG (one lane): G2's (or M2's) outputs."""

    roots: torch.Tensor  # int32[1]
    parent: torch.Tensor  # int32[R_sub, 1] stack row, R_sub for none
    dag: torch.Tensor  # int32[R_sub, K, 1] DAG bits
    parents: torch.Tensor | None  # int32[R_sub, kp, 1] (kp > 1)
    pdist: torch.Tensor | None


def stack_dag(plan: PartitionPlan, st: PartStack, dist: torch.Tensor, kp: int) -> _Dag:
    """The first parents and DAG bits of a stack (``ell_first_parent``; for
    ``kp`` > 1 ``ell_parent_sets``, which also gives the parent sets)."""
    roots = st.root_lane(plan)
    planes = (st.g.in_src, st.g.in_cost, st.slot, None, dist, roots)
    if kp > 1:
        parent, dag, parents, pdist = ell.ell_parent_sets(*planes, kp)
        return _Dag(roots, parent, dag, parents, pdist)
    parent, dag = ell.ell_first_parent(*planes)
    return _Dag(roots, parent, dag, None, None)


def pinned_fixpoint(st: PartStack, d: _Dag, pin_rows: torch.Tensor, pins, kp: int,
                    limit: int) -> tuple[tuple, int]:
    """Phase 3b's inner loop (JAX's ``phase2_kernel`` / ``phase2_mp_kernel``
    fixpoint): (planes, rounds), planes = (hops [R_sub, 1], nh [R_sub, W, 1],
    npaths [R_sub, 1], aw [R_sub, A, 1]; the last two None for ``kp`` = 1).

    Seeds: hops 0 at the root row, R_sub + 1 elsewhere, next hops 0, npaths
    1 at the root, weights 0, and the halo rows ``pin_rows`` set to ``pins``
    (the same tuple of values, [H], [H, W], [H], [H, A]).  The first round
    recomputes every row (a seed is not a round's output); halo rows have no
    slot, so it gives them the no-parent value, which is put back, and their
    frontier bits are cleared: no later round recomputes them.  The changed
    flag of that round is read from the cleaned frontier, the values JAX's
    round compares.  Later rounds are :func:`mp_fixpoint`'s."""
    g = st.g
    r, dev = st.n_rows, st.slot.device
    words = g.direct_nh_words.shape[2]
    at_root = torch.arange(r, device=dev)[:, None] == d.roots.long()[None, :]
    hops = torch.full((r, 1), r + 1, dtype=torch.int32, device=dev)
    hops.masked_fill_(at_root, 0)
    state = [hops, torch.zeros((r, words, 1), dtype=torch.int32, device=dev), None, None]
    if kp > 1:
        state[2] = at_root.to(torch.int32)
        state[3] = torch.zeros((r, 32 * words, 1), dtype=torch.int32, device=dev)
    for x, v in zip(state, pins):
        if x is not None:
            x[pin_rows] = v.reshape(-1, *x.shape[1:])
    state = tuple(state)
    if limit <= 0:
        return state, 0
    before = tuple(None if x is None else torch.empty_like(x) for x in state)
    front = ell.full_frontier(r, 1, dev)
    inc = g.is_router.to(torch.int32)
    _, front = ell.ell_mp_round(g.in_src, d.dag, g.direct_nh_words, inc, d.roots, d.parent,
                                state, front, before)
    for x, s in zip(before, state):
        if x is not None:
            x[pin_rows] = s[pin_rows]
    front.index_fill_(0, pin_rows, 0)  # a fill on the device, no host scalar
    changed = read_flag("spf.flag.partition_pin", front.any())
    state, before = before, state
    if not changed:
        return state, 1
    out, rounds = mp_fixpoint(g, d.roots, d.dag, d.parent, state, before, front, limit - 1)
    return out, rounds + 1


@dataclass
class PartResident:
    """A topology's partitioned planes on the device, and the state of its
    last mask-free solve (DeltaPath re-solves from it).  Host planes are per
    stacked row; hops use N + 1 and parents vertex ids (N for none)."""

    plan: PartitionPlan
    graph: DeviceGraph
    mirror: _EllMirror
    n_atoms: int
    topo_key: tuple | None  # (uid, generation) the planes serve; None: serves nothing
    hint: np.ndarray | None  # the partition hint the cut came from
    kp: int = 1
    btab: np.ndarray | None = None  # int64[P, b_pad, b_pad]
    skel_dist: np.ndarray | None = None  # int64[S]
    dist: np.ndarray | None = None  # int32[R]
    hops: np.ndarray | None = None
    nh: np.ndarray | None = None  # int32[R, W]
    parent: np.ndarray | None = None
    npaths: np.ndarray | None = None
    aw: np.ndarray | None = None  # int32[R, A]
    sets: tuple | None = None  # (parents, pdist, pweight) int32[R, kp]
    tables: dict | None = None  # the exchange tables of the last solve
    last_resolved: int = 0
    exchange_rounds: int = 0
    delta_depth: int = 0
    # A structural delta shifted edge indices: the planes' in_edge_id no
    # longer serves edge masks (DeviceGraphCache's ids_stale).
    ids_stale: bool = False
    timings: dict = field(default_factory=dict)  # ms a phase of the last call
    rounds: dict = field(default_factory=dict)  # rounds a phase of the last call

    def serves(self, topo: Topology) -> bool:
        """The planes are ``topo``'s and were cut from its partition hint."""
        return self.topo_key == topo.cache_key and _same_hint(self.hint, topo.partition_hint)

    def stats(self) -> dict:
        return {
            "parts": self.plan.n_parts,
            "skeleton": self.plan.n_skel,
            "cut-edges": int(self.plan.cut_src.shape[0]),
            "rows": self.plan.n_rows,
            "l-pad": self.plan.l_pad,
            "b-pad": self.plan.b_pad,
            "boundary-lanes": max((b.shape[0] for b in self.plan.bnd), default=0),
            "resolved": self.last_resolved,
            "exchange-rounds": self.exchange_rounds,
            "delta-depth": self.delta_depth,
            "ids-stale": self.ids_stale,
        }


class _PartUnappliable(Exception):
    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


def _tables(n: int, words: int, n_skel: int) -> dict:
    """Fresh exchange tables (JAX's ``_ExchangeState``): the skeleton
    vertices' hops (N + 1), next-hop words, path counts and weights."""
    return {"hops": np.full(n_skel, n + 1, np.int32),
            "nh": np.zeros((n_skel, words), np.int32),
            "npaths": np.zeros(n_skel, np.int32),
            "aw": np.zeros((n_skel, 32 * words), np.int32)}


_PLANES = ("hops", "nh", "npaths", "aw")


class PartitionedSpfEngine:
    """Marshal, full solve and DeltaPath of the partitioned SPF (JAX's
    ``PartitionedSpfEngine``) on ``device`` (the card unless "cpu").  Results
    are host planes in vertex space, equal to the monolithic engine's."""

    #: the exchange's cap on outer rounds, in skeleton sizes (a guard against
    #: a logic fault: tripping it raises)
    EXCHANGE_CAP_SLACK = 4

    def __init__(self, device=None, max_iters: int | None = None,
                 root_chunk: int | None = None):
        self.device = resolve_device(device)
        self.max_iters = max_iters
        self.root_chunk = root_chunk

    def _limit(self, plan: PartitionPlan) -> int:
        return plan.l_pad if self.max_iters is None else self.max_iters

    def marshal(self, topo: Topology, n_atoms: int, n_parts: int | None = None,
                max_part: int | None = None, part_of=None) -> PartResident:
        plan = build_plan(topo, n_parts=n_parts, max_part=max_part, part_of=part_of)
        host = marshal_partitions(topo, plan, n_atoms)
        hint = topo.partition_hint
        _PART_PARTS.set(plan.n_parts)
        _PART_SKEL.set(plan.n_skel)
        return PartResident(plan=plan, graph=device_graph_from_ell(host, self.device),
                            mirror=_EllMirror(host), n_atoms=n_atoms, topo_key=topo.cache_key,
                            hint=None if hint is None else hint.copy())

    # -- the full solve ------------------------------------------------------

    def solve(self, topo: Topology, res: PartResident, edge_mask=None, kp: int = 1) -> dict:
        """The three phases over every part.  Returns the SpfResult planes in
        vertex space; without ``edge_mask`` the resident keeps the solve's
        state for DeltaPath."""
        plan = res.plan
        limit = self._limit(plan)
        t0 = time.perf_counter()
        mask = None
        if edge_mask is not None:
            mask = torch.from_numpy(np.asarray(edge_mask, bool)).to(self.device)
        st = part_stack(plan, res.graph, range(plan.n_parts), mask)
        # The phases are holo_tpu's stages of the partitioned site, beside
        # the host timings the solve keeps (``res.timings``).
        with profiling.stage("spf.partitioned", "bdist"):
            btab, r_bdist = boundary_tables(plan, st, limit, self.root_chunk)
        t1 = time.perf_counter()
        cut_mask = None if edge_mask is None else np.asarray(edge_mask, bool)[plan.cut_eid]
        with profiling.stage("spf.partitioned", "stitch"):
            skel_dist = skeleton_solve(plan, btab, cut_mask)
        t2 = time.perf_counter()
        with profiling.stage("spf.partitioned", "dist"):
            dist, r_dist = final_distances(plan, st, skel_dist, limit)
            dist_h = dist[:, 0].cpu().numpy()
        note_partition("dist")
        t3 = time.perf_counter()
        words = res.graph.direct_nh_words.shape[2]
        tables = _tables(plan.n_vertices, words, plan.n_skel)
        planes = self._fresh_planes(plan, words, kp)
        stacks = {tuple(st.parts): (st, stack_dag(plan, st, dist, kp))}
        with profiling.stage("spf.partitioned", "phase2"):
            info = self._exchange(res, st.parts, tables, planes, stacks, dist_h, mask, kp,
                                  limit, full=True)
        t4 = time.perf_counter()
        sets = self._sets(res, planes, stacks, info["resolved"], dist_h, mask, kp)
        if kp > 1:
            note_partition("mpsets")
        out = assemble(plan, dist_h, planes, sets, kp)
        t5 = time.perf_counter()
        timings = {"bdist_ms": (t1 - t0) * 1e3, "stitch_ms": (t2 - t1) * 1e3,
                   "dist_ms": (t3 - t2) * 1e3, "exchange_ms": (t4 - t3) * 1e3,
                   "assemble_ms": (t5 - t4) * 1e3}
        rounds = {"bdist": r_bdist, "dist": r_dist, "exchange": info["rounds"],
                  "exchange_inner": info["inner"]}
        if edge_mask is None:
            res.kp, res.btab, res.skel_dist, res.dist = kp, btab, skel_dist, dist_h
            res.tables = tables
            res.hops, res.nh, res.parent, res.npaths, res.aw = planes
            res.sets = sets
            res.last_resolved = plan.n_parts
            res.exchange_rounds = info["rounds"]
        res.timings, res.rounds = timings, rounds
        _PART_RESOLVED.set(plan.n_parts)
        _PART_ROUNDS.set(info["rounds"])
        note_partition("solve")
        return out

    def _fresh_planes(self, plan: PartitionPlan, words: int, kp: int) -> list:
        """Host result rows before any exchange: (hops, nh, parent, npaths,
        aw), JAX's initial local planes."""
        r, n = plan.n_rows, plan.n_vertices
        return [np.full(r, n + 1, np.int32), np.zeros((r, words), np.int32),
                np.full(r, n, np.int32), np.zeros(r, np.int32),
                np.zeros((r, 32 * words), np.int32) if kp > 1 else None]

    def _stack_for(self, res, parts, dist_h, mask, kp, stacks) -> tuple[PartStack, _Dag]:
        """The stack of ``parts`` and its DAG, from ``stacks`` (tuple of parts
        -> both) or made now, the distances uploaded from the host rows."""
        key = tuple(parts)
        if key not in stacks:
            st = part_stack(res.plan, res.graph, parts, mask)
            dist = torch.from_numpy(dist_h[st.rows]).to(self.device)[:, None].contiguous()
            stacks[key] = (st, stack_dag(res.plan, st, dist, kp))
        return stacks[key]

    def _exchange(self, res, parts, tables, planes, stacks, dist_h, mask, kp, limit,
                  full: bool) -> dict:
        """Phase 3b's outer loop (JAX's ``_exchange``): run the pinned
        fixpoint over the active parts, fold their skeleton rows' values into
        the tables; the next active parts are those whose halo reads a value
        that changed (a full solve keeps every part active until nothing
        changed).  Updates ``tables`` and the host rows ``planes`` (hops, nh,
        parent, npaths, aw) of every active part; returns the rounds, each
        round's fixpoint rounds and the parts resolved."""
        plan = res.plan
        n = plan.n_vertices
        cap = self.EXCHANGE_CAP_SLACK * (plan.n_skel + 2)
        active = list(parts)
        resolved = set(parts)
        inner = []
        for _ in range(cap):
            if not active:
                break
            st, d = self._stack_for(res, active, dist_h, mask, kp, stacks)
            big = st.n_rows + 1
            pin_local = np.concatenate([st.local(plan, i, plan.halo_rows[p])
                                        for i, p in enumerate(active)]).astype(np.int64)
            pos = np.concatenate([plan.halo_skel[p] for p in active]).astype(np.int64)
            hops_pin = tables["hops"][pos]
            pins = [np.where(hops_pin >= n + 1, big, hops_pin), tables["nh"][pos]]
            if kp > 1:
                pins += [tables["npaths"][pos], tables["aw"][pos]]
            pin_rows = torch.from_numpy(pin_local).to(self.device)
            pins_t = [torch.from_numpy(np.ascontiguousarray(x, np.int32)).to(self.device)
                      for x in pins]
            state, rounds = pinned_fixpoint(st, d, pin_rows, pins_t, kp, limit)
            inner.append(rounds)
            note_partition("phase2-round")
            host = [None if x is None else x.cpu().numpy() for x in state]
            hops = host[0][:, 0]
            host[0] = np.where(hops >= big, n + 1, hops).astype(np.int32)
            host[1] = host[1][:, :, 0]
            if kp > 1:
                host[2], host[3] = host[2][:, 0], host[3][:, :, 0]
            parent = d.parent[:, 0].cpu().numpy()
            gid = np.concatenate([plan.gid[st.rows], [n]]).astype(np.int32)
            for k, name in enumerate(_PLANES):
                if host[k] is not None:
                    planes[(0, 1, 3, 4)[k]][st.rows] = host[k]
            planes[2][st.rows] = gid[parent]
            changed = np.zeros(plan.n_skel, bool)
            for i, p in enumerate(active):
                b_pos = plan.bnd_skel[p]
                b_loc = st.local(plan, i, plan.bnd_rows[p])
                for k, name in enumerate(_PLANES):
                    if host[k] is None:
                        continue
                    exp = host[k][b_loc]
                    diff = tables[name][b_pos] != exp
                    if diff.ndim > 1:
                        diff = diff.any(axis=1)
                    changed[b_pos[diff]] = True
                    tables[name][b_pos] = exp
            nxt = [p for p in range(plan.n_parts)
                   if plan.halo_skel[p].shape[0] and changed[plan.halo_skel[p]].any()]
            if full:
                active = list(range(plan.n_parts)) if nxt else []
            else:
                active = nxt
            resolved.update(active)
        else:
            raise RuntimeError(f"partitioned exchange did not settle within {cap} rounds")
        return {"rounds": len(inner), "inner": inner, "resolved": sorted(resolved)}

    def _sets(self, res, planes, stacks, resolved, dist_h, mask, kp):
        """The parent sets of the resolved parts' rows (kp > 1): M2's parents
        and pdist of their stack (from the exchange's DAG when it ran on that
        stack), M3's weights from the settled path counts.  Host rows in
        vertex ids (``res.sets`` updated in place when it exists), or None."""
        if kp <= 1:
            return None
        plan = res.plan
        n, r = plan.n_vertices, plan.n_rows
        sets = res.sets if res.sets is not None and res.kp == kp and resolved != list(
            range(plan.n_parts)) else (np.full((r, kp), n, np.int32),
                                       np.full((r, kp), INF, np.int32),
                                       np.zeros((r, kp), np.int32))
        if not resolved:
            return sets
        st, d = self._stack_for(res, resolved, dist_h, mask, kp, stacks)
        npaths = torch.from_numpy(planes[3][st.rows]).to(self.device)[:, None].contiguous()
        pweight = ell.ell_parent_weights(d.parents, npaths)
        gid = np.concatenate([plan.gid[st.rows], [n]]).astype(np.int32)
        sets[0][st.rows] = gid[d.parents[:, :, 0].cpu().numpy()]
        sets[1][st.rows] = d.pdist[:, :, 0].cpu().numpy()
        sets[2][st.rows] = pweight[:, :, 0].cpu().numpy()
        return sets

    # -- DeltaPath -----------------------------------------------------------

    def _lower_delta(self, res: PartResident, delta) -> tuple[DeltaSlots, list]:
        """JAX's ``_lower_delta``: the delta's ops as writes of the touched
        stacked slots (moving the mirror, and the plan's cut-edge costs, to
        the post-delta state) and the affected parts.  Raises
        :class:`_PartUnappliable` on what the resident cannot absorb: an
        overload strike, a structural op on a cut edge, padding or atom
        overflow, an op that matches no mirrored slot."""
        plan, mir = res.plan, res.mirror
        keys = plan.row_keys()
        n = plan.n_vertices

        def src_row(p: int, src: int) -> int:
            k = p * n + src
            i = int(np.searchsorted(keys, k))
            if i >= keys.shape[0] or keys[i] != k:
                raise _PartUnappliable("halo-missing")
            return i

        def find(row: int, src: int, cost: int, atom: int) -> int:
            hit = np.nonzero(mir.in_valid[row] & (mir.in_src[row] == src)
                             & (mir.in_cost[row] == cost) & (mir.in_atom[row] == atom))[0]
            if hit.shape[0] == 0:
                raise _PartUnappliable("missing-edge")
            return int(hit[0])

        d = delta
        if len(d.overload):
            raise _PartUnappliable("overload")
        touched: set[tuple[int, int]] = set()
        affected: set[int] = set()
        for src, dst, cost, atom in zip(d.r_src, d.r_dst, d.r_cost, d.r_atom):
            if plan.part_of[src] != plan.part_of[dst]:
                raise _PartUnappliable("cut-struct")
            p = int(plan.part_of[dst])
            row = int(plan.row_of[dst])
            col = find(row, src_row(p, int(src)), cost, atom)
            mir.in_valid[row, col] = False
            mir.in_src[row, col] = row
            mir.in_cost[row, col] = 0
            mir.in_atom[row, col] = -1
            touched.add((row, col))
            affected.add(p)
        for src, dst, old, new, atom in zip(d.w_src, d.w_dst, d.w_old, d.w_new, d.w_atom):
            p = int(plan.part_of[dst])
            row = int(plan.row_of[dst])
            col = find(row, src_row(p, int(src)), old, atom)
            mir.in_cost[row, col] = new
            touched.add((row, col))
            affected.add(p)
            if plan.part_of[src] != p:  # a cut edge's cost: the skeleton edge moves
                hit = np.nonzero((plan.cut_src == src) & (plan.cut_dst == dst)
                                 & (plan.cut_cost == old))[0]
                if hit.shape[0] == 0:
                    raise _PartUnappliable("cut-missing")
                plan.cut_cost[hit[0]] = new
        for src, dst, cost, atom in zip(d.a_src, d.a_dst, d.a_cost, d.a_atom):
            if plan.part_of[src] != plan.part_of[dst]:
                raise _PartUnappliable("cut-struct")
            if atom >= res.n_atoms:
                raise _PartUnappliable("atom-overflow")
            p = int(plan.part_of[dst])
            row = int(plan.row_of[dst])
            free = np.nonzero(~mir.in_valid[row])[0]
            if free.shape[0] == 0:
                raise _PartUnappliable("padding-overflow")
            col = int(free[0])
            mir.in_valid[row, col] = True
            mir.in_src[row, col] = src_row(p, int(src))
            mir.in_cost[row, col] = cost
            mir.in_atom[row, col] = atom
            touched.add((row, col))
            affected.add(p)
        rc = np.array(sorted(touched), np.int64).reshape(-1, 2)
        rows, cols = rc[:, 0], rc[:, 1]
        atom = mir.in_atom[rows, cols]
        words = np.zeros((rows.shape[0], max((res.n_atoms + 31) // 32, 1)), np.uint32)
        has = np.nonzero(atom >= 0)[0]
        words[has, atom[has] // 32] = np.uint32(1) << (atom[has] % 32).astype(np.uint32)
        ops = DeltaSlots(rows=rows, cols=cols, src=mir.in_src[rows, cols],
                         cost=mir.in_cost[rows, cols], valid=mir.in_valid[rows, cols],
                         words=words.view(np.int32), strike=None)
        return ops, sorted(affected)

    def try_delta(self, topo: Topology, res: PartResident, kp: int = 1):
        """Serve a delta-linked ``topo`` from the resident (JAX's
        ``try_delta``): the delta written into the planes in place, the
        boundary solve of the affected parts only, the skeleton stitched
        again, the final solve of the parts whose seeds changed, and the
        exchange from the last solve's tables over the parts whose seeds or
        halo values changed.  Returns (result, info): the result None where
        the resident does not serve the delta (``info["reason"]``; the caller
        solves in full), else ``info`` counts the re-solved parts and the
        exchange rounds.  After a delta it cannot absorb, the resident serves
        nothing."""
        delta = getattr(topo, "delta_base", None)
        plan = res.plan
        if delta is None:
            return None, {"reason": "no-lineage"}
        if res.btab is None or tuple(delta.base_key) != res.topo_key:
            if res.btab is not None:
                note_partition("delta-no-base")
            return None, {"reason": "no-base"}
        if kp != res.kp:
            note_partition("delta-kp-flip")
            return None, {"reason": "kp-flip"}
        if not _same_hint(res.hint, topo.partition_hint):
            return None, {"reason": "hint"}
        t0 = time.perf_counter()
        try:
            ops, affected = self._lower_delta(res, delta)
        except _PartUnappliable as exc:
            # The mirror (and the plan's cut costs) may be half-moved.
            res.topo_key = None
            res.btab = None
            note_partition(f"delta-{exc.reason}")
            return None, {"reason": exc.reason}
        apply_delta_slots(res.graph, ops)
        # The resident's planes hold the new generation from here: a solve
        # still reading them for the base fails its finish under the guard.
        note_donated("spf.partition.delta", res.graph, generation=topo.cache_key)
        note_partition("delta-apply")
        res.topo_key = topo.cache_key
        res.delta_depth += 1
        res.ids_stale = res.ids_stale or not delta.ids_stable
        limit = self._limit(plan)
        r_bdist = r_dist = 0
        if affected:
            st = part_stack(plan, res.graph, affected)
            btab_sub, r_bdist = boundary_tables(plan, st, limit, self.root_chunk)
            res.btab[affected] = btab_sub
            note_partition("delta-bdist")
        t1 = time.perf_counter()
        skel_new = skeleton_solve(plan, res.btab)
        need = set(affected)
        for p in range(plan.n_parts):
            pos = np.concatenate([plan.bnd_skel[p], plan.halo_skel[p]])
            if pos.shape[0] and (skel_new[pos] != res.skel_dist[pos]).any():
                need.add(p)
        res.skel_dist = skel_new
        parts_d = sorted(need)
        t2 = time.perf_counter()
        stacks = {}
        if parts_d:
            st = part_stack(plan, res.graph, parts_d)
            dist, r_dist = final_distances(plan, st, skel_new, limit)
            res.dist[st.rows] = dist[:, 0].cpu().numpy()
            note_partition("delta-dist")
            stacks[tuple(parts_d)] = (st, stack_dag(plan, st, dist, kp))
        t3 = time.perf_counter()
        planes = [res.hops, res.nh, res.parent, res.npaths, res.aw]
        info = self._exchange(res, parts_d, res.tables, planes, stacks, res.dist, None, kp,
                              limit, full=False)
        resolved = sorted(set(info["resolved"]) | set(parts_d))
        t4 = time.perf_counter()
        res.sets = self._sets(res, planes, stacks, resolved, res.dist, None, kp)
        res.last_resolved = len(resolved)
        res.exchange_rounds = info["rounds"]
        out = assemble(plan, res.dist, planes, res.sets, kp)
        t5 = time.perf_counter()
        res.timings = {"bdist_ms": (t1 - t0) * 1e3, "stitch_ms": (t2 - t1) * 1e3,
                       "dist_ms": (t3 - t2) * 1e3, "exchange_ms": (t4 - t3) * 1e3,
                       "assemble_ms": (t5 - t4) * 1e3}
        res.rounds = {"bdist": r_bdist, "dist": r_dist, "exchange": info["rounds"],
                      "exchange_inner": info["inner"]}
        _PART_RESOLVED.set(len(resolved))
        _PART_ROUNDS.set(info["rounds"])
        note_partition("delta-solve")
        return out, {"resolved": len(resolved), "parts": plan.n_parts,
                     "rounds": info["rounds"], "affected": len(affected)}


def _same_hint(a, b) -> bool:
    return (a is None) == (b is None) and (a is None or np.array_equal(a, b))


def assemble(plan: PartitionPlan, dist: np.ndarray, planes, sets, kp: int) -> dict:
    """The SpfResult planes in vertex space from the host rows (JAX's
    ``_assemble``): each vertex from its own part's row; unreachable
    vertices get parent N and hops N + 1 (and npaths 0); next-hop words
    reinterpreted as uint32."""
    n = plan.n_vertices
    own = ~plan.pinned
    gids = plan.gid[own]
    hops, nh, parent, npaths, aw = planes

    def scatter(rows, fill, width=None):
        shape = (n,) if width is None else (n, width)
        out = np.full(shape, fill, np.int32)
        out[gids] = rows[own]
        return out

    d = scatter(dist, INF)
    unreach = d >= INF
    out = {"dist": d, "parent": scatter(parent, n), "hops": scatter(hops, n + 1),
           "nexthop_words": scatter(nh, 0, nh.shape[1]).view(np.uint32)}
    out["parent"][unreach] = n
    out["hops"][unreach] = n + 1
    if kp > 1:
        npv = scatter(npaths, 0)
        npv[unreach] = 0
        out.update(parents=scatter(sets[0], n, kp), pdist=scatter(sets[1], INF, kp),
                   pweight=scatter(sets[2], 0, kp), npaths=npv,
                   nh_weights=scatter(aw, 0, aw.shape[1]))
    return out


# -- kernel-contract audit registrations (HL3xx) ------------------------
# Inert contract descriptors for holo_tpu_torch.analysis.kernel_audit: the
# device programs of PartitionedSpfEngine's phases (holo_tpu's partition
# kernels), at a fixed audit limit.  The thunks run only when the audit
# runs.
from holo_tpu_torch.analysis.kernels import register_kernel as _register_kernel  # noqa: E402

#: ``holo_tpu``'s audit sizes: 4 parts of 32 rows (here 4 grid areas of 4 x 8
#: routers joined by 2 gateway pairs each, plus their halo rows).
_AUDIT_P, _AUDIT_L = 4, 32
_AUDIT_LIMIT = 32


def audit_part_topology() -> Topology:
    from holo_tpu_torch.spf.synth import multiarea_topology

    return multiarea_topology(_AUDIT_P, 4, _AUDIT_L // 4, gateways=2, seed=1)


def _audit_part_specs(device) -> dict:
    """The resident of the audit topology on ``device`` after one full
    solve, and each phase's device inputs built from it as the engine builds
    them."""
    topo = audit_part_topology()
    eng = PartitionedSpfEngine(device)
    res = eng.marshal(topo, 64)
    eng.solve(topo, res)
    plan = res.plan
    st = part_stack(plan, res.graph, range(plan.n_parts))
    counts = [plan.bnd[p].shape[0] for p in st.parts]
    rows = np.concatenate([st.local(plan, i, plan.bnd_rows[p]) for i, p in enumerate(st.parts)])
    cols = np.concatenate([np.arange(c) for c in counts]).astype(np.int64)
    pin = np.concatenate([plan.halo_rows[p] for p in st.parts]).astype(np.int64)
    pos = np.concatenate([plan.halo_skel[p] for p in st.parts]).astype(np.int64)
    hops = res.tables["hops"][pos]
    pins = (np.where(hops >= plan.n_vertices + 1, st.n_rows + 1, hops), res.tables["nh"][pos])
    up = lambda x, dt=torch.int32: torch.from_numpy(np.ascontiguousarray(x)).to(device, dt)  # noqa: E731
    return {
        "plan": plan, "g": res.graph, "st": st, "rows": up(rows, torch.int64),
        "cols": up(cols, torch.int64), "lanes": int(max(counts)),
        "seed": up(final_seeds(plan, st, res.skel_dist)[:, None]),
        "dist": up(res.dist[:, None]), "pin": up(pin, torch.int64),
        "pins": tuple(up(x) for x in pins), "parts": [1, 2],
        "res": res, "eng": eng, "topo": topo,
    }


def _audit_part_delta_specs(device) -> tuple:
    """(the resident's graph, a delta lowered against its mirror): one
    link's cost raised inside area 1."""
    from holo_tpu_torch.ops.graph import diff_topologies
    from holo_tpu_torch.spf.synth import clone_topology

    a = _audit_part_specs(device)
    topo, plan = a["topo"], a["plan"]
    inner = np.nonzero((plan.part_of[topo.edge_src] == 1)
                       & (plan.part_of[topo.edge_dst] == 1))[0]
    e = int(inner[0])
    new = clone_topology(topo, cost={e: int(topo.edge_cost[e]) + 3})
    ops, _ = a["eng"]._lower_delta(a["res"], diff_topologies(topo, new))
    return a["g"], ops


def _pick(*keys):
    return lambda device: (lambda a: tuple(a[k] for k in keys))(_audit_part_specs(device))


_register_kernel(
    "spf.partition.bdist",
    builder=lambda: lambda st, rows, cols, lanes: boundary_dist(
        st, rows, cols, lanes, _AUDIT_LIMIT),
    specs=_pick("st", "rows", "cols", "lanes"),
    buckets=16,  # pow2 partition-lane x root-chunk buckets
)

_register_kernel(
    "spf.partition.fdist",
    builder=lambda: lambda st, seed: relax_fixpoint(st, seed, _AUDIT_LIMIT),
    specs=_pick("st", "seed"),
    buckets=16,
)

_register_kernel(
    "spf.partition.phase2",
    builder=lambda: lambda plan, st, dist, pin, pins: pinned_fixpoint(
        st, stack_dag(plan, st, dist, 1), pin, pins, 1, _AUDIT_LIMIT),
    specs=_pick("plan", "st", "dist", "pin", "pins"),
    buckets=16,
)

_register_kernel(
    "spf.partition.gather",
    builder=lambda: part_stack,
    specs=_pick("plan", "g", "parts"),
    buckets=8,  # pow2 gather-subset lanes
)

_register_kernel(
    "spf.partition.apply_delta",
    builder=lambda: apply_delta_slots,
    specs=_audit_part_delta_specs,
    donate=(0,),
    buckets=16,  # pow2 delta-row pads
)
