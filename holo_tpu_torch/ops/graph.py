"""Graph marshaling: LSDB-style directed graphs -> padded ELL arrays.

The port's own copy of the host-side graph model of ``holo_tpu.ops.graph``
(numpy only).  The protocol layer lowers its LSDB into a :class:`Topology`;
:func:`build_ell` packs it into the fixed-shape ELL (in-edge) layout.

Vertex ordering contract: vertex indices MUST be assigned in ascending SPF
tie-break order -- the reference pops candidates from a BTreeMap keyed by
``(distance, VertexId)`` (holo-ospf/src/spf.rs:614-622) where ``VertexId``
orders Network vertices before Router vertices (holo-ospf/src/ospfv2/spf.rs:42-45).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np

# Distances are exact int32; INF marks unreachable in host-facing planes.
INF = np.int32(1 << 30)

# Multipath path-count saturation (UCMP weights): every engine and the
# scalar oracle compute the same clamped recursion
#   npaths[v] = min(sum over DAG parents u of npaths[u], MP_SAT)
# over already-clamped parent values, which keeps a row sum exact in int32
# for any in-degree below 16384.
MP_SAT = np.int32(1 << 17)

_TOPOLOGY_UIDS = itertools.count()


def topology_namespace(topo) -> tuple:
    """The class of ``topo`` as (module, qualified name).  Marshaling caches
    key on it beside ``cache_key``: each Topology class (this package's and
    ``holo_tpu``'s) counts its uids from 0, so two classes' topologies can
    share a ``(uid, generation)`` pair."""
    cls = type(topo)
    return (cls.__module__, cls.__qualname__)


@dataclass
class Topology:
    """Host-side directed graph in SPF vertex space.

    Vertices are routers and transit networks (pseudo-nodes), pre-sorted by
    the protocol's tie-break key (networks first).  Edges are directed with
    int32 costs; network->router edges cost 0 (RFC 2328 §16.1).  Per-scenario
    what-if masks must mask both directions of a link.
    """

    n_vertices: int
    is_router: np.ndarray  # bool[N]
    edge_src: np.ndarray  # int32[E]
    edge_dst: np.ndarray  # int32[E]
    edge_cost: np.ndarray  # int32[E]
    # Direct next-hop atom id per edge, or -1: set for edges whose
    # relaxation yields a directly computed next hop (parent is the root or
    # a transit network adjacent to it, holo-ospf/src/spf.rs:744-767).
    edge_direct_atom: np.ndarray | None = None
    # Shared-risk link group membership per edge as a uint32 bitmask (bit g:
    # the edge is in SRLG g).  Read by the FRR engines' SRLG policy only; it
    # never enters the device graph, so DeltaPath residents cannot serve it
    # stale.  Default all-zero (no shared risk).
    edge_srlg: np.ndarray | None = None
    root: int = 0
    names: list = field(default_factory=list)  # optional, debugging only
    # Native partition hint: a group id per vertex (OSPF area, IS-IS
    # level), stamped by the protocol layer or a multi-area generator.
    # :func:`partition_topology` honours it verbatim; None means flat (the
    # BFS/greedy cut decides).  It never enters the device planes; a
    # changed hint is not delta-representable (:func:`diff_topologies`).
    partition_hint: np.ndarray | None = None

    def __post_init__(self) -> None:
        self.is_router = np.asarray(self.is_router, dtype=bool)
        self.edge_src = np.asarray(self.edge_src, dtype=np.int32)
        self.edge_dst = np.asarray(self.edge_dst, dtype=np.int32)
        self.edge_cost = np.asarray(self.edge_cost, dtype=np.int32)
        if self.edge_direct_atom is None:
            self.edge_direct_atom = np.full(self.edge_src.shape, -1, np.int32)
        else:
            self.edge_direct_atom = np.asarray(self.edge_direct_atom, np.int32)
        if self.edge_srlg is None:
            self.edge_srlg = np.zeros(self.edge_src.shape, np.uint32)
        else:
            self.edge_srlg = np.asarray(self.edge_srlg, np.uint32)
        if self.partition_hint is not None:
            self.partition_hint = np.asarray(self.partition_hint, np.int32)
        # Identity for marshaling caches: a process-unique id plus a
        # generation bumped by touch().  Callers mutating arrays in place
        # MUST call touch() or cached device planes go stale.
        self._uid = next(_TOPOLOGY_UIDS)
        self.generation = 0
        # DeltaPath lineage: a TopologyDelta from a previously marshaled
        # base topology (link_delta), which lets the SPF backend update the
        # base's resident device graph in place instead of re-marshaling.
        self.delta_base: TopologyDelta | None = None

    def touch(self) -> None:
        """Invalidate marshaling caches after an in-place mutation.

        Also drops the delta lineage: a delta describes the arrays as they
        were when it was diffed, so applying it after a mutation would
        serve a graph that misses the mutation."""
        self.generation += 1
        self.delta_base = None

    @property
    def cache_key(self) -> tuple:
        return (self._uid, self.generation)

    def n_atoms(self) -> int:
        """Number of distinct next-hop atoms referenced by edges (>= 1)."""
        if self.n_edges == 0:
            return 1
        return max(int(self.edge_direct_atom.max()) + 1, 1)

    @property
    def n_edges(self) -> int:
        return int(self.edge_src.shape[0])

    def link_delta(self, delta: TopologyDelta) -> None:
        """Attach DeltaPath lineage: this topology equals the base topology
        of ``delta.base_key`` with ``delta`` applied."""
        self.delta_base = delta

    def filter_mutual(self) -> "Topology":
        """Drop edges whose reverse edge does not exist (the reference's
        bidirectionality check, holo-ospf/src/spf.rs:653-664)."""
        keep = mutual_keep_mask(self.edge_src, self.edge_dst)
        return Topology(
            n_vertices=self.n_vertices,
            is_router=self.is_router,
            edge_src=self.edge_src[keep],
            edge_dst=self.edge_dst[keep],
            edge_cost=self.edge_cost[keep],
            edge_direct_atom=self.edge_direct_atom[keep],
            edge_srlg=self.edge_srlg[keep],
            root=self.root,
            names=self.names,
            partition_hint=self.partition_hint,
        )


class EllGraph(NamedTuple):
    """Fixed-shape layout: per-vertex padded in-edge lists.

    Padding slots have ``in_valid == False`` and ``in_src == 0`` (safe gather).
    """

    in_src: np.ndarray  # int32[N, K] source vertex of k-th in-edge
    in_cost: np.ndarray  # int32[N, K]
    in_valid: np.ndarray  # bool[N, K]
    in_edge_id: np.ndarray  # int32[N, K] original edge index (0 for pads)
    in_direct_atom: np.ndarray  # int32[N, K] atom id or -1
    is_router: np.ndarray  # bool[N]
    n_atoms: int  # number of next-hop atoms (bitmask width)

    @property
    def n_vertices(self) -> int:
        return self.in_src.shape[0]

    @property
    def k_pad(self) -> int:
        return self.in_src.shape[1]


def mutual_keep_mask(edge_src, edge_dst) -> np.ndarray:
    """bool[E]: edge has a reverse edge."""
    src = np.asarray(edge_src)
    dst = np.asarray(edge_dst)
    fwd = set(zip(src.tolist(), dst.tolist()))
    return np.array([(d, s) in fwd for s, d in zip(src, dst)], dtype=bool)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def build_ell(
    topo: Topology,
    k_pad: int | None = None,
    n_atoms: int = 64,
    k_multiple: int = 8,
) -> EllGraph:
    """Pack a :class:`Topology` into the ELL in-edge layout.

    ``k_pad`` defaults to max in-degree rounded up to ``k_multiple``.
    """
    n = topo.n_vertices
    counts = np.bincount(topo.edge_dst, minlength=n)
    kmax = int(counts.max()) if topo.n_edges else 1
    if k_pad is None:
        k_pad = max(_round_up(max(kmax, 1), k_multiple), k_multiple)
    elif kmax > k_pad:
        raise ValueError(f"k_pad={k_pad} < max in-degree {kmax}")
    if topo.n_atoms() > n_atoms:
        raise ValueError(
            f"topology references {topo.n_atoms()} next-hop atoms, "
            f"bitmask width n_atoms={n_atoms} is too small"
        )

    in_src = np.zeros((n, k_pad), np.int32)
    in_cost = np.zeros((n, k_pad), np.int32)
    in_valid = np.zeros((n, k_pad), bool)
    in_edge_id = np.zeros((n, k_pad), np.int32)
    in_direct_atom = np.full((n, k_pad), -1, np.int32)

    if topo.n_edges:
        # Stable-sort edges by destination; the slot of each edge is its
        # rank within its destination group.
        order = np.argsort(topo.edge_dst, kind="stable")
        dst_sorted = topo.edge_dst[order]
        first = np.searchsorted(dst_sorted, dst_sorted, side="left")
        slots = np.arange(topo.n_edges, dtype=np.int64) - first
        rows = dst_sorted.astype(np.int64)
        in_src[rows, slots] = topo.edge_src[order]
        in_cost[rows, slots] = topo.edge_cost[order]
        in_valid[rows, slots] = True
        in_edge_id[rows, slots] = order.astype(np.int32)
        in_direct_atom[rows, slots] = topo.edge_direct_atom[order]

    return EllGraph(
        in_src=in_src,
        in_cost=in_cost,
        in_valid=in_valid,
        in_edge_id=in_edge_id,
        in_direct_atom=in_direct_atom,
        is_router=topo.is_router.copy(),
        n_atoms=n_atoms,
    )


def _i32(values) -> np.ndarray:
    return np.asarray(list(values), np.int32).reshape(-1)


def delta_kind(delta) -> str:
    """The delta's taxonomy bucket (the ``kind`` label of the disposition
    counter): the single op class present, ``mixed`` when several combine,
    ``empty`` for a content-identical alias.  Reads the fields alone, so a
    ``holo_tpu`` delta gets the same answer as this package's."""
    present = [
        name
        for name, n in (
            ("struct", len(delta.r_src) + len(delta.a_src)),
            ("weight", len(delta.w_src)),
            ("overload", len(delta.overload)),
        )
        if n
    ]
    if not present:
        return "empty"
    return present[0] if len(present) == 1 else "mixed"


def delta_seed_rows(delta) -> np.ndarray:
    """int32[S] vertices whose previous distance may now be too small:
    targets of removed edges, targets of cost increases, and the overloaded
    vertices (every path through them passes them).  Reads the fields
    alone, as :func:`delta_kind`."""
    w_dst, w_old, w_new = (np.asarray(x) for x in (delta.w_dst, delta.w_old, delta.w_new))
    rows = [delta.r_dst, w_dst[w_new > w_old], delta.overload]
    return np.unique(np.concatenate([_i32(r) for r in rows]))


@dataclass
class TopologyDelta:
    """How a target topology differs from an already marshaled base
    topology (``base_key``, the base's ``cache_key``), in terms the resident
    ELL planes absorb as in-place slot writes (DeltaPath, arXiv:1808.06893):

    - weight changes: the same directed edge (src, dst, atom) with a new
      cost; edge indices stay valid (``ids_stable``);
    - edge removals and additions: a removal invalidates its slot, an
      addition takes padding slack in its destination row (none left: full
      rebuild).  Edge indices shift, so the updated graph no longer serves
      edge-mask consumers (``ids_stable`` False);
    - overload: every slot whose source is an ``overload`` vertex goes
      invalid (no transit through it; it stays reachable).
    """

    base_key: tuple  # (uid, generation) of the base Topology
    # cost changes: directed edge (src, dst, atom), old -> new cost
    w_src: np.ndarray = field(default_factory=lambda: _i32(()))
    w_dst: np.ndarray = field(default_factory=lambda: _i32(()))
    w_old: np.ndarray = field(default_factory=lambda: _i32(()))
    w_new: np.ndarray = field(default_factory=lambda: _i32(()))
    w_atom: np.ndarray = field(default_factory=lambda: _i32(()))
    # removed directed edges
    r_src: np.ndarray = field(default_factory=lambda: _i32(()))
    r_dst: np.ndarray = field(default_factory=lambda: _i32(()))
    r_cost: np.ndarray = field(default_factory=lambda: _i32(()))
    r_atom: np.ndarray = field(default_factory=lambda: _i32(()))
    # added directed edges
    a_src: np.ndarray = field(default_factory=lambda: _i32(()))
    a_dst: np.ndarray = field(default_factory=lambda: _i32(()))
    a_cost: np.ndarray = field(default_factory=lambda: _i32(()))
    a_atom: np.ndarray = field(default_factory=lambda: _i32(()))
    # vertices struck from transit (overload bit set since the base)
    overload: np.ndarray = field(default_factory=lambda: _i32(()))
    # True iff the base's edge order (in_edge_id) still holds for the
    # target: pure weight deltas only.
    ids_stable: bool = True

    @property
    def n_ops(self) -> int:
        return (
            self.w_src.shape[0]
            + self.r_src.shape[0]
            + self.a_src.shape[0]
            + self.overload.shape[0]
        )

    @property
    def kind(self) -> str:
        return delta_kind(self)

    def seed_rows(self) -> np.ndarray:
        return delta_seed_rows(self)


def diff_topologies(base: Topology, new: Topology, max_ops: int = 512) -> TopologyDelta | None:
    """The :class:`TopologyDelta` taking ``base`` to ``new``, or None when
    the change is not delta-representable: another vertex model or root, a
    changed partition hint (both packages' topologies carry one), or more than
    ``max_ops`` edge operations.

    Vertex identity is positional: diff only topologies built over the same
    vertex order and next-hop atom table.
    """
    if (
        base.n_vertices != new.n_vertices
        or base.root != new.root
        or not np.array_equal(base.is_router, new.is_router)
    ):
        return None
    bh, nh = getattr(base, "partition_hint", None), getattr(new, "partition_hint", None)
    if (bh is None) != (nh is None) or (bh is not None and not np.array_equal(bh, nh)):
        return None
    if base.n_edges == new.n_edges and (
        np.array_equal(base.edge_src, new.edge_src)
        and np.array_equal(base.edge_dst, new.edge_dst)
        and np.array_equal(base.edge_direct_atom, new.edge_direct_atom)
    ):
        # The same edge list in the same order: a pure weight delta, whose
        # edge ids stay valid for mask consumers.
        changed = np.nonzero(base.edge_cost != new.edge_cost)[0]
        if changed.shape[0] > max_ops:
            return None
        return TopologyDelta(
            base_key=base.cache_key,
            w_src=base.edge_src[changed].copy(),
            w_dst=base.edge_dst[changed].copy(),
            w_old=base.edge_cost[changed].copy(),
            w_new=new.edge_cost[changed].copy(),
            w_atom=base.edge_direct_atom[changed].copy(),
            ids_stable=True,
        )
    # Otherwise the multiset difference of the (src, dst, cost, atom) rows:
    # a moved or re-costed edge is one removal plus one addition.  The
    # edge-count gap is a lower bound on the op count.
    if abs(base.n_edges - new.n_edges) > max_ops:
        return None

    def rows(t) -> np.ndarray:
        out = np.empty((t.n_edges, 4), np.int32)
        out[:, 0] = t.edge_src
        out[:, 1] = t.edge_dst
        out[:, 2] = t.edge_cost
        out[:, 3] = t.edge_direct_atom
        return out

    both = np.concatenate([rows(base), rows(new)], axis=0)
    uniq, inv = np.unique(both, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    count = np.zeros(uniq.shape[0], np.int64)
    np.add.at(count, inv[: base.n_edges], 1)
    np.add.at(count, inv[base.n_edges:], -1)
    rem_mask = count > 0
    add_mask = count < 0
    n_ops = int(count[rem_mask].sum() - count[add_mask].sum())
    if n_ops > max_ops:
        return None
    r = np.repeat(uniq[rem_mask], count[rem_mask], axis=0)
    a = np.repeat(uniq[add_mask], -count[add_mask], axis=0)
    return TopologyDelta(
        base_key=base.cache_key,
        r_src=r[:, 0], r_dst=r[:, 1], r_cost=r[:, 2], r_atom=r[:, 3],
        a_src=a[:, 0], a_dst=a[:, 1], a_cost=a[:, 2], a_atom=a[:, 3],
        ids_stable=False,
    )


def _undirected_adjacency(n: int, edge_src, edge_dst) -> tuple[np.ndarray, np.ndarray]:
    """CSR (indptr, indices) of the undirected structure, neighbour lists
    ascending (the deterministic basis of :func:`partition_topology` and
    :func:`bandwidth_permutation`)."""
    src = np.concatenate([edge_src, edge_dst]).astype(np.int64)
    dst = np.concatenate([edge_dst, edge_src]).astype(np.int64)
    order = np.lexsort((dst, src))
    src, dst = src[order], dst[order]
    if src.shape[0]:  # drop parallel and mirrored duplicates
        keep = np.ones(src.shape[0], bool)
        keep[1:] = (src[1:] != src[:-1]) | (dst[1:] != dst[:-1])
        src, dst = src[keep], dst[keep]
    indptr = np.zeros(n + 1, np.int64)
    np.add.at(indptr, src + 1, 1)
    np.cumsum(indptr, out=indptr)
    return indptr, dst.astype(np.int32)


def bandwidth_permutation(n: int, edge_src, edge_dst) -> np.ndarray:
    """Reverse Cuthill-McKee order, ``holo_tpu.ops.graph.bandwidth_permutation``:
    int32 [n] ``perm`` with ``perm[new] = old``.  Relabeling the vertices by
    it puts each vertex's neighbours at nearby indices, which cuts the
    off-diagonal block pairs of a tiled layout.  Deterministic: components
    start at their least-degree (then lowest-id) vertex in that order, a BFS
    level is ordered by (first parent's rank, degree, id) -- the classic FIFO
    expansion with each parent's children sorted by (degree, id) -- and the
    final order is reversed."""
    indptr, nbrs = _undirected_adjacency(n, np.asarray(edge_src), np.asarray(edge_dst))
    deg = np.diff(indptr)
    seen = np.zeros(n, bool)
    chunks: list[np.ndarray] = []
    for s in np.lexsort((np.arange(n), deg)):
        if seen[s]:
            continue
        seen[s] = True
        frontier = np.asarray([s], np.int64)
        chunks.append(frontier)
        while frontier.shape[0]:
            counts = indptr[frontier + 1] - indptr[frontier]
            total = int(counts.sum())
            if total == 0:
                break
            # Every out-neighbour of the level, flattened from the CSR rows.
            flat = np.repeat(indptr[frontier] - np.concatenate([[0], np.cumsum(counts)[:-1]]),
                             counts) + np.arange(total)
            childs = nbrs[flat].astype(np.int64)
            prank = np.repeat(np.arange(frontier.shape[0]), counts)
            fresh = ~seen[childs]
            childs, prank = childs[fresh], prank[fresh]
            if childs.shape[0] == 0:
                break
            # Each child joins at its first parent's rank.
            first = np.lexsort((prank, childs))
            childs, prank = childs[first], prank[first]
            keep = np.ones(childs.shape[0], bool)
            keep[1:] = childs[1:] != childs[:-1]
            childs, prank = childs[keep], prank[keep]
            level = childs[np.lexsort((childs, deg[childs], prank))]
            seen[level] = True
            chunks.append(level)
            frontier = level
    order = np.concatenate(chunks) if chunks else np.empty(0, np.int64)
    return order[::-1].astype(np.int32)


def partition_topology(topo: Topology, n_parts: int | None = None,
                       max_part: int | None = None) -> np.ndarray:
    """int32[N] partition of the vertices (ids 0..P-1, none empty), the cut
    of ``holo_tpu.ops.graph.partition_topology``.

    A ``partition_hint`` is honoured verbatim: its distinct values map to
    dense ids in ascending order.  A flat graph gets a deterministic greedy
    cut: BFS-grown regions of ``ceil(N / n_parts)`` (or ``max_part``)
    vertices, each from the lowest unassigned vertex, neighbours in
    ascending order; then every region smaller than ``max(2, max_part //
    4)`` merges into the neighbour region it has most edges to (lowest id
    on a tie), smallest first.
    """
    n = topo.n_vertices
    hint = topo.partition_hint
    if hint is not None:
        if hint.shape[0] != n:
            raise ValueError(
                f"partition_hint has {hint.shape[0]} entries, topology has {n} vertices")
        return np.unique(hint, return_inverse=True)[1].reshape(-1).astype(np.int32)
    if max_part is None:
        if n_parts is None or n_parts < 1:
            raise ValueError("need n_parts or max_part for a flat cut")
        max_part = -(-n // int(n_parts))
    max_part = max(int(max_part), 1)
    indptr, nbrs = _undirected_adjacency(n, topo.edge_src, topo.edge_dst)
    part = np.full(n, -1, np.int32)
    next_part = 0
    cursor = 0  # the lowest vertex that may be unassigned
    while cursor < n:
        if part[cursor] >= 0:
            cursor += 1
            continue
        frontier = [cursor]
        part[cursor] = next_part
        size = 1
        while frontier and size < max_part:
            nxt: list[int] = []
            for v in frontier:
                for u in nbrs[indptr[v]: indptr[v + 1]]:
                    if part[u] < 0:
                        part[u] = next_part
                        nxt.append(int(u))
                        size += 1
                        if size >= max_part:
                            break
                if size >= max_part:
                    break
            frontier = nxt
        next_part += 1
    min_size = max(2, max_part // 4)
    sizes = np.bincount(part, minlength=next_part).astype(np.int64)
    esrc_p, edst_p = part[topo.edge_src], part[topo.edge_dst]
    alive = sizes > 0
    for _ in range(next_part):
        small = [p for p in range(next_part) if alive[p] and sizes[p] < min_size]
        if not small:
            break
        p = min(small, key=lambda q: (sizes[q], q))
        cut = esrc_p != edst_p
        touch = np.concatenate([edst_p[cut & (esrc_p == p)], esrc_p[cut & (edst_p == p)]])
        if touch.shape[0] == 0:  # an isolated component: kept as it is
            alive[p] = False
            continue
        target = int(np.argmax(np.bincount(touch, minlength=next_part)))
        part[part == p] = target
        esrc_p, edst_p = part[topo.edge_src], part[topo.edge_dst]
        sizes[target] += sizes[p]
        sizes[p] = 0
        alive[p] = False
    return np.unique(part, return_inverse=True)[1].reshape(-1).astype(np.int32)
