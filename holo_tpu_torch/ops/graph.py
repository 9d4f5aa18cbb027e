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

_TOPOLOGY_UIDS = itertools.count()


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
    root: int = 0
    names: list = field(default_factory=list)  # optional, debugging only

    def __post_init__(self) -> None:
        self.is_router = np.asarray(self.is_router, dtype=bool)
        self.edge_src = np.asarray(self.edge_src, dtype=np.int32)
        self.edge_dst = np.asarray(self.edge_dst, dtype=np.int32)
        self.edge_cost = np.asarray(self.edge_cost, dtype=np.int32)
        if self.edge_direct_atom is None:
            self.edge_direct_atom = np.full(self.edge_src.shape, -1, np.int32)
        else:
            self.edge_direct_atom = np.asarray(self.edge_direct_atom, np.int32)
        # Identity for marshaling caches: a process-unique id plus a
        # generation bumped by touch().  Callers mutating arrays in place
        # MUST call touch() or cached device planes go stale.
        self._uid = next(_TOPOLOGY_UIDS)
        self.generation = 0

    def touch(self) -> None:
        """Invalidate marshaling caches after an in-place mutation."""
        self.generation += 1

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
            root=self.root,
            names=self.names,
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
