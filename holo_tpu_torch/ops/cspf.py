"""CSPF: constrained shortest paths as a masked batch of SSSPs.

Port of ``holo_tpu/ops/cspf.py`` (BASELINE.md config 4, "OSPF-SR/TE CSPF:
constrained shortest path as masked batched SSSP").  Each traffic-
engineering request carries constraints -- affinity include / exclude bits,
a minimum available bandwidth, a maximum per-link metric -- that lower to
an edge mask over one shared LSDB; a batch of requests is one lane-batched
:func:`~holo_tpu_torch.ops.spf_engine.spf_whatif_batch` on the card (the
gather engine's kernels, one lane a request), so hundreds of path
computations cost about one batched SPF.  The engine builds the masks on the
device from the requests' constraint values (:func:`device_constraint_masks`,
equal to :func:`constraint_masks`, which ``holo_tpu`` runs on the host): a
batch of 1024 requests over 729,000 edges is 746 MB of bools, which the card
computes at memory speed and never uploads.  The first-parent walk of each
path stays on the host, as in ``holo_tpu``: paths are short, the work is the
distances over the whole graph.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from holo_tpu_torch.analysis.runtime import sanctioned_transfer
from holo_tpu_torch.device import resolve_device
from holo_tpu_torch.ops.graph import INF, Topology, build_ell
from holo_tpu_torch.ops.spf_engine import device_graph_from_ell, spf_whatif_batch


@dataclass(frozen=True)
class LinkAttrs:
    """TE attributes per directed edge (arrays over the topology's edges).
    ``te_metric``, when given, replaces the IGP cost for CSPF: paths and
    ``max_link_metric`` then use TE metrics (RFC 3630)."""

    affinity: np.ndarray  # uint32[E] admin-group bits
    bandwidth: np.ndarray  # float64[E] available bandwidth
    te_metric: np.ndarray | None = None


@dataclass(frozen=True)
class Constraint:
    """One request's constraints."""

    include_any: int = 0  # affinity: at least one of these bits (0: any)
    exclude_any: int = 0  # affinity: none of these bits
    min_bandwidth: float = 0.0
    max_link_metric: int | None = None


def constraint_masks(topo: Topology, attrs: LinkAttrs, constraints: list) -> np.ndarray:
    """bool [B, E] edge masks of the requests' constraints; ``max_link_metric``
    is held against the active metric (the TE metric where ``attrs`` has one,
    else the IGP cost)."""
    costs = attrs.te_metric if attrs.te_metric is not None else topo.edge_cost
    masks = np.ones((len(constraints), topo.n_edges), bool)
    for m, c in zip(masks, constraints):
        if c.include_any:
            m &= (attrs.affinity & np.uint32(c.include_any)) != 0
        if c.exclude_any:
            m &= (attrs.affinity & np.uint32(c.exclude_any)) == 0
        if c.min_bandwidth > 0:
            m &= attrs.bandwidth >= c.min_bandwidth
        if c.max_link_metric is not None:
            m &= costs <= c.max_link_metric
    return masks


# Requests whose [chunk, E] mask temporaries are built at once on the device.
_MASK_ELEMENTS = 1 << 26


def device_constraint_masks(topo: Topology, attrs: LinkAttrs, constraints: list,
                            device) -> torch.Tensor:
    """:func:`constraint_masks` built on ``device``: bool [B, E], equal bit for
    bit (the affinity words as int64, the bandwidths compared in float64),
    from the attribute planes and one value per request and constraint."""
    dev = torch.device(device)
    n_edges = topo.n_edges
    costs = attrs.te_metric if attrs.te_metric is not None else topo.edge_cost
    aff = torch.from_numpy(np.asarray(attrs.affinity, np.uint32).astype(np.int64)).to(dev)
    bw = torch.from_numpy(np.asarray(attrs.bandwidth, np.float64)).to(dev)
    cost = torch.from_numpy(np.asarray(costs, np.int64)).to(dev)
    inc = np.asarray([np.uint32(c.include_any) for c in constraints], np.int64)
    exc = np.asarray([np.uint32(c.exclude_any) for c in constraints], np.int64)
    min_bw = np.asarray([c.min_bandwidth for c in constraints], np.float64)
    has_max = np.asarray([c.max_link_metric is not None for c in constraints], bool)
    max_metric = np.asarray([c.max_link_metric or 0 for c in constraints], np.int64)
    vals = [torch.from_numpy(x).to(dev)[:, None] for x in (inc, exc, min_bw, has_max,
                                                              max_metric)]
    out = torch.empty((len(constraints), n_edges), dtype=torch.bool, device=dev)
    step = max(1, _MASK_ELEMENTS // max(n_edges, 1))
    for b0 in range(0, len(constraints), step):
        i, e, mb, hm, mm = (v[b0: b0 + step] for v in vals)
        m = (i == 0) | ((aff & i) != 0)
        m &= (e == 0) | ((aff & e) == 0)
        m &= ~(mb > 0) | (bw >= mb)
        m &= ~hm | (cost <= mm)
        out[b0: b0 + step] = m
    return out


@dataclass
class CspfPath:
    dst: int
    cost: int | None  # None: unreachable under the constraints
    vertices: list = field(default_factory=list)  # root .. dst


class CspfEngine:
    """Batched TE path computation over one marshaled topology, on ``device``
    (the card unless "cpu")."""

    def __init__(self, topo: Topology, attrs: LinkAttrs, device=None):
        self.attrs = attrs
        if attrs.te_metric is not None:
            topo = Topology(
                n_vertices=topo.n_vertices, is_router=topo.is_router,
                edge_src=topo.edge_src, edge_dst=topo.edge_dst,
                edge_cost=np.asarray(attrs.te_metric, np.int32),
                edge_direct_atom=topo.edge_direct_atom, root=topo.root,
            )
        self.topo = topo
        self.device = resolve_device(device)
        self._g = device_graph_from_ell(build_ell(topo), self.device)

    def compute(self, constraints: list, dsts: list) -> list:
        """One path a (constraint, destination) pair, all of them one lane
        each in one batch; ``len(constraints) == len(dsts)``."""
        if len(constraints) != len(dsts):
            raise ValueError("constraints and dsts must pair up")
        if not constraints:
            return []
        with sanctioned_transfer("cspf.batch.marshal"):
            masks = device_constraint_masks(self.topo, self.attrs, constraints, self.device)
        out = spf_whatif_batch(self._g, self.topo.root, masks)
        with sanctioned_transfer("cspf.batch.unmarshal"):
            dist = out.dist.cpu().numpy()  # [B, N]
            parent = out.parent.cpu().numpy()
        n, root = self.topo.n_vertices, self.topo.root
        paths = []
        for b, dst in enumerate(dsts):
            if dist[b, dst] >= INF:
                paths.append(CspfPath(dst, None))
                continue
            chain = [dst]  # the first-parent chain, dst -> root
            v = dst
            while v != root and len(chain) <= n:
                v = int(parent[b, v])
                if v >= n:
                    break
                chain.append(v)
            chain.reverse()
            paths.append(CspfPath(dst, int(dist[b, dst]), chain))
        return paths
