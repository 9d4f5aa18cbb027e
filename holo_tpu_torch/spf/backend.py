"""SPF backends of the port.

``SpfBackend.compute`` is the single dispatch point the protocol layer calls
from its SPF-delay FSM (the reference's compute site:
holo-ospf/src/spf.rs:428-435).  :class:`ScalarSpfBackend` is the exact
host oracle; :class:`TorchSpfBackend` runs on the CUDA card, whose kernels
are hand-written CUDA, with two engines:

- ``engine="gather"`` (the default, as in ``holo_tpu``): the ELL fixpoints
  of :mod:`holo_tpu_torch.ops.spf_engine` (``one_engine="seq"``), for any
  topology;
- ``engine="blocked"``: the block-sparse engine of
  :mod:`holo_tpu_torch.ops.blocked_spf`.  A topology outside its
  preconditions (parallel ``(src, dst)`` pairs, distances >= 2**27, more
  than 4 failed edges in a scenario) goes to the gather engine, as in
  ``holo_tpu``; ``routed_to_gather`` counts those dispatches.

Unlike ``holo_tpu``'s backend there is no scalar fallback, no breaker and
no DeltaPath (``incremental``): a topology's ``delta_base`` is ignored,
which gives the bits of JAX's full path.  ``multipath_k > 1`` raises.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass

import numpy as np

from holo_tpu_torch.device import resolve_device
from holo_tpu_torch.ops.blocked_spf import (
    failed_edges_perm,
    marshal_block_spf,
    whatif_spf_blocked,
)
from holo_tpu_torch.ops.graph import Topology, build_ell
from holo_tpu_torch.ops.spf_engine import (
    device_graph_from_ell,
    spf_multiroot,
    spf_one,
    spf_whatif_batch,
)
from holo_tpu_torch.spf.scalar import spf_reference

_CACHE_ENTRIES = 4


@dataclass
class SpfResult:
    """Backend-independent SPF output in host (numpy) space."""

    dist: np.ndarray  # int32[N]
    parent: np.ndarray  # int32[N]
    hops: np.ndarray  # int32[N]
    nexthop_words: np.ndarray  # uint32[N, W]


@dataclass
class MultiRootResult:
    """Multi-root SPF output: SPT shape only (see compute_multiroot)."""

    dist: np.ndarray  # int32[R, N]
    parent: np.ndarray  # int32[R, N]
    hops: np.ndarray  # int32[R, N]


def _single_path(multipath_k: int) -> None:
    if multipath_k > 1:
        raise ValueError(
            f"multipath_k={multipath_k}: multipath is a later slice of the port "
            f"(ROADMAP queue A item 9); only multipath_k=1 runs"
        )


def _host_tensors(out, n: int):
    """Device SPF tensors -> the host contract, one bulk copy a plane: the
    vertex axis sliced back to N and the sentinels renormalized to N (no
    parent) and N + 1 (unreachable hops).  The port never pads rows, so
    every step is a no-op kept for ``holo_tpu``'s contract."""
    dist = out.dist.cpu().numpy()[..., :n]
    parent = np.minimum(out.parent.cpu().numpy()[..., :n], np.int32(n))
    hops = np.minimum(out.hops.cpu().numpy()[..., :n], np.int32(n + 1))
    nh = None
    if out.nexthops is not None:
        nh = out.nexthops.cpu().numpy().view(np.uint32)[..., :n, :]
    return dist, parent, hops, nh


class SpfBackend:
    """Interface: one SPF run, a what-if batch, or a multi-root batch."""

    name = "abstract"

    def compute(self, topo: Topology, edge_mask=None, multipath_k: int = 1) -> SpfResult:
        raise NotImplementedError

    def compute_whatif(self, topo: Topology, edge_masks, multipath_k: int = 1) -> list:
        raise NotImplementedError


class ScalarSpfBackend(SpfBackend):
    """Exact reference-semantics Dijkstra on the host CPU."""

    name = "scalar"

    def __init__(self, n_atoms: int = 64):
        self.n_atoms = n_atoms

    def compute(self, topo, edge_mask=None, multipath_k: int = 1):
        _single_path(multipath_k)
        out = spf_reference(topo, edge_mask)
        return SpfResult(
            dist=out.dist,
            parent=out.parent,
            hops=out.hops,
            nexthop_words=out.nexthop_words(max(self.n_atoms, topo.n_atoms())),
        )

    def compute_whatif(self, topo, edge_masks, multipath_k: int = 1):
        return [self.compute(topo, m, multipath_k) for m in edge_masks]

    def compute_multiroot(self, topo, roots) -> MultiRootResult:
        dists, parents, hops = [], [], []
        for r in roots:
            t = copy.copy(topo)
            t.root = int(r)
            out = spf_reference(t)
            dists.append(out.dist)
            parents.append(out.parent)
            hops.append(out.hops)
        return MultiRootResult(
            dist=np.stack(dists), parent=np.stack(parents), hops=np.stack(hops)
        )


class TorchSpfBackend(SpfBackend):
    """SPF on the CUDA card (or on the CPU, on request).

    Marshaling (Topology -> device planes) happens once per topology
    generation (and root, for the blocked planes, which bake it in); up to
    four marshaled graphs of each engine are cached.
    """

    name = "torch"

    def __init__(
        self,
        engine: str = "gather",
        one_engine: str = "seq",
        device=None,
        n_atoms: int = 64,
        max_iters: int | None = None,
    ):
        if engine not in ("gather", "blocked"):
            raise ValueError(f"engine {engine!r}: the port runs 'gather' and 'blocked'")
        if one_engine != "seq":
            raise ValueError(
                f"one_engine {one_engine!r}: the port runs only 'seq' (fused, packed "
                f"and hybrid are ROADMAP queue A item 8, tropical item 12)"
            )
        self.engine = engine
        self.one_engine = one_engine
        self.device = resolve_device(device)
        self.n_atoms = n_atoms
        self.max_iters = max_iters
        self.routed_to_gather = 0  # blocked dispatches the gather engine served
        self._blocked_cache: dict = {}
        self._gather_cache: dict = {}

    def compute(self, topo, edge_mask=None, multipath_k: int = 1):
        _single_path(multipath_k)
        if self.engine == "blocked":
            res = self._whatif_blocked(topo, self._full_mask(topo, edge_mask)[None, :])
            if res is not None:
                return res[0]
        g = self.prepare(topo)
        dist, parent, hops, nh = _host_tensors(
            spf_one(g, topo.root, edge_mask, self.max_iters), topo.n_vertices
        )
        return SpfResult(dist=dist, parent=parent, hops=hops, nexthop_words=nh)

    def compute_whatif(self, topo, edge_masks, multipath_k: int = 1):
        _single_path(multipath_k)
        masks = np.asarray(edge_masks, bool)
        if len(masks) == 0:
            return []
        if self.engine == "blocked":
            res = self._whatif_blocked(topo, masks)
            if res is not None:
                return res
        g = self.prepare(topo)
        out = spf_whatif_batch(g, topo.root, masks, self.max_iters, self.one_engine)
        dist, parent, hops, nh = _host_tensors(out, topo.n_vertices)
        return [
            SpfResult(dist=dist[i], parent=parent[i], hops=hops[i], nexthop_words=nh[i])
            for i in range(len(masks))
        ]

    def compute_multiroot(self, topo, roots) -> MultiRootResult:
        """Distances, parents and hops from many roots (one device program).

        No next-hop plane: direct atoms are marshaled relative to
        ``topo.root``, so next hops mean nothing for another root.
        """
        roots = np.asarray(roots, np.int32)
        if len(roots) == 0:
            empty = np.zeros((0, topo.n_vertices), np.int32)
            return MultiRootResult(dist=empty, parent=empty.copy(), hops=empty.copy())
        out = spf_multiroot(self.prepare(topo), roots, max_iters=self.max_iters)
        dist, parent, hops, _ = _host_tensors(out, topo.n_vertices)
        return MultiRootResult(dist=dist, parent=parent, hops=hops)

    @staticmethod
    def _full_mask(topo: Topology, edge_mask) -> np.ndarray:
        if edge_mask is None:
            return np.ones(topo.n_edges, bool)
        return np.asarray(edge_mask, bool)

    @staticmethod
    def _remember(cache: dict, key, value):
        cache[key] = value
        while len(cache) > _CACHE_ENTRIES:
            cache.pop(next(iter(cache)))
        return value

    def prepare(self, topo: Topology):
        """Marshal (and cache) the gather engine's ELL planes on the device."""
        n_atoms = max(self.n_atoms, topo.n_atoms())
        key = (*topo.cache_key, n_atoms)
        if key in self._gather_cache:
            return self._gather_cache[key]
        g = device_graph_from_ell(build_ell(topo, n_atoms=n_atoms), self.device)
        return self._remember(self._gather_cache, key, g)

    def prepare_blocked(self, topo: Topology):
        """Marshal (and cache) the blocked planes: (graph, host perm_of), or
        None when the topology does not meet the blocked engine's
        preconditions (the gather engine serves it).

        The cache key includes the root: the planes bake the root in (BFS
        permutation + rootp).
        """
        key = (*topo.cache_key, topo.root)
        if key in self._blocked_cache:
            return self._blocked_cache[key]
        try:
            g = marshal_block_spf(
                topo, n_atoms=max(self.n_atoms, topo.n_atoms()), device=self.device
            )
        except ValueError:
            return self._remember(self._blocked_cache, key, None)
        return self._remember(self._blocked_cache, key, (g, g.orig2perm.cpu().numpy()))

    def _whatif_blocked(self, topo, edge_masks) -> list[SpfResult] | None:
        """The blocked engine's results, or None (counted in
        ``routed_to_gather``) when the topology or a scenario is outside
        its preconditions."""
        planes = self.prepare_blocked(topo)
        if planes is not None:
            g, perm_of = planes
            try:
                fdst, fid = failed_edges_perm(perm_of, topo, edge_masks, device=self.device)
            except ValueError:
                planes = None  # more than 4 failed edges in a scenario
        if planes is None:
            self.routed_to_gather += 1
            return None
        out = whatif_spf_blocked(g, fdst, fid, max_iters=self.max_iters)
        dist = out.dist.cpu().numpy()
        parent = out.parent.cpu().numpy()
        hops = out.hops.cpu().numpy()
        nh = out.nexthops.cpu().numpy().view(np.uint32)
        return [
            SpfResult(dist=dist[i], parent=parent[i], hops=hops[i], nexthop_words=nh[i])
            for i in range(dist.shape[0])
        ]
