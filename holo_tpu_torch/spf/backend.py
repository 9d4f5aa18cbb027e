"""SPF backends of the port.

``SpfBackend.compute`` is the single dispatch point the protocol layer calls
from its SPF-delay FSM (the reference's compute site:
holo-ospf/src/spf.rs:428-435).  :class:`ScalarSpfBackend` is the exact
host oracle; :class:`TorchSpfBackend` runs the blocked engine
(:mod:`holo_tpu_torch.ops.blocked_spf`) on the CUDA card, whose block
kernels are hand-written CUDA.

Unlike ``holo_tpu``'s backend there is no scalar fallback and no fallback to
another engine: a topology outside the blocked engine's preconditions
(parallel ``(src, dst)`` pairs, distances >= 2**27, more than 4 failed edges
in a scenario) raises ``ValueError`` saying why.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from holo_tpu_torch.device import resolve_device
from holo_tpu_torch.ops.blocked_spf import (
    failed_edges_perm,
    marshal_block_spf,
    whatif_spf_blocked,
)
from holo_tpu_torch.ops.graph import Topology
from holo_tpu_torch.spf.scalar import spf_reference


@dataclass
class SpfResult:
    """Backend-independent SPF output in host (numpy) space."""

    dist: np.ndarray  # int32[N]
    parent: np.ndarray  # int32[N]
    hops: np.ndarray  # int32[N]
    nexthop_words: np.ndarray  # uint32[N, W]


class SpfBackend:
    """Interface: one SPF run or a what-if batch."""

    name = "abstract"

    def compute(self, topo: Topology, edge_mask: np.ndarray | None = None) -> SpfResult:
        raise NotImplementedError

    def compute_whatif(self, topo: Topology, edge_masks: np.ndarray) -> list[SpfResult]:
        raise NotImplementedError


class ScalarSpfBackend(SpfBackend):
    """Exact reference-semantics Dijkstra on the host CPU."""

    name = "scalar"

    def __init__(self, n_atoms: int = 64):
        self.n_atoms = n_atoms

    def compute(self, topo, edge_mask=None):
        out = spf_reference(topo, edge_mask)
        return SpfResult(
            dist=out.dist,
            parent=out.parent,
            hops=out.hops,
            nexthop_words=out.nexthop_words(max(self.n_atoms, topo.n_atoms())),
        )

    def compute_whatif(self, topo, edge_masks):
        return [self.compute(topo, m) for m in edge_masks]


class TorchSpfBackend(SpfBackend):
    """The blocked SPF engine on the CUDA card (or on the CPU, on request).

    Marshaling (Topology -> block planes on the device) happens once per
    topology generation and root; up to four marshaled graphs are cached.
    """

    name = "torch"

    def __init__(
        self,
        engine: str = "blocked",
        device=None,
        n_atoms: int = 64,
        max_iters: int | None = None,
    ):
        if engine != "blocked":
            raise ValueError(f"engine {engine!r}: this port runs only 'blocked'")
        self.device = resolve_device(device)
        self.n_atoms = n_atoms
        self.max_iters = max_iters
        self._blocked_cache: dict = {}

    def compute(self, topo, edge_mask=None):
        return self._whatif_blocked(topo, self._full_mask(topo, edge_mask)[None, :])[0]

    def compute_whatif(self, topo, edge_masks):
        return self._whatif_blocked(topo, edge_masks)

    @staticmethod
    def _full_mask(topo: Topology, edge_mask) -> np.ndarray:
        if edge_mask is None:
            return np.ones(topo.n_edges, bool)
        return np.asarray(edge_mask, bool)

    def prepare_blocked(self, topo: Topology):
        """Marshal (and cache) the blocked planes: (graph, host perm_of).

        The cache key includes the root: the planes bake the root in (BFS
        permutation + rootp).  Raises ValueError when the topology does not
        meet the blocked engine's preconditions.
        """
        key = (*topo.cache_key, topo.root)
        if key not in self._blocked_cache:
            g = marshal_block_spf(
                topo, n_atoms=max(self.n_atoms, topo.n_atoms()), device=self.device
            )
            self._blocked_cache[key] = (g, g.orig2perm.cpu().numpy())
            while len(self._blocked_cache) > 4:
                self._blocked_cache.pop(next(iter(self._blocked_cache)))
        return self._blocked_cache[key]

    def _whatif_blocked(self, topo, edge_masks) -> list[SpfResult]:
        g, perm_of = self.prepare_blocked(topo)
        fdst, fid = failed_edges_perm(perm_of, topo, edge_masks, device=self.device)
        out = whatif_spf_blocked(g, fdst, fid, max_iters=self.max_iters)
        dist = out.dist.cpu().numpy()
        parent = out.parent.cpu().numpy()
        hops = out.hops.cpu().numpy()
        nh = out.nexthops.cpu().numpy().view(np.uint32)
        return [
            SpfResult(dist=dist[i], parent=parent[i], hops=hops[i], nexthop_words=nh[i])
            for i in range(dist.shape[0])
        ]
