"""SPF backends of the port.

``SpfBackend.compute`` is the single dispatch point the protocol layer calls
from its SPF-delay FSM (the reference's compute site:
holo-ospf/src/spf.rs:428-435).  :class:`ScalarSpfBackend` is the exact
host oracle; :class:`TorchSpfBackend` runs on the CUDA card, whose kernels
are hand-written CUDA, with two engines:

- ``engine="gather"`` (the default, as in ``holo_tpu``): the ELL fixpoints
  of :mod:`holo_tpu_torch.ops.spf_engine`, for any topology, in one of five
  bit-identical formulations, ``one_engine`` ``seq`` (the default),
  ``fused``, ``packed``, ``hybrid`` or ``tropical`` (the distances on
  min-plus tiles, :mod:`holo_tpu_torch.ops.tropical`: ``compute``,
  ``compute_whatif``, ``compute_multiroot`` and DeltaPath; at
  ``multipath_k`` > 1 a pinned-tropical ``compute`` and its DeltaPath chain
  run the multipath program on the tiles, ``mp_tropical``, and a what-if
  runs ``mp``, as in ``holo_tpu``);
- ``engine="blocked"``: the block-sparse engine of
  :mod:`holo_tpu_torch.ops.blocked_spf`.  A topology outside its
  preconditions (parallel ``(src, dst)`` pairs, distances >= 2**27, more
  than 4 failed edges in a scenario) goes to the gather engine, as in
  ``holo_tpu``; ``routed_to_gather`` counts those dispatches.

DeltaPath (``incremental=True``, the default, as in ``holo_tpu``): a
mask-free ``compute`` of a topology that carries delta lineage
(``Topology.link_delta``, this package's delta or ``holo_tpu``'s, read by
its fields) to a topology whose run this backend kept updates the resident
graph in place and runs ``spf_one_incremental`` seeded from that run.
Each disposition counts in ``delta_paths[(kind, path)]``.

Multipath (``multipath_k`` 2..8, padded to ``kp`` = 2, 4 or 8 by
``mp_pad``): ``compute`` and ``compute_whatif`` run the multipath program
of :mod:`holo_tpu_torch.ops.spf_engine` and fill the five multipath fields
of :class:`SpfResult`; ``kp == 1`` is the single-path program, those fields
None.  The blocked engine has no multipath planes: ``kp > 1`` goes to the
gather engine's program, as in ``holo_tpu``.  A ``compute`` whose engine is
``mp_tropical`` (pinned ``tropical``, or the tuner's pick) runs the multipath
program of :mod:`holo_tpu_torch.ops.tropical`.  DeltaPath keeps the run's
``kp`` in its key, so a change of width mid-chain gives ``full-no-prev``.

Every device dispatch (``compute``, ``compute_whatif``,
``compute_multiroot``) runs under ``breaker``, as in ``holo_tpu``: a device
failure (a CUDA error at launch, device memory exhausted) is counted, and
repeated failures open the circuit.  On the card the failure then
re-raises and an open circuit refuses the dispatch: the host oracle is no
substitute for the card's work.  On the CPU with no ``max_iters`` cap, where
:class:`ScalarSpfBackend` computes the same bits, the oracle serves it.  A
kernel library that does not build and an input the kernels refuse
re-raise uncounted (``resilience.breaker._PASSTHROUGH``): they are not
device failures.  DeltaPath runs inside the guarded device path.

The engine tuner (``holo_tpu_torch.pipeline.tuner``): while one is armed
(``configure_engine_tuner``) every single-path gather ``compute`` and
``compute_whatif`` runs the engine the tuner picks for its shape bucket and
feeds it the dispatch's wall, as ``holo_tpu``'s backend does; the first
dispatch of an (engine, shape) under an armed tuner in the process, which
may build the kernel library, is not a sample (the counterpart of JAX's
fresh-compile exclusion).
Multipath dispatches run under buckets of their own: ``compute`` chooses
between ``mp`` and ``mp_tropical``, a what-if runs ``mp``.  The delta-linked
and the re-marshaling ``compute()`` walls feed the DeltaPath depth cap, and a
warm full partitioned solve the partitioned rows.  Multi-root runs ``seq``, or
the tiles when the backend is pinned ``tropical``; a DeltaPath ``compute`` runs
on the tiles when the backend is pinned ``tropical`` or the tuner's measured
``compute()`` winner of the bucket (which carries the multipath width) is
``tropical`` or ``mp_tropical``.

Partitioned SPF (``partition_threshold``, as in ``holo_tpu``): ``compute``,
``compute_whatif`` and ``compute_partitioned`` of a topology with at least
that many vertices run :class:`~holo_tpu_torch.ops.partition.PartitionedSpfEngine`
(not under ``engine="blocked"``): the cut is the topology's
``partition_hint``, else the greedy cut into ``partition_parts`` parts or
parts of at most ``partition_max_part`` vertices.  Its residents live in the
device's shared graph cache, one per (backend, topology class, root, atoms);
a delta-linked mask-free ``compute`` re-solves only the affected parts
(``delta_paths[(kind, "partitioned-incremental")]``, else
``"partitioned-full"``); ``part_stats``, when a dict, receives each
partitioned dispatch's path, re-solved parts, rounds and phase times.  The
what-if batch solves one mask at a time, as in ``holo_tpu``.

Split-phase dispatch (``launch_one`` / ``finish_one``, as ``holo_tpu``'s):
the dispatch pipeline (:mod:`holo_tpu_torch.pipeline.dispatch`) runs a
gather ``compute`` (DeltaPath included) in two phases on its worker: the
launch runs the same device program as ``compute`` and queues the result
planes' copies to pinned host memory behind it; the finish waits on them,
builds the SpfResult, feeds the tuner and keeps the DeltaPath run.  The
chaos seams ``faults.crashpoint("spf.dispatch")`` and
``faults.delaypoint("spf.dispatch")`` sit in both paths.

The dispatch mesh (:mod:`holo_tpu_torch.parallel.mesh`, ``holo_tpu``'s
process mesh): while one is installed every gather dispatch reads it once and
runs on its devices, not on the backend's own.  A what-if batch (each
``one_engine``, and the multipath program at ``multipath_k`` > 1) and a
multi-root batch (``seq``, or the tiles when pinned ``tropical``) run their
lanes split over the batch axis, each shard on its device's resident,
joined on the host; ``compute`` (DeltaPath included, and ``launch_one`` /
``finish_one``) runs on the first batch device's resident; a partitioned
solve runs on the first batch device (``holo_tpu``'s replicated arm), its
resident keyed by the mesh.  Residents, kept runs and tuner buckets carry
the mesh's key, and a node axis above 1 pads the residents' rows, which the
readback slices off (:func:`_host_tensors`).  A size-1 mesh runs the plain
programs, whose bits and kernel launches it keeps.  ``shard_dispatches``
counts the dispatches the mesh served, by kind (``holo_spf_shard_dispatch_
total``; :meth:`TorchSpfBackend.stats`), and ``faults.crashpoint("spf.shard")``
is the shard chaos seam.  The blocked engine ignores the mesh, as in
``holo_tpu``.
"""

from __future__ import annotations

import copy
import itertools
import threading
from collections import Counter
from dataclasses import dataclass

import numpy as np

from holo_tpu_torch import telemetry
from holo_tpu_torch.analysis.runtime import (
    assert_live,
    consumes_donated,
    lease,
    note_donated,
    sanctioned_transfer,
)
from holo_tpu_torch.device import HostCopy, resolve_device
from holo_tpu_torch.ops.blocked_spf import (
    failed_edges_perm,
    marshal_block_spf,
    whatif_spf_blocked,
)
from holo_tpu_torch.ops.graph import (
    Topology,
    delta_kind,
    delta_seed_rows,
    topology_namespace,
)
from holo_tpu_torch.ops.partition import PartitionedSpfEngine
from holo_tpu_torch.ops.spf_engine import (
    _ONE_ENGINES,
    lane_engine,
    mp_pad,
    note_delta,
    shared_graph_cache,
    spf_multipath_batch,
    spf_multiroot,
    spf_one,
    spf_one_incremental,
    spf_one_incremental_multipath,
    spf_one_multipath,
    spf_whatif_batch,
)
from holo_tpu_torch.ops.tropical import (
    tropical_multiroot,
    tropical_spf_one,
    tropical_spf_one_incremental,
    tropical_spf_one_incremental_multipath,
    tropical_spf_one_multipath,
    tropical_whatif_batch,
)
from holo_tpu_torch.parallel import mesh as pm
from holo_tpu_torch.pipeline.tuner import active_tuner, shape_bucket
from holo_tpu_torch.resilience import faults
from holo_tpu_torch.resilience.breaker import CircuitBreaker
from holo_tpu_torch.spf.scalar import spf_multipath_reference, spf_reference
from holo_tpu_torch.telemetry import profiling, residency

_DISPATCH_SECONDS = telemetry.histogram(
    "holo_spf_dispatch_seconds", "Wall time of one SPF dispatch (incl. readback)",
    ("backend", "kind"))
_TRANSFER_SECONDS = telemetry.histogram(
    "holo_spf_transfer_seconds", "Device->host readback time per dispatch", ("kind",))
_GRAPH_CACHE = telemetry.counter(
    "holo_spf_graph_cache_total", "Marshaled DeviceGraph cache lookups", ("result",))
_BATCH_SCENARIOS = telemetry.counter(
    "holo_spf_scenarios_total", "Scenario-SPFs computed (batch rows count individually)",
    ("kind",))
_SHARD_DISPATCHES = telemetry.counter(
    "holo_spf_shard_dispatch_total",
    "Dispatches routed through the process-mesh sharded path "
    "(parallel/mesh.py layout contract)", ("kind",))

_CACHE_ENTRIES = 4
# Namespaces of the backends' partitioned residents: never reused in a
# process (an id() can be, after a collection).
_PART_NS_IDS = itertools.count()
# (kind, engine, device, shapes...) of every gather dispatch run in this
# process while an engine tuner was armed: the first of each is no sample.
_DISPATCHED: set = set()
# The engines that relax on the tiles (holo_tpu's _TROPICAL_ENGINES).
_TROPICAL_ENGINES = ("tropical", "mp_tropical")


def _mesh():
    """The process dispatch mesh (``parallel/mesh.py``), or None."""
    return pm.process_mesh()


@dataclass
class SpfResult:
    """Backend-independent SPF output in host (numpy) space."""

    dist: np.ndarray  # int32[N]
    parent: np.ndarray  # int32[N]
    hops: np.ndarray  # int32[N]
    nexthop_words: np.ndarray  # uint32[N, W]
    # Multipath planes (multipath_k > 1), None for a single-path run.
    parents: np.ndarray | None = None  # int32[N, Kp]; sentinel N
    pdist: np.ndarray | None = None  # int32[N, Kp]; INF past the set
    pweight: np.ndarray | None = None  # int32[N, Kp]
    npaths: np.ndarray | None = None  # int32[N]
    nh_weights: np.ndarray | None = None  # int32[N, A]


@dataclass
class MultiRootResult:
    """Multi-root SPF output: SPT shape only (see compute_multiroot)."""

    dist: np.ndarray  # int32[R, N]
    parent: np.ndarray  # int32[R, N]
    hops: np.ndarray  # int32[R, N]


def _host_tensors(out, n: int):
    """Device SPF tensors -> the host contract, one bulk copy a plane: the
    vertex axis sliced back to N and the sentinels renormalized to N (no
    parent) and N + 1 (unreachable hops).  A resident whose rows a mesh's
    node axis padded to R gives the no-parent sentinel R and unreachable
    hops R + 1; on an unpadded one every step is a no-op."""
    dist = out.dist.cpu().numpy()[..., :n]
    parent = np.minimum(out.parent.cpu().numpy()[..., :n], np.int32(n))
    hops = np.minimum(out.hops.cpu().numpy()[..., :n], np.int32(n + 1))
    nh = None
    if out.nexthops is not None:
        nh = out.nexthops.cpu().numpy().view(np.uint32)[..., :n, :]
    return dist, parent, hops, nh


def _host_mp(mp, n: int) -> dict:
    """Device multipath planes -> the five SpfResult fields, under
    :func:`_host_tensors`' contract (the vertex axis sliced to N, parents'
    sentinel renormalized from R to N)."""
    return {
        "parents": np.minimum(mp.parents.cpu().numpy()[..., :n, :], np.int32(n)),
        "pdist": mp.pdist.cpu().numpy()[..., :n, :],
        "pweight": mp.pweight.cpu().numpy()[..., :n, :],
        "npaths": mp.npaths.cpu().numpy()[..., :n],
        "nh_weights": mp.nh_weights.cpu().numpy()[..., :n, :],
    }


@dataclass
class _InFlightOne:
    """A launched split-phase ``compute`` (``TorchSpfBackend.launch_one``;
    ``holo_tpu``'s ``_InFlightOne``): the run's device tensors, their host
    copies in flight, and what ``finish_one`` books."""

    out: object  # SpfTensors, or (SpfTensors, MultipathTensors) at kp > 1
    # The planes' copies to the host, queued after the run; None where the
    # finish follows at once and reads the planes back itself.
    host: HostCopy | None
    topo: Topology
    engine: str
    bucket: tuple | None  # tuner bucket; None feeds no tuner
    mode: str  # "full" | "delta"
    kp: int = 1
    delta_kind: str = ""
    remember: bool = False  # keep the run as the next delta's seed
    remarshal: bool = False  # a full re-marshal: the depth cap's "full" arm
    first: bool = False  # the first dispatch of its shape: no tuner sample
    # The launch's wall alone: tuner samples are launch_s + the finish's
    # wall, without the time the entry sat launched in a pipeline.
    launch_s: float = 0.0
    mesh: object = None  # the dispatch mesh the launch ran under
    t0: float = 0.0  # the dispatch's start (profiling.clock)
    # The device phase's CUDA events (profiling armed), read at the finish,
    # and the donation guard's lease on the residents the program read.
    clock: object = None
    lease: object = None


def _stage(out, kp: int) -> HostCopy:
    """Queue the host copies of one run's planes (every tensor field of the
    SpfTensors, and of the MultipathTensors at kp > 1)."""
    parts = out if kp > 1 else (out,)
    return HostCopy({(i, f): t for i, part in enumerate(parts)
                     for f, t in part._asdict().items() if t is not None})


def _staged(h: _InFlightOne):
    """``h.out`` with each plane replaced by its host copy (after the wait),
    the shape :meth:`TorchSpfBackend._result` reads; ``h.out`` itself where
    no copy was queued."""
    if h.host is None:
        return h.out
    host = h.host.wait()
    parts = h.out if h.kp > 1 else (h.out,)
    staged = tuple(part._replace(**{f: host[(i, f)] for f in part._fields if (i, f) in host})
                   for i, part in enumerate(parts))
    return staged if h.kp > 1 else staged[0]


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
        # The dispatch histogram's kind axis is shared with the card backend.
        t0 = profiling.clock()
        with telemetry.span("spf.dispatch", kind="one", backend="scalar"):
            res = self._one(topo, edge_mask, mp_pad(multipath_k))
        _DISPATCH_SECONDS.labels(backend="scalar", kind="one").observe(profiling.clock() - t0)
        _BATCH_SCENARIOS.labels(kind="one").inc()
        return res

    def _one(self, topo, edge_mask, kp: int) -> SpfResult:
        n_atoms = max(self.n_atoms, topo.n_atoms())
        if kp > 1:
            out, omp = spf_multipath_reference(topo, kp, edge_mask,
                                               n_lanes=((n_atoms + 31) // 32) * 32)
            mp = vars(omp)  # the five multipath fields
        else:
            out, mp = spf_reference(topo, edge_mask), {}
        return SpfResult(
            dist=out.dist,
            parent=out.parent,
            hops=out.hops,
            nexthop_words=out.nexthop_words(n_atoms),
            **mp,
        )

    def compute_whatif(self, topo, edge_masks, multipath_k: int = 1):
        t0 = profiling.clock()
        kp = mp_pad(multipath_k)
        with telemetry.span("spf.dispatch", kind="whatif", backend="scalar",
                            batch=len(edge_masks)):
            res = [self._one(topo, m, kp) for m in edge_masks]
        _DISPATCH_SECONDS.labels(backend="scalar", kind="whatif").observe(profiling.clock() - t0)
        _BATCH_SCENARIOS.labels(kind="whatif").inc(len(res))
        return res

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
    generation (and root, for the blocked planes, which bake it in).  The
    gather engine's graphs come from the device's shared cache
    (``shared_graph_cache``, through a view that counts this backend's
    lookups and DeltaPath dispositions); up to four of the blocked engine's
    are cached here.  Both are keyed by the topology's class beside its
    ``cache_key``.  ``incremental`` arms
    DeltaPath; ``prev_capacity`` bounds the kept previous runs, one per
    (topology, root) chain.  ``partition_threshold`` (None: never),
    ``partition_parts`` and ``partition_max_part`` arm and shape the
    partitioned path (module docstring).  ``one_engine`` pins the
    single-path formulation while no engine tuner is armed.
    """

    name = "torch"

    def __init__(
        self,
        engine: str = "gather",
        one_engine: str = "seq",
        device=None,
        n_atoms: int = 64,
        max_iters: int | None = None,
        incremental: bool = True,
        prev_capacity: int = 32,
        breaker: CircuitBreaker | None = None,
        partition_threshold: int | None = None,
        partition_parts: int | None = None,
        partition_max_part: int = 4096,
    ):
        if engine not in ("gather", "blocked"):
            raise ValueError(f"engine {engine!r}: the port runs 'gather' and 'blocked'")
        if one_engine != "tropical":  # tiles and repair rows: no lane program
            lane_engine(one_engine)  # raises on an engine the port does not run
        self.engine = engine
        self.one_engine = one_engine
        self.device = resolve_device(device)
        self.n_atoms = n_atoms
        self.max_iters = max_iters
        self.incremental = incremental
        self.prev_capacity = int(prev_capacity)
        self.routed_to_gather = 0  # blocked dispatches the gather engine served
        # Guards every device dispatch; _guarded says what serves a failed one.
        self.breaker = breaker if breaker is not None else CircuitBreaker("spf-dispatch")
        self._oracle = ScalarSpfBackend(n_atoms)
        self._blocked_cache: dict = {}
        self._gather_cache = shared_graph_cache(self.device).view()
        # DeltaPath dispositions, (delta kind, path) -> dispatches: the
        # cache's (apply, full-no-base, full-depth, ...) and the backend's
        # (incremental, full-no-prev), as holo_spf_delta_total{kind,path}.
        self.delta_paths: Counter = self._gather_cache.delta_paths
        # Set to a dict to receive each incremental dispatch's rounds per
        # phase and affected-set size (spf_one_incremental's ``stats``).
        self.delta_stats: dict | None = None
        # The previous run's device tensors per (topology class, uid,
        # generation, n_atoms, root): the seed of the next delta's run.
        # The lock serves a pipeline worker beside the caller's thread.
        self._prev_one: dict[tuple, object] = {}
        self._prev_lock = threading.Lock()
        self.partition_threshold = partition_threshold
        self.partition_parts = partition_parts
        self.partition_max_part = int(partition_max_part)
        self._part_engine = PartitionedSpfEngine(self.device, max_iters)
        self._part_ns = f"part:{next(_PART_NS_IDS)}"
        self.part_stats: dict | None = None
        # Dispatches the process mesh served, by kind (whatif, one,
        # multiroot, partitioned): holo_spf_shard_dispatch_total{kind}.
        self.shard_dispatches: Counter = Counter()
        # Views of the mesh devices' caches other than this backend's own
        # device (sharing its counts), and their partitioned engines.
        self._mesh_views: dict = {}
        self._part_engines: dict = {}
        residency.register_spf_backend(self)  # the ledger's spf-prev row

    def _n_atoms(self, topo) -> int:
        return max(self.n_atoms, topo.n_atoms())

    def fallback_serves(self) -> bool:
        """Does the oracle compute this backend's bits?  On the CPU with no
        ``max_iters`` cap only (the backend's device and, under a dispatch
        mesh, every device of it); it is then the breaker's fallback."""
        mesh = _mesh()
        on_cpu = self.device.type == "cpu" and (
            mesh is None or all(d.type == "cpu" for d in mesh.devices.flat))
        return on_cpu and self.max_iters is None

    def stats(self) -> dict:
        """The mesh's axis sizes and the dispatches it served by kind
        (``holo_tpu``'s ``holo_parallel_mesh_size`` and
        ``holo_spf_shard_dispatch_total``)."""
        return {"mesh": pm.mesh_stats(), "shard-dispatches": dict(self.shard_dispatches)}

    def _view(self, dev):
        """This backend's view of ``dev``'s shared graph cache: its own for
        its own device, else one that shares its counts."""
        cache = shared_graph_cache(dev)
        if cache._cache is self._gather_cache._cache:
            return self._gather_cache
        view = self._mesh_views.get(cache.device)
        if view is None:
            view = self._mesh_views[cache.device] = cache.view(counts=self._gather_cache)
        return view

    def _home(self, mesh):
        """The view a single-lane dispatch runs on: the first batch device's
        under a mesh, else this backend's own."""
        return self._gather_cache if mesh is None else self._view(mesh.batch_device(0))

    def _resident(self, mesh, topo, need_edge_ids: bool = False, tiles: bool = False):
        """``dev -> graph`` (``(graph, tiles)`` with ``tiles``): a batch
        shard's resident under ``mesh`` from its device's cache, looked up
        once per physical device (``pm.per_device``)."""
        n_atoms = self._n_atoms(topo)

        def resident(dev):
            view = self._view(dev)
            g, how = view.get(topo, n_atoms, need_edge_ids=need_edge_ids,
                              allow_delta=self.incremental, mesh=mesh)
            _GRAPH_CACHE.labels(result=how).inc()
            return (g, view.get_tropical(topo, n_atoms, mesh)) if tiles else g

        return pm.per_device(resident)

    def _guarded(self, primary, oracle, context: str):
        """``primary`` under the breaker, the oracle its fallback where
        :meth:`fallback_serves`."""
        return self.breaker.call(primary, oracle if self.fallback_serves() else None, context)

    def compute(self, topo, edge_mask=None, multipath_k: int = 1):
        kp = mp_pad(multipath_k)
        if self._use_partitioned(topo):
            return self.compute_partitioned(topo, edge_mask, multipath_k=kp)
        return self._guarded(
            lambda: self._device_compute(topo, edge_mask, kp),
            lambda: self._oracle.compute(topo, edge_mask, multipath_k=kp),
            "spf.one",
        )

    def compute_whatif(self, topo, edge_masks, multipath_k: int = 1):
        kp = mp_pad(multipath_k)
        if self._use_partitioned(topo):
            return self._guarded(
                lambda: [self._device_partitioned(topo, m, kp) for m in edge_masks],
                lambda: self._oracle.compute_whatif(topo, edge_masks, multipath_k=kp),
                "spf.whatif",
            )
        return self._guarded(
            lambda: self._device_whatif(topo, edge_masks, kp),
            lambda: self._oracle.compute_whatif(topo, edge_masks, multipath_k=kp),
            "spf.whatif",
        )

    def compute_multiroot(self, topo, roots) -> MultiRootResult:
        """Distances, parents and hops from many roots (one device program).

        No next-hop plane: direct atoms are marshaled relative to
        ``topo.root``, so next hops mean nothing for another root.
        """
        return self._guarded(
            lambda: self._device_multiroot(topo, roots),
            lambda: self._oracle.compute_multiroot(topo, roots),
            "spf.multiroot",
        )

    def compute_partitioned(self, topo, edge_mask=None, multipath_k: int = 1) -> SpfResult:
        """One partitioned dispatch (``compute`` routes here past
        ``partition_threshold``), under the breaker as every dispatch."""
        kp = mp_pad(multipath_k)
        return self._guarded(
            lambda: self._device_partitioned(topo, edge_mask, kp),
            lambda: self._oracle.compute(topo, edge_mask, multipath_k=kp),
            "spf.partitioned",
        )

    def _use_partitioned(self, topo) -> bool:
        return (self.partition_threshold is not None
                and topo.n_vertices >= self.partition_threshold
                and self.engine != "blocked")

    def _part_key(self, topo, mesh=None) -> tuple:
        return (self._part_ns, *topology_namespace(topo), int(topo.root), self._n_atoms(topo),
                pm.mesh_cache_key(mesh))

    def _part_device(self, mesh=None):
        """Where the partitioned residents live: the mesh's replicated
        placement (``pm.replicated_device``), else the backend's device."""
        return self.device if mesh is None else pm.replicated_device(mesh)

    def _part_engine_on(self, dev) -> PartitionedSpfEngine:
        if shared_graph_cache(dev)._cache is self._gather_cache._cache:
            return self._part_engine
        eng = self._part_engines.get(dev)
        if eng is None:
            eng = self._part_engines[dev] = PartitionedSpfEngine(dev, self.max_iters)
        return eng

    def partition_residents(self) -> list:
        """This backend's partitioned residents where the current dispatches
        keep them (tests, chip_smoke)."""
        cache = shared_graph_cache(self._part_device(_mesh()))
        return list(cache.partitioned_entries(self._part_ns).values())

    def partition_stats(self) -> dict:
        """Each resident's summary, by its key past the namespace."""
        entries = shared_graph_cache(self._part_device(_mesh())).partitioned_entries(
            self._part_ns)
        return {str(k[1:]): r.stats() for k, r in entries.items()}

    def _device_partitioned(self, topo, edge_mask, kp: int) -> SpfResult:
        """A delta-linked mask-free dispatch re-solves the affected parts of
        the resident (DeltaPath); otherwise the resident, marshaled again
        unless it serves this topology (its cut, and its edge ids for a
        mask), solves in full.  Under a mesh the resident lives on its
        replicated device and its key carries the mesh.  The stages are
        ``holo_tpu``'s: ``spf.partitioned`` delta / marshal / solve; the
        partitioned solve stitches its parts on the host, so the delta and
        solve stages are sanctioned windows whole."""
        t0 = profiling.clock()
        mesh = _mesh()
        if mesh is not None:
            faults.crashpoint("spf.shard")
        dev = self._part_device(mesh)
        eng = self._part_engine_on(dev)
        cache = shared_graph_cache(dev)
        key = self._part_key(topo, mesh)
        delta = getattr(topo, "delta_base", None)
        out, info, path = None, {}, "full"
        with profiling.dispatch_context(kind="partitioned", engine="partitioned", bucket=None), \
                telemetry.span("spf.dispatch", kind="partitioned", backend="torch"):
            res = cache.get_partitioned(key)
            if edge_mask is None and delta is not None and self.incremental and res is not None:
                with profiling.stage("spf.partitioned", "delta"):
                    with sanctioned_transfer("spf.partition.delta"):
                        out, info = eng.try_delta(topo, res, kp)
                if out is not None:
                    path = "incremental"
                    note_delta(self.delta_paths, delta_kind(delta), "partitioned-incremental")
            if out is None:
                with profiling.stage("spf.partitioned", "marshal"):
                    if not (res is not None and res.serves(topo)
                            and not (edge_mask is not None and res.ids_stale)):
                        with sanctioned_transfer("spf.partition.marshal"):
                            res = eng.marshal(
                                topo, self._n_atoms(topo), n_parts=self.partition_parts,
                                max_part=(None if self.partition_parts is not None
                                          else self.partition_max_part))
                        cache.put_partitioned(key, res)
                        path = "marshal"
                ls = lease(res.graph, generation=topo.cache_key)
                with profiling.stage("spf.partitioned", "solve"):
                    with sanctioned_transfer("spf.partition.solve"):
                        out = eng.solve(topo, res, edge_mask, kp)
                # A resident re-solved in place under this solve (a delta of
                # its chain on another thread) fails here under the guard.
                assert_live("spf.partitioned.readback", ls)
                if delta is not None and edge_mask is None:
                    note_delta(self.delta_paths, delta_kind(delta), "partitioned-full")
        if self.part_stats is not None:
            self.part_stats.clear()
            self.part_stats.update(
                path=path, masked=edge_mask is not None, parts=res.plan.n_parts,
                resolved=info.get("resolved", res.plan.n_parts), rounds=dict(res.rounds),
                timings=dict(res.timings), **({"refused": info["reason"]} if "reason" in info
                                              else {}))
        mp = {f: out[f] for f in ("parents", "pdist", "pweight", "npaths", "nh_weights")
              if f in out}
        result = SpfResult(dist=out["dist"], parent=out["parent"], hops=out["hops"],
                           nexthop_words=out["nexthop_words"], **mp)
        t1 = profiling.clock()
        _DISPATCH_SECONDS.labels(backend="torch", kind="partitioned").observe(t1 - t0)
        t = active_tuner()
        if t is not None and edge_mask is None and path == "full":
            # Full solves on a warm resident only, as holo_tpu: a marshal,
            # a delta re-solve or a masked solve is not comparable with the
            # monolithic medians of the same bucket.
            t.observe_partitioned(self._depth_bucket(topo, kp, mesh), t1 - t0)
        kind = "one" if edge_mask is None else "whatif"
        _BATCH_SCENARIOS.labels(kind=kind).inc()
        if mesh is not None:
            _SHARD_DISPATCHES.labels(kind=kind).inc()
            self.shard_dispatches["partitioned"] += 1
        return result

    def _device_compute(self, topo, edge_mask, kp: int) -> SpfResult:
        faults.crashpoint("spf.dispatch")
        mesh = _mesh()
        if mesh is not None:
            # The shard chaos seam: a device lost from the mesh surfaces
            # here, and the breaker counts it like any device failure.
            faults.crashpoint("spf.shard")
        if self.engine == "blocked" and kp == 1:
            res = self._whatif_blocked(topo, self._full_mask(topo, edge_mask)[None, :])
            if res is not None:
                return res[0]
        # The split dispatch back to back, the planes read back by .cpu() at
        # the finish (no pinned copies queued: nothing runs in between).
        with telemetry.span("spf.dispatch", kind="one", backend="torch"):
            return self._finish(self._launch(topo, edge_mask, kp, stage=False, mesh=mesh))

    def _one_program(self, topo, edge_mask, kp: int, mesh=None) -> tuple:
        """The device program of a full (not DeltaPath) ``compute``, in the
        ``spf.one`` marshal stage (as ``holo_tpu``'s jit call): (device
        tensors, engine, tuner bucket, graph lookup, first use, device clock,
        lease).  Under a mesh it runs on the first batch device's
        resident."""
        engine, bucket = self._pick_engine("one", topo, kp=kp, mesh=mesh)
        view = self._home(mesh)
        n_atoms = self._n_atoms(topo)
        with profiling.stage("spf.one", "marshal"):
            tt = None
            with sanctioned_transfer("spf.one.marshal"):
                # A scenario mask gathers through in_edge_id: an entry whose
                # ids went stale under a structural delta is rebuilt for it.
                g, how = view.get(topo, n_atoms, need_edge_ids=edge_mask is not None,
                                  allow_delta=self.incremental, mesh=mesh)
                if engine in _TROPICAL_ENGINES:
                    tt = view.get_tropical(topo, n_atoms, mesh)
            _GRAPH_CACHE.labels(result=how).inc()
            first = self._first_use("one", engine, g, 1, kp, edge_mask is not None,
                                    pm.mesh_cache_key(mesh))
            ls = lease(g, tt, generation=view.key(topo, n_atoms, mesh))
            clk = profiling.device_clock("spf.one", on=g.in_src.device)
            if engine == "mp_tropical":
                out = tropical_spf_one_multipath(g, tt, topo.root, kp, edge_mask, None,
                                                 self.max_iters)
            elif kp > 1:
                out = spf_one_multipath(g, topo.root, kp, edge_mask, self.max_iters)
            elif engine == "tropical":
                out = tropical_spf_one(g, tt, topo.root, edge_mask, None, self.max_iters)
            else:
                one = spf_one if engine == "seq" else _ONE_ENGINES[engine]
                out = one(g, topo.root, edge_mask, self.max_iters)
            profiling.sync(clk)
        return out, engine, bucket, how, first, clk, ls

    def _pick_engine(self, kind: str, topo, batch: int = 1, kp: int = 1, mesh=None):
        """(engine, shape bucket or None): the armed tuner's pick for this
        dispatch's bucket (which carries the mesh's key), else the pinned
        ``one_engine`` and None, which feeds no tuner (``holo_tpu``'s
        ``_pick_engine``; the blocked engine's backends feed none either).
        At kp > 1 the pinned engine is ``mp_tropical`` for a pinned-tropical
        ``compute``, else ``mp``."""
        t = active_tuner()
        if t is None or self.engine == "blocked":
            if kp > 1:
                trop = self.one_engine == "tropical" and kind == "one"
                return ("mp_tropical" if trop else "mp"), None
            return self.one_engine, None
        bucket = shape_bucket(topo.n_vertices, topo.n_edges, batch, pm.mesh_cache_key(mesh), k=kp)
        return t.pick(kind, bucket), bucket

    @staticmethod
    def _tuner_observe(kind: str, bucket, engine: str, seconds: float) -> None:
        t = active_tuner()
        if bucket is not None and t is not None:
            t.observe(kind, bucket, engine, seconds)

    def _trop_incremental(self, topo, kp: int, mesh=None) -> bool:
        """Does a DeltaPath dispatch of width ``kp`` relax on the tiles?
        When the backend is pinned ``tropical``, or the armed tuner's
        measured ``compute()`` winner of the kp bucket is ``tropical`` or
        ``mp_tropical`` (``holo_tpu``'s ``_trop_incremental``)."""
        if self.one_engine == "tropical":
            return True
        t = active_tuner()
        return (t is not None
                and t.current_winner("one", self._depth_bucket(topo, kp, mesh))
                in _TROPICAL_ENGINES)

    @staticmethod
    def _depth_bucket(topo, kp: int = 1, mesh=None) -> tuple:
        """The DeltaPath depth bucket (kind one, batch 1, the mesh, the
        width kp)."""
        return shape_bucket(topo.n_vertices, topo.n_edges, 1, pm.mesh_cache_key(mesh), k=kp)

    def _tuner_depth_observe(self, topo, arm: str, seconds: float, kp: int = 1,
                             mesh=None) -> None:
        """A delta-linked ("delta") or re-marshaling ("full") ``compute()``
        wall, the depth cap's input."""
        t = active_tuner()
        if t is not None:
            observe = t.observe_delta if arm == "delta" else t.observe_full
            observe(self._depth_bucket(topo, kp, mesh), seconds)

    def _first_use(self, kind: str, engine: str, g, *shape) -> bool:
        """True for a dispatch that is no tuner sample: the first of its
        (kind, engine, device, shapes) under an armed tuner in the process
        (the one that may build the kernel library or first launch at the
        shape: an nvcc build would outvote every steady wall).  Signatures
        are kept only while a tuner is armed.  Call it before the dispatch
        runs."""
        if active_tuner() is None:
            return True
        sig = (kind, engine, str(g.in_src.device), *g.in_src.shape,
               g.direct_nh_words.shape[2], *shape)
        first = sig not in _DISPATCHED
        _DISPATCHED.add(sig)
        return first

    @staticmethod
    def _result(out, n: int, kp: int) -> SpfResult:
        """``out``: SpfTensors, or (SpfTensors, MultipathTensors) for kp > 1."""
        sp = out[0] if kp > 1 else out
        dist, parent, hops, nh = _host_tensors(sp, n)
        mp = _host_mp(out[1], n) if kp > 1 else {}
        return SpfResult(dist=dist, parent=parent, hops=hops, nexthop_words=nh, **mp)

    def _prev_key(self, topo, topo_key: tuple, kp: int, mesh=None) -> tuple:
        return (*topology_namespace(topo), *topo_key, self._n_atoms(topo), int(topo.root),
                pm.mesh_cache_key(mesh), int(kp))

    def _remember(self, topo, out, kp: int, mesh=None) -> None:
        """Keep this run's device tensors as the next delta's seed (once per
        key: a repeated run of one generation and root gives the same
        bits).  ``kp`` is in the key: a kp=1 chain keeps SpfTensors, a
        multipath chain the (SpfTensors, MultipathTensors) pair.  The mesh
        is in the key too: a padded run seeds only a padded resident."""
        key = self._prev_key(topo, topo.cache_key, kp, mesh)
        with self._prev_lock:
            if key in self._prev_one:
                return
            # The hand-over seam: this run's fresh tensors take the consumed
            # seed's place.
            with consumes_donated("spf.prev.redeposit"):
                self._prev_one[key] = out
                while len(self._prev_one) > self.prev_capacity:
                    self._prev_one.pop(next(iter(self._prev_one)))

    def _incremental_program(self, topo, kp: int, mesh=None) -> tuple | None:
        """The device program of a DeltaPath dispatch (``holo_tpu``'s
        ``_try_incremental``), in the ``spf.one`` delta stage: the resident
        graph absorbs the delta in place and the incremental SPF runs seeded
        from the kept run of the delta's base.  (device tensors, delta kind,
        device clock, lease), or None for the full path: no lineage, no kept
        run (``full-no-prev``) or a cache that rebuilt the graph (its reason
        already counted).  The kept run of the base leaves ``_prev_one``
        before the program runs; the finish keeps the new one."""
        delta = getattr(topo, "delta_base", None)
        if delta is None or not self.incremental:
            return None
        kind = delta_kind(delta)
        prev_key = self._prev_key(topo, tuple(delta.base_key), kp, mesh)
        if prev_key not in self._prev_one:
            note_delta(self.delta_paths, kind, "full-no-prev")
            return None
        view = self._home(mesh)
        n_atoms = self._n_atoms(topo)
        with profiling.stage("spf.one", "delta"):
            with sanctioned_transfer("spf.one.delta"):
                g, how = view.get(topo, n_atoms, mesh=mesh)
            if how == "miss":
                return None
            _GRAPH_CACHE.labels(result=how).inc()
            with self._prev_lock:
                prev = self._prev_one.pop(prev_key, None)
            if prev is None:  # taken by another thread since the test above
                note_delta(self.delta_paths, kind, "full-no-prev")
                return None
            seeds = delta_seed_rows(delta)
            trop = self._trop_incremental(topo, kp, mesh)
            tt = None
            if trop:
                with sanctioned_transfer("spf.one.delta"):
                    tt = view.get_tropical(topo, n_atoms, mesh)
            generation = view.key(topo, n_atoms, mesh)
            ls = lease(g, tt, generation=generation)
            clk = profiling.device_clock("spf.one", on=g.in_src.device)
            if kp > 1:
                sp, mp = prev
                if trop:
                    out = tropical_spf_one_incremental_multipath(
                        g, tt, topo.root, sp, mp.npaths, mp.nh_weights, seeds, kp,
                        self.max_iters, self.delta_stats)
                else:
                    out = spf_one_incremental_multipath(g, topo.root, sp, mp.npaths,
                                                        mp.nh_weights, seeds, kp, self.max_iters,
                                                        self.delta_stats)
            elif trop:
                out = tropical_spf_one_incremental(g, tt, topo.root, prev, seeds, self.max_iters,
                                                   self.delta_stats)
            else:
                out = spf_one_incremental(g, topo.root, prev, seeds, self.max_iters,
                                          self.delta_stats)
            profiling.sync(clk)
            # The base's kept run was consumed into this generation's.
            note_donated("spf.one.delta", prev, generation=generation)
        return out, kind, clk, ls

    # -- split-phase dispatch (the pipeline's seam)
    #
    # launch_one() runs everything up to the device program's last round
    # and queues the result planes' copies to pinned host memory behind it;
    # finish_one() waits on those copies, builds the SpfResult and books the
    # dispatch.  The port's fixpoints read a changed flag on the host every
    # round, so a launch returns only once the last round has run: what a
    # pipeline overlaps is the tail (the copies, the result's numpy planes,
    # the caller's own work).  compute() is the same two phases back to back
    # (_device_compute), so the results are the same bits and a dispatch is
    # booked in one place.  The stages follow holo_tpu's: marshal or delta
    # in the launch (the program runs in it, as holo_tpu's jit call), device
    # (the wait; its time from the launch's CUDA events) and readback in the
    # finish.  The launch and the finish are spans of their own
    # (spf.launch / spf.finish); compute() is one spf.dispatch span.

    def launch_one(self, topo, edge_mask=None, multipath_k: int = 1) -> _InFlightOne:
        """Phase 1 of a split ``compute``: the chaos seam, the engine pick,
        the graph lookup or the DeltaPath in-place update, the whole device
        program, the host copies queued.  The blocked engine at kp = 1 and
        the partitioned path have no split (a pipeline runs them whole)."""
        faults.crashpoint("spf.dispatch")
        mesh = _mesh()
        if mesh is not None:
            faults.crashpoint("spf.shard")
        kp = mp_pad(multipath_k)
        if (self.engine == "blocked" and kp == 1) or self._use_partitioned(topo):
            raise ValueError("the blocked engine at multipath_k 1 and the partitioned path "
                             "have no split-phase dispatch")
        with telemetry.span("spf.launch", kind="one", backend="torch"):
            return self._launch(topo, edge_mask, kp, stage=True, mesh=mesh)

    def _launch(self, topo, edge_mask, kp: int, stage: bool, mesh=None) -> _InFlightOne:
        """The DeltaPath program where a mask-free dispatch links to a kept
        run, else the full one.  ``stage`` queues the planes' host copies
        for a finish that runs later.  The previous run leaves
        ``_prev_one`` in the DeltaPath program; a pipeline's per-key
        handoff keeps the next delta of the chain from launching before
        :meth:`finish_one` has put the new run back."""
        if edge_mask is None:
            t0 = profiling.clock()
            run = self._incremental_program(topo, kp, mesh)
            if run is not None:
                out, kind, clk, ls = run
                return _InFlightOne(
                    out=out, host=_stage(out, kp) if stage else None, topo=topo, engine="incr",
                    bucket=None, mode="delta", kp=kp, delta_kind=kind, remember=True,
                    launch_s=profiling.clock() - t0, mesh=mesh, t0=t0, clock=clk, lease=ls)
        t0 = profiling.clock()
        out, engine, bucket, how, first, clk, ls = self._one_program(topo, edge_mask, kp, mesh)
        return _InFlightOne(
            out=out, host=_stage(out, kp) if stage else None, topo=topo, engine=engine,
            bucket=bucket, mode="full", kp=kp, remember=edge_mask is None and self.incremental,
            remarshal=how == "miss" and edge_mask is None, first=first,
            launch_s=profiling.clock() - t0, mesh=mesh, t0=t0, clock=clk, lease=ls)

    def finish_one(self, h: _InFlightOne) -> SpfResult:
        """Phase 2: the chaos delay, the wait on the host copies, the
        SpfResult, the tuner samples (the launch's wall and the finish's,
        not the time between) and the kept run."""
        with telemetry.span("spf.finish", kind="one", backend="torch", mode=h.mode):
            return self._finish(h)

    def _finish(self, h: _InFlightOne) -> SpfResult:
        t_fs = profiling.clock()
        with profiling.stage("spf.one", "device", clock=h.clock):
            faults.delaypoint("spf.dispatch")
            # The donation guard's finish seam: a resident moved in place
            # since the launch fails here, named.
            assert_live("spf.one.readback", h.lease)
            staged = _staged(h)
        t1 = profiling.clock()
        with profiling.stage("spf.one", "readback"):
            with sanctioned_transfer("spf.one.unmarshal"):
                res = self._result(staged, h.topo.n_vertices, h.kp)
        t2 = profiling.clock()
        profiling.settle(h.clock, t2 - h.t0)
        _TRANSFER_SECONDS.labels(kind="one").observe(t2 - t1)
        _DISPATCH_SECONDS.labels(backend="torch", kind="one").observe(t2 - h.t0)
        _BATCH_SCENARIOS.labels(kind="one").inc()
        unparked = h.launch_s + (t2 - t_fs)
        if h.mode == "delta":
            note_delta(self.delta_paths, h.delta_kind, "incremental")
            self._tuner_depth_observe(h.topo, "delta", unparked, h.kp, h.mesh)
        else:
            if not h.first:
                self._tuner_observe("one", h.bucket, h.engine, unparked)
            if h.remarshal:
                self._tuner_depth_observe(h.topo, "full", unparked, h.kp, h.mesh)
        if h.remember and self.incremental:
            self._remember(h.topo, h.out, h.kp, h.mesh)
        if h.mesh is not None:
            _SHARD_DISPATCHES.labels(kind="one").inc()
            self.shard_dispatches["one"] += 1
        return res

    def _device_whatif(self, topo, edge_masks, kp: int) -> list:
        mesh = _mesh()
        if mesh is not None:
            faults.crashpoint("spf.shard")
        masks = np.asarray(edge_masks, bool)
        if len(masks) == 0:
            return []
        if self.engine == "blocked" and kp == 1:
            res = self._whatif_blocked(topo, masks)
            if res is not None:
                return res
        b = len(masks)
        t0 = profiling.clock()
        engine, bucket = self._pick_engine("whatif", topo, b, kp, mesh)
        with profiling.dispatch_context(kind="whatif", engine=engine, bucket=bucket), \
                telemetry.span("spf.dispatch", kind="whatif", backend="torch", batch=b):
            with profiling.stage("spf.whatif", "marshal"):
                if mesh is None:
                    tt = None
                    with sanctioned_transfer("spf.whatif.marshal"):
                        g = self.prepare(topo, need_edge_ids=True)
                        if kp == 1 and engine == "tropical":
                            tt = self._gather_cache.get_tropical(topo, self._n_atoms(topo))
                    first = self._first_use("whatif", engine, g, b, kp, topo.n_edges)
                    ls = lease(g, tt, generation=self._gather_cache.key(topo, self._n_atoms(topo)))
                    clk = profiling.device_clock("spf.whatif", on=g.in_src.device)
                    if kp > 1:
                        sp, mp = spf_multipath_batch(g, topo.root, masks, kp, self.max_iters)
                    elif engine == "tropical":
                        sp, mp = tropical_whatif_batch(g, tt, topo.root, masks, None,
                                                       self.max_iters), None
                    else:
                        sp, mp = spf_whatif_batch(g, topo.root, masks, self.max_iters,
                                                  engine), None
                    profiling.sync(clk)
                else:
                    clk = ls = None
                    sp, mp, first = self._sharded_whatif(mesh, topo, masks, engine, kp)
            with profiling.stage("spf.whatif", "device", clock=clk):
                assert_live("spf.whatif.readback", ls)
            t1 = profiling.clock()
            # One bulk copy a plane: per-scenario slices would pay the round
            # trip B times.
            with profiling.stage("spf.whatif", "readback"):
                with sanctioned_transfer("spf.whatif.unmarshal"):
                    mp = {} if mp is None else _host_mp(mp, topo.n_vertices)
                    dist, parent, hops, nh = _host_tensors(sp, topo.n_vertices)
        t2 = profiling.clock()
        profiling.settle(clk, t2 - t0)
        _TRANSFER_SECONDS.labels(kind="whatif").observe(t2 - t1)
        _DISPATCH_SECONDS.labels(backend="torch", kind="whatif").observe(t2 - t0)
        _BATCH_SCENARIOS.labels(kind="whatif").inc(b)
        if mesh is not None:
            _SHARD_DISPATCHES.labels(kind="whatif").inc()
        if not first:
            self._tuner_observe("whatif", bucket, engine, t2 - t0)
        return [
            SpfResult(dist=dist[i], parent=parent[i], hops=hops[i], nexthop_words=nh[i],
                      **{f: x[i] for f, x in mp.items()})
            for i in range(b)
        ]

    def _sharded_whatif(self, mesh, topo, masks, engine: str, kp: int) -> tuple:
        """The what-if batch with its scenarios on the mesh's batch axis
        (``holo_tpu``'s ``_sharded_whatif`` / ``_sharded_mp_whatif`` /
        ``_sharded_trop_whatif``): (SpfTensors, MultipathTensors or None,
        first use), each shard on its device's resident."""
        trop = kp == 1 and engine == "tropical"
        with sanctioned_transfer("spf.whatif.marshal"):
            res = self._resident(mesh, topo, need_edge_ids=True, tiles=trop)
            g0 = res(mesh.batch_device(0))
        first = self._first_use("whatif", engine, g0[0] if trop else g0, len(masks), kp,
                                topo.n_edges, pm.mesh_cache_key(mesh))
        mp = None
        if kp > 1:
            sp, mp = pm.sharded_multipath_program(mesh, res, topo.root, masks, kp,
                                                  self.max_iters, site="spf.whatif")
        elif trop:
            sp = pm.sharded_tropical_whatif_program(mesh, res, topo.root, masks, None,
                                                    self.max_iters, site="spf.whatif")
        else:
            sp = pm.sharded_whatif_program(mesh, res, topo.root, masks, self.max_iters, engine,
                                           site="spf.whatif")
        self.shard_dispatches["whatif"] += 1
        return sp, mp, first

    def _device_multiroot(self, topo, roots) -> MultiRootResult:
        mesh = _mesh()
        if mesh is not None:
            faults.crashpoint("spf.shard")
        roots = np.asarray(roots, np.int32)
        if len(roots) == 0:
            empty = np.zeros((0, topo.n_vertices), np.int32)
            return MultiRootResult(dist=empty, parent=empty.copy(), hops=empty.copy())
        trop = self.one_engine == "tropical"  # holo_tpu's mr_engine
        t0 = profiling.clock()
        clk = ls = None
        with profiling.dispatch_context(kind="multiroot", engine="tropical" if trop else "seq",
                                        bucket=None), \
                telemetry.span("spf.dispatch", kind="multiroot", backend="torch",
                               roots=len(roots)):
            with profiling.stage("spf.multiroot", "marshal"):
                if mesh is not None:
                    # The roots ride the batch axis, padded with root 0.
                    with sanctioned_transfer("spf.multiroot.marshal"):
                        res = self._resident(mesh, topo, tiles=trop)
                        res(mesh.batch_device(0))
                    program = (pm.sharded_tropical_multiroot_program if trop
                               else pm.sharded_multiroot_program)
                    out = program(mesh, res, roots, max_iters=self.max_iters,
                                  site="spf.multiroot")
                    self.shard_dispatches["multiroot"] += 1
                else:
                    tt = None
                    with sanctioned_transfer("spf.multiroot.marshal"):
                        g = self.prepare(topo)
                        if trop:
                            tt = self._gather_cache.get_tropical(topo, self._n_atoms(topo))
                    ls = lease(g, tt, generation=self._gather_cache.key(topo, self._n_atoms(topo)))
                    clk = profiling.device_clock("spf.multiroot", on=g.in_src.device)
                    if trop:
                        out = tropical_multiroot(g, tt, roots, None, None, self.max_iters)
                    else:
                        out = spf_multiroot(g, roots, max_iters=self.max_iters)
                    profiling.sync(clk)
            with profiling.stage("spf.multiroot", "device", clock=clk):
                assert_live("spf.multiroot.readback", ls)
            t1 = profiling.clock()
            with profiling.stage("spf.multiroot", "readback"):
                with sanctioned_transfer("spf.multiroot.unmarshal"):
                    dist, parent, hops, _ = _host_tensors(out, topo.n_vertices)
        t2 = profiling.clock()
        profiling.settle(clk, t2 - t0)
        _TRANSFER_SECONDS.labels(kind="multiroot").observe(t2 - t1)
        _DISPATCH_SECONDS.labels(backend="torch", kind="multiroot").observe(t2 - t0)
        _BATCH_SCENARIOS.labels(kind="multiroot").inc(len(roots))
        if mesh is not None:
            _SHARD_DISPATCHES.labels(kind="multiroot").inc()
        return MultiRootResult(dist=dist, parent=parent, hops=hops)

    @staticmethod
    def _full_mask(topo: Topology, edge_mask) -> np.ndarray:
        if edge_mask is None:
            return np.ones(topo.n_edges, bool)
        return np.asarray(edge_mask, bool)

    @staticmethod
    def _cache_put(cache: dict, key, value):
        cache[key] = value
        while len(cache) > _CACHE_ENTRIES:
            cache.pop(next(iter(cache)))
        return value

    def prepare(self, topo: Topology, need_edge_ids: bool = False):
        """The gather engine's ELL planes on the device, from the cache: a
        hit, a delta applied in place to the base's planes (DeltaPath, when
        ``incremental``), or a full marshal.  ``need_edge_ids``: the caller
        reads ``in_edge_id`` (edge masks).  Under a mesh, the first batch
        device's resident, laid out for the mesh."""
        mesh = _mesh()
        g, how = self._home(mesh).get(topo, self._n_atoms(topo), need_edge_ids=need_edge_ids,
                                      allow_delta=self.incremental, mesh=mesh)
        _GRAPH_CACHE.labels(result=how).inc()
        return g

    def prepare_blocked(self, topo: Topology):
        """Marshal (and cache) the blocked planes: (graph, host perm_of), or
        None when the topology does not meet the blocked engine's
        preconditions (the gather engine serves it).

        The cache key includes the root: the planes bake the root in (BFS
        permutation + rootp).
        """
        key = (*topology_namespace(topo), *topo.cache_key, topo.root)
        if key in self._blocked_cache:
            return self._blocked_cache[key]
        try:
            g = marshal_block_spf(
                topo, n_atoms=max(self.n_atoms, topo.n_atoms()), device=self.device
            )
        except ValueError:
            return self._cache_put(self._blocked_cache, key, None)
        return self._cache_put(self._blocked_cache, key, (g, g.orig2perm.cpu().numpy()))

    def _whatif_blocked(self, topo, edge_masks) -> list[SpfResult] | None:
        """The blocked engine's results, or None (counted in
        ``routed_to_gather``) when the topology or a scenario is outside
        its preconditions."""
        with sanctioned_transfer("spf.blocked.marshal"):
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
        t0 = profiling.clock()
        with profiling.dispatch_context(kind="blocked", engine="blocked", bucket=None), \
                telemetry.span("spf.dispatch", kind="blocked", backend="torch",
                               batch=len(edge_masks)):
            with profiling.stage("spf.blocked", "marshal"):
                clk = profiling.device_clock("spf.blocked", on=self.device)
                out = whatif_spf_blocked(g, fdst, fid, max_iters=self.max_iters)
                profiling.sync(clk)
            with profiling.stage("spf.blocked", "device", clock=clk):
                pass
            t1 = profiling.clock()
            with profiling.stage("spf.blocked", "readback"):
                with sanctioned_transfer("spf.blocked.unmarshal"):
                    dist = out.dist.cpu().numpy()
                    parent = out.parent.cpu().numpy()
                    hops = out.hops.cpu().numpy()
                    nh = out.nexthops.cpu().numpy().view(np.uint32)
        t2 = profiling.clock()
        profiling.settle(clk, t2 - t0)
        _TRANSFER_SECONDS.labels(kind="blocked").observe(t2 - t1)
        _DISPATCH_SECONDS.labels(backend="torch", kind="blocked").observe(t2 - t0)
        _BATCH_SCENARIOS.labels(kind="blocked").inc(dist.shape[0])
        return [
            SpfResult(dist=dist[i], parent=parent[i], hops=hops[i], nexthop_words=nh[i])
            for i in range(dist.shape[0])
        ]
