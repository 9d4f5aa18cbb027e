"""FRR engine + backup resolution policy.

The port's counterpart of ``holo_tpu.frr.manager``.  :class:`FrrEngine` is
the dispatch point the protocol layer calls right after its primary SPF:
Topology in, :class:`~holo_tpu_torch.frr.kernel.BackupTable` out, through
the batched path (:func:`holo_tpu_torch.frr.kernel.frr_batch`) on the CUDA
card (``engine="torch"``) or the scalar oracle (``engine="scalar"``, the
default, as in ``holo_tpu``).  Both are bit-identical; the batched path runs
under a :class:`~holo_tpu_torch.resilience.breaker.CircuitBreaker`, which
counts its device failures.  On the CPU with no ``max_iters`` cap the
oracle over the same marshaled inputs and policy serves a failed dispatch;
on the card the failure re-raises (the oracle runs one Python Dijkstra per
vertex and per protected link, no substitute for the card's work).

``resolve_backup`` applies the configured protection policy to one
(protected link, destination vertex) query: direct LFA first, then the
remote-LFA PQ tunnel, then the TI-LFA segment repair.  The result is
symbolic (atoms + repair vertices); the protocol layer maps atoms to
(interface, address) next hops and repair vertices to SR labels.

The device dispatch has two phases, as ``holo_tpu``'s ``_launch_tpu`` /
``_finish_tpu``: :meth:`FrrEngine._launch_device` runs the batched program
and queues the tables' copies to pinned host memory behind it,
:meth:`FrrEngine._finish_device` waits on them and builds the table.  The
synchronous path runs one after the other and queues no copy (the finish
reads the tables back with ``.cpu()``); the dispatch pipeline
(``holo_tpu_torch.pipeline.dispatch.AsyncFrrEngine``) runs them as two
phases on its worker.

Under a dispatch mesh (:mod:`holo_tpu_torch.parallel.mesh`) the device
dispatch splits its protected links over the mesh's batch axis, padded as
``holo_tpu``'s ``_shard_args`` pads them (a pad link is invalid, costs 1 and
fails nothing); each shard runs the post-convergence batch and the selection
on its device's resident graph, whose all-roots matrix ``D`` is computed once
per physical device and shared by the shards on it; the tables are read back
and joined in link order, then cut to the real links (``[:nl]``) and
vertices (``[:n]``: the node axis pads the resident's rows).  A size-1 mesh
runs the plain ``frr_batch``.  ``faults.crashpoint("frr.shard")`` is the
shard chaos seam.

Telemetry, under ``holo_tpu``'s names: ``holo_frr_dispatch_seconds{engine}``
(one ``frr.dispatch`` span a ``compute``), ``holo_frr_graph_cache_total
{result}``, ``holo_frr_pad_occupancy{plane}``, ``holo_spf_shard_dispatch_
total{kind=frr}`` and the ``frr.batch`` marshal / device / readback stages
(``telemetry.profiling``; the device stage's time from CUDA events recorded
around the program).  The engine also keeps its counters: ``graph_cache``
(marshaled-graph lookups by result), ``dispatches`` (by path: device,
fallback, scalar) and ``shard_dispatches``.  ``stats``, when set to a dict,
receives each device dispatch's stage times (a mesh's dispatch: its shard
count only).
"""

from __future__ import annotations

import time
from collections import Counter
from dataclasses import dataclass

import numpy as np

from holo_tpu_torch import telemetry
from holo_tpu_torch.analysis.runtime import sanctioned_transfer
from holo_tpu_torch.device import resolve_device
from holo_tpu_torch.frr.inputs import marshal_frr
from holo_tpu_torch.frr.kernel import (
    BackupTable,
    all_roots,
    frr_batch,
    frr_select,
    host_tables,
    stage_tables,
)
from holo_tpu_torch.frr.scalar import frr_reference
from holo_tpu_torch.ops.spf_engine import shared_graph_cache, spf_whatif_batch
from holo_tpu_torch.parallel import mesh as pm
from holo_tpu_torch.resilience import faults
from holo_tpu_torch.resilience.breaker import CircuitBreaker
from holo_tpu_torch.telemetry import profiling

_FRR_SECONDS = telemetry.histogram(
    "holo_frr_dispatch_seconds",
    "Wall time of one backup-table computation (marshal + dispatch + readback)",
    ("engine",))
_FRR_GRAPH_CACHE = telemetry.counter(
    "holo_frr_graph_cache_total", "Marshaled DeviceGraph cache lookups (FRR engine)",
    ("result",))
_FRR_PAD_OCCUPANCY = telemetry.gauge(
    "holo_frr_pad_occupancy", "Valid fraction of the padded FRR plane (last dispatch)",
    ("plane",))
_FRR_SHARD_DISPATCHES = telemetry.counter(
    "holo_spf_shard_dispatch_total",
    "Dispatches routed through the process-mesh sharded path "
    "(parallel/mesh.py layout contract)", ("kind",))


@dataclass
class FrrConfig:
    """The fast-reroute policy (ietf-ospf ``fast-reroute/lfa``, holo's
    ti-lfa extension leaves):

    - ``node_protection``: only node-protecting LFAs are selectable;
      uncovered destinations fall through to remote LFA / TI-LFA;
    - ``srlg_disjoint``: repair candidates sharing any SRLG bit
      (``Topology.edge_srlg``) with the protected link are excluded;
    - ``protected_prefixes``: when not None, backups attach only to routes
      covered by one of these networks.
    """

    enabled: bool = False  # LFA (RFC 5286)
    remote_lfa: bool = False  # RFC 7490 (requires enabled)
    ti_lfa: bool = False  # TI-LFA segment repairs (requires enabled + SR)
    engine: str = "scalar"  # 'scalar' | 'torch'
    node_protection: bool = False  # LFA must node-protect
    srlg_disjoint: bool = False  # backup must be SRLG-disjoint
    protected_prefixes: tuple | None = None  # None = protect everything

    def active(self) -> bool:
        return self.enabled

    def protects_prefix(self, prefix) -> bool:
        """Is ``prefix`` in the protection scope?"""
        if self.protected_prefixes is None:
            return True
        for scope in self.protected_prefixes:
            try:
                if prefix == scope or prefix.subnet_of(scope):
                    return True
            except (TypeError, ValueError):
                continue  # mixed address families never match
        return False


@dataclass(frozen=True)
class BackupEntry:
    """One resolved repair for (protected link, destination vertex)."""

    kind: str  # 'lfa' | 'rlfa' | 'ti-lfa'
    atom: int | None  # release next-hop atom (None: the caller falls back
    # to its primary next hop toward via[0])
    via: tuple[int, ...] = ()  # repair vertices: () | (pq,) | (p[, q])
    node_protecting: bool = False


def first_atom(words: np.ndarray) -> int | None:
    """Lowest set atom id in a uint32 bitmask row (deterministic pick)."""
    for wi, word in enumerate(np.asarray(words, np.uint32)):
        w = int(word)
        if w:
            return wi * 32 + (w & -w).bit_length() - 1
    return None


def resolve_backup(table: BackupTable, cfg: FrrConfig, link: int, dest: int) -> BackupEntry | None:
    """Pick the repair for (link, dest) under ``cfg``; None = unprotected."""
    if not cfg.enabled or link < 0 or link >= table.n_links:
        return None
    fin = table.inputs
    a = int(table.lfa_adj[link, dest])
    if a >= 0:
        return BackupEntry(
            kind="lfa",
            atom=int(fin.adj_atom[a]),
            via=(int(fin.adj_nbr[a]),),
            node_protecting=bool(table.lfa_nodeprot[link, dest]),
        )
    if cfg.remote_lfa:
        pq = int(table.rlfa_pq[link, dest])
        if pq >= 0:
            # Release toward the PQ node: its own LFA pick when the plain
            # P-space route would still cross the failed link.
            rel = int(table.lfa_adj[link, pq])
            atom = int(fin.adj_atom[rel]) if rel >= 0 else None
            return BackupEntry(kind="rlfa", atom=atom, via=(pq,))
    if cfg.ti_lfa:
        p = int(table.tilfa_p[link, dest])
        if p >= 0:
            q = int(table.tilfa_q[link, dest])
            atom = first_atom(table.post_nh[link, dest])
            via = (p,) if q < 0 else (p, q)
            return BackupEntry(kind="ti-lfa", atom=atom, via=via)
    return None


def repair_map(table: BackupTable | None, cfg: FrrConfig, words: np.ndarray,
               vertex: int) -> dict[int, BackupEntry]:
    """{primary next-hop atom id -> repair} for one destination vertex.

    Each primary atom rides exactly one protected link (``atom_link``), and
    the repair for (that link, this destination) is what the router flips to
    when the link's BFD session or carrier drops.  Entries whose repair has
    no release atom are omitted: no forwarding entry can be built from
    them."""
    out: dict[int, BackupEntry] = {}
    if table is None or not cfg.active():
        return out
    for wi, word in enumerate(np.asarray(words, np.uint32)):
        w = int(word)
        while w:
            low = w & -w
            a = wi * 32 + low.bit_length() - 1
            w ^= low
            link = table.link_of_atom(a)
            if link is None:
                continue
            entry = resolve_backup(table, cfg, link, vertex)
            if entry is not None and entry.atom is not None:
                out[a] = entry
    return out


def ensure_engine(current, cfg: FrrConfig) -> "FrrEngine":
    """Reuse ``current`` when it already runs ``cfg.engine``, else build a
    fresh engine (its caches are its own); either way adopt ``cfg``'s
    policy.  The lazy-create step of a protocol instance's ``_frr_engine``
    slot.  A fresh ``torch`` engine runs on the card."""
    if current is not None and current.engine == cfg.engine:
        current.set_policy(cfg)
        return current
    engine = FrrEngine(engine=cfg.engine)
    engine.set_policy(cfg)
    return engine


class FrrEngine:
    """Backup-table computation behind the SpfBackend-style interface."""

    def __init__(
        self,
        engine: str = "scalar",
        device=None,
        n_atoms: int = 64,
        max_iters: int | None = None,
        breaker: CircuitBreaker | None = None,
    ):
        """``engine``: ``"torch"`` (the batched path on ``device``: the card
        unless ``device="cpu"``) or ``"scalar"`` (the oracle on the host).
        ``breaker`` guards the device path (see the module docstring for
        what serves a failed ``frr_batch`` dispatch)."""
        if engine not in ("scalar", "torch"):
            raise ValueError(f"engine {engine!r}: the port runs 'scalar' and 'torch'")
        self.engine = engine
        self.device = resolve_device(device) if engine == "torch" else None
        self.n_atoms = n_atoms
        self.max_iters = max_iters
        self.breaker = breaker if breaker is not None else CircuitBreaker("frr-dispatch")
        # Protection policy (node-protection / SRLG-disjoint masks).
        self.policy = FrrConfig()
        self.graph_cache: Counter = Counter()  # shared-cache lookups: hit | delta | miss
        self.dispatches: Counter = Counter()  # device | fallback | scalar
        self.shard_dispatches: Counter = Counter()  # frr: dispatches the mesh served
        # Set to a dict to receive each device dispatch's stage times.
        self.stats: dict | None = None

    def set_policy(self, cfg: FrrConfig) -> None:
        """Adopt the instance's protection policy (the ensure_engine seam)."""
        self.policy = cfg

    def _policy_args(self, fin) -> tuple:
        """(link_srlg, adj_srlg, require_np) under the current policy.  A
        disarmed SRLG policy passes all-zero planes, which exclude
        nothing."""
        if self.policy.srlg_disjoint:
            lsr, asr = fin.link_srlg, fin.adj_srlg
        else:
            lsr = np.zeros_like(fin.link_srlg)
            asr = np.zeros_like(fin.adj_srlg)
        return lsr, asr, np.bool_(self.policy.node_protection)

    def marshal_inputs(self, topo):
        """The FRR planes of ``topo`` (the front half of :meth:`compute`) and
        the pad-occupancy gauges (the adjacency plane's mean sampled at
        scrape time)."""
        fin = marshal_frr(topo)
        lp = fin.link_valid.shape[0]
        if lp:
            _FRR_PAD_OCCUPANCY.labels(plane="links").set(fin.n_links / lp)
        if fin.adj_valid.shape[0]:
            _FRR_PAD_OCCUPANCY.labels(plane="adjs").set_fn(
                telemetry.deferred_mean(fin.adj_valid))
        return fin

    def _prepare(self, topo, device=None, mesh=None):
        """The device graph from the per-device shared cache (``device``'s,
        laid out for ``mesh``; by default this engine's, no mesh).  The
        scenario masks gather through ``in_edge_id``, so an entry whose edge
        ids went stale under a structural delta is rebuilt
        (``need_edge_ids``)."""
        with sanctioned_transfer("frr.batch.marshal"):
            g, how = shared_graph_cache(self.device if device is None else device).get(
                topo, max(self.n_atoms, topo.n_atoms()), need_edge_ids=True, mesh=mesh)
        self.graph_cache[how] += 1
        _FRR_GRAPH_CACHE.labels(result=how).inc()
        return g

    def fallback_serves(self) -> bool:
        """Does the oracle compute this engine's bits?  On the CPU with no
        ``max_iters`` cap only (under a mesh, every device of it on the
        CPU); it is then the breaker's fallback."""
        mesh = pm.process_mesh()
        on_cpu = self.device.type == "cpu" and (
            mesh is None or all(d.type == "cpu" for d in mesh.devices.flat))
        return on_cpu and self.max_iters is None

    def _shard_args(self, mesh, fin) -> list:
        """The per-link planes (link_far, link_cost, link_valid, edge_masks,
        link_srlg) of each batch shard, padded to the batch axis as
        ``holo_tpu``'s ``_shard_args``: a pad link is far 0, cost 1, invalid,
        with an all-True scenario mask and no SRLG bit."""
        lsr = self._policy_args(fin)[0]
        planes = [pm.shard_rows(mesh, np.asarray(x), fill) for x, fill in (
            (fin.link_far, 0), (fin.link_cost, 1), (fin.link_valid, False),
            (fin.edge_masks, True), (lsr, 0))]
        return list(zip(*planes))

    def _sharded(self, mesh, topo, fin):
        """The FRR tables with the protected links on the batch axis: on
        each shard's device ``D`` (once per physical device), the post
        batch of its links and the selection; host tensors joined in link
        order; a size-1 mesh runs the plain ``frr_batch``."""
        if mesh.size == 1:
            return frr_batch(
                self._prepare(topo, mesh.batch_device(0), mesh), topo.root, fin.link_far,
                fin.link_cost, fin.link_valid, fin.edge_masks, fin.adj_nbr, fin.adj_cost,
                fin.adj_link, fin.adj_valid, *self._policy_args(fin), max_iters=self.max_iters,
                stats=self.stats)
        _, asr, rnp = self._policy_args(fin)
        root = int(topo.root)

        def resident(dev):
            g = self._prepare(topo, dev, mesh)
            return g, all_roots(g, self.max_iters)

        def run(gd, shard):
            g, D = gd
            offset, (lf, lc, lv, em, lsr) = shard
            post = spf_whatif_batch(g, root, em, self.max_iters)
            return frr_select(D, post, root, g.is_router, lf, lc, lv, fin.adj_nbr,
                              fin.adj_cost, fin.adj_link, fin.adj_valid, lsr, asr, rnp,
                              self.max_iters, link_offset=offset)

        shards = self._shard_args(mesh, fin)
        width = shards[0][0].shape[0]
        shards = [(i * width, shard) for i, shard in enumerate(shards)]
        if self.stats is not None:
            self.stats["shards"] = len(shards)
        return pm.run_batch(mesh, shards, resident, run, np.asarray(fin.link_far).shape[0],
                            site="frr.batch")

    def _compute_device(self, topo, fin) -> BackupTable:
        # Back to back: the finish reads the tables back with .cpu().
        return self._finish_device(self._launch_device(topo, fin, queue=False))

    def _launch_device(self, topo, fin, queue: bool = True) -> tuple:
        """Phase 1 of the device dispatch: the chaos seam, the shared graph,
        the batched program, the tables' host copies queued behind it
        (``queue``; else the finish reads them back).  Returns the handle
        :meth:`_finish_device` completes."""
        faults.crashpoint("frr.dispatch")
        mesh = pm.process_mesh()
        t0 = profiling.clock()
        with profiling.stage("frr.batch", "marshal"):
            if mesh is not None:
                # The shard chaos seam: a device lost from the mesh surfaces
                # here, and the breaker counts it like any device failure.
                faults.crashpoint("frr.shard")
                clk = None
                out = self._sharded(mesh, topo, fin)
            else:
                g = self._prepare(topo)
                clk = profiling.device_clock("frr.batch", on=g.in_src.device)
                out = frr_batch(
                    g, topo.root, fin.link_far, fin.link_cost, fin.link_valid, fin.edge_masks,
                    fin.adj_nbr, fin.adj_cost, fin.adj_link, fin.adj_valid,
                    *self._policy_args(fin), max_iters=self.max_iters, stats=self.stats,
                )
                profiling.sync(clk)
            # [:nl] drops the link pad (the marshal's bucket and the mesh's
            # batch axis), [:n] the rows a node axis pads.
            staged = stage_tables(out, fin, topo.n_vertices, queue)
        return staged, fin, topo, mesh is not None, clk, t0

    def _finish_device(self, handle: tuple) -> BackupTable:
        """Phase 2: the chaos delay, the wait on the copies, the table."""
        staged, fin, topo, sharded, clk, t_launch = handle
        t0 = time.perf_counter()
        with profiling.stage("frr.batch", "device", clock=clk):
            faults.delaypoint("frr.dispatch")
            staged.wait()
        if sharded:
            _FRR_SHARD_DISPATCHES.labels(kind="frr").inc()
        with profiling.stage("frr.batch", "readback"):
            with sanctioned_transfer("frr.batch.unmarshal"):
                table = host_tables(staged, fin, topo.root)
        profiling.settle(clk, profiling.clock() - t_launch)
        if self.stats is not None:
            self.stats["readback_ms"] = (time.perf_counter() - t0) * 1e3
        self.dispatches["device"] += 1
        if sharded:
            self.shard_dispatches["frr"] += 1
        return table

    def _scalar(self, topo, fin) -> BackupTable:
        return frr_reference(
            topo, self.n_atoms, inputs=fin,
            srlg_disjoint=self.policy.srlg_disjoint,
            node_protection=self.policy.node_protection,
        )

    def _scalar_fallback(self, topo, fin) -> BackupTable:
        """The breaker's degraded path: the oracle over the same marshaled
        inputs and policy."""
        self.dispatches["fallback"] += 1
        return self._scalar(topo, fin)

    def compute(self, topo) -> BackupTable:
        """One batched backup-table computation for ``topo.root``."""
        t0 = time.perf_counter()
        with telemetry.span("frr.dispatch", engine=self.engine):
            fin = self.marshal_inputs(topo)
            if self.stats is not None:
                self.stats.clear()
                self.stats["marshal_ms"] = (time.perf_counter() - t0) * 1e3
            if self.engine == "torch":
                table = self.breaker.call(
                    lambda: self._compute_device(topo, fin),
                    (lambda: self._scalar_fallback(topo, fin)) if self.fallback_serves()
                    else None,
                    "frr.batch",
                )
            else:
                self.dispatches["scalar"] += 1
                table = self._scalar(topo, fin)
        _FRR_SECONDS.labels(engine=self.engine).observe(time.perf_counter() - t0)
        return table
