"""The (batch, node) dispatch mesh of the port: ``holo_tpu/parallel/mesh.py``'s twin.

A :class:`Mesh` is a grid ``[n_batch, n_node]`` of ``torch.device`` entries in
one process.  The daemon, a bench or a test installs one with
:func:`configure_process_mesh`; from then on ``TorchSpfBackend``,
``FrrEngine`` and the per-device graph caches consult :func:`process_mesh`
on every dispatch, and key their residents and tuner buckets by
:func:`mesh_cache_key`, so a reconfigured mesh never serves a resident laid
out for another one.  ``process_mesh() is None`` is the plain single-device
path.

The layout contract, axis by axis:

- **batch** (real): the lanes of a what-if, multi-root, multipath, FRR or
  tropical batch are split into ``n_batch`` contiguous shards.  Shard ``i``
  runs the plain program on ``devices[i, 0]`` against that device's resident
  graph (replicated over batch: each device's shared graph cache holds its
  own copy, one per physical device however many shards it serves).  A
  batch is padded to a multiple of ``n_batch`` as ``holo_tpu`` pads it: masks
  with all-True (no failure) scenarios (:func:`shard_scenarios`), roots with
  0 (:func:`shard_roots`), repair rows with the sentinel
  (:func:`shard_repair_rows`); each shard's planes are read back to the host
  and joined in batch order, then sliced back to B (:func:`gather_batch`, the
  twin of ``constrain_batch``).
- **node** (the layout contract only): a resident's rows are padded to a
  multiple of ``n_node`` (:func:`pad_graph_rows`, the twin of
  ``shard_graph``).  A padded row has no valid in-edge, no direct next-hop
  word and no router bit, so it is unreachable and changes no real row; the
  backend's readback slices the vertex axis back to N and renormalizes the
  no-parent sentinel from the padded row count R to N and the unreachable
  hops from R + 1 to N + 1.  The rows are **not** split across the node
  axis's devices: every batch shard holds the whole padded graph on its
  device, and ``devices[i, 1:]`` serve nothing.  Splitting rows over node
  devices, with a per-round exchange of the state vector (what lets one LSDB
  outgrow one card), needs row-offset forms of the round kernels and a
  multi-GPU runtime (``torch.distributed``); it is queued as ROADMAP A12b.

A size-1 mesh degenerates to the plain program everywhere: no padding, no
readback of its own, the plain program's tensors returned as they are, as
``holo_tpu``'s 1-device mesh does (``mesh.py:152-157``, ``:249-254``,
``:276-277``).  The shards of a mesh run one after another on the caller's
thread (concurrency across distinct cards is A12b too).  The axis sizes are
``holo_parallel_mesh_size{axis}`` (and :func:`mesh_stats`); a sharded program
given its dispatch ``site`` times each shard's device phase on that shard's
own CUDA events, one ``device=<index>`` row each
(``telemetry.profiling.device_stages``).  ``holo_tpu``'s audit
registrations come with the kernel-contract audit (ROADMAP A13c).
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from holo_tpu_torch import telemetry
from holo_tpu_torch.analysis.runtime import sanctioned_transfer
from holo_tpu_torch.device import resolve_device
from holo_tpu_torch.telemetry import profiling

_MESH_SIZE = telemetry.gauge(
    "holo_parallel_mesh_size",
    "Process dispatch-mesh axis sizes (0 = no mesh: single-device path)",
    ("axis",),
)


def _normal(device) -> torch.device:
    """``device`` as a torch.device with the card's index filled in."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """A ``[n_batch, n_node]`` grid of devices (``holo_tpu``'s ``jax.sharding.Mesh``
    over axes ``("batch", "node")``)."""

    def __init__(self, devices: np.ndarray):
        if devices.ndim != 2 or devices.size == 0:
            raise ValueError(f"a mesh is a non-empty [n_batch, n_node] grid, got {devices.shape}")
        self.devices = devices

    @property
    def shape(self) -> dict:
        return {"batch": int(self.devices.shape[0]), "node": int(self.devices.shape[1])}

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def batch_device(self, i: int) -> torch.device:
        """The device batch shard ``i`` runs on (the first of its row)."""
        return self.devices[i, 0]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.flat]})"


def virtual_devices(n: int, device=None) -> list:
    """``n`` entries of one device: the card by default, ``"cpu"`` in the tests
    (the twin of ``holo_tpu.testing.force_virtual_cpu_mesh``, which makes n
    virtual CPU devices for JAX).  A mesh over them runs every shard on that
    one device."""
    return [_normal(resolve_device(device))] * int(n)


def make_spf_mesh(n_batch: int | None = None, n_node: int | None = None,
                  devices: list | None = None) -> Mesh:
    """A (batch, node) mesh over ``devices``: every visible CUDA device when
    None (there is no CPU fallback: with no card this raises).  With neither
    axis given all devices go on the batch axis; with one given the other is
    the quotient; a product that is not the device count raises
    ``ValueError``, as ``holo_tpu``'s ``make_spf_mesh``."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_spf_mesh: no CUDA device is visible, and the mesh has no "
                               "CPU fallback; pass devices=virtual_devices(n, 'cpu') to lay a "
                               "mesh over the host")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [_normal(d) for d in devices]
    nd = len(devices)
    if n_batch is None and n_node is None:
        n_batch, n_node = nd, 1
    elif n_batch is None:
        n_batch = nd // n_node
    elif n_node is None:
        n_node = nd // n_batch
    if n_batch * n_node != nd:
        raise ValueError(f"mesh {n_batch}x{n_node} != {nd} devices")
    arr = np.empty(nd, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(n_batch, n_node))


# The process-wide dispatch mesh (None: the single-device path).
_PROCESS_MESH: Mesh | None = None
_MESH_LOCK = threading.Lock()


def configure_process_mesh(n_batch: int | None = None, n_node: int | None = None,
                           devices: list | None = None) -> Mesh:
    """Install the process-wide dispatch mesh (daemon boot; bench and tests).
    Safe to call again with another shape: residents and tuner buckets are
    keyed by :func:`mesh_cache_key`."""
    global _PROCESS_MESH
    mesh = make_spf_mesh(n_batch, n_node, devices)
    with _MESH_LOCK:
        _PROCESS_MESH = mesh
    _MESH_SIZE.labels(axis="batch").set(mesh.shape["batch"])
    _MESH_SIZE.labels(axis="node").set(mesh.shape["node"])
    return mesh


def reset_process_mesh() -> None:
    """Drop the process mesh: later dispatches take the single-device path."""
    global _PROCESS_MESH
    with _MESH_LOCK:
        _PROCESS_MESH = None
    _MESH_SIZE.labels(axis="batch").set(0)
    _MESH_SIZE.labels(axis="node").set(0)


def process_mesh() -> Mesh | None:
    """The installed dispatch mesh, or None."""
    return _PROCESS_MESH


def mesh_stats() -> dict:
    """The axis sizes of the process mesh, 0 with none (the values of
    ``holo_tpu``'s ``holo_parallel_mesh_size{axis}`` gauge)."""
    m = _PROCESS_MESH
    return {"batch": 0, "node": 0} if m is None else m.shape


def mesh_cache_key(mesh: Mesh | None) -> tuple | None:
    """Hashable identity of a dispatch's mesh for resident and tuner-bucket
    keys: ``(n_batch, n_node, *device strings in order)``, None for no mesh.
    Two meshes of one shape over the same devices key alike, so toggling one
    mesh on and off hits warm entries.  Flat, so a tuner table's JSON keys
    read back as the same tuple.  (``holo_tpu``'s reads the process mesh by
    default; a port dispatch reads the mesh once and passes it.)"""
    if mesh is None:
        return None
    return (mesh.shape["batch"], mesh.shape["node"], *(str(d) for d in mesh.devices.flat))


# -- the node axis: row padding


def padded_rows(n: int, mesh: Mesh | None) -> int:
    """The row count of an n-vertex resident under ``mesh``: n rounded up to
    a multiple of the node axis (n itself with no mesh or a size-1 one)."""
    if mesh is None or mesh.size == 1:
        return int(n)
    nn = mesh.shape["node"]
    return -(-int(n) // nn) * nn


def pad_graph_rows(g, mesh: Mesh | None):
    """A DeviceGraph's planes with their rows zero-padded to
    :func:`padded_rows` (``holo_tpu``'s ``shard_graph`` without the
    placement: every batch shard holds the whole graph).  A pad row has no
    valid in-edge (``in_valid`` False, ``in_edge_id`` 0 but unused), no
    direct word and no router bit; ``g`` itself where nothing pads."""
    n = g.in_src.shape[0]
    rows = padded_rows(n, mesh)
    if rows == n:
        return g
    return type(g)(*(torch.cat([x, x.new_zeros((rows - n, *x.shape[1:]))]) for x in g))


# -- the batch axis: shards, the shard loop and the join


def shard_rows(mesh: Mesh, x: np.ndarray, fill) -> list:
    """``x`` padded along axis 0 to a multiple of the batch axis with rows of
    ``fill``, cut into the batch shards (``[x]`` on a size-1 mesh)."""
    pad = (-x.shape[0]) % mesh.shape["batch"]
    if pad:
        x = np.concatenate([x, np.full((pad, *x.shape[1:]), fill, x.dtype)])
    if mesh.size == 1:
        return [x]
    return np.split(x, mesh.shape["batch"])


def shard_scenarios(mesh: Mesh, edge_masks) -> list:
    """A scenario mask batch bool [B, E] as the batch shards' masks, padded
    with all-True (no failure) scenarios.  Each shard's masks are packed
    into lane words on its own device, so no word straddles two shards."""
    return shard_rows(mesh, np.asarray(edge_masks, bool), True)


def shard_roots(mesh: Mesh, roots) -> list:
    """A multi-root batch int32 [R] as the shards' roots, padded with root 0."""
    return shard_rows(mesh, np.asarray(roots, np.int32).reshape(-1), 0)


def shard_repair_rows(mesh: Mesh, rows, sentinel: int) -> list:
    """A per-scenario repair-row batch int32 [S, M] as the shards' rows,
    padded with sentinel-only rows (a pad scenario fails nothing)."""
    return shard_rows(mesh, np.asarray(rows, np.int32), int(sentinel))


def _host(out):
    """A program's output (a tensor, None, or tuples and NamedTuples of them)
    read back to CPU tensors."""
    if out is None:
        return None
    if torch.is_tensor(out):
        with sanctioned_transfer("mesh.shard.readback"):
            return out.cpu()
    items = [_host(x) for x in out]
    return type(out)(*items) if hasattr(out, "_fields") else tuple(items)


def _join(parts: list, b: int):
    first = parts[0]
    if first is None:
        return None
    if torch.is_tensor(first):
        return torch.cat(parts)[:b]
    items = [_join([p[i] for p in parts], b) for i in range(len(first))]
    return type(first)(*items) if hasattr(first, "_fields") else tuple(items)


def gather_batch(mesh: Mesh, parts: list, b: int):
    """The shards' outputs (read back to the host) joined in batch order along
    the leading axis and sliced to ``b`` (``constrain_batch``'s twin); on a
    size-1 mesh the one part as it is."""
    if mesh.size == 1:
        return parts[0]
    return _join(parts, b)


def per_device(resident):
    """``resident(device)`` computed once per physical device of a dispatch
    (a batch shard's graph, tiles or FRR matrix, shared by the shards on one
    device)."""
    memo = {}

    def get(dev):
        if dev not in memo:
            memo[dev] = resident(dev)
        return memo[dev]

    return get


def run_batch(mesh: Mesh, shards: list, resident, run, b: int, site: str | None = None):
    """``run(resident(device), shard)`` for each batch shard on its device,
    each output read back to the host, joined by :func:`gather_batch`.  On a
    size-1 mesh the one run's output, on its device.  With profiling armed
    and a dispatch ``site``, each shard's run is a ``stage(site, "device",
    device=<index>)`` on its own CUDA events, settled once the shards are
    read back (``profiling.device_stages``)."""
    res = per_device(resident)
    if mesh.size == 1:
        return run(res(mesh.batch_device(0)), shards[0])
    parts, clocks = [], []
    for i, shard in enumerate(shards):
        dev = mesh.batch_device(i)
        g = res(dev)
        clk = None if site is None else profiling.device_clock(site, on=dev, device=str(i))
        if clk is None:
            out = run(g, shard)
        else:
            with profiling.stage(site, "device", device=str(i), clock=clk):
                out = run(g, shard)
                profiling.sync(clk)
            clocks.append(clk)
        parts.append(_host(out))
    profiling.device_stages(site, clocks)
    return gather_batch(mesh, parts, b)


# -- the sharded programs (``holo_tpu``'s sharded jits)


def sharded_whatif_program(mesh: Mesh, resident, root: int, edge_masks, max_iters=None,
                           engine: str = "seq", site: str | None = None):
    """``spf_whatif_batch`` with the scenarios on the batch axis:
    ``resident(device)`` gives a shard's DeviceGraph; [B, R] planes (on the
    host past a size-1 mesh)."""
    from holo_tpu_torch.ops.spf_engine import spf_whatif_batch

    return run_batch(mesh, shard_scenarios(mesh, edge_masks), resident,
                     lambda g, m: spf_whatif_batch(g, root, m, max_iters, engine),
                     len(edge_masks), site)


def sharded_multipath_program(mesh: Mesh, resident, root: int, edge_masks, kp: int,
                              max_iters=None, site: str | None = None):
    """``spf_multipath_batch`` with the scenarios on the batch axis:
    (SpfTensors, MultipathTensors) with a leading batch axis."""
    from holo_tpu_torch.ops.spf_engine import spf_multipath_batch

    return run_batch(mesh, shard_scenarios(mesh, edge_masks), resident,
                     lambda g, m: spf_multipath_batch(g, root, m, kp, max_iters),
                     len(edge_masks), site)


def sharded_multiroot_program(mesh: Mesh, resident, roots, max_iters=None,
                              site: str | None = None):
    """``spf_multiroot`` with the roots on the batch axis: [R, N] planes."""
    from holo_tpu_torch.ops.spf_engine import spf_multiroot

    roots = np.asarray(roots, np.int32)
    return run_batch(mesh, shard_roots(mesh, roots), resident,
                     lambda g, r: spf_multiroot(g, r, max_iters=max_iters), roots.shape[0], site)


def sharded_tropical_whatif_program(mesh: Mesh, resident, root: int, edge_masks,
                                    repair_rows=None, max_iters=None, site: str | None = None):
    """``tropical_whatif_batch`` with the scenarios on the batch axis;
    ``resident(device)`` gives (DeviceGraph, TropicalTiles).  Explicit
    ``repair_rows`` [B, M] are sharded with the resident's row count as the
    sentinel; None builds each shard's repair set on its device."""
    from holo_tpu_torch.ops.tropical import tropical_whatif_batch

    res = per_device(resident)
    masks = shard_scenarios(mesh, edge_masks)
    rows = [None] * len(masks)
    if repair_rows is not None:
        sentinel = res(mesh.batch_device(0))[0].in_src.shape[0]
        rows = shard_repair_rows(mesh, repair_rows, sentinel)
    return run_batch(mesh, list(zip(masks, rows)), res,
                     lambda gt, s: tropical_whatif_batch(*gt, root, s[0], s[1], max_iters),
                     len(edge_masks), site)


def sharded_tropical_multiroot_program(mesh: Mesh, resident, roots, edge_mask=None,
                                       repair_rows=None, max_iters=None,
                                       site: str | None = None):
    """``tropical_multiroot`` with the roots on the batch axis (the mask and
    repair rows [M] shared by every root, as there)."""
    from holo_tpu_torch.ops.tropical import tropical_multiroot

    roots = np.asarray(roots, np.int32)
    return run_batch(mesh, shard_roots(mesh, roots), resident,
                     lambda gt, r: tropical_multiroot(*gt, r, edge_mask, repair_rows, max_iters),
                     roots.shape[0], site)


def replicated_device(mesh: Mesh) -> torch.device:
    """Where a partitioned resident's stacks live under a mesh:
    ``holo_tpu``'s replicated arm (``ops/partition.py:377-389``) on every
    mesh shape.  The partitioned solve is one program over every part, not
    a batch of independent lanes the port splits, so one copy on the first
    batch device serves it."""
    return mesh.batch_device(0)
