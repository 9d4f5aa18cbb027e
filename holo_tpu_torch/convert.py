"""Bring the JAX package's engine state across to the port.

The arguments are the fields of a ``holo_tpu`` ``BlockSpfGraph`` /
``BlockGraph`` / ``DeviceGraph`` / ``SpfTensors`` / ``MultipathTensors`` as
a mapping of numpy arrays and ints (``np.asarray`` of each), so this module
needs neither JAX nor ``holo_tpu``.  The tests use it to run both packages
on identical planes, and to seed both packages' incremental paths with the
same previous run.  ``frr_inputs_from_jax`` and ``backup_table_from_jax``
carry ``holo_tpu``'s FRR values across, read by their fields;
``partition_from_numpy`` turns a ``holo_tpu`` ``PartitionPlan`` and its
``PartPlanes`` into the port's plan and stacked planes, so both engines can
run one cut; ``bgp_table_from_numpy`` carries a ``holo_tpu`` BGP table
backend's resident table (planes and interners) into the port's;
``lsdb_from_wire`` builds the port's OSPFv2 ``Lsdb`` from LSAs' wire images
and install times, so both packages can marshal and route over one LSDB.
"""

from __future__ import annotations

import copy
import dataclasses
from collections.abc import Mapping

import numpy as np
import torch

from holo_tpu_torch.device import resolve_device
from holo_tpu_torch.frr.inputs import FrrInputs
from holo_tpu_torch.frr.kernel import TABLE_PLANES, BackupTable
from holo_tpu_torch.ops.bgp_table import _DevTable, _Interner
from holo_tpu_torch.ops.blocked import BlockGraph, block_graph, edge_planes
from holo_tpu_torch.ops.blocked_spf import BlockSpfGraph, block_spf_graph
from holo_tpu_torch.ops.partition import PartitionPlan, stack_layout
from holo_tpu_torch.ops.spf_engine import DeviceGraph, MultipathTensors, SpfTensors
from holo_tpu_torch.protocols.ospf.lsdb import Lsdb
from holo_tpu_torch.protocols.ospf.packet import Lsa
from holo_tpu_torch.utils.bytesbuf import Reader


def _port_arrays(fields: Mapping) -> dict:
    """numpy copies of the fields plus the port's compact edge planes,
    which the JAX graphs do not carry."""
    arrays = {k: np.asarray(v) for k, v in fields.items()}
    arrays.update(edge_planes(arrays["w"]))
    return arrays


def block_spf_graph_from_numpy(fields: Mapping, device=None) -> BlockSpfGraph:
    """Port ``BlockSpfGraph`` from the JAX one's fields (``first`` is dropped;
    the port derives per-block pair offsets from ``bdst``)."""
    return block_spf_graph(_port_arrays(fields), resolve_device(device))


def block_graph_from_numpy(fields: Mapping, device=None) -> BlockGraph:
    """Port ``BlockGraph`` from the JAX one's fields."""
    arrays = _port_arrays({k: v for k, v in fields.items() if k != "n_real"})
    return block_graph(arrays, int(fields["n_real"]), resolve_device(device))


def device_graph_from_numpy(fields: Mapping, device=None) -> DeviceGraph:
    """Port ``DeviceGraph`` from the JAX one's six fields; the uint32
    ``direct_nh_words`` become int32 bit patterns."""
    dev = resolve_device(device)
    planes = {k: np.array(fields[k]) for k in DeviceGraph._fields}  # writable copies
    planes["direct_nh_words"] = planes["direct_nh_words"].view(np.int32)
    return DeviceGraph(**{k: torch.from_numpy(v).to(dev) for k, v in planes.items()})


def _int32_planes(fields: Mapping, names, device) -> dict:
    """Writable int32 copies of ``fields[name]`` on ``device``; uint32 bit
    patterns (next-hop words) are reinterpreted, not converted."""
    dev = resolve_device(device)
    out = {}
    for k in names:
        x = np.array(fields[k])
        out[k] = torch.from_numpy(x.view(np.int32) if x.dtype == np.uint32 else
                                  x.astype(np.int32)).to(dev)
    return out


def spf_tensors_from_numpy(fields: Mapping, device=None) -> SpfTensors:
    """Port ``SpfTensors`` from the JAX one's four fields (one run or a
    batch); ``nexthops`` become int32 bit patterns."""
    return SpfTensors(**_int32_planes(fields, SpfTensors._fields, device))


def multipath_tensors_from_numpy(fields: Mapping, device=None) -> MultipathTensors:
    """Port ``MultipathTensors`` from the JAX one's five fields (one run or
    a batch)."""
    return MultipathTensors(**_int32_planes(fields, MultipathTensors._fields, device))


def frr_inputs_from_jax(fin) -> FrrInputs:
    """Port ``holo_tpu``'s ``FrrInputs`` (read by its fields): copies of its
    planes, counts and ``atom_link`` map."""
    fields = {f.name: getattr(fin, f.name) for f in dataclasses.fields(FrrInputs)}
    return FrrInputs(**{k: (np.array(v) if isinstance(v, np.ndarray) else copy.copy(v))
                        for k, v in fields.items()})


def backup_table_from_jax(table) -> BackupTable:
    """Port ``holo_tpu``'s ``BackupTable`` (read by its fields), its inputs
    included."""
    return BackupTable(
        inputs=frr_inputs_from_jax(table.inputs), root=int(table.root),
        **{f: np.array(getattr(table, f)) for f in TABLE_PLANES},
    )


def partition_from_numpy(plan_fields: Mapping, plane_fields: Mapping,
                         device=None) -> tuple[PartitionPlan, DeviceGraph]:
    """The port's (plan, stacked planes) of ``holo_tpu``'s ``PartitionPlan``
    fields and ``PartPlanes`` fields [P, L, K] (numpy arrays, lists and
    ints).  JAX keeps each part's rows in RCM order with its halo after
    them; the port keeps them in ascending vertex id, so every row moves to
    the port's row of its vertex (``gid``) and every slot's local source to
    the port's row of that vertex in the same part.  Slots keep their order;
    an invalid slot's source becomes its own row, its cost, edge id and
    words 0.  The ``uint32`` next-hop words become int32 bit patterns."""
    f = plan_fields
    as32 = lambda x: np.array(x, np.int32)  # noqa: E731
    plan = PartitionPlan(
        n_vertices=int(f["n_vertices"]), n_parts=int(f["n_parts"]), root=int(f["root"]),
        part_of=as32(f["part_of"]), verts=[np.sort(as32(v)) for v in f["verts"]],
        halo=[as32(h) for h in f["halo"]], skel=as32(f["skel"]), skel_pos=as32(f["skel_pos"]),
        bnd=[as32(b) for b in f["bnd"]], cut_src=as32(f["cut_src"]),
        cut_dst=as32(f["cut_dst"]), cut_cost=as32(f["cut_cost"]), cut_eid=as32(f["cut_eid"]),
        l_pad=int(f["l_pad"]), k_pad=int(f["k_pad"]), b_pad=int(f["b_pad"]),
        bnd_skel=[as32(b) for b in f["bnd_skel"]], halo_skel=[as32(h) for h in f["halo_skel"]],
    )
    stack_layout(plan)
    pl = {k: np.asarray(v) for k, v in plane_fields.items()}
    n, r, k = plan.n_vertices, plan.n_rows, pl["in_src"].shape[2]
    words = pl["direct_words"].view(np.int32)
    keys = plan.row_keys()
    out = {
        "in_src": np.repeat(np.arange(r, dtype=np.int32)[:, None], k, axis=1),
        "in_cost": np.zeros((r, k), np.int32),
        "in_valid": np.zeros((r, k), bool),
        "in_edge_id": np.zeros((r, k), np.int32),
        "direct_nh_words": np.zeros((r, k, words.shape[3]), np.int32),
        "is_router": np.zeros(r, bool),
    }
    for p in range(plan.n_parts):
        gid = pl["gid"][p]
        local = np.nonzero(gid < n)[0]
        rows = np.searchsorted(keys, p * n + gid[local].astype(np.int64))
        valid = pl["in_valid"][p, local]
        src = np.searchsorted(keys, p * n + gid[pl["in_src"][p, local]].astype(np.int64))
        out["in_src"][rows] = np.where(valid, src, rows[:, None])
        out["in_cost"][rows] = np.where(valid, pl["in_cost"][p, local], 0)
        out["in_valid"][rows] = valid
        out["in_edge_id"][rows] = np.where(valid, pl["in_edge_id"][p, local], 0)
        out["direct_nh_words"][rows] = np.where(valid[:, :, None], words[p, local], 0)
        out["is_router"][rows] = pl["is_router"][p, local]
    dev = resolve_device(device)
    return plan, DeviceGraph(**{name: torch.from_numpy(x).to(dev) for name, x in out.items()})


def _interner(values) -> _Interner:
    out = _Interner()
    for v in values:
        out.intern(v)
    return out


def bgp_table_from_numpy(planes, cap_rows: int, cap_cols: int, rows: Mapping,
                         cols: Mapping, fas, paths, nhs, poisoned, device=None) -> _DevTable:
    """The port's resident BGP table of one address family from a
    ``holo_tpu`` ``TpuBgpTableBackend``'s ``_DevTable``: its planes
    (``np.asarray(dt.planes)``), capacities, prefix rows and peer columns,
    the value lists of its three interners (first AS, AS path, next hop; ids
    are list positions) and its poisoned prefixes.  Scatter and grow counts
    start at 0."""
    x = np.array(planes, dtype=np.int32)
    if x.shape != (13, cap_rows, cap_cols):
        raise ValueError(f"planes {x.shape} are not (13, {cap_rows}, {cap_cols})")
    return _DevTable(
        planes=torch.from_numpy(x).to(resolve_device(device)), cap_rows=int(cap_rows),
        cap_cols=int(cap_cols), rows=dict(rows), cols=dict(cols), fas_ids=_interner(fas),
        path_ids=_interner(paths), nh_ids=_interner(nhs), poisoned=set(poisoned),
    )


def lsdb_from_wire(entries):
    """The port's OSPFv2 :class:`~holo_tpu_torch.protocols.ospf.lsdb.Lsdb`
    from ``(raw, installed_at)`` pairs: each LSA's wire image (``Lsa.raw``
    of either package) and the loop-clock time it was installed at, in
    install order.  Each image is decoded by the port's codec and installed
    at its time, so ages, bodies and the entries' order carry across."""
    lsdb = Lsdb()
    for raw, installed_at in entries:
        lsdb.install(Lsa.decode(Reader(bytes(raw))), float(installed_at))
    return lsdb
