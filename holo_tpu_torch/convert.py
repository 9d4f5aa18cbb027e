"""Bring the JAX package's engine state across to the port.

The arguments are the fields of a ``holo_tpu`` ``BlockSpfGraph`` /
``BlockGraph`` / ``DeviceGraph`` / ``SpfTensors`` / ``MultipathTensors`` as
a mapping of numpy arrays and ints (``np.asarray`` of each), so this module
needs neither JAX nor ``holo_tpu``.  The tests use it to run both packages
on identical planes, and to seed both packages' incremental paths with the
same previous run.  ``frr_inputs_from_jax`` and ``backup_table_from_jax``
carry ``holo_tpu``'s FRR values across, read by their fields.
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
from holo_tpu_torch.ops.blocked import BlockGraph, block_graph, edge_planes
from holo_tpu_torch.ops.blocked_spf import BlockSpfGraph, block_spf_graph
from holo_tpu_torch.ops.spf_engine import DeviceGraph, MultipathTensors, SpfTensors


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
