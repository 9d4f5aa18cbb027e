"""Bring the JAX package's engine state across to the port.

The arguments are the fields of a ``holo_tpu`` ``BlockSpfGraph`` /
``BlockGraph`` / ``DeviceGraph`` as a mapping of numpy arrays and ints
(``np.asarray`` of each), so this module needs neither JAX nor
``holo_tpu``.  The tests use it to run both packages on identical planes.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from holo_tpu_torch.device import resolve_device
from holo_tpu_torch.ops.blocked import BlockGraph, block_graph, edge_planes
from holo_tpu_torch.ops.blocked_spf import BlockSpfGraph, block_spf_graph
from holo_tpu_torch.ops.spf_engine import DeviceGraph


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
