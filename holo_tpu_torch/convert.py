"""Bring the JAX package's blocked-engine state across to the port.

The arguments are the fields of a ``holo_tpu`` ``BlockSpfGraph`` /
``BlockGraph`` as a mapping of numpy arrays and ints (``np.asarray`` of
each), so this module needs neither JAX nor ``holo_tpu``.  The tests use it
to run both packages on identical planes.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np

from holo_tpu_torch.device import resolve_device
from holo_tpu_torch.ops.blocked import BlockGraph, block_graph, edge_planes
from holo_tpu_torch.ops.blocked_spf import BlockSpfGraph, block_spf_graph


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
