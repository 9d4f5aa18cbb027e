"""Compile-check hook and mesh dry run of the port.

The twins of the repo root's ``__graft_entry__.py``:

- ``entry()``: the batched what-if SPF (distances, first parents, hops and
  ECMP next-hop words over scenario edge masks) of
  ``holo_tpu_torch.ops.spf_engine`` on the same 24-router LSDB and the same 8
  masks;
- ``dryrun_multichip(n_devices)``: the (batch, node) dispatch mesh installed
  over ``n_devices`` virtual devices of one device (the card, or the CPU) and
  one what-if batch through the real ``TorchSpfBackend`` dispatch on a
  2,000-router LSDB, checked against the scalar oracle.  The batch axis
  splits the scenarios; the node axis pads the resident's rows and splits
  nothing (ROADMAP A12b), so this is no multi-card run.

    from holo_tpu_torch.graft_entry import dryrun_multichip, entry
    fn, args = entry()  # on the card; entry(device="cpu") on the host
    out = fn(*args)  # SpfTensors, [8, N] planes
    dryrun_multichip(4)  # dryrun_multichip(4, device="cpu") on the host
"""

from __future__ import annotations

import numpy as np
import torch

from holo_tpu_torch.device import resolve_device
from holo_tpu_torch.ops.graph import build_ell
from holo_tpu_torch.ops.spf_engine import device_graph_from_ell, spf_whatif_batch
from holo_tpu_torch.parallel.mesh import (
    configure_process_mesh,
    reset_process_mesh,
    virtual_devices,
)
from holo_tpu_torch.spf.synth import random_ospf_topology, whatif_link_failure_masks


def _small_problem(n_routers=24, n_networks=8, n_scenarios=8, seed=3, extra_p2p=40,
                   device=None):
    """(topology, device graph, bool [n_scenarios, E] masks)."""
    topo = random_ospf_topology(
        n_routers=n_routers, n_networks=n_networks, extra_p2p=extra_p2p, seed=seed
    )
    masks = whatif_link_failure_masks(topo, n_scenarios=n_scenarios, seed=4)
    g = device_graph_from_ell(build_ell(topo), resolve_device(device))
    return topo, g, masks


def entry(device=None):
    """(fn, example_args): ``fn(*example_args)`` runs the what-if batch on
    the card (on the host with ``device="cpu"``) and returns its
    SpfTensors."""
    topo, g, masks = _small_problem(device=device)

    def forward(graph, root, edge_masks):
        return spf_whatif_batch(graph, root, edge_masks)

    return forward, (g, int(topo.root), torch.as_tensor(masks, device=g.in_src.device))


def dryrun_multichip(n_devices: int, device=None) -> str:
    """One what-if batch through the mesh dispatch, checked; returns (and
    prints) what ran.

    Installs the process mesh over ``virtual_devices(n_devices, device)``
    (the card unless ``device="cpu"``), with ``n_node = 2`` when
    ``n_devices`` is even, and runs ``n_batch * max(2, ceil(8 / n_batch))``
    scenarios on a 2,000-router, 400-network, 4,000-extra-p2p LSDB through
    ``TorchSpfBackend().compute_whatif``.  Asserts that the mesh served the
    batch (``shard_dispatches["whatif"]``) and that scenario 1 equals
    ``ScalarSpfBackend`` in ``dist`` and ``nexthop_words``; the mesh is
    reset whatever happens."""
    from holo_tpu_torch.spf.backend import ScalarSpfBackend, TorchSpfBackend

    n_node = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    n_batch = n_devices // n_node
    devices = virtual_devices(n_devices, device)
    mesh = configure_process_mesh(n_batch, n_node, devices)
    n_scenarios = n_batch * max(2, -(-8 // n_batch))
    topo, _g, masks = _small_problem(n_routers=2000, n_networks=400, n_scenarios=n_scenarios,
                                     extra_p2p=4000, device="cpu")
    try:
        be = TorchSpfBackend(device=devices[0])
        out = be.compute_whatif(topo, masks)
        sharded = be.shard_dispatches["whatif"]
        assert sharded == 1, "the batch must dispatch through the mesh"
        ref = ScalarSpfBackend().compute(topo, masks[1])
        np.testing.assert_array_equal(ref.dist, out[1].dist)
        np.testing.assert_array_equal(ref.nexthop_words, out[1].nexthop_words)
    finally:
        reset_process_mesh()
    text = (f"mesh dry run OK: a virtual mesh {mesh.shape} over {n_devices} entries of one "
            f"device ({devices[0]}); {n_scenarios}-scenario what-if SPF on a "
            f"{topo.n_vertices}-vertex LSDB through TorchSpfBackend's mesh dispatch (shard "
            f"dispatches: {sharded}): the batch axis split the scenarios, the node axis padded "
            f"the resident's rows to a multiple of {n_node} and split nothing (rows over node "
            "devices wait for ROADMAP A12b); scenario 1 bit-identical to the scalar oracle")
    print(text)
    return text
