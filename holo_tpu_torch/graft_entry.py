"""Compile-check hook of the port: the flagship computation on a small LSDB.

The twin of the repo root's ``__graft_entry__.py`` ``entry()``: the batched
what-if SPF (distances, first parents, hops and ECMP next-hop words over
scenario edge masks) of ``holo_tpu_torch.ops.spf_engine`` on the same
24-router LSDB and the same 8 masks.  The multi-chip dry run waits for the
port's mesh.

    from holo_tpu_torch.graft_entry import entry
    fn, args = entry()  # on the card; entry(device="cpu") on the host
    out = fn(*args)  # SpfTensors, [8, N] planes
"""

from __future__ import annotations

import torch

from holo_tpu_torch.device import resolve_device
from holo_tpu_torch.ops.graph import build_ell
from holo_tpu_torch.ops.spf_engine import device_graph_from_ell, spf_whatif_batch
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
