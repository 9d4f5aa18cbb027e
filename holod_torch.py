#!/usr/bin/env python3
"""Run the routing daemon of the PyTorch/CUDA port.

    python3 holod_torch.py -f holod.toml [--device cuda|cpu]

This is :func:`holo_tpu_torch.daemon.daemon.main`: the port's own daemon
(YANG data model, northbound transactions, providers, OSPFv2 instances and
RIB, gRPC northbound), with ``spf-control/backend tpu`` and
``fast-reroute/engine tpu`` on the port's ``TorchSpfBackend`` and
``FrrEngine("torch")``.  It imports neither ``jax`` nor ``holo_tpu``.

``--device`` defaults to ``cuda``: with no card the daemon refuses to start
(there is no quiet CPU run); ``--device cpu`` runs the port's plain PyTorch
versions of the kernels on the host.  Where the ``grpc`` package is missing
the gRPC northbound is not served, and the daemon takes its configuration
from ``[database]``: the transaction log another daemon (either package's)
wrote, whose last configuration a ``rollback`` to its id restores.
"""

from holo_tpu_torch.daemon.daemon import main

if __name__ == "__main__":
    main()
