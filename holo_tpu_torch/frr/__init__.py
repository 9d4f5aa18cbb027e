"""IP Fast Reroute (FRR): precomputed per-link backup next hops.

The port's counterpart of ``holo_tpu.frr`` (without its mesh-sharded
dispatch).  After every primary SPF the protocol layer hands its Topology
to an :class:`~holo_tpu_torch.frr.manager.FrrEngine`, which computes on the
card

1. the all-roots distance matrix (one SPF lane from every vertex),
2. per protected link, the post-convergence SPF (the what-if batch with the
   link's edges masked), and
3. the RFC 5286 LFA inequalities, the RFC 7490 remote-LFA P/Q-space
   intersection and the TI-LFA P/Q repair-segment selection over those
   distance planes.

The output is a :class:`~holo_tpu_torch.frr.kernel.BackupTable`: for every
(protected link, destination vertex) the chosen loop-free alternate, as
int32 tables bit-identical to the scalar oracle
(:mod:`holo_tpu_torch.frr.scalar`) and to ``holo_tpu``'s.
"""

from holo_tpu_torch.frr.inputs import FrrInputs, marshal_frr
from holo_tpu_torch.frr.kernel import BackupTable
from holo_tpu_torch.frr.manager import (
    BackupEntry,
    FrrConfig,
    FrrEngine,
    repair_map,
    resolve_backup,
)

__all__ = [
    "BackupEntry",
    "BackupTable",
    "FrrConfig",
    "FrrEngine",
    "FrrInputs",
    "marshal_frr",
    "repair_map",
    "resolve_backup",
]
