"""Northbound framework: providers, callbacks, 3-phase transactions (the
port's copy of ``holo_tpu.northbound``; its ``[database]`` file is
``holo_tpu``'s format).

Reference: holo-northbound (configuration.rs 3-phase commit, state.rs
operational walks, rpc.rs) + holo-daemon/src/northbound/core.rs
(transaction engine, rollback, confirmed commit).
"""

from holo_tpu_torch.northbound.core import Northbound, Transaction
from holo_tpu_torch.northbound.provider import CommitPhase, Provider

__all__ = ["Northbound", "Transaction", "CommitPhase", "Provider"]
