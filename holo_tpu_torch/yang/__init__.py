"""YANG-lite substrate: schema registry, data trees, diffs (the port's copy
of ``holo_tpu.yang``: the same schema, and the same JSON, XML and LYB-lite
encodings, so one configuration drives either package's daemon).

The reference embeds 104 IETF YANG modules and drives everything through
libyang (holo-yang/src/lib.rs:20-26).  libyang is not available in this
environment, so this package provides a YANG-shaped schema system built in
Python: containers/lists/leaves with typed leaves, instance data trees
addressed by slash paths with list keys (``interfaces/interface[name=eth0]/
mtu``), validation, and structural diffs that drive the transaction engine.

Module definitions live in :mod:`holo_tpu_torch.yang.modules` and mirror the
paths of the IETF modules the reference implements (ietf-interfaces,
ietf-routing, ietf-ospf, …) so northbound clients see familiar addressing.
A YANG-text front-end parser can be layered on later without changing the
provider-facing API.
"""

from holo_tpu_torch.yang.schema import Container, Leaf, LeafList, List, Schema
from holo_tpu_torch.yang.data import DataTree, DiffOp, diff_trees

__all__ = [
    "Container",
    "Leaf",
    "LeafList",
    "List",
    "Schema",
    "DataTree",
    "DiffOp",
    "diff_trees",
]
