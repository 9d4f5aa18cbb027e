"""Global RIB manager + southbound programming (reference: holo-routing;
the port's copy of ``holo_tpu.routing``'s RIB).

SURVEY.md §2.2: multi-protocol RIB with admin-distance best-route
selection, redistribution pub/sub, next-hop tracking, MPLS LIB, and kernel
FIB programming (netlink on Linux, mock kernel under test).
"""

from holo_tpu_torch.routing.rib import RibManager

__all__ = ["RibManager"]
