"""OSPFv2 (RFC 2328) — link-state IGP with the SPF hot path on a pluggable
backend (scalar CPU default, :class:`~holo_tpu_torch.spf.backend.TorchSpfBackend`
on the card opt-in).  The port's copy of ``holo_tpu.protocols.ospf``, the
modules on the path from LSA to FIB: packet, lsdb, interface, neighbor,
spf_run, instance, and nb_state's state-name tables.

Reference crate: holo-ospf (SURVEY.md §2.3).  This implementation follows
the same anatomy — packet codecs (packet.py), LSDB (lsdb.py), interface ISM
(interface.py), neighbor NSM (neighbor.py), SPF delay FSM + route calc (spf_run.py), instance actor (instance.py) — but is
structured for the deterministic event loop and tensor SPF backend.

Round-1 scope: OSPFv2 single/multi-area, p2p + broadcast interfaces,
null auth, intra-area + inter-area routes; NSSA/virtual-link/GR/SR later.
"""
