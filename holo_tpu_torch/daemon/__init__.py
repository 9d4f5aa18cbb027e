"""Daemon core: process assembly, static config, gRPC northbound (the
port's copy of ``holo_tpu.daemon``, run by ``holod_torch.py``).

Reference: holo-daemon (SURVEY.md §2.1, §3.1) — entry point, TOML static
config, provider startup order, northbound transaction engine, gRPC
service.  Privilege handling and netlink programming are gated behind the
kernel interface (mock by default; Linux netlink when running as root).
Of the routing protocols only OSPFv2 is ported: the configuration of any
other fails the commit with the ROADMAP item that ports it.
"""
