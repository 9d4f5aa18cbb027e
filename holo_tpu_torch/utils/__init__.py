"""Shared kernel: runtime, codecs, IP types, ibus, southbound messages
(the port's copies of ``holo_tpu.utils``' modules on the OSPFv2 path).

Scope parallels the reference's `holo-utils` crate (SURVEY.md §2.1): the
actor runtime with timers (holo-utils/src/task.rs), network byte codecs
(holo-utils/src/bytes.rs), the in-process ibus pub/sub bus
(holo-utils/src/ibus.rs), and southbound route/interface messages
(holo-utils/src/southbound.rs) — re-designed around a deterministic
single-threaded event loop with a virtual clock so the golden-file test
harness gets reproducible scheduling by construction (the reference bolts
this on via `testing`/`deterministic` cargo features).
"""
