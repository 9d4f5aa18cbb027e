"""The port's runtime checks (``holo_tpu.analysis.runtime`` on torch): the
transfer sanitizer and the donation guard.

**The transfer sanitizer** runs on ``torch.cuda.set_sync_debug_mode``:
armed (:func:`transfer_sanitizer`), every synchronizing CUDA call that
PyTorch makes (``.item()``, ``bool(t)``, ``.cpu()``, ``nonzero``, a copy from
pageable host memory) raises outside a window.  :func:`sanctioned_transfer`
opens a window and counts it by reason (:func:`sanctioned_counts`); the
port's own host syncs each open one with a reason of their own: every
per-round flag read of the fixpoints, the readbacks, the marshal uploads and
``HostCopy``'s wait.  So ``sanctioned_counts()`` counts the host syncs of a
dispatch site by site.

The sync debug mode is process-wide, not per thread.  One depth count under
a lock keeps it right across threads: the mode is "error" only while the
sanitizer is armed and no window is open on any thread.  So while one
thread is in a window, another thread's unsanctioned sync goes unseen; the
pipeline's worker and its caller are covered one at a time.  The sanitizer
cannot see syncs inside the ctypes kernel libraries (a ``cudaMemcpy`` or
``cudaStreamSynchronize`` there is not PyTorch's); none of their ``holo_*``
entry points (``csrc/*.cu``) makes one: the launches are asynchronous, and
the ``*_info`` / ``*_smem`` geometry queries read function attributes and
occupancy into a host buffer.  On the CPU there are no syncs to catch, and
the windows only count.  Armed or not, each window also raises a per-thread
depth (:func:`window_depth`) while it is open: the kernel-contract audit
(:mod:`holo_tpu_torch.analysis.kernel_audit`) reads it to tell the port's
own sanctioned syncs from a stray scalar read, on the CPU as on the card.

**The donation guard.**  Torch does not donate buffers, but the port updates
resident tensors in place: the delta scatter into a cached graph, the tile
deltas, the partitioned resident's delta re-solve and the BGP table's row
scatters.  "Donated" means here: moved in place, under a reader that may
hold them for another generation.  The guard rests on each tensor's version
counter, which every in-place torch op bumps; a seam that writes through a
raw pointer (a hand-written kernel) bumps it itself (``raw=True``).  Armed
(:func:`donation_guard`):

- :func:`note_donated` at an in-place seam stamps the moved tensors with the
  seam's reason and the generation they now hold;
- a dispatch takes a :func:`lease` on the residents it reads, with the
  generation it asks for, and :func:`assert_live` at its finish raises
  :class:`DonatedBufferError` when a leased tensor's version moved since the
  lease, or a leased tensor holds another generation, naming the seam.

Disarmed, each of these costs one global check.  ``HOLO_TPU_TORCH_DONATION_
GUARD=1`` arms the guard for a whole process, ``HOLO_TPU_TORCH_TRANSFER_
SANITIZER=1`` is read by :func:`sanitizer_enabled_by_env`.
"""

from __future__ import annotations

import contextlib
import os
import threading

# -- the transfer sanitizer

_SANCTIONED: dict[str, int] = {}
_MODE_LOCK = threading.Lock()
_ARMED = 0  # nesting depth of transfer_sanitizer()
_OPEN = 0  # sanctioned windows open on any thread while armed
_LOCAL = threading.local()  # .depth: sanctioned windows open on this thread
# What an armed sanitizer sets outside windows: "error" raises; "warn" lets
# a survey run list every unsanctioned sync site in one pass.
ARMED_MODE = "error"


def _set_mode(mode: str) -> None:
    """The process-wide CUDA sync debug mode (nothing where there is no
    card: the CPU has no syncs to catch)."""
    import torch

    if torch.cuda.is_available():
        torch.cuda.set_sync_debug_mode(mode)


def _apply_locked() -> None:
    _set_mode(ARMED_MODE if _ARMED and not _OPEN else "default")


@contextlib.contextmanager
def transfer_sanitizer():
    """Disallow host syncs outside :func:`sanctioned_transfer` windows for
    the enclosed block (nests; the outermost exit restores the default)."""
    global _ARMED
    with _MODE_LOCK:
        _ARMED += 1
        _apply_locked()
    try:
        yield
    finally:
        with _MODE_LOCK:
            _ARMED -= 1
            _apply_locked()


def window_depth() -> int:
    """How many sanctioned windows are open on the calling thread, armed or
    not."""
    return getattr(_LOCAL, "depth", 0)


@contextlib.contextmanager
def sanctioned_transfer(reason: str):
    """Open an allow-window for one of the port's own host syncs and count
    it under ``reason``."""
    global _OPEN
    if not _ARMED:
        _SANCTIONED[reason] = _SANCTIONED.get(reason, 0) + 1
        _LOCAL.depth = window_depth() + 1
        try:
            yield
        finally:
            _LOCAL.depth -= 1
        return
    with _MODE_LOCK:
        _SANCTIONED[reason] = _SANCTIONED.get(reason, 0) + 1
        _OPEN += 1
        _apply_locked()
    _LOCAL.depth = window_depth() + 1
    try:
        yield
    finally:
        _LOCAL.depth -= 1
        with _MODE_LOCK:
            _OPEN -= 1
            _apply_locked()


def read_flag(reason: str, flag) -> bool:
    """``bool(flag)`` in a sanctioned window of its own: a fixpoint's
    per-round changed-flag read, counted under ``reason``.  Disarmed it is a
    count, the read, and the window's depth around it."""
    if not _ARMED:
        _SANCTIONED[reason] = _SANCTIONED.get(reason, 0) + 1
        _LOCAL.depth = window_depth() + 1
        try:
            return bool(flag)
        finally:
            _LOCAL.depth -= 1
    with sanctioned_transfer(reason):
        return bool(flag)


def sanctioned_counts() -> dict[str, int]:
    """How many times each sanctioned window opened in the process."""
    return dict(_SANCTIONED)


def sanitizer_state() -> dict:
    """The window bookkeeping: nesting depth and open windows."""
    with _MODE_LOCK:
        return {"armed": _ARMED, "open": _OPEN}


def sanitizer_enabled_by_env() -> bool:
    """Opt-in knob for ad-hoc runs: HOLO_TPU_TORCH_TRANSFER_SANITIZER=1."""
    return os.environ.get("HOLO_TPU_TORCH_TRANSFER_SANITIZER", "") not in ("", "0", "false")


# -- the donation guard

_DONATION_ARMED = False
# Each arming from disarmed starts an epoch: stamps of an earlier armed
# period (deltas that ran disarmed in between left no stamp) are ignored.
_EPOCH = 0
_DONATED_COUNTS: dict[str, int] = {}
_CONSUME_COUNTS: dict[str, int] = {}


class DonatedBufferError(RuntimeError):
    """A dispatch read a resident that was moved in place under it."""


def _leaves(value) -> list:
    """The tensor leaves of nested tuples/lists/NamedTuples and dicts."""
    if value is None:
        return []
    if isinstance(value, dict):
        value = tuple(value.values())
    if isinstance(value, (tuple, list)):
        out = []
        for v in value:
            out.extend(_leaves(v))
        return out
    return [value] if hasattr(value, "_version") else []


def note_donated(reason: str, *values, generation=None, raw: bool = False) -> None:
    """An in-place seam moved ``values``' tensors to ``generation``.  Armed:
    count the reason, bump the version counter where the write went through
    a raw pointer (``raw``), and stamp each tensor with (reason,
    generation).  Disarmed: one global check."""
    if not _DONATION_ARMED:
        return
    _DONATED_COUNTS[reason] = _DONATED_COUNTS.get(reason, 0) + 1
    if raw:
        import torch

        torch.autograd.graph.increment_version(_leaves(values))
    for t in _leaves(values):
        t._holo_donation = (_EPOCH, reason, generation)


class Lease:
    """A dispatch's hold on the residents it reads: each tensor's version at
    the lease, and the generation the dispatch asked for."""

    __slots__ = ("pairs", "generation", "epoch")

    def __init__(self, pairs, generation, epoch):
        self.pairs = pairs
        self.generation = generation
        self.epoch = epoch


def lease(*values, generation=None) -> Lease | None:
    """Armed: a :class:`Lease` on ``values``' tensors for ``generation``.
    Disarmed: None (one global check)."""
    if not _DONATION_ARMED:
        return None
    return Lease([(t, t._version) for t in _leaves(values)], generation, _EPOCH)


def assert_live(reason: str, *leases) -> None:
    """The finish seam of a dispatch: raise :class:`DonatedBufferError` when
    a leased tensor was moved in place since its lease, or holds another
    generation than the lease's.  ``reason`` names the seam; the error names
    the in-place seam that moved the tensor.  Disarmed (or a None lease):
    nothing."""
    if not _DONATION_ARMED:
        return
    for ls in leases:
        if not isinstance(ls, Lease):
            continue
        for t, version in ls.pairs:
            stamp = getattr(t, "_holo_donation", None)
            mover = stamp[1] if stamp is not None and stamp[0] == ls.epoch else "an in-place op"
            if t._version != version:
                raise DonatedBufferError(
                    f"{reason}: a resident the dispatch reads was moved in place by {mover} "
                    "since its launch (use-after-donate)")
            if (stamp is not None and stamp[0] == ls.epoch and ls.generation is not None
                    and stamp[2] is not None and stamp[2] != ls.generation):
                raise DonatedBufferError(
                    f"{reason}: a resident the dispatch reads holds another generation, "
                    f"moved there by {mover} (use-after-donate)")


@contextlib.contextmanager
def consumes_donated(reason: str):
    """Mark a legitimate hand-over seam of in-place-updated state (a fresh
    run taking a consumed seed's place, the pipeline's per-key handoff); the
    per-reason count lets tests pin that the seam ran."""
    _CONSUME_COUNTS[reason] = _CONSUME_COUNTS.get(reason, 0) + 1
    yield


@contextlib.contextmanager
def donation_guard():
    """Arm the donation guard for the enclosed block (nests; restores)."""
    global _DONATION_ARMED, _EPOCH
    prev = _DONATION_ARMED
    if not prev:
        _EPOCH += 1
    _DONATION_ARMED = True
    try:
        yield
    finally:
        _DONATION_ARMED = prev


def donation_guard_armed() -> bool:
    return _DONATION_ARMED


def donated_counts() -> dict[str, int]:
    """Per-reason count of in-place seams stamped while armed."""
    return dict(_DONATED_COUNTS)


def consumed_counts() -> dict[str, int]:
    """Per-reason count of consumes_donated window entries."""
    return dict(_CONSUME_COUNTS)


def donation_guard_enabled_by_env() -> bool:
    """Opt-in knob for ad-hoc runs: HOLO_TPU_TORCH_DONATION_GUARD=1."""
    return os.environ.get("HOLO_TPU_TORCH_DONATION_GUARD", "") not in ("", "0", "false")


if donation_guard_enabled_by_env():
    _EPOCH += 1
    _DONATION_ARMED = True
