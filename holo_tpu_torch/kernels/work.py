"""Work tallies of the kernel wrappers: the port's cost source.

``holo_tpu`` reads XLA's compile-time ``cost_analysis()`` (FLOPs and bytes
accessed) on a fresh shape bucket; the port has no compiler, so each kernel
wrapper (:mod:`~holo_tpu_torch.kernels.ell`,
:mod:`~holo_tpu_torch.kernels.tropical`, :mod:`~holo_tpu_torch.kernels.blocked`,
:mod:`~holo_tpu_torch.kernels.bgp`) counts the work each call was asked for,
beside its ``launches`` counter:

- **bytes**: each input tensor read once and each output written once, from
  the shapes and dtypes of the tensors the call was given (outputs the
  wrapper allocates are counted from the shapes it would allocate);
- **ops**: int32 operations per element of those shapes, as ``PERF.md``
  section 3 defines them for the kernel's bound, with every slot, pair and
  lane of the shape counted (a frontier, a repair set or a DAG is data, and
  the tally reads no data).

A tally is taken at the top of the wrapper, before it chooses between the
CPU's plain version and the card's kernel, so both count the same work: it
is a count of the function, not of its implementation, and depends on no
timing, no skip decision of the kernel and no iteration cap (a dispatch
capped by ``max_iters`` makes fewer calls; each call counts the same).

Tallies are per thread: the dispatch pipeline's worker never counts a
caller's launches.  Counting is off by default (:func:`set_counting`); the
profiling module turns it on while device profiling or a stage observer is
armed, and a disarmed wrapper pays one module-global check.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager

#: whether the wrappers tally (read as ``work.COUNTING``: the one check a
#: disarmed wrapper pays); set with :func:`set_counting`
COUNTING = False
_local = threading.local()


def set_counting(on: bool) -> None:
    """Turn the wrappers' tallies on or off (process-wide)."""
    global COUNTING
    COUNTING = bool(on)


@contextmanager
def counted():
    """Count within the block (tests), restoring the previous setting."""
    was = COUNTING
    set_counting(True)
    try:
        yield
    finally:
        set_counting(was)


def _table() -> dict:
    t = getattr(_local, "table", None)
    if t is None:
        t = _local.table = {}
    return t


def note(name: str, ops: int, nbytes: int) -> None:
    """Add one call of wrapper ``name`` to this thread's tally."""
    t = _table()
    row = t.get(name)
    if row is None:
        t[name] = [1, int(ops), int(nbytes)]
    else:
        row[0] += 1
        row[1] += int(ops)
        row[2] += int(nbytes)


def totals() -> tuple[int, int]:
    """(ops, bytes) this thread's wrappers have counted so far."""
    ops = nb = 0
    for _calls, o, b in _table().values():
        ops += o
        nb += b
    return ops, nb


def tallies() -> dict:
    """{wrapper: (calls, ops, bytes)} of this thread."""
    return {k: tuple(v) for k, v in _table().items()}


def reset() -> None:
    """Clear this thread's tally."""
    _table().clear()


def nbytes(*tensors) -> int:
    """Bytes of the given tensors (None skipped), each counted once per
    argument."""
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)
