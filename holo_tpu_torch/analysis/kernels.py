"""Kernel registry for the kernel-contract audit (HL3xx family), the port's
``holo_tpu/analysis/kernels.py``.

Every dispatch program that ``holo_tpu`` registers registers here too, at the
port's counterpart of its site, with ``register_kernel(...)``: a name, a
builder thunk that returns the program (a plain callable; ``builder(mesh)``
when ``needs_mesh``), a spec thunk ``specs(device)`` that returns the
program's arguments as concrete tensors on ``device``, made from fixed seeds
at ``holo_tpu``'s audit sizes, and the declared contracts: the donated
(moved in place) arguments, the mesh joins required, the dtype lanes, and
the static shape-bucket count the dispatch site can produce.

Torch has nothing to lower abstractly (the fixpoints read a changed flag a
round, which needs data), so the audit
(:mod:`holo_tpu_torch.analysis.kernel_audit`) runs each program once on its
specs.  Registration stays inert: this module imports nothing heavy (no
torch), and the thunks are never invoked at registration time, so importing
a registering module costs a dict write.
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple

__all__ = [
    "KernelSpec",
    "register_kernel",
    "registry",
    "clear_registry",
]

#: Default dtype lanes: every value a registered program makes must land in
#: one of these unless the registration widens the set.  The port carries
#: uint32 words as int32 bit patterns; int64 index lanes are classified by
#: the audit (:mod:`holo_tpu_torch.analysis.kernel_audit`).
DEFAULT_DTYPES: Tuple[str, ...] = ("int32", "uint32", "bool")

#: Default compile-signature budget: a dispatch seam may produce at most this
#: many distinct shape buckets before HL304 flags it.
DEFAULT_BUCKET_BUDGET = 64


@dataclass(frozen=True)
class KernelSpec:
    """One registered dispatch program and its declared contracts.

    ``builder`` returns the program (``builder()`` normally,
    ``builder(mesh)`` when ``needs_mesh``); ``specs(device)`` returns the
    tuple of its arguments on ``device``.  Both are thunks so that
    registration never allocates a tensor or builds a kernel.
    """

    name: str
    builder: Callable
    specs: Callable[..., tuple]
    donate: Tuple[int, ...] = ()
    fences: int = 0
    dtypes: Tuple[str, ...] = DEFAULT_DTYPES
    buckets: Optional[int] = None
    budget: int = DEFAULT_BUCKET_BUDGET
    needs_mesh: bool = False
    module: str = field(default="", compare=False)
    line: int = field(default=0, compare=False)


_REGISTRY: Dict[str, KernelSpec] = {}


def _caller_site(depth: int) -> Tuple[str, int]:
    """Repo-relative path and line of the registration call site."""
    try:
        frame = sys._getframe(depth)
    except ValueError:  # pragma: no cover - interpreter without frame depth
        return "", 0
    path = frame.f_code.co_filename
    line = frame.f_lineno
    # Repo-relative, so findings anchor at a file of the checkout.
    probe = os.path.dirname(os.path.abspath(path))
    root = ""
    for _ in range(12):
        if os.path.isdir(os.path.join(probe, "holo_tpu_torch")):
            root = probe
            break
        parent = os.path.dirname(probe)
        if parent == probe:
            break
        probe = parent
    if root:
        try:
            path = os.path.relpath(os.path.abspath(path), root)
        except ValueError:  # pragma: no cover - cross-drive on windows
            pass
    return path.replace(os.sep, "/"), line


def register_kernel(
    name: str,
    builder: Optional[Callable] = None,
    *,
    specs: Callable[..., tuple],
    donate: Tuple[int, ...] = (),
    fences: int = 0,
    dtypes: Tuple[str, ...] = DEFAULT_DTYPES,
    buckets: Optional[int] = None,
    budget: int = DEFAULT_BUCKET_BUDGET,
    needs_mesh: bool = False,
):
    """Register a dispatch program for the kernel-contract audit.

    Usable as a plain call (``register_kernel("spf.one", builder=..., ...)``)
    or as a decorator when ``builder`` is omitted.  Re-registration under the
    same name overwrites the previous entry, so repeated module imports are
    idempotent.  No thunk is invoked until the audit runs.
    """

    def _record(fn: Callable) -> Callable:
        # Plain call: user -> register_kernel -> _record -> _caller_site (depth 3).
        # Decorator: user applies the returned _record directly (depth 2).
        module, line = _caller_site(2 if builder is None else 3)
        _REGISTRY[name] = KernelSpec(
            name=name,
            builder=fn,
            specs=specs,
            donate=tuple(donate),
            fences=fences,
            dtypes=tuple(dtypes),
            buckets=buckets,
            budget=budget,
            needs_mesh=needs_mesh,
            module=module,
            line=line,
        )
        return fn

    if builder is None:
        return _record
    return _record(builder)


def registry() -> Dict[str, KernelSpec]:
    """Snapshot of the currently registered programs, keyed by name."""
    return dict(_REGISTRY)


def clear_registry() -> None:
    """Drop all registrations (test isolation helper)."""
    _REGISTRY.clear()
