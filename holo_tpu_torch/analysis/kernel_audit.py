"""The kernel-contract audit (HL3xx family), the port's counterpart of
``holo_tpu/analysis/jaxpr_audit.py``.

``holo_tpu`` lowers every registered kernel abstractly and reads the
contracts off the IR.  Torch has nothing to lower: every fixpoint of the
port reads a changed flag a round (:func:`~holo_tpu_torch.analysis.runtime.
read_flag`), which needs data (``bool(t)`` raises under ``FakeTensorMode``,
``.item()`` on the meta device).  So this audit runs every program registered
in :mod:`holo_tpu_torch.analysis.kernels` **once, concretely**, on its small
seeded specs, under a ``TorchDispatchMode`` recorder that sees every aten op
the program dispatches with its inputs and outputs, and checks:

* **HL301** donation-not-realized: every leaf of a declared donated argument
  must be moved in place: the argument's version counters rose (something
  was written in place), and the program returned a tensor that shares the
  leaf's storage (``untyped_storage().data_ptr()``).  A program that
  returns nothing is judged by the version counters alone.
* **HL302** host-leak-in-kernel, outside a sanctioned window of
  :mod:`holo_tpu_torch.analysis.runtime` (:func:`~holo_tpu_torch.analysis.
  runtime.window_depth` on the calling thread):

  - a scalar read: ``aten._local_scalar_dense`` (``.item()``, ``int(t)``,
    ``bool(t)``), ``aten.item``, ``aten.is_nonzero``, ``aten.equal``;
  - an op whose output shape depends on the data: ``nonzero``,
    ``masked_select``, ``argwhere``, the ``unique`` family,
    ``repeat_interleave`` with tensor repeats and no ``output_size``, and
    indexing (``index``, ``index_put_``) with a boolean mask;
  - host data entering the program: a tensor made from host data
    (``aten.lift_fresh``: ``torch.tensor``, ``as_tensor``, ``from_numpy``)
    moved by ``Tensor.to(device)`` or ``.cuda()``, ``torch.tensor`` /
    ``as_tensor`` of host data given a ``device``, and a host scalar written
    through tensor indices (``x[idx] = 0``: ``index_put_`` of a fresh 0-dim
    tensor); each is a synchronous copy on the card.  A 0-dim host tensor
    used as an operand is a scalar and does not fire;
  - a readback: ``Tensor.cpu``, ``.tolist``, ``.numpy`` (and so
    ``np.asarray(t)``).  These and the uploads dispatch no aten op on the
    CPU, so the tensor methods are watched for the run;
  - on the card, every sync that the transfer sanitizer (armed at
    ``"error"`` for the run) raises on.

* **HL303** dtype-widening.  Every output tensor of every op is a lane:

  - a float or complex output is a widened lane;
  - an int64 output is an *index lane* when the op is a cast
    (``_to_copy``: ``.long()``, ``.to(torch.int64)``), an op whose int64
    output is an index by definition (``argmax``, ``sort``'s and ``max.dim``'s
    indices, ``arange``, ...), a factory with no tensor input, or an op whose
    value inputs are all int64 (index arithmetic on int64 indices; a bool
    input beside them, a condition or a mask, does not count).  Torch's
    ``gather`` and ``index_select`` need int64 indices.  Any other int64
    output was made by implicit promotion from an int32 or bool tensor
    (``sum``, ``cumsum``, mixed int32 / int64 arithmetic) and is a widened
    lane;
  - integer lanes narrower than 32 bits do not widen.

  A widened lane fires unless its dtype is among the registration's
  ``dtypes``.
* **HL304** compile-signature budget: metadata, checked before anything
  runs: no ``buckets`` bound, or more than ``budget``.
* **HL305** fence-realized: a per-mesh program must join its batch shards
  (:func:`~holo_tpu_torch.parallel.mesh.gather_batch`, the twin of
  ``constrain_batch``) at least ``fences`` times on the calling thread, on
  the audit's two-device mesh (``make_spf_mesh(2, 1, devices=
  virtual_devices(2, device))``).  Without a mesh such programs are skipped
  with a note.

The specs are built before the recorder opens, from fixed seeds that
:func:`audit_kernel` sets itself, so the run makes no host transfer outside
the program under audit.  Findings are :class:`~holo_tpu_torch.analysis.core.
Finding` rows anchored at the ``register_kernel`` call site, so the
``# holo-lint: disable=`` comments work as in ``holo_tpu``.  Torch is imported
inside the functions: the cached replay (:mod:`holo_tpu_torch.analysis.cache`)
needs :class:`AuditResult` without it.
"""

from __future__ import annotations

import os
import time
from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

from holo_tpu_torch.analysis.core import Finding, parse_suppressions
from holo_tpu_torch.analysis.kernels import KernelSpec, registry

__all__ = [
    "AuditResult",
    "SEAM_MODULES",
    "apply_suppressions",
    "audit_entries",
    "audit_kernel",
    "audit_mesh",
    "load_registry",
    "record",
    "run_audit",
    "spec_signature",
]

#: Modules that register dispatch programs; importing them populates the
#: registry.  The audit cache hashes this file, so editing the list
#: invalidates cached results.
SEAM_MODULES: Tuple[str, ...] = (
    "holo_tpu_torch.ops.spf_engine",
    "holo_tpu_torch.ops.tropical",
    "holo_tpu_torch.ops.partition",
    "holo_tpu_torch.ops.bgp_table",
    "holo_tpu_torch.parallel.mesh",
    "holo_tpu_torch.spf.backend",
    "holo_tpu_torch.frr.manager",
)

#: Aten ops that read a scalar back to the host.
SCALAR_READS = frozenset({"_local_scalar_dense", "item", "is_nonzero", "equal"})

#: Aten ops whose output shape depends on the data.
DATA_SHAPED = frozenset({
    "nonzero", "nonzero_numpy", "argwhere", "masked_select", "unique", "_unique",
    "_unique2", "unique_dim", "unique_consecutive", "unique_dim_consecutive",
})

#: Aten ops that index with a list of tensors (a bool one is data-shaped).
MASK_INDEXED = frozenset({"index", "index_put", "index_put_", "_index_put_impl_"})

#: Tensor methods that read back to the host without an aten op.
HOST_READS = ("cpu", "tolist", "numpy")

#: Casts: an int64 output is an index lane asked for explicitly.
CAST_OPS = frozenset({"_to_copy", "to", "_to_dtype", "lift_fresh", "lift_fresh_copy"})

#: Ops whose int64 outputs are indices by definition.
INDEX_OPS = frozenset({
    "argmax", "argmin", "argsort", "sort", "topk", "kthvalue", "max", "min", "mode",
    "median", "nanmedian", "cummax", "cummin", "searchsorted", "bucketize", "arange",
    "nonzero", "nonzero_numpy", "argwhere", "unique", "_unique", "_unique2",
    "unique_dim", "unique_consecutive", "unique_dim_consecutive", "randperm",
})

_NARROW = ("int32", "int16", "int8", "uint8", "bool")


@dataclass
class AuditResult:
    """Outcome of one audit pass over the kernel registry."""

    findings: List[Finding] = field(default_factory=list)
    suppressed: List[Finding] = field(default_factory=list)
    kernel_seconds: Dict[str, float] = field(default_factory=dict)
    #: Raw (pre-suppression) findings per kernel: what the cache stores.
    kernel_findings: Dict[str, List[Finding]] = field(default_factory=dict)
    kernels_checked: int = 0
    kernels_cached: int = 0
    skipped: List[str] = field(default_factory=list)
    device_count: int = 0
    #: Per program run: the lanes it made ("int32", "bool", "int64 (index)",
    #: ...) and its :func:`spec_signature` (the cache's fingerprints of a
    #: cold run).
    kernel_lanes: Dict[str, List[str]] = field(default_factory=dict)
    kernel_signatures: Dict[str, str] = field(default_factory=dict)


def load_registry() -> Dict[str, KernelSpec]:
    """Import every seam module (self-registering) and snapshot the registry."""
    import importlib

    for mod in SEAM_MODULES:
        importlib.import_module(mod)
    return registry()


def _describe(x) -> object:
    """A stable, data-free description of one spec argument."""
    import numpy as np
    import torch

    if torch.is_tensor(x):
        return ("tensor", tuple(x.shape), str(x.dtype).replace("torch.", ""))
    if isinstance(x, np.ndarray):
        return ("ndarray", x.shape, str(x.dtype))
    if isinstance(x, (bool, int, float, str, type(None), np.generic)):
        return repr(x)
    if isinstance(x, dict):
        return ("dict", tuple((k, _describe(v)) for k, v in sorted(x.items())))
    if isinstance(x, (tuple, list)):
        return (type(x).__name__, tuple(_describe(v) for v in x))
    if hasattr(x, "__dataclass_fields__"):
        return (type(x).__name__,
                tuple((k, _describe(getattr(x, k))) for k in x.__dataclass_fields__))
    return type(x).__name__


def spec_signature(entry: KernelSpec) -> str:
    """Stable signature of the specs' shapes and dtypes plus the declared
    contracts: changing a shape, dtype, donation, fence count or bucket
    budget re-runs just that program.  Builds the specs on the CPU."""
    _seed()
    return _signature(entry, tuple(entry.specs("cpu")))


def _signature(entry: KernelSpec, specs: tuple) -> str:
    return repr(
        (
            _describe(specs),
            entry.donate,
            entry.fences,
            entry.dtypes,
            entry.buckets,
            entry.budget,
            entry.needs_mesh,
        )
    )


def _seed() -> None:
    """Every generator a spec or a program may draw from, at a fixed seed."""
    import random

    import numpy as np
    import torch

    random.seed(0)
    np.random.seed(0)
    torch.manual_seed(0)


def _finding(entry: KernelSpec, rule: str, severity: str, message: str) -> Finding:
    return Finding(
        rule=rule,
        path=entry.module,
        line=entry.line,
        context=f"kernel:{entry.name}",
        message=message,
        severity=severity,
    )


def _severities() -> Dict[str, str]:
    from holo_tpu_torch.analysis import rules_kernel

    return {cls.id: cls.severity for cls in rules_kernel.RULES}


def _tensors(value) -> list:
    """The tensor leaves of nested tuples / lists / NamedTuples / dicts /
    dataclasses."""
    import torch

    if torch.is_tensor(value):
        return [value]
    if isinstance(value, dict):
        value = list(value.values())
    elif hasattr(value, "__dataclass_fields__"):
        value = [getattr(value, k) for k in value.__dataclass_fields__]
    if isinstance(value, (tuple, list)):
        out = []
        for v in value:
            out.extend(_tensors(v))
        return out
    return []


def _short(dtype) -> str:
    return str(dtype).replace("torch.", "")


class _Recording:
    """What one recorded run saw: HL302 leaks (description -> count), HL303
    lanes (lane -> first op) and the sanctioned windows it opened."""

    def __init__(self):
        self.leaks: Counter = Counter()
        self.lanes: Dict[str, str] = {}
        self.widened: Dict[str, str] = {}
        self.windows: Dict[str, int] = {}


class _Fresh:
    """The tensors made from host data in one run, by identity (a
    ``WeakSet`` would compare tensors with ``==``)."""

    def __init__(self):
        self._refs: dict = {}

    def update(self, tensors) -> None:
        import weakref

        for t in tensors:
            self._refs[id(t)] = weakref.ref(t)

    def __contains__(self, t) -> bool:
        ref = self._refs.get(id(t))
        return ref is not None and ref() is t


def _classify_leak(name: str, overload: str, args, kwargs, fresh) -> Optional[str]:
    """The HL302 description of one op dispatched outside a window, or None.
    ``fresh`` holds the tensors made from host data in this run."""
    import torch

    if name in SCALAR_READS:
        return f"{name} (a scalar read)"
    if name in DATA_SHAPED:
        return f"{name} (data-dependent shape)"
    if name == "repeat_interleave" and overload != "self_int" and \
            kwargs.get("output_size") is None:
        return "repeat_interleave (data-dependent shape)"
    if name in MASK_INDEXED and len(args) > 1 and isinstance(args[1], (list, tuple)):
        if any(torch.is_tensor(i) and i.dtype in (torch.bool, torch.uint8) for i in args[1]):
            return f"{name} (boolean-mask index: data-dependent shape)"
        if name != "index" and len(args) > 2 and torch.is_tensor(args[2]) and \
                args[2].dim() == 0 and args[2] in fresh:
            return f"{name} (a host scalar written through tensor indices)"
    return None


def _recorder_mode(rec: _Recording, fresh):
    """A ``TorchDispatchMode`` that records into ``rec`` and adds every
    tensor made from host data (``aten.lift_fresh``) to ``fresh``."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    from holo_tpu_torch.analysis.runtime import window_depth

    class _Recorder(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            name = func.overloadpacket.__name__
            if window_depth() == 0:
                leak = _classify_leak(name, func._overloadname, args, kwargs, fresh)
                if leak is not None:
                    rec.leaks[leak] += 1
            out = func(*args, **kwargs)
            outs = [t for t in tree_leaves(out) if torch.is_tensor(t)]
            if name == "lift_fresh":
                fresh.update(outs)
            ins = [t.dtype for t in tree_leaves((args, kwargs)) if torch.is_tensor(t)]
            for t in outs:
                lane, widened = _lane(name, ins, t.dtype)
                rec.lanes.setdefault(lane, name)
                if widened:
                    rec.widened.setdefault(_short(t.dtype), name)
            return out

    return _Recorder()


def _lane(name: str, ins: list, dtype) -> Tuple[str, bool]:
    """(lane label, widened?) of one output dtype of op ``name`` whose
    tensor inputs have dtypes ``ins`` (the module docstring's rules)."""
    import torch

    short = _short(dtype)
    if dtype.is_floating_point or dtype.is_complex:
        return short, True
    if dtype != torch.int64:
        return short, False
    if name in CAST_OPS or name in INDEX_OPS or not ins:
        return "int64 (index)", False
    values = [d for d in ins if d != torch.bool] or ins
    if any(_short(d) in _NARROW for d in values):
        return "int64", True
    return "int64 (index)", False


def _moves_to_device(args, kwargs) -> bool:
    """Does a ``Tensor.to`` call name a device (and so, on the card, copy)?"""
    import torch

    if kwargs.get("device") is not None:
        return True
    return any(isinstance(a, (torch.device, str)) or torch.is_tensor(a) for a in args)


class _HostTransfers:
    """Watch, for one run, the host transfers the CPU dispatcher does not
    see: ``Tensor.cpu`` / ``.tolist`` / ``.numpy`` (readbacks), and
    ``Tensor.to`` / ``.cuda`` of a tensor made from host data or
    ``torch.tensor`` / ``torch.as_tensor`` of host data with a ``device``
    (uploads).  Outside a sanctioned window each is an HL302 leak.  The
    methods are patched process-wide for the run; only the auditing
    thread's calls count (a mesh runs its shards on the caller's thread)."""

    def __init__(self, rec: _Recording, fresh):
        self.rec = rec
        self.fresh = fresh
        self.saved = []

    def _wrap(self, owner, attr: str, check):
        import threading

        from holo_tpu_torch.analysis.runtime import window_depth

        orig = getattr(owner, attr)
        self.saved.append((owner, attr, orig))
        rec = self.rec
        me = threading.get_ident()

        def watched(*a, **k):
            if threading.get_ident() == me and window_depth() == 0:
                leak = check(a, k)
                if leak is not None:
                    rec.leaks[leak] += 1
            return orig(*a, **k)

        setattr(owner, attr, watched)

    def __enter__(self):
        import torch

        fresh = self.fresh
        for meth in HOST_READS:
            self._wrap(torch.Tensor, meth, lambda a, k, m=meth: f"Tensor.{m} (a readback)")
        self._wrap(torch.Tensor, "to", lambda a, k: "Tensor.to (host data uploaded)"
                   if a[0] in fresh and _moves_to_device(a[1:], k) else None)
        self._wrap(torch.Tensor, "cuda", lambda a, k: "Tensor.cuda (host data uploaded)"
                   if a[0] in fresh else None)
        for fn in ("tensor", "as_tensor"):
            self._wrap(torch, fn, lambda a, k, f=fn: f"torch.{f} (host data uploaded)"
                       if k.get("device") is not None
                       and not (torch.is_tensor(a[0]) and a[0] not in fresh) else None)
        return self

    def __exit__(self, *exc):
        for owner, attr, orig in reversed(self.saved):
            setattr(owner, attr, orig)
        return False


def record(fn, *args, device: str = "cpu"):
    """Run ``fn(*args)`` once under the recorder (and, on the card, the
    transfer sanitizer at "error"): (output, :class:`_Recording`).  A sync
    the sanitizer raises on ends the run and is a leak of its own."""
    import torch

    from holo_tpu_torch.analysis import runtime

    rec = _Recording()
    fresh = _Fresh()
    before = runtime.sanctioned_counts()
    out = None
    on_card = str(device).startswith("cuda")
    try:
        with _HostTransfers(rec, fresh), _recorder_mode(rec, fresh):
            if on_card:
                with runtime.transfer_sanitizer():
                    out = fn(*args)
            else:
                out = fn(*args)
    except RuntimeError as exc:
        if "synchroniz" not in str(exc):
            raise
        rec.leaks[f"sanitizer: {str(exc).splitlines()[0]}"] += 1
    if on_card:
        torch.cuda.synchronize()
    after = runtime.sanctioned_counts()
    rec.windows = {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}
    return out, rec


def _storage(t) -> int:
    return t.untyped_storage().data_ptr()


def audit_kernel(entry: KernelSpec, mesh=None, device: str = "cpu",
                 rec_out: Optional[dict] = None) -> Tuple[List[Finding], float]:
    """Run one registered program on its specs and check HL301-HL305.

    Returns the findings plus the wall seconds (specs and run).  ``rec_out``,
    when given, receives the run's lanes and windows."""
    from holo_tpu_torch.parallel import mesh as pm

    sev = _severities()
    findings: List[Finding] = []
    t0 = time.perf_counter()

    # HL304 is pure metadata: check it before running anything.
    if entry.buckets is None:
        findings.append(
            _finding(
                entry,
                "HL304",
                sev["HL304"],
                "dispatch seam declares no static shape-bucket bound "
                "(unbounded-shape args => unbounded recompiles); register "
                "buckets=<n> from the tuner/pow2 quantization",
            )
        )
    elif entry.buckets > entry.budget:
        findings.append(
            _finding(
                entry,
                "HL304",
                sev["HL304"],
                f"dispatch seam enumerates {entry.buckets} shape buckets, "
                f"over the compile-signature budget of {entry.budget}",
            )
        )

    program = entry.builder(mesh) if entry.needs_mesh else entry.builder()
    _seed()
    specs = tuple(entry.specs(device))
    donated = [t for i in entry.donate if i < len(specs) for t in _tensors(specs[i])]
    before = [(t._version, _storage(t)) for t in donated]
    joins0 = pm.join_count()
    out, rec = record(program, *specs, device=device)
    joins = pm.join_count() - joins0
    if rec_out is not None:
        rec_out.update(lanes=sorted(rec.lanes), windows=rec.windows,
                       signature=_signature(entry, specs))

    # HL301: every donated leaf moved in place and handed back.
    if donated:
        returned = {_storage(t) for t in _tensors(out)}
        moved = any(t._version != v for t, (v, _) in zip(donated, before))
        if out is None:
            realized = sum(1 for t, (v, _) in zip(donated, before) if t._version != v)
        else:
            realized = sum(1 for _, ptr in before if moved and ptr in returned)
        if realized < len(donated):
            findings.append(
                _finding(
                    entry,
                    "HL301",
                    sev["HL301"],
                    f"declared donate={entry.donate} but only "
                    f"{realized}/{len(donated)} donated leaves were moved in "
                    "place (version bump, storage shared with a returned "
                    "tensor): the seam allocates a copy and note_donated "
                    "stamps a tensor nobody reads",
                )
            )

    # HL302: host round-trips outside the sanctioned windows.
    if rec.leaks:
        findings.append(
            _finding(
                entry,
                "HL302",
                sev["HL302"],
                "host round-trip(s) inside dispatch-scope program outside a "
                "sanctioned window: "
                + ", ".join(f"{k} x{n}" for k, n in sorted(rec.leaks.items())),
            )
        )

    # HL303: widened lanes outside the declared dtypes.
    bad = {dt: op for dt, op in rec.widened.items() if dt not in entry.dtypes}
    if bad:
        detail = ", ".join(f"{dt} (from `{op}`)" for dt, op in sorted(bad.items()))
        findings.append(
            _finding(
                entry,
                "HL303",
                sev["HL303"],
                f"op output lanes outside declared dtypes {entry.dtypes}: " + detail,
            )
        )

    # HL305: declared joins of the batch shards, on a two-device mesh.
    if entry.fences and (not entry.needs_mesh or mesh is not None):
        if joins < entry.fences:
            findings.append(
                _finding(
                    entry,
                    "HL305",
                    sev["HL305"],
                    f"program declares {entry.fences} sharding fence(s) but "
                    f"joined its batch shards {joins} time(s) (gather_batch)",
                )
            )

    return findings, time.perf_counter() - t0


def audit_mesh(device: str = "cpu"):
    """The audit's two-device mesh: two virtual entries of ``device``."""
    from holo_tpu_torch.parallel.mesh import make_spf_mesh, virtual_devices

    return make_spf_mesh(2, 1, devices=virtual_devices(2, device))


def apply_suppressions(
    findings: Iterable[Finding], root: str
) -> Tuple[List[Finding], List[Finding]]:
    """Split audit findings into (live, suppressed) using the same
    ``# holo-lint: disable=`` comments (same line or line above) as
    ``holo_tpu``.  Reads each registering module's source once."""
    cache: Dict[str, Dict[int, set]] = {}
    live: List[Finding] = []
    suppressed: List[Finding] = []
    for f in findings:
        if f.path not in cache:
            try:
                with open(os.path.join(root, f.path), encoding="utf-8") as fh:
                    cache[f.path] = parse_suppressions(fh.read())
            except OSError:
                cache[f.path] = {}
        sup = cache[f.path]
        hit = False
        for line in (f.line, f.line - 1):
            ids = sup.get(line)
            if ids and ("all" in ids or f.rule in ids):
                hit = True
                break
        (suppressed if hit else live).append(f)
    return live, suppressed


def audit_entries(
    entries: Iterable[KernelSpec], mesh=None, device: str = "cpu",
    recs: Optional[dict] = None,
) -> Tuple[Dict[str, List[Finding]], Dict[str, float], List[str]]:
    """Audit an explicit entry list (no registry, no cache, no suppression
    pass): (per-kernel findings, per-kernel wall seconds, skipped names).
    Mesh-needing programs are skipped when no mesh is given.  ``recs``, when
    given, receives each program's lanes and windows by name."""
    per_kernel: Dict[str, List[Finding]] = {}
    seconds: Dict[str, float] = {}
    skipped: List[str] = []
    for entry in entries:
        if entry.needs_mesh and mesh is None:
            skipped.append(entry.name)
            continue
        rec: dict = {}
        rows, dt = audit_kernel(entry, mesh=mesh, device=device, rec_out=rec)
        per_kernel[entry.name] = rows
        seconds[entry.name] = dt
        if recs is not None:
            recs[entry.name] = rec
    return per_kernel, seconds, skipped


def run_audit(
    root: str,
    names: Optional[Iterable[str]] = None,
    reuse: Optional[Dict[str, dict]] = None,
    device: str = "cpu",
) -> AuditResult:
    """Audit every registered program on ``device`` and apply suppressions.

    ``reuse`` maps kernel name -> ``{"findings": [...], "seconds": s}`` rows
    the cache validated by fingerprint; those programs do not run and replay
    their stored findings.  Findings come back sorted by (path, line, rule).
    """
    entries = load_registry()
    if names is not None:
        wanted = set(names)
        entries = {k: v for k, v in entries.items() if k in wanted}

    mesh = audit_mesh(device)
    result = AuditResult(device_count=mesh.size)

    fresh: List[KernelSpec] = []
    for name in sorted(entries):
        row = (reuse or {}).get(name)
        if row is not None:
            result.kernel_findings[name] = list(row["findings"])
            result.kernel_seconds[name] = row.get("seconds", 0.0)
            result.kernels_cached += 1
        else:
            fresh.append(entries[name])
    recs: dict = {}
    per_kernel, seconds, skipped = audit_entries(fresh, mesh=mesh, device=device, recs=recs)
    result.kernel_findings.update(per_kernel)
    result.kernel_seconds.update(seconds)
    result.kernel_lanes = {k: v["lanes"] for k, v in recs.items()}
    result.kernel_signatures = {k: v["signature"] for k, v in recs.items()}
    result.skipped = skipped
    result.kernels_checked = len(entries) - len(skipped)

    raw: List[Finding] = []
    for name in sorted(result.kernel_findings):
        raw.extend(result.kernel_findings[name])

    live, suppressed = apply_suppressions(raw, root)
    result.findings = sorted(live, key=lambda f: (f.path, f.line, f.rule))
    result.suppressed = sorted(suppressed, key=lambda f: (f.path, f.line, f.rule))
    return result
