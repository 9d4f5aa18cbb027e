"""HL3xx: the kernel-contract rules, the port's counterpart of
``holo_tpu/analysis/rules_jaxpr.py`` (same ids, titles and severities).

The findings come from :mod:`holo_tpu_torch.analysis.kernel_audit`, which
runs every program registered in :mod:`holo_tpu_torch.analysis.kernels`
once under a dispatch recorder; these classes are the catalog that gives
each rule its title and tier.  Contract violations that corrupt state or
leak to the host (HL301, HL302) are error tier and gate; discipline drift
(HL303 widening, HL304 signature budget, HL305 joins) is warn tier.
"""

from __future__ import annotations


class KernelRule:
    """A rule of the kernel-contract family."""

    id = ""
    title = ""
    severity = "error"


class DonationNotRealizedRule(KernelRule):
    """HL301: a declared donated argument was not moved in place: a leaf's
    version counter did not rise, or no returned tensor shares its storage.
    The in-place seam then allocates a copy, and the donation guard's
    ``note_donated`` stamps a tensor nobody reads."""

    id = "HL301"
    title = "declared buffer donation not realized in lowered kernel"
    severity = "error"


class HostLeakInKernelRule(KernelRule):
    """HL302: a host round-trip inside a dispatch program outside a
    sanctioned window of :mod:`holo_tpu_torch.analysis.runtime`: a scalar
    read (``.item()``, ``bool(t)``), an op whose output shape depends on the
    data, or (on the card) any sync the transfer sanitizer catches."""

    id = "HL302"
    title = "host-transfer primitive inside dispatch-scope kernel"
    severity = "error"


class DtypeWideningRule(KernelRule):
    """HL303: a program makes a value lane wider than its declared dtype
    lanes: a float, or an int64 made by implicit promotion from an int32 or
    bool tensor.  A widened lane breaks the exact int32 contract and parity
    with the device plane."""

    id = "HL303"
    title = "dtype lane widened beyond declared kernel discipline"
    severity = "warn"


class CompileSignatureBudgetRule(KernelRule):
    """HL304: a registered dispatch seam declares no static shape-bucket
    bound, or more buckets than its budget."""

    id = "HL304"
    title = "compile-signature budget exceeded or unbounded-shape arg"
    severity = "warn"


class FenceNotRealizedRule(KernelRule):
    """HL305: a per-mesh program declares joins of its batch shards
    (``parallel.mesh.gather_batch``, the twin of ``constrain_batch``) but ran
    fewer on a two-device mesh."""

    id = "HL305"
    title = "declared sharding fence missing from lowered kernel"
    severity = "warn"


RULES = [
    DonationNotRealizedRule,
    HostLeakInKernelRule,
    DtypeWideningRule,
    CompileSignatureBudgetRule,
    FenceNotRealizedRule,
]
