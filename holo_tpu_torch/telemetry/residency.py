"""The device-residency byte ledger (``holo_tpu.telemetry.residency``).

One instrument sums every tensor the port parks on a device between
dispatches: a ``holo_device_resident_bytes{plane}`` gauge family and a
:func:`snapshot` with one row per plane.

Planes (:data:`PLANES`, ``holo_tpu``'s rows):

- ``spf-graph``: the ELL entries of every device's shared graph cache
  (``ops.spf_engine.shared_graph_cache``);
- ``spf-graph-partitioned``: the caches' partitioned residents (each
  ``PartResident``'s stacked graph);
- ``tropical``: the tile attachments riding the cache entries.  The
  multipath program's count tiles are built and freed within a fixpoint, so
  no row holds them between dispatches;
- ``spf-prev``: the ``TorchSpfBackend`` runs kept as DeltaPath seeds
  (``_prev_one``; the backends are held by weak reference, so a dropped
  backend leaves the row);
- ``bgp-table``: the BGP backends' Adj-RIB-In lane planes.

Each row is summed lazily, over the tensors' ``nbytes``, when the gauge is
sampled or :func:`snapshot` runs: nothing here runs on a dispatch path, and
the modules are looked up in ``sys.modules``, never imported.
"""

from __future__ import annotations

import sys
import weakref

from holo_tpu_torch import telemetry

#: the plane rows
PLANES = ("spf-graph", "spf-graph-partitioned", "tropical", "spf-prev", "bgp-table")

# Sampled at snapshot time only: unstamped, as holo_tpu's.
_RESIDENT = telemetry.gauge(
    "holo_device_resident_bytes",
    "Device-resident plane bytes by subsystem (marshaled SPF graphs, "
    "partitioned residents, tropical tiles, retained previous-result "
    "tensors, BGP table lanes)",
    ("plane",),
    stamped=False,
)

_SPF_BACKENDS: list = []


def register_spf_backend(backend) -> None:
    """Called once from ``TorchSpfBackend.__init__``: the ledger then sees
    its kept runs."""
    _SPF_BACKENDS.append(weakref.ref(backend))


def _live_backends() -> list:
    live = [b for b in (ref() for ref in _SPF_BACKENDS) if b is not None]
    _SPF_BACKENDS[:] = [ref for ref in _SPF_BACKENDS if ref() is not None]
    return live


def nbytes(obj, depth: int = 0) -> int:
    """``nbytes`` summed over the tensor leaves of nested tuples, lists and
    dicts (NamedTuple planes, (SpfTensors, MultipathTensors) pairs); depth
    bounded."""
    if obj is None or depth > 6:
        return 0
    if isinstance(obj, dict):
        return sum(nbytes(v, depth + 1) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return sum(nbytes(v, depth + 1) for v in obj)
    nb = getattr(obj, "nbytes", None)
    return int(nb) if isinstance(nb, int) else 0


def _caches() -> list:
    eng = sys.modules.get("holo_tpu_torch.ops.spf_engine")
    if eng is None:
        return []
    with eng._SHARED_LOCK:
        return list(eng._SHARED_CACHES.values())


def rows() -> dict[str, dict]:
    """{plane: {"bytes": int, "entries": int}}, one walk over every plane."""
    out = {p: {"bytes": 0, "entries": 0} for p in PLANES}
    for cache in _caches():
        with cache._lock:
            entries = list(cache._cache.values())
            parts = list(cache._part.values())
        for e in entries:
            out["spf-graph"]["bytes"] += nbytes(tuple(e.graph))
            out["spf-graph"]["entries"] += 1
            if e.tropical is not None:
                out["tropical"]["bytes"] += nbytes(tuple(e.tropical))
                out["tropical"]["entries"] += 1
        for res in parts:
            out["spf-graph-partitioned"]["bytes"] += nbytes(tuple(res.graph))
            out["spf-graph-partitioned"]["entries"] += 1
    for backend in _live_backends():
        with backend._prev_lock:
            kept = list(backend._prev_one.values())
        for run in kept:
            out["spf-prev"]["bytes"] += nbytes(run)
            out["spf-prev"]["entries"] += 1
    bgm = sys.modules.get("holo_tpu_torch.ops.bgp_table")
    if bgm is not None:
        for backend in bgm.live_backends():
            for dt in list(backend._tables.values()):
                out["bgp-table"]["bytes"] += nbytes(dt.planes)
                out["bgp-table"]["entries"] += 1
    return out


def _plane_bytes(plane: str) -> float:
    try:
        return float(rows()[plane]["bytes"])
    except Exception:  # noqa: BLE001 -- a sampler never takes a scrape down
        return 0.0


for _p in PLANES:
    _RESIDENT.labels(plane=_p).set_fn(lambda p=_p: _plane_bytes(p))
del _p


def snapshot() -> dict:
    """Per-plane bytes and entries, and their total."""
    r = rows()
    return {"total-bytes": sum(x["bytes"] for x in r.values()), "planes": r}
