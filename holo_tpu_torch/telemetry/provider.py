"""The ``holo-telemetry`` state leaf over the port's modules (the port's
copy of ``holo_tpu.telemetry.provider``): :func:`state_leaf` builds it, and
:class:`TelemetryStateProvider` serves it on the daemon's northbound.

:func:`state_leaf` returns the subtree under ``holo_tpu``'s keys, each
present while its subsystem is live, as ``holo_tpu``'s is:

    metric[]             the registry's samples (name, value, labels, and a
                         histogram's bucket exemplars on its _count row)
    device               the device the caller names
    health/breakers      every live port breaker's snapshot
    health/supervision   the actor supervisors' restarts, crashes and
                         degraded actors
    flight, convergence  the flight recorder and the convergence tracker
    spf-graph-cache      the shared graph caches of every device, summed,
                         with per-device placement (entries, rows, bytes)
    pipeline             the process dispatch pipeline's stats
    engine-tuner         the armed tuner's stats
    bgp-table            the live BGP table backends' stats
    observatory, critical-path, slo
    device-residency     the residency ledger, once anything is resident

Every value is plain JSON.
"""

from __future__ import annotations

import sys

from holo_tpu_torch.northbound.provider import Provider

ROOT = "holo-telemetry"


def metric_rows(registry) -> list[dict]:
    """One row a sample: counters and gauges by family name, histograms as
    their ``_count`` and ``_sum`` rows (``holo_tpu``'s shape)."""
    rows = []
    for fam in registry.families():
        for key, child in fam.children():
            labels = ",".join(f"{n}={v}" for n, v in zip(fam.labelnames, key))
            if fam.kind == "histogram":
                samples = [(f"{fam.name}_count", child.count),
                           (f"{fam.name}_sum", round(child.sum, 9))]
                exemplars = _exemplar_leaf(child)
            else:
                samples, exemplars = [(fam.name, child.value)], ""
            for name, value in samples:
                entry = {"name": f"{name}{{{labels}}}" if labels else name, "value": value,
                         "labels": labels}
                if exemplars and name.endswith("_count"):
                    entry["exemplars"] = exemplars
                rows.append(entry)
    return rows


def _exemplar_leaf(hist) -> str:
    """A histogram child's bucket exemplars as one scalar:
    ``le=<bucket>:<k>=<v>:value=<obs>`` joined by ``;``, buckets ascending."""
    out = []
    for le, (pairs, value) in sorted(hist.exemplars().items()):
        le_s = "+Inf" if le == float("inf") else f"{le:g}"
        kv = ":".join(f"{k}={v}" for k, v in pairs)
        out.append(f"le={le_s}:{kv}:value={value:g}")
    return ";".join(out)


def device_name(device) -> str:
    """``device`` as the caches key it: a card with its index."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return str(dev)


def graph_cache_stats() -> dict | None:
    """``holo_tpu``'s ``spf-graph-cache`` leaf over every device's shared
    cache: the counts summed, and per device the resident entries, the rows
    of their graphs and the bytes of their planes (metadata reads only, no
    copy from the device).  None before any cache exists."""
    eng = sys.modules.get("holo_tpu_torch.ops.spf_engine")
    if eng is None:
        return None
    with eng._SHARED_LOCK:
        caches = list(eng._SHARED_CACHES.items())
    if not caches:
        return None
    from holo_tpu_torch.parallel import mesh as pm

    out = {"entries": 0, "capacity": 0, "evictions": 0, "deltas-applied": 0,
           "delta-entries": 0, "max-chain-depth": 0, "stale-id-entries": 0,
           "tropical-entries": 0, "occupancy": 0.0, "partitioned-residents": 0,
           "partitioned-parts": 0, "sharded-entries": 0, "mesh": None, "per-device": {}}
    occ = []
    for dev, cache in caches:
        with cache._lock:
            items = list(cache._cache.items())
            parts = list(cache._part.values())
        s = cache.stats()
        for k in ("entries", "capacity", "evictions", "deltas-applied", "delta-entries",
                  "stale-id-entries", "tropical-entries"):
            out[k] += s[k]
        out["max-chain-depth"] = max(out["max-chain-depth"], s["max-chain-depth"])
        out["partitioned-residents"] += len(parts)
        out["partitioned-parts"] += sum(r.plan.n_parts for r in parts)
        out["sharded-entries"] += sum(1 for key, _ in items if key[-1] is not None)
        occ.extend(e.mirror.occupancy for _, e in items)
        placed = {"entries": len(items), "rows": 0, "bytes": 0}
        for _, e in items:
            placed["rows"] += int(e.graph.in_src.shape[0])
            placed["bytes"] += sum(int(t.numel() * t.element_size()) for t in e.graph)
        out["per-device"][str(dev)] = placed
    out["occupancy"] = round(sum(occ) / len(occ), 4) if occ else 0.0
    mesh = pm.process_mesh()
    if mesh is not None:
        out["mesh"] = {"batch": mesh.shape["batch"], "node": mesh.shape["node"]}
    return out


def state_leaf(device=None) -> dict:
    """The port's ``holo-telemetry`` subtree (the value under :data:`ROOT`);
    ``device``: the device the caller runs on, named in the leaf."""
    from holo_tpu_torch import telemetry
    from holo_tpu_torch.resilience import breakers
    from holo_tpu_torch.telemetry import convergence, critpath, flight, observatory, slo

    out: dict = {"metric": metric_rows(telemetry.registry())}
    if device is not None:
        out["device"] = device_name(device)
    health = _resilience_health(breakers())
    if health:
        out["health"] = health
    rec = flight.recorder()
    if rec is not None:
        out["flight"] = rec.stats()
    tr = convergence.tracker()
    if tr is not None:
        out["convergence"] = tr.stats()
    cache = graph_cache_stats()
    if cache is not None:
        out["spf-graph-cache"] = cache
    disp = sys.modules.get("holo_tpu_torch.pipeline.dispatch")
    if disp is not None:
        pipe = disp.process_pipeline()
        if pipe is not None:
            out["pipeline"] = pipe.stats()
    tun = sys.modules.get("holo_tpu_torch.pipeline.tuner")
    if tun is not None:
        tuner = tun.active_tuner()
        if tuner is not None:
            out["engine-tuner"] = tuner.stats()
    bgm = sys.modules.get("holo_tpu_torch.ops.bgp_table")
    if bgm is not None:
        rows = bgm.backends_stats()
        if rows:
            out["bgp-table"] = rows[0] if len(rows) == 1 else rows
    ob = observatory.active()
    if ob is not None:
        out["observatory"] = ob.stats()
    cp = critpath.active()
    if cp is not None:
        out["critical-path"] = cp.stats()
    sl = slo.active()
    if sl is not None:
        out["slo"] = sl.stats()
    resm = sys.modules.get("holo_tpu_torch.telemetry.residency")
    if resm is not None:
        rs = resm.snapshot()
        if rs.get("total-bytes") or any(r["entries"] for r in rs["planes"].values()):
            out["device-residency"] = rs
    return out


def _resilience_health(live_breakers: dict) -> dict:
    """The live breakers' states and the supervisors' restart and degraded
    bookkeeping (``holo_tpu.resilience.health_snapshot``)."""
    out: dict = {}
    brs = {name: br.snapshot() for name, br in live_breakers.items()}
    if brs:
        out["breakers"] = brs
    supm = sys.modules.get("holo_tpu_torch.resilience.supervisor")
    sups = [s.snapshot() for s in supm.supervisors()] if supm is not None else []
    if sups:
        merged = {"degraded-actors": [], "restarts": {}, "crashes": {}}
        for snap in sups:
            merged["degraded-actors"].extend(snap["degraded-actors"])
            merged["restarts"].update(snap["restarts"])
            merged["crashes"].update(snap["crashes"])
        merged["degraded-actors"].sort()
        out["supervision"] = merged
    return out


class TelemetryStateProvider(Provider):
    """The ``holo-telemetry`` leaf on the northbound: :func:`state_leaf` on
    the daemon's device.  Read-only: owns no config subtree, vetoes
    nothing."""

    name = "telemetry"

    def __init__(self, device=None):
        self.device = device

    def filter_changes(self, changes):
        return []  # state-only: never part of a commit fan-out

    def get_state(self, path: str | None = None) -> dict:
        if path and not ROOT.startswith(path.split("/")[0]):
            return {}
        return {ROOT: state_leaf(device=self.device)}
