"""Device-resident BGP table: the RFC 4271 §9.1.2.2 decision process as one
kernel launch over packed attribute lanes.

The port's counterpart of ``holo_tpu/ops/bgp_table.py``.  The Adj-RIB-In of
one address family is a resident ``(N_LANES, rows, cols)`` int32 tensor on
the card: one row per prefix, one column per peer, column 0 for the local /
redistributed route.  Every attribute the ladder reads is interned on the
host into an order-preserving int32 lane (``bias(u) = u - 2**31``):

====  ==============  ====================================================
lane  name            encoding
====  ==============  ====================================================
0     lp              ``bias(0xFFFFFFFF - local_pref)`` (default 100)
1     l1              ``path_length << 2 | origin_order``
2     med             ``bias(med or 0)``
3     fas             dense intern id of ``first_as()`` (equality only)
4     rt              0 = Internal, 1 = External (higher preferred)
5     igp             local routes: ``bias(0)`` for no cost, else
                      ``bias(cost + 1)``; peer routes derive it on the
                      card from the next-hop vector
6     rid             ``bias(int(IPv4Address(identifier)))``
7     has_rid         the router-id rung needs both sides to carry one
8     nh              dense intern id of ``ll_nexthop or nexthop``
9     path            dense intern id of the AS path tuple
10    occ             cell holds a route
11    loop            ``as_path_contains(local_asn)``
12    local           ``origin.is_local()``
====  ==============  ====================================================

The MED rung fires only between routes of the same first AS, so the
comparator is not transitive and the decision is a fold over the columns in
the oracle's candidate order, not an argmin: ``kernels.bgp.bgp_fold``
(``csrc/bgp_kernels.cu``) walks one row a thread and also emits the
per-cell reject-reason codes (YANG-visible) and the multipath selection.

Incrementality as in ``holo_tpu``: engines note content changes per prefix
(``note_route_change``); an UPDATE batch scatters exactly those rows in
place (:func:`scatter_rows`) and recomputes the engine's queued set;
next-hop churn re-reads resident rows with no re-marshal, because the IGP
lane is derived on the card.  Planes grow by doubling (:func:`grow_planes`).

The scalar decision process (``protocols.bgp_engine``) is the oracle.  A
route the lane contract cannot represent poisons only its own prefix back
to it.  A device failure under the ``CircuitBreaker("bgp-table")`` is
counted; the oracle then serves the batch only on the CPU, and on the card
the failure re-raises.  The chaos seams ``faults.crashpoint("bgp.dispatch")``
and ``faults.delaypoint("bgp.dispatch")`` sit where ``holo_tpu`` has them.

Telemetry, under ``holo_tpu``'s names: ``holo_bgp_table_dispatch_total
{kind}``, ``holo_bgp_table_update_rows{kind}``, ``holo_bgp_table_recomputed_
prefixes{kind}``, ``holo_bgp_table_fallback_total{context}``, the
``bgp.table.dispatch`` / ``bgp.rank.dispatch`` spans and the ``bgp.table``
marshal / device / readback stages; the row scatter is the donation guard's
``bgp.table.scatter`` seam.  ``holo_tpu``'s jit compile and cache-hit pair has
no torch meaning.  Left out (ROADMAP): the observatory's calls (A13b), the
kernel-contract audit registrations (A13c) and the telemetry leaf wiring
(A4).
"""

from __future__ import annotations

import weakref
from collections import Counter
from dataclasses import dataclass, field
from ipaddress import IPv4Address

import numpy as np
import torch

from holo_tpu_torch import telemetry
from holo_tpu_torch.analysis.runtime import note_donated, sanctioned_transfer
from holo_tpu_torch.device import resolve_device
from holo_tpu_torch.kernels import bgp
from holo_tpu_torch.kernels.bgp import (  # noqa: F401 (the lane contract)
    L_FAS,
    L_HASRID,
    L_IGP,
    L_L1,
    L_LOCAL,
    L_LOOP,
    L_LP,
    L_MED,
    L_NH,
    L_OCC,
    L_PATH,
    L_RID,
    L_RT,
    LOCAL_COL,
    N_LANES,
    R_ADDR,
    R_IGP,
    R_LP,
    R_MED,
    R_ORIGIN,
    R_PLEN,
    R_RID,
    R_RT,
)
from holo_tpu_torch.resilience import faults
from holo_tpu_torch.resilience.breaker import CircuitBreaker
from holo_tpu_torch.telemetry import profiling

_DISPATCH_TOTAL = telemetry.counter(
    "holo_bgp_table_dispatch_total", "BGP table device dispatches", ("kind",))
_UPDATE_ROWS = telemetry.counter(
    "holo_bgp_table_update_rows", "Adj-RIB-In rows scattered into the device planes", ("kind",))
_RECOMPUTED = telemetry.counter(
    "holo_bgp_table_recomputed_prefixes", "Prefixes whose best path was recomputed on device",
    ("kind",))
_FALLBACK = telemetry.counter(
    "holo_bgp_table_fallback_total", "Decisions served by the scalar oracle instead of the device",
    ("context",))

__all__ = [
    "MarshalError",
    "REJECT_REASONS",
    "ScalarBgpTableBackend",
    "TorchBgpTableBackend",
    "DeviceRankBackend",
    "fold_planes",
    "decide",
    "scatter_rows",
    "grow_planes",
    "backends_stats",
]

_BIAS = 1 << 31
_U32 = (1 << 32) - 1

#: reject-reason code -> the oracle's reason string (0 = winner / unset).
REJECT_REASONS = (
    None,
    "local-pref-lower",
    "as-path-longer",
    "origin-type-higher",
    "med-higher",
    "prefer-external",
    "nexthop-cost-higher",
    "higher-router-id",
    "higher-peer-address",
)

_ORIGIN_ORDER = {"Igp": 0, "Egp": 1, "Incomplete": 2}
_DFLT_LOCAL_PREF = 100


class MarshalError(ValueError):
    """A route the lane contract cannot represent — the owning prefix is
    poisoned back to the scalar oracle, nothing else degrades."""


def _addr_key(addr: str):
    """Mirror of ``bgp_engine._addr_key`` (v4 numeric, v6 after) —
    duplicated so the ops layer never imports the protocol layer."""
    try:
        return (0, int(IPv4Address(addr)))
    except Exception:  # noqa: BLE001 — v6 sorts after v4
        return (1, addr)


def _u32(v, what: str) -> int:
    v = int(v)
    if not 0 <= v <= _U32:
        raise MarshalError(f"{what} out of u32 range: {v}")
    return v


def _bias(u: int) -> int:
    return int(u) - _BIAS


class _Interner:
    """Dense equality-only ids (first_as / nexthop / AS-path lanes)."""

    def __init__(self):
        self.ids: dict = {}
        self.values: list = []

    def intern(self, value) -> int:
        got = self.ids.get(value)
        if got is None:
            got = self.ids[value] = len(self.values)
            self.values.append(value)
            if got >= _BIAS:
                raise MarshalError("interner overflow")
        return got

    def __len__(self) -> int:
        return len(self.values)


def _encode_cell(route, col_addr, asn, fas_ids, path_ids, nh_ids) -> list:
    """One (prefix, peer) cell -> the 13 lane values.  Raises
    :class:`MarshalError` for anything outside the lane contract."""
    a = route.attrs
    lp = a.local_pref if a.local_pref is not None else _DFLT_LOCAL_PREF
    lane_lp = _bias(_U32 - _u32(lp, "local-pref"))
    plen = a.path_length()
    if plen >= (1 << 24):
        raise MarshalError(f"as-path length {plen} >= 2**24")
    origin_ord = _ORIGIN_ORDER.get(a.origin)
    if origin_ord is None:
        raise MarshalError(f"unknown origin {a.origin!r}")
    lane_l1 = (plen << 2) | origin_ord
    lane_med = _bias(_u32(a.med or 0, "med"))
    lane_fas = fas_ids.intern(a.first_as())
    if route.route_type == "Internal":
        lane_rt = 0
    elif route.route_type == "External":
        lane_rt = 1
    else:
        raise MarshalError(f"unknown route type {route.route_type!r}")
    is_local = route.origin.is_local()
    if is_local:
        igp = route.igp_cost
        lane_igp = _bias(0 if igp is None else _u32(igp, "igp-cost") + 1)
        lane_nh = 0
    else:
        nexthop = a.ll_nexthop or a.nexthop
        if nexthop is None:
            raise MarshalError("peer route without next hop")
        lane_nh = nh_ids.intern(nexthop)
        lane_igp = 0  # derived on device from the NHT metric vector
    if col_addr is not None and route.origin.remote_addr != col_addr:
        # The peer-address rung rides a per-COLUMN rank vector; a route
        # whose remote_addr is not its column's address would compare
        # against the wrong rank.
        raise MarshalError("route remote_addr differs from its column")
    if col_addr is None and route.origin.remote_addr is not None:
        # Local column with a peer address: same rank mismatch hazard.
        raise MarshalError("local-column route carries a remote_addr")
    rid = route.origin.identifier
    if rid is None:
        lane_rid, lane_hasrid = 0, 0
    else:
        try:
            lane_rid = _bias(int(IPv4Address(rid)))
        except Exception as exc:  # noqa: BLE001 — oracle would also choke
            raise MarshalError(f"unparseable router-id {rid!r}") from exc
        lane_hasrid = 1
    return [
        lane_lp,
        lane_l1,
        lane_med,
        lane_fas,
        lane_rt,
        lane_igp,
        lane_rid,
        lane_hasrid,
        lane_nh,
        path_ids.intern(a.as_path),
        1,
        1 if a.as_path_contains(asn) else 0,
        1 if is_local else 0,
    ]


# ---------------------------------------------------------------------------
# functions on tensors


def fold_planes(sub, order, addr_rank, has_addr, nht_enc, nht_res, mp):
    """``_fold_planes`` over every row of ``sub`` (N_LANES, M, C): returns
    ``(best_col, reasons, elig, mp_sel)`` as ``kernels.bgp.bgp_fold``."""
    idx = torch.arange(sub.shape[1], dtype=torch.int32, device=sub.device)
    return bgp.bgp_fold(sub, idx, order, addr_rank, has_addr, nht_enc, nht_res, mp)


def decide(planes, idx, order, addr_rank, has_addr, nht_enc, nht_res, mp):
    """``_decide_fn``: the fold over the rows ``idx`` of the resident planes
    (the kernel reads them through ``idx``; nothing is gathered first)."""
    return bgp.bgp_fold(planes, idx, order, addr_rank, has_addr, nht_enc, nht_res, mp)


def scatter_rows(planes, idx, rows):
    """Write ``rows`` (N_LANES, k, C) into the rows ``idx`` of ``planes`` in
    place (JAX's donated ``_scatter``) and return ``planes``."""
    return planes.index_copy_(1, idx.long(), rows)


def grow_planes(planes, nr: int, nc: int):
    """``planes`` padded with zero rows at the bottom and zero columns on the
    right (column 0 stays the local column): a fresh tensor and a copy."""
    lanes, r, c = planes.shape
    out = planes.new_zeros((lanes, r + nr, c + nc))
    out[:, :r, :c] = planes
    return out


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _marshal_list(prefixes, dirty, new_rows) -> list:
    """The batch's prefixes whose rows are re-marshaled: noted (dirty) or
    new, in batch order (``holo_tpu`` builds ``set(new_rows)`` once a prefix,
    quadratic on a cold batch; here once)."""
    new = set(new_rows)
    return [p for p in prefixes if p in dirty or p in new]


# ---------------------------------------------------------------------------
# backends


class ScalarBgpTableBackend:
    """The seam's identity element: every call delegates to the engine's
    verbatim scalar decision process (the bit-identical oracle)."""

    name = "scalar"

    def begin_batch(self, engine, afs, table, prefixes) -> None:
        return None

    def note_route_change(self, afs: str, prefix: str) -> None:
        return None

    def best_path(self, engine, afs, table, prefix, dest):
        return engine._best_path(table, dest)

    def compute_nexthops(self, engine, afs, prefix, dest, best):
        return engine._compute_nexthops(afs, dest, best)

    def stats(self) -> dict:
        return {"backend": self.name}


@dataclass
class _DevTable:
    """Per-address-family resident planes + host-side interners."""

    planes: torch.Tensor  # (N_LANES, cap_rows, cap_cols) int32
    cap_rows: int
    cap_cols: int
    rows: dict = field(default_factory=dict)  # prefix -> row index
    cols: dict = field(default_factory=dict)  # addr -> col index (>= 1)
    fas_ids: _Interner = field(default_factory=_Interner)
    path_ids: _Interner = field(default_factory=_Interner)
    nh_ids: _Interner = field(default_factory=_Interner)
    poisoned: set = field(default_factory=set)  # prefixes stuck on scalar
    scatters: int = 0
    grows: int = 0


class TorchBgpTableBackend:
    """Device best-path/multipath over resident packed planes, with the
    per-prefix poison escape hatch to the scalar oracle.  One instance serves
    every address family of one engine (planes are keyed per afs).

    Duck-typed on the engine, its tables and routes: it serves
    :class:`~holo_tpu_torch.protocols.bgp_engine.DecisionEngine` and
    ``holo_tpu``'s ``BgpEngine(table_backend=)`` alike, and builds the best
    route with the class of the route it was given."""

    name = "torch"

    def __init__(self, device=None, breaker: CircuitBreaker | None = None):
        self.device = resolve_device(device)
        self.breaker = breaker if breaker is not None else CircuitBreaker("bgp-table")
        self._tables: dict[str, _DevTable] = {}
        self._dirty: dict[str, set] = {}
        self._batch: dict[str, dict | None] = {}
        self._shapes: set = set()  # distinct dispatch shapes
        self._dispatches = 0
        self._fallbacks = 0
        # Prefixes each hook served, by source: "best-device",
        # "best-poisoned", "best-host" and the same for "nexthops".  Only a
        # poisoned prefix, or on the CPU a batch the breaker's fallback
        # served, comes from the oracle; off the CPU any other miss raises.
        self.served: Counter = Counter()
        _register_backend(self)

    # -- engine hooks ------------------------------------------------

    def note_route_change(self, afs: str, prefix: str) -> None:
        """Content changed under ``prefix`` — its device row is stale.
        NHT-only churn does NOT come through here, which is what keeps
        IGP convergence from re-marshaling the table."""
        self._dirty.setdefault(afs, set()).add(prefix)

    def begin_batch(self, engine, afs, table, prefixes) -> None:
        self._batch[afs] = None
        prefixes = list(prefixes)
        if not prefixes:
            return

        def _device():
            return self._device_batch(engine, afs, table, prefixes)

        def _fallback():
            self._fallbacks += 1
            _FALLBACK.labels(context="bgp.decision").inc()
            return None

        # The oracle serves a failed batch only on the CPU, where it computes
        # the same bits; on the card the failure re-raises once counted.
        serves = self.device.type == "cpu"
        self._batch[afs] = self.breaker.call(
            _device, _fallback if serves else None, context="bgp.decision"
        )

    def best_path(self, engine, afs, table, prefix, dest):
        res = self._verdicts(afs, prefix, "best")
        if res is None:
            _FALLBACK.labels(context="bgp.prefix").inc()
            return engine._best_path(table, dest)
        best_col, reasons, _elig, _mp_sel = res
        dt = self._tables[afs]
        best_route = None
        expect_best = best_col >= 0
        for addr, adj in dest.adj_rib.items():
            route = adj.in_post
            if route is None:
                continue
            col = dt.cols.get(addr)
            if col is None:  # never marshaled: state drifted — bail out
                self._host(afs, prefix, "best", f"peer {addr} has no column")
                return engine._best_path(table, dest)
            best_route = self._apply_cell(
                engine, table, route, col, best_col, reasons, best_route
            )
        if dest.redistribute is not None:
            best_route = self._apply_cell(
                engine,
                table,
                dest.redistribute,
                LOCAL_COL,
                best_col,
                reasons,
                best_route,
            )
        if best_route is None and expect_best:  # drift between scatter and readback
            self._host(afs, prefix, "best", f"column {best_col} holds no route")
            return engine._best_path(table, dest)
        self.served["best-device"] += 1
        if not expect_best:
            return None
        return type(best_route)(
            origin=best_route.origin,
            attrs=best_route.attrs,
            route_type=best_route.route_type,
            igp_cost=best_route.igp_cost,
        )

    @staticmethod
    def _apply_cell(engine, table, route, col, best_col, reasons, best_route):
        """Replay the oracle's per-candidate side effects (reason
        strings are YANG-observable state) from the device verdicts."""
        route.reject_reason = None
        route.ineligible_reason = None
        if route.attrs.as_path_contains(engine.asn):
            route.ineligible_reason = "as-loop"
            return best_route
        if not route.origin.is_local():
            nexthop = route.attrs.ll_nexthop or route.attrs.nexthop
            nht = table.nht.get(nexthop)
            route.igp_cost = nht.metric if nht else None
            if route.igp_cost is None:
                route.ineligible_reason = "unresolvable"
                return best_route
        if col == best_col:
            return route
        code = int(reasons[col])
        if code:
            route.reject_reason = REJECT_REASONS[code]
        return best_route

    def compute_nexthops(self, engine, afs, prefix, dest, best):
        if best.origin.is_local():
            return None
        mp = engine.multipath.get(afs)
        if not mp or not mp.get("enabled"):
            return frozenset({best.attrs.ll_nexthop or best.attrs.nexthop})
        res = self._verdicts(afs, prefix, "nexthops")
        if res is None:
            return engine._compute_nexthops(afs, dest, best)
        _best_col, _reasons, _elig, mp_sel = res
        dt = self._tables[afs]
        nexthops = []
        for addr, adj in dest.adj_rib.items():
            route = adj.in_post
            col = dt.cols.get(addr)
            if route is None or col is None or not mp_sel[col]:
                continue
            nexthops.append(route.attrs.ll_nexthop or route.attrs.nexthop)
        self.served["nexthops-device"] += 1
        return frozenset(nexthops)

    def _verdicts(self, afs, prefix, hook):
        """The batch's device verdicts for ``prefix``, or None where the
        oracle serves it: a poisoned prefix (the lane contract), or on the
        CPU a batch that the breaker's fallback served."""
        batch = self._batch.get(afs)
        res = batch.get(prefix) if batch else None
        if res is None:
            if batch is not None and prefix in self._tables[afs].poisoned:
                self.served[f"{hook}-poisoned"] += 1
            else:
                self._host(afs, prefix, hook, "no device verdict")
        return res

    def _host(self, afs, prefix, hook, why) -> None:
        """Count a prefix the oracle serves though it is not poisoned.  Off
        the CPU that is a fault: the card decides every other prefix."""
        if self.device.type != "cpu":
            raise RuntimeError(f"bgp table {afs} {prefix}: {why} ({hook})")
        self.served[f"{hook}-host"] += 1

    # -- device batch ------------------------------------------------

    def _ensure_table(self, afs, n_rows: int, n_cols: int) -> _DevTable:
        dt = self._tables.get(afs)
        if dt is None:
            cap_r, cap_c = max(4, _pow2(n_rows)), max(2, _pow2(n_cols))
            planes = torch.zeros((N_LANES, cap_r, cap_c), dtype=torch.int32,
                                 device=self.device)
            dt = self._tables[afs] = _DevTable(planes, cap_r, cap_c)
            return dt
        if n_rows > dt.cap_rows or n_cols > dt.cap_cols:
            cap_r = max(dt.cap_rows, _pow2(n_rows))
            cap_c = max(dt.cap_cols, _pow2(n_cols))
            dt.planes = grow_planes(dt.planes, cap_r - dt.cap_rows, cap_c - dt.cap_cols)
            dt.cap_rows, dt.cap_cols = cap_r, cap_c
            dt.grows += 1
        return dt

    def _device_batch(self, engine, afs, table, prefixes) -> dict:
        faults.crashpoint("bgp.dispatch")
        dirty = self._dirty.setdefault(afs, set())

        # Column/row discovery before sizing the planes.
        dt0 = self._tables.get(afs)
        known_rows = dt0.rows if dt0 else {}
        known_cols = dt0.cols if dt0 else {}
        new_rows = [p for p in prefixes if p not in known_rows]
        addrs = set(known_cols)
        for p in prefixes:
            dest = table.prefixes.get(p)
            if dest is not None:
                addrs.update(dest.adj_rib)
        dt = self._ensure_table(
            afs, len(known_rows) + len(new_rows), len(addrs) + 1
        )
        for p in new_rows:
            dt.rows[p] = len(dt.rows)
        for addr in sorted(addrs - set(dt.cols), key=_addr_key):
            dt.cols[addr] = len(dt.cols) + 1  # col 0 is the local slot

        marshal = _marshal_list(prefixes, dirty, new_rows)
        rows_np, idx_np, batch_poison = self._marshal_rows(
            engine, table, dt, marshal
        )
        dirty.difference_update(marshal)
        dt.poisoned.difference_update(marshal)
        dt.poisoned.update(batch_poison)

        live = [
            p
            for p in prefixes
            if p not in dt.poisoned and p in dt.rows
        ]
        mp_cfg = engine.multipath.get(afs) or {}
        kind = "cold" if len(marshal) == len(prefixes) else "incremental"
        t0 = profiling.clock()
        with profiling.dispatch_context(kind="bgp", engine="fold", bucket=None), \
                telemetry.span("bgp.table.dispatch", kind=kind, backend="torch"):
            with profiling.stage("bgp.table", "marshal"):
                with sanctioned_transfer("bgp.table.marshal"):
                    if len(idx_np):
                        scatter_rows(dt.planes, self._up(idx_np), self._up(rows_np))
                        # The kernel writes the resident lanes through a raw
                        # pointer: the guard's version bump is explicit.
                        note_donated("bgp.table.scatter", dt.planes, raw=True)
                        dt.scatters += 1
                        _UPDATE_ROWS.labels(kind=kind).inc(len(idx_np))
                    args = self._dispatch_args(dt, table, live, mp_cfg)
            self._shapes.add(
                ("decide", dt.cap_rows, dt.cap_cols, args[1].shape[0], args[5].shape[0])
            )
            clk = profiling.device_clock("bgp.table", on=self.device)
            out = decide(*args)
            profiling.sync(clk)
            with profiling.stage("bgp.table", "device", clock=clk):
                faults.delaypoint("bgp.dispatch")
            with profiling.stage("bgp.table", "readback"):
                with sanctioned_transfer("bgp.table.unmarshal"):
                    best_col, reasons, elig, mp_sel = (x.cpu().numpy() for x in out)
        profiling.settle(clk, profiling.clock() - t0)
        self._dispatches += 1
        _DISPATCH_TOTAL.labels(kind=kind).inc()
        _RECOMPUTED.labels(kind=kind).inc(len(live))
        best = best_col.tolist()
        return {
            p: (best[i], reasons[i], elig[i], mp_sel[i])
            for i, p in enumerate(live)
        }

    def _up(self, array: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(array).to(self.device)

    def _marshal_rows(self, engine, table, dt, marshal):
        """Host-side lane packing for the changed rows.  A cell the
        contract cannot represent poisons its prefix (scalar fallback)
        and zeroes the row so stale device state can never win."""
        n_cols = dt.cap_cols
        rows_np = np.zeros((N_LANES, len(marshal), n_cols), np.int32)
        idx_np = np.zeros((len(marshal),), np.int32)
        poison = set()
        for i, prefix in enumerate(marshal):
            idx_np[i] = dt.rows[prefix]
            dest = table.prefixes.get(prefix)
            if dest is None:
                continue  # withdrawn everywhere: row stays zero
            try:
                for addr, adj in dest.adj_rib.items():
                    if adj.in_post is None:
                        continue
                    rows_np[:, i, dt.cols[addr]] = _encode_cell(
                        adj.in_post,
                        addr,
                        engine.asn,
                        dt.fas_ids,
                        dt.path_ids,
                        dt.nh_ids,
                    )
                if dest.redistribute is not None:
                    rows_np[:, i, LOCAL_COL] = _encode_cell(
                        dest.redistribute,
                        None,
                        engine.asn,
                        dt.fas_ids,
                        dt.path_ids,
                        dt.nh_ids,
                    )
            except MarshalError:
                rows_np[:, i, :] = 0
                poison.add(prefix)
                _FALLBACK.labels(context="bgp.marshal").inc()
        return rows_np, idx_np, poison

    def _dispatch_args(self, dt, table, live, mp_cfg):
        n_cols = dt.cap_cols
        # Candidate order: peers by address rank, unassigned columns
        # (never eligible) next, local column strictly last.
        by_addr = sorted(dt.cols.items(), key=lambda kv: _addr_key(kv[0]))
        order_np = np.zeros((n_cols,), np.int32)
        addr_rank_np = np.zeros((n_cols,), np.int32)
        has_addr_np = np.zeros((n_cols,), np.int32)
        pos = 0
        assigned = {LOCAL_COL}
        for rank, (_addr, col) in enumerate(by_addr):
            order_np[pos] = col
            addr_rank_np[col] = rank
            has_addr_np[col] = 1
            assigned.add(col)
            pos += 1
        for col in range(n_cols):
            if col not in assigned:
                order_np[pos] = col
                pos += 1
        order_np[pos] = LOCAL_COL

        k = max(1, _pow2(len(dt.nh_ids)))
        nht_enc_np = np.full((k,), _bias(0), np.int32)
        nht_res_np = np.zeros((k,), np.int32)
        for nh_id, addr in enumerate(dt.nh_ids.values):
            nht = table.nht.get(addr)
            if nht is not None and nht.metric is not None:
                nht_enc_np[nh_id] = _bias(_u32(nht.metric, "metric") + 1)
                nht_res_np[nh_id] = 1

        m = max(1, _pow2(len(live)))
        idx_np = np.zeros((m,), np.int32)
        for i, p in enumerate(live):
            idx_np[i] = dt.rows[p]
        mp_np = np.asarray(
            [
                1 if mp_cfg.get("allow_multiple_as") else 0,
                int(mp_cfg.get("ibgp_max", 1)),
                int(mp_cfg.get("ebgp_max", 1)),
            ],
            np.int32,
        )
        return (
            dt.planes,
            self._up(idx_np),
            self._up(order_np),
            self._up(addr_rank_np),
            self._up(has_addr_np),
            self._up(nht_enc_np),
            self._up(nht_res_np),
            self._up(mp_np),
        )

    # -- state surface ----------------------------------------------

    def stats(self) -> dict:
        """The ``holo-telemetry/bgp-table`` leaf payload (``holo_tpu``'s
        keys; ``compiled-shapes`` counts distinct dispatch shapes)."""
        tables = {}
        resident_bytes = 0
        for afs, dt in self._tables.items():
            resident_bytes += N_LANES * dt.cap_rows * dt.cap_cols * 4
            tables[afs] = {
                "rows": len(dt.rows),
                "cols": len(dt.cols),
                "cap-rows": dt.cap_rows,
                "cap-cols": dt.cap_cols,
                "scatters": dt.scatters,
                "grows": dt.grows,
                "poisoned": len(dt.poisoned),
            }
        return {
            "backend": self.name,
            "dispatches": self._dispatches,
            "fallbacks": self._fallbacks,
            "compiled-shapes": len(self._shapes),
            "resident-bytes": resident_bytes,
            "tables": tables,
        }


# Live-backend registry for the telemetry surface (weakrefs: a backend
# dropped with its engine must not leak through it).
_BACKENDS: list = []


def _register_backend(backend) -> None:
    _BACKENDS.append(weakref.ref(backend))


def live_backends() -> list:
    """The live BGP table backends (the residency ledger's bgp-table row)."""
    return [b for b in (ref() for ref in _BACKENDS) if b is not None]


def backends_stats() -> list[dict]:
    out = []
    dead = []
    for ref in _BACKENDS:
        backend = ref()
        if backend is None:
            dead.append(ref)
        else:
            out.append(backend.stats())
    for ref in dead:
        _BACKENDS.remove(ref)
    return out


# ---------------------------------------------------------------------------
# the bgp.py `_decision` boundary: that rank tuple has no conditional
# MED rung, so it IS a clean total order — a packed-lane stable lexsort
# is argsort-exact there.

#: per-lane encodings for bgp.py's rank tuple
#: (-local_pref, path len, origin, med, peer class, router id).
_RANK_SPEC = ("neg_u32", "u31", "u31", "u32", "u31", "u32")


def rank_sort(lanes: torch.Tensor) -> torch.Tensor:
    """The stable lexicographic order of the columns of ``lanes`` (L, n),
    lane 0 the primary key (``jnp.lexsort`` of the lanes reversed): one
    stable sort a lane, from the last lane to the first."""
    perm = torch.arange(lanes.shape[1], device=lanes.device)
    for lane in reversed(range(lanes.shape[0])):
        perm = perm[torch.sort(lanes[lane][perm], stable=True).indices]
    return perm


class DeviceRankBackend:
    """Batched stable sort of ``bgp.Bgp._decision`` rank tuples on the card.
    ``rank_order`` returns the sort permutation, or ``None`` when a tuple
    falls outside the lane contract (counted in ``refusals``) — the caller
    then runs its own ``list.sort`` (the oracle).  A device failure is
    counted by the breaker; the caller's sort serves it only on the CPU."""

    name = "torch-rank"

    def __init__(self, device=None, breaker: CircuitBreaker | None = None):
        self.device = resolve_device(device)
        self.breaker = breaker if breaker is not None else CircuitBreaker("bgp-rank")
        self.refusals = 0

    def _encode(self, ranks) -> np.ndarray | None:
        n = len(ranks)
        lanes = np.full((len(_RANK_SPEC), _pow2(max(1, n))), 2**31 - 1, np.int32)
        try:
            for i, rank in enumerate(ranks):
                for j, (spec, v) in enumerate(zip(_RANK_SPEC, rank)):
                    if spec == "neg_u32":  # v = -lp, lp in [0, 2**32)
                        lanes[j, i] = _bias(_u32(-v, "neg lane") ^ _U32)
                    elif spec == "u32":
                        lanes[j, i] = _bias(_u32(v, "u32 lane"))
                    else:  # u31: must fit int32 directly
                        v = int(v)
                        if not 0 <= v < _BIAS:
                            raise MarshalError("u31 lane out of range")
                        lanes[j, i] = v
        except MarshalError:
            self.refusals += 1
            _FALLBACK.labels(context="bgp.rank").inc()
            return None
        return lanes

    def rank_order(self, ranks) -> list[int] | None:
        if len(ranks) < 2:
            return list(range(len(ranks)))
        lanes = self._encode(ranks)
        if lanes is None:
            return None

        def _device():
            with telemetry.span("bgp.rank.dispatch", kind="rank", backend="torch"):
                with sanctioned_transfer("bgp.rank.marshal"):
                    up = torch.from_numpy(lanes).to(self.device)
                order = rank_sort(up)
                with sanctioned_transfer("bgp.rank.unmarshal"):
                    order = order.cpu().tolist()
            _DISPATCH_TOTAL.labels(kind="rank").inc()
            return [i for i in order if i < len(ranks)]

        def _fallback():
            _FALLBACK.labels(context="bgp.rank").inc()
            return None

        serves = self.device.type == "cpu"
        return self.breaker.call(_device, _fallback if serves else None, context="bgp.rank")
