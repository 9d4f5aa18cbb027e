"""The BGP table's fold kernel beside its plain PyTorch version.

:func:`bgp_fold` wraps ``csrc/bgp_kernels.cu``: the RFC 4271 §9.1.2.2
decision ladder over the packed Adj-RIB-In planes of ``ops.bgp_table``, for
the queued rows ``idx``.  It stands for ``_fold_planes`` + ``_decide_fn`` of
``holo_tpu/ops/bgp_table.py`` (``:294-426``), an XLA loop fusion with no
Pallas kernel.  Given CPU tensors it computes :func:`fold_plain` (JAX's
``fori_loop`` step for step in torch ops); given CUDA tensors it launches the
kernel on the current stream or raises.  It never falls back.
:data:`launches` counts kernel launches.

The kernel is a pipeline in one block an SM: a producer warp copies the
queued rows raw into a ring of :data:`STAGES` shared-memory stages (TMA bulk
copies where ``4 C`` is a multiple of 16, ``cp.async`` elsewhere); derive
warps lay each row out in candidate order and scan its eligible (LP, L1)
pairs, settling at once every position that loses at those two rungs; fold
warps walk only the rest (one lane a row) and write the group's outputs in
coalesced runs.  :func:`geometry` picks the rows a fold warp takes, the
tile rows, the fold warps and the grid; :func:`smem_bytes` is the kernel's
shared-memory layout.  On the CPU the same walk is modelled in numpy by
``tests/test_torch_bgp_table.py`` (``walk_fold``) and held to
:func:`fold_plain` and to JAX.

Inputs (int32): ``planes`` (13, R, C) (lanes in ``ops.bgp_table`` order),
``idx`` [M] rows of ``planes`` (in [0, R); repeats allowed), ``order`` [C]
the candidate order (a permutation of the columns), ``addr_rank`` /
``has_addr`` [C], ``nht_enc`` / ``nht_res`` [K] (K >= 1), ``mp`` [3] =
(allow_multiple_as, ibgp_max, ebgp_max).  Outputs, as JAX's: ``best_col``
int32 [M] (-1 where no column is eligible), ``reasons`` int32 [M, C],
``elig`` bool [M, C], ``mp_sel`` bool [M, C].
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from holo_tpu_torch.kernels import build

# Lanes and reject-reason codes (ops.bgp_table's, which imports them here).
(
    L_LP, L_L1, L_MED, L_FAS, L_RT, L_IGP, L_RID, L_HASRID, L_NH, L_PATH, L_OCC, L_LOOP,
    L_LOCAL,
) = range(13)
N_LANES = 13
LOCAL_COL = 0
R_LP, R_PLEN, R_ORIGIN, R_MED, R_RT, R_IGP, R_RID, R_ADDR = range(1, 9)

STAGES = 3  # the ring of raw tiles a block keeps in shared memory
TILE_ROWS = 8  # rows a raw tile holds (fewer where a group is smaller)
GROUP_ROWS = 32  # rows a fold warp takes at once, one a lane
FOLD_WARPS = 4  # the most fold warps a block (csrc/bgp_kernels.cu)
MAX_BLOCKS_PER_SM = 2  # 416 threads a block (csrc/bgp_kernels.cu)
SMEM_LIMIT = 232_448  # dynamic shared memory one block may take on sm_90
SM_SHARED = 233_472  # shared memory of one SM (228 KB) ...
BLOCK_RESERVE = 1024  # ... of which the runtime keeps 1 KB a block
H100_SMS = 132
_STAGED = 9  # int32 words a derived cell keeps

#: kernel launches since the last :func:`reset_launches`
launches = {"bgp_fold": 0}


class Geometry(NamedTuple):
    """A launch of the fold: rows a fold warp takes (a group), rows a raw
    tile holds, ring stages, fold warps a block, blocks, shared bytes a
    block, and the copy path ("tma" or "cp.async")."""

    group_rows: int
    tile_rows: int
    stages: int
    warps: int
    blocks: int
    smem_bytes: int
    copy: str


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _align16(n: int) -> int:
    return (n + 15) & ~15


def smem_bytes(cols: int, group_rows: int, tile_rows: int, stages: int, warps: int) -> int:
    """Shared-memory bytes of one block (``layout`` in csrc/bgp_kernels.cu):
    the barriers (two a stage, two a fold warp), the raw ring, and for each
    fold warp its derived cells
    (row stride ``cols | 1``), reason rows and eligibility and selection
    words (``ceil(cols / 32) | 1`` a row); then the four position vectors."""
    stride, words = cols | 1, ((cols + 31) // 32) | 1
    return sum(_align16(n) for n in (
        16 * (stages + FOLD_WARPS),
        4 * stages * N_LANES * tile_rows * cols,
        4 * warps * _STAGED * group_rows * stride,
        4 * warps * group_rows * cols,
        4 * warps * group_rows * words,
        4 * warps * group_rows * words,
        16 * cols,
    ))


def geometry(m: int, cols: int, n_sms: int = H100_SMS) -> Geometry:
    """The launch of a fold of ``m`` rows x ``cols`` columns on ``n_sms``
    SMs: the group rows (a power of two, at most :data:`GROUP_ROWS`) and
    fold warps that keep the most rows folding in one block's shared memory
    (more warps at a tie), the group halved while the groups would leave an
    SM without one; as many blocks as the SMs hold, at most one a group.
    Raises where one row does not fit."""
    best = None
    for group in (32, 16, 8, 4, 2, 1):
        for warps in range(FOLD_WARPS, 0, -1):
            if smem_bytes(cols, group, min(group, TILE_ROWS), STAGES, warps) <= SMEM_LIMIT:
                if best is None or (warps * group, warps) > (best[0] * best[1], best[1]):
                    best = (group, warps)
                break
    if best is None:
        raise ValueError(f"{cols} peer columns do not fit one staged row in shared memory")
    group, warps = best
    while group > 1 and -(-m // group) < n_sms:
        group //= 2
    tile = min(group, TILE_ROWS)
    smem = smem_bytes(cols, group, tile, STAGES, warps)
    per_sm = max(1, min(MAX_BLOCKS_PER_SM, SM_SHARED // (smem + BLOCK_RESERVE)))
    blocks = max(1, min(-(-m // group), per_sm * n_sms))
    return Geometry(group, tile, STAGES, warps, blocks, smem,
                    "tma" if cols % 4 == 0 else "cp.async")


_SMS: dict = {}


def _sm_count(dev: torch.device) -> int:
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    if index not in _SMS:
        _SMS[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _SMS[index]


def _derive(sub, nht_enc, nht_res):
    """(igp, elig) [M, C]: the derived IGP lane and eligibility
    (``bgp_table.py:310-316``)."""
    occ = sub[L_OCC] != 0
    loop = sub[L_LOOP] != 0
    local = sub[L_LOCAL] != 0
    nhc = sub[L_NH].clamp(0, nht_enc.shape[0] - 1).long()
    resolved = local | (nht_res[nhc] != 0)
    igp = torch.where(local, sub[L_IGP], nht_enc[nhc])
    return igp, occ & ~loop & resolved


def fold_plain(sub, order, addr_rank, has_addr, nht_enc, nht_res, mp):
    """``_fold_planes`` step for step: the fold over the candidate order
    (bottom-up ladder, one ``where`` per rung), then the multipath test and
    the cap in candidate order.  ``sub`` is (13, M, C)."""
    m, n_cols = sub.shape[1], sub.shape[2]
    dev = sub.device
    igp, elig = _derive(sub, nht_enc, nht_res)
    rows = torch.arange(m, device=dev)
    best_col = torch.full((m,), -1, dtype=torch.int32, device=dev)
    has_best = torch.zeros(m, dtype=torch.bool, device=dev)
    b = torch.zeros((N_LANES, m), dtype=torch.int32, device=dev)
    b_addr = torch.zeros(m, dtype=torch.int32, device=dev)
    b_hasaddr = torch.zeros(m, dtype=torch.bool, device=dev)
    b_igp = torch.zeros(m, dtype=torch.int32, device=dev)
    reasons = torch.zeros((m, n_cols), dtype=torch.int32, device=dev)
    for c in order.tolist():
        cand = sub[:, :, c]
        igp_c, elig_c = igp[:, c], elig[:, c]
        a_addr = addr_rank[c]
        a_has = has_addr[c] != 0
        better = torch.zeros(m, dtype=torch.bool, device=dev)
        reason = torch.full((m,), R_ADDR, dtype=torch.int32, device=dev)
        addr_app = a_has & b_hasaddr & (a_addr != b_addr)
        better = torch.where(addr_app, a_addr < b_addr, better)
        rid_app = ((cand[L_HASRID] & b[L_HASRID]) != 0) & (cand[L_RID] != b[L_RID])
        better = torch.where(rid_app, cand[L_RID] < b[L_RID], better)
        reason = torch.where(rid_app, R_RID, reason)
        igp_d = igp_c != b_igp
        better = torch.where(igp_d, igp_c < b_igp, better)
        reason = torch.where(igp_d, R_IGP, reason)
        rt_d = cand[L_RT] != b[L_RT]
        better = torch.where(rt_d, cand[L_RT] > b[L_RT], better)
        reason = torch.where(rt_d, R_RT, reason)
        med_app = (cand[L_FAS] == b[L_FAS]) & (cand[L_MED] != b[L_MED])
        better = torch.where(med_app, cand[L_MED] < b[L_MED], better)
        reason = torch.where(med_app, R_MED, reason)
        l1_d = cand[L_L1] != b[L_L1]
        better = torch.where(l1_d, cand[L_L1] < b[L_L1], better)
        plen_d = (cand[L_L1] >> 2) != (b[L_L1] >> 2)
        reason = torch.where(l1_d & plen_d, R_PLEN, torch.where(l1_d, R_ORIGIN, reason))
        lp_d = cand[L_LP] != b[L_LP]
        better = torch.where(lp_d, cand[L_LP] < b[L_LP], better)
        reason = torch.where(lp_d, R_LP, reason)

        take = elig_c & (~has_best | better)
        lose = elig_c & has_best
        # JAX writes the reason over the whole [M, C] plane where the loser's
        # column matches; a scatter to the loser's cell is the same step.
        loser = torch.where(lose & better, best_col, c).long()
        keep = reasons[rows, loser]
        reasons[rows, loser] = torch.where(lose, reason, keep)
        b = torch.where(take[None, :], cand, b)
        b_addr = torch.where(take, a_addr, b_addr)
        b_hasaddr = torch.where(take, a_has, b_hasaddr)
        b_igp = torch.where(take, igp_c, b_igp)
        best_col = torch.where(take, c, best_col)
        has_best = has_best | elig_c

    # Multipath (bgp_table.py:388-415): equality against the winner, then the
    # first max_paths matches in candidate order, the local column excluded.
    fas_eq = sub[L_FAS] == b[L_FAS][:, None]
    med_ok = ~fas_eq | (sub[L_MED] == b[L_MED][:, None])
    is_ext = b[L_RT][:, None] == 1
    branch = torch.where(is_ext, (mp[0] != 0) | fas_eq, sub[L_PATH] == b[L_PATH][:, None])
    cols = torch.arange(n_cols, device=dev)[None, :]
    eq = (
        elig
        & (cols != LOCAL_COL)
        & has_best[:, None]
        & (sub[L_LP] == b[L_LP][:, None])
        & (sub[L_L1] == b[L_L1][:, None])
        & (sub[L_RT] == b[L_RT][:, None])
        & (igp == b_igp[:, None])
        & med_ok
        & branch
    )
    maxp = torch.where(b[L_RT] == 0, mp[1], mp[2])
    order_l = order.long()
    eq_ord = eq[:, order_l]
    csum = torch.cumsum(eq_ord.to(torch.int32), dim=1)
    mp_sel = torch.zeros_like(eq)
    mp_sel[:, order_l] = eq_ord & (csum <= maxp[:, None])
    return best_col, reasons, elig, mp_sel


def decide_plain(planes, idx, order, addr_rank, has_addr, nht_enc, nht_res, mp):
    """``_decide_fn``: the fold over the rows ``idx`` of ``planes``."""
    return fold_plain(planes[:, idx.long(), :], order, addr_rank, has_addr, nht_enc,
                      nht_res, mp)


def bgp_fold(planes, idx, order, addr_rank, has_addr, nht_enc, nht_res, mp):
    """(best_col, reasons, elig, mp_sel) of the rows ``idx`` of ``planes``
    (``_decide_fn``, ``bgp_table.py:423-426``); see the module docstring."""
    if not build.on_card(planes, idx, order, addr_rank, has_addr, nht_enc, nht_res, mp):
        return decide_plain(planes, idx, order, addr_rank, has_addr, nht_enc, nht_res, mp)
    lanes, n_rows, n_cols = planes.shape
    m = idx.shape[0]
    if (lanes != N_LANES or idx.dim() != 1 or order.shape != (n_cols,)
            or addr_rank.shape != (n_cols,) or has_addr.shape != (n_cols,)
            or nht_enc.dim() != 1 or nht_enc.shape[0] < 1 or nht_res.shape != nht_enc.shape
            or mp.shape != (3,) or n_rows < 1):
        raise ValueError(
            f"bgp_fold inputs disagree: planes {tuple(planes.shape)}, idx {tuple(idx.shape)}, "
            f"order {tuple(order.shape)}, addr_rank {tuple(addr_rank.shape)}, has_addr "
            f"{tuple(has_addr.shape)}, nht_enc {tuple(nht_enc.shape)}, nht_res "
            f"{tuple(nht_res.shape)}, mp {tuple(mp.shape)}"
        )
    dev = planes.device
    best_col = torch.empty(m, dtype=torch.int32, device=dev)
    reasons = torch.empty((m, n_cols), dtype=torch.int32, device=dev)
    elig = torch.empty((m, n_cols), dtype=torch.bool, device=dev)
    mp_sel = torch.empty((m, n_cols), dtype=torch.bool, device=dev)
    if m:
        geo = geometry(m, n_cols, _sm_count(dev))
        build.launch("holo_bgp_fold", planes, idx, order, addr_rank, has_addr, nht_enc,
                     nht_res, mp, best_col, reasons, elig, mp_sel, n_rows, n_cols, m,
                     nht_enc.shape[0], geo.group_rows, geo.tile_rows, geo.stages, geo.warps,
                     geo.blocks)
        launches["bgp_fold"] += 1
    return best_col, reasons, elig, mp_sel
