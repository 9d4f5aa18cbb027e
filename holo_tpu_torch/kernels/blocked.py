"""The blocked SPF engine's CUDA kernels, each beside its plain PyTorch version.

Three wrappers -- :func:`relax`, :func:`dmin_parent`, :func:`nh_or` -- over
``csrc/blocked_kernels.cu`` (which names the TPU kernels each one
replaces).  A wrapper given CPU tensors computes the plain version; given
CUDA tensors it launches the kernel on the current stream or raises.  It
never falls back.  :data:`launches` counts kernel launches per wrapper.

Plane conventions (all int32, CAP = 1<<28 as infinity):

- ``w`` [P, S, S]: block pair p holds edge costs (bsrc[p]*S + u) ->
  (bdst[p]*S + v) at ``w[p, u, v]``, CAP where there is no edge;
- ``edges`` = (cptr [P, S+1], crow [nnz], cw [nnz], border [nb]): the
  entries < CAP of ``w`` as a per-pair CSC (``ops.blocked.edge_planes``)
  and the order in which the kernels take the destination blocks
  (``ops.blocked.block_order``).  The kernels walk only these and need
  them on the card; the plain versions read ``w``;
- ``bsrc``/``bdst`` [P]: source / destination block ids, sorted by
  ``bdst``; ``seg`` [nb + 1]: pairs of destination block bd are
  ``seg[bd] .. seg[bd+1]``;
- vertex planes are [N_pad, lanes] with N_pad = nb * S.
"""

from __future__ import annotations

import torch

from holo_tpu_torch.kernels import build, work

S = 256
CAP = 1 << 28
PBIG = 1 << 27
_UC = 32  # source rows per chunk in the plain versions (bounds memory)

#: kernel launches per wrapper since the last :func:`reset_launches`
launches = {"relax": 0, "dmin_parent": 0, "nh_or": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _check_planes(w, seg, dist_rows: int) -> int:
    nb = seg.shape[0] - 1
    if w.shape[1:] != (S, S) or dist_rows != nb * S:
        raise ValueError(
            f"plane shapes disagree: w {tuple(w.shape)}, {nb} destination "
            f"blocks, {dist_rows} vertex rows"
        )
    return nb


def _check_edges(w, nb: int, edges) -> tuple:
    if edges is None:
        raise ValueError("the card walks the compact edge planes: pass "
                         "edges=(cptr, crow, cw, border), as ops.blocked.edges_of gives")
    cptr, crow, cw, border = edges
    if (
        cptr.shape != (w.shape[0], S + 1)
        or crow.dim() != 1
        or crow.shape != cw.shape
        or border.shape != (nb,)
    ):
        raise ValueError(
            f"edge planes disagree: w {tuple(w.shape)}, cptr {tuple(cptr.shape)}, "
            f"crow {tuple(crow.shape)}, cw {tuple(cw.shape)}, border "
            f"{tuple(border.shape)} for {nb} blocks"
        )
    return edges


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path, and the card's reference).


def or_reduce(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Bitwise OR over ``dim`` (torch has no OR reduction): halving folds."""
    x = x.movedim(dim, 0)
    while x.shape[0] > 1:
        half = x.shape[0] // 2
        folded = x[:half] | x[half : 2 * half]
        if x.shape[0] % 2:
            folded[0] |= x[-1]
        x = folded
    return x[0]


def _pair_loop(w, bsrc, bdst, out, step):
    """out[dst rows] = step(out[dst rows], w chunk [uc,S,1], src row slice)
    over every block pair and every chunk of its source rows, in pair order."""
    for p, (bs, bd) in enumerate(zip(bsrc.tolist(), bdst.tolist())):
        rows_d = slice(bd * S, (bd + 1) * S)
        for u0 in range(0, S, _UC):
            rows_s = slice(bs * S + u0, bs * S + u0 + _UC)
            out[rows_d] = step(out[rows_d], w[p, u0 : u0 + _UC, :, None], rows_s, rows_d)
    return out


def _dag(wc, du, dv):
    """DAG-parent test: edge present, source reached, tight."""
    return (wc < CAP) & (du < CAP) & (wc + du == dv)


def relax_plain(w, bsrc, bdst, dist):
    def step(acc, wc, rs, rd):
        return torch.minimum(acc, (wc + dist[rs][:, None, :]).amin(0))

    return _pair_loop(w, bsrc, bdst, dist.clone(), step)


def dmin_plain(w, bsrc, bdst, dist):
    def step(acc, wc, rs, rd):
        du = dist[rs][:, None, :]
        dag = _dag(wc, du, dist[rd][None])
        return torch.minimum(acc, torch.where(dag, du, CAP).amin(0))

    return _pair_loop(w, bsrc, bdst, torch.full_like(dist, CAP), step)


def parent_plain(w, bsrc, bdst, dist, dmin, orig_id):
    def step(acc, wc, rs, rd):
        du = dist[rs][:, None, :]
        dag = _dag(wc, du, dist[rd][None]) & (du == dmin[rd][None])
        oid = orig_id[rs][:, None, None]
        return torch.minimum(acc, torch.where(dag, oid, PBIG).amin(0))

    return _pair_loop(w, bsrc, bdst, torch.full_like(dist, PBIG), step)


def nh_or_plain(w, bsrc, bdst, dist, gate, nh, direct):
    words = nh.shape[1] // dist.shape[1]
    dist_cat = dist.repeat(1, words)  # lane l = word * B + b
    gate_cat = gate.repeat(1, words)

    def step(acc, wc, rs, rd):
        du = dist_cat[rs][:, None, :]
        dag = _dag(wc, du, dist_cat[rd][None]) & (gate_cat[rs][:, None, :] > 0)
        return acc | or_reduce(torch.where(dag, nh[rs][:, None, :], 0), 0)

    return _pair_loop(w, bsrc, bdst, direct.clone(), step)


# ---------------------------------------------------------------------------
# Wrappers: CPU tensors -> plain version; CUDA tensors -> the kernel.


def _launch(name: str, *args) -> None:
    """Launch ``holo_blocked_<name>`` (raises on a CUDA error) and count it."""
    build.launch(f"holo_blocked_{name}", *args)
    launches[name] += 1


# Work tallies (:mod:`holo_tpu_torch.kernels.work`), as PERF.md section 3
# prices the block kernels: per weight entry walked (the compact edge planes'
# entries, every entry of the dense planes without them) and lane.
RELAX_OPS = 2  # K1/K2: an add and a min
DMIN_PARENT_OPS = 3 + 3  # K3+K4: the DAG test and the update
NH_OR_OPS = 4  # K5: the gated DAG test (+ an OR a word)


def _entries(w, edges) -> tuple:
    """(weight entries walked, the bytes of the weight planes read)."""
    if edges is None:
        return w.numel(), work.nbytes(w)
    return edges[2].shape[0], work.nbytes(*edges)


def relax(w, bsrc, bdst, seg, dist, edges=None):
    """out[v, l] = min(dist[v, l], min over pairs and u of w[u, v] + dist[u, l]).

    The kernel adds only the edges (``edges``), which equals the dense sum
    for ``dist`` in [0, CAP], as every caller passes it (CAP + d >= CAP).
    """
    if work.COUNTING:
        nnz, wb = _entries(w, edges)
        work.note("relax", RELAX_OPS * nnz * dist.shape[1],
                  wb + work.nbytes(bsrc, bdst, seg, dist, dist))
    if not build.on_card(w, bsrc, bdst, seg, dist, *(edges or ())):
        return relax_plain(w, bsrc, bdst, dist)
    nb = _check_planes(w, seg, dist.shape[0])
    cptr, crow, cw, border = _check_edges(w, nb, edges)
    out = torch.empty_like(dist)
    _launch("relax", cptr, crow, cw, border, seg, bsrc, dist, out, nb, dist.shape[1])
    return out


def dmin_parent(w, bsrc, bdst, seg, dist, orig_id, edges=None):
    """(dmin, parent) [N_pad, lanes]: dmin[v, l] = min dist[u, l] over DAG
    parents u of v (CAP if none); parent[v, l] = min orig_id[u] over DAG
    parents u of v with dist[u, l] == dmin[v, l] (PBIG if none).

    Together they are the lexicographic min of (dist[u, l], orig_id[u]),
    which the kernel takes in one walk of ``edges``.
    """
    if work.COUNTING:
        nnz, wb = _entries(w, edges)
        work.note("dmin_parent", DMIN_PARENT_OPS * nnz * dist.shape[1],
                  wb + work.nbytes(bsrc, bdst, seg, dist, orig_id, dist, dist))
    if not build.on_card(w, bsrc, bdst, seg, dist, orig_id, *(edges or ())):
        dmin_ = dmin_plain(w, bsrc, bdst, dist)
        return dmin_, parent_plain(w, bsrc, bdst, dist, dmin_, orig_id)
    nb = _check_planes(w, seg, dist.shape[0])
    cptr, crow, cw, border = _check_edges(w, nb, edges)
    if orig_id.shape != (dist.shape[0],):
        raise ValueError(
            f"orig_id {tuple(orig_id.shape)} does not match dist {tuple(dist.shape)}"
        )
    dmin_, parent_ = torch.empty_like(dist), torch.empty_like(dist)
    _launch("dmin_parent", cptr, crow, cw, border, seg, bsrc, dist, orig_id, dmin_,
            parent_, nb, dist.shape[1])
    return dmin_, parent_


def nh_or(w, bsrc, bdst, seg, dist, gate, nh, direct, edges=None):
    """out[v, l] = direct[v, l] | OR nh[u, l] over DAG parents u of v with
    gate[u, b] > 0; lanes pack (word, scenario) as l = word * B + b, while
    ``dist`` and ``gate`` are [N_pad, B].

    The kernel walks ``edges`` and maps gated and unreached sources to a
    negative distance, which is the plain test for ``dist`` >= 0, as
    distances are.
    """
    if work.COUNTING:
        nnz, wb = _entries(w, edges)
        words = nh.shape[1] // max(dist.shape[1], 1)
        work.note("nh_or", (NH_OR_OPS + words) * nnz * dist.shape[1],
                  wb + work.nbytes(bsrc, bdst, seg, dist, gate, nh, direct, nh))
    if not build.on_card(w, bsrc, bdst, seg, dist, gate, nh, direct, *(edges or ())):
        return nh_or_plain(w, bsrc, bdst, dist, gate, nh, direct)
    nb = _check_planes(w, seg, dist.shape[0])
    cptr, crow, cw, border = _check_edges(w, nb, edges)
    batch, lanes = dist.shape[1], nh.shape[1]
    if (
        gate.shape != dist.shape
        or direct.shape != nh.shape
        or nh.shape[0] != dist.shape[0]
        or lanes % batch
    ):
        raise ValueError(
            f"nh_or planes disagree: dist {tuple(dist.shape)}, gate "
            f"{tuple(gate.shape)}, nh {tuple(nh.shape)}, direct {tuple(direct.shape)}"
        )
    out = torch.empty_like(nh)
    du = torch.empty_like(dist)  # the kernel's gated source distances
    _launch("nh_or", cptr, crow, cw, border, seg, bsrc, dist, gate, nh, direct, du, out,
            nb, batch, lanes)
    return out
