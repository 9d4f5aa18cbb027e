// Block-sparse SPF kernels for Hopper (sm_90a), plain C interface for ctypes.
//
// These replace the Pallas TPU kernels of the blocked SPF engine:
//
//   relax       <- holo_tpu/ops/blocked.py:118 _relax_kernel (pallas_call at
//                  :144) and holo_tpu/ops/blocked_spf.py:281 _relax_kernel
//   dmin_parent <- holo_tpu/ops/blocked_spf.py:295 _dmin_kernel and
//                  holo_tpu/ops/blocked_spf.py:312 _parent_kernel, both
//                  outputs in one walk
//   nh_or       <- holo_tpu/ops/blocked_spf.py:337 _nh_or_kernel
//   (the blocked_spf.py kernels are built by _grid, pallas_call at :394)
//
// All work on int32 with CAP = 1<<28 as infinity over the P nonzero S x S
// block pairs (S = 256) of the adjacency: edge (bsrc[p]*S + u) ->
// (bdst[p]*S + v) of pair p.  Pairs are sorted by destination block and
// seg[bd] .. seg[bd+1] are the pairs of destination block bd.  No kernel
// reads the dense weight planes: each walks the compact edge planes, a
// per-pair CSC of the edges, where column v of pair p is
// crow[cptr[p*(S+1)+v] .. cptr[p*(S+1)+v+1]] (source rows u) with weights cw
// at the same offsets.
//
//   relax      : out[v,l] = min(dist[v,l], min_u w[u,v] + dist[u,l])
//   dmin_parent: (dmin, parent)[v,l] = lexicographic min of
//                (dist[u,l], orig_id[u]) over DAG parents u, (CAP, PBIG)
//                if none
//   nh_or      : out[v,l] = direct[v,l] | OR nh[u,l] over DAG parents u
//                with gate[u,b] > 0, where l = word * batch + b
//
// u is a DAG parent of v in lane l when dist[u] < CAP and
// w[u,v] + dist[u] == dist[v].
//
// Grid.  The TPU grid walks the block pairs in order and carries the output
// block across steps ("first" flag).  GPU blocks run in no order, so here
// one thread block owns one destination block (and a tile of its lanes),
// loops over that block's run of pairs, starts from its init value (dist,
// (CAP, PBIG) or direct) and writes once: no atomics, deterministic.  min,
// lexicographic min and OR are order-free, so any walk order gives the same
// bits.
//
// The edge walk.  96.6% of the dense block entries of the k=90 fat tree are
// CAP filler, so a dense walk is bound by work the function does not need.
// These kernels walk only the CSC entries, so their work is the bound's:
// an add+min per (edge, lane) for relax (nvcc fuses it into Hopper's DPX
// VIADDMNMX); for dmin_parent the DAG test (add, tight test, reached test)
// once per (edge, scenario) and the lexicographic update where it holds; for
// nh_or the DAG test once per (edge, scenario) and, where it holds, an OR
// per word.  On the k=90 fat tree the test holds on 11% of the pairs.
// Every operand is a shared-memory read, so what bounds them on this card
// is the rate of integer instructions and of shared-memory wavefronts per
// edge, and the per-column overhead of short columns, not device memory.
// A thread block of 32 warps takes one destination block x one lane tile;
// for each pair it copies in, with cp.async (16 bytes a copy where the
// plane's stride allows), the source block's tile (relax: 256 rows x 64
// lanes of dist; dmin_parent: 256 rows x 32 scenarios of dist and the 256
// orig_ids; nh_or: 256 rows x 32 scenarios of the gated distance and of two
// next-hop words), the pair's column spans and its first CSC entries as (u,
// w).  Two buffers (227 KB) let pair p + 1's copies run while pair p is
// walked.
// Each warp walks the columns of its 8 destination rows (v = warp + 32 i):
// (u, w) is the same for the whole warp (a broadcast read), the lanes sit
// on consecutive threads (conflict-free reads), accumulators stay in
// registers, and four entries are read at a time.  Entries of a pair past
// the staged count (none on the k=90 fat tree) are read from device memory.
// Lane tiles vary fastest, so the blocks resident at once share source
// planes in L2, and destination blocks go heaviest first (border, from the
// marshal), so the last blocks on the card are short ones.
// relax's sparse sum equals the dense one for dist in [0, CAP], which every
// caller passes: a CAP entry adds CAP + dist[u] >= dist[v].
// dmin_parent: K3 is the min of dist[u] over the DAG parents, K4 the min
// orig_id over the DAG parents at that distance; together they are the
// lexicographic min of (dist[u], orig_id[u]), so one walk gives both
// outputs bit for bit, with half the DAG tests, one staged source plane
// (one scenario a thread keeps 8 rows x (dist[v], best distance, best id)
// in 24 registers) and no dmin plane read back.  K4 fed a dmin that a
// caller corrected in between is a different function; the pipeline's
// corrections rewrite exactly the cells where the two differ (see
// ops/blocked_spf.py first_parent).
// nh_or tests each (edge, scenario) once for a chunk of two words (lane
// l = word * B + b): the test does not depend on the word.  A first pass
// (nh_or_gate) folds the gate and the reached test into the source
// distance: a parent with hops == 0 passes nothing on, nor does one that is
// not reached, and both become NEG, so the DAG test is w + du == dist[v]
// alone.
// At few lanes (compute() runs one scenario) a lane tile would leave most
// threads idle, so up to SMALL lanes the *_rows kernels give a warp one
// destination row and one lane: its threads take the row's pairs in turn,
// read the sources from L1/L2 and meet in a warp min (relax), a two-step
// warp min (dmin_parent: the distance, then the id among the threads that
// hold it) or a warp OR (nh_or).

#include <cuda_runtime.h>

namespace {

constexpr int S = 256;        // vertex block size
constexpr int CAP = 1 << 28;  // in-kernel infinity
constexpr int PBIG = 1 << 27; // "no parent" sentinel

constexpr int SMALL = 8;                // lane counts up to this: *_rows kernels
constexpr int WARPS = 32;               // warps of a tile kernel
constexpr int EW_THREADS = WARPS * 32;
constexpr int ROWS = S / WARPS;         // destination rows per warp
constexpr int RELAX_TL = 64;            // relax lanes per thread block, 2 a thread
constexpr int DP_TB = 32;               // dmin_parent scenarios per thread block, 1 a thread
constexpr int NH_TB = 32;               // nh_or scenarios per thread block, 1 a thread
constexpr int WC = 2;                   // nh_or words per thread (a chunk of W)
constexpr int ROW_WARPS = 8;            // warps (destination rows) of a *_rows block
constexpr int SCP = 2 * S;              // (begin, end) of each column
// CSC entries of a pair staged in shared memory (the rest are read from
// device memory), sized so that two buffers fill the 227 KB a block gets.
constexpr int RELAX_EC = 6016;
constexpr int DP_EC = 9984;
constexpr int NH_EC = 1920;
constexpr int NEG = -(1 << 30);         // nh_or: a source that is no parent
constexpr int RELAX_BUF = S * RELAX_TL + 2 * RELAX_EC + SCP;  // ints a buffer
constexpr int DP_BUF = S * DP_TB + S + 2 * DP_EC + SCP;
constexpr int NH_BUF = S * NH_TB * 3 + 2 * NH_EC + SCP;
static_assert(2 * DP_BUF * 4 <= 232448 && DP_BUF % 4 == 0, "dmin_parent buffers");

// 4-byte asynchronous copy device memory -> shared memory (cp.async).
__device__ __forceinline__ void cp_async4(int* dst, const int* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}
// 16-byte asynchronous copy, bypassing L1 (both addresses 16-byte aligned).
__device__ __forceinline__ void cp_async16(int* dst, const int* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Waits for all but the newest group of this thread's copies.
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Calls f(u_local, w) for the CSC entries [beg, end), four loads in flight.
template <class F>
__device__ __forceinline__ void for_edges(const int* __restrict__ crow,
                                          const int* __restrict__ cw, int beg,
                                          int end, F f) {
  int e = beg;
  for (; e + 4 <= end; e += 4) {
    int u[4], w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      u[k] = __ldg(crow + e + k);
      w[k] = __ldg(cw + e + k);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) f(u[k], w[k]);
  }
  for (; e < end; ++e) f(__ldg(crow + e), __ldg(cw + e));
}

// Issues the copies of pair p's column spans (scp[v] = (begin, end) of
// column v) and of its first ec CSC entries, span.x onwards, as
// (u_local, w) pairs (se).
__device__ __forceinline__ void stage_csc(const int* __restrict__ cptr,
                                          const int* __restrict__ crow,
                                          const int* __restrict__ cw, int p,
                                          int2 span, int ec, int2* scp,
                                          int2* se) {
  const int* cpg = cptr + (long)p * (S + 1);
  for (int k = threadIdx.x; k < 2 * S; k += EW_THREADS)
    cp_async4(reinterpret_cast<int*>(scp) + k, cpg + (k + 1) / 2);
  const int n = min(ec, span.y - span.x);
  for (int k = threadIdx.x; k < n; k += EW_THREADS) {
    int* x = reinterpret_cast<int*>(se + k);
    cp_async4(x, crow + span.x + k);
    cp_async4(x + 1, cw + span.x + k);
  }
}

// Calls f(u_local, w) for the entries col = [begin, end) of the staged
// pair: from shared memory (se holds the entries from base to staged_end;
// all of them when whole, the same for the whole block), the rest from
// device memory.
template <class F>
__device__ __forceinline__ void walk_column(bool whole, const int2* se,
                                            int base, int staged_end,
                                            const int* __restrict__ crow,
                                            const int* __restrict__ cw,
                                            int2 col, F f) {
  if (whole) {
    const int2* c = se + (col.x - base);
    const int n = col.y - col.x;
    int j = 0;
    for (; j + 4 <= n; j += 4) {
      int2 a[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) a[k] = c[j + k];
#pragma unroll
      for (int k = 0; k < 4; ++k) f(a[k].x, a[k].y);
    }
    for (; j < n; ++j) f(c[j].x, c[j].y);
    return;
  }
  const int beg = col.x, end = col.y;
  const int mid = min(end, staged_end);
  int e = beg;
  for (; e + 4 <= mid; e += 4) {
    int2 a[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) a[k] = se[e - base + k];
#pragma unroll
    for (int k = 0; k < 4; ++k) f(a[k].x, a[k].y);
  }
  for (; e < mid; ++e) {
    const int2 a = se[e - base];
    f(a.x, a.y);
  }
  for_edges(crow, cw, e, end, f);
}

// The CSC entries [beg, end) of pair q and its source block.
struct PairInfo {
  int beg, end, src;
};
__device__ __forceinline__ PairInfo pair_info(const int* __restrict__ cptr,
                                              const int* __restrict__ bsrc,
                                              int q) {
  const int* c = cptr + (long)q * (S + 1);
  return {__ldg(c), __ldg(c + S), __ldg(bsrc + q)};
}

// Issues the copies of a source tile: rows src*S .. src*S + S of a plane
// with row stride `stride`, columns l0 .. l0 + TL, into dst [S][TL];
// columns from `count` on get fill.  Where the plane allows it (the same
// for the whole block), 16 bytes a copy.
template <int TL>
__device__ __forceinline__ void stage_tile(const int* __restrict__ x, int src,
                                           long stride, int l0, int count,
                                           int fill, int* dst) {
  const long urow0 = (long)src * S;
  if (((stride | l0 | count) & 3) == 0 &&
      (reinterpret_cast<unsigned long>(x) & 15) == 0) {
#pragma unroll 1
    for (int k = threadIdx.x; k < S * TL / 4; k += EW_THREADS) {
      const int c = k % (TL / 4) * 4, l = l0 + c;
      int* d = dst + k * 4;
      if (l < count) {
        cp_async16(d, x + (urow0 + k / (TL / 4)) * stride + l);
      } else {
        d[0] = d[1] = d[2] = d[3] = fill;
      }
    }
    return;
  }
#pragma unroll 4
  for (int k = threadIdx.x; k < S * TL; k += EW_THREADS) {
    const int l = l0 + k % TL;
    if (l < count)
      cp_async4(dst + k, x + (urow0 + k / TL) * stride + l);
    else
      dst[k] = fill;
  }
}

// The pair loop of a tile kernel, double-buffered: pair p + 1's buffer is
// copied in while pair p is walked, and pair p + 2's info is loaded
// meanwhile for the next step.  stage(info, p, buffer) issues a pair's
// copies; walk(info, buffer) walks it once every thread's copies are in.
template <int BUF, class Stage, class Walk>
__device__ __forceinline__ void pair_loop(const int* __restrict__ cptr,
                                          const int* __restrict__ bsrc, int p0,
                                          int p_end, int* base, Stage stage,
                                          Walk walk) {
  PairInfo cur = pair_info(cptr, bsrc, p0);
  PairInfo nxt = p0 + 1 < p_end ? pair_info(cptr, bsrc, p0 + 1) : cur;
  stage(cur, p0, base);
  cp_async_commit();
  for (int p = p0; p < p_end; ++p) {
    PairInfo after = nxt;
    if (p + 1 < p_end) {
      stage(nxt, p + 1, base + ((p - p0 + 1) & 1) * BUF);
      if (p + 2 < p_end) after = pair_info(cptr, bsrc, p + 2);
    }
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();  // pair p's buffer is in
    walk(cur, static_cast<const int*>(base + ((p - p0) & 1) * BUF));
    __syncthreads();  // pair p's buffer is consumed before it is refilled
    cur = nxt;
    nxt = after;
  }
}

__global__ void __launch_bounds__(EW_THREADS, 1)
relax_tile(const int* __restrict__ cptr, const int* __restrict__ crow,
           const int* __restrict__ cw, const int* __restrict__ border,
           const int* __restrict__ seg, const int* __restrict__ bsrc,
           const int* __restrict__ dist, int* __restrict__ out, int lanes) {
  // Two buffers, each: [S][RELAX_TL] source lanes, RELAX_EC (u, w), spans.
  extern __shared__ int4 smem[];
  const int bd = __ldg(border + blockIdx.y);
  const int l0 = blockIdx.x * RELAX_TL;
  const int warp = threadIdx.x / 32, t = threadIdx.x % 32;
  const int la = l0 + 2 * t;  // this thread's lanes: la, la + 1

  int acc[ROWS][2];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const long v = (long)bd * S + warp + WARPS * i;
    acc[i][0] = la < lanes ? dist[v * lanes + la] : 0;
    acc[i][1] = la + 1 < lanes ? dist[v * lanes + la + 1] : 0;
  }

  pair_loop<RELAX_BUF>(
      cptr, bsrc, seg[bd], seg[bd + 1], reinterpret_cast<int*>(smem),
      [&](const PairInfo& in, int p, int* buf) {
        stage_tile<RELAX_TL>(dist, in.src, lanes, l0, lanes, CAP, buf);
        stage_csc(cptr, crow, cw, p, make_int2(in.beg, in.end), RELAX_EC,
                  reinterpret_cast<int2*>(buf + RELAX_BUF - SCP),
                  reinterpret_cast<int2*>(buf + S * RELAX_TL));
      },
      [&](const PairInfo& in, const int* buf) {
        const int2* ds2 = reinterpret_cast<const int2*>(buf);
        const int2* se = reinterpret_cast<const int2*>(buf + S * RELAX_TL);
        const int2* scp = reinterpret_cast<const int2*>(buf + RELAX_BUF - SCP);
        const bool whole = in.end - in.beg <= RELAX_EC;
        const int staged_end = in.beg + min(RELAX_EC, in.end - in.beg);
#pragma unroll
        for (int i = 0; i < ROWS; ++i) {
          int a0 = acc[i][0], a1 = acc[i][1];
          walk_column(whole, se, in.beg, staged_end, crow, cw,
                      scp[warp + WARPS * i], [&](int u, int w) {
                        const int2 d = ds2[u * (RELAX_TL / 2) + t];
                        a0 = min(a0, w + d.x);
                        a1 = min(a1, w + d.y);
                      });
          acc[i][0] = a0;
          acc[i][1] = a1;
        }
      });

#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const long v = (long)bd * S + warp + WARPS * i;
    if (la < lanes) out[v * lanes + la] = acc[i][0];
    if (la + 1 < lanes) out[v * lanes + la + 1] = acc[i][1];
  }
}

// (d, id) = the lexicographic min of (d, id) and (du, oid).
__device__ __forceinline__ void lex_min(int& d, int& id, int du, int oid) {
  if (du < d || (du == d && oid < id)) {
    d = du;
    id = oid;
  }
}

__global__ void __launch_bounds__(EW_THREADS, 1)
dmin_parent_tile(const int* __restrict__ cptr, const int* __restrict__ crow,
                 const int* __restrict__ cw, const int* __restrict__ border,
                 const int* __restrict__ seg, const int* __restrict__ bsrc,
                 const int* __restrict__ dist, const int* __restrict__ orig_id,
                 int* __restrict__ dmin, int* __restrict__ parent, int lanes) {
  // Two buffers, each: [S][DP_TB] source dist, the S source orig_ids,
  // DP_EC (u, w), spans.
  extern __shared__ int4 smem[];
  const int bd = __ldg(border + blockIdx.y);
  const int b0 = blockIdx.x * DP_TB;
  const int warp = threadIdx.x / 32, t = threadIdx.x % 32;
  const int b = b0 + t;
  const bool ok = b < lanes;

  int dv[ROWS];  // -1 for a masked scenario: no w + du equals it
  int best_d[ROWS], best_id[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const long v = (long)bd * S + warp + WARPS * i;
    dv[i] = ok ? dist[v * lanes + b] : -1;
    best_d[i] = CAP;
    best_id[i] = PBIG;
  }

  pair_loop<DP_BUF>(
      cptr, bsrc, seg[bd], seg[bd + 1], reinterpret_cast<int*>(smem),
      [&](const PairInfo& in, int p, int* buf) {
        stage_tile<DP_TB>(dist, in.src, lanes, b0, lanes, CAP, buf);
        const int* oid = orig_id + (long)in.src * S;
        for (int k = threadIdx.x; k < S; k += EW_THREADS)
          cp_async4(buf + S * DP_TB + k, oid + k);
        stage_csc(cptr, crow, cw, p, make_int2(in.beg, in.end), DP_EC,
                  reinterpret_cast<int2*>(buf + DP_BUF - SCP),
                  reinterpret_cast<int2*>(buf + S * DP_TB + S));
      },
      [&](const PairInfo& in, const int* buf) {
        const int* soid = buf + S * DP_TB;
        const int2* se = reinterpret_cast<const int2*>(buf + S * DP_TB + S);
        const int2* scp = reinterpret_cast<const int2*>(buf + DP_BUF - SCP);
        const bool whole = in.end - in.beg <= DP_EC;
        const int staged_end = in.beg + min(DP_EC, in.end - in.beg);
#pragma unroll
        for (int i = 0; i < ROWS; ++i) {
          const int dvi = dv[i];
          int d = best_d[i], id = best_id[i];
          walk_column(whole, se, in.beg, staged_end, crow, cw,
                      scp[warp + WARPS * i], [&](int u, int w) {
                        const int du = buf[u * DP_TB + t];
                        if (du < CAP && w + du == dvi) lex_min(d, id, du, soid[u]);
                      });
          best_d[i] = d;
          best_id[i] = id;
        }
      });

#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const long v = (long)bd * S + warp + WARPS * i;
    if (ok) {
      dmin[v * lanes + b] = best_d[i];
      parent[v * lanes + b] = best_id[i];
    }
  }
}

// nh_or's first pass: the source distance each DAG test reads.  A parent
// with hops == 0 passes nothing on, and neither does one that is not
// reached: both become NEG, for which w + NEG < 0 <= dist[v], so the DAG
// test is w + du == dist[v] alone.
__global__ void __launch_bounds__(256)
nh_or_gate(const int* __restrict__ dist, const int* __restrict__ gate,
           int* __restrict__ du, long n) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    const int d = dist[i];
    du[i] = gate[i] > 0 && d < CAP ? d : NEG;
  }
}

__global__ void __launch_bounds__(EW_THREADS, 1)
nh_or_tile(const int* __restrict__ cptr, const int* __restrict__ crow,
           const int* __restrict__ cw, const int* __restrict__ border,
           const int* __restrict__ seg, const int* __restrict__ bsrc,
           const int* __restrict__ dist, const int* __restrict__ du,
           const int* __restrict__ nh, const int* __restrict__ direct,
           int* __restrict__ out, int batch, int words) {
  // Two buffers, each: [S][NH_TB] gated dist, the two words [S][NH_TB] of
  // word w0 then w0 + 1, NH_EC (u, w), spans.
  extern __shared__ int4 smem[];
  const int bd = __ldg(border + blockIdx.y);
  const int b0 = blockIdx.x * NH_TB;
  const int w0 = blockIdx.z * WC;  // this block's words: w0, w0 + 1
  const int warp = threadIdx.x / 32, t = threadIdx.x % 32;
  const int b = b0 + t;
  const int lanes = words * batch;
  const long l0 = (long)w0 * batch, l1 = l0 + batch;  // + scenario
  const bool ok_w1 = w0 + 1 < words;  // the chunk has a second word
  const bool ok0 = b < batch, ok1 = ok0 && ok_w1;

  int acc[ROWS][WC];
  int dv[ROWS];  // -1 for a masked scenario: no w + du equals it
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const long v = (long)bd * S + warp + WARPS * i;
    acc[i][0] = ok0 ? direct[v * lanes + l0 + b] : 0;
    acc[i][1] = ok1 ? direct[v * lanes + l1 + b] : 0;
    dv[i] = ok0 ? dist[v * batch + b] : -1;
  }

  pair_loop<NH_BUF>(
      cptr, bsrc, seg[bd], seg[bd + 1], reinterpret_cast<int*>(smem),
      [&](const PairInfo& in, int p, int* buf) {
        stage_tile<NH_TB>(du, in.src, batch, b0, batch, NEG, buf);
        stage_tile<NH_TB>(nh + l0, in.src, lanes, b0, batch, 0,
                          buf + S * NH_TB);
        stage_tile<NH_TB>(nh + l1, in.src, lanes, b0, ok_w1 ? batch : 0, 0,
                          buf + 2 * S * NH_TB);
        stage_csc(cptr, crow, cw, p, make_int2(in.beg, in.end), NH_EC,
                  reinterpret_cast<int2*>(buf + NH_BUF - SCP),
                  reinterpret_cast<int2*>(buf + 3 * S * NH_TB));
      },
      [&](const PairInfo& in, const int* buf) {
        const int* x0 = buf + S * NH_TB;
        const int* x1 = buf + 2 * S * NH_TB;
        const int2* se = reinterpret_cast<const int2*>(buf + 3 * S * NH_TB);
        const int2* scp = reinterpret_cast<const int2*>(buf + NH_BUF - SCP);
        const bool whole = in.end - in.beg <= NH_EC;
        const int staged_end = in.beg + min(NH_EC, in.end - in.beg);
#pragma unroll
        for (int i = 0; i < ROWS; ++i) {
          const int dvi = dv[i];
          int a0 = acc[i][0], a1 = acc[i][1];
          walk_column(whole, se, in.beg, staged_end, crow, cw,
                      scp[warp + WARPS * i], [&](int u, int w) {
                        const int k = u * NH_TB + t;
                        if (w + buf[k] == dvi) {
                          a0 |= x0[k];
                          a1 |= x1[k];
                        }
                      });
          acc[i][0] = a0;
          acc[i][1] = a1;
        }
      });

#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const long v = (long)bd * S + warp + WARPS * i;
    if (ok0) out[v * lanes + l0 + b] = acc[i][0];
    if (ok1) out[v * lanes + l1 + b] = acc[i][1];
  }
}

// One warp per (destination row, lane): its threads take the row's pairs
// in turn, walk their columns and meet in a warp min.
__global__ void __launch_bounds__(ROW_WARPS * 32)
relax_rows(const int* __restrict__ cptr, const int* __restrict__ crow,
           const int* __restrict__ cw, const int* __restrict__ seg,
           const int* __restrict__ bsrc, const int* __restrict__ dist,
           int* __restrict__ out, int lanes) {
  const long v = (long)blockIdx.x * ROW_WARPS + threadIdx.x / 32;
  const int l = blockIdx.y, t = threadIdx.x % 32;
  const int bd = v / S, vl = v % S;
  int acc = CAP;
  const int p_end = seg[bd + 1];
  for (int p = seg[bd] + t; p < p_end; p += 32) {
    const long urow0 = (long)bsrc[p] * S;
    const int* cp = cptr + (long)p * (S + 1);
    for_edges(crow, cw, cp[vl], cp[vl + 1], [&](int u, int w) {
      acc = min(acc, w + __ldg(dist + (urow0 + u) * lanes + l));
    });
  }
  acc = __reduce_min_sync(0xffffffffu, acc);
  if (t == 0) out[v * lanes + l] = min(dist[v * lanes + l], acc);
}

// One warp per (destination row, lane), as relax_rows; the warp meets in
// the min distance, then in the min id over the threads that hold it.
__global__ void __launch_bounds__(ROW_WARPS * 32)
dmin_parent_rows(const int* __restrict__ cptr, const int* __restrict__ crow,
                 const int* __restrict__ cw, const int* __restrict__ seg,
                 const int* __restrict__ bsrc, const int* __restrict__ dist,
                 const int* __restrict__ orig_id, int* __restrict__ dmin,
                 int* __restrict__ parent, int lanes) {
  const long v = (long)blockIdx.x * ROW_WARPS + threadIdx.x / 32;
  const int l = blockIdx.y, t = threadIdx.x % 32;
  const int bd = v / S, vl = v % S;
  const int dv = dist[v * lanes + l];
  int d = CAP, id = PBIG;
  const int p_end = seg[bd + 1];
  for (int p = seg[bd] + t; p < p_end; p += 32) {
    const long urow0 = (long)bsrc[p] * S;
    const int* cp = cptr + (long)p * (S + 1);
    for_edges(crow, cw, cp[vl], cp[vl + 1], [&](int u, int w) {
      const int du = __ldg(dist + (urow0 + u) * lanes + l);
      if (du < CAP && w + du == dv) lex_min(d, id, du, __ldg(orig_id + urow0 + u));
    });
  }
  const int m = __reduce_min_sync(0xffffffffu, d);
  id = __reduce_min_sync(0xffffffffu, d == m ? id : PBIG);
  if (t == 0) {
    dmin[v * lanes + l] = m;
    parent[v * lanes + l] = id;
  }
}

// One warp per (destination row, scenario, word chunk), as relax_rows.
__global__ void __launch_bounds__(ROW_WARPS * 32)
nh_or_rows(const int* __restrict__ cptr, const int* __restrict__ crow,
           const int* __restrict__ cw, const int* __restrict__ seg,
           const int* __restrict__ bsrc, const int* __restrict__ dist,
           const int* __restrict__ gate, const int* __restrict__ nh,
           const int* __restrict__ direct, int* __restrict__ out, int batch,
           int words) {
  const long v = (long)blockIdx.x * ROW_WARPS + threadIdx.x / 32;
  const int b = blockIdx.y, w0 = blockIdx.z * WC, t = threadIdx.x % 32;
  const int bd = v / S, vl = v % S;
  const long lanes = (long)words * batch;
  const long l0 = (long)w0 * batch + b, l1 = l0 + batch;
  const bool two = w0 + 1 < words;
  const int dv = dist[v * batch + b];
  unsigned a0 = 0, a1 = 0;
  const int p_end = seg[bd + 1];
  for (int p = seg[bd] + t; p < p_end; p += 32) {
    const long urow0 = (long)bsrc[p] * S;
    const int* cp = cptr + (long)p * (S + 1);
    for_edges(crow, cw, cp[vl], cp[vl + 1], [&](int u, int w) {
      const long r = urow0 + u;
      const int du = __ldg(dist + r * batch + b);
      if (__ldg(gate + r * batch + b) > 0 && du < CAP && w + du == dv) {
        a0 |= __ldg(nh + r * lanes + l0);
        if (two) a1 |= __ldg(nh + r * lanes + l1);
      }
    });
  }
  a0 = __reduce_or_sync(0xffffffffu, a0);
  a1 = __reduce_or_sync(0xffffffffu, a1);
  if (t == 0) {
    out[v * lanes + l0] = direct[v * lanes + l0] | (int)a0;
    if (two) out[v * lanes + l1] = direct[v * lanes + l1] | (int)a1;
  }
}

// Dynamic shared memory above 48 KB must be allowed per kernel first.
template <class K>
int allow_smem(K kernel, int bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

extern "C" {

const char* holo_error_string(int rc) {
  return cudaGetErrorString((cudaError_t)rc);
}

int holo_blocked_relax(const void* cptr, const void* crow, const void* cw,
                       const void* border, const void* seg, const void* bsrc,
                       const void* dist, void* out, int nb, int lanes,
                       void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int *cp = (const int*)cptr, *cr = (const int*)crow, *c = (const int*)cw;
  const int *sg = (const int*)seg, *bs = (const int*)bsrc, *d = (const int*)dist;
  if (nb > 0 && lanes > 0 && lanes <= SMALL) {
    relax_rows<<<dim3(nb * S / ROW_WARPS, lanes), ROW_WARPS * 32, 0, st>>>(
        cp, cr, c, sg, bs, d, (int*)out, lanes);
  } else if (nb > 0 && lanes > 0) {
    const int smem = 2 * RELAX_BUF * (int)sizeof(int);
    const int rc = allow_smem(relax_tile, smem);
    if (rc != 0) return rc;
    // Lane tiles vary fastest: the blocks resident at once share their
    // destination blocks' source tiles in L2, and the heaviest destination
    // blocks (border) start first.
    const dim3 grid((lanes + RELAX_TL - 1) / RELAX_TL, nb);
    relax_tile<<<grid, EW_THREADS, smem, st>>>(
        cp, cr, c, (const int*)border, sg, bs, d, (int*)out, lanes);
  }
  return (int)cudaGetLastError();
}

int holo_blocked_dmin_parent(const void* cptr, const void* crow,
                             const void* cw, const void* border,
                             const void* seg, const void* bsrc,
                             const void* dist, const void* orig_id,
                             void* dmin, void* parent, int nb, int lanes,
                             void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int *cp = (const int*)cptr, *cr = (const int*)crow, *c = (const int*)cw;
  const int *sg = (const int*)seg, *bs = (const int*)bsrc, *d = (const int*)dist;
  const int* o = (const int*)orig_id;
  if (nb > 0 && lanes > 0 && lanes <= SMALL) {
    dmin_parent_rows<<<dim3(nb * S / ROW_WARPS, lanes), ROW_WARPS * 32, 0, st>>>(
        cp, cr, c, sg, bs, d, o, (int*)dmin, (int*)parent, lanes);
  } else if (nb > 0 && lanes > 0) {
    const int smem = 2 * DP_BUF * (int)sizeof(int);
    const int rc = allow_smem(dmin_parent_tile, smem);
    if (rc != 0) return rc;
    const dim3 grid((lanes + DP_TB - 1) / DP_TB, nb);
    dmin_parent_tile<<<grid, EW_THREADS, smem, st>>>(
        cp, cr, c, (const int*)border, sg, bs, d, o, (int*)dmin, (int*)parent,
        lanes);
  }
  return (int)cudaGetLastError();
}

int holo_blocked_nh_or(const void* cptr, const void* crow, const void* cw,
                       const void* border, const void* seg, const void* bsrc,
                       const void* dist, const void* gate, const void* nh,
                       const void* direct, void* du, void* out, int nb,
                       int batch, int lanes, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int *cp = (const int*)cptr, *cr = (const int*)crow, *c = (const int*)cw;
  const int *sg = (const int*)seg, *bs = (const int*)bsrc, *d = (const int*)dist;
  const int *g = (const int*)gate, *x = (const int*)nh, *dr = (const int*)direct;
  const int words = batch > 0 ? lanes / batch : 0;
  const int chunks = (words + WC - 1) / WC;
  if (nb > 0 && words > 0 && batch <= SMALL) {
    nh_or_rows<<<dim3(nb * S / ROW_WARPS, batch, chunks), ROW_WARPS * 32, 0,
                 st>>>(cp, cr, c, sg, bs, d, g, x, dr, (int*)out, batch, words);
  } else if (nb > 0 && words > 0) {
    const long n = (long)nb * S * batch;
    nh_or_gate<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(d, g, (int*)du, n);
    const int smem = 2 * NH_BUF * (int)sizeof(int);
    const int rc = allow_smem(nh_or_tile, smem);
    if (rc != 0) return rc;
    const dim3 grid((batch + NH_TB - 1) / NH_TB, nb, chunks);
    nh_or_tile<<<grid, EW_THREADS, smem, st>>>(cp, cr, c, (const int*)border,
                                               sg, bs, d, (const int*)du, x,
                                               dr, (int*)out, batch, words);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
