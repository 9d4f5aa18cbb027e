// Multipath kernels of the gather SPF engine for Hopper (sm_90a), plain C
// interface for ctypes.
//
// The JAX package computes the multipath planes (holo_tpu/ops/spf_engine.py,
// spf_one_multipath) with jnp inside lax.while_loop; XLA fuses each step into
// one loop fusion, and there is no Pallas kernel.  In eager PyTorch the
// per-atom weight round alone would form an [N, K, A] contribution per lane
// (10,125 x 96 x 64 x 1024 int32 = 254 GB at the k=90 fat tree x 1024
// scenarios), so each step is one hand-written kernel:
//
//   ell_mp_round     <- :1281-1322, the body of _mp_fixpoint: one Jacobi
//                       round of hops, next-hop words, saturated path counts
//                       and per-atom UCMP weights, every value recomputed
//                       from the previous round's planes (never
//                       accumulated), and a changed flag over all four.
//                       Without the count and weight planes it is the body
//                       of _hops_nh_fixpoint (:1211-1227), the incremental
//                       path's hops + next-hop round.
//   ell_parent_sets  <- :1327-1372, _mp_parent_sets: per (vertex, lane) the
//                       kp smallest (path cost, source) pairs over the
//                       admissible slots, one per source at its cheapest
//                       slot, with the source's path count.
//
// Planes (int32, lanes minor as in ell_kernels.cu): src, cost, slot [N, K]
// (slot = edge id, -1 for padding); mask [E, ceil(B/32)] or NULL; dag
// [N, K, ceil(B/32)], the DAG bits ell_first_parent writes (bit b%32 of word
// [v, k, b/32]: slot k is a DAG in-edge of v in lane b); direct [N, K, W]
// one-hot atom words; inc [N] (1 at a router); roots [B]; parent, hops,
// npaths, dist [N, B]; next hops [N, W, B]; weights [N, A, B] with A = 32 W
// (atom a = bit a%32 of word a/32); parent sets [N, KP, B].  Sums wrap as
// JAX's int32 sums do (unsigned arithmetic) and are clamped at SAT after
// the row sum, as JAX clamps them.
//
// What bounds them.  ell_mp_round must read and write the four planes once a
// round: at k=90 x 1024 the weights are 2.65 GB a copy, so a round moves
// ~5.6 GB, 1.7 ms at the HBM rate.  What it gathers is larger: each DAG
// (slot, lane) pair whose source has hops != 0 reads the source's 64 atom
// weights, 256 bytes, and 83 million DAG pairs read ~21 GB a round, mostly
// from HBM (the plane does not fit in L2).  This first design does not
// avoid that: a warp owns one destination row, one 32-lane tile and one word
// (32 atoms, gridDim.y = tiles x words), so each thread keeps 32 atom sums
// in registers (all 64 would spill) and each gather of a source's atom row
// is one 128-byte line a word; the DAG slots of a 32-slot chunk are found
// by a ballot over their DAG words and walked one at a time.  Rows, tiles
// and words are independent blocks; the hops and path counts are written
// by the word-0 blocks.  ell_parent_sets reads the slot planes, mask words
// and the gathered dist[src] once (~0.65 GB at kp=4 x 1024 lanes with its
// outputs, 0.2 ms); a thread owns one lane and keeps its sorted set of kp
// (cost, source) entries in registers (one entry per source: a slot of a
// listed source only lowers that entry's cost, a new source replaces the
// last entry if it ranks before it, then one bubble pass restores the
// order).
//
// Row form (up to SMALL lanes: compute() and the incremental path are one
// lane).  ell_mp_round: a warp owns one row and one word; thread t owns atom
// 32 w + t in every lane, and every thread keeps the row's next-hop words,
// path counts and hops in registers (the same in all threads), which thread
// b writes for lane b.  ell_parent_sets: a warp owns one (row, lane), its
// threads take slots t, t + 32, ..., and kp rounds of a warp-wide
// lexicographic min emit the set in order, each round skipping the sources
// already emitted (JAX's rounds, written for a warp).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int INF = 1 << 30;
constexpr int SAT = 1 << 17;  // MP_SAT
constexpr unsigned FULL = 0xffffffffu;
constexpr int SMALL = 8;  // lane counts up to this: *_rows kernels
constexpr int WARPS = 8;  // warps per thread block

__device__ __forceinline__ int add32(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

// hops[v, b] of the round: 0 at the lane's root, the first parent's hops
// plus inc[v] where the parent exists and has hops below N + 1, else N + 1.
__device__ __forceinline__ int next_hops(const int* __restrict__ hops,
                                         const int* __restrict__ parent,
                                         const int* __restrict__ inc, long v, int b,
                                         int n, int lanes, bool is_root) {
  if (is_root) return 0;
  const int p = parent[v * lanes + b];
  const int ph = (p >= 0 && p < n) ? hops[(long)p * lanes + b] : n + 1;
  return ph < n + 1 ? add32(ph, inc[v]) : n + 1;
}

// One multipath round, tile form: blockIdx.x = row block, blockIdx.y =
// tile * nwords + word.  MP: with the path-count and weight planes.
template <bool MP>
__global__ void __launch_bounds__(WARPS * 32)
ell_mp_round_tile(const int* __restrict__ src, const int* __restrict__ dag,
                  const int* __restrict__ direct, const int* __restrict__ inc,
                  const int* __restrict__ roots, const int* __restrict__ parent,
                  const int* __restrict__ hops, const int* __restrict__ nh,
                  const int* __restrict__ np, const int* __restrict__ aw,
                  int* __restrict__ hops_out, int* __restrict__ nh_out,
                  int* __restrict__ np_out, int* __restrict__ aw_out,
                  int* __restrict__ changed, int n, int k, int lanes, int nwords) {
  const int t = threadIdx.x % 32;
  const long v = (long)blockIdx.x * WARPS + threadIdx.x / 32;
  if (v >= n) return;
  const int words = (lanes + 31) / 32;  // DAG words a slot
  const int tile = blockIdx.y / nwords;
  const int w = blockIdx.y % nwords;
  const int b = tile * 32 + t;
  const long atoms = 32L * nwords;
  unsigned nh_acc = 0u, np_acc = 0u;
  unsigned acc[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) acc[j] = 0u;
  const long row = v * k;
  for (int k0 = 0; k0 < k; k0 += 32) {
    int s = 0;
    unsigned d = 0u;
    if (k0 + t < k) {
      s = __ldg(src + row + k0 + t);
      d = (unsigned)__ldg(dag + (row + k0 + t) * words + tile);
    }
    unsigned todo = __ballot_sync(FULL, d != 0u);  // this tile's DAG slots
    while (todo != 0u) {
      const int j = __ffs(todo) - 1;
      todo &= todo - 1u;
      const int sj = __shfl_sync(FULL, s, j);
      const unsigned dj = __shfl_sync(FULL, d, j);
      if ((dj >> t) & 1u) {  // bits past the last lane are 0
        const long o = (long)sj * lanes + b;
        const int h = __ldg(hops + o);
        const unsigned p = MP ? (unsigned)__ldg(np + o) : 0u;
        if (h == 0) {
          const unsigned x = (unsigned)__ldg(direct + (row + k0 + j) * nwords + w);
          nh_acc |= x;
          if (MP) {
#pragma unroll
            for (int a = 0; a < 32; ++a) acc[a] += ((x >> a) & 1u) ? p : 0u;
          }
        } else {
          nh_acc |= (unsigned)__ldg(nh + ((long)sj * nwords + w) * lanes + b);
          if (MP) {
            const int* q = aw + ((long)sj * atoms + 32L * w) * lanes + b;
#pragma unroll
            for (int a = 0; a < 32; ++a) acc[a] += (unsigned)__ldg(q + (long)a * lanes);
          }
        }
        np_acc += p;
      }
    }
  }
  bool moved = false;
  if (b < lanes) {
    const long o = v * lanes + b;
    const long ow = (v * nwords + w) * lanes + b;
    const unsigned old = (unsigned)nh[ow];
    nh_out[ow] = (int)nh_acc;
    moved = old != nh_acc;
    const bool is_root = roots[b] == v;
    if (w == 0) {
      const int hn = next_hops(hops, parent, inc, v, b, n, lanes, is_root);
      hops_out[o] = hn;
      moved |= hn != hops[o];
      if (MP) {
        const int pn = is_root ? 1 : min((int)np_acc, SAT);
        np_out[o] = pn;
        moved |= pn != np[o];
      }
    }
    if (MP) {
#pragma unroll
      for (int a = 0; a < 32; ++a) {
        const long oa = (v * atoms + 32L * w + a) * lanes + b;
        const int x = min((int)acc[a], SAT);
        moved |= x != aw[oa];
        aw_out[oa] = x;
      }
    }
  }
  if (__any_sync(FULL, moved) && t == 0) *changed = 1;
}

// One multipath round, row form: blockIdx.x = row block, blockIdx.y = word;
// thread t owns atom 32 w + t; one DAG word a slot.
template <bool MP>
__global__ void __launch_bounds__(WARPS * 32)
ell_mp_round_rows(const int* __restrict__ src, const int* __restrict__ dag,
                  const int* __restrict__ direct, const int* __restrict__ inc,
                  const int* __restrict__ roots, const int* __restrict__ parent,
                  const int* __restrict__ hops, const int* __restrict__ nh,
                  const int* __restrict__ np, const int* __restrict__ aw,
                  int* __restrict__ hops_out, int* __restrict__ nh_out,
                  int* __restrict__ np_out, int* __restrict__ aw_out,
                  int* __restrict__ changed, int n, int k, int lanes, int nwords) {
  const int t = threadIdx.x % 32;
  const long v = (long)blockIdx.x * WARPS + threadIdx.x / 32;
  if (v >= n) return;
  const int w = blockIdx.y;
  const long atoms = 32L * nwords;
  unsigned nh_acc[SMALL], np_acc[SMALL], acc[SMALL];
#pragma unroll
  for (int b = 0; b < SMALL; ++b) nh_acc[b] = np_acc[b] = acc[b] = 0u;
  const long row = v * k;
  for (int k0 = 0; k0 < k; k0 += 32) {
    int s = 0;
    unsigned d = 0u;
    if (k0 + t < k) {
      s = __ldg(src + row + k0 + t);
      d = (unsigned)__ldg(dag + row + k0 + t);
    }
    unsigned todo = __ballot_sync(FULL, d != 0u);
    while (todo != 0u) {
      const int j = __ffs(todo) - 1;
      todo &= todo - 1u;
      const int sj = __shfl_sync(FULL, s, j);
      const unsigned dj = __shfl_sync(FULL, d, j);
      const unsigned x = (unsigned)__ldg(direct + (row + k0 + j) * nwords + w);
      const bool mine = (x >> t) & 1u;  // the slot's direct atoms include atom 32 w + t
#pragma unroll
      for (int b = 0; b < SMALL; ++b) {
        if (b < lanes && ((dj >> b) & 1u)) {
          const long o = (long)sj * lanes + b;
          const int h = __ldg(hops + o);
          const unsigned p = MP ? (unsigned)__ldg(np + o) : 0u;
          if (h == 0) {
            nh_acc[b] |= x;
            if (MP && mine) acc[b] += p;
          } else {
            nh_acc[b] |= (unsigned)__ldg(nh + ((long)sj * nwords + w) * lanes + b);
            if (MP) acc[b] += (unsigned)__ldg(aw + ((long)sj * atoms + 32L * w + t) * lanes + b);
          }
          np_acc[b] += p;
        }
      }
    }
  }
  bool moved = false;
#pragma unroll
  for (int b = 0; b < SMALL; ++b) {
    if (b >= lanes) continue;
    if (MP) {
      const long oa = (v * atoms + 32L * w + t) * lanes + b;
      const int x = min((int)acc[b], SAT);
      moved |= x != aw[oa];
      aw_out[oa] = x;
    }
    if (t == b) {
      const long o = v * lanes + b;
      const long ow = (v * nwords + w) * lanes + b;
      const unsigned old = (unsigned)nh[ow];
      nh_out[ow] = (int)nh_acc[b];
      moved |= old != nh_acc[b];
      const bool is_root = roots[b] == v;
      if (w == 0) {
        const int hn = next_hops(hops, parent, inc, v, b, n, lanes, is_root);
        hops_out[o] = hn;
        moved |= hn != hops[o];
        if (MP) {
          const int pn = is_root ? 1 : min((int)np_acc[b], SAT);
          np_out[o] = pn;
          moved |= pn != np[o];
        }
      }
    }
  }
  if (__any_sync(FULL, moved) && t == 0) *changed = 1;
}

// (c, s) ranks before (c2, s2): path cost first, then source id.
__device__ __forceinline__ bool before(int c, int s, int c2, int s2) {
  return c < c2 || (c == c2 && s < s2);
}

// Offer (c, s) to the sorted set (pc, ps) of at most KP sources, each at its
// cheapest offered cost; empty entries are (INF, n) and rank last.
template <int KP>
__device__ __forceinline__ void offer(int (&pc)[KP], int (&ps)[KP], int c, int s) {
  bool listed = false, lowered = false;
#pragma unroll
  for (int i = 0; i < KP; ++i) {
    if (ps[i] == s) {
      listed = true;
      if (c < pc[i]) {
        pc[i] = c;
        lowered = true;
      }
    }
  }
  if (!listed) {
    if (!before(c, s, pc[KP - 1], ps[KP - 1])) return;
    pc[KP - 1] = c;
    ps[KP - 1] = s;
  } else if (!lowered) {
    return;
  }
  // One entry moved up in rank: a bubble pass from the bottom restores the order.
#pragma unroll
  for (int i = KP - 1; i > 0; --i) {
    if (before(pc[i], ps[i], pc[i - 1], ps[i - 1])) {
      const int c0 = pc[i], s0 = ps[i];
      pc[i] = pc[i - 1];
      ps[i] = ps[i - 1];
      pc[i - 1] = c0;
      ps[i - 1] = s0;
    }
  }
}

// Parent sets, tile form: blockIdx.x = row block, blockIdx.y = 32-lane tile.
template <int KP>
__global__ void __launch_bounds__(WARPS * 32)
ell_parent_sets_tile(const int* __restrict__ src, const int* __restrict__ cost,
                     const int* __restrict__ slot, const int* __restrict__ mask,
                     const int* __restrict__ dist, const int* __restrict__ np,
                     const int* __restrict__ roots, int* __restrict__ parents,
                     int* __restrict__ pdist, int* __restrict__ pweight, int n, int k,
                     int lanes) {
  const int t = threadIdx.x % 32;
  const long v = (long)blockIdx.x * WARPS + threadIdx.x / 32;
  if (v >= n) return;
  const int words = (lanes + 31) / 32;
  const int tile = blockIdx.y;
  const int b = tile * 32 + t;
  const bool ok = b < lanes;
  const int dv = ok ? dist[v * lanes + b] : INF;
  // Lanes of the tile in which v is reached and not the root.
  const unsigned live = __ballot_sync(FULL, ok && dv < INF && roots[b] != v);
  int pc[KP], ps[KP];
#pragma unroll
  for (int i = 0; i < KP; ++i) {
    pc[i] = INF;
    ps[i] = n;
  }
  const long row = v * k;
  for (int k0 = 0; live != 0u && k0 < k; k0 += 32) {
    int s = 0, c = 0;
    unsigned m = 0u;  // lanes in which this thread's slot is usable and v live
    if (k0 + t < k) {
      const int e = __ldg(slot + row + k0 + t);
      if (e >= 0) {
        s = __ldg(src + row + k0 + t);
        c = __ldg(cost + row + k0 + t);
        m = (mask == nullptr ? FULL : (unsigned)__ldg(mask + (long)e * words + tile)) & live;
      }
    }
    unsigned todo = __ballot_sync(FULL, m != 0u);
    while (todo != 0u) {
      const int j = __ffs(todo) - 1;
      todo &= todo - 1u;
      const int sj = __shfl_sync(FULL, s, j);
      const int cj = __shfl_sync(FULL, c, j);
      const unsigned mj = __shfl_sync(FULL, m, j);
      if ((mj >> t) & 1u) {
        const int d = __ldg(dist + (long)sj * lanes + b);
        if (d < INF) {
          const int pcost = add32(d, cj);
          if ((pcost == dv || d < dv) && pcost < INF) offer<KP>(pc, ps, pcost, sj);
        }
      }
    }
  }
  if (ok) {
#pragma unroll
    for (int i = 0; i < KP; ++i) {
      const long o = (v * KP + i) * lanes + b;
      parents[o] = ps[i];
      pdist[o] = pc[i];
      pweight[o] = ps[i] < n ? np[(long)ps[i] * lanes + b] : 0;
    }
  }
}

// Parent sets, row form: one warp a (row, lane); KP rounds of a warp-wide
// lexicographic min over the threads' slots, skipping emitted sources.
template <int KP>
__global__ void __launch_bounds__(WARPS * 32)
ell_parent_sets_rows(const int* __restrict__ src, const int* __restrict__ cost,
                     const int* __restrict__ slot, const int* __restrict__ mask,
                     const int* __restrict__ dist, const int* __restrict__ np,
                     const int* __restrict__ roots, int* __restrict__ parents,
                     int* __restrict__ pdist, int* __restrict__ pweight, int n, int k,
                     int lanes) {
  const int t = threadIdx.x % 32;
  const long pair = (long)blockIdx.x * WARPS + threadIdx.x / 32;
  const long v = pair / lanes;
  const int b = (int)(pair % lanes);
  if (v >= n) return;
  const int dv = dist[v * lanes + b];
  const bool live = dv < INF && roots[b] != v;
  const long row = v * k;
  int emitted[KP];
#pragma unroll
  for (int r = 0; r < KP; ++r) emitted[r] = n;
#pragma unroll
  for (int r = 0; r < KP; ++r) {
    int bc = INF, bs = n;
    for (int kk = t; live && kk < k; kk += 32) {
      const int e = __ldg(slot + row + kk);
      if (e < 0 || (mask != nullptr && !(((unsigned)__ldg(mask + e) >> b) & 1u))) continue;
      const int s = __ldg(src + row + kk);
      const int d = __ldg(dist + (long)s * lanes + b);
      if (d >= INF) continue;
      const int pcost = add32(d, __ldg(cost + row + kk));
      if (!((pcost == dv || d < dv) && pcost < INF)) continue;
      bool seen = false;
#pragma unroll
      for (int i = 0; i < KP; ++i) seen |= i < r && emitted[i] == s;
      if (!seen && before(pcost, s, bc, bs)) {
        bc = pcost;
        bs = s;
      }
    }
    const int cmin = __reduce_min_sync(FULL, bc);
    const int smin = __reduce_min_sync(FULL, bc == cmin ? bs : n);
    const bool has = cmin < INF;
    emitted[r] = has ? smin : n;
    if (t == 0) {
      const long o = (v * KP + r) * lanes + b;
      parents[o] = has ? smin : n;
      pdist[o] = has ? cmin : INF;
      pweight[o] = has ? np[(long)smin * lanes + b] : 0;
    }
  }
}

unsigned row_blocks(long rows) { return (unsigned)((rows + WARPS - 1) / WARPS); }

template <int KP>
void launch_parent_sets(const int* s, const int* c, const int* e, const int* m, const int* d,
                        const int* np, const int* r, int* parents, int* pdist, int* pweight,
                        int n, int k, int lanes, cudaStream_t st) {
  if (lanes <= SMALL) {
    ell_parent_sets_rows<KP><<<row_blocks((long)n * lanes), WARPS * 32, 0, st>>>(
        s, c, e, m, d, np, r, parents, pdist, pweight, n, k, lanes);
  } else {
    ell_parent_sets_tile<KP><<<dim3(row_blocks(n), (lanes + 31) / 32), WARPS * 32, 0, st>>>(
        s, c, e, m, d, np, r, parents, pdist, pweight, n, k, lanes);
  }
}

}  // namespace

extern "C" {

int holo_ell_mp_round(const void* src, const void* dag, const void* direct, const void* inc,
                      const void* roots, const void* parent, const void* hops, const void* nh,
                      const void* np, const void* aw, void* hops_out, void* nh_out,
                      void* np_out, void* aw_out, void* changed, int n, int k, int lanes,
                      int nwords, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (n <= 0 || lanes <= 0 || nwords <= 0) return (int)cudaGetLastError();
  const int *s = (const int*)src, *dg = (const int*)dag, *dr = (const int*)direct;
  const int *ic = (const int*)inc, *r = (const int*)roots, *p = (const int*)parent;
  const int *h = (const int*)hops, *x = (const int*)nh, *c = (const int*)np;
  const int* a = (const int*)aw;
  int *ho = (int*)hops_out, *xo = (int*)nh_out, *co = (int*)np_out, *ao = (int*)aw_out;
  int* ch = (int*)changed;
  const bool mp = np != nullptr;
  if (lanes <= SMALL) {
    const dim3 grid(row_blocks(n), nwords);
    if (mp)
      ell_mp_round_rows<true><<<grid, WARPS * 32, 0, st>>>(s, dg, dr, ic, r, p, h, x, c, a, ho,
                                                           xo, co, ao, ch, n, k, lanes, nwords);
    else
      ell_mp_round_rows<false><<<grid, WARPS * 32, 0, st>>>(s, dg, dr, ic, r, p, h, x, c, a, ho,
                                                            xo, co, ao, ch, n, k, lanes, nwords);
  } else {
    const dim3 grid(row_blocks(n), ((lanes + 31) / 32) * nwords);
    if (mp)
      ell_mp_round_tile<true><<<grid, WARPS * 32, 0, st>>>(s, dg, dr, ic, r, p, h, x, c, a, ho,
                                                           xo, co, ao, ch, n, k, lanes, nwords);
    else
      ell_mp_round_tile<false><<<grid, WARPS * 32, 0, st>>>(s, dg, dr, ic, r, p, h, x, c, a, ho,
                                                            xo, co, ao, ch, n, k, lanes, nwords);
  }
  return (int)cudaGetLastError();
}

int holo_ell_parent_sets(const void* src, const void* cost, const void* slot, const void* mask,
                         const void* dist, const void* np, const void* roots, void* parents,
                         void* pdist, void* pweight, int n, int k, int lanes, int kp,
                         void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (n <= 0 || lanes <= 0) return (int)cudaGetLastError();
  const int *s = (const int*)src, *c = (const int*)cost, *e = (const int*)slot;
  const int *m = (const int*)mask, *d = (const int*)dist, *w = (const int*)np;
  const int* r = (const int*)roots;
  int *pa = (int*)parents, *pd = (int*)pdist, *pw = (int*)pweight;
  switch (kp) {  // the widths mp_pad gives past single path
    case 2: launch_parent_sets<2>(s, c, e, m, d, w, r, pa, pd, pw, n, k, lanes, st); break;
    case 4: launch_parent_sets<4>(s, c, e, m, d, w, r, pa, pd, pw, n, k, lanes, st); break;
    case 8: launch_parent_sets<8>(s, c, e, m, d, w, r, pa, pd, pw, n, k, lanes, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
