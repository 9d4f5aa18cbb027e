// ELL fixpoint-round kernels of the gather SPF engine for Hopper (sm_90a),
// plain C interface for ctypes.
//
// The JAX package runs each of these steps inside lax.while_loop, where XLA
// fuses the gather, add, select and reduction over the K in-edge slots into
// one loop fusion; there is no Pallas kernel.  In eager PyTorch each step
// would write several [lanes, N, K] temporaries (3.98 GB each at 10,125
// vertices x 96 slots x 1024 lanes), so each is one hand-written kernel:
//
//   ell_relax        <- holo_tpu/ops/spf_engine.py:860-866, the body of
//                       sssp_distances: one Bellman-Ford round
//   ell_first_parent <- :872-894, _sp_dag + _first_parent: the DAG test
//                       and the lexicographic argmin of (dist[u], u)
//   ell_nh_seed      <- :976-991, the next-hop seed of spf_one: the OR of
//                       the direct atom words over DAG slots whose source
//                       has hops 0
//   ell_nh_round     <- :993-1005, one round of the next-hop inherit
//                       fixpoint, every word at once
//
// Planes (int32, INF = 1<<30 unreachable): src, cost, slot [N, K] (slot =
// the in-edge's edge id, -1 for padding); mask [E, ceil(B/32)] with bit b%32
// of word [e, b/32] set where edge e is up in lane b, or NULL (every edge
// up); vertex planes [N, B] and next-hop planes [N, W, B], lanes minor, so a
// warp's gather of plane[src, b0 .. b0+31] is one 128-byte line.  Slot
// (v, k) is usable in lane b iff slot >= 0 and its mask bit is set; it is a
// DAG in-edge iff also d = dist[src] < INF, dist[v] < INF, d + cost ==
// dist[v], and v is not lane b's root.  Adds wrap as JAX's int32 adds do
// (done in unsigned arithmetic).
//
// What bounds them.  Every slot's source row is gathered for every lane:
// 729,000 valid slots x 1024 lanes x 4 bytes = 3.0 GB of gathers a relax
// round at the k=90 fat tree, from L2 (the 41 MB dist plane mostly stays
// there), against 0.19 GB that the function must move (mask bits, dist in
// and out, the slot planes).  So these simple kernels are bound by the L2
// and load-issue rate of the gathers, not by device memory or by the int32
// rate; staging source rows in shared memory does not apply to an arbitrary
// ELL graph the way it does to the blocked engine's 256-vertex blocks.
//
// Tile form (more than SMALL lanes).  A warp owns one destination row and a
// group of TG 32-lane tiles (256 lanes), one lane of each tile a thread, so
// each accumulator lives in a register.  The warp loads 32 slots at a time
// (one a thread) and broadcasts each with __shfl_sync; a slot's mask words
// for the group's tiles are 32 contiguous bytes (one sector), read by the
// first TG threads and broadcast per tile.  Every edge has exactly one slot,
// so each mask word is read once per launch.  A tile whose mask word (or
// inherit word) is 0 skips its gather.  Lane groups vary fastest in the
// grid, so the blocks of one row group run together and share its slot
// planes in L2.
//
// Row form (up to SMALL lanes: compute() is one lane, small multi-root
// batches a few).  A tile would leave most threads idle, so a warp owns one
// destination row and all its lanes, each thread takes slots k = t, t + 32,
// ... (three at K = 96) and the warp meets in __reduce_min_sync (relax, and
// a two-step min for the (distance, id) argmin) or __reduce_or_sync.
//
// ell_nh_seed writes, besides the seed, the inherit bits [N, K, ceil(B/32)]
// (bit b of word [v, k, b/32]: DAG slot whose source has hops != 0), which
// every ell_nh_round then reads instead of repeating the DAG test: a round
// reads 4 bytes per (slot, 32 lanes) and gathers next hops only for the
// inherit pairs.  The words of a slot are written whole (a __ballot_sync of
// the tile, or one thread's word in the row form), so no atomics and no
// zero fill are needed.  Next-hop words go in chunks of WC per block
// (gridDim.z); the inherit bits are written by chunk 0.
//
// Changed flags: a warp that changed any element votes (__any_sync) and its
// first thread stores 1; the wrapper zeroes the flag before the launch.

#include <cuda_runtime.h>

namespace {

constexpr int INF = 1 << 30;
constexpr unsigned FULL = 0xffffffffu;
constexpr int SMALL = 8;   // lane counts up to this: *_rows kernels
constexpr int TG = 8;      // 32-lane tiles a warp of a *_tile kernel takes
constexpr int WARPS = 8;   // warps (destination rows) per thread block
constexpr int WC = 2;      // next-hop words per block (a chunk of W)

__device__ __forceinline__ int add32(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

// The slot's mask word of tile `tile` (FULL without a mask).
__device__ __forceinline__ unsigned mask_word(const int* __restrict__ mask,
                                              int e, int words, int tile) {
  return mask == nullptr ? FULL : (unsigned)__ldg(mask + (long)e * words + tile);
}

// One Bellman-Ford round, tile form: blockIdx.x = lane group, blockIdx.y =
// row block.
__global__ void __launch_bounds__(WARPS * 32)
ell_relax_tile(const int* __restrict__ src, const int* __restrict__ cost,
               const int* __restrict__ slot, const int* __restrict__ mask,
               const int* __restrict__ dist, int* __restrict__ out,
               int* __restrict__ changed, int n, int k, int lanes) {
  const int t = threadIdx.x % 32;
  const long v = (long)blockIdx.y * WARPS + threadIdx.x / 32;
  if (v >= n) return;
  const int words = (lanes + 31) / 32;
  const int tile0 = blockIdx.x * TG;
  const int ntiles = min(TG, words - tile0);
  int acc[TG];
#pragma unroll
  for (int g = 0; g < TG; ++g) acc[g] = INF;
  const long row = v * k;
  for (int k0 = 0; k0 < k; k0 += 32) {
    int s = 0, c = 0, e = -1;
    if (k0 + t < k) {
      s = __ldg(src + row + k0 + t);
      c = __ldg(cost + row + k0 + t);
      e = __ldg(slot + row + k0 + t);
    }
    const int cnt = min(32, k - k0);
    for (int j = 0; j < cnt; ++j) {
      const int ej = __shfl_sync(FULL, e, j);
      if (ej < 0) continue;  // the same for the whole warp
      const int sj = __shfl_sync(FULL, s, j);
      const int cj = __shfl_sync(FULL, c, j);
      const unsigned mw = t < ntiles ? mask_word(mask, ej, words, tile0 + t) : 0u;
#pragma unroll
      for (int g = 0; g < TG; ++g) {
        const unsigned m = __shfl_sync(FULL, mw, g);
        const int b = (tile0 + g) * 32 + t;
        if (g < ntiles && ((m >> t) & 1u) && b < lanes) {
          const int du = __ldg(dist + (long)sj * lanes + b);
          if (du < INF) acc[g] = min(acc[g], add32(du, cj));
        }
      }
    }
  }
  bool ch = false;
#pragma unroll
  for (int g = 0; g < TG; ++g) {
    const int b = (tile0 + g) * 32 + t;
    if (g < ntiles && b < lanes) {
      const long o = v * lanes + b;
      const int d = dist[o];
      const int nv = min(d, acc[g]);
      out[o] = nv;
      ch |= nv != d;
    }
  }
  if (__any_sync(FULL, ch) && t == 0) *changed = 1;
}

// One Bellman-Ford round, row form: blockIdx.x = row block.
__global__ void __launch_bounds__(WARPS * 32)
ell_relax_rows(const int* __restrict__ src, const int* __restrict__ cost,
               const int* __restrict__ slot, const int* __restrict__ mask,
               const int* __restrict__ dist, int* __restrict__ out,
               int* __restrict__ changed, int n, int k, int lanes) {
  const int t = threadIdx.x % 32;
  const long v = (long)blockIdx.x * WARPS + threadIdx.x / 32;
  if (v >= n) return;
  int acc[SMALL];
#pragma unroll
  for (int b = 0; b < SMALL; ++b) acc[b] = INF;
  const long row = v * k;
  for (int kk = t; kk < k; kk += 32) {
    const int e = __ldg(slot + row + kk);
    if (e < 0) continue;
    const int s = __ldg(src + row + kk), c = __ldg(cost + row + kk);
    const unsigned m = mask_word(mask, e, 1, 0);
#pragma unroll
    for (int b = 0; b < SMALL; ++b) {
      if (b < lanes && ((m >> b) & 1u)) {
        const int du = __ldg(dist + (long)s * lanes + b);
        if (du < INF) acc[b] = min(acc[b], add32(du, c));
      }
    }
  }
  bool ch = false;
#pragma unroll
  for (int b = 0; b < SMALL; ++b) {
    if (b < lanes) {
      const int r = __reduce_min_sync(FULL, acc[b]);
      if (t == b) {
        const int d = dist[v * lanes + b];
        const int nv = min(d, r);
        out[v * lanes + b] = nv;
        ch = nv != d;
      }
    }
  }
  if (__any_sync(FULL, ch) && t == 0) *changed = 1;
}

// The (distance, id) lexicographic min of the DAG parents, tile form.
__global__ void __launch_bounds__(WARPS * 32)
ell_first_parent_tile(const int* __restrict__ src, const int* __restrict__ cost,
                      const int* __restrict__ slot, const int* __restrict__ mask,
                      const int* __restrict__ dist, const int* __restrict__ roots,
                      int* __restrict__ parent, int n, int k, int lanes) {
  const int t = threadIdx.x % 32;
  const long v = (long)blockIdx.y * WARPS + threadIdx.x / 32;
  if (v >= n) return;
  const int words = (lanes + 31) / 32;
  const int tile0 = blockIdx.x * TG;
  const int ntiles = min(TG, words - tile0);
  int dv[TG], bd[TG], bs[TG];
  bool live[TG];
#pragma unroll
  for (int g = 0; g < TG; ++g) {
    const int b = (tile0 + g) * 32 + t;
    const bool ok = g < ntiles && b < lanes;
    dv[g] = ok ? dist[v * lanes + b] : INF;
    live[g] = ok && dv[g] < INF && roots[b] != v;
    bd[g] = INF;
    bs[g] = n;
  }
  const long row = v * k;
  for (int k0 = 0; k0 < k; k0 += 32) {
    int s = 0, c = 0, e = -1;
    if (k0 + t < k) {
      s = __ldg(src + row + k0 + t);
      c = __ldg(cost + row + k0 + t);
      e = __ldg(slot + row + k0 + t);
    }
    const int cnt = min(32, k - k0);
    for (int j = 0; j < cnt; ++j) {
      const int ej = __shfl_sync(FULL, e, j);
      if (ej < 0) continue;
      const int sj = __shfl_sync(FULL, s, j);
      const int cj = __shfl_sync(FULL, c, j);
      const unsigned mw = t < ntiles ? mask_word(mask, ej, words, tile0 + t) : 0u;
#pragma unroll
      for (int g = 0; g < TG; ++g) {
        const unsigned m = __shfl_sync(FULL, mw, g);
        const int b = (tile0 + g) * 32 + t;
        if (live[g] && ((m >> t) & 1u)) {
          const int du = __ldg(dist + (long)sj * lanes + b);
          if (du < INF && add32(du, cj) == dv[g] &&
              (du < bd[g] || (du == bd[g] && sj < bs[g]))) {
            bd[g] = du;
            bs[g] = sj;
          }
        }
      }
    }
  }
#pragma unroll
  for (int g = 0; g < TG; ++g) {
    const int b = (tile0 + g) * 32 + t;
    if (g < ntiles && b < lanes) parent[v * lanes + b] = bs[g];
  }
}

// The (distance, id) lexicographic min of the DAG parents, row form: the
// warp meets in the min distance, then in the min id among the threads
// that hold it.
__global__ void __launch_bounds__(WARPS * 32)
ell_first_parent_rows(const int* __restrict__ src, const int* __restrict__ cost,
                      const int* __restrict__ slot, const int* __restrict__ mask,
                      const int* __restrict__ dist, const int* __restrict__ roots,
                      int* __restrict__ parent, int n, int k, int lanes) {
  const int t = threadIdx.x % 32;
  const long v = (long)blockIdx.x * WARPS + threadIdx.x / 32;
  if (v >= n) return;
  int dv[SMALL], bd[SMALL], bs[SMALL];
  bool live[SMALL];
#pragma unroll
  for (int b = 0; b < SMALL; ++b) {
    dv[b] = b < lanes ? dist[v * lanes + b] : INF;
    live[b] = b < lanes && dv[b] < INF && roots[b] != v;
    bd[b] = INF;
    bs[b] = n;
  }
  const long row = v * k;
  for (int kk = t; kk < k; kk += 32) {
    const int e = __ldg(slot + row + kk);
    if (e < 0) continue;
    const int s = __ldg(src + row + kk), c = __ldg(cost + row + kk);
    const unsigned m = mask_word(mask, e, 1, 0);
#pragma unroll
    for (int b = 0; b < SMALL; ++b) {
      if (live[b] && ((m >> b) & 1u)) {
        const int du = __ldg(dist + (long)s * lanes + b);
        if (du < INF && add32(du, c) == dv[b] &&
            (du < bd[b] || (du == bd[b] && s < bs[b]))) {
          bd[b] = du;
          bs[b] = s;
        }
      }
    }
  }
#pragma unroll
  for (int b = 0; b < SMALL; ++b) {
    if (b < lanes) {
      const int m = __reduce_min_sync(FULL, bd[b]);
      const int id = __reduce_min_sync(FULL, bd[b] == m ? bs[b] : n);
      if (t == b) parent[v * lanes + b] = id;
    }
  }
}

// Next-hop seed and inherit bits, tile form: blockIdx.z = word chunk.
__global__ void __launch_bounds__(WARPS * 32)
ell_nh_seed_tile(const int* __restrict__ src, const int* __restrict__ cost,
                 const int* __restrict__ slot, const int* __restrict__ mask,
                 const int* __restrict__ dist, const int* __restrict__ hops,
                 const int* __restrict__ roots, const int* __restrict__ direct,
                 int* __restrict__ seed, int* __restrict__ inherit, int n,
                 int k, int lanes, int nwords) {
  const int t = threadIdx.x % 32;
  const long v = (long)blockIdx.y * WARPS + threadIdx.x / 32;
  if (v >= n) return;
  const int words = (lanes + 31) / 32;
  const int tile0 = blockIdx.x * TG;
  const int ntiles = min(TG, words - tile0);
  const int w0 = blockIdx.z * WC;
  const bool two = w0 + 1 < nwords;
  const bool bits_out = blockIdx.z == 0;
  int dv[TG];
  bool live[TG];
  unsigned a0[TG], a1[TG];
#pragma unroll
  for (int g = 0; g < TG; ++g) {
    const int b = (tile0 + g) * 32 + t;
    const bool ok = g < ntiles && b < lanes;
    dv[g] = ok ? dist[v * lanes + b] : INF;
    live[g] = ok && dv[g] < INF && roots[b] != v;
    a0[g] = a1[g] = 0u;
  }
  const long row = v * k;
  for (int k0 = 0; k0 < k; k0 += 32) {
    int s = 0, c = 0, e = -1;
    if (k0 + t < k) {
      s = __ldg(src + row + k0 + t);
      c = __ldg(cost + row + k0 + t);
      e = __ldg(slot + row + k0 + t);
    }
    const int cnt = min(32, k - k0);
    for (int j = 0; j < cnt; ++j) {
      const long sl = row + k0 + j;
      const int ej = __shfl_sync(FULL, e, j);
      if (ej < 0) {
        if (bits_out && t < ntiles) inherit[sl * words + tile0 + t] = 0;
        continue;
      }
      const int sj = __shfl_sync(FULL, s, j);
      const int cj = __shfl_sync(FULL, c, j);
      const unsigned mw = t < ntiles ? mask_word(mask, ej, words, tile0 + t) : 0u;
      const unsigned d0 = (unsigned)__ldg(direct + sl * nwords + w0);
      const unsigned d1 = two ? (unsigned)__ldg(direct + sl * nwords + w0 + 1) : 0u;
      unsigned mine = 0u;  // thread g keeps tile g's inherit word
#pragma unroll
      for (int g = 0; g < TG; ++g) {
        const unsigned m = __shfl_sync(FULL, mw, g);
        const int b = (tile0 + g) * 32 + t;
        bool inh = false;
        if (live[g] && ((m >> t) & 1u)) {
          const int du = __ldg(dist + (long)sj * lanes + b);
          if (du < INF && add32(du, cj) == dv[g]) {
            if (__ldg(hops + (long)sj * lanes + b) == 0) {
              a0[g] |= d0;
              a1[g] |= d1;
            } else {
              inh = true;
            }
          }
        }
        const unsigned bal = __ballot_sync(FULL, inh);
        if (t == g) mine = bal;
      }
      if (bits_out && t < ntiles) inherit[sl * words + tile0 + t] = (int)mine;
    }
  }
#pragma unroll
  for (int g = 0; g < TG; ++g) {
    const int b = (tile0 + g) * 32 + t;
    if (g < ntiles && b < lanes) {
      seed[(v * nwords + w0) * lanes + b] = (int)a0[g];
      if (two) seed[(v * nwords + w0 + 1) * lanes + b] = (int)a1[g];
    }
  }
}

// Next-hop seed and inherit bits, row form: blockIdx.y = word chunk; one
// inherit word per slot (at most SMALL lanes), written by its thread.
__global__ void __launch_bounds__(WARPS * 32)
ell_nh_seed_rows(const int* __restrict__ src, const int* __restrict__ cost,
                 const int* __restrict__ slot, const int* __restrict__ mask,
                 const int* __restrict__ dist, const int* __restrict__ hops,
                 const int* __restrict__ roots, const int* __restrict__ direct,
                 int* __restrict__ seed, int* __restrict__ inherit, int n,
                 int k, int lanes, int nwords) {
  const int t = threadIdx.x % 32;
  const long v = (long)blockIdx.x * WARPS + threadIdx.x / 32;
  if (v >= n) return;
  const int w0 = blockIdx.y * WC;
  const bool two = w0 + 1 < nwords;
  int dv[SMALL];
  bool live[SMALL];
  unsigned a0[SMALL], a1[SMALL];
#pragma unroll
  for (int b = 0; b < SMALL; ++b) {
    dv[b] = b < lanes ? dist[v * lanes + b] : INF;
    live[b] = b < lanes && dv[b] < INF && roots[b] != v;
    a0[b] = a1[b] = 0u;
  }
  const long row = v * k;
  for (int kk = t; kk < k; kk += 32) {
    const long sl = row + kk;
    const int e = __ldg(slot + sl);
    unsigned inh = 0u;
    if (e >= 0) {
      const int s = __ldg(src + sl), c = __ldg(cost + sl);
      const unsigned m = mask_word(mask, e, 1, 0);
      const unsigned d0 = (unsigned)__ldg(direct + sl * nwords + w0);
      const unsigned d1 = two ? (unsigned)__ldg(direct + sl * nwords + w0 + 1) : 0u;
#pragma unroll
      for (int b = 0; b < SMALL; ++b) {
        if (live[b] && ((m >> b) & 1u)) {
          const int du = __ldg(dist + (long)s * lanes + b);
          if (du < INF && add32(du, c) == dv[b]) {
            if (__ldg(hops + (long)s * lanes + b) == 0) {
              a0[b] |= d0;
              a1[b] |= d1;
            } else {
              inh |= 1u << b;
            }
          }
        }
      }
    }
    if (blockIdx.y == 0) inherit[sl] = (int)inh;
  }
#pragma unroll
  for (int b = 0; b < SMALL; ++b) {
    if (b < lanes) {
      const unsigned r0 = __reduce_or_sync(FULL, a0[b]);
      const unsigned r1 = __reduce_or_sync(FULL, a1[b]);
      if (t == b) {
        seed[(v * nwords + w0) * lanes + b] = (int)r0;
        if (two) seed[(v * nwords + w0 + 1) * lanes + b] = (int)r1;
      }
    }
  }
}

// One next-hop inherit round, tile form: blockIdx.z = word chunk.
__global__ void __launch_bounds__(WARPS * 32)
ell_nh_round_tile(const int* __restrict__ src, const int* __restrict__ inherit,
                  const int* __restrict__ nh, int* __restrict__ out,
                  int* __restrict__ changed, int n, int k, int lanes,
                  int nwords) {
  const int t = threadIdx.x % 32;
  const long v = (long)blockIdx.y * WARPS + threadIdx.x / 32;
  if (v >= n) return;
  const int words = (lanes + 31) / 32;
  const int tile0 = blockIdx.x * TG;
  const int ntiles = min(TG, words - tile0);
  const int w0 = blockIdx.z * WC;
  const bool two = w0 + 1 < nwords;
  const long plane = (long)lanes;  // stride of one word plane in a row
  unsigned a0[TG], a1[TG];
#pragma unroll
  for (int g = 0; g < TG; ++g) a0[g] = a1[g] = 0u;
  const long row = v * k;
  for (int k0 = 0; k0 < k; k0 += 32) {
    const int s = k0 + t < k ? __ldg(src + row + k0 + t) : 0;
    const int cnt = min(32, k - k0);
    for (int j = 0; j < cnt; ++j) {
      const int sj = __shfl_sync(FULL, s, j);
      const unsigned iw =
          t < ntiles ? (unsigned)__ldg(inherit + (row + k0 + j) * words + tile0 + t) : 0u;
      if (!__any_sync(FULL, iw != 0u)) continue;
      const long base = ((long)sj * nwords + w0) * plane;
#pragma unroll
      for (int g = 0; g < TG; ++g) {
        const unsigned m = __shfl_sync(FULL, iw, g);
        if ((m >> t) & 1u) {
          const int b = (tile0 + g) * 32 + t;
          a0[g] |= (unsigned)__ldg(nh + base + b);
          if (two) a1[g] |= (unsigned)__ldg(nh + base + plane + b);
        }
      }
    }
  }
  bool ch = false;
#pragma unroll
  for (int g = 0; g < TG; ++g) {
    const int b = (tile0 + g) * 32 + t;
    if (g < ntiles && b < lanes) {
      const long o = (v * nwords + w0) * plane + b;
      const unsigned x0 = (unsigned)nh[o], n0 = x0 | a0[g];
      out[o] = (int)n0;
      ch |= n0 != x0;
      if (two) {
        const unsigned x1 = (unsigned)nh[o + plane], n1 = x1 | a1[g];
        out[o + plane] = (int)n1;
        ch |= n1 != x1;
      }
    }
  }
  if (__any_sync(FULL, ch) && t == 0) *changed = 1;
}

// One next-hop inherit round, row form: blockIdx.y = word chunk.
__global__ void __launch_bounds__(WARPS * 32)
ell_nh_round_rows(const int* __restrict__ src, const int* __restrict__ inherit,
                  const int* __restrict__ nh, int* __restrict__ out,
                  int* __restrict__ changed, int n, int k, int lanes,
                  int nwords) {
  const int t = threadIdx.x % 32;
  const long v = (long)blockIdx.x * WARPS + threadIdx.x / 32;
  if (v >= n) return;
  const int w0 = blockIdx.y * WC;
  const bool two = w0 + 1 < nwords;
  const long plane = (long)lanes;
  unsigned a0[SMALL], a1[SMALL];
#pragma unroll
  for (int b = 0; b < SMALL; ++b) a0[b] = a1[b] = 0u;
  const long row = v * k;
  for (int kk = t; kk < k; kk += 32) {
    const unsigned iw = (unsigned)__ldg(inherit + row + kk);
    if (iw == 0u) continue;
    const long base = ((long)__ldg(src + row + kk) * nwords + w0) * plane;
#pragma unroll
    for (int b = 0; b < SMALL; ++b) {
      if ((iw >> b) & 1u) {
        a0[b] |= (unsigned)__ldg(nh + base + b);
        if (two) a1[b] |= (unsigned)__ldg(nh + base + plane + b);
      }
    }
  }
  bool ch = false;
#pragma unroll
  for (int b = 0; b < SMALL; ++b) {
    if (b < lanes) {
      const unsigned r0 = __reduce_or_sync(FULL, a0[b]);
      const unsigned r1 = __reduce_or_sync(FULL, a1[b]);
      if (t == b) {
        const long o = (v * nwords + w0) * plane + b;
        const unsigned x0 = (unsigned)nh[o], n0 = x0 | r0;
        out[o] = (int)n0;
        ch = n0 != x0;
        if (two) {
          const unsigned x1 = (unsigned)nh[o + plane], n1 = x1 | r1;
          out[o + plane] = (int)n1;
          ch |= n1 != x1;
        }
      }
    }
  }
  if (__any_sync(FULL, ch) && t == 0) *changed = 1;
}

unsigned row_blocks(int n) { return (unsigned)((n + WARPS - 1) / WARPS); }
unsigned lane_groups(int lanes) { return (unsigned)(((lanes + 31) / 32 + TG - 1) / TG); }
unsigned word_chunks(int nwords) { return (unsigned)((nwords + WC - 1) / WC); }

}  // namespace

extern "C" {

int holo_ell_relax(const void* src, const void* cost, const void* slot,
                   const void* mask, const void* dist, void* out,
                   void* changed, int n, int k, int lanes, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int *s = (const int*)src, *c = (const int*)cost, *e = (const int*)slot;
  const int *m = (const int*)mask, *d = (const int*)dist;
  if (n > 0 && lanes > 0 && lanes <= SMALL) {
    ell_relax_rows<<<row_blocks(n), WARPS * 32, 0, st>>>(
        s, c, e, m, d, (int*)out, (int*)changed, n, k, lanes);
  } else if (n > 0 && lanes > 0) {
    ell_relax_tile<<<dim3(lane_groups(lanes), row_blocks(n)), WARPS * 32, 0, st>>>(
        s, c, e, m, d, (int*)out, (int*)changed, n, k, lanes);
  }
  return (int)cudaGetLastError();
}

int holo_ell_first_parent(const void* src, const void* cost, const void* slot,
                          const void* mask, const void* dist,
                          const void* roots, void* parent, int n, int k,
                          int lanes, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int *s = (const int*)src, *c = (const int*)cost, *e = (const int*)slot;
  const int *m = (const int*)mask, *d = (const int*)dist, *r = (const int*)roots;
  if (n > 0 && lanes > 0 && lanes <= SMALL) {
    ell_first_parent_rows<<<row_blocks(n), WARPS * 32, 0, st>>>(
        s, c, e, m, d, r, (int*)parent, n, k, lanes);
  } else if (n > 0 && lanes > 0) {
    ell_first_parent_tile<<<dim3(lane_groups(lanes), row_blocks(n)), WARPS * 32, 0,
                            st>>>(s, c, e, m, d, r, (int*)parent, n, k, lanes);
  }
  return (int)cudaGetLastError();
}

int holo_ell_nh_seed(const void* src, const void* cost, const void* slot,
                     const void* mask, const void* dist, const void* hops,
                     const void* roots, const void* direct, void* seed,
                     void* inherit, int n, int k, int lanes, int nwords,
                     void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int *s = (const int*)src, *c = (const int*)cost, *e = (const int*)slot;
  const int *m = (const int*)mask, *d = (const int*)dist, *h = (const int*)hops;
  const int *r = (const int*)roots, *dr = (const int*)direct;
  if (n > 0 && lanes > 0 && nwords > 0 && lanes <= SMALL) {
    ell_nh_seed_rows<<<dim3(row_blocks(n), word_chunks(nwords)), WARPS * 32, 0, st>>>(
        s, c, e, m, d, h, r, dr, (int*)seed, (int*)inherit, n, k, lanes, nwords);
  } else if (n > 0 && lanes > 0 && nwords > 0) {
    ell_nh_seed_tile<<<dim3(lane_groups(lanes), row_blocks(n), word_chunks(nwords)),
                       WARPS * 32, 0, st>>>(s, c, e, m, d, h, r, dr, (int*)seed,
                                            (int*)inherit, n, k, lanes, nwords);
  }
  return (int)cudaGetLastError();
}

int holo_ell_nh_round(const void* src, const void* inherit, const void* nh,
                      void* out, void* changed, int n, int k, int lanes,
                      int nwords, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int *s = (const int*)src, *i = (const int*)inherit, *x = (const int*)nh;
  if (n > 0 && lanes > 0 && nwords > 0 && lanes <= SMALL) {
    ell_nh_round_rows<<<dim3(row_blocks(n), word_chunks(nwords)), WARPS * 32, 0, st>>>(
        s, i, x, (int*)out, (int*)changed, n, k, lanes, nwords);
  } else if (n > 0 && lanes > 0 && nwords > 0) {
    ell_nh_round_tile<<<dim3(lane_groups(lanes), row_blocks(n), word_chunks(nwords)),
                        WARPS * 32, 0, st>>>(s, i, x, (int*)out, (int*)changed, n, k,
                                             lanes, nwords);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
