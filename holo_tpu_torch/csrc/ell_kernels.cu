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
//                       and the lexicographic argmin of (dist[u], u); it
//                       writes the DAG as bits
//   ell_nh_seed      <- :976-991, the next-hop seed of spf_one: the OR of
//                       the direct atom words over DAG slots whose source
//                       has hops 0, and the bits of the other DAG slots
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
// What bounds them.  A round that gathered every usable slot's source row in
// every lane would move 729,000 valid slots x 1024 lanes x 4 bytes = 3.0 GB
// at the k=90 fat tree, against ~0.19 GB that the function must move (mask
// bits, dist in and out, the slot planes).  ell_first_parent still does
// that, once a dispatch, bound by the rate of its gathers.  It is the only
// kernel that runs the DAG test: it writes the DAG bits [N, K, ceil(B/32)]
// (bit b of word [v, k, b/32]: slot k is a DAG in-edge of v in lane b; 124 MB
// at k=90 x 1024), and ell_nh_seed gathers no distance and no hops.  Per
// (slot, tile) whose DAG word d is not 0 it loads one word h = hop0[src,
// tile] (lanes in which the source has hops 0, [N, ceil(B/32)], packed by
// nexthop_fixpoint, 1.3 MB: it stays in L2), writes the inherit word d & ~h,
// and ORs the slot's direct words into the seed of the lanes of d & h (46,080
// of 83 million DAG pairs at k=90 x 1024).  So it moves ~0.34 GB, bound by bytes:
// DAG bits in, inherit bits and seed out.
//
// ell_relax and ell_nh_round, which run every round, gather only from
// sources that changed (frontier words):
//
// - Each writes a frontier plane [N, ceil(B/32)] beside its output: bit b%32
//   of word [v, b/32] set where lane b of row v changed in this launch,
//   written whole by __ballot_sync (no atomics, no zero fill).  The next
//   launch takes it and skips a (slot, tile) where the source's frontier word
//   AND the slot's mask (or inherit) word is 0; it loads the mask or inherit
//   word only where the frontier word is not 0.  Exact: after a round
//   computed from prev, cur[v] <= prev[u] + cost (relax) and cur[v] is a
//   superset of prev[u] (next hops) for every usable or inherit source u, so
//   a source with cur[u] == prev[u] offers nothing; a frontier bit set where
//   nothing changed only costs work.  The driver builds the first frontier
//   (the roots; the nonzero seed words).
// - Lane slabs (ell_nh_round): the lane group is the slowest grid axis, so
//   the next-hop rows being gathered at any moment are one 128-lane slab of
//   both words (10.4 MB at k=90), not the whole 83 MB plane.  ell_relax
//   keeps the lane groups fastest: there the slab order measured slower.
// - Cache hints: slot planes, mask and inherit words and the row's own old
//   value are streamed with evict-first loads (__ldcs), outputs with
//   __stcs; the gathers carry an L2 evict_last policy.
// - Pipelined loads: per 32-slot chunk each thread loads its slot's planes,
//   then its frontier words and mask (inherit) words as vectors; the next
//   chunk's slot planes are in flight meanwhile.  The warp then walks each
//   tile's active slots (a ballot) eight gathers at a time, so no gather
//   waits on a load of its own iteration.  ell_first_parent walks its slots
//   the same way, with the lanes in which v is reached and not the root in
//   place of the frontier.
//
// What bounds them now.  Over a 6-round dispatch at k=90 x 1024 the active
// (slot, tile) pairs add up to about one full round of gathers; the rest is
// a fixed cost a round (dist in and out and the slot planes, ~96 MB; both
// next-hop words in and out, ~170 MB), which the rounds with few active
// pairs show at 3.5-5.5x its time at the HBM rate: each warp waits on a chain
// of dependent loads (slot planes, then frontier words, then mask or
// inherit words, per chunk, then its row's old values), and too few bytes
// are in flight.  Holding three chunks' words in registers (124 registers
// a thread, half the warps resident) and staging them in shared memory with
// cp.async (frontier words no longer read through L1) both measured slower.

// Tile form (more than SMALL lanes).  A warp owns one destination row and a
// group of 32-lane tiles (TG = 8 tiles, 256 lanes; ell_nh_round TGN = 4, 128
// lanes of every next-hop word; ell_first_parent TGP = 4, where 8 tiles took
// 128 registers a thread and half the resident warps, and ran 1.5x slower
// than 4 tiles held to 64), one lane of each tile a thread, so each
// accumulator lives in a register.  Every edge has exactly one slot, so each
// mask word is read at most once per launch.  Thread j of a chunk owns slot
// j's words (mask, DAG, inherit) for the group's tiles: 32 contiguous bytes,
// loaded and stored as two 16-byte vectors where the planes allow.
//
// Row form (up to SMALL lanes: compute() is one lane, small multi-root
// batches a few).  A tile would leave most threads idle, so a warp owns one
// destination row and all its lanes, each thread takes slots k = t, t + 32,
// ... (three at K = 96) and the warp meets in __reduce_min_sync (relax, and
// a two-step min for the (distance, id) argmin) or __reduce_or_sync.  The
// frontier plane is one word a row; ell_relax_rows and ell_nh_round_rows
// skip a slot whose source's word AND mask (inherit) word is 0.
//
// ell_nh_seed writes, besides the seed, the inherit bits [N, K, ceil(B/32)]
// (bit b of word [v, k, b/32]: DAG slot whose source has hops != 0), which
// every ell_nh_round then reads instead of repeating the DAG test.  The DAG
// and inherit words of every slot, padding and lanes past B included, are
// written whole (a __ballot_sync of the tile, or one thread's word in the row
// form), so no atomics and no zero fill are needed.  ell_nh_seed takes
// next-hop words in chunks of WC per block (gridDim.z; the inherit bits are
// written by chunk 0); ell_nh_round walks the chunks inside the block, so
// that one block writes a row's frontier word.
//
// Changed flags: a warp that changed any element votes (__any_sync) and its
// first thread stores 1; the wrapper zeroes the flag before the launch.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int INF = 1 << 30;
constexpr unsigned FULL = 0xffffffffu;
constexpr int SMALL = 8;   // lane counts up to this: *_rows kernels
constexpr int TG = 8;      // 32-lane tiles a warp of a *_tile kernel takes
constexpr int TGN = 4;     // ... of ell_nh_round_tile (both words of 128 lanes)
constexpr int TGP = 4;     // ... of ell_first_parent_tile (128 lanes)
constexpr int WARPS = 8;   // warps (destination rows) per thread block
constexpr int WC = 2;      // next-hop words per pass (a chunk of W)
constexpr int GATHERS = 8; // gathers a warp issues together

__device__ __forceinline__ int add32(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

// The slot's mask word of tile `tile` (FULL without a mask).
__device__ __forceinline__ unsigned mask_word(const int* __restrict__ mask,
                                              int e, int words, int tile) {
  return mask == nullptr ? FULL : (unsigned)__ldg(mask + (long)e * words + tile);
}

// The L2 policy of the gathers: keep the rows in L2 (evict_last).
__device__ __forceinline__ uint64_t keep_policy() {
  uint64_t pol;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(pol));
  return pol;
}

__device__ __forceinline__ int ld_gather(const int* p, uint64_t pol) {
  int x;
  asm("ld.global.nc.L2::cache_hint.b32 %0, [%1], %2;" : "=r"(x) : "l"(p), "l"(pol));
  return x;
}

// Words p[0 .. N) of which the first n exist (0 past them); `vec` (n == N,
// p 16-byte aligned) loads them as N / 4 int4 vectors.  CS streams them.
template <int N, bool CS>
__device__ __forceinline__ void ld_words(const int* p, int n, bool vec, unsigned (&w)[N]) {
  if (vec) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const int4* q = reinterpret_cast<const int4*>(p + i);
      int4 x;
      if constexpr (CS) x = __ldcs(q);
      else x = __ldg(q);
      w[i] = (unsigned)x.x;
      w[i + 1] = (unsigned)x.y;
      w[i + 2] = (unsigned)x.z;
      w[i + 3] = (unsigned)x.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) w[i] = i < n ? (unsigned)(CS ? __ldcs(p + i) : __ldg(p + i)) : 0u;
  }
}

// Words w[0 .. n) to p[0 .. n), streamed (__stcs); `vec` (n == N, p 16-byte
// aligned) stores them as N / 4 int4 vectors.
template <int N>
__device__ __forceinline__ void st_words(int* p, int n, bool vec, const unsigned (&w)[N]) {
  if (vec) {
#pragma unroll
    for (int i = 0; i < N; i += 4)
      __stcs(reinterpret_cast<int4*>(p + i),
             make_int4((int)w[i], (int)w[i + 1], (int)w[i + 2], (int)w[i + 3]));
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (i < n) __stcs(p + i, (int)w[i]);
  }
}

// One Bellman-Ford round, tile form: blockIdx.x = lane group, blockIdx.y =
// row block.
__global__ void __launch_bounds__(WARPS * 32)
ell_relax_tile(const int* __restrict__ src, const int* __restrict__ cost,
               const int* __restrict__ slot, const int* __restrict__ mask,
               const int* __restrict__ dist, const int* __restrict__ front,
               int* __restrict__ out, int* __restrict__ changed,
               int* __restrict__ front_out, int n, int k, int lanes, bool vec) {
  const int t = threadIdx.x % 32;
  const long v = (long)blockIdx.y * WARPS + threadIdx.x / 32;
  if (v >= n) return;
  const int words = (lanes + 31) / 32;
  const int tile0 = blockIdx.x * TG;
  const int ntiles = min(TG, words - tile0);
  const uint64_t pol = keep_policy();
  int acc[TG];
#pragma unroll
  for (int g = 0; g < TG; ++g) acc[g] = INF;
  const long row = v * k;
  int s = 0, c = 0, e = -1;
  if (t < k) {
    s = __ldcs(src + row + t);
    c = __ldcs(cost + row + t);
    e = __ldcs(slot + row + t);
  }
  for (int k0 = 0; k0 < k; k0 += 32) {
    int sn = 0, cn = 0, en = -1;  // the next chunk's slot, in flight
    if (k0 + 32 + t < k) {
      sn = __ldcs(src + row + k0 + 32 + t);
      cn = __ldcs(cost + row + k0 + 32 + t);
      en = __ldcs(slot + row + k0 + 32 + t);
    }
    // act[g]: lanes of tile g in which this thread's slot is usable and its
    // source changed.
    unsigned act[TG];
#pragma unroll
    for (int g = 0; g < TG; ++g) act[g] = 0u;
    if (e >= 0) {
      ld_words<TG, false>(front + (long)s * words + tile0, ntiles, vec, act);
      unsigned any = 0u;
#pragma unroll
      for (int g = 0; g < TG; ++g) any |= act[g];
      if (any != 0u && mask != nullptr) {
        unsigned m[TG];
        ld_words<TG, true>(mask + (long)e * words + tile0, ntiles, vec, m);
#pragma unroll
        for (int g = 0; g < TG; ++g) act[g] &= m[g];
      }
    }
#pragma unroll
    for (int g = 0; g < TG; ++g) {
      const int b = (tile0 + g) * 32 + t;
      unsigned todo = __ballot_sync(FULL, act[g] != 0u);  // this tile's active slots
      while (todo != 0u) {
        int du[GATHERS], cq[GATHERS];
#pragma unroll
        for (int q = 0; q < GATHERS; ++q) {
          du[q] = INF;
          cq[q] = 0;
          if (todo != 0u) {  // the same for the whole warp
            const int j = __ffs(todo) - 1;
            todo &= todo - 1u;
            const unsigned a = __shfl_sync(FULL, act[g], j);
            const int sj = __shfl_sync(FULL, s, j);
            cq[q] = __shfl_sync(FULL, c, j);
            if (((a >> t) & 1u) && b < lanes) du[q] = ld_gather(dist + (long)sj * lanes + b, pol);
          }
        }
#pragma unroll
        for (int q = 0; q < GATHERS; ++q)
          if (du[q] < INF) acc[g] = min(acc[g], add32(du[q], cq[q]));
      }
    }
    s = sn;
    c = cn;
    e = en;
  }
  bool ch = false;
#pragma unroll
  for (int g = 0; g < TG; ++g) {
    const int b = (tile0 + g) * 32 + t;
    const bool ok = g < ntiles && b < lanes;
    bool moved = false;
    if (ok) {
      const long o = v * lanes + b;
      const int d = __ldcs(dist + o);
      const int nv = min(d, acc[g]);
      __stcs(out + o, nv);
      moved = nv != d;
    }
    const unsigned word = __ballot_sync(FULL, moved);
    if (t == g && g < ntiles) __stcs(front_out + v * words + tile0 + g, (int)word);
    ch |= moved;
  }
  if (__any_sync(FULL, ch) && t == 0) *changed = 1;
}

// One Bellman-Ford round, row form: blockIdx.x = row block; one frontier
// word a row.
__global__ void __launch_bounds__(WARPS * 32)
ell_relax_rows(const int* __restrict__ src, const int* __restrict__ cost,
               const int* __restrict__ slot, const int* __restrict__ mask,
               const int* __restrict__ dist, const int* __restrict__ front,
               int* __restrict__ out, int* __restrict__ changed,
               int* __restrict__ front_out, int n, int k, int lanes) {
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
    const int s = __ldg(src + row + kk);
    const unsigned m = mask_word(mask, e, 1, 0) & (unsigned)__ldg(front + s);
    if (m == 0u) continue;
    const int c = __ldg(cost + row + kk);
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
  const unsigned word = __ballot_sync(FULL, ch);  // bit b: lane b (thread b)
  if (t == 0) {
    front_out[v] = (int)word;
    if (word != 0u) *changed = 1;
  }
}

// The (distance, id) lexicographic min of the DAG parents and the DAG bits,
// tile form: blockIdx.x = lane group, blockIdx.y = row block.  The slots are
// walked as in ell_relax_tile, with `live` (v reached and not the lane's
// root) in place of the frontier; thread j keeps slot j's DAG words.  At most
// 64 registers a thread (4 blocks resident per SM; ptxas spills a few words).
__global__ void __launch_bounds__(WARPS * 32, 4)
ell_first_parent_tile(const int* __restrict__ src, const int* __restrict__ cost,
                      const int* __restrict__ slot, const int* __restrict__ mask,
                      const int* __restrict__ dist, const int* __restrict__ roots,
                      int* __restrict__ parent, int* __restrict__ dag, int n, int k,
                      int lanes, bool vec) {
  const int t = threadIdx.x % 32;
  const long v = (long)blockIdx.y * WARPS + threadIdx.x / 32;
  if (v >= n) return;
  const int words = (lanes + 31) / 32;
  const int tile0 = blockIdx.x * TGP;
  const int ntiles = min(TGP, words - tile0);
  const uint64_t pol = keep_policy();
  int dv[TGP], bd[TGP], bs[TGP];
  unsigned live[TGP];  // lanes of tile g in which v is reached and not the root
  unsigned any_live = 0u;
#pragma unroll
  for (int g = 0; g < TGP; ++g) {
    const int b = (tile0 + g) * 32 + t;
    const bool ok = g < ntiles && b < lanes;
    dv[g] = ok ? __ldg(dist + v * lanes + b) : INF;
    live[g] = __ballot_sync(FULL, ok && dv[g] < INF && __ldg(roots + b) != v);
    any_live |= live[g];
    bd[g] = INF;
    bs[g] = n;
  }
  const long row = v * k;
  int s = 0, c = 0, e = -1;
  if (t < k) {
    s = __ldcs(src + row + t);
    c = __ldcs(cost + row + t);
    e = __ldcs(slot + row + t);
  }
  for (int k0 = 0; k0 < k; k0 += 32) {
    int sn = 0, cn = 0, en = -1;  // the next chunk's slot, in flight
    if (k0 + 32 + t < k) {
      sn = __ldcs(src + row + k0 + 32 + t);
      cn = __ldcs(cost + row + k0 + 32 + t);
      en = __ldcs(slot + row + k0 + 32 + t);
    }
    // act[g]: lanes of tile g in which this thread's slot is usable and v live.
    unsigned act[TGP];
#pragma unroll
    for (int g = 0; g < TGP; ++g) act[g] = 0u;
    if (e >= 0 && any_live != 0u) {
      if (mask != nullptr) {
        ld_words<TGP, true>(mask + (long)e * words + tile0, ntiles, vec, act);
      } else {
#pragma unroll
        for (int g = 0; g < TGP; ++g) act[g] = FULL;
      }
#pragma unroll
      for (int g = 0; g < TGP; ++g) act[g] &= live[g];
    }
    unsigned mine[TGP];  // this thread's slot's DAG words
#pragma unroll
    for (int g = 0; g < TGP; ++g) {
      const int b = (tile0 + g) * 32 + t;
      mine[g] = 0u;
      unsigned todo = __ballot_sync(FULL, act[g] != 0u);  // this tile's active slots
      while (todo != 0u) {
        int du[GATHERS], sq[GATHERS], cq[GATHERS], jq[GATHERS];
#pragma unroll
        for (int q = 0; q < GATHERS; ++q) {
          du[q] = INF;
          sq[q] = cq[q] = 0;
          jq[q] = -1;
          if (todo != 0u) {  // the same for the whole warp
            const int j = __ffs(todo) - 1;
            todo &= todo - 1u;
            const unsigned a = __shfl_sync(FULL, act[g], j);
            sq[q] = __shfl_sync(FULL, s, j);
            cq[q] = __shfl_sync(FULL, c, j);
            jq[q] = j;
            if ((a >> t) & 1u) du[q] = ld_gather(dist + (long)sq[q] * lanes + b, pol);
          }
        }
#pragma unroll
        for (int q = 0; q < GATHERS; ++q) {
          const bool tight = du[q] < INF && add32(du[q], cq[q]) == dv[g];
          if (tight && (du[q] < bd[g] || (du[q] == bd[g] && sq[q] < bs[g]))) {
            bd[g] = du[q];
            bs[g] = sq[q];
          }
          const unsigned word = __ballot_sync(FULL, tight);
          if (t == jq[q]) mine[g] = word;
        }
      }
    }
    if (k0 + t < k) st_words<TGP>(dag + (row + k0 + t) * words + tile0, ntiles, vec, mine);
    s = sn;
    c = cn;
    e = en;
  }
#pragma unroll
  for (int g = 0; g < TGP; ++g) {
    const int b = (tile0 + g) * 32 + t;
    if (g < ntiles && b < lanes) __stcs(parent + v * lanes + b, bs[g]);
  }
}

// The (distance, id) lexicographic min of the DAG parents and the DAG bits,
// row form: each thread writes its slots' DAG words (one a slot); the warp
// meets in the min distance, then in the min id among the threads that hold
// it.
__global__ void __launch_bounds__(WARPS * 32)
ell_first_parent_rows(const int* __restrict__ src, const int* __restrict__ cost,
                      const int* __restrict__ slot, const int* __restrict__ mask,
                      const int* __restrict__ dist, const int* __restrict__ roots,
                      int* __restrict__ parent, int* __restrict__ dag, int n, int k,
                      int lanes) {
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
    unsigned word = 0u;
    if (e >= 0) {
      const int s = __ldg(src + row + kk), c = __ldg(cost + row + kk);
      const unsigned m = mask_word(mask, e, 1, 0);
#pragma unroll
      for (int b = 0; b < SMALL; ++b) {
        if (live[b] && ((m >> b) & 1u)) {
          const int du = __ldg(dist + (long)s * lanes + b);
          if (du < INF && add32(du, c) == dv[b]) {
            word |= 1u << b;
            if (du < bd[b] || (du == bd[b] && s < bs[b])) {
              bd[b] = du;
              bs[b] = s;
            }
          }
        }
      }
    }
    dag[row + kk] = (int)word;
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

// Next-hop seed and inherit bits from the DAG bits, tile form: blockIdx.x =
// lane group, blockIdx.y = row block, blockIdx.z = word chunk.  Thread j
// takes slot j of each 32-slot chunk; the next chunk's src and DAG words are
// in flight while a chunk is split.
__global__ void __launch_bounds__(WARPS * 32)
ell_nh_seed_tile(const int* __restrict__ src, const int* __restrict__ dag,
                 const int* __restrict__ hop0, const int* __restrict__ direct,
                 int* __restrict__ seed, int* __restrict__ inherit, int n, int k,
                 int lanes, int nwords, bool vec) {
  const int t = threadIdx.x % 32;
  const long v = (long)blockIdx.y * WARPS + threadIdx.x / 32;
  if (v >= n) return;
  const int words = (lanes + 31) / 32;
  const int tile0 = blockIdx.x * TG;
  const int ntiles = min(TG, words - tile0);
  const int w0 = blockIdx.z * WC;
  const bool two = w0 + 1 < nwords;
  const bool bits_out = blockIdx.z == 0;
  unsigned a0[TG], a1[TG];
#pragma unroll
  for (int g = 0; g < TG; ++g) a0[g] = a1[g] = 0u;
  const long row = v * k;
  int s = 0;
  unsigned d[TG];  // this thread's slot's DAG words
#pragma unroll
  for (int g = 0; g < TG; ++g) d[g] = 0u;
  if (t < k) {
    s = __ldcs(src + row + t);
    ld_words<TG, true>(dag + (row + t) * words + tile0, ntiles, vec, d);
  }
  for (int k0 = 0; k0 < k; k0 += 32) {
    int sn = 0;  // the next chunk's slot, in flight
    unsigned dn[TG];
#pragma unroll
    for (int g = 0; g < TG; ++g) dn[g] = 0u;
    if (k0 + 32 + t < k) {
      sn = __ldcs(src + row + k0 + 32 + t);
      ld_words<TG, true>(dag + (row + k0 + 32 + t) * words + tile0, ntiles, vec, dn);
    }
    unsigned any = 0u, h[TG];
#pragma unroll
    for (int g = 0; g < TG; ++g) {
      any |= d[g];
      h[g] = 0u;
    }
    if (any != 0u) ld_words<TG, false>(hop0 + (long)s * words + tile0, ntiles, vec, h);
    unsigned dir[TG];  // DAG lanes whose source has hops 0; d keeps the others
#pragma unroll
    for (int g = 0; g < TG; ++g) {
      dir[g] = d[g] & h[g];
      d[g] &= ~h[g];
    }
    if (bits_out && k0 + t < k)
      st_words<TG>(inherit + (row + k0 + t) * words + tile0, ntiles, vec, d);
#pragma unroll
    for (int g = 0; g < TG; ++g) {
      unsigned todo = __ballot_sync(FULL, dir[g] != 0u);  // rare
      while (todo != 0u) {
        const int j = __ffs(todo) - 1;
        todo &= todo - 1u;
        const unsigned a = __shfl_sync(FULL, dir[g], j);
        const long sl = row + k0 + j;
        const unsigned x0 = (unsigned)__ldg(direct + sl * nwords + w0);
        const unsigned x1 = two ? (unsigned)__ldg(direct + sl * nwords + w0 + 1) : 0u;
        if ((a >> t) & 1u) {
          a0[g] |= x0;
          a1[g] |= x1;
        }
      }
    }
    s = sn;
#pragma unroll
    for (int g = 0; g < TG; ++g) d[g] = dn[g];
  }
#pragma unroll
  for (int g = 0; g < TG; ++g) {
    const int b = (tile0 + g) * 32 + t;
    if (g < ntiles && b < lanes) {
      __stcs(seed + (v * nwords + w0) * lanes + b, (int)a0[g]);
      if (two) __stcs(seed + (v * nwords + w0 + 1) * lanes + b, (int)a1[g]);
    }
  }
}

// Next-hop seed and inherit bits from the DAG bits, row form: blockIdx.y =
// word chunk; one DAG and one inherit word per slot (at most SMALL lanes).
__global__ void __launch_bounds__(WARPS * 32)
ell_nh_seed_rows(const int* __restrict__ src, const int* __restrict__ dag,
                 const int* __restrict__ hop0, const int* __restrict__ direct,
                 int* __restrict__ seed, int* __restrict__ inherit, int n, int k,
                 int lanes, int nwords) {
  const int t = threadIdx.x % 32;
  const long v = (long)blockIdx.x * WARPS + threadIdx.x / 32;
  if (v >= n) return;
  const int w0 = blockIdx.y * WC;
  const bool two = w0 + 1 < nwords;
  unsigned a0[SMALL], a1[SMALL];
#pragma unroll
  for (int b = 0; b < SMALL; ++b) a0[b] = a1[b] = 0u;
  const long row = v * k;
  for (int kk = t; kk < k; kk += 32) {
    const long sl = row + kk;
    const unsigned d = (unsigned)__ldg(dag + sl);
    const unsigned h = d != 0u ? (unsigned)__ldg(hop0 + __ldg(src + sl)) : 0u;
    if (blockIdx.y == 0) inherit[sl] = (int)(d & ~h);
    const unsigned dir = d & h;
    if (dir != 0u) {
      const unsigned x0 = (unsigned)__ldg(direct + sl * nwords + w0);
      const unsigned x1 = two ? (unsigned)__ldg(direct + sl * nwords + w0 + 1) : 0u;
#pragma unroll
      for (int b = 0; b < SMALL; ++b) {
        if ((dir >> b) & 1u) {
          a0[b] |= x0;
          a1[b] |= x1;
        }
      }
    }
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

// One next-hop inherit round, tile form: blockIdx.x = row block,
// blockIdx.y = lane slab; a warp takes one row and TGN tiles of every word,
// the word chunks (WC words) one after another.
__global__ void __launch_bounds__(WARPS * 32)
ell_nh_round_tile(const int* __restrict__ src, const int* __restrict__ inherit,
                  const int* __restrict__ nh, const int* __restrict__ front,
                  int* __restrict__ out, int* __restrict__ changed,
                  int* __restrict__ front_out, int n, int k, int lanes, int nwords,
                  bool vec) {
  const int t = threadIdx.x % 32;
  const long v = (long)blockIdx.x * WARPS + threadIdx.x / 32;
  if (v >= n) return;
  const int words = (lanes + 31) / 32;
  const int tile0 = blockIdx.y * TGN;
  const int ntiles = min(TGN, words - tile0);
  const long plane = (long)lanes;  // stride of one word plane in a row
  const uint64_t pol = keep_policy();
  const long row = v * k;
  bool moved[TGN];
#pragma unroll
  for (int g = 0; g < TGN; ++g) moved[g] = false;
  for (int w0 = 0; w0 < nwords; w0 += WC) {
    const bool two = w0 + 1 < nwords;
    unsigned a0[TGN], a1[TGN];
#pragma unroll
    for (int g = 0; g < TGN; ++g) a0[g] = a1[g] = 0u;
    int s = t < k ? __ldcs(src + row + t) : -1;
    for (int k0 = 0; k0 < k; k0 += 32) {
      const int sn = k0 + 32 + t < k ? __ldcs(src + row + k0 + 32 + t) : -1;
      // act[g]: lanes of tile g that inherit through this thread's slot from
      // a source that changed.
      unsigned act[TGN];
#pragma unroll
      for (int g = 0; g < TGN; ++g) act[g] = 0u;
      if (s >= 0) {
        ld_words<TGN, false>(front + (long)s * words + tile0, ntiles, vec, act);
        unsigned any = 0u;
#pragma unroll
        for (int g = 0; g < TGN; ++g) any |= act[g];
        if (any != 0u) {
          unsigned iw[TGN];
          ld_words<TGN, true>(inherit + (row + k0 + t) * words + tile0, ntiles, vec, iw);
#pragma unroll
          for (int g = 0; g < TGN; ++g) act[g] &= iw[g];
        }
      }
#pragma unroll
      for (int g = 0; g < TGN; ++g) {
        const int b = (tile0 + g) * 32 + t;
        unsigned todo = __ballot_sync(FULL, act[g] != 0u);
        while (todo != 0u) {
          unsigned x0[GATHERS / 2], x1[GATHERS / 2];
#pragma unroll
          for (int q = 0; q < GATHERS / 2; ++q) {
            x0[q] = x1[q] = 0u;
            if (todo != 0u) {  // the same for the whole warp
              const int j = __ffs(todo) - 1;
              todo &= todo - 1u;
              const unsigned a = __shfl_sync(FULL, act[g], j);
              const int sj = __shfl_sync(FULL, s, j);
              if (((a >> t) & 1u) && b < lanes) {
                const int* p = nh + ((long)sj * nwords + w0) * plane + b;
                x0[q] = (unsigned)ld_gather(p, pol);
                if (two) x1[q] = (unsigned)ld_gather(p + plane, pol);
              }
            }
          }
#pragma unroll
          for (int q = 0; q < GATHERS / 2; ++q) {
            a0[g] |= x0[q];
            a1[g] |= x1[q];
          }
        }
      }
      s = sn;
    }
#pragma unroll
    for (int g = 0; g < TGN; ++g) {
      const int b = (tile0 + g) * 32 + t;
      if (g < ntiles && b < lanes) {
        const long o = (v * nwords + w0) * plane + b;
        const unsigned x0 = (unsigned)__ldcs(nh + o), n0 = x0 | a0[g];
        __stcs(out + o, (int)n0);
        moved[g] |= n0 != x0;
        if (two) {
          const unsigned x1 = (unsigned)__ldcs(nh + o + plane), n1 = x1 | a1[g];
          __stcs(out + o + plane, (int)n1);
          moved[g] |= n1 != x1;
        }
      }
    }
  }
  bool ch = false;
#pragma unroll
  for (int g = 0; g < TGN; ++g) {
    const unsigned word = __ballot_sync(FULL, moved[g]);
    if (t == g && g < ntiles) __stcs(front_out + v * words + tile0 + g, (int)word);
    ch |= moved[g];
  }
  if (__any_sync(FULL, ch) && t == 0) *changed = 1;
}

// One next-hop inherit round, row form: blockIdx.x = row block, the word
// chunks one after another; one inherit and one frontier word a slot / row.
__global__ void __launch_bounds__(WARPS * 32)
ell_nh_round_rows(const int* __restrict__ src, const int* __restrict__ inherit,
                  const int* __restrict__ nh, const int* __restrict__ front,
                  int* __restrict__ out, int* __restrict__ changed,
                  int* __restrict__ front_out, int n, int k, int lanes, int nwords) {
  const int t = threadIdx.x % 32;
  const long v = (long)blockIdx.x * WARPS + threadIdx.x / 32;
  if (v >= n) return;
  const long plane = (long)lanes;
  const long row = v * k;
  bool ch = false;  // thread b: lane b changed in some word
  for (int w0 = 0; w0 < nwords; w0 += WC) {
    const bool two = w0 + 1 < nwords;
    unsigned a0[SMALL], a1[SMALL];
#pragma unroll
    for (int b = 0; b < SMALL; ++b) a0[b] = a1[b] = 0u;
    for (int kk = t; kk < k; kk += 32) {
      const int s = __ldg(src + row + kk);
      unsigned iw = (unsigned)__ldg(front + s);
      if (iw == 0u) continue;
      iw &= (unsigned)__ldg(inherit + row + kk);
      if (iw == 0u) continue;
      const long base = ((long)s * nwords + w0) * plane;
#pragma unroll
      for (int b = 0; b < SMALL; ++b) {
        if (b < lanes && ((iw >> b) & 1u)) {
          a0[b] |= (unsigned)__ldg(nh + base + b);
          if (two) a1[b] |= (unsigned)__ldg(nh + base + plane + b);
        }
      }
    }
#pragma unroll
    for (int b = 0; b < SMALL; ++b) {
      if (b < lanes) {
        const unsigned r0 = __reduce_or_sync(FULL, a0[b]);
        const unsigned r1 = __reduce_or_sync(FULL, a1[b]);
        if (t == b) {
          const long o = (v * nwords + w0) * plane + b;
          const unsigned x0 = (unsigned)nh[o], n0 = x0 | r0;
          out[o] = (int)n0;
          ch |= n0 != x0;
          if (two) {
            const unsigned x1 = (unsigned)nh[o + plane], n1 = x1 | r1;
            out[o + plane] = (int)n1;
            ch |= n1 != x1;
          }
        }
      }
    }
  }
  const unsigned word = __ballot_sync(FULL, ch);
  if (t == 0) {
    front_out[v] = (int)word;
    if (word != 0u) *changed = 1;
  }
}

unsigned row_blocks(int n) { return (unsigned)((n + WARPS - 1) / WARPS); }
unsigned lane_groups(int lanes, int tiles = TG) {
  return (unsigned)(((lanes + 31) / 32 + tiles - 1) / tiles);
}
unsigned word_chunks(int nwords) { return (unsigned)((nwords + WC - 1) / WC); }
bool aligned16(const void* p) { return p == nullptr || (uintptr_t)p % 16 == 0; }

}  // namespace

extern "C" {

int holo_ell_relax(const void* src, const void* cost, const void* slot,
                   const void* mask, const void* dist, const void* front, void* out,
                   void* changed, void* front_out, int n, int k, int lanes, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int *s = (const int*)src, *c = (const int*)cost, *e = (const int*)slot;
  const int *m = (const int*)mask, *d = (const int*)dist, *f = (const int*)front;
  if (n > 0 && lanes > 0 && lanes <= SMALL) {
    ell_relax_rows<<<row_blocks(n), WARPS * 32, 0, st>>>(
        s, c, e, m, d, f, (int*)out, (int*)changed, (int*)front_out, n, k, lanes);
  } else if (n > 0 && lanes > 0) {
    const bool vec = (lanes + 31) / 32 % TG == 0 && aligned16(mask) && aligned16(front);
    ell_relax_tile<<<dim3(lane_groups(lanes), row_blocks(n)), WARPS * 32, 0, st>>>(
        s, c, e, m, d, f, (int*)out, (int*)changed, (int*)front_out, n, k, lanes, vec);
  }
  return (int)cudaGetLastError();
}

int holo_ell_first_parent(const void* src, const void* cost, const void* slot,
                          const void* mask, const void* dist, const void* roots,
                          void* parent, void* dag, int n, int k, int lanes, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int *s = (const int*)src, *c = (const int*)cost, *e = (const int*)slot;
  const int *m = (const int*)mask, *d = (const int*)dist, *r = (const int*)roots;
  if (n > 0 && lanes > 0 && lanes <= SMALL) {
    ell_first_parent_rows<<<row_blocks(n), WARPS * 32, 0, st>>>(
        s, c, e, m, d, r, (int*)parent, (int*)dag, n, k, lanes);
  } else if (n > 0 && lanes > 0) {
    const bool vec = (lanes + 31) / 32 % TGP == 0 && aligned16(mask) && aligned16(dag);
    ell_first_parent_tile<<<dim3(lane_groups(lanes, TGP), row_blocks(n)), WARPS * 32, 0, st>>>(
        s, c, e, m, d, r, (int*)parent, (int*)dag, n, k, lanes, vec);
  }
  return (int)cudaGetLastError();
}

int holo_ell_nh_seed(const void* src, const void* dag, const void* hop0, const void* direct,
                     void* seed, void* inherit, int n, int k, int lanes, int nwords,
                     void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int *s = (const int*)src, *d = (const int*)dag, *h = (const int*)hop0;
  const int* dr = (const int*)direct;
  if (n > 0 && lanes > 0 && nwords > 0 && lanes <= SMALL) {
    ell_nh_seed_rows<<<dim3(row_blocks(n), word_chunks(nwords)), WARPS * 32, 0, st>>>(
        s, d, h, dr, (int*)seed, (int*)inherit, n, k, lanes, nwords);
  } else if (n > 0 && lanes > 0 && nwords > 0) {
    const bool vec = (lanes + 31) / 32 % TG == 0 && aligned16(dag) && aligned16(hop0) &&
                     aligned16(inherit);
    ell_nh_seed_tile<<<dim3(lane_groups(lanes), row_blocks(n), word_chunks(nwords)),
                       WARPS * 32, 0, st>>>(s, d, h, dr, (int*)seed, (int*)inherit, n, k,
                                            lanes, nwords, vec);
  }
  return (int)cudaGetLastError();
}

int holo_ell_nh_round(const void* src, const void* inherit, const void* nh,
                      const void* front, void* out, void* changed, void* front_out,
                      int n, int k, int lanes, int nwords, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int *s = (const int*)src, *i = (const int*)inherit, *x = (const int*)nh;
  const int* f = (const int*)front;
  if (n > 0 && lanes > 0 && nwords > 0 && lanes <= SMALL) {
    ell_nh_round_rows<<<row_blocks(n), WARPS * 32, 0, st>>>(
        s, i, x, f, (int*)out, (int*)changed, (int*)front_out, n, k, lanes, nwords);
  } else if (n > 0 && lanes > 0 && nwords > 0) {
    const bool vec = (lanes + 31) / 32 % TGN == 0 && aligned16(inherit) && aligned16(front);
    ell_nh_round_tile<<<dim3(row_blocks(n), lane_groups(lanes, TGN)), WARPS * 32, 0, st>>>(
        s, i, x, f, (int*)out, (int*)changed, (int*)front_out, n, k, lanes, nwords, vec);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
