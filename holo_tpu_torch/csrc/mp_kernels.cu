// Multipath kernels of the gather SPF engine for Hopper (sm_90a), plain C
// interface for ctypes.
//
// The JAX package computes the multipath planes (holo_tpu/ops/spf_engine.py,
// spf_one_multipath) with jnp inside lax.while_loop; XLA fuses each step into
// one loop fusion, and there is no Pallas kernel.  In eager PyTorch the
// per-atom weight round alone would form an [N, K, A] contribution per lane
// (10,125 x 96 x 64 x 1024 int32 = 254 GB at the k=90 fat tree x 1024
// scenarios), so each step is hand-written:
//
//   ell_mp_round       <- :1281-1322, the body of _mp_fixpoint: one Jacobi
//                         round of hops, next-hop words, saturated path
//                         counts and per-atom UCMP weights and a changed flag
//                         over all four; without the count and weight planes
//                         the body of _hops_nh_fixpoint (:1211-1227), the
//                         incremental path's round.
//   ell_parent_sets    <- :872-894 (_sp_dag + _first_parent, as
//                         ell_first_parent writes them) and :1327-1372
//                         (_mp_parent_sets without pweight), from one walk.
//   ell_parent_weights <- :1361-1366, pweight = npaths[parent], once the
//                         fixpoint has the path counts.
//
// Planes (int32, lanes minor as in ell_kernels.cu): src, cost, slot [N, K]
// (slot = edge id, -1 for padding); mask [E, ceil(B/32)] or NULL; dag
// [N, K, ceil(B/32)] (bit b%32 of word [v, k, b/32]: slot k is a DAG in-edge
// of v in lane b); direct [N, K, W] one-hot atom words; inc [N] (1 at a
// router); roots [B]; parent, hops, npaths, dist [N, B]; next hops [N, W, B];
// weights [N, A, B] with A = 32 W (atom a = bit a%32 of word a/32); parent
// sets [N, KP, B]; frontier [N, ceil(B/32)] lane bits.  Sums wrap as JAX's
// int32 sums do (unsigned arithmetic) and are clamped at SAT after the row
// sum, as JAX clamps them.
//
// What bounds ell_mp_round.  A full round gathers, for each DAG (slot, lane)
// pair whose source has hops != 0, the source's 64 atom weights: 83 million
// pairs, ~21 GB a round at k=90 x 1024 (5.3-5.9 ms a round, 7 rounds a
// dispatch), against 5.6 GB of state in and out.  Yet a value is
// recomputed from its DAG sources' values of the round before, so a lane of
// a row whose sources did not change keeps its value: a row frontier is
// exact for sums as for min and OR.  The round reads the state S of round
// r - 1 (buffer A) and the frontier F of round r - 1 and writes buffer B,
// which holds the state of round r - 2:
//
// - recomputed: the lanes of a row in which some DAG slot's source is in F,
//   or the row is in F and has no DAG slot (its value is then a constant,
//   which a stale seed may not hold);
// - copied from A: the other lanes in F; every other entry of B is already
//   the round's value.  F_r marks the recomputed lanes that changed, and the
//   changed flag is "any bit of F_r", JAX's flag over the four planes.
//
// ops/spf_engine.py starts fresh seeds from the blank planes of a round
// before them (mp_start, F_0: the roots) and a previous run's planes from an
// all-ones F_0 (mp_resume: a full round).  Over a dispatch the recomputed pairs add up to ~1.8 full
// rounds of gathers at k=90 x 1024 (rows with DAG sources at several
// distances are recomputed more than once), and the copies to ~13 million
// entries.  The tile form is two kernels:
//
// - ell_mp_plan: a warp owns one row and thread t its tiles t, t + 32, ...:
//   per slot it reads one 128-byte line of DAG words and one of the source's
//   frontier words, eight slots in flight, and writes the (recompute, copy)
//   words of each (row, tile) and zeroes the frontier word.  Planning in the
//   round kernel itself, one warp a (row, tile), reads a 4-byte word per
//   32-byte sector, and measured several times slower in rounds with little
//   work.
// - ell_mp_round_tile: a warp owns one (row, tile, word) (gridDim.y = tiles x
//   words, the blocks at work at any moment gathering one tile and word of
//   the weights, 41 MB, which L2 holds for every DAG child of a source) and
//   returns at once where the plan has no work.  Else it walks the row's DAG
//   slots in the recomputed lanes (a ballot over each 32-slot chunk), keeps
//   32 atom sums a thread (80 registers, at most 3 blocks an SM: letting
//   ptxas take more registers measured slower), gathers a source's
//   atom row as 32 coalesced lines with an L2 evict_last policy, writes the
//   recomputed lanes and copies the others on separate paths (one select
//   path measured slower), and ORs the lanes that changed into the
//   frontier word with one atomicOr a warp.  Also measured slower: a work
//   list built with atomics and taken by persistent warps (rows in arrival
//   order: the grid's row order keeps consecutive rows' shared sources in
//   L2), a block planning its own rows (its warps wait on the block's
//   heaviest row), and one warp walking both words of a (row, tile).
//
// The row form (up to SMALL lanes: compute() and the incremental path are
// one lane) is one kernel: a warp owns one row, plans it (one word a slot)
// and returns where nothing is to do; thread t owns atom 32 w + t of every
// lane for each word w in turn and thread b writes lane b's hops, path
// count and next-hop words.
//
// ell_parent_sets walks the usable (slot, lane) pairs once as
// ell_first_parent does (the next chunk's slot planes in flight, eight
// gathers of dist[src] at a time) and feeds each gathered distance to the
// DAG test, the (dist, id) argmin and the lane's sorted set of KP (cost,
// source) entries (one entry per source: a listed source's cost only falls,
// a new source replaces the last entry if it ranks before it, then one
// bubble pass; an offer costlier than the last entry is refused first).  It
// is bound by instructions more than bytes: the offers of 246 million
// admissible pairs at kp=4 x 1024 come on top of ell_first_parent's walk.
// Tiles a warp: 4 at KP = 2, 2 at 4, 1 at 8 (2 KP registers a tile; 3 blocks
// an SM); more tiles, or 2 or 4 blocks an SM, measured no faster.  The row form runs
// JAX's KP rounds of a warp-wide lexicographic min per lane after the walk,
// reading the row's distances again from L1.

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
// N a multiple of 4, p 16-byte aligned) loads them as int4 vectors,
// streamed (__ldcs).
template <int N>
__device__ __forceinline__ void ld_words(const int* p, int n, bool vec, unsigned (&w)[N]) {
  if constexpr (N % 4 == 0) {
    if (vec) {
#pragma unroll
      for (int i = 0; i < N; i += 4) {
        const int4 x = __ldcs(reinterpret_cast<const int4*>(p + i));
        w[i] = (unsigned)x.x;
        w[i + 1] = (unsigned)x.y;
        w[i + 2] = (unsigned)x.z;
        w[i + 3] = (unsigned)x.w;
      }
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) w[i] = i < n ? (unsigned)__ldcs(p + i) : 0u;
}

// Words w[0 .. n) to p[0 .. n), streamed (__stcs), as int4 vectors where
// `vec` (as ld_words).
template <int N>
__device__ __forceinline__ void st_words(int* p, int n, bool vec, const unsigned (&w)[N]) {
  if constexpr (N % 4 == 0) {
    if (vec) {
#pragma unroll
      for (int i = 0; i < N; i += 4)
        __stcs(reinterpret_cast<int4*>(p + i),
               make_int4((int)w[i], (int)w[i + 1], (int)w[i + 2], (int)w[i + 3]));
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (i < n) __stcs(p + i, (int)w[i]);
}

// hops[v, b] of the round: 0 at the lane's root, the first parent's hops
// plus inc[v] where the parent exists and has hops below N + 1, else N + 1.
__device__ __forceinline__ int next_hops(const int* __restrict__ hops,
                                         const int* __restrict__ parent,
                                         const int* __restrict__ inc, long v, int b,
                                         int n, int lanes, bool is_root) {
  if (is_root) return 0;
  const int p = parent[v * lanes + b];
  const int ph = (p >= 0 && p < n) ? __ldg(hops + (long)p * lanes + b) : n + 1;
  return ph < n + 1 ? add32(ph, inc[v]) : n + 1;
}

// The frontier hits of row v in the row form (one DAG and frontier word a
// slot / row): (hit, has), reduced over the warp; thread t takes slots t,
// t + 32, ..., four at a time, their words loaded before their sources'
// frontier words.  hit: lanes in which some DAG slot's source is marked in
// `front`; has: lanes with a DAG slot.
__device__ __forceinline__ void frontier_hits(const int* __restrict__ src,
                                              const int* __restrict__ dag,
                                              const int* __restrict__ front, long v, int k,
                                              unsigned& hit, unsigned& has) {
  const int t = threadIdx.x % 32;
  const long row = v * k;
  hit = has = 0u;
  for (int k0 = t; k0 < k; k0 += 4 * 32) {
    int s[4];
    unsigned d[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kk = k0 + i * 32;
      s[i] = 0;
      d[i] = 0u;
      if (kk < k) {
        s[i] = __ldg(src + row + kk);
        d[i] = (unsigned)__ldg(dag + row + kk);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (d[i] != 0u) {
        has |= d[i];
        hit |= d[i] & (unsigned)__ldg(front + s[i]);
      }
    }
  }
  hit = __reduce_or_sync(FULL, hit);
  has = __reduce_or_sync(FULL, has);
}

// The row frontier of a word of row v from its (hit, has): (rec, copy).
// rec: the lanes in which some DAG slot's source is marked, or v is marked
// and has no DAG slot; copy: the other marked lanes.
__device__ __forceinline__ void row_frontier(unsigned hit, unsigned has, unsigned own,
                                             unsigned& rec, unsigned& copy) {
  rec = hit | (own & ~has);
  copy = own & ~rec;
}

// The plan of a row-frontier round, tile form: a warp takes one row and
// thread t its 32-lane tiles t, t + 32, ... (a slot's DAG words and its
// source's frontier words are 128-byte lines).  Per (row, tile) it writes
// (rec, copy) to `plan` ([2][words][N]) and zeroes the frontier word, into
// which the round then ORs the lanes that change.
__global__ void __launch_bounds__(WARPS * 32)
ell_mp_plan(const int* __restrict__ src, const int* __restrict__ dag,
            const int* __restrict__ front, int* __restrict__ front_out,
            int* __restrict__ plan, int n, int k, int words) {
  const int t = threadIdx.x % 32;
  const long v = (long)blockIdx.x * WARPS + threadIdx.x / 32;
  if (v >= n) return;
  const long row = v * k;
  for (int g = t; g < words; g += 32) {
    unsigned hit = 0u, has = 0u;
    for (int k0 = 0; k0 < k; k0 += 8) {  // eight slots' loads in flight
      unsigned d[8], f[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        d[i] = 0u;
        f[i] = 0u;
        if (k0 + i < k) {
          d[i] = (unsigned)__ldg(dag + (row + k0 + i) * words + g);
          f[i] = (unsigned)__ldg(front + (long)__ldg(src + row + k0 + i) * words + g);
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        has |= d[i];
        hit |= d[i] & f[i];
      }
    }
    unsigned rec, copy;
    row_frontier(hit, has, (unsigned)__ldg(front + v * words + g), rec, copy);
    plan[(long)g * n + v] = (int)rec;
    plan[((long)words + g) * n + v] = (int)copy;
    front_out[v * words + g] = 0;
  }
}

// One row-frontier round, tile form: blockIdx.x = row block, blockIdx.y =
// tile * nwords + word, so that the blocks at work at any moment gather the
// weight rows of one tile and word (41 MB at k=90, which L2 holds for every
// DAG child of a source).  A warp owns one (row, tile, word) and stops at
// once where the plan has no work for its (row, tile); else it walks the
// row's DAG slots in the recomputed lanes for its word (32 atoms), writes
// that word's planes (and at word 0 the hops and path counts) and ORs the
// lanes that changed into the frontier word.  MP: with the path-count and
// weight planes.
template <bool MP>
__global__ void __launch_bounds__(WARPS * 32, 3)
ell_mp_round_tile(const int* __restrict__ src, const int* __restrict__ dag,
                  const int* __restrict__ direct, const int* __restrict__ inc,
                  const int* __restrict__ roots, const int* __restrict__ parent,
                  const int* __restrict__ hops, const int* __restrict__ nh,
                  const int* __restrict__ np, const int* __restrict__ aw,
                  const int* __restrict__ plan, int* __restrict__ hops_out,
                  int* __restrict__ nh_out, int* __restrict__ np_out,
                  int* __restrict__ aw_out, int* __restrict__ changed,
                  int* __restrict__ front_out, int n, int k, int lanes, int nwords) {
  const int t = threadIdx.x % 32;
  const uint64_t pol = keep_policy();
  const long v = (long)blockIdx.x * WARPS + threadIdx.x / 32;
  if (v >= n) return;
  const int words = (lanes + 31) / 32;  // DAG and frontier words a slot / row
  const int tile = blockIdx.y / nwords;
  const int w = blockIdx.y % nwords;
  const long atoms = 32L * nwords;
  const unsigned rec = (unsigned)__ldg(plan + (long)tile * n + v);
  const unsigned copy = (unsigned)__ldg(plan + ((long)words + tile) * n + v);
  if ((rec | copy) == 0u) return;
  const int b = tile * 32 + t;
  const long row = v * k;
  bool moved = false;
  unsigned nh_acc = 0u, np_acc = 0u;
  unsigned acc[32];
#pragma unroll
  for (int a = 0; a < 32; ++a) acc[a] = 0u;
  if (rec != 0u) {
    for (int k0 = 0; k0 < k; k0 += 32) {
      int s = 0;
      unsigned d = 0u;
      if (k0 + t < k) {
        s = __ldg(src + row + k0 + t);
        d = (unsigned)__ldg(dag + (row + k0 + t) * words + tile) & rec;
      }
      unsigned todo = __ballot_sync(FULL, d != 0u);
      while (todo != 0u) {
        const int j = __ffs(todo) - 1;
        todo &= todo - 1u;
        const int sj = __shfl_sync(FULL, s, j);
        const unsigned dj = __shfl_sync(FULL, d, j);
        if ((dj >> t) & 1u) {  // bits past the last lane are 0
          const long so = (long)sj * lanes + b;
          const int h = __ldg(hops + so);
          const unsigned p = MP ? (unsigned)__ldg(np + so) : 0u;
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
              for (int a = 0; a < 32; ++a) acc[a] += (unsigned)ld_gather(q + (long)a * lanes, pol);
            }
          }
          np_acc += p;
        }
      }
    }
  }
  const long o = v * lanes + b;
  const long ow = (v * nwords + w) * lanes + b;
  if (b < lanes && ((rec >> t) & 1u)) {
    const unsigned old = (unsigned)nh[ow];
    nh_out[ow] = (int)nh_acc;
    moved |= nh_acc != old;
    if (w == 0) {
      const int hn = next_hops(hops, parent, inc, v, b, n, lanes, roots[b] == v);
      moved |= hn != hops[o];
      hops_out[o] = hn;
      if (MP) {
        const int pn = roots[b] == v ? 1 : min((int)np_acc, SAT);
        moved |= pn != np[o];
        np_out[o] = pn;
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
  } else if (b < lanes && ((copy >> t) & 1u)) {  // unchanged this round: the last value
    nh_out[ow] = nh[ow];
    if (w == 0) {
      hops_out[o] = hops[o];
      if (MP) np_out[o] = np[o];
    }
    if (MP) {
#pragma unroll
      for (int a = 0; a < 32; ++a) {
        const long oa = (v * atoms + 32L * w + a) * lanes + b;
        aw_out[oa] = aw[oa];
      }
    }
  }
  const unsigned word = __ballot_sync(FULL, moved);
  if (t == 0 && word != 0u) {
    atomicOr((unsigned*)front_out + v * words + tile, word);
    *changed = 1;
  }
}

// One row-frontier round, row form: blockIdx.x = row block; thread t owns
// atom 32 w + t of every lane, for each word w in turn; one DAG and one
// frontier word a slot / row.
template <bool MP>
__global__ void __launch_bounds__(WARPS * 32)
ell_mp_round_rows(const int* __restrict__ src, const int* __restrict__ dag,
                  const int* __restrict__ direct, const int* __restrict__ inc,
                  const int* __restrict__ roots, const int* __restrict__ parent,
                  const int* __restrict__ hops, const int* __restrict__ nh,
                  const int* __restrict__ np, const int* __restrict__ aw,
                  const int* __restrict__ front, int* __restrict__ hops_out,
                  int* __restrict__ nh_out, int* __restrict__ np_out,
                  int* __restrict__ aw_out, int* __restrict__ changed,
                  int* __restrict__ front_out, int n, int k, int lanes, int nwords) {
  const int t = threadIdx.x % 32;
  const long v = (long)blockIdx.x * WARPS + threadIdx.x / 32;
  if (v >= n) return;
  const long atoms = 32L * nwords;
  unsigned hit, has, rec, copy;
  frontier_hits(src, dag, front, v, k, hit, has);
  row_frontier(hit, has, (unsigned)__ldg(front + v), rec, copy);
  unsigned moved = 0u;  // lanes this thread saw change
  if ((rec | copy) != 0u) {
    const long row = v * k;
    unsigned np_acc[SMALL];
#pragma unroll
    for (int b = 0; b < SMALL; ++b) np_acc[b] = 0u;
    for (int w = 0; w < nwords; ++w) {
      unsigned nh_acc[SMALL], acc[SMALL];
#pragma unroll
      for (int b = 0; b < SMALL; ++b) nh_acc[b] = acc[b] = 0u;
      for (int k0 = 0; rec != 0u && k0 < k; k0 += 32) {
        int s = 0;
        unsigned d = 0u;
        if (k0 + t < k) {
          s = __ldg(src + row + k0 + t);
          d = (unsigned)__ldg(dag + row + k0 + t) & rec;
        }
        unsigned todo = __ballot_sync(FULL, d != 0u);
        while (todo != 0u) {
          const int j = __ffs(todo) - 1;
          todo &= todo - 1u;
          const int sj = __shfl_sync(FULL, s, j);
          const unsigned dj = __shfl_sync(FULL, d, j);
          const unsigned x = (unsigned)__ldg(direct + (row + k0 + j) * nwords + w);
          const bool atom = (x >> t) & 1u;  // the slot's direct atoms include atom 32 w + t
#pragma unroll
          for (int b = 0; b < SMALL; ++b) {
            if (b < lanes && ((dj >> b) & 1u)) {
              const long so = (long)sj * lanes + b;
              const int h = __ldg(hops + so);
              const unsigned p = MP ? (unsigned)__ldg(np + so) : 0u;
              if (h == 0) {
                nh_acc[b] |= x;
                if (MP && atom) acc[b] += p;
              } else {
                nh_acc[b] |= (unsigned)__ldg(nh + ((long)sj * nwords + w) * lanes + b);
                if (MP) acc[b] += (unsigned)__ldg(aw + ((long)sj * atoms + 32L * w + t) * lanes + b);
              }
              if (w == 0) np_acc[b] += p;
            }
          }
        }
      }
#pragma unroll
      for (int b = 0; b < SMALL; ++b) {
        if (b >= lanes || !(((rec | copy) >> b) & 1u)) continue;
        const bool r = (rec >> b) & 1u;
        bool mv = false;
        if (MP) {
          const long oa = (v * atoms + 32L * w + t) * lanes + b;
          const int a0 = aw[oa];
          const int x = r ? min((int)acc[b], SAT) : a0;
          aw_out[oa] = x;
          mv |= x != a0;
        }
        if (t == b) {
          const long o = v * lanes + b;
          const long ow = (v * nwords + w) * lanes + b;
          const unsigned old = (unsigned)nh[ow];
          const unsigned x = r ? nh_acc[b] : old;
          nh_out[ow] = (int)x;
          mv |= x != old;
          if (w == 0) {
            const int h0 = hops[o];
            const int hn = r ? next_hops(hops, parent, inc, v, b, n, lanes, roots[b] == v) : h0;
            hops_out[o] = hn;
            mv |= hn != h0;
            if (MP) {
              const int p0 = np[o];
              const int pn = r ? (roots[b] == v ? 1 : min((int)np_acc[b], SAT)) : p0;
              np_out[o] = pn;
              mv |= pn != p0;
            }
          }
        }
        if (mv) moved |= 1u << b;
      }
    }
  }
  const unsigned word = __reduce_or_sync(FULL, moved);
  if (t == 0) {
    front_out[v] = (int)word;
    if (word != 0u) *changed = 1;
  }
}

// (c, s) ranks before (c2, s2): path cost first, then source id.
__device__ __forceinline__ bool before(int c, int s, int c2, int s2) {
  return c < c2 || (c == c2 && s < s2);
}

// Offer (c, s) to the sorted set (pc, ps) of at most KP sources, each at its
// cheapest offered cost; empty entries are (INF, n) and rank last.
template <int KP>
__device__ __forceinline__ void offer(int (&pc)[KP], int (&ps)[KP], int c, int s) {
  // Costlier than the last entry: it cannot enter, and a listed entry of s
  // costs no more than the last one.
  if (c > pc[KP - 1]) return;
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

// 32-lane tiles a warp of ell_parent_sets_tile takes: the sorted sets cost
// 2 KP registers a tile.
template <int KP>
__host__ __device__ constexpr int tiles_of() { return KP <= 2 ? 4 : KP == 4 ? 2 : 1; }

constexpr int GATHERS = 8;  // gathers a warp issues together

// First parent, DAG bits and parent sets, tile form: blockIdx.x = lane group
// (TT tiles), blockIdx.y = row block.  The slots are walked as in
// ell_first_parent_tile (thread j keeps slot j's DAG words; the next
// chunk's slot in flight; eight gathers of dist[src] at a time), and each
// gathered distance feeds the DAG test, the (dist, id) argmin and the
// offer to the lane's sorted set.
template <int KP>
__global__ void __launch_bounds__(WARPS * 32, 3)
ell_parent_sets_tile(const int* __restrict__ src, const int* __restrict__ cost,
                     const int* __restrict__ slot, const int* __restrict__ mask,
                     const int* __restrict__ dist, const int* __restrict__ roots,
                     int* __restrict__ parent, int* __restrict__ dag,
                     int* __restrict__ parents, int* __restrict__ pdist, int n, int k,
                     int lanes, bool vec) {
  constexpr int TT = tiles_of<KP>();
  const int t = threadIdx.x % 32;
  const long v = (long)blockIdx.y * WARPS + threadIdx.x / 32;
  if (v >= n) return;
  const int words = (lanes + 31) / 32;
  const int tile0 = blockIdx.x * TT;
  const int ntiles = min(TT, words - tile0);
  const uint64_t pol = keep_policy();
  int dv[TT], bd[TT], bs[TT], pc[TT][KP], ps[TT][KP];
  unsigned live[TT];  // lanes of tile g in which v is reached and not the root
  unsigned any_live = 0u;
#pragma unroll
  for (int g = 0; g < TT; ++g) {
    const int b = (tile0 + g) * 32 + t;
    const bool ok = g < ntiles && b < lanes;
    dv[g] = ok ? __ldg(dist + v * lanes + b) : INF;
    live[g] = __ballot_sync(FULL, ok && dv[g] < INF && __ldg(roots + b) != v);
    any_live |= live[g];
    bd[g] = INF;
    bs[g] = n;
#pragma unroll
    for (int i = 0; i < KP; ++i) {
      pc[g][i] = INF;
      ps[g][i] = n;
    }
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
    unsigned act[TT];
#pragma unroll
    for (int g = 0; g < TT; ++g) act[g] = 0u;
    if (e >= 0 && any_live != 0u) {
      if (mask != nullptr) {
        ld_words<TT>(mask + (long)e * words + tile0, ntiles, vec, act);
      } else {
#pragma unroll
        for (int g = 0; g < TT; ++g) act[g] = FULL;
      }
#pragma unroll
      for (int g = 0; g < TT; ++g) act[g] &= live[g];
    }
    unsigned mine[TT];  // this thread's slot's DAG words
#pragma unroll
    for (int g = 0; g < TT; ++g) {
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
          const int pcost = add32(du[q], cq[q]);
          const bool tight = du[q] < INF && pcost == dv[g];
          if (tight && (du[q] < bd[g] || (du[q] == bd[g] && sq[q] < bs[g]))) {
            bd[g] = du[q];
            bs[g] = sq[q];
          }
          const unsigned word = __ballot_sync(FULL, tight);
          if (t == jq[q]) mine[g] = word;
          if (du[q] < INF && (tight || du[q] < dv[g]) && pcost < INF)
            offer<KP>(pc[g], ps[g], pcost, sq[q]);
        }
      }
    }
    if (k0 + t < k) st_words<TT>(dag + (row + k0 + t) * words + tile0, ntiles, vec, mine);
    s = sn;
    c = cn;
    e = en;
  }
#pragma unroll
  for (int g = 0; g < TT; ++g) {
    const int b = (tile0 + g) * 32 + t;
    if (g < ntiles && b < lanes) {
      __stcs(parent + v * lanes + b, bs[g]);
#pragma unroll
      for (int i = 0; i < KP; ++i) {
        const long o = (v * KP + i) * lanes + b;
        __stcs(parents + o, ps[g][i]);
        __stcs(pdist + o, pc[g][i]);
      }
    }
  }
}

// First parent, DAG bits and parent sets, row form: a warp owns one row and
// all its lanes.  One walk (thread t takes slots t, t + 32, ...) writes each
// slot's DAG word and finds the (dist, id) argmin as ell_first_parent_rows
// does; then per live lane KP rounds of a warp-wide lexicographic min over
// the admissible slots, each skipping the sources already emitted (JAX's
// rounds), read the row's distances again from L1.
template <int KP>
__global__ void __launch_bounds__(WARPS * 32)
ell_parent_sets_rows(const int* __restrict__ src, const int* __restrict__ cost,
                     const int* __restrict__ slot, const int* __restrict__ mask,
                     const int* __restrict__ dist, const int* __restrict__ roots,
                     int* __restrict__ parent, int* __restrict__ dag,
                     int* __restrict__ parents, int* __restrict__ pdist, int n, int k,
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
      const unsigned m = mask == nullptr ? FULL : (unsigned)__ldg(mask + e);
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
    if (b >= lanes) continue;
    const int m = __reduce_min_sync(FULL, bd[b]);
    const int id = __reduce_min_sync(FULL, bd[b] == m ? bs[b] : n);
    if (t == b) parent[v * lanes + b] = id;
    int emitted[KP];
#pragma unroll
    for (int r = 0; r < KP; ++r) emitted[r] = n;
#pragma unroll 1
    for (int r = 0; r < KP; ++r) {
      int bc = INF, bsr = n;
      for (int kk = t; live[b] && kk < k; kk += 32) {
        const int e = __ldg(slot + row + kk);
        if (e < 0 || (mask != nullptr && !(((unsigned)__ldg(mask + e) >> b) & 1u))) continue;
        const int s = __ldg(src + row + kk);
        const int d = __ldg(dist + (long)s * lanes + b);
        if (d >= INF) continue;
        const int pcost = add32(d, __ldg(cost + row + kk));
        if (!((pcost == dv[b] || d < dv[b]) && pcost < INF)) continue;
        bool seen = false;
        for (int i = 0; i < r; ++i) seen |= emitted[i] == s;
        if (!seen && before(pcost, s, bc, bsr)) {
          bc = pcost;
          bsr = s;
        }
      }
      const int cmin = __reduce_min_sync(FULL, bc);
      const int smin = __reduce_min_sync(FULL, bc == cmin ? bsr : n);
      const bool has = cmin < INF;
      emitted[r] = has ? smin : n;
      if (t == 0) {
        const long o = (v * KP + r) * lanes + b;
        parents[o] = has ? smin : n;
        pdist[o] = has ? cmin : INF;
      }
    }
  }
}

// pweight[v, i, b] = npaths[parents[v, i, b], b], 0 past the set (parent
// N): one thread an entry, the parent-set planes streamed.
__global__ void __launch_bounds__(WARPS * 32)
ell_parent_weights(const int* __restrict__ parents, const int* __restrict__ np,
                   int* __restrict__ pweight, long total, int n, int lanes) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int p = __ldcs(parents + i);
  __stcs(pweight + i, p < n ? __ldg(np + (long)p * lanes + i % lanes) : 0);
}

unsigned row_blocks(long rows) { return (unsigned)((rows + WARPS - 1) / WARPS); }
bool aligned16(const void* p) { return p == nullptr || (uintptr_t)p % 16 == 0; }

template <int KP>
void launch_parent_sets(const int* s, const int* c, const int* e, const int* m, const int* d,
                        const int* r, int* parent, int* dag, int* parents, int* pdist, int n,
                        int k, int lanes, cudaStream_t st) {
  if (lanes <= SMALL) {
    ell_parent_sets_rows<KP><<<row_blocks(n), WARPS * 32, 0, st>>>(
        s, c, e, m, d, r, parent, dag, parents, pdist, n, k, lanes);
  } else {
    constexpr int TT = tiles_of<KP>();
    const int words = (lanes + 31) / 32;
    const bool vec = TT % 4 == 0 && words % TT == 0 && aligned16(m) && aligned16(dag);
    const dim3 grid((words + TT - 1) / TT, row_blocks(n));
    ell_parent_sets_tile<KP><<<grid, WARPS * 32, 0, st>>>(s, c, e, m, d, r, parent, dag,
                                                          parents, pdist, n, k, lanes, vec);
  }
}

template <bool MP>
void launch_mp_round(const int* s, const int* dg, const int* dr, const int* ic, const int* r,
                     const int* p, const int* h, const int* x, const int* c, const int* a,
                     const int* f, int* ho, int* xo, int* co, int* ao, int* ch, int* fo,
                     int* plan, int n, int k, int lanes, int nwords, cudaStream_t st) {
  if (lanes <= SMALL) {
    ell_mp_round_rows<MP><<<row_blocks(n), WARPS * 32, 0, st>>>(
        s, dg, dr, ic, r, p, h, x, c, a, f, ho, xo, co, ao, ch, fo, n, k, lanes, nwords);
    return;
  }
  const int words = (lanes + 31) / 32;
  ell_mp_plan<<<row_blocks(n), WARPS * 32, 0, st>>>(s, dg, f, fo, plan, n, k, words);
  ell_mp_round_tile<MP><<<dim3(row_blocks(n), words * nwords), WARPS * 32, 0, st>>>(
      s, dg, dr, ic, r, p, h, x, c, a, plan, ho, xo, co, ao, ch, fo, n, k, lanes, nwords);
}

}  // namespace

extern "C" {

int holo_ell_mp_round(const void* src, const void* dag, const void* direct, const void* inc,
                      const void* roots, const void* parent, const void* hops, const void* nh,
                      const void* np, const void* aw, const void* front, void* hops_out,
                      void* nh_out, void* np_out, void* aw_out, void* changed, void* front_out,
                      void* plan, int n, int k, int lanes, int nwords, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (n <= 0 || lanes <= 0 || nwords <= 0) return (int)cudaGetLastError();
  const int *s = (const int*)src, *dg = (const int*)dag, *dr = (const int*)direct;
  const int *ic = (const int*)inc, *r = (const int*)roots, *p = (const int*)parent;
  const int *h = (const int*)hops, *x = (const int*)nh, *c = (const int*)np;
  const int *a = (const int*)aw, *f = (const int*)front;
  int *ho = (int*)hops_out, *xo = (int*)nh_out, *co = (int*)np_out, *ao = (int*)aw_out;
  int *ch = (int*)changed, *fo = (int*)front_out, *pl = (int*)plan;
  if (np != nullptr)
    launch_mp_round<true>(s, dg, dr, ic, r, p, h, x, c, a, f, ho, xo, co, ao, ch, fo, pl, n, k,
                          lanes, nwords, st);
  else
    launch_mp_round<false>(s, dg, dr, ic, r, p, h, x, c, a, f, ho, xo, co, ao, ch, fo, pl, n,
                           k, lanes, nwords, st);
  return (int)cudaGetLastError();
}

int holo_ell_parent_weights(const void* parents, const void* np, void* pweight, int n, int kp,
                            int lanes, void* stream) {
  const long total = (long)n * kp * lanes;
  if (total > 0)
    ell_parent_weights<<<(unsigned)((total + WARPS * 32 - 1) / (WARPS * 32)), WARPS * 32, 0,
                         (cudaStream_t)stream>>>((const int*)parents, (const int*)np,
                                                 (int*)pweight, total, n, lanes);
  return (int)cudaGetLastError();
}

int holo_ell_parent_sets(const void* src, const void* cost, const void* slot, const void* mask,
                         const void* dist, const void* roots, void* parent, void* dag,
                         void* parents, void* pdist, int n, int k, int lanes, int kp,
                         void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (n <= 0 || lanes <= 0) return (int)cudaGetLastError();
  const int *s = (const int*)src, *c = (const int*)cost, *e = (const int*)slot;
  const int *m = (const int*)mask, *d = (const int*)dist, *r = (const int*)roots;
  int *pa = (int*)parent, *dg = (int*)dag, *ps = (int*)parents, *pd = (int*)pdist;
  switch (kp) {  // the widths mp_pad gives past single path
    case 2: launch_parent_sets<2>(s, c, e, m, d, r, pa, dg, ps, pd, n, k, lanes, st); break;
    case 4: launch_parent_sets<4>(s, c, e, m, d, r, pa, dg, ps, pd, n, k, lanes, st); break;
    case 8: launch_parent_sets<8>(s, c, e, m, d, r, pa, dg, ps, pd, n, k, lanes, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
