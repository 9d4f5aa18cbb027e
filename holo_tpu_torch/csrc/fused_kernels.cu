// The fused Jacobi round of the gather SPF engine for Hopper (sm_90a), plain
// C interface for ctypes.
//
//   ell_fused_round <- holo_tpu/ops/spf_engine.py:1071-1106, round_fn of
//                      spf_one_fused: the round of the `fused` (separate
//                      gathers) and `packed` (one row gather) engines.  The
//                      JAX package runs it inside lax.while_loop, where XLA
//                      fuses it into loop fusions; there is no Pallas kernel.
//
// One round recomputes every quantity of a row from the state before it (all
// int32, INF = 1<<30 unreachable; adds wrap as JAX's int32 adds, in unsigned):
//
//   dist'  = min(dist, min over usable slots with dist[src] < INF of
//            dist[src] + cost)
//   DAG    = those slots with dist' < INF and dist[src] + cost == dist' (the
//            new distance against the OLD neighbour), v not the lane's root
//   parent = the DAG slot's source minimizing (dist[src], src); N if none
//   hops'  = 0 at the root; hops[parent] + inc[v] where parent < N and
//            hops[parent] < N + 1; N + 1 elsewhere (recomputed, so a stale
//            value can rise or fall)
//   nh'[w] = OR over the DAG slots of (hops[src] == 0 ? direct[v, k, w] :
//            nh[src, w]), with the OLD hops and words (_nh_words_round)
//
// Every slot whose source is the parent carries hops[parent], so hops' takes
// the hops of the slot that wins the (dist, src) argmin.
//
// Planes: src, cost, slot [N, K] (slot = the in-edge's edge id, -1 for
// padding); mask [E, ceil(B/32)] with bit b%32 of word [e, b/32] set where
// edge e is up in lane b, or NULL; direct [N, K, W] one-hot atom words; inc
// [N] (1 at a router); roots [B]; frontier [N, ceil(B/32)].  Two layouts of
// the state, the JAX package's `packed` switch: planar (`fused`), dist [N, B],
// hops [N, B], next hops [N, W, B], lanes minor; interleaved (`packed`), one
// plane [N, B, 2 + W], (dist, hops, words) of a (row, lane) contiguous.
//
// Frontier skip.  Write S_r for the state before round r.  Row v's S_{r+1}
// and parent are functions of dist_r[v] and of S_r[u] over v's usable
// sources u alone.  If no usable source of v changed in round r - 1, then
// dist_{r+1}[v] = min(dist_r[v], C) with the same candidate minimum C that
// gave dist_r[v] = min(dist_{r-1}[v], C), so dist_{r+1}[v] = dist_r[v], and
// the DAG, the parent, hops and the words are the same functions of the same
// inputs: the whole row repeats, parent included.  (Round 1 has no round
// before it: its frontier is all ones.)  So the kernel takes the frontier of
// the round before (bit b%32 of word [v, b/32]: lane b of row v changed) and
//
// - recomputes a (row, lane) iff some valid slot of the row, whose edge is
//   up in that lane, has a source with its frontier bit set; the skip is by
//   row and lane, not by slot (as ell_relax's is), because the DAG, the
//   argmin and the OR are rebuilt from scratch, so a recomputed lane needs
//   all its sources;
// - else copies it from the input state into the output buffer if its own
//   frontier bit is set: the fixpoint loop ping-pongs two buffers, so the
//   one written holds S_{r-1}, which differs from S_r exactly there;
// - else leaves it alone (S_{r-1} = S_r there).
//
// The parent plane is carried across rounds and written only where a lane is
// recomputed.  The changed flag and the frontier written beside the output
// come from the recomputed lanes alone (a copied lane did not move): bit set
// where dist', hops' or a word differs from the input, written whole (a
// __ballot_sync of the tile, or one word a row), no atomics and no zero fill.
//
// One pass over a running best, in both layouts: b starts at dist[v]; a
// candidate below b resets the (dist, src) argmin and the OR accumulators,
// one equal to b accumulates into them.  The gathers come in batches: the
// batch's candidates lower b first, then the batch's slots at b accumulate.
// After each batch the accumulators hold exactly the slots seen so far whose
// candidate equals b, so at the end they hold the DAG.  The planar layout
// gathers hops and the words only for a slot at the running best, batched
// behind its batch's dist gathers.
//
// Tile form (more than SMALL lanes).  A warp owns one row and a group of TGF
// 32-lane tiles (grid x: WARPS rows a block; grid y: the lane group, the
// slowest axis, so the gathered rows at any moment are one 128-lane slab of
// the state).  Pass 1 takes the group's tiles together: per 32-slot chunk
// each thread loads one slot's src and slot (the next chunk's in flight),
// then its source's frontier words and, where one is not 0, the slot's mask
// words; the warp ORs them into the recompute words (__reduce_or_sync).
// Pass 2 and the writes take the tiles one after another, so one tile's
// accumulators are live at a time (walking the group's tiles together took
// 128 registers and spills and ran twice as slow): per chunk each thread
// loads its slot's (src, cost, slot), the next chunk's in flight, and its
// mask word, and the warp walks the tile's active slots (a ballot) GATHERS
// gathers at a time.  The next-hop words go FW at a time: a chunk of words
// repeats pass 2 inside the block, so one warp writes the row's frontier
// word of a tile.  Streamed planes are read with __ldcs, outputs written
// with __stcs, and the gathers carry an L2 evict_last policy.
//
// Row form (up to SMALL lanes: compute() is one lane).  A warp owns one row
// and all its lanes; thread t takes slots t, t + 32, ... (three at K = 96),
// RS at a time with their loads issued together, and keeps its own running
// best a lane, and the warp meets in
// __reduce_min_sync: the candidate minimum, then the (dist, src) argmin in
// two steps among the threads whose best is the minimum, then the winner's
// hops (every slot whose source is the winner carries the same); the words
// meet in __reduce_or_sync.  The frontier is one word a row.
//
// The interleaved vector.  In the row form, where 2 + W == 4 and the planes
// are 16-byte aligned, a lane's (dist, hops, words) gather is one int4 load
// (16 bytes, a half sector), so a slot at the running best needs no second
// gather.  The tile form gathers dist alone and the rest only at the running
// best: eight int4 vectors in flight took it to 128 registers a thread, and
// it measured slower than this path on the same inputs (PERF.md, Findings).
//
// What bounds it.  A round must read the src and slot planes, the source's
// frontier words and, where one is set, the slot's mask word; for a row that
// recomputes a lane, its costs and the state of the sources it gathers (dist
// of a usable slot's source, hops and the words of a DAG slot's source), each
// (source, lane) once; and write the recomputed and copied lanes and the
// recomputed lanes' parents once (chip_smoke's bound, at the HBM rate).  A
// gather moves a 32-byte sector, far more than the entry it needs, so the
// kernel lives on L2: the planar dist plane is 41.5 MB at 10,125 x 1024 and
// fits in the 50 MB L2; the interleaved plane is 166 MB and does not, but a
// 128-lane slab of it (20.7 MB) does, which the slab order exploits.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int INF = 1 << 30;
constexpr unsigned FULL = 0xffffffffu;
constexpr int SMALL = 8;    // lane counts up to this: the row form
constexpr int TGF = 4;      // 32-lane tiles a warp of the tile form takes
constexpr int WARPS = 8;    // warps (rows) a block
constexpr int FW = 2;       // next-hop words a pass accumulates
constexpr int GATHERS = 8;  // gathers a warp issues together (tile form)
constexpr int RS = 4;       // slots a thread of the row form loads together
constexpr int TILE_BLOCKS = 4;  // blocks an SM the tile form is held to (64 registers)

__device__ __forceinline__ int add32(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

// The slot's mask word of tile `tile` (FULL without a mask).
__device__ __forceinline__ unsigned mask_word(const int* __restrict__ mask, int e, int words,
                                              int tile) {
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
// a multiple of 4, p 16-byte aligned) loads them as N / 4 int4 vectors.  CS
// streams them.
template <int N, bool CS>
__device__ __forceinline__ void ld_words(const int* p, int n, bool vec, unsigned (&w)[N]) {
  if constexpr (N % 4 == 0) {
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
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) w[i] = i < n ? (unsigned)(CS ? __ldcs(p + i) : __ldg(p + i)) : 0u;
}

// The (dist, src) argmin over the DAG slots, with the winner's hops.
__device__ __forceinline__ void argmin(int d, int u, int h, int& pd, int& ps, int& ph) {
  if (d < pd || (d == pd && u < ps)) {
    pd = d;
    ps = u;
    ph = h;
  }
}

// A lane's own state: dist, hops and words w0 .. w0 + nw (0 past them).
template <bool PACKED, bool VEC4>
__device__ __forceinline__ void ld_own(const int* __restrict__ dist, const int* __restrict__ hops,
                                       const int* __restrict__ nh, long v, int b, int lanes,
                                       int nwords, int w0, int nw, int& d, int& h,
                                       unsigned (&x)[FW]) {
  const long me = v * lanes + b;
  if constexpr (VEC4) {
    const int4 q = __ldcs(reinterpret_cast<const int4*>(dist + me * 4));
    d = q.x;
    h = q.y;
    x[0] = (unsigned)q.z;
    x[1] = (unsigned)q.w;
  } else if constexpr (PACKED) {
    const int* p = dist + me * (2 + nwords);
    d = __ldcs(p);
    h = __ldcs(p + 1);
#pragma unroll
    for (int w = 0; w < FW; ++w) x[w] = w < nw ? (unsigned)__ldcs(p + 2 + w0 + w) : 0u;
  } else {
    d = __ldcs(dist + me);
    h = __ldcs(hops + me);
#pragma unroll
    for (int w = 0; w < FW; ++w)
      x[w] = w < nw ? (unsigned)__ldcs(nh + (v * nwords + w0 + w) * lanes + b) : 0u;
  }
}

// Store a lane's dist and hops (`first`: the first word chunk) and words
// w0 .. w0 + nw.
template <bool PACKED, bool VEC4>
__device__ __forceinline__ void st_own(int* __restrict__ dist, int* __restrict__ hops,
                                       int* __restrict__ nh, long v, int b, int lanes,
                                       int nwords, int w0, int nw, bool first, int d, int h,
                                       const unsigned (&x)[FW]) {
  const long me = v * lanes + b;
  if constexpr (VEC4) {
    __stcs(reinterpret_cast<int4*>(dist + me * 4), make_int4(d, h, (int)x[0], (int)x[1]));
  } else if constexpr (PACKED) {
    int* p = dist + me * (2 + nwords);
    if (first) {
      __stcs(p, d);
      __stcs(p + 1, h);
    }
#pragma unroll
    for (int w = 0; w < FW; ++w)
      if (w < nw) __stcs(p + 2 + w0 + w, (int)x[w]);
  } else {
    if (first) {
      __stcs(dist + me, d);
      __stcs(hops + me, h);
    }
#pragma unroll
    for (int w = 0; w < FW; ++w)
      if (w < nw) __stcs(nh + (v * nwords + w0 + w) * lanes + b, (int)x[w]);
  }
}

// One fused round, tile form: blockIdx.x = row block, blockIdx.y = lane group.
// Pass 1 takes the group's tiles together; pass 2 and the writes take them
// one after another, so only one tile's accumulators are live.
template <bool PACKED>
__global__ void __launch_bounds__(WARPS * 32, TILE_BLOCKS)
ell_fused_tile(const int* __restrict__ src, const int* __restrict__ cost,
               const int* __restrict__ slot, const int* __restrict__ mask,
               const int* __restrict__ direct, const int* __restrict__ inc,
               const int* __restrict__ roots, const int* __restrict__ dist,
               const int* __restrict__ hops, const int* __restrict__ nh,
               const int* __restrict__ front, int* __restrict__ dist_out,
               int* __restrict__ hops_out, int* __restrict__ nh_out, int* __restrict__ parent,
               int* __restrict__ changed, int* __restrict__ front_out, int n, int k, int lanes,
               int nwords, bool vec) {
  const int t = threadIdx.x % 32;
  const long v = (long)blockIdx.x * WARPS + threadIdx.x / 32;
  if (v >= n) return;
  const int words = (lanes + 31) / 32;
  const int tile0 = blockIdx.y * TGF;
  const int ntiles = min(TGF, words - tile0);
  const int c = 2 + nwords;
  const long row = v * k;
  const uint64_t pol = keep_policy();

  // Pass 1: the recompute words of the group's tiles; thread g < TGF keeps
  // tile g's recompute and own frontier words.
  unsigned my_rec = 0u, my_fo = 0u;
  {
    unsigned rec[TGF];
#pragma unroll
    for (int g = 0; g < TGF; ++g) rec[g] = 0u;
    int s = 0, e = -1;
    if (t < k) {
      e = __ldg(slot + row + t);
      s = __ldg(src + row + t);
    }
    for (int k0 = 0; k0 < k; k0 += 32) {
      int sn = 0, en = -1;  // the next chunk's slot, in flight
      if (k0 + 32 + t < k) {
        en = __ldg(slot + row + k0 + 32 + t);
        sn = __ldg(src + row + k0 + 32 + t);
      }
      if (e >= 0) {
        unsigned f[TGF];
        ld_words<TGF, false>(front + (long)s * words + tile0, ntiles, vec, f);
        unsigned any = 0u;
#pragma unroll
        for (int g = 0; g < TGF; ++g) any |= f[g];
        if (any != 0u && mask != nullptr) {
          unsigned m[TGF];
          ld_words<TGF, false>(mask + (long)e * words + tile0, ntiles, vec, m);
#pragma unroll
          for (int g = 0; g < TGF; ++g) f[g] &= m[g];
        }
#pragma unroll
        for (int g = 0; g < TGF; ++g) rec[g] |= f[g];
      }
      s = sn;
      e = en;
    }
#pragma unroll
    for (int g = 0; g < TGF; ++g) {
      const unsigned r = __reduce_or_sync(FULL, rec[g]);
      if (t == g) my_rec = r;
    }
    if (t < ntiles) my_fo = (unsigned)__ldg(front + v * words + tile0 + t);
  }

  bool ch = false;
  for (int g = 0; g < ntiles; ++g) {
    const int tile = tile0 + g;
    const unsigned rec = __shfl_sync(FULL, my_rec, g), fo = __shfl_sync(FULL, my_fo, g);
    const int b = tile * 32 + t;
    const bool on = b < lanes;
    const bool r = on && ((rec >> t) & 1u);
    const bool live = r && __ldg(roots + b) != v;  // recomputed, not the lane's root
    bool moved = false;
    for (int w0 = 0; (rec | fo) != 0u && (w0 == 0 || w0 < nwords); w0 += FW) {
      const int nw = max(0, min(FW, nwords - w0));
      const bool first = w0 == 0;
      int best = INF, pd = INF, ps = n, ph = n + 1;
      unsigned acc[FW];
#pragma unroll
      for (int w = 0; w < FW; ++w) acc[w] = 0u;
      if (r) best = PACKED ? __ldcs(dist + (v * lanes + b) * c) : __ldcs(dist + v * lanes + b);
      // Pass 2: the slots of the recomputed lanes.
      int s = 0, co = 0, e = -1;
      if (rec != 0u && t < k) {
        s = __ldcs(src + row + t);
        co = __ldcs(cost + row + t);
        e = __ldcs(slot + row + t);
      }
      for (int k0 = 0; rec != 0u && k0 < k; k0 += 32) {
        int sn = 0, cn = 0, en = -1;  // the next chunk's slot, in flight
        if (k0 + 32 + t < k) {
          sn = __ldcs(src + row + k0 + 32 + t);
          cn = __ldcs(cost + row + k0 + 32 + t);
          en = __ldcs(slot + row + k0 + 32 + t);
        }
        // act: recomputed lanes of the tile in which this thread's slot is up.
        const unsigned act = e >= 0 ? mask_word(mask, e, words, tile) & rec : 0u;
        unsigned todo = __ballot_sync(FULL, act != 0u);  // the tile's active slots
        while (todo != 0u) {
          int du[GATHERS], sq[GATHERS], cq[GATHERS], jq[GATHERS];
#pragma unroll
          for (int q = 0; q < GATHERS; ++q) {
            du[q] = INF;
            sq[q] = cq[q] = 0;
            jq[q] = 0;
            if (todo != 0u) {  // the same for the whole warp
              const int j = __ffs(todo) - 1;
              todo &= todo - 1u;
              const unsigned a = __shfl_sync(FULL, act, j);
              sq[q] = __shfl_sync(FULL, s, j);
              cq[q] = __shfl_sync(FULL, co, j);
              jq[q] = j;
              if ((a >> t) & 1u) {
                if constexpr (PACKED) {
                  du[q] = ld_gather(dist + ((long)sq[q] * lanes + b) * c, pol);
                } else {
                  du[q] = ld_gather(dist + (long)sq[q] * lanes + b, pol);
                }
              }
            }
          }
          // The batch lowers the running best, then its slots at the best
          // accumulate.
          int m = best;
#pragma unroll
          for (int q = 0; q < GATHERS; ++q) {
            cq[q] = add32(du[q], cq[q]);  // the candidate
            if (du[q] < INF) m = min(m, cq[q]);
          }
          if (m < best) {
            best = m;
            pd = INF;
            ps = n;
            ph = n + 1;
#pragma unroll
            for (int w = 0; w < FW; ++w) acc[w] = 0u;
          }
          const bool can = live && best < INF;
#pragma unroll
          for (int q = 0; q < GATHERS; ++q) {
            if (!(can && du[q] < INF && cq[q] == best)) continue;
            int h;
            unsigned x[FW];
            if constexpr (PACKED) {
              const int* p = dist + ((long)sq[q] * lanes + b) * c;
              h = ld_gather(p + 1, pol);
#pragma unroll
              for (int w = 0; w < FW; ++w)
                x[w] = w < nw ? (unsigned)ld_gather(p + 2 + w0 + w, pol) : 0u;
            } else {
              h = ld_gather(hops + (long)sq[q] * lanes + b, pol);
#pragma unroll
              for (int w = 0; w < FW; ++w)
                x[w] = w < nw ? (unsigned)ld_gather(nh + ((long)sq[q] * nwords + w0 + w) * lanes + b,
                                                    pol)
                              : 0u;
            }
            argmin(du[q], sq[q], h, pd, ps, ph);
            if (h == 0) {
              const int* dr = direct + (row + k0 + jq[q]) * nwords + w0;
#pragma unroll
              for (int w = 0; w < FW; ++w)
                if (w < nw) acc[w] |= (unsigned)__ldg(dr + w);
            } else {
#pragma unroll
              for (int w = 0; w < FW; ++w) acc[w] |= x[w];
            }
          }
        }
        s = sn;
        co = cn;
        e = en;
      }
      // The recomputed lane's new values, or the copied lane's old ones.
      if (r || (on && ((fo >> t) & 1u))) {
        int d, hv;
        unsigned old[FW];
        ld_own<PACKED, false>(dist, hops, nh, v, b, lanes, nwords, w0, nw, d, hv, old);
        if (!r) {
          st_own<PACKED, false>(dist_out, hops_out, nh_out, v, b, lanes, nwords, w0, nw, first, d,
                               hv, old);
        } else {
          const int hn = !live ? 0 : (ps < n && ph < n + 1 ? ph + __ldg(inc + v) : n + 1);
          moved |= first && (best != d || hn != hv);
#pragma unroll
          for (int w = 0; w < FW; ++w) moved |= w < nw && acc[w] != old[w];
          st_own<PACKED, false>(dist_out, hops_out, nh_out, v, b, lanes, nwords, w0, nw, first,
                               best, hn, acc);
          if (first) __stcs(parent + v * lanes + b, ps);
        }
      }
    }
    const unsigned word = __ballot_sync(FULL, moved);
    if (t == 0) __stcs(front_out + v * words + tile, (int)word);
    ch |= word != 0u;
  }
  if (ch && t == 0) *changed = 1;
}

// One fused round, row form: blockIdx.x = row block; one frontier word a row.
// Each thread takes up to RS of its slots at a time (all of them at K <=
// 32 RS), their loads issued together.
template <bool PACKED, bool VEC4>
__global__ void __launch_bounds__(WARPS * 32)
ell_fused_rows(const int* __restrict__ src, const int* __restrict__ cost,
               const int* __restrict__ slot, const int* __restrict__ mask,
               const int* __restrict__ direct, const int* __restrict__ inc,
               const int* __restrict__ roots, const int* __restrict__ dist,
               const int* __restrict__ hops, const int* __restrict__ nh,
               const int* __restrict__ front, int* __restrict__ dist_out,
               int* __restrict__ hops_out, int* __restrict__ nh_out, int* __restrict__ parent,
               int* __restrict__ changed, int* __restrict__ front_out, int n, int k, int lanes,
               int nwords) {
  const int t = threadIdx.x % 32;
  const long v = (long)blockIdx.x * WARPS + threadIdx.x / 32;
  if (v >= n) return;
  const int c = 2 + nwords;
  const long row = v * k;
  const unsigned fo = (unsigned)__ldg(front + v);
  unsigned r = 0u;
  for (int k0 = t; k0 < k; k0 += 32 * RS) {
    int e[RS], u[RS];
#pragma unroll
    for (int i = 0; i < RS; ++i) {
      const int kk = k0 + 32 * i;
      e[i] = kk < k ? __ldg(slot + row + kk) : -1;
      u[i] = kk < k ? __ldg(src + row + kk) : 0;
    }
#pragma unroll
    for (int i = 0; i < RS; ++i)
      if (e[i] >= 0) r |= (unsigned)__ldg(front + u[i]) & mask_word(mask, e[i], 1, 0);
  }
  const unsigned rec = __reduce_or_sync(FULL, r);
  bool moved = false;  // thread b: lane b moved
  for (int w0 = 0; (rec | fo) != 0u && (w0 == 0 || w0 < nwords); w0 += FW) {
    const int nw = max(0, min(FW, nwords - w0));
    const bool first = w0 == 0;
#pragma unroll
    for (int b = 0; b < SMALL; ++b) {
      if (b >= lanes) break;
      if (!((rec >> b) & 1u)) {
        if (t == b && ((fo >> b) & 1u)) {
          int d, hv;
          unsigned old[FW];
          ld_own<PACKED, VEC4>(dist, hops, nh, v, b, lanes, nwords, w0, nw, d, hv, old);
          st_own<PACKED, VEC4>(dist_out, hops_out, nh_out, v, b, lanes, nwords, w0, nw, first,
                               d, hv, old);
        }
        continue;
      }
      const bool live = __ldg(roots + b) != v;
      int best = PACKED ? __ldg(dist + (v * lanes + b) * c) : __ldg(dist + v * lanes + b);
      int pd = INF, ps = n, ph = n + 1;
      unsigned acc[FW];
#pragma unroll
      for (int w = 0; w < FW; ++w) acc[w] = 0u;
      for (int k0 = t; k0 < k; k0 += 32 * RS) {
        int du[RS], cd[RS], us[RS];
        long at[RS];
        int4 vq[RS];
#pragma unroll
        for (int i = 0; i < RS; ++i) {
          const int kk = k0 + 32 * i;
          const int e = kk < k ? __ldg(slot + row + kk) : -1;
          du[i] = INF;
          us[i] = e >= 0 ? __ldg(src + row + kk) : 0;
          cd[i] = e >= 0 ? __ldg(cost + row + kk) : 0;
          at[i] = PACKED ? ((long)us[i] * lanes + b) * c : (long)us[i] * lanes + b;
          if (e >= 0 && ((mask_word(mask, e, 1, 0) >> b) & 1u)) {
            if constexpr (VEC4) {
              vq[i] = __ldg(reinterpret_cast<const int4*>(dist + at[i]));
              du[i] = vq[i].x;
            } else {
              du[i] = __ldg(dist + at[i]);
            }
          }
        }
        // The thread's slots lower its running best, then those at the best
        // accumulate.
        int m = best;
#pragma unroll
        for (int i = 0; i < RS; ++i) {
          cd[i] = add32(du[i], cd[i]);  // the candidate
          if (du[i] < INF) m = min(m, cd[i]);
        }
        if (m < best) {
          best = m;
          pd = INF;
          ps = n;
          ph = n + 1;
#pragma unroll
          for (int w = 0; w < FW; ++w) acc[w] = 0u;
        }
#pragma unroll
        for (int i = 0; i < RS; ++i) {
          if (!(live && best < INF && du[i] < INF && cd[i] == best)) continue;
          int h;
          unsigned x[FW];
          if constexpr (VEC4) {
            h = vq[i].y;
            x[0] = (unsigned)vq[i].z;
            x[1] = (unsigned)vq[i].w;
          } else {
            h = PACKED ? __ldg(dist + at[i] + 1) : __ldg(hops + at[i]);
#pragma unroll
            for (int w = 0; w < FW; ++w)
              x[w] = w >= nw ? 0u
                   : PACKED ? (unsigned)__ldg(dist + at[i] + 2 + w0 + w)
                            : (unsigned)__ldg(nh + ((long)us[i] * nwords + w0 + w) * lanes + b);
          }
          argmin(du[i], us[i], h, pd, ps, ph);
#pragma unroll
          for (int w = 0; w < FW; ++w)
            if (w < nw)
              acc[w] |= h == 0 ? (unsigned)__ldg(direct + (row + k0 + 32 * i) * nwords + w0 + w)
                               : x[w];
        }
      }
      // The warp meets: the best, then the argmin among the threads at it.
      const int gbest = __reduce_min_sync(FULL, best);
      const bool in = best == gbest;
      const int gpd = __reduce_min_sync(FULL, in ? pd : INF);
      const int gps = __reduce_min_sync(FULL, in && pd == gpd ? ps : n);
      const int gph = __reduce_min_sync(FULL, in && pd == gpd && ps == gps ? ph : n + 1);
      unsigned gacc[FW];
#pragma unroll
      for (int w = 0; w < FW; ++w) gacc[w] = __reduce_or_sync(FULL, in ? acc[w] : 0u);
      if (t == b) {
        int d, hv;
        unsigned old[FW];
        ld_own<PACKED, VEC4>(dist, hops, nh, v, b, lanes, nwords, w0, nw, d, hv, old);
        const int hn = !live ? 0 : (gps < n && gph < n + 1 ? gph + __ldg(inc + v) : n + 1);
        moved |= first && (gbest != d || hn != hv);
#pragma unroll
        for (int w = 0; w < FW; ++w) moved |= w < nw && gacc[w] != old[w];
        st_own<PACKED, VEC4>(dist_out, hops_out, nh_out, v, b, lanes, nwords, w0, nw, first,
                             gbest, hn, gacc);
        if (first) parent[v * lanes + b] = gps;
      }
    }
  }
  const unsigned word = __ballot_sync(FULL, moved);  // bit b: lane b (thread b)
  if (t == 0) {
    front_out[v] = (int)word;
    if (word != 0u) *changed = 1;
  }
}

unsigned row_blocks(int n) { return (unsigned)((n + WARPS - 1) / WARPS); }
bool aligned16(const void* p) { return p == nullptr || (uintptr_t)p % 16 == 0; }

// What a launch takes, decided in one place for holo_ell_fused_round and
// holo_ell_fused_info: the row form up to SMALL lanes (its int4 path where
// a lane's interleaved vector is 16 bytes and both planes are 16-byte
// aligned), else the tile form (its 16-byte loads of the mask and frontier
// words where a group is whole and both are aligned).
struct Choice {
  decltype(&ell_fused_rows<false, false>) rows;  // null in the tile form
  decltype(&ell_fused_tile<false>) tile;         // null in the row form
  int tiles;  // 32-lane tiles a warp; 0 in the row form
  bool vec4;  // row form: a lane's vector is one int4
  bool vec;   // tile form: 16-byte mask and frontier loads
};

Choice choose(int lanes, int nwords, int packed, const void* dist, const void* dist_out,
              const void* mask, const void* front) {
  Choice c{};
  if (lanes <= SMALL) {
    c.vec4 = packed && nwords == 2 && aligned16(dist) && aligned16(dist_out);
    if (c.vec4)
      c.rows = ell_fused_rows<true, true>;
    else if (packed)
      c.rows = ell_fused_rows<true, false>;
    else
      c.rows = ell_fused_rows<false, false>;
  } else {
    const int words = (lanes + 31) / 32;
    c.tiles = TGF;
    c.vec = words % TGF == 0 && aligned16(mask) && aligned16(front);
    if (packed)
      c.tile = ell_fused_tile<true>;
    else
      c.tile = ell_fused_tile<false>;
  }
  return c;
}

}  // namespace

extern "C" {

int holo_ell_fused_round(const void* src, const void* cost, const void* slot,
                         const void* mask, const void* direct, const void* inc,
                         const void* roots, const void* dist, const void* hops,
                         const void* nh, const void* front, void* dist_out, void* hops_out,
                         void* nh_out, void* parent, void* changed, void* front_out, int n,
                         int k, int lanes, int nwords, int packed, void* stream) {
  if (n == 0 || lanes == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const int *s = (const int*)src, *co = (const int*)cost, *sl = (const int*)slot,
            *m = (const int*)mask, *di = (const int*)direct, *ic = (const int*)inc,
            *r = (const int*)roots, *d = (const int*)dist, *h = (const int*)hops,
            *x = (const int*)nh, *f = (const int*)front;
  int *dout = (int*)dist_out, *hout = (int*)hops_out, *xout = (int*)nh_out,
      *p = (int*)parent, *ch = (int*)changed, *fout = (int*)front_out;
  const Choice c = choose(lanes, nwords, packed, dist, dist_out, mask, front);
  if (c.rows != nullptr) {
    const auto kernel = c.rows;
    kernel<<<row_blocks(n), WARPS * 32, 0, st>>>(s, co, sl, m, di, ic, r, d, h, x, f, dout, hout,
                                                 xout, p, ch, fout, n, k, lanes, nwords);
  } else {
    const dim3 grid(row_blocks(n), (unsigned)(((lanes + 31) / 32 + TGF - 1) / TGF));
    const auto kernel = c.tile;
    kernel<<<grid, WARPS * 32, 0, st>>>(s, co, sl, m, di, ic, r, d, h, x, f, dout, hout, xout, p,
                                        ch, fout, n, k, lanes, nwords, c.vec);
  }
  return (int)cudaGetLastError();
}

// What holo_ell_fused_round launches for (lanes, nwords, packed) on the
// state planes dist and dist_out (the mask and frontier taken as aligned):
// out[0] = 32-lane tiles a warp (0 for the row form), out[1] = 1 where a
// lane's vector is one int4, out[2] = the kernel's registers a thread.
int holo_ell_fused_info(int lanes, int nwords, int packed, const void* dist,
                        const void* dist_out, void* out) {
  int* o = (int*)out;
  const Choice c = choose(lanes, nwords, packed, dist, dist_out, nullptr, nullptr);
  o[0] = c.tiles;
  o[1] = c.vec4 ? 1 : 0;
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(
      &attr, c.rows != nullptr ? (const void*)c.rows : (const void*)c.tile);
  o[2] = err == cudaSuccess ? attr.numRegs : 0;
  return (int)err;
}

}  // extern "C"
