// The tropical (min-plus) tile relax T1 of the tropical SPF engine for Hopper
// (sm_90a), plain C interface for ctypes.
//
//   trop_relax <- holo_tpu/ops/tropical.py:423-464, the body of _tile_relax's
//                 lax.while_loop (an XLA fusion; the JAX package has no
//                 Pallas kernel there): one round of the blocked min-plus
//                 fixpoint over S independent lanes; two kernels, the tile
//                 pass (trop_relax_tile / trop_relax_rows) and the repair
//                 pass (trop_repair), launched one after the other on one
//                 stream by one wrapper call
//   trop_count (T2) <- holo_tpu/ops/tropical.py:559-572 and :608-623, the
//                 bodies of the multipath tile fixpoints (int32 einsums in
//                 XLA): one round of the integer count-tile contraction,
//                 described at its kernels below
//
// Planes (int32, INF = 1<<30 unreachable), in the tiles' permuted vertex
// space padded to NB*B rows: tiles [NB, Tm, B, B] (tiles[rb, t, i, j] = the
// least cost of an edge cb[rb, t]*B + j -> rb*B + i, INF where none); cb
// [NB, Tm] (NB for a padding slot); dist [NB*B, S], lanes minor; active
// [NB, ceil(S/32)] (bit s%32 of word [c, s/32]: a row of block c changed in
// lane s in the round before); repair [NB*B, ceil(S/32)] or NULL (bit s of
// word [p, s/32]: row p's value in lane s is the exact masked ELL relax) and
// its pairs [R, 2] (permuted row, lane) of every set bit, listed once per
// fixpoint.  The repair pass reads the ELL planes src, cost, slot [N, K]
// (slot = edge id, -1 for padding), the mask words [E, ceil(S/32)] (NULL:
// every edge up), perm [NB*B] (permuted row -> vertex) and inv [N] (vertex ->
// permuted row).  out [NB*B, S] is another buffer that equals dist outside
// the (block, lane)s of active (the fixpoint passes the buffer of the round
// before, the first round a copy of dist).
//
// One round, per (row block rb, lane s):
//   agg[rb*B + i, s] = min over slots t with cb != NB and block cb active in
//                      lane s, and over j, of tiles[rb, t, i, j] + dist[cb*B
//                      + j, s], saturated at INF;
//   a repair (row, lane) takes the exact masked ELL row relax instead;
//   new = min(dist, agg) into out; active_out marks the (block, lane)s of a
//   change; changed is set if any value changed.
// Every operand is at most INF = 2^30, so a sum is at most 2^31: the adds are
// unsigned (in int32, INF + INF would wrap negative and win the min) and the
// least sum is clamped to INF at the end, as tropical.py:409-418 says.
//
// What bounds it.  A round with every block active at the k=90 fat tree x
// 1024 lanes does 53,524 tiles x 64 entries x 1024 lanes = 3.5 G (add, min)
// pairs: 7.0 G operations, 0.21 ms at the card's int32 rate.  Its bytes are
// ~0.03 ms from memory, but the gathered source rows (B rows x the block's
// lanes for every active slot, 1.75 GB at a full round) come through L2 once
// a block; the round is bound by operations and that L2 traffic.
//
// Tile form (more than SMALL lanes; Tile<B> below).  A block owns one row
// block and LANES lanes (256 for B = 8 and 16): at k=90 x 1024, 1,266 x 4 =
// 5,064 blocks of 64 threads.  Its threads list, once for the block, the
// slots whose source block is active in one of its lane words (the OR of
// those words; shared-memory atomics, order free: min is), keeping each
// listed slot's words; CH listed tiles at a time are staged in shared memory
// (int4 copies).  A thread carries R rows (all 8 for B = 8) of one row
// group and L lanes (4 for B = 8, 2 above), lanes l + 32k of its warp's
// lane range: per listed slot it skips the slot if none of its warp's
// words has the source (a warp-uniform branch), reads each (source row j,
// lane) value once into a register straight from dist (coalesced, INF where
// the lane's bit is clear) and applies the tile's row words as uint4
// broadcasts, DPX min(w + d, acc) per (entry, lane) pair.  Shared-memory
// reads per (entry, lane) pair, by the kernel's own count: 2 uint4 loads per
// (row, 8 columns) feed 8 x L pairs, 1/(4L) loads or 1/L 32-bit words: B = 8
// 0.0625 loads, 0.25 words; above 8, 0.125 loads, 0.5 words.  Then each
// thread takes new = min(old, agg) for its (row, lane)s, skipping the repair
// (row, lane)s (no write, no vote: the repair pass owns them), and writes
// out only where the lane's input frontier bit is set or the value changed
// (the copy rule: out holds the round before, equal to dist elsewhere).  A
// warp whose lanes saw no active source and have no frontier bit reads and
// writes nothing; its active_out words are still written whole.  For B = 8 a
// warp owns its L active_out words (a ballot each, no atomics, no barrier);
// above 8 the row groups' ballots meet in shared memory.
//
// The tile form for B = 8 / 16 / 32 / 64 / 128: threads 64 / 256 / 256 / 256
// / 256, lanes a block 256 / 256 / 128 / 64 / 64, dynamic shared memory
// 13,312 / 21,504 / 19,456 / 34,816 / 67,584 bytes; registers a thread 128 /
// 100 / 100 / 96 / 109 and blocks an SM 8 / 2 / 2 / 2 / 2 on the H100 with
// CUDA 12.8 (nvcc -Xptxas -v and cudaOccupancyMaxActiveBlocksPerMultiprocessor;
// chip_smoke prints them, PERF.md keeps them).  The row form: 30 registers;
// the repair pass: 32.
//
// Row form (up to SMALL lanes: compute() is one lane).  A block owns one row
// block; each warp takes rows i = warp, warp + 8, ...: its threads split the
// row's Tm x B (slot, j) entries, each keeping a minimum per lane, then
// meet in __reduce_min_sync; thread s finishes lane s, writing every
// (row, lane) but the repair ones.
//
// Repair pass (trop_repair): a warp a listed repair (row, lane); its 32
// threads split the K slots of the row's vertex (slot, src and cost loaded
// together, then the mask word and inv, then the source's value) and meet in
// __reduce_min_sync; lane 0 writes min(old, value) into out and, on a
// change, ORs the lane's bit into active_out (global atomicOr: several pairs
// share a word) and sets changed.  It runs after the tile pass on the same
// stream, which has written active_out whole, and reads dist, which no pass
// writes (Jacobi).
//
// Changed flag: a block with a change stores 1; the wrapper zeroes the flag.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned INF = 1u << 30;
constexpr int ROW_THREADS = 256;
constexpr int ROW_WARPS = ROW_THREADS / 32;
constexpr int SMALL = 8;  // lane counts up to this run the row form
constexpr int LIST = 128;  // slots listed a pass of the tile form
constexpr int REPAIR_THREADS = 256;

// The tile form's geometry for tile size B.
template <int B>
struct Tile {
  static constexpr int L = B == 8 ? 4 : 2;                   // lanes a thread
  static constexpr int R = B == 128 ? 16 : 8;                // rows a thread
  static constexpr int G = B / R;                            // row groups
  static constexpr int LWARPS = B == 8 ? 8 / L : (B == 16 ? 4 : (B == 32 ? 2 : 1));
  static constexpr int THREADS = 32 * G * LWARPS;
  static constexpr int LANES = 32 * L * LWARPS;              // lanes a block
  static constexpr int WORDS = LANES / 32;                   // lane words a block
  static constexpr int CH = B == 8 ? 32 : (B == 16 ? 16 : (B == 32 ? 4 : (B == 64 ? 2 : 1)));
  // Dynamic shared memory: CH tiles, then the listed slots' words, slots
  // and source blocks.
  static constexpr int SMEM = (CH * B * B + LIST * WORDS + 2 * LIST) * (int)sizeof(unsigned);
  static constexpr int MIN_BLOCKS = 512 / THREADS;  // caps registers at 128 a thread
  static_assert(THREADS <= 256 && B % R == 0 && R % 8 == 0, "tile geometry");
};

// min(w + d, acc) in one DPX instruction; every operand is at most 2^30, so
// the sum fits 32 bits.
__device__ __forceinline__ unsigned relax_step(unsigned w, unsigned d, unsigned acc) {
  return __viaddmin_u32(w, d, acc);
}

// The valid-lane bits of lane word `word` of `lanes` lanes.
__device__ __forceinline__ unsigned lane_bits(int word, int lanes) {
  const int rest = lanes - word * 32;
  return rest >= 32 ? 0xffffffffu : (rest <= 0 ? 0u : (1u << rest) - 1u);
}

template <int B>
__global__ void __launch_bounds__(Tile<B>::THREADS, Tile<B>::MIN_BLOCKS)
    trop_relax_tile(const int* __restrict__ tiles, const int* __restrict__ cb,
                    const int* __restrict__ dist, const int* __restrict__ active,
                    const int* __restrict__ repair, int* __restrict__ out,
                    int* __restrict__ changed, int* __restrict__ active_out, int nb, int tm,
                    int lanes) {
  using T = Tile<B>;
  constexpr int L = T::L, R = T::R, WORDS = T::WORDS, CH = T::CH;
  extern __shared__ __align__(16) unsigned smem[];
  unsigned* tile_s = smem;                    // [CH][B][B]
  unsigned* aw_s = smem + CH * B * B;         // [LIST][WORDS] listed slots' words
  int* list_t = (int*)(aw_s + LIST * WORDS);  // [LIST] slot
  int* list_c = list_t + LIST;                // [LIST] source block
  __shared__ int list_n;
  __shared__ unsigned moved_s[WORDS];

  const int words = (lanes + 31) >> 5;
  const int chunks = (words + WORDS - 1) / WORDS;
  const int rb = blockIdx.x / chunks;
  const int w0 = (blockIdx.x % chunks) * WORDS;  // the block's first lane word
  const int warp = threadIdx.x >> 5, l = threadIdx.x & 31;
  const int gi = warp / T::LWARPS;                  // row group
  const int wword = w0 + (warp % T::LWARPS) * L;   // the warp's first lane word
  const size_t slot0 = (size_t)rb * tm;

  unsigned acc[R][L];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int k = 0; k < L; ++k) acc[r][k] = 0xffffffffu;
  bool touched = false;  // some listed source is active in one of the warp's words
  if (T::G > 1 && threadIdx.x < WORDS) moved_s[threadIdx.x] = 0;

  for (int t0 = 0; t0 < tm; t0 += LIST) {
    __syncthreads();  // the pass before is done with list_n
    if (threadIdx.x == 0) list_n = 0;
    __syncthreads();
    const int t1 = min(tm, t0 + LIST);
    for (int t = t0 + (int)threadIdx.x; t < t1; t += T::THREADS) {
      const int c = cb[slot0 + t];
      if (c >= nb) continue;
      unsigned w[WORDS], any = 0;
#pragma unroll
      for (int x = 0; x < WORDS; ++x) {
        const int gw = w0 + x;
        w[x] = gw < words ? (unsigned)active[(size_t)c * words + gw] & lane_bits(gw, lanes) : 0u;
        any |= w[x];
      }
      if (any == 0) continue;
      const int pos = atomicAdd(&list_n, 1);
      list_t[pos] = t;
      list_c[pos] = c;
#pragma unroll
      for (int x = 0; x < WORDS; ++x) aw_s[pos * WORDS + x] = w[x];
    }
    __syncthreads();
    const int cnt = list_n;
    for (int base = 0; base < cnt; base += CH) {
      const int m = min(CH, cnt - base);
      constexpr int V = B * B / 4;  // int4 vectors a tile
      for (int idx = threadIdx.x; idx < m * V; idx += T::THREADS) {
        const int q = idx / V, rem = idx % V;
        const int4 v = reinterpret_cast<const int4*>(tiles + (slot0 + list_t[base + q]) * B * B)[rem];
        reinterpret_cast<int4*>(tile_s + q * B * B)[rem] = v;
      }
      __syncthreads();
      for (int q = 0; q < m; ++q) {
        unsigned aw[L], any = 0;
#pragma unroll
        for (int k = 0; k < L; ++k) {
          aw[k] = aw_s[(base + q) * WORDS + (wword - w0) + k];
          any |= aw[k];
        }
        if (any == 0) continue;  // warp-uniform: no lane of the warp has this source
        touched = true;
        const int* src = dist + (size_t)list_c[base + q] * B * lanes + wword * 32 + l;
        const unsigned* ts = tile_s + q * B * B + gi * R * B;
#pragma unroll 1
        for (int jc = 0; jc < B; jc += 8) {
          unsigned d[8][L];
#pragma unroll
          for (int jj = 0; jj < 8; ++jj)
#pragma unroll
            for (int k = 0; k < L; ++k)
              d[jj][k] = ((aw[k] >> l) & 1) ? (unsigned)__ldg(src + (size_t)(jc + jj) * lanes + k * 32)
                                            : INF;
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const uint4 a = *reinterpret_cast<const uint4*>(ts + r * B + jc);
            const uint4 b = *reinterpret_cast<const uint4*>(ts + r * B + jc + 4);
#pragma unroll
            for (int k = 0; k < L; ++k) {
              unsigned x = acc[r][k];
              x = relax_step(a.x, d[0][k], x);
              x = relax_step(a.y, d[1][k], x);
              x = relax_step(a.z, d[2][k], x);
              x = relax_step(a.w, d[3][k], x);
              x = relax_step(b.x, d[4][k], x);
              x = relax_step(b.y, d[5][k], x);
              x = relax_step(b.z, d[6][k], x);
              x = relax_step(b.w, d[7][k], x);
              acc[r][k] = x;
            }
          }
        }
      }
      __syncthreads();
    }
  }

  // new = min(old, agg) for the thread's (row, lane)s but the repair ones;
  // out written where the input frontier bit is set or the value changed.
  bool any_moved = false;
#pragma unroll
  for (int k = 0; k < L; ++k) {
    const int word = wword + k;
    if (word >= words) break;
    const unsigned fw = (unsigned)active[(size_t)rb * words + word] & lane_bits(word, lanes);
    unsigned bal = 0;
    if (touched || fw != 0) {
      const int lane = word * 32 + l;
      bool mv = false;
      if (lane < lanes) {
        const bool front = (fw >> l) & 1;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int p = rb * B + gi * R + r;
          const size_t at = (size_t)p * lanes + lane;
          if (!touched) {  // nothing relaxed: copy the frontier lanes
            if (front) out[at] = dist[at];
            continue;
          }
          if (repair != nullptr && ((repair[(size_t)p * words + word] >> l) & 1)) continue;
          const int old = dist[at];
          const int nw = min(old, (int)min(acc[r][k], INF));
          if (nw != old) mv = true;
          if (front || nw != old) out[at] = nw;
        }
      }
      bal = __ballot_sync(0xffffffffu, mv);
    }
    any_moved |= bal != 0;
    if (T::G == 1) {
      if (l == 0) active_out[(size_t)rb * words + word] = (int)bal;
    } else if (l == 0 && bal != 0) {
      atomicOr(&moved_s[word - w0], bal);
    }
  }
  if (T::G == 1) {
    if (l == 0 && any_moved) changed[0] = 1;
    return;
  }
  __syncthreads();
  if (threadIdx.x < WORDS && w0 + (int)threadIdx.x < words) {
    const unsigned mw = moved_s[threadIdx.x];
    active_out[(size_t)rb * words + w0 + threadIdx.x] = (int)mw;
    if (mw != 0) changed[0] = 1;
  }
}

template <int B>
__global__ void __launch_bounds__(ROW_THREADS)
    trop_relax_rows(const int* __restrict__ tiles, const int* __restrict__ cb,
                    const int* __restrict__ dist, const int* __restrict__ active,
                    const int* __restrict__ repair, int* __restrict__ out,
                    int* __restrict__ changed, int* __restrict__ active_out, int nb, int tm,
                    int lanes) {
  __shared__ unsigned moved_word;
  const int rb = blockIdx.x;
  const int warp = threadIdx.x >> 5, l = threadIdx.x & 31;
  const size_t slot0 = (size_t)rb * tm;
  if (threadIdx.x == 0) moved_word = 0;
  __syncthreads();
  unsigned moved = 0;  // lane bits of this warp's rows that changed
  for (int i = warp; i < B; i += ROW_WARPS) {
    unsigned acc[SMALL];
#pragma unroll
    for (int s = 0; s < SMALL; ++s) acc[s] = 0xffffffffu;
    for (int idx = l; idx < tm * B; idx += 32) {
      const int t = idx / B, j = idx % B;
      const int c = cb[slot0 + t];
      if (c >= nb) continue;
      const unsigned aw = (unsigned)active[c];
      if (aw == 0) continue;
      const unsigned w = (unsigned)tiles[((slot0 + t) * B + i) * B + j];
      const int* row = dist + ((size_t)c * B + j) * lanes;
#pragma unroll
      for (int s = 0; s < SMALL; ++s)
        if (s < lanes && ((aw >> s) & 1)) acc[s] = min(acc[s], w + (unsigned)row[s]);
    }
    const int p = rb * B + i;
    int agg_l = (int)INF;
#pragma unroll
    for (int s = 0; s < SMALL; ++s) {
      if (s < lanes) {
        const unsigned best = __reduce_min_sync(0xffffffffu, acc[s]);
        if (l == s) agg_l = (int)min(best, INF);
      }
    }
    bool ch = false;
    if (l < lanes && !(repair != nullptr && ((repair[p] >> l) & 1))) {
      const size_t at = (size_t)p * lanes + l;
      const int old = dist[at];
      const int nw = min(old, agg_l);
      out[at] = nw;
      ch = nw != old;
    }
    moved |= __ballot_sync(0xffffffffu, ch);
  }
  if (l == 0 && moved != 0) atomicOr(&moved_word, moved);
  __syncthreads();
  if (threadIdx.x == 0) {
    active_out[rb] = (int)moved_word;
    if (moved_word != 0) changed[0] = 1;
  }
}

// The exact masked ELL relax of each listed repair (row, lane):
// tropical.py:449-457, int32 adds as JAX's.
__global__ void __launch_bounds__(REPAIR_THREADS)
    trop_repair(const int* __restrict__ pairs, int npairs, const int* __restrict__ dist,
                const int* __restrict__ src, const int* __restrict__ cost,
                const int* __restrict__ slot, const int* __restrict__ mask,
                const int* __restrict__ perm, const int* __restrict__ inv, int* __restrict__ out,
                int* __restrict__ changed, int* __restrict__ active_out, int b, int lanes, int k) {
  const int pair = (int)((blockIdx.x * (size_t)REPAIR_THREADS + threadIdx.x) >> 5);
  const int l = threadIdx.x & 31;
  if (pair >= npairs) return;  // warp-uniform
  const int p = pairs[2 * pair], s = pairs[2 * pair + 1];
  const int words = (lanes + 31) >> 5;
  const size_t v = (size_t)perm[p] * k;
  int best = (int)INF;
  for (int j = l; j < k; j += 32) {
    const int e = slot[v + j], u = src[v + j], w = cost[v + j];
    bool ok = e >= 0;
    if (ok && mask != nullptr) ok = (mask[(size_t)e * words + (s >> 5)] >> (s & 31)) & 1;
    if (ok) {
      const int d = dist[(size_t)inv[u] * lanes + s];
      if (d < (int)INF) best = min(best, d + w);
    }
  }
  best = __reduce_min_sync(0xffffffffu, best);
  if (l == 0) {
    const size_t at = (size_t)p * lanes + s;
    const int old = dist[at];
    const int nw = min(old, best);
    out[at] = nw;
    if (nw != old) {
      atomicOr(&active_out[(size_t)(p / b) * words + (s >> 5)], (int)(1u << (s & 31)));
      changed[0] = 1;
    }
  }
}

template <int B>
int launch(const int* tiles, const int* cb, const int* dist, const int* active,
           const int* repair, int* out, int* changed, int* active_out, int nb, int tm, int lanes,
           cudaStream_t st) {
  if (lanes <= SMALL) {
    trop_relax_rows<B><<<nb, ROW_THREADS, 0, st>>>(tiles, cb, dist, active, repair, out, changed,
                                                   active_out, nb, tm, lanes);
    return (int)cudaGetLastError();
  }
  using T = Tile<B>;
  const int rc = (int)cudaFuncSetAttribute(trop_relax_tile<B>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (rc != 0) return rc;
  const int words = (lanes + 31) / 32;
  const long long blocks = (long long)nb * ((words + T::WORDS - 1) / T::WORDS);
  trop_relax_tile<B><<<(unsigned)blocks, T::THREADS, T::SMEM, st>>>(
      tiles, cb, dist, active, repair, out, changed, active_out, nb, tm, lanes);
  return (int)cudaGetLastError();
}

// The launch geometry of the tile pass on (b, lanes, nb): info[0] form (1
// tile, 0 row), [1] blocks, [2] threads a block, [3] dynamic shared bytes,
// [4] registers a thread, [5] blocks an SM, [6] lanes a thread, [7] rows a
// thread, [8] lanes a block, [9] the repair pass's registers a thread.
template <int B>
int geometry(int lanes, int nb, int* info) {
  cudaFuncAttributes fa;
  int rc;
  int per_sm = 0;
  if (lanes <= SMALL) {
    rc = (int)cudaFuncGetAttributes(&fa, trop_relax_rows<B>);
    if (rc == 0)
      rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, trop_relax_rows<B>,
                                                               ROW_THREADS, 0);
    const int row[9] = {0, nb, ROW_THREADS, 0, fa.numRegs, per_sm, SMALL,
                        (B + ROW_WARPS - 1) / ROW_WARPS, SMALL};
    for (int i = 0; i < 9; ++i) info[i] = row[i];
  } else {
    using T = Tile<B>;
    rc = (int)cudaFuncSetAttribute(trop_relax_tile<B>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (rc == 0) rc = (int)cudaFuncGetAttributes(&fa, trop_relax_tile<B>);
    if (rc == 0)
      rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, trop_relax_tile<B>,
                                                               T::THREADS, T::SMEM);
    const int words = (lanes + 31) / 32;
    const int tile[9] = {1, nb * ((words + T::WORDS - 1) / T::WORDS), T::THREADS, T::SMEM,
                         fa.numRegs, per_sm, T::L, T::R, T::LANES};
    for (int i = 0; i < 9; ++i) info[i] = tile[i];
  }
  if (rc != 0) return rc;
  rc = (int)cudaFuncGetAttributes(&fa, trop_repair);
  info[9] = fa.numRegs;
  return rc;
}

// ---------------------------------------------------------------------------
// trop_count_round (T2) <- holo_tpu/ops/tropical.py:559-572 and :608-623, the
// loop bodies of _np_tile_fixpoint and _aw_tile_fixpoint (int32 einsums in
// XLA; the JAX package has no Pallas kernel there): one Jacobi round of the
// DAG-linear multipath fixpoints over integer count tiles, in the tiles'
// permuted space padded to NB*B rows.
//
// Planes (int32): cnt [NB, Tm, B, B] (cnt[rb, t, i, j] = how many flagged
// ELL slots join source cb[rb, t]*B + j to row rb*B + i; 0 on a padding
// slot); cb [NB, Tm] (NB for a padding slot); x [NB*B, A] (the carry, 0 on
// padding rows); seed [NB*B, A] or NULL (0 everywhere); out [NB*B, A] another
// buffer, written whole; root: the permuted row whose value is 1 (the path
// counts' root), or -1 for none.
//   tot[p, a] = sum over slots t with cb[rb, t] < NB and over j of
//               cnt[rb, t, i, j] * x[cb*B + j, a];
//   new = p == root ? 1 : min(seed + tot, MP_SAT) into out; changed is set
//   if any new != x.
// Every x is at most MP_SAT = 2^17 and a row's counts add up to at most its
// K slots, so every partial sum is at most K * 2^17 < 2^31 (K <= 16384,
// holo_tpu/ops/graph.py:32-36): int32 multiply-adds are exact and give
// JAX's bits.  No floating point, no tensor core.
//
// What bounds it: at the k=90 fat tree (B = 8, NB 1,266, Tm 67) the count
// tiles are 21.7 MB, read once a round (6.5 us at the HBM rate), against two
// operations (multiply, add) a (nonzero count, lane): bytes.  The design is
// the simple one.  Row form (up to SMALL lanes; the path counts' one lane):
// a block a row block, a warp a row, its threads splitting the row's (slot,
// j) entries, then __reduce_add_sync; thread s finishes lane s.  Lane form
// (more lanes; the 32 W weight lanes): a block a row block x 32 lanes, a warp
// a row, a thread a lane walking the row's entries (the count a broadcast
// read, the source value a coalesced one).  Padding slots and zero counts
// are skipped (exact: they add 0).
// ---------------------------------------------------------------------------

constexpr int MP_SAT = 1 << 17;
constexpr int COUNT_THREADS = 256;
constexpr int COUNT_WARPS = COUNT_THREADS / 32;

__device__ __forceinline__ void count_finish(int p, int s, int tot, const int* x,
                                             const int* seed, int* out, int* changed,
                                             int lanes, int root) {
  const size_t at = (size_t)p * lanes + s;
  const int nw = p == root ? 1 : min((seed != nullptr ? seed[at] : 0) + tot, MP_SAT);
  out[at] = nw;
  if (nw != x[at]) changed[0] = 1;
}

__global__ void __launch_bounds__(COUNT_THREADS)
    trop_count_rows(const int* __restrict__ cnt, const int* __restrict__ cb,
                    const int* __restrict__ x, const int* __restrict__ seed,
                    int* __restrict__ out, int* __restrict__ changed, int nb, int tm, int b,
                    int lanes, int root) {
  const int rb = blockIdx.x;
  const int warp = threadIdx.x >> 5, l = threadIdx.x & 31;
  const size_t slot0 = (size_t)rb * tm;
  for (int i = warp; i < b; i += COUNT_WARPS) {
    int acc[SMALL];
#pragma unroll
    for (int s = 0; s < SMALL; ++s) acc[s] = 0;
    for (int idx = l; idx < tm * b; idx += 32) {
      const int t = idx / b, j = idx - t * b;
      const int c = cb[slot0 + t];
      if (c >= nb) continue;
      const int w = cnt[((slot0 + t) * b + i) * b + j];
      if (w == 0) continue;
      const int* row = x + ((size_t)c * b + j) * lanes;
#pragma unroll
      for (int s = 0; s < SMALL; ++s)
        if (s < lanes) acc[s] += w * row[s];
    }
    const int p = rb * b + i;
#pragma unroll
    for (int s = 0; s < SMALL; ++s) {
      if (s < lanes) {
        const int tot = __reduce_add_sync(0xffffffffu, acc[s]);
        if (l == s) count_finish(p, s, tot, x, seed, out, changed, lanes, root);
      }
    }
  }
}

__global__ void __launch_bounds__(COUNT_THREADS)
    trop_count_lanes(const int* __restrict__ cnt, const int* __restrict__ cb,
                     const int* __restrict__ x, const int* __restrict__ seed,
                     int* __restrict__ out, int* __restrict__ changed, int nb, int tm, int b,
                     int lanes, int root, int chunks) {
  const int rb = blockIdx.x / chunks;
  const int warp = threadIdx.x >> 5, l = threadIdx.x & 31;
  const int s = (blockIdx.x % chunks) * 32 + l;
  if (s >= lanes) return;  // no warp-collective below
  const size_t slot0 = (size_t)rb * tm;
  for (int i = warp; i < b; i += COUNT_WARPS) {
    int acc = 0;
    for (int t = 0; t < tm; ++t) {
      const int c = cb[slot0 + t];
      if (c >= nb) continue;
      const int* w = cnt + ((slot0 + t) * b + i) * b;
      const int* col = x + (size_t)c * b * lanes + s;
      for (int j = 0; j < b; ++j) {
        const int wj = w[j];
        if (wj != 0) acc += wj * col[(size_t)j * lanes];
      }
    }
    count_finish(rb * b + i, s, acc, x, seed, out, changed, lanes, root);
  }
}

}  // namespace

extern "C" {

int holo_trop_relax(const void* tiles, const void* cb, const void* dist, const void* active,
                    const void* repair, void* out, void* changed, void* active_out, int nb, int tm,
                    int b, int lanes, void* stream) {
  if (nb <= 0 || tm <= 0 || lanes <= 0) return 0;
  const int *t = (const int*)tiles, *c = (const int*)cb, *d = (const int*)dist;
  const int *a = (const int*)active, *rp = (const int*)repair;
  int *o = (int*)out, *ch = (int*)changed, *ao = (int*)active_out;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (b) {
    case 8:
      return launch<8>(t, c, d, a, rp, o, ch, ao, nb, tm, lanes, st);
    case 16:
      return launch<16>(t, c, d, a, rp, o, ch, ao, nb, tm, lanes, st);
    case 32:
      return launch<32>(t, c, d, a, rp, o, ch, ao, nb, tm, lanes, st);
    case 64:
      return launch<64>(t, c, d, a, rp, o, ch, ao, nb, tm, lanes, st);
    case 128:
      return launch<128>(t, c, d, a, rp, o, ch, ao, nb, tm, lanes, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

int holo_trop_repair(const void* pairs, int npairs, const void* dist, const void* src,
                     const void* cost, const void* slot, const void* mask, const void* perm,
                     const void* inv, void* out, void* changed, void* active_out, int b,
                     int lanes, int k, void* stream) {
  if (npairs <= 0) return 0;
  const int warps = REPAIR_THREADS / 32;
  const unsigned blocks = (unsigned)((npairs + warps - 1) / warps);
  trop_repair<<<blocks, REPAIR_THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)pairs, npairs, (const int*)dist, (const int*)src, (const int*)cost,
      (const int*)slot, (const int*)mask, (const int*)perm, (const int*)inv, (int*)out,
      (int*)changed, (int*)active_out, b, lanes, k);
  return (int)cudaGetLastError();
}

int holo_trop_count(const void* cnt, const void* cb, const void* x, const void* seed, void* out,
                    void* changed, int nb, int tm, int b, int lanes, int root, void* stream) {
  if (nb <= 0 || tm <= 0 || lanes <= 0) return 0;
  const int *n = (const int*)cnt, *c = (const int*)cb, *xi = (const int*)x;
  const int* sd = (const int*)seed;
  int *o = (int*)out, *ch = (int*)changed;
  const cudaStream_t st = (cudaStream_t)stream;
  if (lanes <= SMALL) {
    trop_count_rows<<<nb, COUNT_THREADS, 0, st>>>(n, c, xi, sd, o, ch, nb, tm, b, lanes, root);
  } else {
    const int chunks = (lanes + 31) / 32;
    trop_count_lanes<<<(unsigned)((long long)nb * chunks), COUNT_THREADS, 0, st>>>(
        n, c, xi, sd, o, ch, nb, tm, b, lanes, root, chunks);
  }
  return (int)cudaGetLastError();
}

int holo_trop_info(int b, int lanes, int nb, void* info) {
  int* i = (int*)info;
  switch (b) {
    case 8:
      return geometry<8>(lanes, nb, i);
    case 16:
      return geometry<16>(lanes, nb, i);
    case 32:
      return geometry<32>(lanes, nb, i);
    case 64:
      return geometry<64>(lanes, nb, i);
    case 128:
      return geometry<128>(lanes, nb, i);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
