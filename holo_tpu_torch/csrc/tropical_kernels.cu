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
// slot); cb [NB, Tm] (NB for a padding slot); the count list, built once a
// fixpoint (kernels/tropical.py count_list): list [NB, Tm] (first, in slot
// order, each row block's real slots whose tile holds a nonzero count; the
// rest of the row is never used) and len [NB] (how many); x [NB*B, A] (the
// carry, 0 on padding rows); seed [NB*B, A] or NULL (0 everywhere); out
// [NB*B, A] another buffer, written whole; root: the permuted row whose
// value is 1 (the path counts' root), or -1 for none.
//   tot[p, a] = sum over slots t with cb[rb, t] < NB and over j of
//               cnt[rb, t, i, j] * x[cb*B + j, a];
//   new = p == root ? 1 : min(seed + tot, MP_SAT) into out; changed is set
//   if any new != x.
// Every x is at most MP_SAT = 2^17 and a row's counts add up to at most its
// K slots, so every partial sum is at most K * 2^17 < 2^31 (K <= 16384,
// holo_tpu/ops/graph.py:32-36): int32 multiply-adds are exact in any order
// and give JAX's bits.  No floating point, no tensor core (x passes int8).
//
// What bounds it: bytes, and in practice latency and instructions.  At the
// k=90 fat tree (B = 8, NB 1,266, Tm 67) 20,811 of the 53,524 real tiles
// hold a nonzero count, and 81,293 of their 1.33 M entries are nonzero, in
// 52,088 (tile, column) pairs.  The floor is those entries with an index
// each, the listed slots' cb, and x, seed and out once (8.5 MB at 64 lanes,
// 0.8 MB at one); two operations (multiply, add) a (nonzero entry, lane)
// are nothing beside it.  So a round walks only the count list (a zero tile
// adds 0: exact) and, within a listed tile, only its nonzero columns'
// source rows; what is left is a few dependent loads a block and the
// instructions a (pair, lane).
//
// Lane form (more than SMALL lanes: the 32 W weight lanes; Count<B> below).
// A block owns one row block and LANES lanes; a thread R rows of row group
// warp / LWARPS and one lane, (warp % LWARPS) * 32 + l.  The thread's old
// values and seed are loaded first, beside the list's first chunk.  Per
// chunk of CH listed slots, a thread a (tile, column j) reads the column's
// B counts and its slot's cb, and a ballot a warp lists the nonzero columns
// as pairs (source row cb*B + j, the column's offset) in shared memory (a
// shared-memory atomic a warp: the order is free, integer sums are exact in
// any order).  PAIRS pairs at a time, their source rows x[cb*B + j, lanes]
// (16 bytes a copy where the lane count allows; only those rows, 2.5 of 8 a
// tile at k=90) and their columns (contiguous, rows in order) are staged
// together by cp.async, and each thread adds count x source into its R sums
// in registers: a pair costs it one source read and R / 4 16-byte count
// reads (broadcasts).  No tile is staged whole, so a block needs 13.6 KB at
// B = 8 and a chunk of 64 tiles holds every row block's list at k=90.  The
// instructions a pair and the dependent loads a block (list, columns,
// sources), not the bytes, set the lane form's time at k=90.  Then each
// thread writes its R outputs; the changed flag is one vote a block
// (__syncthreads_or) and one store.
//
// The lane form for B = 8 / 16 / 32 / 64 / 128: rows a thread R 4 / 8 / 8 /
// 16 / 16, threads 128 / 128 / 256 / 256 / 256, lanes a block 64 / 64 / 64 /
// 64 / 32, tiles a chunk CH 64 / 32 / 16 / 8 / 4, pairs a pass PAIRS 32,
// shared memory 13,568 / 14,464 / 16,448 / 20,512 / 24,592 bytes
// (registers and blocks an SM: holo_trop_count_info, which chip_smoke
// prints and PERF.md keeps).
//
// Row form (up to SMALL lanes: the path counts' one lane; CountRows<B, S>,
// S = 1 for one lane, else SMALL: the sums a thread keeps, so that one lane
// holds 8 and not 64 in registers).  A block owns one row block: a warp 8 of
// its rows, SPLIT warps a row group splitting its listed (tile, column j)
// entries (the next entry's slot loaded ahead).  A thread loads its 8 rows
// of the column and skips an all-zero one, else loads the source row's
// lanes into 8 rows x S lanes of sums; the warp meets in __reduce_add_sync
// (thread o % 32 keeps output o = row * S + lane), the SPLIT warps in
// shared memory, and the first warp of the group finishes the outputs,
// whose old values and seed it loaded before the walk.  The changed flag as
// in the lane form.
// ---------------------------------------------------------------------------

constexpr int MP_SAT = 1 << 17;

__device__ __forceinline__ unsigned sptr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 4 bytes global -> shared, in flight until cp_async_wait; `ok` false
// fills 0 and reads nothing.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok = true) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(sptr(dst)), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}

// 16 bytes global -> shared (both ends 16-byte aligned), through L2 only;
// `ok` false fills 0 and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(sptr(dst)), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}

// Every cp.async this thread issued has landed.
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// The lane form's geometry for tile size B.
template <int B>
struct Count {
  static constexpr int R = B == 8 ? 4 : (B <= 32 ? 8 : 16);  // rows a thread
  static constexpr int G = B / R;                             // row groups
  static constexpr int LWARPS = B == 128 ? 1 : 2;             // warps a row group
  static constexpr int THREADS = 32 * G * LWARPS;
  static constexpr int LANES = 32 * LWARPS;                   // lanes a block
  static constexpr int CH = 512 / B;  // listed tiles a chunk
  static constexpr int CAP = CH * B;  // (tile, column) pairs a chunk at most
  static constexpr int PAIRS = 32;    // pairs staged a pass
  // Shared memory: a pass's columns (B counts each, contiguous) and source
  // rows, the chunk's pairs (source row, column offset) and list entries.
  static constexpr int SMEM = (PAIRS * B + PAIRS * LANES + 2 * CAP + CH) * (int)sizeof(int);
  static_assert(THREADS <= 256 && B % R == 0 && R % 4 == 0 && LANES % 4 == 0 &&
                    SMEM <= 48 * 1024, "count geometry");
};

template <int B>
__global__ void __launch_bounds__(Count<B>::THREADS)
    trop_count_lanes(const int* __restrict__ cnt, const int* __restrict__ cb,
                     const int* __restrict__ list, const int* __restrict__ len,
                     const int* __restrict__ x, const int* __restrict__ seed,
                     int* __restrict__ out, int* __restrict__ changed, int tm, int lanes,
                     int root) {
  using C = Count<B>;
  constexpr int R = C::R, CH = C::CH, LANES = C::LANES, PAIRS = C::PAIRS, T = C::THREADS;
  extern __shared__ __align__(16) int csm[];
  int* col_s = csm;                      // [PAIRS][B]: a pass's columns, rows in order
  int* src_s = col_s + PAIRS * B;        // [PAIRS][LANES]: a pass's source rows
  int* row_s = src_s + PAIRS * LANES;    // [CAP]: pair k's source row cb * B + j
  int* off_s = row_s + C::CAP;           // [CAP]: pair k's column, slot * B * B + j
  int* list_s = off_s + C::CAP;          // [CH]
  __shared__ int npairs;

  const int chunks = (lanes + LANES - 1) / LANES;
  const int rb = blockIdx.x / chunks;
  const int lane0 = (blockIdx.x % chunks) * LANES;
  const int tid = threadIdx.x, warp = tid >> 5, l = tid & 31;
  const int ln = (warp % C::LWARPS) * 32 + l;  // the thread's lane within the block's
  const int s = lane0 + ln;
  const int i0 = (warp / C::LWARPS) * R;       // its first row within the row block
  const int row0 = rb * B + i0;
  const size_t slot0 = (size_t)rb * tm;
  const int* tiles = cnt + slot0 * B * B;      // the row block's tiles
  const bool live = s < lanes;
  // Source rows as 16-byte copies where every row segment is aligned.
  const bool vec = lanes % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;

  for (int i = tid; i < CH; i += T) cp_async4(list_s + i, list + slot0 + min(i, tm - 1));
  int old[R], sd[R], acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const size_t at = (size_t)(row0 + r) * lanes + s;
    old[r] = live ? x[at] : 0;
    sd[r] = live && seed != nullptr ? seed[at] : 0;
    acc[r] = 0;
  }
  const int n = len[rb];
  for (int t0 = 0; t0 < n; t0 += CH) {
    const int m = min(CH, n - t0);
    cp_async_wait();
    if (tid == 0) npairs = 0;
    __syncthreads();  // list_s holds this chunk; the chunk before is done
    // A thread a (tile, column j) reads the column's B counts; a nonzero
    // column is listed (a ballot a warp) with its source row and offset.
    for (int base = 0; base < m * B; base += T) {
      const int idx = base + tid;
      bool nz = false;
      int slot = 0, c = 0;
      if (idx < m * B) {
        slot = list_s[idx / B];
        c = cb[slot0 + slot];
        const int* col = tiles + (size_t)slot * B * B + idx % B;
#pragma unroll
        for (int i = 0; i < B; ++i) nz |= __ldg(col + i * B) != 0;
      }
      const unsigned bal = __ballot_sync(0xffffffffu, nz);
      int at = 0;
      if (l == 0 && bal != 0) at = atomicAdd(&npairs, __popc(bal));
      at = __shfl_sync(0xffffffffu, at, 0) + __popc(bal & ((1u << l) - 1u));
      if (nz) {
        row_s[at] = c * B + idx % B;
        off_s[at] = slot * B * B + idx % B;
      }
    }
    __syncthreads();
    if (t0 + CH < n)  // the next chunk's list, in flight while this one is walked
      for (int i = tid; i < CH; i += T)
        cp_async4(list_s + i, list + slot0 + min(t0 + CH + i, tm - 1));
    const int np = npairs;
    for (int p0 = 0; p0 < np; p0 += PAIRS) {
      const int pm = min(PAIRS, np - p0);
      if (vec) {
        for (int idx = tid; idx < pm * (LANES / 4); idx += T) {
          const int sl = lane0 + 4 * (idx % (LANES / 4));
          const bool ok = sl < lanes;
          cp_async16(src_s + 4 * idx,
                     ok ? x + (size_t)row_s[p0 + idx / (LANES / 4)] * lanes + sl : x, ok);
        }
      } else {
        for (int idx = tid; idx < pm * LANES; idx += T) {
          const int sl = lane0 + idx % LANES;
          const bool ok = sl < lanes;
          cp_async4(src_s + idx, ok ? x + (size_t)row_s[p0 + idx / LANES] * lanes + sl : x, ok);
        }
      }
      for (int idx = tid; idx < pm * B; idx += T)
        cp_async4(col_s + idx, tiles + off_s[p0 + idx / B] + (idx % B) * B);
      cp_async_wait();
      __syncthreads();
      const int* w = col_s + i0;
      for (int p = 0; p < pm; ++p, w += B) {
        const int v = src_s[p * LANES + ln];
#pragma unroll
        for (int r = 0; r < R; r += 4) {
          const int4 c = *reinterpret_cast<const int4*>(w + r);
          acc[r] += c.x * v;
          acc[r + 1] += c.y * v;
          acc[r + 2] += c.z * v;
          acc[r + 3] += c.w * v;
        }
      }
      __syncthreads();  // col_s and src_s are free for the next pass
    }
  }
  cp_async_wait();  // a list prefetch past the last chunk
  bool moved = false;
  if (live) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int p = row0 + r;
      const int nw = p == root ? 1 : min(sd[r] + acc[r], MP_SAT);
      out[(size_t)p * lanes + s] = nw;
      moved |= nw != old[r];
    }
  }
  if (__syncthreads_or(moved) && tid == 0) changed[0] = 1;
}

// The row form's geometry for tile size B and S lanes of sums: a warp 8
// rows, SPLIT warps splitting a row group's listed (tile, column) entries.
template <int B, int S>
struct CountRows {
  static constexpr int G = B / 8;                   // row groups
  static constexpr int SPLIT = G >= 4 ? 1 : 4 / G;  // warps a row group
  static constexpr int THREADS = 32 * G * SPLIT;
  static constexpr int OUT = 8 * S;                 // (row, lane) outputs of a row group
  static constexpr int KEPT = (OUT + 31) / 32;      // outputs a thread keeps
};

template <int B, int S>
__global__ void __launch_bounds__(CountRows<B, S>::THREADS)
    trop_count_rows(const int* __restrict__ cnt, const int* __restrict__ cb,
                    const int* __restrict__ list, const int* __restrict__ len,
                    const int* __restrict__ x, const int* __restrict__ seed,
                    int* __restrict__ out, int* __restrict__ changed, int tm, int lanes,
                    int root) {
  using C = CountRows<B, S>;
  constexpr int STEP = 32 * C::SPLIT, KEPT = C::KEPT;
  __shared__ int red[C::SPLIT > 1 ? C::THREADS / 32 : 1][KEPT * 32];
  const int rb = blockIdx.x, warp = threadIdx.x >> 5, l = threadIdx.x & 31;
  const int g = warp / C::SPLIT, part = warp % C::SPLIT;
  const int i0 = g * 8;
  const size_t slot0 = (size_t)rb * tm;

  // The outputs this thread finishes (group's first warp): old values, seed.
  int old[KEPT], sd[KEPT];
#pragma unroll
  for (int k = 0; k < KEPT; ++k) {
    const int o = k * 32 + l, sl = o % S;
    const size_t at = (size_t)(rb * B + i0 + o / S) * lanes + sl;
    const bool mine = part == 0 && o < C::OUT && sl < lanes;
    old[k] = mine ? x[at] : 0;
    sd[k] = mine && seed != nullptr ? seed[at] : 0;
  }
  int acc[8][S] = {};
  int idx = part * 32 + l;
  int t = list[slot0 + min(idx / B, tm - 1)];  // loaded beside len, ahead of the walk
  const int n = len[rb];
  for (; idx < n * B; idx += STEP) {
    const int tn = list[slot0 + min((idx + STEP) / B, tm - 1)];  // the next entry's slot
    const int j = idx % B;
    const int c = cb[slot0 + t];
    const int* col = cnt + ((slot0 + t) * B + i0) * B + j;
    int w[8];
    bool any = false;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      w[r] = col[r * B];
      any |= w[r] != 0;
    }
    if (any) {
      const int* src = x + ((size_t)c * B + j) * lanes;
#pragma unroll
      for (int sl = 0; sl < S; ++sl) {
        if (sl < lanes) {
          const int v = src[sl];
#pragma unroll
          for (int r = 0; r < 8; ++r) acc[r][sl] += w[r] * v;
        }
      }
    }
    t = tn;
  }
  int kept[KEPT];
#pragma unroll
  for (int k = 0; k < KEPT; ++k) kept[k] = 0;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
#pragma unroll
    for (int sl = 0; sl < S; ++sl) {
      if (sl < lanes) {
        const int tot = __reduce_add_sync(0xffffffffu, acc[r][sl]);
        if (((r * S + sl) & 31) == l) kept[(r * S + sl) >> 5] = tot;
      }
    }
  }
  if (C::SPLIT > 1) {
#pragma unroll
    for (int k = 0; k < KEPT; ++k) red[warp][k * 32 + l] = kept[k];
    __syncthreads();
    if (part == 0) {
#pragma unroll
      for (int k = 0; k < KEPT; ++k) {
        int sum = 0;
        for (int q = 0; q < C::SPLIT; ++q) sum += red[g * C::SPLIT + q][k * 32 + l];
        kept[k] = sum;
      }
    }
  }
  bool moved = false;
  if (part == 0) {
#pragma unroll
    for (int k = 0; k < KEPT; ++k) {
      const int o = k * 32 + l, sl = o % S;
      if (o < C::OUT && sl < lanes) {
        const int p = rb * B + i0 + o / S;
        const int nw = p == root ? 1 : min(sd[k] + kept[k], MP_SAT);
        out[(size_t)p * lanes + sl] = nw;
        moved |= nw != old[k];
      }
    }
  }
  if (__syncthreads_or(moved) && threadIdx.x == 0) changed[0] = 1;
}

template <int B>
int count_launch(const int* cnt, const int* cb, const int* list, const int* len, const int* x,
                 const int* seed, int* out, int* changed, int nb, int tm, int lanes, int root,
                 cudaStream_t st) {
  if (lanes == 1) {
    trop_count_rows<B, 1><<<nb, CountRows<B, 1>::THREADS, 0, st>>>(
        cnt, cb, list, len, x, seed, out, changed, tm, lanes, root);
    return (int)cudaGetLastError();
  }
  if (lanes <= SMALL) {
    trop_count_rows<B, SMALL><<<nb, CountRows<B, SMALL>::THREADS, 0, st>>>(
        cnt, cb, list, len, x, seed, out, changed, tm, lanes, root);
    return (int)cudaGetLastError();
  }
  using C = Count<B>;
  const long long blocks = (long long)nb * ((lanes + C::LANES - 1) / C::LANES);
  trop_count_lanes<B><<<(unsigned)blocks, C::THREADS, C::SMEM, st>>>(
      cnt, cb, list, len, x, seed, out, changed, tm, lanes, root);
  return (int)cudaGetLastError();
}

// T2's launch geometry on (b, lanes, nb): info[0] form (1 lane, 0 row), [1]
// blocks, [2] threads a block, [3] shared bytes a block (static and
// dynamic), [4] registers a thread, [5] blocks an SM, [6] lanes a block, [7]
// rows a thread, [8] tiles a chunk, [9] source rows a pass (the last two 0
// in the row form).
template <int B>
int count_geometry(int lanes, int nb, int* info) {
  cudaFuncAttributes fa;
  int per_sm = 0, rc;
  if (lanes <= SMALL) {
    const int threads = CountRows<B, SMALL>::THREADS;  // as CountRows<B, 1>'s
    const auto kernel = lanes == 1 ? trop_count_rows<B, 1> : trop_count_rows<B, SMALL>;
    rc = (int)cudaFuncGetAttributes(&fa, kernel);
    if (rc == 0) rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
    const int row[10] = {0, nb, threads, (int)fa.sharedSizeBytes, fa.numRegs, per_sm,
                         lanes == 1 ? 1 : SMALL, 8, 0, 0};
    for (int i = 0; i < 10; ++i) info[i] = row[i];
  } else {
    using C = Count<B>;
    rc = (int)cudaFuncGetAttributes(&fa, trop_count_lanes<B>);
    if (rc == 0)
      rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, trop_count_lanes<B>,
                                                               C::THREADS, C::SMEM);
    const int lane[10] = {1, nb * ((lanes + C::LANES - 1) / C::LANES), C::THREADS,
                          C::SMEM + (int)fa.sharedSizeBytes, fa.numRegs, per_sm, C::LANES, C::R,
                          C::CH, C::PAIRS};
    for (int i = 0; i < 10; ++i) info[i] = lane[i];
  }
  return rc;
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

int holo_trop_count(const void* cnt, const void* cb, const void* list, const void* len,
                    const void* x, const void* seed, void* out, void* changed, int nb, int tm,
                    int b, int lanes, int root, void* stream) {
  if (nb <= 0 || tm <= 0 || lanes <= 0) return 0;
  const int *n = (const int*)cnt, *c = (const int*)cb, *li = (const int*)list;
  const int *le = (const int*)len, *xi = (const int*)x, *sd = (const int*)seed;
  int *o = (int*)out, *ch = (int*)changed;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (b) {
    case 8:
      return count_launch<8>(n, c, li, le, xi, sd, o, ch, nb, tm, lanes, root, st);
    case 16:
      return count_launch<16>(n, c, li, le, xi, sd, o, ch, nb, tm, lanes, root, st);
    case 32:
      return count_launch<32>(n, c, li, le, xi, sd, o, ch, nb, tm, lanes, root, st);
    case 64:
      return count_launch<64>(n, c, li, le, xi, sd, o, ch, nb, tm, lanes, root, st);
    case 128:
      return count_launch<128>(n, c, li, le, xi, sd, o, ch, nb, tm, lanes, root, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

int holo_trop_count_info(int b, int lanes, int nb, void* info) {
  int* i = (int*)info;
  switch (b) {
    case 8:
      return count_geometry<8>(lanes, nb, i);
    case 16:
      return count_geometry<16>(lanes, nb, i);
    case 32:
      return count_geometry<32>(lanes, nb, i);
    case 64:
      return count_geometry<64>(lanes, nb, i);
    case 128:
      return count_geometry<128>(lanes, nb, i);
    default:
      return (int)cudaErrorInvalidValue;
  }
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
