// The BGP table's decision fold for Hopper (sm_90a), plain C interface for
// ctypes.
//
// bgp_fold <- holo_tpu/ops/bgp_table.py:294-415 (_fold_planes) through
// :423-426 (_decide_fn): the RFC 4271 §9.1.2.2 decision process over the
// packed Adj-RIB-In planes, for the queued rows.  In the JAX package it is a
// lax.fori_loop over the peer columns, one XLA loop fusion, not a Pallas
// kernel.  In eager PyTorch each of the 64 column steps of a full table would
// be ~40 launches over 524,288-row vectors, each rewriting the [M, C] reason
// plane (134 MB x 64 steps against 1.75 GB of inputs), so the fold is
// written by hand.
//
// Inputs (int32): planes (13, R, C), lanes as in ops/bgp_table.py (LP, L1,
// MED, FAS, RT, IGP, RID, HASRID, NH, PATH, OCC, LOOP, LOCAL); idx [M] rows of
// planes (clamped into [0, R)); order [C] the candidate order, a permutation
// of the columns (peers by address, unassigned columns, the local column 0
// last); addr_rank, has_addr [C]; nht_enc, nht_res [K]; mp [3] =
// (allow_multiple_as, ibgp_max, ebgp_max).  Outputs: best [M] int32 (-1: no
// eligible column), reasons [M, C] int32, elig and sel [M, C] bytes (0 / 1).
// Lanes hold biased u32 values (u - 2^31 as int32): every compare is a
// signed int compare, as JAX's.
//
// The fold is not an argmin.  The MED rung fires only between routes of the
// same first AS, so the comparator is not transitive (three routes can form
// a preference cycle) and only the oracle's walk in candidate order gives its
// answer.  Each loss writes its reason once, to the loser's cell (the
// candidate, or the displaced winner).  A second walk in the same order
// tests the peer columns against the winner (rib.rs:463-487) and selects the
// first max_paths matches.
//
// What bounds it: bytes.  Each cell's 13 lanes are read once (1.745 GB at
// 524,288 x 64) and 0.203 GB of outputs written: 0.58 ms at 3.35 TB/s.  What
// held the walk back was latency: one thread's step through the ladder is a
// chain of ~50 dependent instructions, ~460 cycles with one fold warp a
// scheduler, and ~28 eligible steps a row at the full table.  The design:
//
// - A pipeline in one block an SM (two where they fit), every barrier taken
//   in order, one phase at a time.  Warp 12 produces: it copies the rows of
//   each tile (tr rows, through idx) raw into a ring of `stages`
//   shared-memory stages, each completing on an mbarrier ("full") and
//   refilled when released ("empty").  A row's C words of one lane are
//   contiguous, so where 4C is a multiple of 16 each run of consecutive
//   rows of a lane is one TMA bulk copy (cp.async.bulk ... complete_tx; a
//   row alone where idx is not consecutive); elsewhere the warp's lanes copy
//   words with cp.async and arrive when their copies land.
// - Warps 4-11 derive, a row of a tile each: position j of the row gets
//   column order[j]'s (LP, L1) as one int2 and MED, FAS, RT, the derived IGP
//   (the next-hop metric, or the local IGP lane), RID, HASRID and PATH (row
//   stride C | 1, odd, so the fold's lanes read distinct banks), and
//   eligibility as ballot words by position.  Then a warp scan of the
//   row's eligible (LP, L1) pairs in order: the winner's pair after any step
//   of the walk is the least pair so far (the two first rungs compare
//   lexicographically), so a position above the least pair before it loses
//   at LP or L1 and its reason is written at once; the rest (the first
//   eligible position, each new least pair, each tie on it) are the
//   "events" left for the walk.
// - Group j of a block (gr rows, gr / tr tiles) is derived into the buffer
//   of fold warp j % warps ("ready"), which walks only the events, one lane
//   a row, testing the rungs past (LP, L1) at once (the first that differs
//   found with __ffs); the multipath pass takes the events on the winner's
//   pair, which are all its ties.  The reasons stay in shared memory, by
//   position, and leave with the elig and sel bytes in coalesced runs (4
//   columns a lane), so each output cell is written once; then the buffer
//   is released ("freed").
//
// The wrapper (kernels/bgp.py geometry) picks gr, tr, the ring depth, the
// fold warps and the grid: the most rows folding in one block's shared
// memory (3 warps x 16 rows at C = 64, 4 x 32 at C = 32), the groups halved
// until every SM has one (the UPDATE shape, 4,096 x 64, is 256 groups).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

enum { L_LP, L_L1, L_MED, L_FAS, L_RT, L_IGP, L_RID, L_HASRID, L_NH, L_PATH, L_OCC,
       L_LOOP, L_LOCAL, N_LANES };
// A derived cell: (LP, L1) as one int2 -- the two rungs that decide most
// steps -- and 7 more words (the IGP word holds the derived IGP).
enum { X_MED, X_FAS, X_RT, X_IGP, X_RID, X_HASRID, X_PATH, N_REST };
constexpr int N_STAGED = 2 + N_REST;
constexpr int R_LP = 1, R_PLEN = 2, R_ORIGIN = 3, R_MED = 4, R_RT = 5, R_IGP = 6,
              R_RID = 7, R_ADDR = 8;
// Past (LP, L1) the fold finds the deciding rung k (MED, RT, IGP, RID,
// address) and writes reason R_MED + k.
static_assert(R_RT == R_MED + 1 && R_IGP == R_MED + 2 && R_RID == R_MED + 3 &&
                  R_ADDR == R_MED + 4,
              "reason codes follow the rungs");
constexpr int LOCAL_COL = 0;
constexpr int FOLD_WARPS = 4;    // the most fold warps a block: warps 0-3
constexpr int DERIVE_WARPS = 8;  // warps 4-11
constexpr int PRODUCER = FOLD_WARPS + DERIVE_WARPS;  // warp 12
constexpr int THREADS = 32 * (PRODUCER + 1);
constexpr int MAX_STAGES = 8;
constexpr int MAX_DEVICES = 64;

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

// Byte offsets of a block's shared memory at group rows `gr`, tile rows
// `tr`, `stages` ring stages and `warps` fold warps; kernels/bgp.py
// smem_bytes mirrors the total.
struct Layout {
  int stride, ws;  // derived row stride (odd), eligibility words a row (odd)
  size_t raw, cell, reason, ebits, sbits, vecs, total;
};

__host__ __device__ inline Layout layout(int n_cols, int gr, int tr, int stages, int warps) {
  Layout g;
  g.stride = n_cols | 1;
  g.ws = ((n_cols + 31) >> 5) | 1;
  // full[stages], empty[stages], ready[FOLD_WARPS], freed[FOLD_WARPS]
  size_t off = align16(16 * (size_t)(stages + FOLD_WARPS));
  g.raw = off;  // [stages][N_LANES][tr][C]
  off += align16(4 * (size_t)stages * N_LANES * tr * n_cols);
  g.cell = off;  // int2 [warps][gr][stride], then int [warps][N_REST][gr][stride]
  off += align16(4 * (size_t)warps * N_STAGED * gr * g.stride);
  g.reason = off;  // [warps][gr][C], by position
  off += align16(4 * (size_t)warps * gr * n_cols);
  g.ebits = off;  // [warps][gr][ws], by position
  off += align16(4 * (size_t)warps * gr * g.ws);
  g.sbits = off;  // [warps][gr][ws], by position
  off += align16(4 * (size_t)warps * gr * g.ws);
  g.vecs = off;  // order, inverse, addr_rank, has_addr
  off += align16(16 * (size_t)n_cols);
  g.total = off;
  return g;
}

__device__ __forceinline__ uint32_t sptr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(sptr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  uint64_t state;
  asm volatile("mbarrier.arrive.shared::cta.b64 %0, [%1];"
               : "=l"(state)
               : "r"(sptr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  uint64_t state;
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 %0, [%1], %2;"
               : "=l"(state)
               : "r"(sptr(bar)), "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(sptr(bar)), "r"(parity)
        : "memory");
  }
}

// One TMA bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from global to shared memory, completing on `bar`'s transaction count.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(sptr(dst)), "l"(src), "r"(bytes), "r"(sptr(bar))
      : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(sptr(dst)), "l"(src)
               : "memory");
}

// Arrive on `bar` once every cp.async this thread issued has landed.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(sptr(bar))
               : "memory");
}

// The winner's words, kept in registers by the fold.
struct Best {
  int lp, l1, med, fas, rt, igp, rid, hasrid, path, addr, has;
};

// The words of position p past (LP, L1).
__device__ __forceinline__ void load_rest(Best& c, const int* rest, int pl, const int* s_addr,
                                          const int* s_has, int p) {
  c.med = rest[X_MED * pl + p];
  c.fas = rest[X_FAS * pl + p];
  c.rt = rest[X_RT * pl + p];
  c.igp = rest[X_IGP * pl + p];
  c.rid = rest[X_RID * pl + p];
  c.hasrid = rest[X_HASRID * pl + p];
  c.path = rest[X_PATH * pl + p];
  c.addr = s_addr[p];
  c.has = s_has[p];
}

__device__ __forceinline__ unsigned pos_bit(const unsigned* words, int p) {
  return (words[p >> 5] >> (p & 31)) & 1u;
}

// Derive one raw cell `v` (its 13 lanes) into the fold buffer at (row t,
// position p); returns its eligibility.
__device__ __forceinline__ bool derive(const int* v, int res, int enc, int t, int p, int n_cols,
                                       int stride, int pl, int2* key, int* rest) {
  const bool in = p < n_cols;
  const bool local = v[L_LOCAL] != 0;
  if (in) {
    key[t * stride + p] = make_int2(v[L_LP], v[L_L1]);
    int* dst = rest + t * stride + p;
    dst[X_MED * pl] = v[L_MED];
    dst[X_FAS * pl] = v[L_FAS];
    dst[X_RT * pl] = v[L_RT];
    dst[X_IGP * pl] = local ? v[L_IGP] : enc;
    dst[X_RID * pl] = v[L_RID];
    dst[X_HASRID * pl] = v[L_HASRID];
    dst[X_PATH * pl] = v[L_PATH];
  }
  return in && v[L_OCC] != 0 && v[L_LOOP] == 0 && (local || res != 0);
}

// (LP, L1) as one unsigned key whose order is the pair's lexicographic
// signed order.
__device__ __forceinline__ unsigned long long pair_key(int lp, int l1) {
  return (unsigned long long)((unsigned)lp ^ 0x80000000u) << 32 | ((unsigned)l1 ^ 0x80000000u);
}

__device__ __forceinline__ unsigned long long umin64(unsigned long long a, unsigned long long b) {
  return a < b ? a : b;
}

__global__ void __launch_bounds__(THREADS, 1) bgp_fold_kernel(
    const int* __restrict__ planes, const int* __restrict__ idx, const int* __restrict__ order,
    const int* __restrict__ addr_rank, const int* __restrict__ has_addr,
    const int* __restrict__ nht_enc, const int* __restrict__ nht_res,
    const int* __restrict__ mp, int* __restrict__ best_out, int* __restrict__ reasons,
    uint8_t* __restrict__ elig_out, uint8_t* __restrict__ sel_out, int n_rows, int n_cols,
    int m, int k, int gr, int tr, int stages, int warps, int tma) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout g = layout(n_cols, gr, tr, stages, warps);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + stages;
  uint64_t* ready = empty + stages;
  uint64_t* freed = ready + FOLD_WARPS;
  int* raw = reinterpret_cast<int*>(smem + g.raw);        // [stages][N_LANES][tr][C]
  int* s_order = reinterpret_cast<int*>(smem + g.vecs);  // position -> column
  int* s_inv = s_order + n_cols;                          // column -> position
  int* s_addr = s_inv + n_cols;                           // by position
  int* s_has = s_addr + n_cols;                           // by position
  const int stride = g.stride, ws = g.ws, pl = gr * stride;
  const int lane_words = tr * n_cols;  // one lane of a raw tile
  const int tile_words = N_LANES * lane_words;
  const int per_group = gr / tr;       // raw tiles a group
  const int n_groups = (m + gr - 1) / gr;
  const int words = (n_cols + 31) >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  for (int p = threadIdx.x; p < n_cols; p += THREADS) {
    const int c = min(max(__ldg(order + p), 0), n_cols - 1);
    s_order[p] = c;
    s_inv[c] = p;
    s_addr[p] = __ldg(addr_rank + c);
    s_has[p] = __ldg(has_addr + c) != 0;
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], tma ? 1 : 32);
      mbar_init(&empty[s], DERIVE_WARPS);
    }
    for (int w = 0; w < FOLD_WARPS; ++w) {
      mbar_init(&ready[w], DERIVE_WARPS);
      mbar_init(&freed[w], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // Group j of this block is rows [gr gi, gr gi + gr) with gi = b + j grid;
  // it is copied as raw tiles of tr rows, tile q being the block's tile
  // seq = j per_group + q, which goes to ring stage seq % stages.  Every
  // barrier is taken in order by its waiters, one phase at a time.
  if (warp == PRODUCER) {
    // The producer: a stage is refilled once the derive warps have
    // released its previous tile.  Lane i holds idx of row i of the tile
    // (tr <= 32), loaded a tile ahead so that its latency hides behind the
    // copies and the wait.
    const long long lane_plane = (long long)n_rows * n_cols;
    auto tile_rows = [&](int seq, int& row0) {  // rows of the block's tile seq (0: none)
      const int gi = blockIdx.x + (seq / per_group) * gridDim.x;
      row0 = gi * gr + (seq % per_group) * tr;
      return gi < n_groups ? max(0, min(tr, min(gr - (seq % per_group) * tr, m - row0))) : 0;
    };
    auto row_of = [&](int row0, int rows) {
      return lane < rows ? min(max(__ldg(idx + row0 + lane), 0), n_rows - 1) : -2;
    };
    int row0, rows = tile_rows(0, row0);
    int row = row_of(row0, rows);
    for (int seq = 0; rows > 0; ++seq) {
      int next0;
      const int next_rows = tile_rows(seq + 1, next0);
      const int next_row = row_of(next0, next_rows);
      const int s = seq % stages;
      mbar_wait(&empty[s], ((seq / stages) & 1) ^ 1);
      int* dst = raw + (size_t)s * tile_words;
      if (tma) {
        // A bulk copy for each lane of each run of consecutive rows (a
        // row alone where idx is not consecutive), a run's 13 copies
        // issued by 13 lanes at once.
        if (lane == 0) mbar_arrive_expect_tx(&full[s], (uint32_t)(rows * N_LANES * n_cols * 4));
        __syncwarp();
        const int prev = __shfl_up_sync(0xffffffffu, row, 1);
        unsigned starts = __ballot_sync(0xffffffffu, lane < rows && (lane == 0 || row != prev + 1));
        while (starts) {
          const int r = __ffs(starts) - 1;
          starts &= starts - 1u;
          const int len = (starts ? __ffs(starts) - 1 : rows) - r;
          const int first = __shfl_sync(0xffffffffu, row, r);
          if (lane < N_LANES) {
            bulk_copy(dst + lane * lane_words + r * n_cols,
                      planes + lane * lane_plane + (long long)first * n_cols,
                      (uint32_t)(4 * n_cols * len), &full[s]);
          }
        }
      } else {
        for (int r = 0; r < rows; ++r) {
          const int* src = planes + (long long)__shfl_sync(0xffffffffu, row, r) * n_cols;
          for (int u = lane; u < N_LANES * n_cols; u += 32) {
            const int l = u / n_cols, c = u - l * n_cols;
            cp_async4(dst + l * lane_words + r * n_cols + c, src + l * lane_plane + c);
          }
        }
        cp_async_arrive(&full[s]);
      }
      rows = next_rows;
      row = next_row;
    }
    if (!tma) asm volatile("cp.async.wait_all;" ::: "memory");
    return;
  }

  int2* key_all = reinterpret_cast<int2*>(smem + g.cell);
  int* rest_all = reinterpret_cast<int*>(key_all + (size_t)warps * pl);
  if (warp >= FOLD_WARPS) {
    // The derive warps: group j goes to fold warp j % warps once that warp
    // has written out its previous group.  A warp takes a row of a tile,
    // 32 positions a step (lane i position 32w + i): it derives the cells
    // (13 loads in flight a lane, eight warps at it), then scans the eligible
    // (LP, L1) pairs in order.  The winner's pair after any step of the
    // fold is the least pair so far (the two rungs compare
    // lexicographically), so a position above the least pair before it
    // loses at LP or L1 and its reason is written here; the others (the
    // first, each new least pair, each tie on it) are the events the fold
    // walks.
    const int dw = warp - FOLD_WARPS;
    for (int j = 0, gi = blockIdx.x; gi < n_groups; ++j, gi += gridDim.x) {
      const int fw = j % warps;
      mbar_wait(&freed[fw], ((j / warps) & 1) ^ 1);
      int2* key = key_all + fw * pl;
      int* rest = rest_all + fw * N_REST * pl;
      int* sreason = reinterpret_cast<int*>(smem + g.reason) + fw * gr * n_cols;
      unsigned* ebits = reinterpret_cast<unsigned*>(smem + g.ebits) + fw * gr * ws;
      unsigned* sbits = reinterpret_cast<unsigned*>(smem + g.sbits) + fw * gr * ws;
      const int grows = min(gr, m - gi * gr);
      for (int q = 0; q * tr < grows; ++q) {
        const int seq = j * per_group + q, s = seq % stages;
        mbar_wait(&full[s], (seq / stages) & 1);
        const int* src0 = raw + (size_t)s * tile_words;
        const int rows = min(tr, grows - q * tr);
        for (int r = dw; r < rows; r += DERIVE_WARPS) {
          const int t = q * tr + r;
          unsigned long long carry = ~0ull;  // the least eligible pair of the words so far
          bool seen = false;                 // an eligible position so far
          for (int w = 0; w < words; ++w) {
            const int p = (w << 5) + lane;
            const int* src = src0 + r * n_cols + s_order[p < n_cols ? p : 0];
            int v[N_LANES];
#pragma unroll
            for (int l = 0; l < N_LANES; ++l) v[l] = src[l * lane_words];
            const int nh = min(max(v[L_NH], 0), k - 1);
            const bool e = derive(v, __ldg(nht_res + nh), __ldg(nht_enc + nh), t, p, n_cols,
                                  stride, pl, key, rest);
            // The scan: the least eligible pair before each position.
            const unsigned long long kp = e ? pair_key(v[L_LP], v[L_L1]) : ~0ull;
            unsigned long long inc = kp;
#pragma unroll
            for (int d = 1; d < 32; d <<= 1) {
              const unsigned long long o = __shfl_up_sync(0xffffffffu, inc, d);
              if (lane >= d) inc = umin64(inc, o);
            }
            unsigned long long least = __shfl_up_sync(0xffffffffu, inc, 1);
            least = umin64(lane ? least : ~0ull, carry);
            const unsigned ew = __ballot_sync(0xffffffffu, e);
            const bool before = seen || (ew & ((1u << lane) - 1u)) != 0;
            const bool event = e && (!before || kp <= least);
            int reason = 0;
            if (e && !event) {  // loses at LP or L1 to the winner, whose pair is `least`
              const int lp = (int)((unsigned)(least >> 32) ^ 0x80000000u);
              const int l1 = (int)((unsigned)least ^ 0x80000000u);
              reason = v[L_LP] != lp ? R_LP : (v[L_L1] >> 2) != (l1 >> 2) ? R_PLEN : R_ORIGIN;
            }
            if (p < n_cols) sreason[t * n_cols + p] = reason;
            const unsigned evw = __ballot_sync(0xffffffffu, event);
            if (lane == 0) {
              ebits[t * ws + w] = ew;
              sbits[t * ws + w] = evw;
            }
            carry = umin64(carry, __shfl_sync(0xffffffffu, inc, 31));
            seen = seen || ew != 0u;
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with the stage
      }
      if (lane == 0) mbar_arrive(&ready[fw]);
    }
    return;
  }
  if (warp >= warps) return;

  // A fold warp: its groups j = warp, warp + warps, ..., folded one lane a
  // row and written out.
  const int2* key = key_all + warp * pl;
  const int* rest = rest_all + warp * N_REST * pl;
  int* sreason = reinterpret_cast<int*>(smem + g.reason) + warp * gr * n_cols;
  const unsigned* ebits = reinterpret_cast<const unsigned*>(smem + g.ebits) + warp * gr * ws;
  unsigned* sbits = reinterpret_cast<unsigned*>(smem + g.sbits) + warp * gr * ws;
  const bool allow = __ldg(mp) != 0;
  const int ibgp_max = __ldg(mp + 1), ebgp_max = __ldg(mp + 2);
  const int local_pos = s_inv[LOCAL_COL];
  // This lane's first output item and its stride, as (row, item of the
  // row): an item is 4 columns where C is a multiple of 4, else one.
  const bool quads = n_cols % 4 == 0;
  const int items = quads ? n_cols >> 2 : n_cols;
  const int o_r0 = lane / items, o_c0 = lane - o_r0 * items;
  const int o_dr = 32 / items, o_dc = 32 - o_dr * items;
  for (int j = warp, gi = blockIdx.x + warp * gridDim.x; gi < n_groups;
       j += warps, gi += warps * gridDim.x) {
    const int g0 = gi * gr, grows = min(gr, m - g0);
    mbar_wait(&ready[warp], (j / warps) & 1);

    if (lane < grows) {
      const int t = lane;
      const int2* mk = key + t * stride;
      const int* my = rest + t * stride;
      int* rrow = sreason + t * n_cols;
      // Pass 1: the fold in candidate order over the events the derive
      // warps left (the first eligible position, each new least (LP, L1),
      // each tie on it); every other eligible position already lost at LP
      // or L1.  The first differing rung decides (JAX evaluates the ladder
      // bottom-up, each rung overwriting the deeper verdict); a full tie
      // loses on the peer address.  Past (LP, L1) the rungs are tested at
      // once and the first that differs found with __ffs.
      unsigned* sb = sbits + t * ws;  // the events, then the selection
      int best = -1;  // the winner's position
      Best b = {};
      for (int x = 0; x < words; ++x) {
        for (unsigned ev = sb[x]; ev; ev &= ev - 1u) {
          const int p = (x << 5) + __ffs(ev) - 1;
          const int2 kp = mk[p];
          Best c;
          c.lp = kp.x;
          c.l1 = kp.y;
          load_rest(c, my, pl, s_addr, s_has, p);
          bool better = true;
          if (best >= 0) {
            int reason;
            if (c.lp != b.lp || c.l1 != b.l1) {  // a new least pair
              reason = c.lp != b.lp ? R_LP : (c.l1 >> 2) != (b.l1 >> 2) ? R_PLEN : R_ORIGIN;
            } else {
              const unsigned differs =
                  ((unsigned)(c.fas == b.fas) & (unsigned)(c.med != b.med)) |
                  (unsigned)(c.rt != b.rt) << 1 | (unsigned)(c.igp != b.igp) << 2 |
                  ((unsigned)((c.hasrid & b.hasrid) != 0) & (unsigned)(c.rid != b.rid)) << 3 |
                  1u << 4;
              const unsigned wins =
                  (unsigned)(c.med < b.med) |
                  (unsigned)(c.rt > b.rt) << 1 |  // the one rung where the higher value wins
                  (unsigned)(c.igp < b.igp) << 2 | (unsigned)(c.rid < b.rid) << 3 |
                  ((unsigned)(c.has != 0) & (unsigned)(b.has != 0) & (unsigned)(c.addr < b.addr))
                      << 4;
              const int rung = __ffs(differs) - 1;  // MED, RT, IGP, RID, address
              better = (wins >> rung) & 1u;
              reason = R_MED + rung;
            }
            rrow[better ? best : p] = reason;
          }
          if (better) {
            best = p;
            b = c;
          }
        }
      }
      // Pass 2: multipath, the first max_paths equal peer columns in order,
      // among the events on the winner's pair (which are all the eligible
      // positions with it); the selection replaces the events word by word.
      if (best >= 0) {
        const int maxp = b.rt == 0 ? ibgp_max : ebgp_max;
        int count = 0;
        for (int x = 0; x < words; ++x) {
          unsigned sel = 0u;
          for (unsigned ev = sb[x]; ev && count < maxp; ev &= ev - 1u) {
            const int bit = __ffs(ev) - 1, q = (x << 5) + bit;
            const int2 kq = mk[q];
            if (q == local_pos || kq.x != b.lp || kq.y != b.l1) continue;
            const bool fas_eq = my[X_FAS * pl + q] == b.fas;
            if (my[X_RT * pl + q] == b.rt && my[X_IGP * pl + q] == b.igp &&
                (!fas_eq || my[X_MED * pl + q] == b.med) &&
                (b.rt == 1 ? (allow || fas_eq) : my[X_PATH * pl + q] == b.path)) {
              sel |= 1u << bit;
              ++count;
            }
          }
          sb[x] = sel;
        }
      }
      best_out[g0 + t] = best < 0 ? -1 : s_order[best];
    }
    __syncwarp();

    // The group's reasons, eligibility and selection, by column, in
    // coalesced runs (4 columns a lane where C is a multiple of 4).
    const long long out0 = (long long)g0 * n_cols;
    for (int r = o_r0, c = o_c0; r < grows;) {
      const int* rr = sreason + r * n_cols;
      const unsigned* ew = ebits + r * ws;
      const unsigned* sw = sbits + r * ws;
      if (quads) {
        const int4 q = *reinterpret_cast<const int4*>(s_inv + 4 * c);
        const long long o = out0 + (long long)r * n_cols + 4 * c;
        *reinterpret_cast<int4*>(reasons + o) = make_int4(rr[q.x], rr[q.y], rr[q.z], rr[q.w]);
        *reinterpret_cast<unsigned*>(elig_out + o) = pos_bit(ew, q.x) | pos_bit(ew, q.y) << 8 |
                                                     pos_bit(ew, q.z) << 16 | pos_bit(ew, q.w) << 24;
        *reinterpret_cast<unsigned*>(sel_out + o) = pos_bit(sw, q.x) | pos_bit(sw, q.y) << 8 |
                                                    pos_bit(sw, q.z) << 16 | pos_bit(sw, q.w) << 24;
      } else {
        const int q = s_inv[c];
        const long long o = out0 + (long long)r * n_cols + c;
        reasons[o] = rr[q];
        elig_out[o] = (uint8_t)pos_bit(ew, q);
        sel_out[o] = (uint8_t)pos_bit(sw, q);
      }
      r += o_dr;
      c += o_dc;
      if (c >= items) {
        c -= items;
        ++r;
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&freed[warp]);  // the derive warps may refill the buffer
  }
}

}  // namespace

extern "C" {

// Shared-memory bytes a block takes at this geometry.
int holo_bgp_fold_smem(int n_cols, int gr, int tr, int stages, int warps) {
  return (int)layout(n_cols, gr, tr, stages, warps).total;
}

int holo_bgp_fold(const void* planes, const void* idx, const void* order, const void* addr_rank,
                  const void* has_addr, const void* nht_enc, const void* nht_res,
                  const void* mp, void* best, void* reasons, void* elig, void* sel,
                  int n_rows, int n_cols, int m, int k, int gr, int tr, int stages, int warps,
                  int grid, void* stream) {
  if (m <= 0) return 0;
  if (n_cols <= 0 || n_rows <= 0 || k <= 0 || gr <= 0 || gr > 32 || tr <= 0 || gr % tr != 0 ||
      stages < 2 || stages > MAX_STAGES || warps < 1 || warps > FOLD_WARPS || grid <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = layout(n_cols, gr, tr, stages, warps).total;
  // Dynamic shared memory above 48 KB must be allowed per kernel and device;
  // raise the allowance only when a launch needs more than it already has,
  // so the update-sized launches pay no host call for it.
  static size_t allowed[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES || smem > allowed[dev]) {
    err = cudaFuncSetAttribute(bgp_fold_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < MAX_DEVICES) allowed[dev] = smem;
  }
  // Bulk copies need 16-byte runs on 16-byte boundaries: 4C a multiple of 16
  // and the planes' base aligned.
  const int tma = n_cols % 4 == 0 && reinterpret_cast<uintptr_t>(planes) % 16 == 0;
  bgp_fold_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const int*)planes, (const int*)idx, (const int*)order, (const int*)addr_rank,
      (const int*)has_addr, (const int*)nht_enc, (const int*)nht_res, (const int*)mp,
      (int*)best, (int*)reasons, (uint8_t*)elig, (uint8_t*)sel, n_rows, n_cols, m, k, gr, tr,
      stages, warps, tma);
  return (int)cudaGetLastError();
}

}  // extern "C"
