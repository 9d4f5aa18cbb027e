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
// planes (clamped into [0, R)); order [C] the candidate order (peers by
// address, unassigned columns, the local column 0 last); addr_rank, has_addr
// [C]; nht_enc, nht_res [K]; mp [3] = (allow_multiple_as, ibgp_max,
// ebgp_max).  Outputs: best [M] int32 (-1: no eligible column), reasons
// [M, C] int32, elig and sel [M, C] bytes (0 / 1).  Lanes hold biased u32
// values (u - 2^31 as int32): every compare is a signed int compare, as
// JAX's.
//
// The fold is not an argmin.  The MED rung fires only between routes of the
// same first AS, so the comparator is not transitive (three routes can form
// a preference cycle) and only the oracle's walk in candidate order gives its
// answer: one thread owns a row and visits the columns in order, keeping the
// winner's lanes and its derived IGP in registers.  Each loss writes its
// reason once, to the loser's cell (the candidate, or the displaced winner);
// the row starts zeroed.  A second walk in order tests each eligible peer
// column against the winner (rib.rs:463-487) and selects the first max_paths
// matches.
//
// What bounds it: bytes.  Each cell's 13 lanes are read once (1.745 GB at
// 524,288 x 64) and 0.203 GB of outputs written: 0.58 ms at 3.35 TB/s; the
// fold is ~30 int32 operations a cell.  A thread per row reading its own row
// would make a warp's loads C x 4 bytes apart, a 32-byte sector for every
// 4-byte word.  So a block of 128 threads stages a tile of up to 32 rows x
// all columns: warp w loads rows w, w + 4, ..., lane l columns l, l + 32, ...
// (each row's C words of a lane are contiguous), derives the IGP lane and
// eligibility on the way (the next-hop vectors are read there and nowhere
// else), and keeps 9 words a cell in shared memory (row stride C | 1, odd,
// so the fold's 32 threads read 32 banks) and eligibility as ballot bit
// words.  One warp folds the tile; the block then writes the elig and
// selection bytes in coalesced runs.  At C = 64 a tile takes 75 KB: three
// blocks an SM.  Wider tables fold fewer rows a block (the wrapper picks
// tile rows that fit).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

enum { L_LP, L_L1, L_MED, L_FAS, L_RT, L_IGP, L_RID, L_HASRID, L_NH, L_PATH, L_OCC,
       L_LOOP, L_LOCAL, N_LANES };
// Words a staged cell keeps (the IGP word holds the derived IGP).
enum { S_LP, S_L1, S_MED, S_FAS, S_RT, S_IGP, S_RID, S_HASRID, S_PATH, N_STAGED };
constexpr int R_LP = 1, R_PLEN = 2, R_ORIGIN = 3, R_MED = 4, R_RT = 5, R_IGP = 6,
              R_RID = 7, R_ADDR = 8;
constexpr int LOCAL_COL = 0;
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_DEVICES = 64;

__host__ __device__ inline int word_stride(int n_cols) { return ((n_cols + 31) >> 5) | 1; }

inline size_t smem_bytes(int n_cols, int tr) {
  return sizeof(int) * ((size_t)N_STAGED * tr * (n_cols | 1) + 2 * (size_t)tr * word_stride(n_cols));
}

__global__ void __launch_bounds__(THREADS) bgp_fold_kernel(
    const int* __restrict__ planes, const int* __restrict__ idx, const int* __restrict__ order,
    const int* __restrict__ addr_rank, const int* __restrict__ has_addr,
    const int* __restrict__ nht_enc, const int* __restrict__ nht_res,
    const int* __restrict__ mp, int* __restrict__ best_out, int* __restrict__ reasons,
    uint8_t* __restrict__ elig_out, uint8_t* __restrict__ sel_out, int n_rows, int n_cols,
    int m, int k, int tr) {
  extern __shared__ int smem[];
  const int stride = n_cols | 1;
  const int ws = word_stride(n_cols);
  const int pl = tr * stride;  // one staged word's plane
  int* cell = smem;            // [N_STAGED][tr][stride]
  unsigned* ebits = reinterpret_cast<unsigned*>(smem + N_STAGED * pl);  // [tr][ws]
  unsigned* sbits = ebits + tr * ws;                                     // [tr][ws]
  const int row0 = blockIdx.x * tr;
  const int rows = min(tr, m - row0);
  const long long lane_plane = (long long)n_rows * n_cols;
  const int lane_id = threadIdx.x & 31;

  // Stage the tile, deriving the IGP word and eligibility.
  for (int r = threadIdx.x >> 5; r < rows; r += WARPS) {
    const int row = min(max(idx[row0 + r], 0), n_rows - 1);
    const int* base = planes + (long long)row * n_cols;
    for (int c0 = 0; c0 < n_cols; c0 += 32) {
      const int c = c0 + lane_id;
      bool e = false;
      if (c < n_cols) {
        int v[N_LANES];
#pragma unroll
        for (int l = 0; l < N_LANES; ++l) v[l] = __ldg(base + l * lane_plane + c);
        const int nh = min(max(v[L_NH], 0), k - 1);
        const bool local = v[L_LOCAL] != 0;
        e = v[L_OCC] != 0 && v[L_LOOP] == 0 && (local || __ldg(nht_res + nh) != 0);
        int* dst = cell + r * stride + c;
        dst[S_LP * pl] = v[L_LP];
        dst[S_L1 * pl] = v[L_L1];
        dst[S_MED * pl] = v[L_MED];
        dst[S_FAS * pl] = v[L_FAS];
        dst[S_RT * pl] = v[L_RT];
        dst[S_IGP * pl] = local ? v[L_IGP] : __ldg(nht_enc + nh);
        dst[S_RID * pl] = v[L_RID];
        dst[S_HASRID * pl] = v[L_HASRID];
        dst[S_PATH * pl] = v[L_PATH];
      }
      const unsigned word = __ballot_sync(0xffffffffu, e);
      if (lane_id == 0) {
        ebits[r * ws + (c0 >> 5)] = word;
        sbits[r * ws + (c0 >> 5)] = 0u;
      }
    }
  }
  // A reason is written once a cell, where its column loses: zero the tile.
  int* tile_reasons = reasons + (long long)row0 * n_cols;
  for (int i = threadIdx.x; i < rows * n_cols; i += THREADS) tile_reasons[i] = 0;
  __syncthreads();

  if (threadIdx.x < rows) {
    const int t = threadIdx.x;
    const int* my = cell + t * stride;
    const unsigned* eb = ebits + t * ws;
    int* rrow = tile_reasons + (long long)t * n_cols;
    int best = -1;
    int b_lp = 0, b_l1 = 0, b_med = 0, b_fas = 0, b_rt = 0, b_igp = 0, b_rid = 0,
        b_hasrid = 0, b_path = 0, b_addr = 0;
    bool b_hasaddr = false;
    // Pass 1: the fold in candidate order.  The first differing rung
    // decides (JAX evaluates the ladder bottom-up, each rung overwriting the
    // deeper verdict); a full tie loses on the peer address.
    for (int j = 0; j < n_cols; ++j) {
      const int c = __ldg(order + j);
      if (!((eb[c >> 5] >> (c & 31)) & 1u)) continue;
      const int c_lp = my[S_LP * pl + c], c_l1 = my[S_L1 * pl + c];
      const int c_med = my[S_MED * pl + c], c_fas = my[S_FAS * pl + c];
      const int c_rt = my[S_RT * pl + c], c_igp = my[S_IGP * pl + c];
      const int c_rid = my[S_RID * pl + c], c_hasrid = my[S_HASRID * pl + c];
      const int a_addr = __ldg(addr_rank + c);
      const bool a_has = __ldg(has_addr + c) != 0;
      bool better = true;
      if (best >= 0) {
        int reason;
        if (c_lp != b_lp) {
          better = c_lp < b_lp;
          reason = R_LP;
        } else if (c_l1 != b_l1) {
          better = c_l1 < b_l1;
          reason = (c_l1 >> 2) != (b_l1 >> 2) ? R_PLEN : R_ORIGIN;
        } else if (c_fas == b_fas && c_med != b_med) {
          better = c_med < b_med;
          reason = R_MED;
        } else if (c_rt != b_rt) {
          better = c_rt > b_rt;  // the one rung where the higher value wins
          reason = R_RT;
        } else if (c_igp != b_igp) {
          better = c_igp < b_igp;
          reason = R_IGP;
        } else if ((c_hasrid & b_hasrid) != 0 && c_rid != b_rid) {
          better = c_rid < b_rid;
          reason = R_RID;
        } else {
          better = a_has && b_hasaddr && a_addr != b_addr && a_addr < b_addr;
          reason = R_ADDR;
        }
        rrow[better ? best : c] = reason;
      }
      if (better) {
        best = c;
        b_lp = c_lp, b_l1 = c_l1, b_med = c_med, b_fas = c_fas, b_rt = c_rt;
        b_igp = c_igp, b_rid = c_rid, b_hasrid = c_hasrid;
        b_path = my[S_PATH * pl + c];
        b_addr = a_addr, b_hasaddr = a_has;
      }
    }
    // Pass 2: multipath, the first max_paths equal peer columns in order.
    if (best >= 0) {
      const int maxp = b_rt == 0 ? __ldg(mp + 1) : __ldg(mp + 2);
      const bool allow = __ldg(mp) != 0;
      unsigned* sb = sbits + t * ws;
      int count = 0;
      for (int j = 0; j < n_cols && count < maxp; ++j) {
        const int c = __ldg(order + j);
        if (c == LOCAL_COL || !((eb[c >> 5] >> (c & 31)) & 1u)) continue;
        if (my[S_LP * pl + c] != b_lp || my[S_L1 * pl + c] != b_l1 ||
            my[S_RT * pl + c] != b_rt || my[S_IGP * pl + c] != b_igp) {
          continue;
        }
        const bool fas_eq = my[S_FAS * pl + c] == b_fas;
        if (fas_eq && my[S_MED * pl + c] != b_med) continue;
        if (!(b_rt == 1 ? (allow || fas_eq) : my[S_PATH * pl + c] == b_path)) continue;
        ++count;
        sb[c >> 5] |= 1u << (c & 31);
      }
    }
    best_out[row0 + t] = best;
  }
  __syncthreads();

  // The tile's eligibility and selection bytes, in coalesced runs.
  const long long out0 = (long long)row0 * n_cols;
  for (int i = threadIdx.x; i < rows * n_cols; i += THREADS) {
    const int r = i / n_cols, c = i - r * n_cols;
    const int w = r * ws + (c >> 5), bit = c & 31;
    elig_out[out0 + i] = (uint8_t)((ebits[w] >> bit) & 1u);
    sel_out[out0 + i] = (uint8_t)((sbits[w] >> bit) & 1u);
  }
}

}  // namespace

extern "C" {

int holo_bgp_fold(const void* planes, const void* idx, const void* order, const void* addr_rank,
                  const void* has_addr, const void* nht_enc, const void* nht_res,
                  const void* mp, void* best, void* reasons, void* elig, void* sel,
                  int n_rows, int n_cols, int m, int k, int tr, void* stream) {
  if (m <= 0 || n_cols <= 0 || tr <= 0) return 0;
  const size_t smem = smem_bytes(n_cols, tr);
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
  bgp_fold_kernel<<<(m + tr - 1) / tr, THREADS, smem, (cudaStream_t)stream>>>(
      (const int*)planes, (const int*)idx, (const int*)order, (const int*)addr_rank,
      (const int*)has_addr, (const int*)nht_enc, (const int*)nht_res, (const int*)mp,
      (int*)best, (int*)reasons, (uint8_t*)elig, (uint8_t*)sel, n_rows, n_cols, m, k, tr);
  return (int)cudaGetLastError();
}

}  // extern "C"
