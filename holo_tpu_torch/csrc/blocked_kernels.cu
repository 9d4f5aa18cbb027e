// Block-sparse SPF kernels for Hopper (sm_90a), plain C interface for ctypes.
//
// These replace the Pallas TPU kernels of the blocked SPF engine:
//
//   relax   <- holo_tpu/ops/blocked.py:118 _relax_kernel (pallas_call at :144)
//              and holo_tpu/ops/blocked_spf.py:281 _relax_kernel (same math)
//   dmin    <- holo_tpu/ops/blocked_spf.py:295 _dmin_kernel
//   parent  <- holo_tpu/ops/blocked_spf.py:312 _parent_kernel
//   nh_or   <- holo_tpu/ops/blocked_spf.py:337 _nh_or_kernel
//   (all four TPU kernels are built by _grid, pallas_call at blocked_spf.py:394)
//
// All work on int32 with CAP = 1<<28 as infinity over the P nonzero S x S
// block pairs (S = 256) of the adjacency: w[p, u, v] is the cost of edge
// (bsrc[p]*S + u) -> (bdst[p]*S + v), CAP where there is none.  Pairs are
// sorted by destination block and seg[bd] .. seg[bd+1] are the pairs of
// destination block bd.
//
//   relax : out[v,l] = min(dist[v,l], min_u w[u,v] + dist[u,l])
//   dmin  : out[v,l] = min dist[u,l] over DAG parents u, CAP if none
//   parent: out[v,l] = min orig_id[u] over DAG parents u with
//           dist[u,l] == dmin[v,l], PBIG if none
//   nh_or : out[v,l] = direct[v,l] | OR nh[u,l] over DAG parents u with
//           gate[u,b] > 0, where l = word * batch + b
//
// u is a DAG parent of v in lane l when w[u,v] < CAP, dist[u] < CAP and
// w[u,v] + dist[u] == dist[v].
//
// Design.  The TPU grid walks the block pairs in order and carries the
// output block across steps ("first" flag).  GPU blocks run in no order, so
// here one thread block owns a 64-row x 64-lane tile of ONE destination
// block, loops over that block's run of pairs, starts from its init value
// (ddst, CAP, PBIG or direct) and writes once: no atomics, deterministic.
// One S x S weight block is 256 KiB, more than a thread block's shared
// memory, so the source-row loop is streamed in chunks of 32 rows: 32 rows
// of w (the tile's 64 columns) and the matching 32 rows of the lane tile's
// source planes go to shared memory; each of the 256 threads keeps a 4 x 4
// register tile of (v, lane) accumulators.  Lanes beyond the lane count are
// masked, so any batch works (compute() runs with one lane).
//
// Bound on this card.  Every (u, v, lane) triple of a pair costs an add and
// a min (relax) or an add, compares and a select (the others): the kernels
// are bound by integer throughput, not by the ~170 MB they move per launch
// at 10k vertices x 1024 scenarios.  The source does not call Hopper's DPX
// intrinsic __viaddmin_s32(a, b, c) = min(a + b, c), relax's inner step,
// but nvcc fuses relax's add and min into that instruction (VIADDMNMX)
// anyway; chip_smoke.py counts it in the built library.  The next step is a
// sparser walk of the mostly-CAP weight blocks.

#include <cuda_runtime.h>

namespace {

constexpr int S = 256;        // vertex block size
constexpr int CAP = 1 << 28;  // in-kernel infinity
constexpr int PBIG = 1 << 27; // "no parent" sentinel
constexpr int TV = 64;        // destination rows per thread block
constexpr int TL = 64;        // lanes per thread block
constexpr int UC = 32;        // source rows per shared-memory chunk
constexpr int RV = 4;         // rows per thread
constexpr int RL = 4;         // lanes per thread
constexpr int THREADS = 256;  // 16 x 16 threads, each RV x RL outputs

enum Mode { RELAX = 0, DMIN = 1, PARENT = 2, NH_OR = 3 };

// dsrc/ddst: [N_pad, batch] distances read on the source / destination side.
// aux_d: destination-indexed [N_pad, lanes] (PARENT: dmin, NH_OR: direct).
// aux_s: source-indexed (PARENT: orig_id [N_pad], NH_OR: nh [N_pad, lanes]).
// gate: NH_OR only, [N_pad, batch].
template <int MODE>
__global__ void __launch_bounds__(THREADS)
blocked_kernel(const int* __restrict__ w, const int* __restrict__ seg,
               const int* __restrict__ bsrc, const int* __restrict__ dsrc,
               const int* __restrict__ ddst, const int* __restrict__ aux_d,
               const int* __restrict__ aux_s, const int* __restrict__ gate,
               int* __restrict__ out, int lanes, int batch) {
  __shared__ int ws[UC][TV];
  __shared__ int ds[UC][TL];
  __shared__ int xs[MODE == NH_OR ? UC : 1][TL];
  __shared__ int oids[UC];

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int bd = blockIdx.z;
  const int vcol0 = blockIdx.y * TV;  // first column of the tile in w
  const int vrow0 = bd * S + vcol0;   // its global row
  const int l0 = blockIdx.x * TL;

  int acc[RV][RL];
  int dv[RV][RL];
  int dm[RV][RL];
#pragma unroll
  for (int i = 0; i < RV; ++i) {
#pragma unroll
    for (int j = 0; j < RL; ++j) {
      const long v = vrow0 + ty + 16 * i;
      const int l = l0 + tx + 16 * j;
      const bool ok = l < lanes;
      const int b = MODE == NH_OR ? (ok ? l % batch : 0) : l;
      dv[i][j] = ok ? ddst[v * batch + b] : 0;
      dm[i][j] = (MODE == PARENT && ok) ? aux_d[v * lanes + l] : 0;
      if (MODE == RELAX) acc[i][j] = dv[i][j];
      if (MODE == DMIN) acc[i][j] = CAP;
      if (MODE == PARENT) acc[i][j] = PBIG;
      if (MODE == NH_OR) acc[i][j] = ok ? aux_d[v * lanes + l] : 0;
    }
  }

  const int p_end = seg[bd + 1];
  for (int p = seg[bd]; p < p_end; ++p) {
    const long urow0 = (long)bsrc[p] * S;
    const int* wp = w + (long)p * S * S;
    for (int u0 = 0; u0 < S; u0 += UC) {
      __syncthreads();  // the previous chunk is consumed
      for (int k = threadIdx.x; k < UC * TV; k += THREADS) {
        const int r = k / TV, c = k % TV;
        ws[r][c] = wp[(long)(u0 + r) * S + vcol0 + c];
      }
      for (int k = threadIdx.x; k < UC * TL; k += THREADS) {
        const int r = k / TL, c = k % TL;
        const long u = urow0 + u0 + r;
        const int l = l0 + c;
        int du = CAP;
        int x = 0;
        if (l < lanes) {
          const int b = MODE == NH_OR ? l % batch : l;
          du = dsrc[u * batch + b];
          if (MODE == NH_OR) {
            // A parent with hops == 0 passes nothing on: the same as no
            // parent, since every DAG test also asks dist[u] < CAP.
            if (gate[u * batch + b] <= 0) du = CAP;
            x = aux_s[u * lanes + l];
          }
        }
        ds[r][c] = du;
        if (MODE == NH_OR) xs[r][c] = x;
      }
      if (MODE == PARENT && threadIdx.x < UC) {
        oids[threadIdx.x] = aux_s[urow0 + u0 + threadIdx.x];
      }
      __syncthreads();

#pragma unroll 4
      for (int r = 0; r < UC; ++r) {
        int wv[RV];
        int du[RL];
#pragma unroll
        for (int i = 0; i < RV; ++i) wv[i] = ws[r][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < RL; ++j) du[j] = ds[r][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < RV; ++i) {
#pragma unroll
          for (int j = 0; j < RL; ++j) {
            const int s = wv[i] + du[j];
            if (MODE == RELAX) {
              acc[i][j] = min(acc[i][j], s);
            } else {
              const bool dag = wv[i] < CAP && du[j] < CAP && s == dv[i][j];
              if (MODE == DMIN && dag) acc[i][j] = min(acc[i][j], du[j]);
              if (MODE == PARENT && dag && du[j] == dm[i][j])
                acc[i][j] = min(acc[i][j], oids[r]);
              if (MODE == NH_OR && dag) acc[i][j] |= xs[r][tx + 16 * j];
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RV; ++i) {
#pragma unroll
    for (int j = 0; j < RL; ++j) {
      const long v = vrow0 + ty + 16 * i;
      const int l = l0 + tx + 16 * j;
      if (l < lanes) out[v * lanes + l] = acc[i][j];
    }
  }
}

template <int MODE>
int launch(const void* w, const void* seg, const void* bsrc, const void* dsrc,
           const void* ddst, const void* aux_d, const void* aux_s,
           const void* gate, void* out, int nb, int lanes, int batch,
           void* stream) {
  if (nb > 0 && lanes > 0) {
    const dim3 grid((lanes + TL - 1) / TL, S / TV, nb);
    blocked_kernel<MODE><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const int*)w, (const int*)seg, (const int*)bsrc, (const int*)dsrc,
        (const int*)ddst, (const int*)aux_d, (const int*)aux_s,
        (const int*)gate, (int*)out, lanes, batch);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* holo_error_string(int rc) {
  return cudaGetErrorString((cudaError_t)rc);
}

int holo_blocked_relax(const void* w, const void* seg, const void* bsrc,
                       const void* dist, void* out, int nb, int lanes,
                       void* stream) {
  return launch<RELAX>(w, seg, bsrc, dist, dist, nullptr, nullptr, nullptr,
                       out, nb, lanes, lanes, stream);
}

int holo_blocked_dmin(const void* w, const void* seg, const void* bsrc,
                      const void* dist, void* out, int nb, int lanes,
                      void* stream) {
  return launch<DMIN>(w, seg, bsrc, dist, dist, nullptr, nullptr, nullptr,
                      out, nb, lanes, lanes, stream);
}

int holo_blocked_parent(const void* w, const void* seg, const void* bsrc,
                        const void* dist, const void* dmin,
                        const void* orig_id, void* out, int nb, int lanes,
                        void* stream) {
  return launch<PARENT>(w, seg, bsrc, dist, dist, dmin, orig_id, nullptr, out,
                        nb, lanes, lanes, stream);
}

int holo_blocked_nh_or(const void* w, const void* seg, const void* bsrc,
                       const void* dist, const void* gate, const void* nh,
                       const void* direct, void* out, int nb, int batch,
                       int lanes, void* stream) {
  return launch<NH_OR>(w, seg, bsrc, dist, dist, direct, nh, gate, out, nb,
                       lanes, batch, stream);
}

}  // extern "C"
