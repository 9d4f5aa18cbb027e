// The fused Jacobi round of the gather SPF engine for Hopper (sm_90a), plain
// C interface for ctypes.
//
//   ell_fused_round <- holo_tpu/ops/spf_engine.py:1071-1106, round_fn of
//                      spf_one_fused: the round of the `fused` (separate
//                      gathers) and `packed` (one row gather) engines.  The
//                      JAX package runs it inside lax.while_loop, where XLA
//                      fuses it into loop fusions; there is no Pallas kernel.
//
// One round recomputes every quantity from the state before it (all int32,
// INF = 1<<30 unreachable; adds wrap as JAX's int32 adds, in unsigned):
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
// and sets *changed where dist', hops' or a word differs from its input.
// Every slot whose source is the parent carries hops[parent], so hops' takes
// the hops of the slot that wins the (dist, src) argmin.
//
// Planes: src, cost, slot [N, K] (slot = the in-edge's edge id, -1 for
// padding); mask [E, ceil(B/32)] with bit b%32 of word [e, b/32] set where
// edge e is up in lane b, or NULL; direct [N, K, W] one-hot atom words; inc
// [N] (1 at a router); roots [B].  Two layouts of the state, the JAX
// package's `packed` switch:
//
// - planar (`fused`): dist [N, B], hops [N, B], next hops [N, W, B], lanes
//   minor.  Pass 1 gathers dist[src] over the K slots for the row minimum;
//   pass 2 walks the slots again and gathers hops and the words only where
//   dist[src] + cost == dist' (the DAG slots).
// - interleaved (`packed`): one plane [N, B, 2 + W], (dist, hops, words) of
//   a (row, lane) contiguous, so a usable slot gathers one 2 + W vector a
//   lane (16 bytes at W = 2), JAX's single row gather.  One
//   pass keeps a running best b = min(dist, the candidates so far): a
//   candidate below b resets the parent and OR accumulators, one equal to b
//   accumulates into them.  b never falls below the final minimum, so a slot
//   whose candidate is the minimum is accumulated when the walk meets it and
//   never reset after; a slot above it is reset once b falls below it.  The
//   accumulators end holding exactly the DAG.
//
// A warp owns one row and one 32-lane word (blockIdx.x: WARPS rows,
// blockIdx.y: the lane word, blockIdx.z: a chunk of FW next-hop words; each
// chunk repeats the walk for its words, chunk 0 also writes dist', hops' and
// the parent).  The slot planes and the mask word are warp-uniform loads.
// The kernel reads the state (A) and writes the next one (B): the fixpoint loop
// ping-pongs two buffers, and sets the flag to 0 before the launch.
//
// What bounds it.  A round must read the slot planes (12 bytes a slot), one
// mask word a (slot, lane word), and per usable (slot, lane word) a 32-byte
// sector of the source's dist (planar; the interleaved vector is 16 bytes a
// lane, 512 a word) plus, per DAG (slot, lane word), a sector of hops and of
// each next-hop word (planar); and write the next state and the parent once.
// This first kernel walks the slots one at a time with one gather in flight
// a warp and no frontier (every round gathers every usable slot), so it waits
// on load latency, far above that bound: batching the gathers and skipping
// unchanged sources, as ell_relax does, are later work.

#include <cuda_runtime.h>

namespace {

constexpr int INF = 1 << 30;
constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 8;  // rows a block
constexpr int FW = 4;     // next-hop words a block accumulates

__device__ __forceinline__ int add32(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

// Lane `lane` of the slot's mask word of tile `tile` (every edge up without a mask).
__device__ __forceinline__ bool edge_up(const int* __restrict__ mask, int e, int words,
                                        int tile, int lane) {
  return mask == nullptr || (((unsigned)__ldg(mask + (long)e * words + tile) >> lane) & 1u);
}

// The (dist, src) argmin over the DAG slots, with the winner's hops.
__device__ __forceinline__ void argmin(int d, int u, int h, int& pd, int& ps, int& ph) {
  if (d < pd || (d == pd && u < ps)) {
    pd = d;
    ps = u;
    ph = h;
  }
}

// PACKED: the interleaved layout (state in `dist`, `hops` and `nh` NULL).
template <bool PACKED>
__global__ void __launch_bounds__(WARPS * 32)
ell_fused_round(const int* __restrict__ src, const int* __restrict__ cost,
                const int* __restrict__ slot, const int* __restrict__ mask,
                const int* __restrict__ direct, const int* __restrict__ inc,
                const int* __restrict__ roots, const int* __restrict__ dist,
                const int* __restrict__ hops, const int* __restrict__ nh,
                int* __restrict__ dist_out, int* __restrict__ hops_out,
                int* __restrict__ nh_out, int* __restrict__ parent,
                int* __restrict__ changed, int n, int k, int lanes, int nwords) {
  const int lane = threadIdx.x & 31;
  const long v = (long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (v >= n) return;  // warp-uniform
  const int tile = blockIdx.y;
  const int b = tile * 32 + lane;
  const bool on = b < lanes;
  const int words = (lanes + 31) / 32;
  const int w0 = blockIdx.z * FW;
  const int nw = min(FW, nwords - w0);
  const int c = 2 + nwords;  // interleaved stride
  const long me = v * lanes + b;
  const long row = v * k;

  int d_old = INF, h_old = 0;
  unsigned old[FW];
#pragma unroll
  for (int w = 0; w < FW; ++w) old[w] = 0u;
  if (on) {
    if constexpr (PACKED) {
      d_old = __ldg(dist + me * c);
      h_old = __ldg(dist + me * c + 1);
#pragma unroll
      for (int w = 0; w < FW; ++w)
        if (w < nw) old[w] = (unsigned)__ldg(dist + me * c + 2 + w0 + w);
    } else {
      d_old = __ldg(dist + me);
      h_old = __ldg(hops + me);
#pragma unroll
      for (int w = 0; w < FW; ++w)
        if (w < nw) old[w] = (unsigned)__ldg(nh + (v * nwords + w0 + w) * lanes + b);
    }
  }
  const bool not_root = on && (int)v != __ldg(roots + b);

  int best = d_old;
  int pd = INF, ps = n, ph = n + 1;
  unsigned acc[FW];
#pragma unroll
  for (int w = 0; w < FW; ++w) acc[w] = 0u;

  if constexpr (!PACKED) {
    // Pass 1: the row minimum.
    for (int j = 0; j < k; ++j) {
      const int e = __ldg(slot + row + j);
      if (e < 0 || !on || !edge_up(mask, e, words, tile, lane)) continue;
      const int d = __ldg(dist + (long)__ldg(src + row + j) * lanes + b);
      if (d < INF) best = min(best, add32(d, __ldg(cost + row + j)));
    }
    // Pass 2: the DAG slots, against the new distance.
    if (not_root && best < INF) {
      for (int j = 0; j < k; ++j) {
        const int e = __ldg(slot + row + j);
        if (e < 0 || !edge_up(mask, e, words, tile, lane)) continue;
        const int u = __ldg(src + row + j);
        const int d = __ldg(dist + (long)u * lanes + b);
        if (d >= INF || add32(d, __ldg(cost + row + j)) != best) continue;
        const int h = __ldg(hops + (long)u * lanes + b);
        argmin(d, u, h, pd, ps, ph);
        if (h == 0) {
#pragma unroll
          for (int w = 0; w < FW; ++w)
            if (w < nw) acc[w] |= (unsigned)__ldg(direct + (row + j) * nwords + w0 + w);
        } else {
#pragma unroll
          for (int w = 0; w < FW; ++w)
            if (w < nw) acc[w] |= (unsigned)__ldg(nh + ((long)u * nwords + w0 + w) * lanes + b);
        }
      }
    }
  } else {
    // One pass over a running best.
    for (int j = 0; j < k; ++j) {
      const int e = __ldg(slot + row + j);
      if (e < 0 || !on || !edge_up(mask, e, words, tile, lane)) continue;
      const int u = __ldg(src + row + j);
      const long at = ((long)u * lanes + b) * c;
      const int d = __ldg(dist + at);
      if (d >= INF) continue;
      const int cand = add32(d, __ldg(cost + row + j));
      if (cand > best) continue;
      if (cand < best) {
        best = cand;
        pd = INF;
        ps = n;
        ph = n + 1;
#pragma unroll
        for (int w = 0; w < FW; ++w) acc[w] = 0u;
      }
      if (!not_root || cand >= INF) continue;
      const int h = __ldg(dist + at + 1);
      unsigned x[FW];
#pragma unroll
      for (int w = 0; w < FW; ++w)
        if (w < nw) x[w] = (unsigned)__ldg(dist + at + 2 + w0 + w);
      argmin(d, u, h, pd, ps, ph);
      if (h == 0) {
#pragma unroll
        for (int w = 0; w < FW; ++w)
          if (w < nw) acc[w] |= (unsigned)__ldg(direct + (row + j) * nwords + w0 + w);
      } else {
#pragma unroll
        for (int w = 0; w < FW; ++w)
          if (w < nw) acc[w] |= x[w];
      }
    }
  }

  bool moved = false;
  if (on) {
    const int hn = !not_root ? 0 : (ps < n && ph < n + 1 ? ph + __ldg(inc + v) : n + 1);
#pragma unroll
    for (int w = 0; w < FW; ++w)
      if (w < nw) moved |= acc[w] != old[w];
    if (blockIdx.z == 0) {
      moved |= best != d_old || hn != h_old;
      parent[me] = ps;
    }
    if constexpr (PACKED) {
      if (blockIdx.z == 0) {
        dist_out[me * c] = best;
        dist_out[me * c + 1] = hn;
      }
#pragma unroll
      for (int w = 0; w < FW; ++w)
        if (w < nw) dist_out[me * c + 2 + w0 + w] = (int)acc[w];
    } else {
      if (blockIdx.z == 0) {
        dist_out[me] = best;
        hops_out[me] = hn;
      }
#pragma unroll
      for (int w = 0; w < FW; ++w)
        if (w < nw) nh_out[(v * nwords + w0 + w) * lanes + b] = (int)acc[w];
    }
  }
  if (__any_sync(FULL, moved) && lane == 0) *changed = 1;
}

}  // namespace

extern "C" {

int holo_ell_fused_round(const void* src, const void* cost, const void* slot,
                         const void* mask, const void* direct, const void* inc,
                         const void* roots, const void* dist, const void* hops,
                         const void* nh, void* dist_out, void* hops_out, void* nh_out,
                         void* parent, void* changed, int n, int k, int lanes, int nwords,
                         int packed, void* stream) {
  if (n == 0 || lanes == 0) return 0;
  const dim3 grid((unsigned)((n + WARPS - 1) / WARPS), (unsigned)((lanes + 31) / 32),
                  (unsigned)((nwords + FW - 1) / FW));
  const cudaStream_t st = (cudaStream_t)stream;
  const int *s = (const int*)src, *co = (const int*)cost, *sl = (const int*)slot,
            *m = (const int*)mask, *di = (const int*)direct, *ic = (const int*)inc,
            *r = (const int*)roots, *d = (const int*)dist, *h = (const int*)hops,
            *x = (const int*)nh;
  int *dout = (int*)dist_out, *hout = (int*)hops_out, *xout = (int*)nh_out,
      *p = (int*)parent, *ch = (int*)changed;
  if (packed) {
    ell_fused_round<true><<<grid, WARPS * 32, 0, st>>>(
        s, co, sl, m, di, ic, r, d, h, x, dout, hout, xout, p, ch, n, k, lanes, nwords);
  } else {
    ell_fused_round<false><<<grid, WARPS * 32, 0, st>>>(
        s, co, sl, m, di, ic, r, d, h, x, dout, hout, xout, p, ch, n, k, lanes, nwords);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
