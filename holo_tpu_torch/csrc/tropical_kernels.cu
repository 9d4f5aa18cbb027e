// The tropical (min-plus) tile relax T1 of the tropical SPF engine for Hopper
// (sm_90a), plain C interface for ctypes.
//
//   trop_relax <- holo_tpu/ops/tropical.py:423-464, the body of _tile_relax's
//                 lax.while_loop (an XLA fusion; the JAX package has no
//                 Pallas kernel there): one round of the blocked min-plus
//                 fixpoint over S independent lanes
//
// Planes (int32, INF = 1<<30 unreachable), in the tiles' permuted vertex
// space padded to NB*B rows: tiles [NB, Tm, B, B] (tiles[rb, t, i, j] = the
// least cost of an edge cb[rb, t]*B + j -> rb*B + i, INF where none); cb
// [NB, Tm] (NB for a padding slot); dist [NB*B, S], lanes minor; active
// [NB, ceil(S/32)] (bit s%32 of word [c, s/32]: a row of block c changed in
// lane s in the round before); repair [NB*B, ceil(S/32)] or NULL (bit s of
// word [p, s/32]: row p's value in lane s is the exact masked ELL relax).
// The repair rows read the ELL planes src, cost, slot [N, K] (slot = edge id,
// -1 for padding), the mask words [E, ceil(S/32)] (NULL: every edge up), perm
// [NB*B] (permuted row -> vertex) and inv [N] (vertex -> permuted row).
//
// One round, per (row block rb, lane s):
//   agg[rb*B + i, s] = min over slots t with cb != NB and block cb active in
//                      lane s, and over j, of tiles[rb, t, i, j] + dist[cb*B
//                      + j, s], saturated at INF;
//   a repair (row, lane) takes the exact masked ELL row relax instead;
//   new = min(dist, agg); active_out marks the (block, lane)s of a change;
//   changed is set if any value changed.
// Every operand is at most INF = 2^30, so a sum is at most 2^31: the adds are
// unsigned (in int32, INF + INF would wrap negative and win the min) and the
// least sum is clamped to INF at the end, as tropical.py:409-418 says.
//
// What bounds it.  A round with every block active at the k=90 fat tree x
// 1024 lanes does 53,524 tiles x 64 entries x 1024 lanes = 3.5 G (add, min)
// pairs: 7.0 G operations, 0.21 ms at the card's int32 rate, against ~0.03 ms
// for its bytes (each tile and each source block's lanes read once, dist in
// and out).  So it is bound by operations, and by shared-memory reads that
// feed them: per entry a thread reads its tile word (a broadcast) and its
// source's lane word.
//
// Tile form (more than SMALL lanes).  A block of 8 warps owns one row block
// and 32 lanes (one lane a thread; blocks of one row block are adjacent in
// the grid, so its tiles come from L2 after the first).  Warp 0 lists the
// slots whose source block is active in some lane of the group (a ballot
// per 32 slots); the block stages up to CH listed slots at a time in shared
// memory -- the B x B tile (int4 copies) and the source block's B rows x 32
// lanes, INF in a lane where the block is inactive -- and each thread keeps
// a running minimum for its B/8 rows, reading four tile words as one uint4
// broadcast per source word.  A skipped slot costs one word of cb and of
// active.  Then each thread applies the repair rows of its lane, writes its
// rows and votes; the block's vote is the active_out word, written whole (no
// zero fill, no atomics in device memory).
//
// Row form (up to SMALL lanes: compute() is one lane).  A block owns one row
// block; each warp takes rows i = warp, warp + 8, ...: its threads split the
// row's Tm x B (slot, j) entries, each keeping a minimum per lane, then
// meet in __reduce_min_sync; thread s finishes lane s.
//
// Changed flag: a block with a change stores 1; the wrapper zeroes the flag.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned INF = 1u << 30;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SMALL = 8;   // lane counts up to this run the row form
constexpr int LIST = 256;  // listed slots a pass of the tile form

// Slots staged at once in the tile form; each takes B*B + 32*B words.
template <int B>
__host__ __device__ constexpr int stage_slots() {
  return B <= 16 ? 16 : (B == 32 ? 4 : (B == 64 ? 2 : 1));
}

template <int B>
__host__ __device__ constexpr int smem_bytes() {
  return stage_slots<B>() * (B * B + 32 * B) * (int)sizeof(unsigned);
}

// The exact masked ELL relax of permuted row p in lane `lane` (repair):
// tropical.py:449-457.  int32 adds, as JAX's.
__device__ __forceinline__ int repair_value(int p, int lane, int lanes, int words,
                                            const int* __restrict__ src,
                                            const int* __restrict__ cost,
                                            const int* __restrict__ slot,
                                            const int* __restrict__ mask,
                                            const int* __restrict__ perm,
                                            const int* __restrict__ inv,
                                            const int* __restrict__ dist, int k) {
  const size_t v = (size_t)perm[p] * k;
  int best = (int)INF;
  for (int j = 0; j < k; ++j) {
    const int e = slot[v + j];
    if (e < 0) continue;
    if (mask != nullptr && !((mask[(size_t)e * words + (lane >> 5)] >> (lane & 31)) & 1)) continue;
    const int d = dist[(size_t)inv[src[v + j]] * lanes + lane];
    if (d < (int)INF) best = min(best, d + cost[v + j]);
  }
  return best;
}

template <int B>
__global__ void __launch_bounds__(THREADS)
    trop_relax_tile(const int* __restrict__ tiles, const int* __restrict__ cb,
                    const int* __restrict__ dist, const int* __restrict__ active,
                    const int* __restrict__ repair, const int* __restrict__ src,
                    const int* __restrict__ cost, const int* __restrict__ slot,
                    const int* __restrict__ mask, const int* __restrict__ perm,
                    const int* __restrict__ inv, int* __restrict__ out,
                    int* __restrict__ changed, int* __restrict__ active_out, int nb, int tm,
                    int lanes, int k) {
  constexpr int R = B / WARPS;  // rows a thread
  constexpr int CH = stage_slots<B>();
  extern __shared__ __align__(16) unsigned smem[];
  unsigned* tile_s = smem;               // [CH][B][B]
  unsigned* src_s = smem + CH * B * B;   // [CH][B][32]
  __shared__ int list[LIST];
  __shared__ int list_n, list_next;
  __shared__ unsigned moved_word;

  const int words = (lanes + 31) >> 5;
  const int rb = blockIdx.x / words;
  const int g = blockIdx.x % words;  // the 32-lane group
  const int warp = threadIdx.x >> 5, l = threadIdx.x & 31;
  const int lane = g * 32 + l;
  const size_t slot0 = (size_t)rb * tm;

  unsigned acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0xffffffffu;
  if (threadIdx.x == 0) moved_word = 0;

  int t0 = 0;
  while (t0 < tm) {
    if (warp == 0) {
      int cnt = 0, t = t0;
      for (; t < tm && cnt + 32 <= LIST; t += 32) {
        const int tt = t + l;
        bool ok = false;
        if (tt < tm) {
          const int c = cb[slot0 + tt];
          ok = c < nb && active[(size_t)c * words + g] != 0;
        }
        const unsigned bal = __ballot_sync(0xffffffffu, ok);
        if (ok) list[cnt + __popc(bal & ((1u << l) - 1u))] = tt;
        cnt += __popc(bal);
      }
      if (l == 0) {
        list_n = cnt;
        list_next = t;
      }
    }
    __syncthreads();
    const int cnt = list_n;
    t0 = list_next;
    for (int base = 0; base < cnt; base += CH) {
      const int m = min(CH, cnt - base);
      constexpr int V = B * B / 4;  // int4 vectors a tile
      for (int idx = threadIdx.x; idx < m * V; idx += THREADS) {
        const int q = idx / V, rem = idx % V;
        const int4 w = reinterpret_cast<const int4*>(tiles + (slot0 + list[base + q]) * B * B)[rem];
        reinterpret_cast<int4*>(tile_s + q * B * B)[rem] = w;
      }
      for (int idx = threadIdx.x; idx < m * B * 32; idx += THREADS) {
        const int q = idx / (B * 32), j = (idx >> 5) % B, x = idx & 31;
        const int c = cb[slot0 + list[base + q]];
        const int ln = g * 32 + x;
        unsigned d = INF;
        if (ln < lanes && ((active[(size_t)c * words + g] >> x) & 1))
          d = (unsigned)dist[((size_t)c * B + j) * lanes + ln];
        src_s[(q * B + j) * 32 + x] = d;
      }
      __syncthreads();
      for (int q = 0; q < m; ++q) {
        const unsigned* ts = tile_s + q * B * B;
        const unsigned* ss = src_s + q * B * 32;
#pragma unroll 2
        for (int j = 0; j < B; j += 4) {
          const unsigned d0 = ss[j * 32 + l], d1 = ss[(j + 1) * 32 + l];
          const unsigned d2 = ss[(j + 2) * 32 + l], d3 = ss[(j + 3) * 32 + l];
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const uint4 w = *reinterpret_cast<const uint4*>(ts + (warp + r * WARPS) * B + j);
            acc[r] = min(acc[r], min(min(w.x + d0, w.y + d1), min(w.z + d2, w.w + d3)));
          }
        }
      }
      __syncthreads();
    }
    __syncthreads();  // list_n and list_next are read before the next pass writes them
  }

  bool moved = false;
  if (lane < lanes) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int p = rb * B + warp + r * WARPS;
      const size_t at = (size_t)p * lanes + lane;
      const int old = dist[at];
      int agg = (int)min(acc[r], INF);
      if (repair != nullptr && ((repair[(size_t)p * words + g] >> l) & 1))
        agg = repair_value(p, lane, lanes, words, src, cost, slot, mask, perm, inv, dist, k);
      const int nw = min(old, agg);
      out[at] = nw;
      moved |= nw != old;
    }
  }
  const unsigned bal = __ballot_sync(0xffffffffu, moved);
  if (l == 0 && bal != 0) atomicOr(&moved_word, bal);
  __syncthreads();
  if (threadIdx.x == 0) {
    active_out[(size_t)rb * words + g] = (int)moved_word;
    if (moved_word != 0) changed[0] = 1;
  }
}

template <int B>
__global__ void __launch_bounds__(THREADS)
    trop_relax_rows(const int* __restrict__ tiles, const int* __restrict__ cb,
                    const int* __restrict__ dist, const int* __restrict__ active,
                    const int* __restrict__ repair, const int* __restrict__ src,
                    const int* __restrict__ cost, const int* __restrict__ slot,
                    const int* __restrict__ mask, const int* __restrict__ perm,
                    const int* __restrict__ inv, int* __restrict__ out,
                    int* __restrict__ changed, int* __restrict__ active_out, int nb, int tm,
                    int lanes, int k) {
  __shared__ unsigned moved_word;
  const int rb = blockIdx.x;
  const int warp = threadIdx.x >> 5, l = threadIdx.x & 31;
  const size_t slot0 = (size_t)rb * tm;
  if (threadIdx.x == 0) moved_word = 0;
  __syncthreads();
  unsigned moved = 0;  // lane bits of this warp's rows that changed
  for (int i = warp; i < B; i += WARPS) {
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
    if (l < lanes) {
      if (repair != nullptr && ((repair[p] >> l) & 1))
        agg_l = repair_value(p, l, lanes, 1, src, cost, slot, mask, perm, inv, dist, k);
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

template <int B>
int launch(const int* tiles, const int* cb, const int* dist, const int* active,
           const int* repair, const int* src, const int* cost, const int* slot,
           const int* mask, const int* perm, const int* inv, int* out, int* changed,
           int* active_out, int nb, int tm, int lanes, int k, cudaStream_t st) {
  if (lanes <= SMALL) {
    trop_relax_rows<B><<<nb, THREADS, 0, st>>>(tiles, cb, dist, active, repair, src, cost,
                                               slot, mask, perm, inv, out, changed,
                                               active_out, nb, tm, lanes, k);
    return (int)cudaGetLastError();
  }
  const int smem = smem_bytes<B>();
  const int rc = (int)cudaFuncSetAttribute(trop_relax_tile<B>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != 0) return rc;
  const long long blocks = (long long)nb * ((lanes + 31) / 32);
  trop_relax_tile<B><<<(unsigned)blocks, THREADS, smem, st>>>(
      tiles, cb, dist, active, repair, src, cost, slot, mask, perm, inv, out, changed,
      active_out, nb, tm, lanes, k);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int holo_trop_relax(const void* tiles, const void* cb, const void* dist, const void* active,
                    const void* repair, const void* src, const void* cost, const void* slot,
                    const void* mask, const void* perm, const void* inv, void* out,
                    void* changed, void* active_out, int nb, int tm, int b, int lanes, int k,
                    void* stream) {
  if (nb <= 0 || tm <= 0 || lanes <= 0) return 0;
  const int *t = (const int*)tiles, *c = (const int*)cb, *d = (const int*)dist;
  const int *a = (const int*)active, *rp = (const int*)repair, *s = (const int*)src;
  const int *co = (const int*)cost, *sl = (const int*)slot, *m = (const int*)mask;
  const int *pm = (const int*)perm, *iv = (const int*)inv;
  int *o = (int*)out, *ch = (int*)changed, *ao = (int*)active_out;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (b) {
    case 8:
      return launch<8>(t, c, d, a, rp, s, co, sl, m, pm, iv, o, ch, ao, nb, tm, lanes, k, st);
    case 16:
      return launch<16>(t, c, d, a, rp, s, co, sl, m, pm, iv, o, ch, ao, nb, tm, lanes, k, st);
    case 32:
      return launch<32>(t, c, d, a, rp, s, co, sl, m, pm, iv, o, ch, ao, nb, tm, lanes, k, st);
    case 64:
      return launch<64>(t, c, d, a, rp, s, co, sl, m, pm, iv, o, ch, ao, nb, tm, lanes, k, st);
    case 128:
      return launch<128>(t, c, d, a, rp, s, co, sl, m, pm, iv, o, ch, ao, nb, tm, lanes, k, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
