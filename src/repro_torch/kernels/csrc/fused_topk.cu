// Fused ranked-query tail: per (query, candidate), probe every tail term's
// epsilon-window lanes, add the matched impacts to the partial score, mask
// by the floor; then per query the top k -> (Q, k) ids and scores.
// Per lane j < wlen of slot (q, t, c), at rank r = rlo + j:
//   id  = base + rint(slope * f32(r - start)) + unpack(clo, chi, r*w, w) + cmin
//   imp = unpack(plo, phi, r*pbits, pbits),  added when id == cand[q, c].
// An empty slot is id -1, score 0; ties go to the smaller candidate index
// (candidates ascend, so to the smaller doc id).
//
// Replaces: src/repro/kernels/fused_query/kernel.py, fused_topk (4 query
// rows per grid step over the whole padded (T, C, W) tile, the top-k heap in
// VMEM scratch).
//
// What bounds it on the H100: memory, the tile bytes of the true lanes and
// candidates, read once; then the k rounds of the row merge, which are
// serial in k and short.
//
// Design: two kernels on one stream, launched by one call.  Every order is
// by one 64-bit key per candidate, (score << 32) | ~c with c its index in the
// row, so the largest score wins and, among equal scores, the smallest index;
// a key of 0 is "nothing" (scores <= 0 never enter).
// - select_kernel: one block of 256 threads per slice of 1,024 candidates of
//   one row, so a long row spreads over the whole card.  Each thread scores
//   4 candidates into registers: it loops over the T slots and only the
//   lanes j < wlen (padded lanes are never read, so whatever they hold cannot
//   match); ids compare in int64, so a lane's sum cannot wrap into a false
//   match; the segment line is __float2int_rn(__fmul_rn(...)), one float32
//   multiply rounded half to even, no FMA contraction, like jnp.rint; unpack
//   shifts stay in 0..31.  Then each warp peels the top min(k, 128) of its
//   128 keys (each lane's 4 keys sorted in registers, two __reduce_max_sync
//   per round: score, then ~c among equal scores), and warp 0 merges the 8
//   sorted warp lists into the slice's sorted top min(k, 1,024).  The
//   slice's list goes to a (Q, S, kk) scratch, ended by a 0 key when
//   shorter: the full (Q, C) score row is never written.
// - merge_kernel: one block per row merges the row's S sorted lists; each
//   thread owns lists t, t + blockDim, ... and its best head, and each of
//   the k rounds is one block-wide max over the heads.  The winner advances
//   its list (positions in a (Q, S) scratch that the owner alone touches, set
//   at the start of the launch, so CUDA-graph replays need no reset).  Once
//   the best head is 0 the rest of the row's slots are empty.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int SEL_THREADS = 256;
constexpr int PER_THREAD = 4;
constexpr int SLICE = SEL_THREADS * PER_THREAD;  // candidates per select block
constexpr int WARP_SLICE = 32 * PER_THREAD;
constexpr int WARPS = SEL_THREADS / 32;
constexpr int MAX_MERGE_THREADS = 1024;
constexpr unsigned FULL = 0xffffffffu;

typedef unsigned long long u64;

__device__ __forceinline__ uint32_t unpack(uint32_t lo, uint32_t hi, uint32_t shift,
                                           uint32_t mask) {
  const uint32_t up = shift > 0 ? hi << (32u - shift) : 0u;
  return ((lo >> shift) | up) & mask;
}

__device__ __forceinline__ uint32_t width_mask(uint32_t w) {
  return w >= 32 ? 0xffffffffu : (1u << w) - 1u;
}

// the warp's largest key: two 32-bit reductions, score first, then ~c
__device__ __forceinline__ u64 warp_max(u64 key) {
  const uint32_t hi = (uint32_t)(key >> 32);
  const uint32_t top = __reduce_max_sync(FULL, hi);
  const uint32_t lo = __reduce_max_sync(FULL, hi == top ? (uint32_t)key : 0u);
  return ((u64)top << 32) | lo;
}

__device__ __forceinline__ void swap_desc(u64& a, u64& b) {
  const u64 hi = a > b ? a : b, lo = a > b ? b : a;
  a = hi;
  b = lo;
}

struct Tiles {
  const uint32_t* width;
  const int32_t *cmin, *rlo, *wlen, *start, *base;
  const float* slope;
  const uint32_t *clo, *chi, *plo, *phi;
  const int32_t *cand, *part, *floors;
};

// lane j of slot (cell, t): its impact when its id equals cd, else 0
__device__ __forceinline__ int32_t lane_impact(uint32_t cl, uint32_t ch, uint32_t pl, uint32_t ph,
                                               int r, int st, int64_t b, float sl, uint32_t w,
                                               uint32_t cmask, int64_t cm, int64_t cd,
                                               uint32_t pbits, uint32_t pmask) {
  const int64_t pred = b + __float2int_rn(__fmul_rn(sl, (float)(r - st)));
  const int32_t corr = (int32_t)unpack(cl, ch, ((uint32_t)r * w) & 31u, cmask);
  if (pred + corr + cm != cd) return 0;
  return (int32_t)unpack(pl, ph, ((uint32_t)r * pbits) & 31u, pmask);
}

// the masked scores (s > floor ? s : 0) of candidates c0 + 32 r, r < 4, of
// row q.  The four candidates advance through each slot together, so their
// loads are in flight at once: window length, then the slot's segment
// line, then its first lane's four words; later lanes follow one by one.
__device__ void score4(const Tiles& tl, int q, int c0, int T, int C, int W, int pbits,
                       int32_t out[PER_THREAD]) {
  const uint32_t pmask = width_mask((uint32_t)pbits);
  int64_t cd[PER_THREAD];
  int32_t s[PER_THREAD];
#pragma unroll
  for (int r = 0; r < PER_THREAD; ++r) {
    const int c = c0 + 32 * r;
    const size_t qc = (size_t)q * C + c;
    cd[r] = c < C ? tl.cand[qc] : 0;
    s[r] = c < C ? tl.part[qc] : 0;
  }
  for (int t = 0; t < T; ++t) {
    const size_t qt = (size_t)q * T + t;
    int n[PER_THREAD];
#pragma unroll
    for (int r = 0; r < PER_THREAD; ++r) {
      const int c = c0 + 32 * r;
      n[r] = c < C ? min(tl.wlen[qt * C + c], W) : 0;
    }
    if (max(max(n[0], n[1]), max(n[2], n[3])) <= 0) continue;
    const uint32_t w = tl.width[qt];
    const uint32_t cmask = width_mask(w);
    const int64_t cm = tl.cmin[qt];
    int lo[PER_THREAD] = {}, st[PER_THREAD] = {};
    int64_t b[PER_THREAD] = {};
    float sl[PER_THREAD] = {};
    uint32_t cl[PER_THREAD] = {}, ch[PER_THREAD] = {}, pl[PER_THREAD] = {}, ph[PER_THREAD] = {};
#pragma unroll
    for (int r = 0; r < PER_THREAD; ++r) {
      if (n[r] > 0) {
        const size_t cell = qt * C + c0 + 32 * r, lane0 = cell * W;
        lo[r] = tl.rlo[cell];
        st[r] = tl.start[cell];
        b[r] = tl.base[cell];
        sl[r] = tl.slope[cell];
        cl[r] = tl.clo[lane0];
        ch[r] = tl.chi[lane0];
        pl[r] = tl.plo[lane0];
        ph[r] = tl.phi[lane0];
      }
    }
#pragma unroll
    for (int r = 0; r < PER_THREAD; ++r) {
      if (n[r] <= 0) continue;
      s[r] += lane_impact(cl[r], ch[r], pl[r], ph[r], lo[r], st[r], b[r], sl[r], w, cmask, cm,
                          cd[r], (uint32_t)pbits, pmask);
      const size_t lane0 = (qt * C + c0 + 32 * r) * W;
      for (int j = 1; j < n[r]; ++j)
        s[r] += lane_impact(tl.clo[lane0 + j], tl.chi[lane0 + j], tl.plo[lane0 + j],
                            tl.phi[lane0 + j], lo[r] + j, st[r], b[r], sl[r], w, cmask, cm,
                            cd[r], (uint32_t)pbits, pmask);
    }
  }
  const int32_t f = tl.floors[q];
#pragma unroll
  for (int r = 0; r < PER_THREAD; ++r) out[r] = s[r] > f ? s[r] : 0;
}

__global__ void __launch_bounds__(SEL_THREADS)
select_kernel(Tiles tl, u64* __restrict__ lists, int T, int C, int W, int pbits, int kk) {
  __shared__ u64 warp_list[WARPS][WARP_SLICE];
  const int q = blockIdx.y, s = blockIdx.x;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int c0 = s * SLICE + warp * WARP_SLICE + lane;

  // this lane's 4 keys (candidates c0, c0+32, c0+64, c0+96), sorted descending
  int32_t v[PER_THREAD];
  score4(tl, q, c0, T, C, W, pbits, v);
  u64 key[PER_THREAD];
#pragma unroll
  for (int r = 0; r < PER_THREAD; ++r) {
    const uint32_t c = (uint32_t)(c0 + 32 * r);
    key[r] = v[r] > 0 ? ((u64)(uint32_t)v[r] << 32) | (0xffffffffu - c) : 0ull;
  }
  swap_desc(key[0], key[1]);
  swap_desc(key[2], key[3]);
  swap_desc(key[0], key[2]);
  swap_desc(key[1], key[3]);
  swap_desc(key[1], key[2]);

  // each warp: the sorted top min(kk, 128) of its 128 keys, 0-terminated
  const int kw = min(kk, WARP_SLICE);
  for (int i = 0; i < kw; ++i) {
    const u64 m = warp_max(key[0]);
    if (lane == 0) warp_list[warp][i] = m;
    if (m == 0) break;
    if (key[0] == m) {  // keys are unique: exactly one lane pops its head
      key[0] = key[1];
      key[1] = key[2];
      key[2] = key[3];
      key[3] = 0;
    }
  }
  __syncthreads();
  if (warp != 0) return;

  // warp 0: merge the WARPS sorted lists into the slice's top kk
  int pos = 0;
  u64 head = lane < WARPS ? warp_list[lane][0] : 0ull;
  u64* out = lists + ((size_t)q * gridDim.x + s) * kk;
  for (int i = 0; i < kk; ++i) {
    const u64 m = warp_max(head);
    if (lane == 0) out[i] = m;
    if (m == 0) break;
    if (head == m) {
      ++pos;
      head = pos < kw ? warp_list[lane][pos] : 0ull;
    }
  }
}

__global__ void __launch_bounds__(MAX_MERGE_THREADS)
merge_kernel(const u64* __restrict__ lists, int* __restrict__ pos, const int32_t* __restrict__ cand,
             int32_t* __restrict__ out_ids, int32_t* __restrict__ out_scores, int S, int C,
             int kk, int k) {
  __shared__ u64 warp_best[MAX_MERGE_THREADS / 32];
  const int q = blockIdx.x, tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int nwarps = blockDim.x / 32;
  const u64* row = lists + (size_t)q * S * kk;
  int* rpos = pos + (size_t)q * S;

  // this thread's best head over its lists l = tid, tid + blockDim, ...
  u64 best = 0;
  int best_l = -1;
  for (int l = tid; l < S; l += blockDim.x) {
    rpos[l] = 0;
    const u64 h = row[(size_t)l * kk];
    if (h > best) best = h, best_l = l;
  }
  for (int i = 0; i < k; ++i) {
    const u64 wm = warp_max(best);
    if (lane == 0) warp_best[warp] = wm;
    __syncthreads();
    u64 m = 0;
    for (int w = 0; w < nwarps; ++w) m = warp_best[w] > m ? warp_best[w] : m;
    __syncthreads();  // every thread has read warp_best before the next round writes it
    const size_t slot = (size_t)q * k + i;
    if (m == 0) {  // nothing left above the floor: the other slots stay empty
      for (int j = i + tid; j < k; j += blockDim.x) {
        out_ids[(size_t)q * k + j] = -1;
        out_scores[(size_t)q * k + j] = 0;
      }
      return;
    }
    if (best == m) {  // keys are unique: exactly one thread won
      const int c = (int)(0xffffffffu - (uint32_t)(m & 0xffffffffu));
      out_ids[slot] = cand[(size_t)q * C + c];
      out_scores[slot] = (int32_t)(m >> 32);
      ++rpos[best_l];
      best = 0;
      best_l = -1;
      for (int l = tid; l < S; l += blockDim.x) {
        const int pl = rpos[l];
        const u64 h = pl < kk ? row[(size_t)l * kk + pl] : 0ull;
        if (h > best) best = h, best_l = l;
      }
    }
  }
}

}  // namespace

extern "C" int fused_topk_launch(const uint32_t* width, const int32_t* cmin, const int32_t* rlo,
                                 const int32_t* wlen, const int32_t* start, const int32_t* base,
                                 const float* slope, const uint32_t* clo, const uint32_t* chi,
                                 const uint32_t* plo, const uint32_t* phi, const int32_t* cand,
                                 const int32_t* part, const int32_t* floors, u64* lists,
                                 int32_t* pos, int32_t* out_ids, int32_t* out_scores, int Q,
                                 int T, int C, int W, int k, int pbits, cudaStream_t stream) {
  if (Q <= 0 || C <= 0 || k <= 0) return (int)cudaGetLastError();
  const Tiles tl{width, cmin, rlo, wlen, start, base, slope, clo, chi, plo, phi, cand, part,
                 floors};
  const int S = (C + SLICE - 1) / SLICE, kk = k < SLICE ? k : SLICE;
  select_kernel<<<dim3(S, Q), SEL_THREADS, 0, stream>>>(tl, lists, T, C, W, pbits, kk);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int threads = S >= MAX_MERGE_THREADS ? MAX_MERGE_THREADS : (S + 31) / 32 * 32;
  merge_kernel<<<Q, threads, 0, stream>>>(lists, pos, cand, out_ids, out_scores, S, C, kk, k);
  return (int)cudaGetLastError();
}
