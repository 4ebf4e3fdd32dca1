// Fused ranked-query tail: per (query, candidate), probe every tail term's
// epsilon-window lanes, add the matched impacts to the partial score, mask
// by the floor; then per query k argmax peels -> (Q, k) ids and scores.
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
// candidates; the peel re-reads each row's C scores k times from L2.
//
// Design: two kernels on one stream, launched by one call.  score_kernel
// gives one thread to each (query, candidate) and loops over the T slots
// and only the lanes j < wlen: padded lanes are never read, so whatever
// they hold cannot match.  Ids are compared in int64, so a lane's sum
// cannot wrap into a false match.  The segment line is
// __float2int_rn(__fmul_rn(...)): one float32 multiply rounded half to even,
// no FMA contraction, like jnp.rint.  Unpack shifts stay in 0..31: the
// second word is shifted in only when off > 0, and width 32 takes the
// all-ones mask.  Scores go to a global scratch row per query.  peel_kernel
// runs one CTA per query: each of the k rounds is a block-wide max over
// 64-bit keys (score << 32 | ~index), so the largest score wins and, among
// equal scores, the smallest index; thread 0 writes the slot and zeroes the
// cell.  Rows are peeled independently, as blocks run in no order.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int SCORE_THREADS = 256;
constexpr int PEEL_THREADS = 512;

__device__ __forceinline__ uint32_t unpack(uint32_t lo, uint32_t hi, uint32_t shift,
                                           uint32_t mask) {
  const uint32_t up = shift > 0 ? hi << (32u - shift) : 0u;
  return ((lo >> shift) | up) & mask;
}

__device__ __forceinline__ uint32_t width_mask(uint32_t w) {
  return w >= 32 ? 0xffffffffu : (1u << w) - 1u;
}

__global__ void __launch_bounds__(SCORE_THREADS)
score_kernel(const uint32_t* __restrict__ width, const int32_t* __restrict__ cmin,
             const int32_t* __restrict__ rlo, const int32_t* __restrict__ wlen,
             const int32_t* __restrict__ start, const int32_t* __restrict__ base,
             const float* __restrict__ slope, const uint32_t* __restrict__ clo,
             const uint32_t* __restrict__ chi, const uint32_t* __restrict__ plo,
             const uint32_t* __restrict__ phi, const int32_t* __restrict__ cand,
             const int32_t* __restrict__ part, const int32_t* __restrict__ floors,
             int32_t* __restrict__ alive, int Q, int T, int C, int W, int pbits) {
  const int64_t idx = (int64_t)blockIdx.x * SCORE_THREADS + threadIdx.x;
  if (idx >= (int64_t)Q * C) return;
  const int q = (int)(idx / C), c = (int)(idx % C);
  const int64_t cd = cand[idx];
  const uint32_t pmask = width_mask((uint32_t)pbits);
  int32_t s = part[idx];
  for (int t = 0; t < T; ++t) {
    const size_t qt = (size_t)q * T + t;
    const size_t cell = qt * C + c;
    const int n = min(wlen[cell], W);
    if (n <= 0) continue;
    const uint32_t w = width[qt];
    const uint32_t cmask = width_mask(w);
    const int64_t cm = cmin[qt];
    const int lo = rlo[cell], st = start[cell];
    const int64_t b = base[cell];
    const float sl = slope[cell];
    const size_t lane0 = cell * W;
    for (int j = 0; j < n; ++j) {
      const int r = lo + j;
      const int64_t pred = b + __float2int_rn(__fmul_rn(sl, (float)(r - st)));
      const uint32_t cshift = ((uint32_t)r * w) & 31u;
      const int32_t corr = (int32_t)unpack(clo[lane0 + j], chi[lane0 + j], cshift, cmask);
      if (pred + corr + cm == cd) {
        const uint32_t pshift = ((uint32_t)r * (uint32_t)pbits) & 31u;
        s += (int32_t)unpack(plo[lane0 + j], phi[lane0 + j], pshift, pmask);
      }
    }
  }
  alive[idx] = s > floors[q] ? s : 0;
}

__global__ void __launch_bounds__(PEEL_THREADS)
peel_kernel(const int32_t* __restrict__ cand, int32_t* __restrict__ alive,
            int32_t* __restrict__ out_ids, int32_t* __restrict__ out_scores, int C, int k) {
  __shared__ unsigned long long warp_best[PEEL_THREADS / 32];
  __shared__ unsigned long long best;
  const int q = blockIdx.x;
  int32_t* row = alive + (size_t)q * C;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int i = 0; i < k; ++i) {
    unsigned long long key = 0;
    for (int c = threadIdx.x; c < C; c += PEEL_THREADS) {
      const int32_t v = row[c];
      if (v > 0) {
        const unsigned long long kc =
            ((unsigned long long)(uint32_t)v << 32) | (0xffffffffu - (uint32_t)c);
        key = kc > key ? kc : key;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const unsigned long long o = __shfl_down_sync(0xffffffffu, key, off);
      key = o > key ? o : key;
    }
    if (lane == 0) warp_best[warp] = key;
    __syncthreads();
    if (threadIdx.x == 0) {
      unsigned long long m = 0;
      for (int w = 0; w < PEEL_THREADS / 32; ++w) m = warp_best[w] > m ? warp_best[w] : m;
      best = m;
      const size_t slot = (size_t)q * k + i;
      if (m == 0) {
        out_ids[slot] = -1;
        out_scores[slot] = 0;
      } else {
        const int c = (int)(0xffffffffu - (uint32_t)(m & 0xffffffffu));
        out_ids[slot] = cand[(size_t)q * C + c];
        out_scores[slot] = (int32_t)(m >> 32);
        row[c] = 0;
      }
    }
    __syncthreads();
    if (best == 0) {  // nothing left above the floor: the other slots stay empty
      for (int j = i + 1 + threadIdx.x; j < k; j += PEEL_THREADS) {
        out_ids[(size_t)q * k + j] = -1;
        out_scores[(size_t)q * k + j] = 0;
      }
      return;
    }
  }
}

}  // namespace

extern "C" int fused_topk_launch(const uint32_t* width, const int32_t* cmin, const int32_t* rlo,
                                 const int32_t* wlen, const int32_t* start, const int32_t* base,
                                 const float* slope, const uint32_t* clo, const uint32_t* chi,
                                 const uint32_t* plo, const uint32_t* phi, const int32_t* cand,
                                 const int32_t* part, const int32_t* floors, int32_t* alive,
                                 int32_t* out_ids, int32_t* out_scores, int Q, int T, int C,
                                 int W, int k, int pbits, cudaStream_t stream) {
  if (Q > 0 && C > 0) {
    const int64_t cells = (int64_t)Q * C;
    const int blocks = (int)((cells + SCORE_THREADS - 1) / SCORE_THREADS);
    score_kernel<<<blocks, SCORE_THREADS, 0, stream>>>(width, cmin, rlo, wlen, start, base,
                                                        slope, clo, chi, plo, phi, cand, part,
                                                        floors, alive, Q, T, C, W, pbits);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if (k > 0) peel_kernel<<<Q, PEEL_THREADS, 0, stream>>>(cand, alive, out_ids, out_scores, C, k);
  }
  return (int)cudaGetLastError();
}
