// Algorithm 2's candidate step (the paper's two-tier index) in one launch:
// the union of each query's truncated tier-1 lists, kept where f_hat holds
// for every valid term of the query, as a packed candidate bitmap.
//
// Replaces: src/repro/core/algorithms.py, two_tier_query (XLA, not Pallas:
// per query a sort-based padded_union of the (T, k) tier-1 rows, then
// membership.term_doc_logits on the gathered doc rows and a threshold).
//
// two_tier_launch: the shard's (n_terms, k) tier-1 table (row t = the k
// lowest local doc ids of term t, padded), its (n_terms,) row lengths,
// (Q,T) term ids (-1 = pad), the (n_terms,E) term and (D,E) doc embeddings,
// the (n_terms,) thresholds and the bias -> (Q, ceil(D/32)) candidate words:
// bit d of a query's row is set iff d is in some valid slot's tier-1 list
// and (te[t] . de[d]) + bias >= tau[t] for every valid slot t.  A query
// with no valid slot has no bits set; tail bits past D are never set.
//
// The dot product is csrc/membership.cu's, bit for bit: an fp32
// accumulator from 0, fmaf over e = 0..E-1 in order, then + bias, then >=
// tau.  So on the card a two_tier candidate equals the exhaustive
// candidate (membership) AND the tier-1 union, exactly.  A gather plus a
// cuBLAS product would sum in another order and could flip bits next to
// tau; no TF32 and no wgmma, for the reason membership.cu gives.
//
// What bounds it on the H100: at phase A's shapes (Q=128, about 3 valid
// slots a query, k=4,000) memory.  It reads the doc row of every
// candidate (E x 4 = 512 bytes) and writes the (Q, words) bitmap (8.4 MB
// at 528,000 docs); the FMAs (E per candidate and slot) are a fifth of the
// bytes' time or less.  Candidates of different queries share doc rows
// (tier-1 keeps the lowest ids, so frequent terms' lists overlap), which
// L2 can serve.
//
// Design: a CTA takes one query and a share of its candidates: thread 0
// packs the valid slots (term, list length, tau, first position in the
// concatenation of the slots' lists) into shared memory, the CTA copies
// their term rows there, and each thread walks positions of that
// concatenation strided by the grid's width.  A position's doc is scored
// only from the first slot whose list holds it (a binary search in each
// earlier slot's row, read from L1), so each doc of the union is scored
// once.  The other way, OR-ing the lists into the bitmap first and
// scoring the set bits in a second pass, needs a grid-wide barrier or a
// second launch and a sweep of every word of the row; the searches cost
// less than a doc row.  A thread scores its doc against up to 8 slots per
// pass over the row (8 accumulators, the term rows broadcast from shared
// memory), with 16-byte loads where E % 4 == 0.  Bits are set with
// atomicOr into a bitmap the launch zeroes with its own memset, so a
// CUDA-graph replay starts from zero.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_TERMS = 64;  // query slots kept in shared memory
constexpr int GROUP = 8;       // slots scored per pass over a doc row

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
two_tier_kernel(const int32_t* __restrict__ tier1, int k, const int32_t* __restrict__ tier1_len,
                const int32_t* __restrict__ queries, int T, const float* __restrict__ te,
                const float* __restrict__ de, int E, const float* __restrict__ tau, float bias,
                uint32_t* __restrict__ out, int D, int words) {
  extern __shared__ float4 smem4[];
  float* s_te = reinterpret_cast<float*>(smem4);  // [n][E]: the valid slots' term rows
  __shared__ int s_term[MAX_TERMS];
  __shared__ int s_len[MAX_TERMS];
  __shared__ int s_off[MAX_TERMS + 1];  // slot i's first position in the concatenation
  __shared__ float s_tau[MAX_TERMS];
  __shared__ int s_n;
  const int q = blockIdx.y;
  if (threadIdx.x == 0) {
    int n = 0, off = 0;
    for (int t = 0; t < T; ++t) {
      const int term = queries[(size_t)q * T + t];
      if (term < 0) continue;
      const int len = min(tier1_len[term], k);
      s_term[n] = term;
      s_len[n] = len;
      s_tau[n] = tau[term];
      s_off[n] = off;
      off += len;
      ++n;
    }
    s_off[n] = off;
    s_n = n;
  }
  __syncthreads();
  const int n = s_n, total = s_off[n];
  if (blockIdx.x * THREADS >= total) return;  // the same for every thread of the CTA
  for (int i = threadIdx.x; i < n * E; i += THREADS)
    s_te[i] = te[(size_t)s_term[i / E] * E + i % E];
  __syncthreads();

  for (int p = blockIdx.x * THREADS + threadIdx.x; p < total; p += gridDim.x * THREADS) {
    int s = 0;
    while (p >= s_off[s + 1]) ++s;
    const int term = s_term[s];
    const int d = tier1[(size_t)term * k + (p - s_off[s])];
    if ((unsigned)d >= (unsigned)D) continue;
    // scored by the first slot whose list holds d
    bool seen = false;
    for (int r = 0; r < s && !seen; ++r) {
      if (s_term[r] == term) {
        seen = true;
        break;
      }
      const int32_t* row = tier1 + (size_t)s_term[r] * k;
      int lo = 0, hi = s_len[r];
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (row[mid] < d) lo = mid + 1;
        else hi = mid;
      }
      seen = lo < s_len[r] && row[lo] == d;
    }
    if (seen) continue;

    const float* drow = de + (size_t)d * E;
    bool pass = true;
    for (int g = 0; g < n && pass; g += GROUP) {
      float acc[GROUP];
#pragma unroll
      for (int i = 0; i < GROUP; ++i) acc[i] = 0.f;
      if constexpr (VEC) {
        for (int e = 0; e < E; e += 4) {
          const float4 v = __ldg(reinterpret_cast<const float4*>(drow + e));
#pragma unroll
          for (int i = 0; i < GROUP; ++i) {
            if (g + i < n) {
              const float4 w = *reinterpret_cast<const float4*>(s_te + (g + i) * E + e);
              acc[i] = fmaf(w.x, v.x, acc[i]);
              acc[i] = fmaf(w.y, v.y, acc[i]);
              acc[i] = fmaf(w.z, v.z, acc[i]);
              acc[i] = fmaf(w.w, v.w, acc[i]);
            }
          }
        }
      } else {
        for (int e = 0; e < E; ++e) {
          const float v = __ldg(drow + e);
#pragma unroll
          for (int i = 0; i < GROUP; ++i)
            if (g + i < n) acc[i] = fmaf(s_te[(g + i) * E + e], v, acc[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < GROUP; ++i)
        if (g + i < n) pass = pass && (acc[i] + bias) >= s_tau[g + i];
    }
    if (pass) atomicOr(out + (size_t)q * words + (d >> 5), 1u << (d & 31));
  }
}

template <bool VEC>
cudaError_t launch(const int32_t* tier1, int k, const int32_t* tier1_len, const int32_t* queries,
                   int T, const float* te, const float* de, int E, const float* tau, float bias,
                   uint32_t* out, int D, int words, int Q, int grid_x, cudaStream_t stream) {
  const int smem = T * E * (int)sizeof(float);
  static int configured = 48 << 10;  // the largest dynamic shared memory allowed so far
  if (smem > configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        two_tier_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    configured = smem;
  }
  two_tier_kernel<VEC><<<dim3(grid_x, Q), THREADS, smem, stream>>>(
      tier1, k, tier1_len, queries, T, te, de, E, tau, bias, out, D, words);
  return cudaGetLastError();
}

}  // namespace

// The wrapper checks the shapes: T <= 64, Q <= 65535, grid_x >= 1, T * E
// floats of shared memory within the card's 227 KB.
extern "C" int two_tier_launch(const int32_t* tier1, int k, const int32_t* tier1_len,
                               const int32_t* queries, int T, const float* te, const float* de,
                               int E, const float* tau, float bias, uint32_t* out, int D,
                               int words, int Q, int grid_x, cudaStream_t stream) {
  if (Q <= 0 || words <= 0) return (int)cudaGetLastError();
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(uint32_t) * (size_t)Q * words, stream);
  if (err != cudaSuccess) return (int)err;
  if (T <= 0 || k <= 0) return (int)cudaGetLastError();
  const bool vec = E % 4 == 0 && reinterpret_cast<uintptr_t>(de) % 16 == 0;
  err = vec ? launch<true>(tier1, k, tier1_len, queries, T, te, de, E, tau, bias, out, D, words,
                           Q, grid_x, stream)
            : launch<false>(tier1, k, tier1_len, queries, T, te, de, E, tau, bias, out, D, words,
                            Q, grid_x, stream);
  return (int)err;
}
