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
// candidate (membership) AND the tier-1 union, exactly.  One thread sums
// one product; a gather plus a cuBLAS product would sum in another order
// and could flip bits next to tau; no TF32 and no wgmma, for the reason
// membership.cu gives.
//
// What bounds it on the H100: the L1/shared-memory pipe, not device
// memory.  Each (query, union doc) pair reads its doc row (E x 4 = 512
// bytes, mostly from L2: tier-1 keeps the lowest ids, so queries share
// rows) and sums E FMAs per valid slot, each FMA's term value a broadcast
// shared-memory read (a 16-byte read costs a warp four cycles however many
// lanes share its address).  So the design spends no read or FMA on an
// empty slot, idles no lane, and loads rows a warp at a time; a kernel
// that walks positions a thread each spends most of its time in that loop
// even with its rows in L1 (PERF.md §6, measured with
// src/repro_torch/kernels/two_tier/bench.py).
//
// Design: a CTA takes one query and a share of its candidates: thread 0
// packs the valid slots (term, list length, tau, first position in the
// concatenation of the slots' lists) into shared memory, the CTA copies
// their term rows there, and each warp takes batches of 32 consecutive
// positions of that concatenation.
// - A position's doc is claimed with an atomicOr on the query's output
//   word: the lane that sets the bit scores the doc, every other lane that
//   meets it (another slot's list, a repeated term) drops it; a doc that
//   fails f_hat has its bit cleared with an atomicAnd.  So each doc of the
//   union is scored once, with no search of the other lists.
// - A warp queues its claimed docs in shared memory and scores them 32 at
//   a time, a doc a lane, so no lane idles on a dropped position.
// - The slots are summed in groups of exactly the query's count (a
//   template per group size up to 8): no read or FMA for an empty slot.
// - The 32 docs' rows go through a per-warp tile of shared memory, 32
//   floats of each row at a time: the warp reads them with 16-byte loads,
//   4 rows of 128 bytes an instruction (4 loads in flight, then their
//   stores).  Each lane then reads its row from the tile (rows padded so
//   that a quarter warp hits every bank once) and the term rows by
//   broadcast, chunk after chunk in order.
// The launch zeroes the bitmap with its own memset, so a CUDA-graph replay
// starts from zero.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_TERMS = 64;  // query slots kept in shared memory
constexpr int GROUP = 8;       // slots scored per pass over a doc row
constexpr int CHUNK = 32;      // floats of each row a warp stages at a time
constexpr unsigned FULL = 0xffffffffu;

// floats between staged rows: 16-byte reads of rows r..r+7 (a quarter
// warp) hit distinct banks; 4-byte reads of rows r..r+31 likewise
template <bool VEC>
__host__ __device__ constexpr int row_stride() {
  return VEC ? CHUNK + 4 : CHUNK + 1;
}

// acc[i] = sum over e of te[slot g + i][e] * de[doc][e], fmaf in order, for
// the doc of each lane below cnt, its row staged through the warp's tile;
// pass &= every slot's test.  Called by the whole warp.
template <bool VEC, int NS>
__device__ __forceinline__ void score_group(int doc, int cnt, const float* __restrict__ de, int E,
                                            const float* s_te, const float* s_tau, int g,
                                            float bias, float* tile, bool& pass) {
  constexpr int RS = row_stride<VEC>();
  const int lane = threadIdx.x & 31;
  float acc[NS];
#pragma unroll
  for (int i = 0; i < NS; ++i) acc[i] = 0.f;
  for (int e0 = 0; e0 < E; e0 += CHUNK) {
    const int w = min(CHUNK, E - e0);
    if constexpr (VEC) {
      // instruction i stages rows 4i..4i+3: lane l reads floats
      // 4 (l % 8) .. +3 of row 4i + l / 8
      const int c = 4 * (lane & 7);
#pragma unroll
      for (int h = 0; h < 8; h += 4) {  // 4 loads in flight, then their stores
        float4 v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = 4 * (h + i) + (lane >> 3);
          const int d = __shfl_sync(FULL, doc, r);
          if (r < cnt && c < w)
            v[i] = __ldg(reinterpret_cast<const float4*>(de + (size_t)d * E + e0 + c));
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = 4 * (h + i) + (lane >> 3);
          if (r < cnt && c < w) *reinterpret_cast<float4*>(tile + r * RS + c) = v[i];
        }
      }
    } else {
      for (int r = 0; r < cnt; ++r) {
        const int d = __shfl_sync(FULL, doc, r);
        if (lane < w) tile[r * RS + lane] = __ldg(de + (size_t)d * E + e0 + lane);
      }
    }
    __syncwarp();
    if (lane < cnt) {
      const float* row = tile + lane * RS;
      const float* tb = s_te + (size_t)g * E + e0;
      if constexpr (VEC) {
        for (int c = 0; c < w; c += 4) {
          const float4 v = *reinterpret_cast<const float4*>(row + c);
#pragma unroll
          for (int i = 0; i < NS; ++i) {
            const float4 t = *reinterpret_cast<const float4*>(tb + i * E + c);
            acc[i] = fmaf(t.x, v.x, acc[i]);
            acc[i] = fmaf(t.y, v.y, acc[i]);
            acc[i] = fmaf(t.z, v.z, acc[i]);
            acc[i] = fmaf(t.w, v.w, acc[i]);
          }
        }
      } else {
        for (int c = 0; c < w; ++c) {
          const float v = row[c];
#pragma unroll
          for (int i = 0; i < NS; ++i) acc[i] = fmaf(tb[i * E + c], v, acc[i]);
        }
      }
    }
    __syncwarp();  // before the next chunk overwrites the tile
  }
#pragma unroll
  for (int i = 0; i < NS; ++i) pass = pass && (acc[i] + bias) >= s_tau[g + i];
}

// Score the docs of lanes 0..cnt-1 (cnt the same in every lane) against
// the query's n slots, in groups of exactly min(8, slots left), and clear
// the bit of each doc that fails one.  Called by the whole warp.
template <bool VEC>
__device__ __forceinline__ void score_docs(int doc, int cnt, const float* __restrict__ de, int E,
                                           const float* s_te, const float* s_tau, int n,
                                           float bias, float* tile, uint32_t* orow) {
  bool pass = true;
  for (int g = 0; g < n; g += GROUP) {
    switch (min(GROUP, n - g)) {
      case 1: score_group<VEC, 1>(doc, cnt, de, E, s_te, s_tau, g, bias, tile, pass); break;
      case 2: score_group<VEC, 2>(doc, cnt, de, E, s_te, s_tau, g, bias, tile, pass); break;
      case 3: score_group<VEC, 3>(doc, cnt, de, E, s_te, s_tau, g, bias, tile, pass); break;
      case 4: score_group<VEC, 4>(doc, cnt, de, E, s_te, s_tau, g, bias, tile, pass); break;
      case 5: score_group<VEC, 5>(doc, cnt, de, E, s_te, s_tau, g, bias, tile, pass); break;
      case 6: score_group<VEC, 6>(doc, cnt, de, E, s_te, s_tau, g, bias, tile, pass); break;
      case 7: score_group<VEC, 7>(doc, cnt, de, E, s_te, s_tau, g, bias, tile, pass); break;
      default: score_group<VEC, 8>(doc, cnt, de, E, s_te, s_tau, g, bias, tile, pass); break;
    }
  }
  if ((threadIdx.x & 31) < cnt && !pass) atomicAnd(orow + (doc >> 5), ~(1u << (doc & 31)));
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
two_tier_kernel(const int32_t* __restrict__ tier1, int k, const int32_t* __restrict__ tier1_len,
                const int32_t* __restrict__ queries, int T, const float* __restrict__ te,
                const float* __restrict__ de, int E, const float* __restrict__ tau, float bias,
                uint32_t* __restrict__ out, int D, int words) {
  extern __shared__ float4 smem4[];
  float* s_te = reinterpret_cast<float*>(smem4);        // [n][E]: the valid slots' term rows
  float* s_tiles = s_te + ((T * E + 3) & ~3);           // [WARPS][32][row_stride]
  __shared__ int s_term[MAX_TERMS];
  __shared__ int s_off[MAX_TERMS + 1];  // slot i's first position in the concatenation
  __shared__ float s_tau[MAX_TERMS];
  __shared__ int s_queue[WARPS][64];    // each warp's claimed docs not yet scored
  __shared__ int s_n;
  const int q = blockIdx.y;
  if (threadIdx.x == 0) {
    int n = 0, off = 0;
    for (int t = 0; t < T; ++t) {
      const int term = queries[(size_t)q * T + t];
      if (term < 0) continue;
      s_term[n] = term;
      s_tau[n] = tau[term];
      s_off[n] = off;
      off += min(tier1_len[term], k);
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

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* tile = s_tiles + warp * 32 * row_stride<VEC>();
  int* queue = s_queue[warp];
  uint32_t* orow = out + (size_t)q * words;
  int pending = 0;
  const int batches = (total + 31) / 32;
  for (int b = blockIdx.x * WARPS + warp; b < batches; b += gridDim.x * WARPS) {
    const int p = 32 * b + lane;
    bool take = false;
    int d = 0;
    if (p < total) {
      int s = 0;
      while (p >= s_off[s + 1]) ++s;
      d = tier1[(size_t)s_term[s] * k + (p - s_off[s])];
      if ((unsigned)d < (unsigned)D) {
        const uint32_t bit = 1u << (d & 31);
        take = !(atomicOr(orow + (d >> 5), bit) & bit);  // this lane claimed d
      }
    }
    const unsigned m = __ballot_sync(FULL, take);
    if (take) queue[pending + __popc(m & ((1u << lane) - 1u))] = d;
    pending += __popc(m);
    __syncwarp();
    if (pending >= 32) {
      score_docs<VEC>(queue[lane], 32, de, E, s_te, s_tau, n, bias, tile, orow);
      pending -= 32;
      if (lane < pending) queue[lane] = queue[32 + lane];
      __syncwarp();
    }
  }
  if (pending > 0)
    score_docs<VEC>(lane < pending ? queue[lane] : 0, pending, de, E, s_te, s_tau, n, bias, tile,
                    orow);
}

template <bool VEC>
cudaError_t launch(const int32_t* tier1, int k, const int32_t* tier1_len, const int32_t* queries,
                   int T, const float* te, const float* de, int E, const float* tau, float bias,
                   uint32_t* out, int D, int words, int Q, int grid_x, cudaStream_t stream) {
  const int smem =
      (int)sizeof(float) * (((T * E + 3) & ~3) + WARPS * 32 * row_stride<VEC>());
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

// The wrapper checks the shapes: T <= 64, Q <= 65535, grid_x >= 1, the
// term rows and the warps' tiles within the card's 227 KB of shared memory.
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
