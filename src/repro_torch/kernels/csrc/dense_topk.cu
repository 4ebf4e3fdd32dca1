// The dense arena pass of ranked serving in one launch: per query row, the
// top k docs by (score desc, id asc) among the docs whose summed impact
// beats max(floor, 0), where a doc's score is the integer sum of its T
// term rows of the shard's resident (n_terms + 1, n_docs) impact table.
//
// Replaces: src/repro/kernels/fused_query/dense.py, _dense_impl (XLA, not
// Pallas: a gather-sum into a (Q, n_docs) int32 accumulator, then a
// lax.while_loop of k masked argmax peels, each zeroing the peeled cell).
// k peels with first-maximum ties pick exactly the top k by (score desc,
// id asc) of the eligible docs, so the kernel selects them directly.
//
// dense_topk_launch: the table (uint8, int16 or int32 impacts; its last row
// is the all-zero pad target), (Q, T) int32 term ids (-1 = pad), (Q,) int32
// floors, k <= 32 -> (Q, k) int32 ids (NEVER = 1 << 30 where empty) and
// scores (0 where empty), and rounds (0-d int64): with H the most hits any
// row has, H + 1 if H < k, else k -- the reference loop's round count.
//
// What bounds it on the H100: memory.  A pass reads T table rows per query
// row (one byte a doc at uint8: 67 MB at Q=64, T=8 and the arena's cap of
// 131,072 docs, about 0.02 ms at 3.35 TB/s); the selection is a few
// integer operations a doc.  At small arenas (2,000 docs) it is one launch.
//
// Design (a grid of (row, doc-chunk) CTAs, then a merge per row in the same
// launch):
// - CTA (s, q) scores docs [4096 s, 4096 s + 4096) of row q: each of its 256
//   threads owns 16 consecutive docs and adds the row's valid term rows with
//   16-byte loads (a warp reads 512 contiguous bytes of a uint8 row), into
//   16 int32 registers.  Pad slots are skipped, not read; the (Q, n_docs)
//   accumulator never exists in device memory.
// - The CTA's top min(k, eligible) without sorting 4,096 keys: if more than
//   k docs are eligible, a bitwise search over the score value finds s*, the
//   k-th largest score (about 11 block-wide counts for uint8 rows at T=8);
//   the CTA keeps every doc above s* and, of the docs equal to s*, the ones
//   with the smallest ids (a block-wide prefix count in doc order).  Warp 0
//   sorts those <= 32 keys by rank counting and writes them to a (Q, S, k)
//   scratch.  A key is (score << 32) | ~doc, so the larger key wins and, at
//   equal scores, the smaller doc; 0 is "nothing".
// - Each CTA then counts itself into its row's arrival counter; the row's
//   last CTA copies the row's S sorted lists into shared memory and merges
//   them with one warp (a lane per list, k rounds of a warp-wide max, the
//   winner advancing its list), writes the
//   row's k slots, and counts the row's hits into a batch-wide maximum; the
//   last row to finish writes rounds.  The counters are zeroed by a memset
//   inside the launch, so a CUDA-graph replay starts from zero.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int PER_THREAD = 16;               // consecutive docs a thread scores
constexpr int CHUNK = THREADS * PER_THREAD;  // docs a CTA scores
constexpr int WARPS = THREADS / 32;
constexpr int MAX_K = 32;
constexpr int NEVER = 1 << 30;
constexpr unsigned FULL = 0xffffffffu;

typedef unsigned long long u64;

__device__ __forceinline__ u64 make_key(int score, int doc) {
  return ((u64)(uint32_t)score << 32) | (u64)(0xffffffffu - (uint32_t)doc);
}

// the warp's largest key: two 32-bit reductions, score first, then ~doc
__device__ __forceinline__ u64 warp_max(u64 key) {
  const uint32_t hi = (uint32_t)(key >> 32);
  const uint32_t top = __reduce_max_sync(FULL, hi);
  const uint32_t lo = __reduce_max_sync(FULL, hi == top ? (uint32_t)key : 0u);
  return ((u64)top << 32) | lo;
}

// Block-wide sum and max, every thread gets the result.  Calls alternate
// between the two halves of red, so one barrier a call suffices: a thread
// cannot write a half again before every thread has passed the barrier of
// the call in between, after reading it.
__device__ __forceinline__ int block_sum(int v, int* red) {
  v = __reduce_add_sync(FULL, v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  int s = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) s += red[w];
  return s;
}

__device__ __forceinline__ int block_max(int v, int* red) {
  v = __reduce_max_sync(FULL, v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  int m = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) m = max(m, red[w]);
  return m;
}

// acc[i] += row[d0 + i] for the thread's 16 docs below n_docs.  VEC: 16-byte
// loads, n_docs * sizeof(Elem) a multiple of 16, so a vector is all in or
// all out; int16 impacts are sign-extended as the plain version's cast does.
template <typename Elem, bool VEC>
__device__ __forceinline__ void add_row(const Elem* __restrict__ row, int d0, int n_docs,
                                        int (&acc)[PER_THREAD]) {
  if constexpr (VEC) {
    constexpr int PER_VEC = 16 / (int)sizeof(Elem);
#pragma unroll
    for (int v = 0; v < PER_THREAD / PER_VEC; ++v) {
      const int d = d0 + v * PER_VEC;
      if (d >= n_docs) break;
      const uint4 w = __ldg(reinterpret_cast<const uint4*>(row + d));
      const uint32_t x[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if constexpr (sizeof(Elem) == 1) {
#pragma unroll
          for (int b = 0; b < 4; ++b) acc[v * PER_VEC + 4 * j + b] += (int)((x[j] >> (8 * b)) & 0xffu);
        } else if constexpr (sizeof(Elem) == 2) {
          acc[v * PER_VEC + 2 * j] += (int)(int16_t)(x[j] & 0xffffu);
          acc[v * PER_VEC + 2 * j + 1] += (int)(int16_t)(x[j] >> 16);
        } else {
          acc[v * PER_VEC + j] += (int)x[j];
        }
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i)
      if (d0 + i < n_docs) acc[i] += (int)__ldg(row + d0 + i);
  }
}

template <typename Elem, bool VEC>
__global__ void __launch_bounds__(THREADS)
dense_topk_kernel(const Elem* __restrict__ table, int n_rows, int n_docs,
                  const int32_t* __restrict__ qt, const int32_t* __restrict__ floors, int Q,
                  int T, int k, u64* __restrict__ lists, int32_t* __restrict__ counts,
                  int32_t* __restrict__ out_ids, int32_t* __restrict__ out_scores,
                  int64_t* __restrict__ rounds) {
  __shared__ int red[2][WARPS];
  __shared__ int s_n, s_last;
  __shared__ u64 s_keys[MAX_K];
  extern __shared__ u64 s_lists[];  // the merge's copy of the row's S lists [S][k] ...
  int* s_pos = reinterpret_cast<int*>(s_lists + (size_t)gridDim.x * k);  // ... and its positions
  const int q = blockIdx.y, s = blockIdx.x, S = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int d0 = s * CHUNK + tid * PER_THREAD;
  if (tid == 0) s_n = 0;

  // 1. the thread's 16 scores, masked by the floor
  int acc[PER_THREAD];
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i) acc[i] = 0;
  const int pad = n_rows - 1;  // the all-zero pad row adds nothing: it is not read
  for (int t = 0; t < T; ++t) {
    const int term = __ldg(qt + (size_t)q * T + t);
    if (term >= 0 && term < pad) add_row<Elem, VEC>(table + (size_t)term * n_docs, d0, n_docs, acc);
  }
  const int fl = max(__ldg(floors + q), 0);
  int cnt = 0, mx = 0;
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i) {
    acc[i] = acc[i] > fl ? acc[i] : 0;
    cnt += acc[i] > 0;
    mx = max(mx, acc[i]);
  }

  // 2. s*: 0 when at most k docs are eligible (all are kept), else the
  // largest s with at least k eligible scores >= s, built bit by bit
  int ph = 0;
  const int n_el = block_sum(cnt, red[ph]);
  ph ^= 1;
  int sstar = 0;
  if (n_el > k) {  // uniform across the CTA
    const int m = block_max(mx, red[ph]);
    ph ^= 1;
    for (int b = 31 - __clz(m); b >= 0; --b) {
      const int cand = sstar | (1 << b);
      int c = 0;
#pragma unroll
      for (int i = 0; i < PER_THREAD; ++i) c += acc[i] >= cand;
      if (block_sum(c, red[ph]) >= k) sstar = cand;
      ph ^= 1;
    }
  }

  // 3. keep every doc above s*; of those equal to s*, the smallest ids
  // (fewer than k docs lie above s*, so need >= 1 when s* > 0)
  int gt = 0, eq = 0;
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i) {
    gt += acc[i] > sstar;
    eq += sstar > 0 && acc[i] == sstar;
  }
  const int need = k - block_sum(gt, red[ph]);
  ph ^= 1;
  int incl = eq;  // the prefix count of docs equal to s*, in doc order
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) red[ph][warp] = incl;
  __syncthreads();
  int before = incl - eq;
  for (int w = 0; w < warp; ++w) before += red[ph][w];
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i) {
    bool take = acc[i] > sstar;
    if (!take && sstar > 0 && acc[i] == sstar) take = before++ < need;
    if (take) s_keys[atomicAdd(&s_n, 1)] = make_key(acc[i], d0 + i);
  }
  __syncthreads();

  // 4. warp 0: the CTA's keys sorted by rank into its (q, s) list, 0-padded
  // to k; then the CTA counts itself into its row
  if (warp == 0) {
    const int n = s_n;
    u64* out = lists + ((size_t)q * S + s) * k;
    if (lane < n) {
      const u64 key = s_keys[lane];
      int rank = 0;
      for (int j = 0; j < n; ++j) rank += s_keys[j] > key;
      out[rank] = key;
    } else if (lane < k) {
      out[lane] = 0ull;
    }
    __threadfence();
    __syncwarp();
    if (lane == 0) s_last = atomicAdd(&counts[q], 1) == S - 1;
  }
  __syncthreads();
  if (!s_last) return;

  // 5. the row's last CTA: the row's S sorted lists into shared memory
  // (read past L1, which may hold none of them), then warp 0 merges them
  __threadfence();
  const u64* row = lists + (size_t)q * S * k;
  for (int i = tid; i < S * k; i += THREADS) s_lists[i] = __ldcg(row + i);
  __syncthreads();
  if (warp != 0) return;
  u64 best = 0;
  int best_l = -1;
  for (int l = lane; l < S; l += 32) {
    s_pos[l] = 0;
    const u64 h = s_lists[(size_t)l * k];
    if (h > best) best = h, best_l = l;
  }
  int hits = 0;
  for (int i = 0; i < k; ++i) {
    const u64 m = warp_max(best);
    if (m == 0) break;  // nothing left above the floor
    if (best == m) {    // keys are unique: exactly one lane won
      out_ids[(size_t)q * k + i] = (int32_t)(0xffffffffu - (uint32_t)m);
      out_scores[(size_t)q * k + i] = (int32_t)(m >> 32);
      ++s_pos[best_l];
      best = 0;
      best_l = -1;
      for (int l = lane; l < S; l += 32) {
        const int p = s_pos[l];
        const u64 h = p < k ? s_lists[(size_t)l * k + p] : 0ull;
        if (h > best) best = h, best_l = l;
      }
    }
    hits = i + 1;
  }
  for (int i = hits + lane; i < k; i += 32) {
    out_ids[(size_t)q * k + i] = NEVER;
    out_scores[(size_t)q * k + i] = 0;
  }
  if (lane == 0) {  // the batch's most hits; the last row writes rounds
    atomicMax(&counts[Q], hits);
    __threadfence();
    if (atomicAdd(&counts[Q + 1], 1) == Q - 1) {
      const int h = atomicAdd(&counts[Q], 0);
      *rounds = h < k ? h + 1 : k;
    }
  }
}

template <typename Elem>
cudaError_t launch(const void* table, bool vec, int n_rows, int n_docs, const int32_t* qt,
                   const int32_t* floors, int Q, int T, int k, u64* lists, int32_t* counts,
                   int32_t* out_ids, int32_t* out_scores, int64_t* rounds, cudaStream_t stream) {
  const dim3 grid((n_docs + CHUNK - 1) / CHUNK, Q);
  const size_t smem = (sizeof(u64) * k + sizeof(int)) * grid.x;
  const Elem* t = static_cast<const Elem*>(table);
  if (vec)
    dense_topk_kernel<Elem, true><<<grid, THREADS, smem, stream>>>(
        t, n_rows, n_docs, qt, floors, Q, T, k, lists, counts, out_ids, out_scores, rounds);
  else
    dense_topk_kernel<Elem, false><<<grid, THREADS, smem, stream>>>(
        t, n_rows, n_docs, qt, floors, Q, T, k, lists, counts, out_ids, out_scores, rounds);
  return cudaGetLastError();
}

}  // namespace

// The wrapper checks the shapes: 0 < k <= 32, Q <= 65535, n_docs > 0 and at
// most 128 CTAs a row (the merge's 33 KB of lists and positions at k = 32),
// elem_bytes 1, 2 or 4.
extern "C" int dense_topk_launch(const void* table, int elem_bytes, int n_rows, int n_docs,
                                 const int32_t* qt, const int32_t* floors, int Q, int T, int k,
                                 u64* lists, int32_t* counts, int32_t* out_ids,
                                 int32_t* out_scores, int64_t* rounds, cudaStream_t stream) {
  if (Q <= 0 || k <= 0 || k > MAX_K || n_docs <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(counts, 0, sizeof(int32_t) * ((size_t)Q + 2), stream);
  if (err != cudaSuccess) return (int)err;
  const bool vec = ((size_t)n_docs * elem_bytes) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(table) % 16 == 0;
  switch (elem_bytes) {
    case 1:
      err = launch<uint8_t>(table, vec, n_rows, n_docs, qt, floors, Q, T, k, lists, counts,
                            out_ids, out_scores, rounds, stream);
      break;
    case 2:
      err = launch<int16_t>(table, vec, n_rows, n_docs, qt, floors, Q, T, k, lists, counts,
                            out_ids, out_scores, rounds, stream);
      break;
    case 4:
      err = launch<int32_t>(table, vec, n_rows, n_docs, qt, floors, Q, T, k, lists, counts,
                            out_ids, out_scores, rounds, stream);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return (int)err;
}
