// Batched quantized-BM25 scoring of a (candidate, term) impact window:
//   ints[p] = sum_t impacts[p, t]          (exact int32: integer adds)
//   floats[p] = f32(ints[p]) * scale        (one rounding of the product)
//
// Replaces: src/repro/kernels/bm25_score/kernel.py, score_batch (an
// (8, 128)-lane tile per grid step, the term axis padded to 128 lanes).
//
// What bounds it on the H100: memory, the P*T*4 bytes of impacts read once
// and 8 bytes written per row; one add per impact.  At the port's shapes
// (a ranked batch's exhaustive windows stacked, a few thousand rows of at
// most 6-8 terms) the bytes take far less than a launch, so the design's
// aim is one launch per batch that does no work it need not.
//
// Design: for T <= 8 (every ranked row the port builds: zipf_disjunctions
// draws at most 6 terms) one thread per row, its loads unrolled to at most
// 8 columns and guarded by T, each 16 bytes (T % 4 == 0) or 8 bytes (T
// even) where the row stride and the base address allow, else 4: three
// variants, one per load width.  Neighbouring threads read neighbouring
// rows, so a warp's loads cover one contiguous stretch.  The warp-per-row
// layout this replaces left at least 26 of 32 lanes idle on such rows and
// spent a 5-step shuffle ladder per row; it is kept for wider T, where the
// lanes stride over the row's true columns and a shuffle reduction sums
// them.  Integer addition is associative, so either sum is the
// reference's whatever the order; __int2float_rn converts the exact sum
// and __fmul_rn multiplies once without FMA contraction: the same single
// rounding as bm25_score/ref.py.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int ROWS_PER_BLOCK = THREADS / 32;
constexpr int MAX_THREAD_T = 8;

template <int V>
struct Vec;
template <>
struct Vec<1> {
  using type = int;
  __device__ static int sum(int v) { return v; }
};
template <>
struct Vec<2> {
  using type = int2;
  __device__ static int sum(int2 v) { return v.x + v.y; }
};
template <>
struct Vec<4> {
  using type = int4;
  __device__ static int sum(int4 v) { return v.x + v.y + v.z + v.w; }
};

__device__ __forceinline__ void store(int32_t* ints, float* floats, int p, int32_t s,
                                      float scale) {
  ints[p] = s;
  floats[p] = __fmul_rn(__int2float_rn(s), scale);
}

// one thread per row of T <= 8 columns, read V int32 at a time (T % V == 0)
template <int V>
__global__ void __launch_bounds__(THREADS)
row_kernel(const int32_t* __restrict__ impacts, float scale, int32_t* __restrict__ ints,
           float* __restrict__ floats, int P, int T) {
  const int p = blockIdx.x * THREADS + threadIdx.x;
  if (p >= P) return;
  using VT = typename Vec<V>::type;
  const VT* row = reinterpret_cast<const VT*>(impacts + (size_t)p * T);
  const int n = T / V;
  int32_t s = 0;
#pragma unroll
  for (int j = 0; j < MAX_THREAD_T / V; ++j) {
    if (j < n) s += Vec<V>::sum(__ldg(row + j));
  }
  store(ints, floats, p, s, scale);
}

// one warp per row: T > 8 (and T == 0)
__global__ void __launch_bounds__(THREADS)
warp_kernel(const int32_t* __restrict__ impacts, float scale, int32_t* __restrict__ ints,
            float* __restrict__ floats, int P, int T) {
  const int p = blockIdx.x * ROWS_PER_BLOCK + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (p >= P) return;  // warp-uniform
  const int32_t* row = impacts + (size_t)p * T;
  int32_t s = 0;
  for (int t = lane; t < T; t += 32) s += row[t];
  for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
  if (lane == 0) store(ints, floats, p, s, scale);
}

}  // namespace

extern "C" int bm25_score_launch(const int32_t* impacts, int32_t* ints, float* floats, int P,
                                 int T, float scale, cudaStream_t stream) {
  if (P > 0) {
    if (T >= 1 && T <= MAX_THREAD_T) {
      // a row starts at base + 4*T*p bytes: aligned to V int32 when T % V == 0
      const uintptr_t base = reinterpret_cast<uintptr_t>(impacts);
      const int blocks = (P + THREADS - 1) / THREADS;
      if (T % 4 == 0 && base % 16 == 0) {
        row_kernel<4><<<blocks, THREADS, 0, stream>>>(impacts, scale, ints, floats, P, T);
      } else if (T % 2 == 0 && base % 8 == 0) {
        row_kernel<2><<<blocks, THREADS, 0, stream>>>(impacts, scale, ints, floats, P, T);
      } else {
        row_kernel<1><<<blocks, THREADS, 0, stream>>>(impacts, scale, ints, floats, P, T);
      }
    } else {
      const int blocks = (P + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
      warp_kernel<<<blocks, THREADS, 0, stream>>>(impacts, scale, ints, floats, P, T);
    }
  }
  return (int)cudaGetLastError();
}
