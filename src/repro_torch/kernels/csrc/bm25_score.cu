// Batched quantized-BM25 scoring of a (candidate, term) impact window:
//   ints[p] = sum_t impacts[p, t]          (exact int32: integer adds)
//   floats[p] = f32(ints[p]) * scale        (one rounding of the product)
//
// Replaces: src/repro/kernels/bm25_score/kernel.py, score_batch (an
// (8, 128)-lane tile per grid step, the term axis padded to 128 lanes).
//
// What bounds it on the H100: memory, the P*T*4 bytes of impacts read once
// and 8 bytes written per row; one add per impact.
//
// Design: one warp per candidate row.  The lanes stride over the row's true
// T columns (no padding to 128: that was the TPU's lane layout), and a warp
// shuffle reduction sums them; integer addition is associative, so the sum
// is the reference's whatever the order.  __int2float_rn converts the exact
// sum and __fmul_rn multiplies once without FMA contraction: the same single
// rounding as bm25_score/ref.py.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int ROWS_PER_BLOCK = THREADS / 32;

__global__ void __launch_bounds__(THREADS)
score_kernel(const int32_t* __restrict__ impacts, float scale, int32_t* __restrict__ ints,
             float* __restrict__ floats, int P, int T) {
  const int p = blockIdx.x * ROWS_PER_BLOCK + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (p >= P) return;  // warp-uniform
  const int32_t* row = impacts + (size_t)p * T;
  int32_t s = 0;
  for (int t = lane; t < T; t += 32) s += row[t];
  for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
  if (lane == 0) {
    ints[p] = s;
    floats[p] = __fmul_rn(__int2float_rn(s), scale);
  }
}

}  // namespace

extern "C" int bm25_score_launch(const int32_t* impacts, int32_t* ints, float* floats, int P,
                                 int T, float scale, cudaStream_t stream) {
  if (P > 0) {
    const int blocks = (P + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
    score_kernel<<<blocks, THREADS, 0, stream>>>(impacts, scale, ints, floats, P, T);
  }
  return (int)cudaGetLastError();
}
