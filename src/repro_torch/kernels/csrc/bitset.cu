// Packed-bitset conjunctive AND + popcount: Algorithm 3's block intersect.
// (Q,T,W) per-query per-term block bitmaps and (Q,T) valid flags ->
// (Q,W) AND over each query's valid terms (an invalid term acts as all-ones)
// and (Q,) the number of surviving blocks.
//
// Replaces: src/repro/kernels/bitset/kernel.py, bitset_and_popcount
// (the Pallas tile with an unrolled T-way AND and a SWAR popcount ladder).
//
// What bounds it on the H100: memory.  Each input word is read once and
// each output word written once; there is one AND per term and one popc per
// word, far below what the card can compute in the time the bytes take.
//
// Design: one thread per output word, the T rows read with neighbouring
// threads on neighbouring words (coalesced).  __popc replaces the SWAR
// ladder.  The TPU kernel carried the count across its sequential grid
// steps in scratch; here blocks run in no order, so each block reduces its
// popcounts (warp shuffles, then one shared slot per warp) and adds them to
// the query's counter with one integer atomicAdd.  Integer addition is exact
// in any order, so the count is deterministic.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
bitset_kernel(const uint32_t* __restrict__ maps, const int32_t* __restrict__ valid,
              uint32_t* __restrict__ anded, int32_t* __restrict__ count, int T, int W) {
  const int q = blockIdx.y;
  const int w = blockIdx.x * THREADS + threadIdx.x;
  int bits = 0;
  if (w < W) {
    uint32_t acc = 0xffffffffu;
    for (int t = 0; t < T; ++t) {
      if (valid[(size_t)q * T + t] > 0) acc &= maps[((size_t)q * T + t) * W + w];
    }
    anded[(size_t)q * W + w] = acc;
    bits = __popc(acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) bits += __shfl_down_sync(0xffffffffu, bits, off);
  __shared__ int warp_sums[THREADS / 32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) warp_sums[warp] = bits;
  __syncthreads();
  if (warp == 0) {
    int s = lane < THREADS / 32 ? warp_sums[lane] : 0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0 && s != 0) atomicAdd(&count[q], s);
  }
}

}  // namespace

// `count` must be zero on entry: blocks add their partial counts to it.
extern "C" int bitset_and_popcount_launch(const uint32_t* maps, const int32_t* valid,
                                          uint32_t* anded, int32_t* count, int Q, int T,
                                          int W, cudaStream_t stream) {
  if (Q > 0 && W > 0) {
    dim3 grid((W + THREADS - 1) / THREADS, Q);
    bitset_kernel<<<grid, THREADS, 0, stream>>>(maps, valid, anded, count, T, W);
  }
  return (int)cudaGetLastError();
}
