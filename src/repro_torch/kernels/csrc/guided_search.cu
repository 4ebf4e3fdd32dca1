// Batched epsilon-window probes of the learned (plm/rmi) posting streams.
// Per probe p, over its window j < n_valid[p]:
//   id = base + rint(slope * f32(r_lo + j - seg_start)) + corr[p, j]
//   found[p] = any(id == cand[p]),  lt[p] = count(id < cand[p]).
//
// Replaces: src/repro/kernels/guided_search/kernel.py, probe_batch
// (the Pallas (8-probe, W) tile reduced along lanes).
//
// What bounds it on the H100: memory, the P*W*4 bytes of corrections (only
// the n_valid prefix of each row is read); one multiply and two compares per
// rank.
//
// Design: one warp per probe.  The lanes stride over the valid prefix of
// the window only, so the padded tail of a row is never read, and the loop
// bound is warp-uniform.  found comes from __any_sync, lt from
// __popc(__ballot_sync(...)) summed over the strides: no shared memory, no
// atomics.  Rounding matches the reference bit for bit: __fmul_rn forbids
// contracting the product into an FMA, and __float2int_rn rounds half to
// even like jnp.rint.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int PROBES_PER_BLOCK = THREADS / 32;

__global__ void __launch_bounds__(THREADS)
probe_kernel(const int32_t* __restrict__ seg_starts, const int32_t* __restrict__ bases,
             const float* __restrict__ slopes, const int32_t* __restrict__ r_lo,
             const int32_t* __restrict__ n_valid, const int32_t* __restrict__ cands,
             const int32_t* __restrict__ corr, int32_t* __restrict__ found,
             int32_t* __restrict__ lt, int P, int W) {
  const int p = blockIdx.x * PROBES_PER_BLOCK + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (p >= P) return;  // warp-uniform
  const int seg = seg_starts[p], base = bases[p], lo = r_lo[p], cand = cands[p];
  const float slope = slopes[p];
  const int n = min(n_valid[p], W);
  bool any = false;
  int below = 0;
  for (int j0 = 0; j0 < n; j0 += 32) {
    const int j = j0 + lane;
    bool eq = false, less = false;
    if (j < n) {
      const float di = (float)(lo + j - seg);
      const int id = base + __float2int_rn(__fmul_rn(slope, di)) + corr[(size_t)p * W + j];
      eq = id == cand;
      less = id < cand;
    }
    any |= __any_sync(0xffffffffu, eq);
    below += __popc(__ballot_sync(0xffffffffu, less));
  }
  if (lane == 0) {
    found[p] = any ? 1 : 0;
    lt[p] = below;
  }
}

}  // namespace

extern "C" int probe_batch_launch(const int32_t* seg_starts, const int32_t* bases,
                                  const float* slopes, const int32_t* r_lo,
                                  const int32_t* n_valid, const int32_t* cands,
                                  const int32_t* corr, int32_t* found, int32_t* lt, int P,
                                  int W, cudaStream_t stream) {
  if (P > 0) {
    const int blocks = (P + PROBES_PER_BLOCK - 1) / PROBES_PER_BLOCK;
    probe_kernel<<<blocks, THREADS, 0, stream>>>(seg_starts, bases, slopes, r_lo, n_valid,
                                                 cands, corr, found, lt, P, W);
  }
  return (int)cudaGetLastError();
}
