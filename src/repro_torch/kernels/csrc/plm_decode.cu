// Batched decode of learned (plm/rmi) posting streams, ragged.
// The lists of a batch are laid end to end: posting i of the batch is rank
// r of its list, at flat position i = offset(list) + r.  Segment g of the
// batch starts at flat position seg_pos[g] (ascending; every list's first
// segment starts at its rank 0).  For posting i, s = the last g with
// seg_pos[g] <= i, and
//   id[i] = base_s + rint(slope_s * f32(i - seg_pos[s])) + corr[i].
//
// Replaces: src/repro/kernels/plm_decode/kernel.py, decode_batch
// (the Pallas (8-list, R, S) one-hot select over a padded batch).
//
// What bounds it on the H100: memory.  Each id costs one correction read
// and one id write; the 12 bytes per segment are read once from HBM and then
// from L1/L2 by the binary searches of neighbouring threads.
//
// Design: one thread per posting, no padding.  The TPU kernel padded every
// list to the longest one and built a (R, S) one-hot, because the TPU has no
// cheap gather; here a batch of mostly short lists would spend most threads
// on padding, so the lists are flat and each thread binary-searches the
// batch's segment positions (i - seg_pos[s] equals the rank within the
// segment, so no per-list offsets are needed), then gathers (base, slope).
// Rounding matches the reference bit for bit: __fmul_rn forbids FMA
// contraction and __float2int_rn rounds half to even like jnp.rint.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
decode_kernel(const int32_t* __restrict__ seg_pos, const int32_t* __restrict__ bases,
              const float* __restrict__ slopes, const int32_t* __restrict__ corr,
              int32_t* __restrict__ out, int S, int N) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= N) return;
  // last s with seg_pos[s] <= i, or -1
  int lo = 0, hi = S;  // invariant: seg_pos[lo-1] <= i < seg_pos[hi] (virtual bounds)
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (seg_pos[mid] <= i) lo = mid + 1; else hi = mid;
  }
  const int s = lo - 1;
  int id = corr[i];
  if (s >= 0) {
    const float di = (float)(i - seg_pos[s]);
    id += bases[s] + __float2int_rn(__fmul_rn(slopes[s], di));
  }
  out[i] = id;
}

}  // namespace

extern "C" int decode_batch_launch(const int32_t* seg_pos, const int32_t* bases,
                                   const float* slopes, const int32_t* corr, int32_t* out,
                                   int S, int N, cudaStream_t stream) {
  if (N > 0) {
    const int blocks = (N + THREADS - 1) / THREADS;
    decode_kernel<<<blocks, THREADS, 0, stream>>>(seg_pos, bases, slopes, corr, out, S, N);
  }
  return (int)cudaGetLastError();
}
