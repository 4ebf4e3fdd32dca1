// Batched epsilon-window probes of the learned (plm/rmi) posting streams,
// corrections read packed from a device-resident arena.
// Probe row p is [l, g, r_lo, n, cand, slot]: ranks r_lo .. r_lo + n - 1 of
// segment g of learned term l, checked against doc id cand.  Term row l is
// [word_l, w_l, cmin_l] (its corrections are pack_bits(corr - cmin_l, w_l)
// from word word_l of the arena's words, postings/plm.py) and segment row g
// is [start, base, slope bits].  Rank r decodes to
//   id = base + rint(slope * f32(r - start))
//        + bits [r*w_l, (r+1)*w_l) of the words from word_l + cmin_l
// in 32-bit wrapping arithmetic (exact for ids < 2^31), and
//   found[slot] |= any(id == cand),  lt[slot] += count(id < cand).
//
// Replaces: src/repro/kernels/guided_search/kernel.py, probe_batch (the
// Pallas (8-probe, W) tile over a dense, zero-padded (P, W) matrix of
// corrections the host had unpacked), one call per (term, candidate set).
//
// What bounds it on the H100: memory, and at the sizes a verification
// round gives, launch latency.  The bytes: the packed words the windows
// touch (w_l bits a rank, 8-12 in the learned regime, against 32 for an
// unpacked correction), 24 bytes a probe row in, 8 bytes a slot out, and
// 12 bytes of segment row (and of term row) a probe.
//
// Design: one launch for a whole batch of probes of many terms: the
// segment tables and packed corrections of every learned term stay on the
// card, so a launch uploads only its probe rows.  One warp per row; the
// lanes stride over the window, each reading its packed value in place and
// a second word only when the value straddles a word boundary
// (off + w > 32, so the shift is 1..31; w == 32 takes the all-ones mask,
// w == 0 reads no word).  found comes from __any_sync and lt from
// __popc(__ballot_sync).  The host cuts a window longer than 1,024 ranks
// into rows of 1,024, one warp each; the rows of a slot combine by integer
// atomicOr/atomicAdd into outputs that one memset per launch zeroes, so the
// results do not depend on the order of the warps and a CUDA-graph replay
// starts from zero.  Rounding matches the reference bit for bit: __fmul_rn
// forbids contracting the product into an FMA, and __float2int_rn rounds
// half to even like jnp.rint.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int ROWS_PER_BLOCK = THREADS / 32;
constexpr int ROW_COLS = 6;
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(THREADS)
probe_kernel(const int32_t* __restrict__ rows, const int32_t* __restrict__ terms,
             const int32_t* __restrict__ segs, const uint32_t* __restrict__ words,
             int32_t* __restrict__ found, int32_t* __restrict__ lt, int R) {
  const int p = blockIdx.x * ROWS_PER_BLOCK + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (p >= R) return;  // warp-uniform
  // lanes 0..5 load the row, lanes 0..2 then the term row and 3..5 the
  // segment row, each broadcast by a shuffle
  const int v = lane < ROW_COLS ? __ldg(rows + (size_t)p * ROW_COLS + lane) : 0;
  const int term = __shfl_sync(FULL, v, 0), seg = __shfl_sync(FULL, v, 1);
  const int lo = __shfl_sync(FULL, v, 2), n = __shfl_sync(FULL, v, 3);
  const int cand = __shfl_sync(FULL, v, 4), slot = __shfl_sync(FULL, v, 5);
  int meta = 0;
  if (lane < 3) meta = __ldg(terms + (size_t)term * 3 + lane);
  else if (lane < 6) meta = __ldg(segs + (size_t)seg * 3 + (lane - 3));
  const uint32_t* base_word = words + __shfl_sync(FULL, meta, 0);
  const uint32_t w = (uint32_t)__shfl_sync(FULL, meta, 1);
  const uint32_t cmin = (uint32_t)__shfl_sync(FULL, meta, 2);
  const int start = __shfl_sync(FULL, meta, 3);
  const uint32_t base = (uint32_t)__shfl_sync(FULL, meta, 4);
  const float slope = __int_as_float(__shfl_sync(FULL, meta, 5));
  bool any = false;
  int below = 0;
  for (int j0 = 0; j0 < n; j0 += 32) {
    const int j = j0 + lane;
    bool eq = false, less = false;
    if (j < n) {
      const int r = lo + j;
      uint32_t val = 0;
      if (w > 0) {
        const long long bitpos = (long long)r * w;
        const uint32_t off = (uint32_t)(bitpos & 31);
        const uint32_t* q = base_word + (bitpos >> 5);
        val = __ldg(q) >> off;
        if (off + w > 32) val |= __ldg(q + 1) << (32 - off);
        if (w < 32) val &= (1u << w) - 1u;
      }
      const float di = (float)(r - start);
      const int32_t id = (int32_t)(base + (uint32_t)__float2int_rn(__fmul_rn(slope, di)) +
                                   val + cmin);
      eq = id == cand;
      less = id < cand;
    }
    any |= __any_sync(FULL, eq);
    below += __popc(__ballot_sync(FULL, less));
  }
  if (lane == 0) {
    if (any) atomicOr(found + slot, 1);
    if (below) atomicAdd(lt + slot, below);
  }
}

}  // namespace

// out is (2, n_out) int32: found, then lt; zeroed here before the probes.
extern "C" int probe_batch_launch(const int32_t* rows, const int32_t* terms,
                                  const int32_t* segs, const uint32_t* words, int32_t* out,
                                  int R, int n_out, cudaStream_t stream) {
  if (n_out > 0) {
    const cudaError_t err = cudaMemsetAsync(out, 0, sizeof(int32_t) * 2 * (size_t)n_out, stream);
    if (err != cudaSuccess) return (int)err;
  }
  if (R > 0) {
    const int blocks = (R + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
    probe_kernel<<<blocks, THREADS, 0, stream>>>(rows, terms, segs, words, out, out + n_out,
                                                 R);
  }
  return (int)cudaGetLastError();
}
