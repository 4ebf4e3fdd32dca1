// Batched decode of learned (plm/rmi) posting streams, ragged, corrections
// read packed.
// The lists of a batch lie end to end: posting i of the batch is rank r of
// list l, at flat position i = off_l + r, where off_l is the last list
// offset <= i.  List row l is [off_l, word_l, width_l, cmin_l]: its
// corrections are pack_bits(corr - cmin_l, width_l) from word word_l of the
// batch's correction words (postings/plm.py).  Segment g of the batch starts
// at flat position seg_pos[g] (ascending; every list's first segment starts
// at its rank 0).  For posting i, s = the last g with seg_pos[g] <= i, and
//   id[i] = base_s + rint(slope_s * f32(i - seg_pos[s]))
//           + bits [r*w, (r+1)*w) of the list's words + cmin_l
// in 32-bit wrapping arithmetic (exact for ids < 2^31).
//
// Replaces: src/repro/kernels/plm_decode/kernel.py, decode_batch (the
// Pallas (8-list, R, S) one-hot select over a padded batch of corrections
// the host had unpacked).
//
// What bounds it on the H100: memory, the packed correction bits, 12 bytes
// a segment and 16 a list read once, and 4 bytes written per id.
//
// Design: one CTA of 256 threads per 1,024 consecutive postings.  Warp 0
// finds the CTA's first segment and warp 1 its first list, each with one
// 32-way search (32 keys a step, so 4 steps reach a million); each warp then
// stages the rows that cover the CTA's range, 32 at a time, into shared
// memory: (start, base, slope) per segment, the list rows likewise, at most
// 1,024 of each.  A posting finds its segment and its list by a binary
// search over those few shared rows, not log2 S global loads.  Thread t
// takes postings t, t + 256, ..., so a warp's loads of packed words and its
// stores of ids are contiguous.  A value reads its second word only when it
// straddles a word boundary (off + w > 32, so the shift is 1..31), and
// w == 32 takes the all-ones mask.  Rounding matches the reference bit for
// bit: __fmul_rn forbids FMA contraction and __float2int_rn rounds half to
// even like jnp.rint.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int PER_THREAD = 4;
constexpr int RANGE = THREADS * PER_THREAD;  // postings per CTA
constexpr int LIST_COLS = 4;
constexpr unsigned FULL = 0xffffffffu;

// Last i in [0, n) with keys[i * stride] <= target, or -1; one warp, all
// lanes get the answer.
__device__ int warp_search(const int32_t* keys, int stride, int n, int target, int lane) {
  int lo = 0, hi = n;  // keys[lo - 1] <= target < keys[hi] (virtual ends)
  while (hi > lo) {
    const int span = hi - lo;
    const int idx = span <= 32 ? lo + lane : lo + (int)(((long long)lane * span) >> 5);
    const bool in = idx < hi && keys[(size_t)idx * stride] <= target;
    const unsigned le = __ballot_sync(FULL, in);
    const int c = __popc(le);  // keys ascend: the lanes <= target form a prefix
    if (span <= 32) return lo + c - 1;
    if (c == 0) return lo - 1;
    const int last = __shfl_sync(FULL, idx, c - 1);
    const int next = c < 32 ? __shfl_sync(FULL, idx, c < 32 ? c : 31) : hi;
    lo = last + 1;
    hi = next;
  }
  return lo - 1;
}

// Stage rows first, first + 1, ... whose key (column 0 of a row of `cols`
// int32) is < end into `dst` (column-major, RANGE rows); returns the count.
__device__ int stage_rows(const int32_t* rows, int cols, int n, int first, int end,
                          int32_t (*dst)[RANGE], int lane) {
  int count = 0;
  for (int at = first;; at += 32) {
    const int r = at + lane;
    const bool in = r < n && count + lane < RANGE && rows[(size_t)r * cols] < end;
    if (in)
      for (int c = 0; c < cols; ++c) dst[c][count + lane] = rows[(size_t)r * cols + c];
    const int got = __popc(__ballot_sync(FULL, in));
    count += got;
    if (got < 32) return count;
  }
}

// last of key[0 .. n) that is <= i, or 0 when none is
__device__ __forceinline__ int shared_search(const int32_t* key, int n, int i) {
  int lo = 0, hi = n;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (key[mid] <= i) lo = mid; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(THREADS)
decode_kernel(const int32_t* __restrict__ seg_pos, const int32_t* __restrict__ bases,
              const float* __restrict__ slopes, const int32_t* __restrict__ lists,
              const uint32_t* __restrict__ words, int32_t* __restrict__ out, int S, int L,
              int N) {
  __shared__ int32_t sm_seg[3][RANGE];  // start, base, slope bits
  __shared__ int32_t sm_list[LIST_COLS][RANGE];  // offset, first word, width, cmin
  __shared__ int sm_n[2];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int lo = blockIdx.x * RANGE;
  const int end = min(lo + RANGE, N);
  if (warp == 0) {
    // the segment covering lo (or -1: postings before any segment decode to
    // their correction alone), then every segment starting before end
    const int s0 = warp_search(seg_pos, 1, S, lo, lane);
    const int first = s0 < 0 ? 0 : s0;
    int count = 0;
    for (int at = first;; at += 32) {
      const int s = at + lane;
      const bool in = s < S && count + lane < RANGE && seg_pos[s] < end;
      if (in) {
        sm_seg[0][count + lane] = seg_pos[s];
        sm_seg[1][count + lane] = bases[s];
        sm_seg[2][count + lane] = __float_as_int(slopes[s]);
      }
      const int got = __popc(__ballot_sync(FULL, in));
      count += got;
      if (got < 32) break;
    }
    if (lane == 0) sm_n[0] = count;
  } else if (warp == 1) {
    const int l0 = warp_search(lists, LIST_COLS, L, lo, lane);
    const int count = stage_rows(lists, LIST_COLS, L, l0 < 0 ? 0 : l0, end, sm_list, lane);
    if (lane == 0) sm_n[1] = count;
  }
  __syncthreads();
  const int n_seg = sm_n[0], n_list = sm_n[1];
  for (int k = 0; k < PER_THREAD; ++k) {
    const int i = lo + k * THREADS + tid;
    if (i >= end) return;
    const int l = shared_search(sm_list[0], n_list, i);
    const uint32_t w = (uint32_t)sm_list[2][l];
    uint32_t v = 0;
    if (w > 0) {
      const long long bitpos = (long long)(i - sm_list[0][l]) * w;
      const uint32_t off = (uint32_t)(bitpos & 31);
      const uint32_t* p = words + sm_list[1][l] + (bitpos >> 5);
      v = __ldg(p) >> off;
      if (off + w > 32) v |= __ldg(p + 1) << (32 - off);
      if (w < 32) v &= (1u << w) - 1u;
    }
    uint32_t id = v + (uint32_t)sm_list[3][l];
    const int g = shared_search(sm_seg[0], n_seg, i);
    if (n_seg > 0 && sm_seg[0][g] <= i) {
      const float di = (float)(i - sm_seg[0][g]);
      id += (uint32_t)sm_seg[1][g] +
            (uint32_t)__float2int_rn(__fmul_rn(__int_as_float(sm_seg[2][g]), di));
    }
    out[i] = (int32_t)id;
  }
}

}  // namespace

extern "C" int decode_batch_launch(const int32_t* seg_pos, const int32_t* bases,
                                   const float* slopes, const int32_t* lists,
                                   const uint32_t* words, int32_t* out, int S, int L, int N,
                                   cudaStream_t stream) {
  if (N > 0) {
    const int blocks = (N + RANGE - 1) / RANGE;
    decode_kernel<<<blocks, THREADS, 0, stream>>>(seg_pos, bases, slopes, lists, words, out,
                                                  S, L, N);
  }
  return (int)cudaGetLastError();
}
