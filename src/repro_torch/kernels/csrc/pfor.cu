// OptPFD decode of a batch of posting lists, d-gap prefix sum included:
// packed PFor blocks -> doc ids.
// Per PFor block b (meta row [width, word_off, blen, out_off, exc_off, n_exc,
// head, 0]):
//   gap[i] = bits [i*w, (i+1)*w) of the little-endian stream at word_off,
//   gap[pos_e] |= hi_e << w for each exception pair (pos_e, hi_e) stored at
//   exc_off, for i < blen; head = 1 marks the first block of a list.  The
//   lists lie end to end, blocks in order, and
//   id[out_off + i] = sum of the list's gaps up to and including i,
// summed in 64 bits and written as its low 32 bits.  out[n_out] is set to 1
// when any id exceeds INT32_MAX (the host raises, as undgaps does).
//
// Replaces: src/repro/kernels/pfor/kernel.py, unpack_blocks (one launch per
// static width over same-width blocks; exceptions patched and gaps summed on
// the host).
//
// What bounds it on the H100: memory, the packed words, exception pairs and
// meta rows read once and 4 bytes written per id; a few integer operations
// a value.  A small batch is bound by latency: one launch, one dependent
// chain of loads.
//
// Design: each warp decodes 4 consecutive PFor blocks (512 values), 8 lanes
// a block and 16 consecutive values a lane, and a CTA of 8 warps 32 blocks
// (4,096 values), so that every lane has many loads in flight and the fixed
// costs of a CTA (meta rows, barriers, look-back) spread over 4,096 values.
// The CTA's 32 meta rows land in shared memory in one coalesced read.  Each
// lane starts all its loads up front: up to 4 packed words of each of its
// warp's 4 blocks and its first exception pair.  The packed words go to a
// per-warp shared slice, each lane unpacks its 16 values from it, writes
// them back over the slice, and the exception pairs patch the slice under
// __syncwarp only.  A segmented warp scan of the lanes' 64-bit sums (a head
// block restarts it) gives each lane its prefix; the CTA then scans its 8
// warps' tail sums, restarting at every head, and carries the sum of a list
// that began in an earlier CTA with a single-pass decoupled look-back: each
// CTA publishes its tail sum at once (flag A, or P when the CTA holds a
// head), and warp 0 of a CTA whose first block continues a list reads up to
// 32 predecessors' status words at a time until it meets a P.  A CTA waits
// only on CTAs of lower index, which the hardware dispatches first (the
// order CUB's single-pass scan relies on as well).  The status words live
// in the output buffer past the overflow flag, and every launch zeroes flag
// and status words with one memset, so CUDA-graph replays stay right.  When
// a warp's 4 blocks are full and their output starts at a multiple of 4 ids,
// the ids go out as 16-byte stores, a warp's 512 bytes at a time; else as
// coalesced 4-byte stores a block at a time.  No shift by 32 is executed: a
// value reads its second word only when it straddles a word boundary
// (off + w > 32, so the shift is 1..31), and w == 32 takes the all-ones
// mask.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 128;           // values per PFor block (index/compress.py)
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int BPW = 4;               // PFor blocks per warp
constexpr int LPB = 32 / BPW;        // lanes per PFor block
constexpr int VPL = BLOCK / LPB;     // values per lane
constexpr int BPC = WARPS * BPW;     // PFor blocks per CTA
constexpr int WPL = BLOCK / 32;      // packed words a lane stages per block (w <= 32)
constexpr int META = 8;
constexpr unsigned FULL = 0xffffffffu;

typedef unsigned long long u64;

// status word: flag in the top two bits, the 62-bit sum below
constexpr u64 FLAG_AGG = 1ull << 62;  // the CTA's own tail sum
constexpr u64 FLAG_PRE = 2ull << 62;  // the tail sum from its list's start
constexpr u64 VALUE = (1ull << 62) - 1;

// A status word carries its value, so one 64-bit store publishes both and
// no other write needs ordering before it.
__device__ __forceinline__ void publish(u64* status, u64 word) {
  *reinterpret_cast<volatile u64*>(status) = word;
}

__device__ __forceinline__ u64 peek(const u64* status) {
  return *reinterpret_cast<const volatile u64*>(status);
}

// Sum of the tail sums before CTA `cta` back to the first one flagged P
// (inclusive), read by one warp 32 predecessors at a time.
__device__ u64 look_back(const u64* status, int cta, int lane) {
  u64 carry = 0;
  for (int pred = cta - 1;; pred -= 32) {
    const int idx = pred - lane;  // lane 0 reads the nearest predecessor
    u64 st;
    int first_pre;
    for (;;) {
      st = idx >= 0 ? peek(status + idx) : FLAG_PRE;  // before CTA 0: a P of 0
      const unsigned pre = __ballot_sync(FULL, (st >> 62) == 2);
      const unsigned unset = __ballot_sync(FULL, (st >> 62) == 0);
      first_pre = pre ? __ffs(pre) - 1 : 32;
      const unsigned needed = first_pre == 32 ? FULL : (2u << first_pre) - 1u;
      if (!(unset & needed)) break;
    }
    u64 v = lane <= first_pre ? (st & VALUE) : 0;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(FULL, v, d);
    carry += v;
    if (first_pre < 32) return carry;
  }
}

struct Block {  // one meta row, clamped so that no access leaves the warp's slice
  int w, word_off, blen, out_off, exc_off, n_exc, head;
};

__device__ __forceinline__ Block block_of(const int32_t* sm_meta, int b, bool live) {
  if (!live) return Block{0, 0, 0, 0, 0, 0, 0};
  const int32_t* m = sm_meta + b * META;
  return Block{min(m[0], 32), m[1], min(m[2], BLOCK), m[3], m[4], min(m[5], BLOCK), m[6]};
}

// the exception pair e of the warp's blocks -> its block (or -1), position, high bits
__device__ __forceinline__ int exception(const uint32_t* __restrict__ words,
                                         const int32_t* sm_meta, int wb0, int nwb, int e,
                                         uint32_t& pos, uint32_t& hi) {
  int first = 0;
#pragma unroll
  for (int b = 0; b < BPW; ++b) {
    const Block k = block_of(sm_meta, wb0 + b, b < nwb);
    if (e < first + k.n_exc) {
      const uint32_t* pair = words + k.exc_off + 2 * (e - first);
      pos = __ldg(pair);
      hi = __ldg(pair + 1);
      return b;
    }
    first += k.n_exc;
  }
  return -1;
}

__device__ __forceinline__ void patch(uint32_t* buf, const int32_t* sm_meta, int wb0, int b,
                                      uint32_t pos, uint32_t hi) {
  const Block k = block_of(sm_meta, wb0 + b, true);
  if (k.w < 32 && pos < (uint32_t)k.blen) buf[b * BLOCK + pos] |= hi << k.w;
}

__global__ void __launch_bounds__(THREADS, 4)
pfor_kernel(const uint32_t* __restrict__ words, const int32_t* __restrict__ meta,
            int n_blocks, uint32_t* __restrict__ out, uint32_t* overflow,
            u64* status) {
  __shared__ int32_t sm_meta[BPC * META];
  __shared__ __align__(16) uint32_t sm_buf[WARPS][BPW * BLOCK];  // packed words, then values
  __shared__ u64 sm_tail[WARPS];
  __shared__ int sm_head[WARPS];
  __shared__ u64 sm_carry;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int cta = blockIdx.x;
  const int b0 = cta * BPC;
  const int nb = min(BPC, n_blocks - b0);
  if (tid < nb * META) sm_meta[tid] = meta[(size_t)b0 * META + tid];
  __syncthreads();

  // ---- every load of the warp up front: packed words, the first exception
  const int wb0 = warp * BPW;
  const int nwb = max(0, min(BPW, nb - wb0));
  uint32_t* buf = sm_buf[warp];
  uint32_t staged[BPW][WPL];
#pragma unroll
  for (int b = 0; b < BPW; ++b) {
    const Block k = block_of(sm_meta, wb0 + b, b < nwb);
    const int n_words = (k.blen * k.w + 31) >> 5;
#pragma unroll
    for (int i = 0; i < WPL; ++i) {
      const int at = lane + 32 * i;
      staged[b][i] = at < n_words ? __ldg(words + k.word_off + at) : 0u;
    }
  }
  uint32_t pos0 = 0, hi0 = 0;
  const int exc0 = exception(words, sm_meta, wb0, nwb, lane, pos0, hi0);
#pragma unroll
  for (int b = 0; b < BPW; ++b) {
    const Block k = block_of(sm_meta, wb0 + b, b < nwb);
    const int n_words = (k.blen * k.w + 31) >> 5;
#pragma unroll
    for (int i = 0; i < WPL; ++i) {
      const int at = lane + 32 * i;
      if (at < n_words) buf[b * BLOCK + at] = staged[b][i];
    }
  }
  __syncwarp();

  // ---- unpack this lane's 16 values, then patch the exceptions in place
  const int lb = lane / LPB, first = (lane % LPB) * VPL;
  const Block own = block_of(sm_meta, wb0 + lb, lb < nwb);
  uint32_t x[VPL];
  {
    const uint32_t* src = buf + lb * BLOCK;
    const uint32_t mask = own.w >= 32 ? FULL : (1u << own.w) - 1u;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int v = first + i;
      uint32_t t = 0;
      if (v < own.blen && own.w > 0) {
        const int bitpos = v * own.w;
        const int off = bitpos & 31;
        const int p = bitpos >> 5;
        t = src[p] >> off;
        if (off + own.w > 32) t |= src[p + 1] << (32 - off);
        t &= mask;
      }
      x[i] = t;
    }
  }
  uint4* slot = reinterpret_cast<uint4*>(buf + lb * BLOCK + first);
  __syncwarp();  // every lane has read its packed words: the slice now takes values
#pragma unroll
  for (int q = 0; q < VPL / 4; ++q)
    slot[q] = make_uint4(x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]);
  __syncwarp();
  if (exc0 >= 0) patch(buf, sm_meta, wb0, exc0, pos0, hi0);
  for (int e = lane + 32;; e += 32) {  // pairs past the first 32 of the warp
    uint32_t pos, hi;
    const int b = exception(words, sm_meta, wb0, nwb, e, pos, hi);
    if (__ballot_sync(FULL, b >= 0) == 0) break;
    if (b >= 0) patch(buf, sm_meta, wb0, b, pos, hi);
  }
  __syncwarp();
#pragma unroll
  for (int q = 0; q < VPL / 4; ++q) {
    const uint4 g = slot[q];
    x[4 * q] = g.x, x[4 * q + 1] = g.y, x[4 * q + 2] = g.z, x[4 * q + 3] = g.w;
  }

  // ---- segmented warp scan of the lanes' sums (a head block restarts it)
  u64 total = 0;
#pragma unroll
  for (int i = 0; i < VPL; ++i) total += x[i];
  u64 incl = total;
  unsigned seg = (first == 0 && own.head) ? 1u : 0u;  // this lane starts a list
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const u64 y = __shfl_up_sync(FULL, incl, d);
    const unsigned g = __shfl_up_sync(FULL, seg, d);
    if (lane >= d) {
      if (!seg) incl += y;
      seg |= g;
    }
  }
  // seg: a list starts in lanes 0..lane of this warp; else this lane's list
  // continues from an earlier warp
  if (lane == 31) {
    sm_tail[warp] = incl;
    sm_head[warp] = seg;
  }
  __syncthreads();

  // ---- CTA scan of the warps' tail sums, restarting at every head
  u64 before = 0;    // this warp's prefix inside the CTA, from its list's start
  bool open = true;  // the list began before this CTA
  for (int k = warp - 1; k >= 0; --k) {
    before += sm_tail[k];
    if (sm_head[k]) {
      open = false;
      break;
    }
  }
  if (warp == 0) {
    u64 tail = 0;
    bool has_head = false;
    for (int k = 0; k < WARPS; ++k) {
      if (sm_head[k]) {
        tail = sm_tail[k];
        has_head = true;
      } else {
        tail += sm_tail[k];
      }
    }
    if (lane == 0) publish(status + cta, (has_head ? FLAG_PRE : FLAG_AGG) | (tail & VALUE));
    u64 carry = 0;
    if (!sm_meta[6]) {  // the CTA's first block continues a list
      carry = look_back(status, cta, lane);
      if (!has_head && lane == 0) publish(status + cta, FLAG_PRE | ((carry + tail) & VALUE));
    }
    if (lane == 0) sm_carry = carry;
  }
  __syncthreads();

  // ---- ids: carry + warp prefix + lane prefix + the lane's own sums
  u64 id = incl - total + (seg ? 0 : before + (open ? sm_carry : 0));
  bool over = false;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    id += x[i];
    over |= first + i < own.blen && id > 0x7fffffffull;
    x[i] = (uint32_t)id;
  }
  if (__any_sync(FULL, over) && lane == 0) atomicExch(overflow, 1u);
#pragma unroll
  for (int q = 0; q < VPL / 4; ++q)
    slot[q] = make_uint4(x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]);
  __syncwarp();
  const Block lead = block_of(sm_meta, wb0, nwb > 0);
  bool full = nwb == BPW && (lead.out_off & 3) == 0;
#pragma unroll
  for (int b = 0; b < BPW; ++b) {
    const Block k = block_of(sm_meta, wb0 + b, b < nwb);
    full &= k.blen == BLOCK && k.out_off == lead.out_off + b * BLOCK;
  }
  if (full) {
    uint4* dst = reinterpret_cast<uint4*>(out + lead.out_off);
    const uint4* src = reinterpret_cast<const uint4*>(buf);
#pragma unroll
    for (int q = 0; q < BPW * BLOCK / 128; ++q) dst[q * 32 + lane] = src[q * 32 + lane];
  } else {
    for (int b = 0; b < nwb; ++b) {
      const Block k = block_of(sm_meta, wb0 + b, true);
      for (int i = lane; i < k.blen; i += 32) out[k.out_off + i] = buf[b * BLOCK + i];
    }
  }
}

}  // namespace

// out: n_out ids, the overflow flag, one pad word when n_out is even, then
// one u64 status word per CTA of 32 blocks: 2 * ceil(n_blocks / 32) words
// (kernels/pfor/kernel.py sizes it).
extern "C" int pfor_decode_launch(const uint32_t* words, const int32_t* meta, int n_blocks,
                                  uint32_t* out, int n_out, cudaStream_t stream) {
  const int ctas = (n_blocks + BPC - 1) / BPC;
  const size_t head = (size_t)n_out + 1 + ((n_out + 1) & 1);
  u64* status = reinterpret_cast<u64*>(out + head);
  const size_t bytes = sizeof(uint32_t) * (head - n_out) + sizeof(u64) * (size_t)ctas;
  const cudaError_t err = cudaMemsetAsync(out + n_out, 0, bytes, stream);
  if (err != cudaSuccess) return (int)err;
  if (ctas > 0) pfor_kernel<<<ctas, THREADS, 0, stream>>>(words, meta, n_blocks, out,
                                                          out + n_out, status);
  return (int)cudaGetLastError();
}
