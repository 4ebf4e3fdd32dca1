// Fused membership scoring, the f(t, .) scan of Algorithms 1 and 3:
// (S,E) x (D,E)^T float32 logits + bias, thresholded against tau per slot
// and packed 32 docs a word (bit i = doc lane i).  Two entry points:
//   membership_bitmask_launch  every (slot, doc) pair: Algorithm 1's rows;
//   membership_masked_launch   only the docs of the blocks that survive
//                              the block AND of the slot's query:
//                              Algorithm 3's rows, zero words elsewhere.
//
// Replaces: src/repro/kernels/membership/kernel.py, membership_bitmask
// (the Pallas MXU tile with an in-VMEM bit-pack), which Algorithm 3 runs
// over every doc before the block AND (src/repro/core/algorithms.py,
// block_query); the masked launch scores only what that AND keeps.
//
// Arithmetic: every logit is an fp32 accumulator from 0, fmaf over e =
// 0..E-1 in order, then + bias, then >= tau; csrc/two_tier.cu sums the same
// way, so a two-tier candidate is an exhaustive one ANDed with the tier-1
// union, bit for bit.  Tensor cores (TF32, bf16, 3xTF32), split-K or any
// other order would break that identity, and their error is above the
// thresholds' 1e-5 relative margin.  A bf16 doc table is widened to fp32 on
// its way in (a shift: exact), so its words are those of the same table
// in fp32.
//
// What bounds it on the H100: fp32 FMA issue on the CUDA cores (67
// TFLOP/s published): a sub-partition issues one warp instruction a clock,
// so the bound is met only if nearly every issue slot is an FFMA that does
// not stall.  The doc table streams from device memory once and the words
// are 32x smaller than the logits: bytes are not the limit.  Measured
// (kernels/membership/bench.py, PERF.md §6): the hot loop is 128 FFMA in
// 138 instructions, yet the kernel reaches about two thirds of the FFMA
// bound at phase W's shape; the copies cost 4-11% (a build that copies
// nothing), and what stalls the rest is not known without a profiler of
// issue stalls.
//
// Design: one persistent CTA an SM, warp-specialised, no __syncthreads in
// the loop.
// - Work is a static list of items, each up to 128 slots x a tile of 256
//   docs, CTA b taking items b, b + grid, ...  Dense: every (slot tile, doc
//   tile), slot tiles fastest and rotated by the doc tile, so the CTAs in
//   flight share their doc tiles in L2 and each CTA cycles through the
//   ragged slot tile.  Masked: per doc tile, the slots whose query keeps
//   one of the tile's blocks, compacted in the launch (csrc/live_items.cuh)
//   and cut into items of 128 (Algorithm 3 at phase A's shape keeps about
//   56% of the (slot, word) cells: about 2 items a tile where the dense
//   launch has 3 1/4).
// - 4 helper warps (one a sub-partition): cp.async copies of 16 bytes land
//   a stage of 32 dims of the item's slot rows (gathered in the masked
//   launch) and doc rows row-major in a landing slot (pieces permuted per
//   row, so the reads below hit every bank once), completing on an
//   mbarrier; a stage later the helpers transpose it into a dim-major
//   stage (widening bf16) and complete its ``full`` barrier, with the
//   item's rows' slots, thresholds and live words staged once an item.
//   Two landing slots and two dim-major stages: the next item's first
//   stage lands and is transposed during this item's last and its
//   epilogue.
// - 8 consumer warps (setmaxnreg: 224 registers, the helpers 56): a thread
//   holds 16 slots x 8 docs; per dim it reads its slots' 4 float4 and its
//   docs' 2 (4 and 8 distinct addresses a warp) for 128 FFMA, then
//   releases the stage on ``empty``.  Reading row-major float4 pieces
//   instead (4 dims a read) paired each accumulator with four registers of
//   alternating banks, and an 8 x 8 tile fed 64 FFMA with 4 reads: both
//   measured slower (PERF.md §6).
// - Ragged items: slot row r = 32 g + 8 t + 4 w + i sits in column 64 w +
//   16 g + 4 t + i, so the first rows of an item fall to both warp rows and
//   to the first 4-slot groups; a warp runs G of its 4 groups (a template),
//   and an item of r slots costs about ceil(r / 32) / 4 of a full one (398
//   slots: 3 full items and one of 1/4).
// - Epilogue: each lane holds 4 adjacent docs a word, so a row's word is
//   its 8 lanes' nibbles OR-ed by three shuffles; no logits are written, no
//   atomics; docs past D never hit (tail bits zero).  The masked launch
//   zeroes its rows first and writes the words of its items, zero where the
//   word's block is dead for the slot's query.
// The wrapper pads E to a multiple of 4 (fp32 table) or 8 (bf16) and copies
// an unaligned table, so every row is whole 16-byte pieces.
#include <cstdint>
#include <cuda_runtime.h>

#include "live_items.cuh"

namespace {

constexpr int GROUPS = 4;             // 4-slot column groups a thread (16 slots)
constexpr int TM = 4 * GROUPS, TN = 8;  // slots x docs a thread
constexpr int WARPS_M = 2, WARPS_N = 4;
constexpr int CONSUMERS = WARPS_M * WARPS_N;  // warps 0..7: two warpgroups
constexpr int HELPERS = 4;                    // warps 8..11: one warpgroup, one a sub-partition
constexpr int HELPER_THREADS = 32 * HELPERS;
constexpr int THREADS = 32 * (CONSUMERS + HELPERS);
constexpr int CONSUMER_REGS = 224, HELPER_REGS = 56;  // setmaxnreg: 2 x 224 + 56 per sub-partition
constexpr int BM = 64 * WARPS_M;      // slots an item (128)
constexpr int BN = 64 * WARPS_N;      // docs a tile (256)
constexpr int KC = 32;                // dims a stage
constexpr int LDA = BM + 4, LDB = BN + 4;  // dim-major tiles [KC][LD]: LD = 4 mod 32
constexpr int KSTAGES = 2;            // dim-major stages the consumers read
constexpr int LSLOTS = 2;             // landing slots the copies fill
constexpr int MSLOTS = KSTAGES + 1;   // items whose rows' slots and thresholds are staged
constexpr int KM_FLOATS = KC * (LDA + LDB);
constexpr int LAND_BYTES = (BM + BN) * KC * 4;  // row-major rows as they land
constexpr int SMEM_BYTES = KSTAGES * KM_FLOATS * 4 + LSLOTS * LAND_BYTES;  // 198,656
constexpr unsigned FULL = 0xffffffffu;
static_assert(KC == 32 && BM == HELPER_THREADS && BN == 2 * HELPER_THREADS,
              "8 pieces a landed row; a helper lane transposes one slot row and two doc rows");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// an arrival on ``bar`` once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void bar_arrive_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

// until the phase of parity ``parity`` has completed
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// the helper warps alone (named barrier 1)
__device__ __forceinline__ void helpers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(HELPER_THREADS) : "memory");
}

// 16 bytes from global to shared memory, zeros where !ok
__device__ __forceinline__ void copy16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}

// A ring position: slot index and the parity of its current phase.
template <int N>
struct Ring {
  int s = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void next() {
    if (++s == N) s = 0, phase ^= 1u;
  }
};

struct Args {
  const float* q;      // (S, E) slot rows
  const void* d;       // (D, E) doc rows, fp32 or bf16
  bool bf16;
  const float* tau;    // (S,)
  float bias;
  uint32_t* out;       // (S, words)
  int S, D, E, words;
  // masked only
  const int4* items;   // (tile, first position, count)
  const int* n_items;
  const int* tile_slots;
  const uint32_t* anded;
  const int32_t* slot_query;
  int Wb, block_words;
};

// Slot row r = 32 g + 8 t + 4 w + i of an item (g, t < 4; w < 2; i < 4) is
// column 64 w + 16 g + 4 t + i of the dim-major slot tile: warp row w's
// lane row t reads groups g, and the first rows of a ragged item fall to
// both warp rows and to the first groups (an item of r slots costs about
// ceil(r / 32) / 4 of a full one).
__device__ __forceinline__ int slot_row(int col) {
  return 32 * ((col >> 4) & 3) + 8 * ((col >> 2) & 3) + 4 * (col >> 6) + (col & 3);
}

// Landed rows are KC floats (8 pieces of 16 bytes; bf16 doc rows 4
// pieces), each row's pieces permuted so that the 8 rows a transpose reads
// at once hit distinct banks.
__device__ __forceinline__ int slot_swz(int r) { return (r & 3) | ((r >> 1) & 4); }
__device__ __forceinline__ int doc_swz(int r) { return r & 7; }
__device__ __forceinline__ int bf16_swz(int r) { return (r >> 1) & 3; }

// The products of one stage's kc dims from the dim-major tiles: slot
// columns sa + 16 g + [0, 4) for the first G groups, doc columns sb +
// [0, 4) and + 32.  Each dim is G + 2 LDS.128 for 4 G x 8 FFMA, each doc
// value reused across the 4 G slots (faster than the other order, PERF.md
// §6); each accumulator sums its dims in order.
template <int G>
__device__ __forceinline__ void products(float (&acc)[TM][TN], const float* sa, const float* sb,
                                         int kc) {
  const float* const end = sb + kc * LDB;
#pragma unroll 1
  for (; sb != end; sa += LDA, sb += LDB) {
    float a[4 * G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float4 v = *reinterpret_cast<const float4*>(sa + 16 * g);
      a[4 * g] = v.x, a[4 * g + 1] = v.y, a[4 * g + 2] = v.z, a[4 * g + 3] = v.w;
    }
    const float4 b0 = *reinterpret_cast<const float4*>(sb);
    const float4 b1 = *reinterpret_cast<const float4*>(sb + 32);
    const float b[TN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int j = 0; j < TN; ++j)
#pragma unroll
      for (int i = 0; i < 4 * G; ++i) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// An item's rows as the epilogue reads them, staged by the helpers: each
// row's slot (-1 past the item), threshold and, masked, the liveness of the
// tile's 8 words for the slot's query (bit h: word h).
struct Meta {
  int slot[BM];
  float tau[BM];
  uint8_t alive[BM];
};

// An item: its doc tile, its slot rows (count, first position) and, for the
// masked launch, its doc tile's list of live slots.
struct Item {
  int d0, rows, first;
  const int* slots;  // masked: slot of row r = slots[r]; dense: first + r
  __device__ __forceinline__ int slot(int r) const { return slots ? slots[r] : first + r; }
};

// Dense items: every (slot tile, doc tile), slot tiles fastest, each doc
// tile's slot tiles rotated by its index, so that a CTA's items (a stride
// of the grid apart) cycle through the slot tiles, the ragged one too.
template <bool MASKED>
__device__ __forceinline__ Item decode(const Args& a, int it, int q_tiles) {
  Item m;
  if (MASKED) {
    const int4 v = a.items[it];
    m.d0 = v.x * BN, m.first = v.y, m.rows = v.z;
    m.slots = a.tile_slots + (size_t)v.x * a.S + v.y;
  } else {
    const int d = it / q_tiles;
    m.d0 = d * BN, m.first = ((it + d) % q_tiles) * BM;
    m.rows = min(BM, a.S - m.first), m.slots = nullptr;
  }
  return m;
}

// The helpers' copies of one stage into a landing slot: lane hl takes
// piece hl % 8 of slot and (fp32) doc rows hl / 8 + 16 k, or piece hl % 4
// of bf16 doc rows hl / 4 + 32 k; rows past the item and dims past E land
// as zeros.
__device__ __forceinline__ void issue(const Args& a, const Item& m, const int (&src)[BM / 16],
                                      int k0, unsigned char* slot, int hl) {
  float* lq = reinterpret_cast<float*>(slot);
  const int piece = hl % 8, c = k0 + 4 * piece;
#pragma unroll
  for (int k = 0; k < BM / 16; ++k) {
    const int r = hl / 8 + 16 * k;
    const bool ok = src[k] >= 0 && c < a.E;
    copy16(lq + r * KC + 4 * (piece ^ slot_swz(r)), ok ? a.q + (size_t)src[k] * a.E + c : a.q,
           ok);
  }
  if (a.bf16) {
    const uint16_t* d = static_cast<const uint16_t*>(a.d);  // bf16 bit patterns
    unsigned char* ld = slot + BM * KC * 4;
    const int p = hl % 4, cb = k0 + 8 * p;
#pragma unroll 4
    for (int k = 0; k < BN / 32; ++k) {
      const int r = hl / 4 + 32 * k, doc = m.d0 + r;
      const bool ok = doc < a.D && cb < a.E;
      copy16(ld + r * KC * 2 + 16 * (p ^ bf16_swz(r)), ok ? d + (size_t)doc * a.E + cb : d, ok);
    }
  } else {
    const float* d = static_cast<const float*>(a.d);
    float* ld = lq + BM * KC;
#pragma unroll 4
    for (int k = 0; k < BN / 16; ++k) {
      const int r = hl / 8 + 16 * k, doc = m.d0 + r;
      const bool ok = doc < a.D && c < a.E;
      copy16(ld + r * KC + 4 * (piece ^ doc_swz(r)), ok ? d + (size_t)doc * a.E + c : d, ok);
    }
  }
}

// A landed slot into a dim-major stage: lane hl moves the slot row of
// column hl and doc rows hl and hl + 128, widening bf16 (a shift: exact).
__device__ __forceinline__ void transpose(const Args& a, const unsigned char* slot, float* km,
                                          int hl) {
  const float* lq = reinterpret_cast<const float*>(slot);
  const int r = slot_row(hl);
#pragma unroll
  for (int p = 0; p < KC / 4; ++p) {
    const float4 v = *reinterpret_cast<const float4*>(lq + r * KC + 4 * (p ^ slot_swz(r)));
    float* o = km + 4 * p * LDA + hl;
    o[0] = v.x, o[LDA] = v.y, o[2 * LDA] = v.z, o[3 * LDA] = v.w;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int dr = hl + HELPER_THREADS * h;
    float* kb = km + KC * LDA + dr;
    if (a.bf16) {
      const unsigned char* ld = slot + BM * KC * 4;
#pragma unroll
      for (int p = 0; p < KC / 8; ++p) {
        const uint4 v =
            *reinterpret_cast<const uint4*>(ld + dr * KC * 2 + 16 * (p ^ bf16_swz(dr)));
        float* o = kb + 8 * p * LDB;
        const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          o[(2 * e) * LDB] = __uint_as_float(w[e] << 16);
          o[(2 * e + 1) * LDB] = __uint_as_float(w[e] & 0xffff0000u);
        }
      }
    } else {
      const float* ld = lq + BM * KC;
#pragma unroll
      for (int p = 0; p < KC / 4; ++p) {
        const float4 v = *reinterpret_cast<const float4*>(ld + dr * KC + 4 * (p ^ doc_swz(dr)));
        float* o = kb + 4 * p * LDB;
        o[0] = v.x, o[LDB] = v.y, o[2 * LDB] = v.z, o[3 * LDB] = v.w;
      }
    }
  }
}

template <bool MASKED>
__global__ void __launch_bounds__(THREADS, 1)
membership_kernel(const Args a, int q_tiles, int dense_items) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* km_base = reinterpret_cast<float*>(smem);
  unsigned char* land = smem + (size_t)KSTAGES * KM_FLOATS * 4;
  __shared__ __align__(8) uint64_t full[KSTAGES], empty[KSTAGES], landed[LSLOTS];
  __shared__ Meta meta[MSLOTS];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < KSTAGES; ++s) {
      bar_init(&full[s], HELPER_THREADS);
      bar_init(&empty[s], CONSUMERS);
    }
    for (int s = 0; s < LSLOTS; ++s) bar_init(&landed[s], HELPER_THREADS);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int E = a.E, chunks = (E + KC - 1) / KC;
  const int total = MASKED ? *a.n_items : dense_items;

  if (warp >= CONSUMERS) {
    // helpers: stage n's rows land in slot n % LSLOTS; LSLOTS - 1 stages
    // later the slot is transposed into a dim-major stage for the
    // consumers, with the item's rows' slots and thresholds at its first
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(HELPER_REGS));
    const int hl = threadIdx.x - 32 * CONSUMERS;
    Ring<LSLOTS> issued, landing;  // the slot to fill next, the slot to transpose next
    Ring<KSTAGES> kr;
    int behind = 0, done = 0;  // stages not yet transposed; stages transposed
    auto transpose_next = [&]() {
      bar_wait(&landed[landing.s], landing.phase);
      bar_wait(&empty[kr.s], kr.phase ^ 1u);
      transpose(a, land + (size_t)landing.s * LAND_BYTES, km_base + (size_t)kr.s * KM_FLOATS, hl);
      if (done % chunks == 0) {  // the first stage of an item: its rows (lane hl: row hl)
        const int j = done / chunks;
        const Item m = decode<MASKED>(a, blockIdx.x + j * gridDim.x, q_tiles);
        Meta& mt = meta[j % MSLOTS];
        const int slot = hl < m.rows ? m.slot(hl) : -1;
        mt.slot[hl] = slot;
        mt.tau[hl] = slot >= 0 ? a.tau[slot] : 0.f;
        if (MASKED) {
          uint32_t bits = 0;
          if (slot >= 0) {
            const uint32_t* row = a.anded + (size_t)a.slot_query[slot] * a.Wb;
            const int w0 = m.d0 / 32;
            for (int h = 0; h < BN / 32 && w0 + h < a.words; ++h)
              bits |= (uint32_t)live::block_live(row, (w0 + h) / a.block_words) << h;
          }
          mt.alive[hl] = (uint8_t)bits;
        }
      }
      bar_arrive(&full[kr.s]);
      helpers_sync();  // every lane is done reading the slot before it is refilled
      landing.next(), kr.next();
      --behind, ++done;
    };
    for (int it = blockIdx.x; it < total; it += gridDim.x) {
      const Item m = decode<MASKED>(a, it, q_tiles);
      int src[BM / 16];  // this lane's slot rows hl / 8 + 16 k
#pragma unroll
      for (int k = 0; k < BM / 16; ++k) {
        const int r = hl / 8 + 16 * k;
        src[k] = r < m.rows ? m.slot(r) : -1;
      }
      for (int k0 = 0; k0 < E; k0 += KC) {
        issue(a, m, src, k0, land + (size_t)issued.s * LAND_BYTES, hl);
        bar_arrive_copies(&landed[issued.s]);
        issued.next();
        if (++behind == LSLOTS) transpose_next();  // the slot issued next is free
      }
    }
    while (behind > 0) transpose_next();
    return;
  }

  // consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
  const int wm = warp % WARPS_M, wn = warp / WARPS_M;
  const int ty = lane / 8, tx = lane % 8;
  const int qa = 64 * wm + 4 * ty, db = 64 * wn + 4 * tx;
  Ring<KSTAGES> kr;
  for (int it = blockIdx.x, j = 0; it < total; it += gridDim.x, ++j) {
    const Item m = decode<MASKED>(a, it, q_tiles);
    // this warp's rows: 32 g + 8 ty + 4 wm + [0, 4); group g holds a valid
    // row iff 32 g + 4 wm < rows
    const int G = max(0, min(GROUPS, (m.rows - 4 * wm + 31) / 32));
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < E; k0 += KC) {
      bar_wait(&full[kr.s], kr.phase);
      const float* km = km_base + (size_t)kr.s * KM_FLOATS;
      const int kc = min(KC, E - k0);
      const float *sa = km + qa, *sb = km + KC * LDA + db;
      switch (G) {
        case 4: products<4>(acc, sa, sb, kc); break;
        case 3: products<3>(acc, sa, sb, kc); break;
        case 2: products<2>(acc, sa, sb, kc); break;
        case 1: products<1>(acc, sa, sb, kc); break;
        default: break;
      }
      __syncwarp();
      if (lane == 0) bar_arrive(&empty[kr.s]);
      kr.next();
    }

    // row i of this thread is item row 32 (i / 4) + 8 ty + 4 wm + i % 4 (its
    // slot and threshold staged at the item's first stage, so visible since
    // that stage's full barrier); its docs in word h of the warp's two are
    // 4 tx + [0, 4): a nibble, OR-ed over the 8 lanes of the row
    const Meta& mt = meta[j % MSLOTS];
    const int w0 = (m.d0 + 64 * wn) / 32;
    uint32_t docs_ok = 0;  // bit 4 h + c: this thread's doc 32 h + c of the tile lies before D
#pragma unroll
    for (int c = 0; c < TN; ++c) docs_ok |= (uint32_t)(m.d0 + db + 32 * (c / 4) + c % 4 < a.D) << c;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = 32 * (i / 4) + 8 * ty + 4 * wm + i % 4;
      const int slot = mt.slot[r];
      const float t = mt.tau[r];
      const bool ok = slot >= 0;
      uint32_t word[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t nib = 0;
#pragma unroll
        for (int c = 0; c < 4; ++c) nib |= (uint32_t)((acc[i][4 * h + c] + a.bias) >= t) << c;
        nib &= ok ? docs_ok >> (4 * h) & 0xfu : 0u;
        uint32_t w = nib << (4 * tx);
        w |= __shfl_xor_sync(FULL, w, 1);
        w |= __shfl_xor_sync(FULL, w, 2);
        w |= __shfl_xor_sync(FULL, w, 4);
        word[h] = w;
      }
      if (tx == i % 8 && ok) {
        const uint32_t alive = MASKED ? mt.alive[r] >> (2 * wn) : 3u;  // this warp's 2 words
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int w = w0 + h;
          if (w < a.words) a.out[(size_t)slot * a.words + w] = (alive >> h) & 1u ? word[h] : 0u;
        }
      }
    }
  }
}

// CTAs that fit on the card at once, one an SM
int resident_ctas() {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

template <bool MASKED>
cudaError_t launch(const Args& a, int grid, int q_tiles, int dense_items, cudaStream_t stream) {
  static bool configured = false;  // the attribute is per function, set once
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        membership_kernel<MASKED>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  membership_kernel<MASKED><<<grid, THREADS, SMEM_BYTES, stream>>>(a, q_tiles, dense_items);
  return cudaGetLastError();
}

bool shapes_ok(const float* q, const void* d, int d_bf16, int E) {
  // whole 16-byte pieces in every row (the wrapper pads E and copies an
  // unaligned table)
  const int piece = d_bf16 ? 8 : 4;
  return E > 0 && E % piece == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(d) % 16 == 0;
}

}  // namespace

// Algorithm 1's rows: every (slot, doc) pair, every word written.  d is
// (D, E) fp32 (d_bf16 = 0) or bf16 (1).  Returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for rows that are not whole 16-byte
// pieces.
extern "C" int membership_bitmask_launch(const float* q, const void* d, int d_bf16,
                                         const float* tau, float bias, uint32_t* out, int S,
                                         int D, int E, int words, cudaStream_t stream) {
  if (!shapes_ok(q, d, d_bf16, E)) return (int)cudaErrorInvalidValue;
  if (S <= 0 || D <= 0) return (int)cudaGetLastError();
  Args a{q, d, d_bf16 != 0, tau, bias, out, S, D, E, words,
         nullptr, nullptr, nullptr, nullptr, nullptr, 0, 1};
  const int q_tiles = (S + BM - 1) / BM, d_tiles = (D + BN - 1) / BN;
  const long long items = (long long)q_tiles * d_tiles;
  const int grid = (int)(items < resident_ctas() ? items : resident_ctas());
  return (int)launch<false>(a, grid, q_tiles, (int)items, stream);
}

// Algorithm 3's rows: only the docs of blocks that survive the block AND of
// the slot's query.  table (n_terms, Wb) block words, terms (Q, T) (-1 =
// pad), slot_query (S,) the query of each slot, block_words = block size /
// 32.  scratch (ints): [0] the item count, [1, 4) unused, then the items
// (n_tiles * ceil(S / 128) int4), the block AND (Q * Wb) and each tile's
// live slots (n_tiles * S); n_tiles = ceil(D / 256).  The rows and the
// count are zeroed here, then the rows written in live blocks.
extern "C" int membership_masked_launch(const float* q, const void* d, int d_bf16,
                                        const float* tau, float bias, uint32_t* out, int S, int D,
                                        int E, int words, const uint32_t* table, int Wb,
                                        const int32_t* terms, int Q, int T,
                                        const int32_t* slot_query, int block_words, int* scratch,
                                        cudaStream_t stream) {
  if (!shapes_ok(q, d, d_bf16, E) || block_words < 1) return (int)cudaErrorInvalidValue;
  if (S <= 0 || words <= 0) return (int)cudaGetLastError();
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(uint32_t) * (size_t)S * words, stream);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(scratch, 0, sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (D + BN - 1) / BN, chunks = (S + BM - 1) / BM;
  int4* items = reinterpret_cast<int4*>(scratch + 4);
  uint32_t* anded = reinterpret_cast<uint32_t*>(scratch + 4 + 4 * (size_t)n_tiles * chunks);
  int* tile_slots = reinterpret_cast<int*>(anded + (size_t)Q * Wb);
  const int and_grid = (Q * Wb + 255) / 256 < 1024 ? (Q * Wb + 255) / 256 : 1024;
  if (and_grid > 0) live::block_and_kernel<<<and_grid, 256, 0, stream>>>(table, Wb, terms, Q, T, anded);
  live::live_items_kernel<BM, BN><<<n_tiles, 256, 0, stream>>>(
      anded, Wb, slot_query, S, words, block_words, tile_slots, items, scratch);
  Args a{q, d, d_bf16 != 0, tau, bias, out, S, D, E, words,
         items, scratch, tile_slots, anded, slot_query, Wb, block_words};
  const int most = n_tiles * chunks;
  const int grid = most < resident_ctas() ? most : resident_ctas();
  return (int)launch<true>(a, grid, 0, 0, stream);
}
