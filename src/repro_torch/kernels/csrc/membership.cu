// Fused membership scoring for Algorithm 3's f(t, .) scan:
// (Q,E) x (D,E)^T float32 logits + bias, thresholded against tau_q and packed
// 32 docs per word, bit i = doc lane i.
//
// Replaces: src/repro/kernels/membership/kernel.py, membership_bitmask
// (the Pallas MXU tile with an in-VMEM bit-pack).
//
// What bounds it on the H100: float32 FMA issue on the CUDA cores (67
// TFLOP/s published), and in practice how fast the SM can feed the FFMAs.
// The product has to stay true fp32: TF32 or bf16 tensor-core error is far
// above the thresholds' 1e-5 relative margin and would break zero false
// negatives, so wgmma does not apply.  The output is 32x smaller than the
// logits and the doc table streams from device memory once, so device
// memory is not the limit; moving tiles from L2 into shared memory is the
// next cost after the FFMAs.
//
// Design: a 128-query x 128-doc output tile per block of 256 threads, two
// blocks (16 warps) per SM.
// - Register tile 8 x 8 from k-major shared tiles: per dim a thread reads
//   queries 4 ty + {0..3} and + 16 and docs 4 tx + {0..3} and + 32 with four
//   LDS.128 (lane = 8 ty + tx; the reads cover 64 and 128 contiguous bytes)
//   and does 64 FFMA.  Each accumulator sums its E products in order with
//   fmaf.
// - Copies that move 16 bytes each: a stage of 16 dims of the block's
//   query and doc rows lands row-major by cp.async (4 per thread), while
//   the previous stage computes; then the block turns it into the k-major
//   tiles (LDS.128, STS.32 into 32 consecutive columns).  Copying straight
//   into k-major order takes 4-byte copies, which cost more than the FFMAs
//   gain.  Dims past E, rows past Q and D land as zeros (src-size 0) and a
//   zero product adds nothing, so any E works; E % 4 != 0 or an unaligned
//   table takes 4-byte copies.
// - The 128 x 128 tile moves a fifth fewer bytes per FFMA from L2 than
//   64 x 256; the one-dimensional grid runs the query tile fastest, so the
//   blocks that share a doc tile run side by side and meet it in L2.
// - Ragged Q: warps whose 32 query rows lie past Q only copy and sync, and
//   a warp whose upper 16 rows do skips their products (398 queries cost
//   400 rows of work).
// - Epilogue: each lane holds 4 adjacent docs per word, so a row's word is
//   its 8 lanes' nibbles OR-ed by three shuffles.  No logits are written,
//   no atomics; tail bits of the last word are zero because docs past D
//   never hit.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TM = 8, TN = 8;         // queries x docs per thread
constexpr int WARPS_M = 4, WARPS_N = 2;
constexpr int WQ = 4 * TM, WD = 8 * TN;  // warp tile: lanes are 4 (queries) x 8 (docs)
constexpr int BM = WARPS_M * WQ;      // queries per block (128)
constexpr int BN = WARPS_N * WD;      // docs per block (128)
constexpr int BK = 16;                // embedding dims per stage
constexpr int THREADS = 32 * WARPS_M * WARPS_N;
constexpr int LDA = BM + 4, LDB = BN + 4;  // k-major tiles [BK][LD]: LD = 4 mod 32
constexpr int LDS = BK + 4;                // row-major landing rows [BM + BN][LDS]
constexpr int KM_FLOATS = BK * (LDA + LDB);
constexpr int SMEM_BYTES = (KM_FLOATS + (BM + BN) * LDS) * (int)sizeof(float);  // 37,376
constexpr int CHUNKS = BK / 4;                         // 16-byte pieces of a row per stage
constexpr int COPIES = (BM + BN) * CHUNKS / THREADS;   // 4 per thread per stage
static_assert(BM * CHUNKS % THREADS == 0 && BN * CHUNKS % THREADS == 0 && BM >= 32 && BN >= 32,
              "whole pieces per thread, 32 consecutive rows per warp");

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(ok ? 4 : 0));
}

// Land dims [k0, k0 + BK) of the block's query rows (landing rows 0..BM-1)
// and doc rows (BM..BM+BN-1) row-major: 16-byte copies, CHUNKS per row, when
// the tables allow them (E % 4 == 0, aligned), else 4-byte copies.  Rows
// past Q or D and dims past E land as zeros.
template <bool VEC>
__device__ __forceinline__ void land(float* rows, const float* q, const float* d, int q0, int d0,
                                     int Q, int D, int E, int k0, int tid) {
  // E through an opaque move: the copy addresses are recomputed per stage
  // (a few integer ops) rather than hoisted out of the loop, where they would
  // hold registers through the products
  asm volatile("mov.b32 %0, %0;" : "+r"(E));
#pragma unroll
  for (int m = 0; m < COPIES; ++m) {
    const int f = tid + m * THREADS, r = f / CHUNKS, c = 4 * (f % CHUNKS);
    const bool is_q = r < BM;
    const float* g = is_q ? q : d;
    const int row = is_q ? q0 + r : d0 + r - BM, n = is_q ? Q : D;
    float* dst = rows + r * LDS + c;
    if constexpr (VEC) {
      const bool ok = row < n && k0 + c < E;
      cp_async16(dst, ok ? g + (size_t)row * E + k0 + c : g, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = row < n && k0 + c + e < E;
        cp_async4(dst + e, ok ? g + (size_t)row * E + k0 + c + e : g, ok);
      }
    }
  }
}

// Turn ROWS landed rows, from landing row `from`, into the k-major tile
// [BK][LD]: piece p = tid + m THREADS is row p % ROWS, dims 4 (p / ROWS) +
// [0, 4); a warp's stores hit 32 consecutive columns of a k-major row, so 32
// distinct banks.
template <int ROWS, int LD>
__device__ __forceinline__ void transpose(float* tile, const float* rows, int from, int tid) {
#pragma unroll
  for (int m = 0; m < ROWS * CHUNKS / THREADS; ++m) {
    const int p = tid + m * THREADS, r = p % ROWS, c = p / ROWS;
    const float4 v = *reinterpret_cast<const float4*>(rows + (from + r) * LDS + 4 * c);
    float* t = tile + 4 * c * LD + r;
    t[0] = v.x, t[LD] = v.y, t[2 * LD] = v.z, t[3 * LD] = v.w;
  }
}

__device__ __forceinline__ void transpose(float* km, const float* rows, int tid) {
  transpose<BM, LDA>(km, rows, 0, tid);
  transpose<BN, LDB>(km + BK * LDA, rows, BM, tid);
}

// One stage of products from the k-major tiles: rows (queries) qa + {0..3}
// and + 16, the first R of them; columns (docs) db + {0..3} and + 32.  Each
// dim is two LDS.128 of queries and two of docs for 8 x 8 FFMA.
template <int R>
__device__ __forceinline__ void products(float (&acc)[TM][TN], const float* km, int qa, int db) {
  const float* sa = km + qa;
  const float* sb = km + BK * LDA + db;
#pragma unroll
  for (int k = 0; k < BK; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(sa + k * LDA);
    const float4 a1 = R > 4 ? *reinterpret_cast<const float4*>(sa + k * LDA + 16) : a0;
    const float4 b0 = *reinterpret_cast<const float4*>(sb + k * LDB);
    const float4 b1 = *reinterpret_cast<const float4*>(sb + k * LDB + 32);
    const float a[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float b[TN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
membership_kernel(const float* __restrict__ q, const float* __restrict__ d,
                  const float* __restrict__ tau, float bias, uint32_t* __restrict__ out,
                  int Q, int D, int E, int words, int q_tiles) {
  extern __shared__ float4 smem4[];
  float* km = reinterpret_cast<float*>(smem4);  // the k-major tiles of one stage
  float* rows = km + KM_FLOATS;                 // the landing rows of the next
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ty = lane / 8, tx = lane % 8;
  const int q0 = (int)(blockIdx.x % q_tiles) * BM;
  const int d0 = (int)(blockIdx.x / q_tiles) * BN;
  const int wq = (warp / WARPS_N) * WQ, wd = (warp % WARPS_N) * WD;
  const bool live = q0 + wq < Q;  // warps of padding rows only copy and sync

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  const int stages = (E + BK - 1) / BK;
  land<VEC>(rows, q, d, q0, d0, Q, D, E, 0, tid);
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
  transpose(km, rows, tid);
  __syncthreads();
  for (int s = 0; s < stages; ++s) {
    const bool more = s + 1 < stages;
    if (more) {  // stage s + 1 lands while stage s computes
      land<VEC>(rows, q, d, q0, d0, Q, D, E, (s + 1) * BK, tid);
      asm volatile("cp.async.commit_group;\n" ::);
    }
    // a warp whose upper 16 query rows all lie past Q skips their products
    if (q0 + wq + WQ / 2 < Q) products<TM>(acc, km, wq + 4 * ty, wd + 4 * tx);
    else if (live) products<TM / 2>(acc, km, wq + 4 * ty, wd + 4 * tx);
    if (more) {
      asm volatile("cp.async.wait_group 0;\n" ::);
      __syncthreads();  // stage s + 1 has landed, and every warp is done with stage s
      transpose(km, rows, tid);
      __syncthreads();  // its k-major tiles are complete, and the landing rows free
    }
  }

  // row i of this thread is query wq + 4 ty + i % 4 + 16 (i / 4); its docs in
  // word h of the warp's two are 4 tx + {0..3}: a nibble, OR-ed over the 8
  // lanes of the row
  const int w0 = (d0 + wd) / 32;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gq = q0 + wq + 4 * ty + i % 4 + 16 * (i / 4);
    const float t = gq < Q ? tau[gq] : 0.f;
    uint32_t word[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t nib = 0;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int gd = d0 + wd + 32 * h + 4 * tx + c;
        nib |= (uint32_t)(gq < Q && gd < D && (acc[i][4 * h + c] + bias) >= t) << c;
      }
      uint32_t w = nib << (4 * tx);
      w |= __shfl_xor_sync(0xffffffffu, w, 1);
      w |= __shfl_xor_sync(0xffffffffu, w, 2);
      w |= __shfl_xor_sync(0xffffffffu, w, 4);
      word[h] = w;
    }
    if (tx == i && gq < Q) {
      if (w0 < words) out[(size_t)gq * words + w0] = word[0];
      if (w0 + 1 < words) out[(size_t)gq * words + w0 + 1] = word[1];
    }
  }
}

template <bool VEC>
cudaError_t launch(const float* q, const float* d, const float* tau, float bias, uint32_t* out,
                   int Q, int D, int E, int words, cudaStream_t stream) {
  static bool configured = false;  // the attribute is per function, set once
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        membership_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const int q_tiles = (Q + BM - 1) / BM, d_tiles = (D + BN - 1) / BN;
  membership_kernel<VEC><<<q_tiles * d_tiles, THREADS, SMEM_BYTES, stream>>>(
      q, d, tau, bias, out, Q, D, E, words, q_tiles);
  return cudaGetLastError();
}

}  // namespace

extern "C" int membership_bitmask_launch(const float* q, const float* d, const float* tau,
                                         float bias, uint32_t* out, int Q, int D, int E,
                                         int words, cudaStream_t stream) {
  if (Q <= 0 || D <= 0) return (int)cudaGetLastError();
  const bool vec = E % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(d) % 16 == 0;
  return (int)(vec ? launch<true>(q, d, tau, bias, out, Q, D, E, words, stream)
                   : launch<false>(q, d, tau, bias, out, Q, D, E, words, stream));
}
