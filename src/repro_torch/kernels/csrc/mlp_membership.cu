// Membership scoring with the MLP head, thresholded and packed: for a
// (slot, doc) pair, h = gelu_tanh(A[slot] + Bd[doc]), the head's later
// layers, + bias, >= tau[slot], 32 docs a word (bit i = doc lane i).
// Three entry points:
//   mlp_membership_launch  every (slot, doc) pair: Algorithm 1's rows;
//   mlp_masked_launch      only the docs of the blocks that survive the
//                          slot's query's block AND: Algorithm 3's rows,
//                          zero words in dead blocks;
//   mlp_two_tier_launch    only the union of each query's tier-1 lists,
//                          the docs that pass every valid slot: Algorithm
//                          2's candidates.
//
// Replaces: src/repro/core/membership.py:66-74, term_doc_logits' MLP branch
// (XLA, not Pallas: a broadcast (Q, D, 2E) pairing through nn.mlp on doc
// tiles, thresholded by the algorithms), and, for a head,
// src/repro/core/algorithms.py:97-116 (two_tier_query's per_query, which
// scores the union's docs through it).  At phase A's width that pairing
// would be 398 x 528,000 x 128 floats, about 108 GB: here no pair's
// activations leave the registers.
//
// Inputs: A = te[terms] @ W1[:E] (S, H1) and Bd = doc_embed @ W1[E:] + b1
// (D, H1), the first layer's two halves (plain products outside the
// kernel, as the reference leaves them to XLA); the later layers packed
// flat (each w row-major (h_in, h_out), then its b) with their dims
// (H1, ..., 1); tau per slot; the scalar bias.  Rows are (S, ceil(D/32))
// words, tail bits past D zero.  Given a non-null ``logits`` (S, D), the
// dense and masked launches also write the logit of every pair they score
// (for checks against the plain version; the serving path passes null).
//
// Arithmetic: true fp32, one order everywhere.  gelu_tanh(x) = 0.5 x (1 +
// tanh u), u = sqrt(2/pi) (x + 0.044715 x^3), in its equal form x sigma(2u)
// = x / (1 + 2^t) with t = -2 log2(e) u = x (C1 + C3 x^2), on the
// special-function unit (SFU) and with no branch (the library tanhf
// branches on |u|, and a warp with mixed lanes ran both paths): one
// ex2.approx a unit and one rcp.approx a pair of units (1/d0 = d1 / (d0
// d1)), t capped at 63 so that the product stays finite.  For very
// negative x the unit gives x 2^-63 (under 4e-18 on [-30, 0]) where GELU's
// limit is -0; for large x it gives x.  In float32 its error against
// float64 is about the tanhf form's (tests/test_torch_mlp.py pins both).
// The deep path evaluates each unit alone, uncapped (-0 in the limit).
// Each pair's sum is an accumulator from 0 with fmaf(w[k], gelu(A[k] +
// Bd[k]), acc) over k in order (units padded to a multiple of 4 with zero
// weights), then + b_last, then + bias; the three kernels share it, so a
// two-tier candidate is Algorithm 1's bit ANDed with the union, exactly.
// The plain version sums in a matrix product's order, so a bit may differ
// from it only next to tau (inside NUMERIC_MARGIN, which the threshold fit
// reserves for this).
//
// What bounds it on the H100: operations, on the SFU.  A unit costs 1.5
// SFU results and about 9.5 fp32 instructions (the add, t's three and its
// cap, 1 +, the pair's products, x r, the FMA into the logit); the SFU
// gives 16 results a clock an SM against 128 fp32 lanes, so the SFU (12
// lane-clocks a warp-unit) and the issue slots (about 11) bind together.
// Evaluating both reciprocals on the SFU (2 results a unit), Newton steps
// on the fmaf pipe, one reciprocal for four units, or the library tanhf
// were each slower at phase M's shape (PERF.md §6,
// kernels/mlp_membership/bench.py --gelu).  Tensor cores do not apply to
// the one-hidden-layer head: its only product (H1 -> 1) is a dot per pair,
// and the non-linearity sits between the halves' sum and it.
//
// Design, one hidden layer (the shallow path, mlp_hidden = (H1,)):
// - Work is a list of items, each 16 slots x a tile of 512 docs (16
//   words).  A CTA of 8 warps takes items from the list (a persistent
//   grid); a warp scores 8 slots x 128 docs, a lane 8 slots x 4 docs (lane
//   + 32 j), so a slot's word is one __ballot_sync and the 32 words of a
//   warp land one a lane for the store.
// - Hidden units go 32 at a time through shared memory, the item's A rows
//   and the tile's Bd rows as they lie in device memory (16-byte loads,
//   rows padded to 36 floats, so the lanes' 16-byte reads of 8 consecutive
//   rows hit every bank once); per 4 units a lane reads its 4 docs' float4,
//   each slot's float4 (a broadcast) and the weights' float4: 13 reads for
//   128 GELUs.
// - Dense: the items are every (tile, 16 consecutive slots).  Masked: a
//   first kernel ANDs each query's block words from the shard's table, a
//   second lists, per tile, the slots whose query keeps one of the tile's
//   blocks and cuts the list into items of 16 (both csrc/live_items.cuh,
//   which the masked membership launch shares; an atomic counter sizes the
//   list on the card, so a CUDA-graph replay rebuilds it); the slots of
//   one item may belong to different queries.  No CTA or warp spends time
//   on a dead (slot, tile); inside a live tile, a word whose block is dead
//   (blocks smaller than a tile) is written zero.  The launch zeroes the
//   rows first: dead cells are never touched again.
// - Two-tier: a CTA takes one query and a share of the positions of its
//   valid slots' tier-1 lists, as csrc/two_tier.cu does: a lane claims a
//   doc with atomicOr on the query's word (the one that sets the bit
//   scores it), a warp queues its claimed docs and scores 32 at a time, a
//   doc a lane, slot after slot: its row goes through a per-warp tile 32
//   units at a time (16-byte loads, 4 rows an instruction), the slots' A
//   rows and the weights sit in shared memory; a doc that fails a slot
//   has its bit cleared with atomicAnd.  The launch zeroes the bitmap with
//   its own memset.
// Deeper heads (the deep path): a thread scores one (slot, doc) pair with
// every later layer's weights in shared memory and the pair's hidden
// vectors in thread-local arrays (width at most MAX_WIDTH); dense and
// masked launches give a warp one (slot, word) (masked: skipped when its
// block is dead), the two-tier launch a lane one claimed doc.  Simple and
// right; no configuration runs it, and its tensor-core layers are not
// written.
#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

#include "live_items.cuh"

namespace {

using live::block_live;

constexpr int MAX_LAYERS = 4;   // layers after the first
constexpr int MAX_WIDTH = 256;  // hidden widths after the first layer (deep path)
constexpr int MAX_TERMS = 64;   // query slots the two-tier launch keeps in shared memory
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int TS = 8;                   // slots a warp and a lane (shallow path)
constexpr int TD = 4;                   // docs a lane: lane + 32 j
constexpr int WARPS_S = 2, WARPS_D = 4;
constexpr int BS = TS * WARPS_S;        // 16 slots an item
constexpr int BD = 32 * TD * WARPS_D;   // 512 docs a tile
constexpr int KC = 32;                  // hidden units a stage
constexpr int RS = KC + 4;              // floats between staged rows
constexpr int CTAS_PER_SM = 2;

// t = -2 log2(e) sqrt(2/pi) (x + 0.044715 x^3) = x (C1 + C3 x^2)
constexpr float C1 = -2.302208198144325f;    // -2 log2(e) sqrt(2/pi)
constexpr float C3 = -0.1029432395800235f;   // C1 * 0.044715
constexpr float T_MAX = 63.0f;               // d = 1 + 2^t <= 2^63: d0 d1 is finite

struct Dims {
  int n;                    // layers after the first
  int h[MAX_LAYERS + 1];    // h[0] = H1, h[n] = 1
};

__device__ __forceinline__ float ex2_approx(float t) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(t));
  return y;
}

__device__ __forceinline__ float rcp_approx(float d) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(d));
  return y;
}

// gelu_tanh(x) = x / (1 + 2^t), one unit (the deep path)
__device__ __forceinline__ float gelu_tanh(float x) {
  const float t = x * fmaf(C3, x * x, C1);
  return x * rcp_approx(1.0f + ex2_approx(t));
}

// 1 + 2^t with t capped at T_MAX, so that a product of two stays finite
__device__ __forceinline__ float denom(float x) {
  return 1.0f + ex2_approx(fminf(x * fmaf(C3, x * x, C1), T_MAX));
}

// The GELU of 4 consecutive units, the form every shallow kernel uses: one
// rcp.approx a pair of units, 1/d0 = d1 / (d0 d1) and 1/d1 = d0 / (d0 d1),
// two fp32 multiplies in place of an SFU result.
__device__ __forceinline__ float4 gelu4(float4 x) {
  const float d0 = denom(x.x), d1 = denom(x.y), d2 = denom(x.z), d3 = denom(x.w);
  const float r01 = rcp_approx(d0 * d1), r23 = rcp_approx(d2 * d3);
  return make_float4(x.x * (r01 * d1), x.y * (r01 * d0), x.z * (r23 * d3), x.w * (r23 * d2));
}

__device__ __forceinline__ float4 load4(const float* __restrict__ p, int row, int width, int c,
                                        bool vec) {
  // floats c..c+3 of a row of ``width``, zero past it
  const float* r = p + (size_t)row * width;
  if (vec) return __ldg(reinterpret_cast<const float4*>(r + c));
  return make_float4(c < width ? __ldg(r + c) : 0.f, c + 1 < width ? __ldg(r + c + 1) : 0.f,
                     c + 2 < width ? __ldg(r + c + 2) : 0.f,
                     c + 3 < width ? __ldg(r + c + 3) : 0.f);
}

// acc = fmaf(w[k], gelu(a[k] + b[k]), acc) for the 4 units of a float4
__device__ __forceinline__ float dot4(float4 w, float4 a, float4 b, float acc) {
  const float4 g = gelu4(make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w));
  acc = fmaf(w.x, g.x, acc);
  acc = fmaf(w.y, g.y, acc);
  acc = fmaf(w.z, g.z, acc);
  return fmaf(w.w, g.w, acc);
}

// the shallow path's weights in shared memory: w (H4 floats, zero past H),
// then b_last at H4
__device__ __forceinline__ void stage_last_layer(float* w_s, const float* __restrict__ W, int H,
                                                 int H4) {
  for (int i = threadIdx.x; i < H4 + 4; i += blockDim.x)
    w_s[i] = i < H ? W[i] : (i == H4 ? W[H] : 0.f);
}

// ---------------------------------------------------------------- shallow rows
template <bool MASKED>
__global__ void __launch_bounds__(THREADS, CTAS_PER_SM)
mlp_rows_kernel(const float* __restrict__ A, const float* __restrict__ Bd,
                const float* __restrict__ W, const float* __restrict__ tau, float bias,
                uint32_t* __restrict__ out, float* __restrict__ logits, int S, int D, int H,
                int words, int n_chunks, int n_dense, const int4* __restrict__ items,
                const int* __restrict__ n_items, const int* __restrict__ tile_slots,
                const uint32_t* __restrict__ anded, const int32_t* __restrict__ slot_query,
                int Wb, int block_words, bool vec) {
  extern __shared__ float4 smem4[];
  const int H4 = (H + 3) & ~3;
  float* w_s = reinterpret_cast<float*>(smem4);  // [H4 + 4]: w, then b_last
  float* As = w_s + H4 + 4;                      // [BS][RS]: the item's A rows
  float* Bs = As + BS * RS;                      // [BD][RS]: the tile's Bd rows
  __shared__ int s_slot[BS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ws = warp / WARPS_D, wd = warp % WARPS_D;
  stage_last_layer(w_s, W, H, H4);
  const int total = MASKED ? *n_items : n_dense;
  for (int it = blockIdx.x; it < total; it += gridDim.x) {
    int tile, start, count;
    if (MASKED) {
      const int4 v = items[it];
      tile = v.x, start = v.y, count = v.z;
    } else {
      tile = it / n_chunks, start = (it % n_chunks) * BS, count = min(BS, S - start);
    }
    __syncthreads();  // the previous item is done with s_slot and the tiles (w_s is in)
    if (tid < BS)
      s_slot[tid] = tid >= count ? -1
                    : MASKED     ? tile_slots[(size_t)tile * S + start + tid]
                                 : start + tid;
    const int d0 = tile * BD;
    const bool busy = ws * TS < count;  // the warp has a slot of the item
    float acc[TS][TD];
#pragma unroll
    for (int i = 0; i < TS; ++i)
#pragma unroll
      for (int j = 0; j < TD; ++j) acc[i][j] = 0.f;
    for (int j0 = 0; j0 < H4; j0 += KC) {
      const int kc = min(KC, H4 - j0);  // a multiple of 4
      __syncthreads();  // the previous stage is consumed; s_slot is written
      for (int i = tid; i < BS * (KC / 4); i += THREADS) {
        const int r = i / (KC / 4), c = 4 * (i % (KC / 4));
        const int s = s_slot[r];
        const float4 v = s >= 0 && c < kc ? load4(A, s, H, j0 + c, vec) : make_float4(0, 0, 0, 0);
        *reinterpret_cast<float4*>(As + r * RS + c) = v;
      }
      for (int i = tid; i < BD * (KC / 4); i += THREADS) {
        const int r = i / (KC / 4), c = 4 * (i % (KC / 4));
        const int d = d0 + r;
        const float4 v = d < D && c < kc ? load4(Bd, d, H, j0 + c, vec) : make_float4(0, 0, 0, 0);
        *reinterpret_cast<float4*>(Bs + r * RS + c) = v;
      }
      __syncthreads();
      if (busy) {
        for (int k = 0; k < kc; k += 4) {
          const float4 w4 = *reinterpret_cast<const float4*>(w_s + j0 + k);
          float4 b4[TD];
#pragma unroll
          for (int j = 0; j < TD; ++j)
            b4[j] = *reinterpret_cast<const float4*>(Bs + (wd * 32 * TD + lane + 32 * j) * RS + k);
#pragma unroll
          for (int i = 0; i < TS; ++i) {
            const float4 a4 = *reinterpret_cast<const float4*>(As + (ws * TS + i) * RS + k);
#pragma unroll
            for (int j = 0; j < TD; ++j) acc[i][j] = dot4(w4, a4, b4[j], acc[i][j]);
          }
        }
      }
    }
    if (busy) {
      const float b_last = w_s[H4];
      uint32_t mine = 0;  // lane i * TD + j keeps the word of (slot i, docs j)
#pragma unroll
      for (int i = 0; i < TS; ++i) {
        const int s = s_slot[ws * TS + i];
        const float t = s >= 0 ? tau[s] : 0.f;
#pragma unroll
        for (int j = 0; j < TD; ++j) {
          const int d = d0 + wd * 32 * TD + 32 * j + lane;
          const float logit = (acc[i][j] + b_last) + bias;
          const bool ok = s >= 0 && d < D;
          if (logits != nullptr && ok) logits[(size_t)s * D + d] = logit;
          const uint32_t bits = __ballot_sync(FULL, ok && logit >= t);
          if (lane == i * TD + j) mine = bits;
        }
      }
      const int s = s_slot[ws * TS + lane / TD];
      const int word = (d0 >> 5) + wd * TD + lane % TD;
      if (s >= 0 && word < words) {
        if (MASKED && !block_live(anded + (size_t)slot_query[s] * Wb, word / block_words))
          mine = 0u;
        out[(size_t)s * words + word] = mine;
      }
    }
  }
}

// ---------------------------------------------------------------- deep path
// the logit before + bias of one pair through every layer: the first
// hidden layer feeds the second unit by unit (g holds the second layer's
// sums, so no vector of width H1 is kept)
__device__ __forceinline__ float deep_logit(const float* __restrict__ a, const float* __restrict__ b,
                                            const float* ws, const Dims& dims, float* g,
                                            float* nxt) {
  const int h1 = dims.h[0], h2 = dims.h[1];
  for (int k = 0; k < h2; ++k) g[k] = 0.0f;
  for (int j = 0; j < h1; ++j) {
    const float x = gelu_tanh(a[j] + b[j]);
    const float* row = ws + (size_t)j * h2;
    for (int k = 0; k < h2; ++k) g[k] = fmaf(x, row[k], g[k]);
  }
  int off = h1 * h2;
  for (int l = 1;; ++l) {
    const int h_in = dims.h[l];
    const float* bl = ws + off;  // this layer's bias: g[k] + b[k]
    if (l == dims.n) return g[0] + bl[0];  // h_in == 1: the output
    for (int k = 0; k < h_in; ++k) g[k] = gelu_tanh(g[k] + bl[k]);
    off += h_in;
    const int h_out = dims.h[l + 1];
    const float* w = ws + off;
    for (int k = 0; k < h_out; ++k) {
      float acc = 0.0f;
      for (int j = 0; j < h_in; ++j) acc = fmaf(g[j], w[(size_t)j * h_out + k], acc);
      nxt[k] = acc;
    }
    for (int k = 0; k < h_out; ++k) g[k] = nxt[k];
    off += h_in * h_out;
  }
}

__global__ void __launch_bounds__(THREADS)
mlp_deep_kernel(const float* __restrict__ A, const float* __restrict__ Bd,
                const float* __restrict__ W, int n_weights, Dims dims,
                const float* __restrict__ tau, float bias, uint32_t* __restrict__ out,
                float* __restrict__ logits, int S, int D, int words,
                const uint32_t* __restrict__ anded, const int32_t* __restrict__ slot_query,
                int Wb, int block_words) {
  extern __shared__ float ws[];  // every later layer: w row-major, then b
  for (int i = threadIdx.x; i < n_weights; i += THREADS) ws[i] = W[i];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int h1 = dims.h[0];
  const long long n_items = (long long)S * words;
  float g[MAX_WIDTH], nxt[MAX_WIDTH];
  for (long long item = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5); item < n_items;
       item += (long long)gridDim.x * WARPS) {
    const int s = (int)(item / words), word = (int)(item % words);
    // masked: a dead block's words stay as the launch's memset left them
    if (anded != nullptr && !block_live(anded + (size_t)slot_query[s] * Wb, word / block_words))
      continue;
    const int d = word * 32 + lane;
    bool hit = false;
    if (d < D) {
      const float logit = deep_logit(A + (size_t)s * h1, Bd + (size_t)d * h1, ws, dims, g, nxt) + bias;
      if (logits != nullptr) logits[(size_t)s * D + d] = logit;
      hit = logit >= tau[s];
    }
    const uint32_t bits = __ballot_sync(FULL, hit);
    if (lane == 0) out[(size_t)s * words + word] = bits;
  }
}

// ---------------------------------------------------------------- two-tier
// Score the docs of lanes 0..cnt-1 (cnt the same in every lane) against
// the query's n valid slots and clear the bit of each doc that fails one.
// Called by the whole warp.
template <bool DEEP>
__device__ __forceinline__ void score_docs(int doc, int cnt, const float* __restrict__ A,
                                           const float* __restrict__ Bd, int H, bool vec,
                                           const float* w_s, const float* a_s, const int* s_slot,
                                           const float* s_tau, int n, float bias,
                                           const Dims& dims, float* tile, uint32_t* orow) {
  const int lane = threadIdx.x & 31;
  bool pass = true;
  if constexpr (DEEP) {
    float g[MAX_WIDTH], nxt[MAX_WIDTH];
    if (lane < cnt)
      for (int i = 0; i < n && pass; ++i)
        pass = deep_logit(A + (size_t)s_slot[i] * H, Bd + (size_t)doc * H, w_s, dims, g, nxt) +
                   bias >= s_tau[i];
  } else {
    const int H4 = (H + 3) & ~3;
    const float b_last = w_s[H4];
    const int c = 4 * (lane & 7);
    for (int i = 0; i < n; ++i) {
      float acc = 0.f;
      for (int e0 = 0; e0 < H4; e0 += KC) {
        const int w = min(KC, H4 - e0);
        // stage the docs' units e0.. : an instruction moves rows 4u..4u+3,
        // lane l floats c..c+3 of row 4u + l / 8 (4 loads in flight, then
        // their stores)
        for (int r0 = 0; r0 < cnt; r0 += 16) {
          float4 v[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int r = r0 + 4 * u + (lane >> 3);
            const int d = __shfl_sync(FULL, doc, r & 31);
            if (r < cnt && c < w) v[u] = load4(Bd, d, H, e0 + c, vec);
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int r = r0 + 4 * u + (lane >> 3);
            if (r < cnt && c < w) *reinterpret_cast<float4*>(tile + r * RS + c) = v[u];
          }
        }
        __syncwarp();
        if (lane < cnt) {
          const float* row = tile + lane * RS;
          const float* av = a_s + (size_t)i * H4 + e0;
          const float* wv = w_s + e0;
          for (int k = 0; k < w; k += 4)
            acc = dot4(*reinterpret_cast<const float4*>(wv + k),
                       *reinterpret_cast<const float4*>(av + k),
                       *reinterpret_cast<const float4*>(row + k), acc);
        }
        __syncwarp();  // before the next chunk overwrites the tile
      }
      pass = pass && (acc + b_last) + bias >= s_tau[i];
    }
  }
  if (lane < cnt && !pass) atomicAnd(orow + (doc >> 5), ~(1u << (doc & 31)));
}

template <bool DEEP>
__global__ void __launch_bounds__(THREADS)
mlp_two_tier_kernel(const int32_t* __restrict__ tier1, int k, const int32_t* __restrict__ tier1_len,
                    const int32_t* __restrict__ queries, const int32_t* __restrict__ slots, int T,
                    const float* __restrict__ A, const float* __restrict__ Bd, int H, bool vec,
                    const float* __restrict__ W, int n_weights, Dims dims,
                    const float* __restrict__ tau, float bias, uint32_t* __restrict__ out, int D,
                    int words) {
  extern __shared__ float4 smem4[];
  const int H4 = (H + 3) & ~3;
  // shallow: w and b_last [H4 + 4], the valid slots' A rows [T][H4], the
  // warps' tiles [WARPS][32][RS]; deep: every later layer [n_weights]
  float* w_s = reinterpret_cast<float*>(smem4);
  float* a_s = w_s + H4 + 4;
  float* s_tiles = a_s + (size_t)T * H4;
  __shared__ int s_term[MAX_TERMS];
  __shared__ int s_slot[MAX_TERMS];
  __shared__ int s_off[MAX_TERMS + 1];  // slot i's first position in the concatenation
  __shared__ float s_tau[MAX_TERMS];
  __shared__ int s_queue[WARPS][64];    // each warp's claimed docs not yet scored
  __shared__ int s_n;
  const int q = blockIdx.y;
  if (threadIdx.x == 0) {
    int n = 0, off = 0;
    for (int t = 0; t < T; ++t) {
      const int term = queries[(size_t)q * T + t];
      if (term < 0) continue;
      s_term[n] = term;
      s_slot[n] = slots[(size_t)q * T + t];
      s_tau[n] = tau[s_slot[n]];
      s_off[n] = off;
      off += min(tier1_len[term], k);
      ++n;
    }
    s_off[n] = off;
    s_n = n;
  }
  __syncthreads();
  const int n = s_n, total = s_off[n];
  if (blockIdx.x * THREADS >= total) return;  // the same for every thread of the CTA
  if constexpr (DEEP) {
    for (int i = threadIdx.x; i < n_weights; i += THREADS) w_s[i] = W[i];
  } else {
    stage_last_layer(w_s, W, H, H4);
    for (int i = threadIdx.x; i < n * H4; i += THREADS) {
      const int r = i / H4, c = i % H4;
      a_s[i] = c < H ? A[(size_t)s_slot[r] * H + c] : 0.f;
    }
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* tile = s_tiles + warp * 32 * RS;
  int* queue = s_queue[warp];
  uint32_t* orow = out + (size_t)q * words;
  int pending = 0;
  const int batches = (total + 31) / 32;
  for (int b = blockIdx.x * WARPS + warp; b < batches; b += gridDim.x * WARPS) {
    const int p = 32 * b + lane;
    bool take = false;
    int d = 0;
    if (p < total) {
      int s = 0;
      while (p >= s_off[s + 1]) ++s;
      d = tier1[(size_t)s_term[s] * k + (p - s_off[s])];
      if ((unsigned)d < (unsigned)D) {
        const uint32_t bit = 1u << (d & 31);
        take = !(atomicOr(orow + (d >> 5), bit) & bit);  // this lane claimed d
      }
    }
    const unsigned m = __ballot_sync(FULL, take);
    if (take) queue[pending + __popc(m & ((1u << lane) - 1u))] = d;
    pending += __popc(m);
    __syncwarp();
    if (pending >= 32) {
      score_docs<DEEP>(queue[lane], 32, A, Bd, H, vec, w_s, a_s, s_slot, s_tau, n, bias, dims,
                       tile, orow);
      pending -= 32;
      if (lane < pending) queue[lane] = queue[32 + lane];
      __syncwarp();
    }
  }
  if (pending > 0)
    score_docs<DEEP>(lane < pending ? queue[lane] : 0, pending, A, Bd, H, vec, w_s, a_s, s_slot,
                     s_tau, n, bias, dims, tile, orow);
}

// ---------------------------------------------------------------- host side
// Reads dims_host (n_later + 1 ints: H1, ..., 1) into dims and the count
// of later weights; false for dims the kernels do not take.
bool parse_dims(const int* dims_host, int n_later, int H1, Dims& dims, int& n_weights) {
  if (n_later < 1 || n_later > MAX_LAYERS || dims_host[0] != H1 || dims_host[n_later] != 1)
    return false;
  dims.n = n_later;
  n_weights = 0;
  for (int l = 0; l <= n_later; ++l) {
    dims.h[l] = dims_host[l];
    if (dims.h[l] < 1 || (l > 0 && l < n_later && dims.h[l] > MAX_WIDTH)) return false;
    if (l < n_later) n_weights += dims_host[l] * dims_host[l + 1] + dims_host[l + 1];
  }
  return true;
}

size_t rows_smem(int H1) { return sizeof(float) * (((H1 + 3) & ~3) + 4 + (BS + BD) * RS); }

template <typename Kernel>
cudaError_t allow_smem(Kernel* fn, size_t bytes, size_t& configured) {
  // the attribute is per function: raised once to the largest size asked
  if (bytes <= configured) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) configured = bytes;
  return err;
}

// CTAs of ``fn`` that fit on the card at once (the persistent grid)
template <typename Kernel>
int resident_ctas(Kernel* fn, size_t smem) {
  int dev = 0, sms = 132, per_sm = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, THREADS, smem);
  return sms * (per_sm > 0 ? per_sm : 1);
}

template <bool MASKED>
cudaError_t launch_rows(const float* A, const float* Bd, const float* W, const float* tau,
                        float bias, uint32_t* out, float* logits, int S, int D, int H1, int words,
                        const int4* items, const int* n_items, const int* tile_slots,
                        const uint32_t* anded, const int32_t* slot_query, int Wb, int block_words,
                        cudaStream_t stream) {
  static size_t configured = 48 << 10;
  auto* fn = mlp_rows_kernel<MASKED>;
  const size_t smem = rows_smem(H1);
  cudaError_t err = allow_smem(fn, smem, configured);
  if (err != cudaSuccess) return err;
  const int n_tiles = (D + BD - 1) / BD, n_chunks = (S + BS - 1) / BS;
  const int n_dense = n_tiles * n_chunks;
  const int grid = std::min(n_dense, resident_ctas(fn, smem));
  const bool vec = H1 % 4 == 0 && reinterpret_cast<uintptr_t>(A) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(Bd) % 16 == 0;
  mlp_rows_kernel<MASKED><<<grid, THREADS, smem, stream>>>(
      A, Bd, W, tau, bias, out, logits, S, D, H1, words, n_chunks, n_dense, items, n_items,
      tile_slots, anded, slot_query, Wb, block_words, vec);
  return cudaGetLastError();
}

cudaError_t launch_deep(const float* A, const float* Bd, const float* W, int n_weights,
                        const Dims& dims, const float* tau, float bias, uint32_t* out,
                        float* logits, int S, int D, int words, const uint32_t* anded,
                        const int32_t* slot_query, int Wb, int block_words, cudaStream_t stream) {
  static size_t configured = 48 << 10;
  const size_t smem = (size_t)n_weights * sizeof(float);
  cudaError_t err = allow_smem(mlp_deep_kernel, smem, configured);
  if (err != cudaSuccess) return err;
  const long long items = (long long)S * words;
  const long long blocks = (items + WARPS - 1) / WARPS;
  const int grid = (int)(blocks < 132LL * 64 ? blocks : 132LL * 64);
  mlp_deep_kernel<<<grid, THREADS, smem, stream>>>(A, Bd, W, n_weights, dims, tau, bias, out,
                                                   logits, S, D, words, anded, slot_query, Wb,
                                                   block_words);
  return cudaGetLastError();
}

}  // namespace

// Algorithm 1's rows: every (slot, doc) pair, every word written.
// dims_host: n_later + 1 ints (H1, ..., 1), read here, on the host, before
// the launch.  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for dims the kernels do not take.
extern "C" int mlp_membership_launch(const float* A, const float* Bd, const float* W,
                                     const int* dims_host, int n_later, const float* tau,
                                     float bias, uint32_t* out, float* logits, int S, int D,
                                     int H1, int words, cudaStream_t stream) {
  Dims dims;
  int n_weights;
  if (!parse_dims(dims_host, n_later, H1, dims, n_weights)) return (int)cudaErrorInvalidValue;
  if (S <= 0 || D <= 0) return (int)cudaGetLastError();
  if (n_later == 1)
    return (int)launch_rows<false>(A, Bd, W, tau, bias, out, logits, S, D, H1, words, nullptr,
                                   nullptr, nullptr, nullptr, nullptr, 0, 1, stream);
  return (int)launch_deep(A, Bd, W, n_weights, dims, tau, bias, out, logits, S, D, words,
                          nullptr, nullptr, 0, 1, stream);
}

// Algorithm 3's rows: only the docs of blocks that survive the block AND of
// the slot's query.  table (n_terms, Wb) block words, terms (Q, T) (-1 =
// pad), slot_query (S,) the query of each slot, block_words = block size /
// 32.  Scratch from the caller: anded (Q * Wb), tile_slots (n_tiles * S),
// items (n_tiles * ceil(S / 16) int4), n_items (1 int); n_tiles =
// ceil(D / 512).  The rows are zeroed here, then written in live blocks.
extern "C" int mlp_masked_launch(const float* A, const float* Bd, const float* W,
                                 const int* dims_host, int n_later, const float* tau, float bias,
                                 uint32_t* out, float* logits, int S, int D, int H1, int words,
                                 const uint32_t* table, int Wb, const int32_t* terms, int Q, int T,
                                 const int32_t* slot_query, int block_words, uint32_t* anded,
                                 int* tile_slots, int4* items, int* n_items,
                                 cudaStream_t stream) {
  Dims dims;
  int n_weights;
  if (!parse_dims(dims_host, n_later, H1, dims, n_weights) || block_words < 1)
    return (int)cudaErrorInvalidValue;
  if (S <= 0 || words <= 0) return (int)cudaGetLastError();
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(uint32_t) * (size_t)S * words, stream);
  if (err != cudaSuccess) return (int)err;
  const int and_grid = std::min((Q * Wb + THREADS - 1) / THREADS, 1024);
  if (and_grid > 0)
    live::block_and_kernel<<<and_grid, THREADS, 0, stream>>>(table, Wb, terms, Q, T, anded);
  if (n_later > 1)
    return (int)launch_deep(A, Bd, W, n_weights, dims, tau, bias, out, logits, S, D, words, anded,
                            slot_query, Wb, block_words, stream);
  err = cudaMemsetAsync(n_items, 0, sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (D + BD - 1) / BD;
  live::live_items_kernel<BS, BD><<<n_tiles, THREADS, 0, stream>>>(
      anded, Wb, slot_query, S, words, block_words, tile_slots, items, n_items);
  return (int)launch_rows<true>(A, Bd, W, tau, bias, out, logits, S, D, H1, words, items, n_items,
                                tile_slots, anded, slot_query, Wb, block_words, stream);
}

// Algorithm 2's candidates with a head: (Q, words) bits, set iff the doc is
// in a valid slot's tier-1 list and passes every valid slot.  tier1 (n_terms,
// k) padded, tier1_len (n_terms,), queries (Q, T) term ids (-1 = pad),
// slots (Q, T) the row of A and tau of each valid (query, term).  The
// wrapper checks T <= 64, Q <= 65535, grid_x >= 1 and the shared memory.
extern "C" int mlp_two_tier_launch(const int32_t* tier1, int k, const int32_t* tier1_len,
                                   const int32_t* queries, const int32_t* slots, int Q, int T,
                                   const float* A, const float* Bd, const float* W,
                                   const int* dims_host, int n_later, const float* tau,
                                   float bias, uint32_t* out, int D, int H1, int words,
                                   int grid_x, cudaStream_t stream) {
  Dims dims;
  int n_weights;
  if (!parse_dims(dims_host, n_later, H1, dims, n_weights)) return (int)cudaErrorInvalidValue;
  if (Q <= 0 || words <= 0) return (int)cudaGetLastError();
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(uint32_t) * (size_t)Q * words, stream);
  if (err != cudaSuccess) return (int)err;
  if (T <= 0 || k <= 0) return (int)cudaGetLastError();
  const bool vec = H1 % 4 == 0 && reinterpret_cast<uintptr_t>(Bd) % 16 == 0;
  const int H4 = (H1 + 3) & ~3;
  const dim3 grid(grid_x, Q);
  if (n_later == 1) {
    static size_t configured = 48 << 10;
    const size_t smem = sizeof(float) * (H4 + 4 + (size_t)T * H4 + WARPS * 32 * RS);
    err = allow_smem(mlp_two_tier_kernel<false>, smem, configured);
    if (err != cudaSuccess) return (int)err;
    mlp_two_tier_kernel<false><<<grid, THREADS, smem, stream>>>(
        tier1, k, tier1_len, queries, slots, T, A, Bd, H1, vec, W, n_weights, dims, tau, bias, out,
        D, words);
  } else {
    static size_t configured = 48 << 10;
    const size_t smem = sizeof(float) * (size_t)n_weights;
    err = allow_smem(mlp_two_tier_kernel<true>, smem, configured);
    if (err != cudaSuccess) return (int)err;
    mlp_two_tier_kernel<true><<<grid, THREADS, smem, stream>>>(
        tier1, k, tier1_len, queries, slots, T, A, Bd, H1, vec, W, n_weights, dims, tau, bias, out,
        D, words);
  }
  return (int)cudaGetLastError();
}
