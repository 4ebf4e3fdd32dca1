// Membership scoring with the MLP head, thresholded and packed: for every
// (slot, doc) pair, h = gelu_tanh(A[slot] + Bd[doc]), the head's later
// layers, + bias, >= tau[slot], 32 docs a word (bit i = doc lane i).
//
// Replaces: src/repro/core/membership.py:66-74, term_doc_logits' MLP branch
// (XLA, not Pallas: a broadcast (Q, D, 2E) pairing through nn.mlp on doc
// tiles, thresholded by the algorithms).  At phase A's width that pairing
// would be 398 x 528,000 x 128 floats, about 108 GB: here no pair's
// activations leave the registers.
//
// Inputs: A = te[terms] @ W1[:E] (S, H1) and Bd = doc_embed @ W1[E:] + b1
// (D, H1), the first layer's two halves (plain products outside the
// kernel, as the reference leaves them to XLA); the later layers packed
// flat (each w row-major (h_in, h_out), then its b) with their dims
// (H1, ..., 1); tau per slot; the scalar bias.  Output (S, ceil(D/32))
// words; tail bits past D are zero, every word is written.  Given a
// non-null ``logits`` (S, D), the launch also writes every pair's logit
// (for checks against the plain version; the serving path passes null).
//
// Arithmetic: true fp32.  gelu_tanh is 0.5 x (1 + tanhf(sqrt(2/pi) (x +
// 0.044715 x^3))) with the library tanhf (no --use_fast_math); each layer's
// sum is an accumulator from 0 with fmaf over its inputs in order, then +
// its bias; the logit is (sum + b_last) + bias.  The plain version sums in
// a matrix product's order, so a bit may differ only next to tau (inside
// NUMERIC_MARGIN, which the threshold fit reserves for this).
//
// What bounds it on the H100: operations.  A pair costs about 12 fp32
// operations per first-layer unit (the add, GELU with its tanh, the FMA
// into the next layer), against 2 bytes of output per 16 pairs and input
// rows shared by every pair of a tile; tanhf, a few dozen instructions,
// dominates.  Tensor cores do not apply to the one-hidden-layer head: its
// only product (H1 -> 1) is a dot per pair, and the non-linearity sits
// between the halves' sum and it.
//
// Design, one hidden layer (the shallow path, mlp_hidden = (H1,)): a block
// of 256 threads scores 16 slots x 128 docs; a warp holds 8 slots and 32
// consecutive docs, a doc a lane, so a slot's word is one __ballot_sync.
// Hidden units go 32 at a time through shared memory, unit-major (the
// slots' A values read as broadcasts, the docs' Bd values one a lane with
// no bank conflict; the transposing stores padded by one column); the last
// layer's weights sit in shared memory for the whole block.  Blocks that
// share a doc tile run side by side (slot tile fastest), so Bd streams
// from device memory about once and from L2 per slot tile.
// Deeper heads (the deep path): a thread scores one (slot, doc) pair, a
// warp one word (ballot), with every later layer's weights in shared
// memory and the pair's hidden vectors in thread-local arrays (width at
// most MAX_WIDTH).  Simple and right; its speed is not on the main path.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_LAYERS = 4;   // layers after the first
constexpr int MAX_WIDTH = 256;  // hidden widths after the first layer (deep path)
constexpr int THREADS = 256;
constexpr int TS = 8;                   // slots a thread (shallow path)
constexpr int WARPS_S = 2, WARPS_D = 4;
constexpr int BS = TS * WARPS_S;        // 16 slots a block
constexpr int BD = 32 * WARPS_D;        // 128 docs a block
constexpr int KC = 32;                  // hidden units a stage
constexpr int MAX_SMEM = 227 * 1024;

struct Dims {
  int n;                    // layers after the first
  int h[MAX_LAYERS + 1];    // h[0] = H1, h[n] = 1
};

__device__ __forceinline__ float gelu_tanh(float x) {
  const float k_beta = 0.7978845608028654f;  // sqrt(2 / pi)
  const float k_kappa = 0.044715f;
  const float inner = k_beta * (x + k_kappa * (x * x * x));
  return 0.5f * x * (1.0f + tanhf(inner));
}

__global__ void __launch_bounds__(THREADS)
mlp_shallow_kernel(const float* __restrict__ A, const float* __restrict__ Bd,
                   const float* __restrict__ W, const float* __restrict__ tau, float bias,
                   uint32_t* __restrict__ out, float* __restrict__ logits, int S, int D, int H,
                   int words, int s_tiles) {
  extern __shared__ float w_last[];  // H weights, then b_last
  __shared__ float As[KC][BS + 1];   // unit-major: As[j][slot]
  __shared__ float Bs[KC][BD + 1];   // unit-major: Bs[j][doc]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ws = warp / WARPS_D, wd = warp % WARPS_D;
  const int s0 = (blockIdx.x % s_tiles) * BS;
  const int d0 = (blockIdx.x / s_tiles) * BD;
  for (int i = tid; i <= H; i += THREADS) w_last[i] = W[i];

  float acc[TS];
#pragma unroll
  for (int i = 0; i < TS; ++i) acc[i] = 0.0f;
  const int c = tid & 31, r0 = tid >> 5;  // column (unit) and first row of the copies
  for (int j0 = 0; j0 < H; j0 += KC) {
    __syncthreads();  // the previous stage is consumed (and w_last is in)
    const int j = j0 + c;
    for (int r = r0; r < BS; r += THREADS / 32) {
      const int s = s0 + r;
      As[c][r] = (s < S && j < H) ? A[(size_t)s * H + j] : 0.0f;
    }
    for (int r = r0; r < BD; r += THREADS / 32) {
      const int d = d0 + r;
      Bs[c][r] = (d < D && j < H) ? Bd[(size_t)d * H + j] : 0.0f;
    }
    __syncthreads();
    const int kc = min(KC, H - j0);
    for (int k = 0; k < kc; ++k) {
      const float b = Bs[k][wd * 32 + lane];
      const float w = w_last[j0 + k];
#pragma unroll
      for (int i = 0; i < TS; ++i) acc[i] = fmaf(w, gelu_tanh(As[k][ws * TS + i] + b), acc[i]);
    }
  }
  const float b_last = w_last[H];
  const int d = d0 + wd * 32 + lane;
  const int word = (d0 >> 5) + wd;
#pragma unroll
  for (int i = 0; i < TS; ++i) {
    const int s = s0 + ws * TS + i;
    const float logit = (acc[i] + b_last) + bias;
    if (logits != nullptr && s < S && d < D) logits[(size_t)s * D + d] = logit;
    const bool hit = s < S && d < D && logit >= tau[s < S ? s : 0];
    const uint32_t bits = __ballot_sync(0xffffffffu, hit);
    if (lane == 0 && s < S && word < words) out[(size_t)s * words + word] = bits;
  }
}

__global__ void __launch_bounds__(THREADS)
mlp_deep_kernel(const float* __restrict__ A, const float* __restrict__ Bd,
                const float* __restrict__ W, int n_weights, Dims dims,
                const float* __restrict__ tau, float bias, uint32_t* __restrict__ out,
                float* __restrict__ logits, int S, int D, int words) {
  extern __shared__ float ws[];  // every later layer: w row-major, then b
  for (int i = threadIdx.x; i < n_weights; i += THREADS) ws[i] = W[i];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long items = (long long)S * words;
  float g[MAX_WIDTH], nxt[MAX_WIDTH];
  for (long long item = (long long)blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5); item < items;
       item += (long long)gridDim.x * (THREADS / 32)) {
    const int s = (int)(item / words), word = (int)(item % words);
    const int d = word * 32 + lane;
    bool hit = false;
    if (d < D) {
      const int h1 = dims.h[0];
      const float* a = A + (size_t)s * h1;
      const float* b = Bd + (size_t)d * h1;
      // the first hidden layer feeds the second unit by unit: g holds the
      // second layer's sums, so no vector of width H1 is kept
      const int h2 = dims.h[1];
      for (int k = 0; k < h2; ++k) g[k] = 0.0f;
      for (int j = 0; j < h1; ++j) {
        const float x = gelu_tanh(a[j] + b[j]);
        const float* row = ws + (size_t)j * h2;
        for (int k = 0; k < h2; ++k) g[k] = fmaf(x, row[k], g[k]);
      }
      int off = h1 * h2;
      float logit = 0.0f;
      for (int l = 1; l <= dims.n; ++l) {
        const int h_in = dims.h[l];
        const float* bl = ws + off;  // this layer's bias: g[k] + b[k]
        if (l == dims.n) {  // h_in == 1: the output
          logit = g[0] + bl[0];
          break;
        }
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
      logit += bias;
      if (logits != nullptr) logits[(size_t)s * D + d] = logit;
      hit = logit >= tau[s];
    }
    const uint32_t bits = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) out[(size_t)s * words + word] = bits;
  }
}

}  // namespace

// dims_host: n_later + 1 ints (H1, ..., 1), read here, on the host, before
// the launch.  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for dims the kernels do not take.
extern "C" int mlp_membership_launch(const float* A, const float* Bd, const float* W,
                                     const int* dims_host, int n_later, const float* tau,
                                     float bias, uint32_t* out, float* logits, int S, int D,
                                     int H1, int words, cudaStream_t stream) {
  if (n_later < 1 || n_later > MAX_LAYERS || dims_host[0] != H1 || dims_host[n_later] != 1)
    return (int)cudaErrorInvalidValue;
  Dims dims;
  dims.n = n_later;
  int n_weights = 0;
  for (int l = 0; l <= n_later; ++l) {
    dims.h[l] = dims_host[l];
    if (dims.h[l] < 1 || (l > 0 && l < n_later && dims.h[l] > MAX_WIDTH))
      return (int)cudaErrorInvalidValue;
    if (l < n_later) n_weights += dims_host[l] * dims_host[l + 1] + dims_host[l + 1];
  }
  if (S <= 0 || D <= 0) return (int)cudaGetLastError();
  const size_t smem = (size_t)n_weights * sizeof(float);
  const size_t static_smem = n_later == 1 ? sizeof(float) * KC * (BS + 1 + BD + 1) : 0;
  if (smem + static_smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  if (n_later == 1) {
    static bool configured = false;  // the attribute is per function, set once
    if (!configured) {
      const cudaError_t err = cudaFuncSetAttribute(
          mlp_shallow_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          MAX_SMEM - (int)static_smem);
      if (err != cudaSuccess) return (int)err;
      configured = true;
    }
    const int s_tiles = (S + BS - 1) / BS, d_tiles = (D + BD - 1) / BD;
    mlp_shallow_kernel<<<s_tiles * d_tiles, THREADS, smem, stream>>>(
        A, Bd, W, tau, bias, out, logits, S, D, H1, words, s_tiles);
  } else {
    static bool configured = false;
    if (!configured) {
      const cudaError_t err = cudaFuncSetAttribute(
          mlp_deep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
      if (err != cudaSuccess) return (int)err;
      configured = true;
    }
    const long long items = (long long)S * words;
    const long long blocks = (items + THREADS / 32 - 1) / (THREADS / 32);
    const int grid = (int)(blocks < 132LL * 64 ? blocks : 132LL * 64);
    mlp_deep_kernel<<<grid, THREADS, smem, stream>>>(A, Bd, W, n_weights, dims, tau, bias,
                                                     out, logits, S, D, words);
  }
  return (int)cudaGetLastError();
}
