// Algorithm 3's block step in one launch: the packed-bitset conjunctive
// AND + popcount of the block bitmaps (Algorithm 3's block intersect), and
// the AND of the membership rows in the blocks that survive it.
//
// Replaces: src/repro/kernels/bitset/kernel.py, bitset_and_popcount
// (the Pallas tile with an unrolled T-way AND and a SWAR popcount ladder),
// and the ops src/repro/core/algorithms.py:block_query runs around it (the
// per-doc expansion of the block AND, the scan over the query's terms).
//
// block_candidates_launch: the shard's (n_terms, Wb) block-bitmap table,
// read in place by term id, (Q,T) term ids (-1 = pad), (Q,T) slots into the
// compact (R, words) membership rows -> (Q, words) candidate words (f_hat
// ANDed over the query's valid terms, kept only in words whose block
// survives the block AND, zero past n_docs and for a query with no valid
// term), plus the TPU kernel's own (Q,Wb) block AND and (Q,) count.
//
// What bounds it on the H100: memory.  It reads the R membership rows (R x
// words x 4 bytes, only in the words of surviving blocks) and writes the
// (Q, words) candidates; the block words (T x Wb a query) are tiny.  One
// AND per (term, word), no arithmetic worth counting.
//
// Design: a CTA takes one query and a chunk of 1,024 words.  Thread 0 packs
// the query's valid (term, slot) pairs into shared memory; the CTA then
// ANDs the at most 33 block words its chunk falls in (block_size >= 32, so
// a block word covers >= 32 words) straight from the table, so no (Q,T,Wb)
// copy is gathered.  Each thread owns 4 words strided by the CTA width
// (coalesced) and, term by term, issues the 4 independent loads of its
// words' row entries, skipping words in dead blocks.  A block word's AND
// and popcount are written by the CTA holding its first word, one
// atomicAdd per CTA into a count the launch zeroes with its own memset, so
// a CUDA-graph replay starts from zero.  This replaces the (Q*T, words)
// all-ones tensor, the scatter of membership rows into it, T-1 AND passes
// and the nine ops of the block expansion.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int CAND_THREADS = 256;
constexpr int WORDS_PER_THREAD = 4;
constexpr int CHUNK = CAND_THREADS * WORDS_PER_THREAD;  // words per CTA
constexpr int MAX_TERMS = 64;
constexpr int MAX_BLOCK_WORDS = CHUNK / 32 + 1;  // a chunk's block words at block_size 32

__global__ void __launch_bounds__(CAND_THREADS)
candidates_kernel(const uint32_t* __restrict__ table, int Wb, const int32_t* __restrict__ terms,
                  const int32_t* __restrict__ slots, int T, const uint32_t* __restrict__ rows,
                  int words, int block_words, int tail_bits, uint32_t* __restrict__ cand,
                  uint32_t* __restrict__ anded, int32_t* __restrict__ count) {
  __shared__ int s_term[MAX_TERMS];
  __shared__ int s_slot[MAX_TERMS];
  __shared__ int s_n;
  __shared__ uint32_t s_blk[MAX_BLOCK_WORDS];
  const int q = blockIdx.y;
  const int c0 = blockIdx.x * CHUNK;
  const int c1 = min(c0 + CHUNK, words);
  if (threadIdx.x == 0) {
    int n = 0;
    for (int t = 0; t < T; ++t) {
      const int term = terms[(size_t)q * T + t];
      if (term >= 0) {
        s_term[n] = term;
        s_slot[n] = slots[(size_t)q * T + t];
        ++n;
      }
    }
    s_n = n;
  }
  __syncthreads();
  const int n = s_n;
  // word w lies in block w / block_words: bit (w / block_words) % 32 of
  // block word w / span
  const int span = 32 * block_words;
  const int j0 = c0 / span, j1 = (c1 - 1) / span;
  for (int j = j0 + threadIdx.x; j <= j1; j += CAND_THREADS) {
    uint32_t acc = 0xffffffffu;
    for (int t = 0; t < n; ++t) acc &= table[(size_t)s_term[t] * Wb + j];
    s_blk[j - j0] = acc;
  }
  __syncthreads();
  if (threadIdx.x < 32) {  // the block words whose first word is in this chunk
    int bits = 0;
    for (int j = j0 + (int)threadIdx.x; j <= j1; j += 32) {
      if (j * span >= c0) {
        const uint32_t a = s_blk[j - j0];
        anded[(size_t)q * Wb + j] = a;
        bits += __popc(a);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) bits += __shfl_down_sync(0xffffffffu, bits, off);
    if (threadIdx.x == 0 && bits != 0) atomicAdd(&count[q], bits);
  }
  uint32_t acc[WORDS_PER_THREAD];
  bool live[WORDS_PER_THREAD];
#pragma unroll
  for (int k = 0; k < WORDS_PER_THREAD; ++k) {
    const int w = c0 + k * CAND_THREADS + threadIdx.x;
    const int blk = w / block_words;
    live[k] = n > 0 && w < c1 && ((s_blk[w / span - j0] >> (blk % 32)) & 1u);
    acc[k] = live[k] ? 0xffffffffu : 0u;
  }
  for (int t = 0; t < n; ++t) {
    const uint32_t* row = rows + (size_t)s_slot[t] * words;
#pragma unroll
    for (int k = 0; k < WORDS_PER_THREAD; ++k) {
      if (live[k]) acc[k] &= __ldg(row + c0 + k * CAND_THREADS + threadIdx.x);
    }
  }
#pragma unroll
  for (int k = 0; k < WORDS_PER_THREAD; ++k) {
    const int w = c0 + k * CAND_THREADS + threadIdx.x;
    if (w < c1) {
      // bits past n_docs (tail_bits of the last word are docs; 0 = all 32)
      const uint32_t tail = tail_bits ? (1u << tail_bits) - 1u : 0xffffffffu;
      cand[(size_t)q * words + w] = w == words - 1 ? acc[k] & tail : acc[k];
    }
  }
}

}  // namespace

// The wrapper checks the shapes: T <= 64, block_words >= 1, and every block
// word's first word below `words` (Wb == ceil(words / (32 * block_words))).
extern "C" int block_candidates_launch(const uint32_t* table, int Wb, const int32_t* terms,
                                       const int32_t* slots, int T, const uint32_t* rows,
                                       int words, int block_words, int tail_bits,
                                       uint32_t* cand, uint32_t* anded, int32_t* count, int Q,
                                       cudaStream_t stream) {
  if (Q > 0) {
    cudaMemsetAsync(count, 0, sizeof(int32_t) * (size_t)Q, stream);
    if (words > 0) {
      dim3 grid((words + CHUNK - 1) / CHUNK, Q);
      candidates_kernel<<<grid, CAND_THREADS, 0, stream>>>(table, Wb, terms, slots, T, rows,
                                                           words, block_words, tail_bits, cand,
                                                           anded, count);
    }
  }
  return (int)cudaGetLastError();
}
