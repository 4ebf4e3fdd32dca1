// Algorithm 3's live-block work lists, shared by the masked launches of
// csrc/membership.cu and csrc/mlp_membership.cu.
//
// A slot's row is needed only in the blocks that survive the block AND of
// its query's valid terms.  block_and_kernel forms that AND per query;
// live_items_kernel lists, per doc tile, the slots whose query keeps one of
// the tile's blocks and cuts the list into items of at most ITEM slots (an
// atomic counter sizes the list on the card, so a CUDA-graph replay
// rebuilds it).  The slots of one item may belong to different queries.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {  // each source that includes it is a library of its own
namespace live {

constexpr unsigned FULL = 0xffffffffu;

// bit b of a query's block AND
__device__ __forceinline__ bool block_live(const uint32_t* __restrict__ row, int b) {
  return (row[b >> 5] >> (b & 31)) & 1u;
}

// anded[q][j] = AND of the query's valid terms' block words (0 for a
// query with none)
__global__ void block_and_kernel(const uint32_t* __restrict__ table, int Wb,
                                 const int32_t* __restrict__ terms, int Q, int T,
                                 uint32_t* __restrict__ anded) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < Q * Wb; i += gridDim.x * blockDim.x) {
    const int q = i / Wb, j = i % Wb;
    uint32_t acc = FULL;
    bool any = false;
    for (int t = 0; t < T; ++t) {
      const int term = terms[(size_t)q * T + t];
      if (term >= 0) {
        acc &= table[(size_t)term * Wb + j];
        any = true;
      }
    }
    anded[i] = any ? acc : 0u;
  }
}

// One CTA a tile of TILE docs (blockDim.x a multiple of 32): its live
// slots into tile_slots[tile][...], then items of at most ITEM of them
// appended to ``items`` (x = tile, y = first position, z = count).
template <int ITEM, int TILE>
__global__ void live_items_kernel(const uint32_t* __restrict__ anded, int Wb,
                                  const int32_t* __restrict__ slot_query, int S, int words,
                                  int block_words, int* __restrict__ tile_slots,
                                  int4* __restrict__ items, int* __restrict__ n_items) {
  __shared__ int s_count;
  const int tile = blockIdx.x, lane = threadIdx.x & 31;
  const int w0 = tile * (TILE / 32), w1 = min(w0 + TILE / 32, words) - 1;
  const int b0 = w0 / block_words, b1 = w1 / block_words;
  if (threadIdx.x == 0) s_count = 0;
  __syncthreads();
  for (int base = 0; base < S; base += blockDim.x) {  // the same trip count in every thread
    const int s = base + threadIdx.x;
    bool live = false;
    if (s < S) {
      const uint32_t* row = anded + (size_t)slot_query[s] * Wb;
      for (int b = b0; b <= b1 && !live; ++b) live = block_live(row, b);
    }
    const unsigned m = __ballot_sync(FULL, live);
    int pos = 0;
    if (lane == 0 && m) pos = atomicAdd(&s_count, __popc(m));
    pos = __shfl_sync(FULL, pos, 0);
    if (live) tile_slots[(size_t)tile * S + pos + __popc(m & ((1u << lane) - 1u))] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const int count = s_count, chunks = (count + ITEM - 1) / ITEM;
    const int first = chunks ? atomicAdd(n_items, chunks) : 0;
    for (int c = 0; c < chunks; ++c)
      items[first + c] = make_int4(tile, c * ITEM, min(ITEM, count - c * ITEM), 0);
  }
}

}  // namespace live
}  // namespace
