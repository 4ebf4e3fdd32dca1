// OptPFD block decode: fixed-width bit-unpack plus the exception patch.
// Per PFor block b (meta row [width, word_off, blen, out_off, exc_off, n_exc]):
//   gap[i] = bits [i*w, (i+1)*w) of the little-endian stream at word_off,
//   gap[pos_e] |= hi_e << w for each exception pair (pos_e, hi_e) stored at
//   exc_off, for i < blen, written at out_off + i.
//
// Replaces: src/repro/kernels/pfor/kernel.py, unpack_blocks (one launch per
// static width over same-width blocks; exceptions patched on the host).
//
// What bounds it on the H100: memory, the packed words and exception pairs
// read once and 4 bytes written per value; a few integer operations a value.
//
// Design: the width is per block, read from the meta row, so one launch
// decodes every block of every list in the batch, whatever its width.  One
// CTA of 128 threads per block, one thread per value.  A value reads its
// second word only when it straddles a word boundary (off + w > 32), which
// also keeps the shift count in 1..31: the undefined shifts by 32 (off == 0)
// never happen, and w == 32 takes the all-ones mask.  The block's values go
// through shared memory so its exception threads can patch them (positions
// within a block are distinct: no race) before the coalesced store.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 128;  // values per PFor block (index/compress.py)
constexpr int META = 6;

__global__ void __launch_bounds__(BLOCK)
pfor_kernel(const uint32_t* __restrict__ words, const int32_t* __restrict__ meta,
            uint32_t* __restrict__ out) {
  __shared__ uint32_t vals[BLOCK];
  const int32_t* m = meta + (size_t)blockIdx.x * META;
  const int w = m[0], word_off = m[1], blen = m[2], out_off = m[3];
  const int exc_off = m[4], n_exc = m[5];
  const int i = threadIdx.x;
  uint32_t v = 0;
  if (i < blen && w > 0) {
    const int bitpos = i * w;
    const int off = bitpos & 31;
    const uint32_t* p = words + word_off + (bitpos >> 5);
    v = p[0] >> off;
    if (off + w > 32) v |= p[1] << (32 - off);
    if (w < 32) v &= (1u << w) - 1u;
  }
  vals[i] = v;
  __syncthreads();
  if (i < n_exc && w < 32) {
    const uint32_t pos = words[exc_off + 2 * i];
    const uint32_t hi = words[exc_off + 2 * i + 1];
    if (pos < (uint32_t)blen) vals[pos] |= hi << w;
  }
  __syncthreads();
  if (i < blen) out[out_off + i] = vals[i];
}

}  // namespace

extern "C" int pfor_unpack_launch(const uint32_t* words, const int32_t* meta, uint32_t* out,
                                  int n_blocks, cudaStream_t stream) {
  if (n_blocks > 0) pfor_kernel<<<n_blocks, BLOCK, 0, stream>>>(words, meta, out);
  return (int)cudaGetLastError();
}
