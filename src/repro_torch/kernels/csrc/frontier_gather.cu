// Frontier bit-gather: is the source of each edge slot in the frontier?
//
// Replaces the TPU kernels of src/repro/kernels/frontier_gather.py:
//   frontier_gather_full (_full_kernel)     -> gather_full_kernel
//   frontier_gather      (_windowed_kernel) -> gather_window_kernel
//
// What bounds it on the H100: bytes.  A slot reads one int32 vertex id and
// writes one byte; the bitmap word it tests is one 4-byte read, and a
// rank's bitmap is small (about 1.1 MB at Kronecker scale 23), so the
// words stay in the 50 MB L2 while the ids stream through once.
//
// What the design does about it:
// - gather_full: one thread per slot over a [rank, slot] grid, so the id
//   loads and the byte stores are coalesced; the word is read with __ldg
//   through L2.  The TPU design keeps the whole bitmap in VMEM, which does
//   not carry over: a bitmap of this size is over the 227 KB of shared
//   memory a block can hold.
// - gather_window: one block per 512-slot edge block.  The block loads its
//   own window index (the TPU prefetched it as a scalar), stages the
//   window's ww words (at most 16 KB) in shared memory, then tests bits.
// Ids outside the bitmap (or the window) read as 0 and never address
// memory outside it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void gather_full_kernel(const uint32_t* __restrict__ words,
                                   const int32_t* __restrict__ src,
                                   uint8_t* __restrict__ out,
                                   int64_t n_words, int64_t slots) {
  const int64_t rank = blockIdx.y;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= slots) return;
  const uint32_t s = (uint32_t)src[rank * slots + i];
  uint8_t bit = 0;
  if ((uint64_t)s < (uint64_t)n_words * 32) {
    const uint32_t w = __ldg(words + rank * n_words + (s >> 5));
    bit = (w >> (s & 31u)) & 1u;
  }
  out[rank * slots + i] = bit;
}

__global__ void gather_window_kernel(const uint32_t* __restrict__ words,
                                     const int32_t* __restrict__ block_ws,
                                     const int32_t* __restrict__ src_local,
                                     uint8_t* __restrict__ out,
                                     int64_t n_words, int64_t n_blocks,
                                     int64_t eb, int ww) {
  extern __shared__ uint32_t window[];
  const int64_t rank = blockIdx.y;
  const int64_t block = rank * n_blocks + blockIdx.x;
  const int64_t base = (int64_t)block_ws[block] * ww;
  const uint32_t* rank_words = words + rank * n_words;
  for (int t = threadIdx.x; t < ww; t += blockDim.x) {
    const int64_t j = base + t;
    window[t] = (j >= 0 && j < n_words) ? rank_words[j] : 0u;
  }
  __syncthreads();
  const uint32_t bits = (uint32_t)ww * 32u;
  const int32_t* s = src_local + block * eb;
  uint8_t* o = out + block * eb;
  for (int64_t e = threadIdx.x; e < eb; e += blockDim.x) {
    const uint32_t x = (uint32_t)s[e];
    o[e] = x < bits ? (window[x >> 5] >> (x & 31u)) & 1u : 0;
  }
}

}  // namespace

// words int32[P, n_words], src int32[P, slots] -> out uint8[P, slots]
extern "C" int repro_frontier_gather_full(const void* words, const void* src,
                                          void* out, long long p,
                                          long long n_words, long long slots,
                                          void* stream) {
  const dim3 grid((unsigned)((slots + kThreads - 1) / kThreads), (unsigned)p);
  gather_full_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)words, (const int32_t*)src, (uint8_t*)out, n_words,
      slots);
  return (int)cudaGetLastError();
}

// words int32[P, n_words], block_ws int32[P, n_blocks],
// src_local int32[P, n_blocks, eb] -> out uint8[P, n_blocks, eb]
extern "C" int repro_frontier_gather(const void* words, const void* block_ws,
                                     const void* src_local, void* out,
                                     long long p, long long n_words,
                                     long long n_blocks, long long eb,
                                     long long ww, void* stream) {
  const dim3 grid((unsigned)n_blocks, (unsigned)p);
  gather_window_kernel<<<grid, kThreads, (size_t)ww * sizeof(uint32_t),
                         (cudaStream_t)stream>>>(
      (const uint32_t*)words, (const int32_t*)block_ws,
      (const int32_t*)src_local, (uint8_t*)out, n_words, n_blocks, eb,
      (int)ww);
  return (int)cudaGetLastError();
}
