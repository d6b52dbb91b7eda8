// K-way OR of packed bitmaps: the merge of one butterfly round (the
// accumulator plus the digit-1 buffers received).
//
// Replaces the TPU kernel of src/repro/kernels/bitmap_merge.py:
//   bitmap_or_reduce (_kernel) -> or_reduce_kernel
//
// What bounds it on the H100: bytes.  It reads K words and writes one
// for every output word, and does one OR per word read.
//
// What the design does about it: a grid-stride loop over the words of
// each rank (grid y = rank), with 128-bit (uint4) loads through the
// read-only path when the row length and the pointers allow it, so each
// thread moves 16 bytes per load and the K rows stream through once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t bor(uint32_t a, uint32_t b) { return a | b; }
__device__ __forceinline__ uint4 bor(uint4 a, uint4 b) {
  return make_uint4(a.x | b.x, a.y | b.y, a.z | b.z, a.w | b.w);
}

// stack T[B, K, n], out T[B, n]; T is one 32-bit word or four (uint4).
template <typename T>
__global__ void or_reduce_kernel(const T* __restrict__ stack,
                                 T* __restrict__ out, int64_t k, int64_t n) {
  const int64_t b = blockIdx.y;
  const T* rows = stack + b * k * n;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    T acc = __ldg(rows + i);
    for (int64_t r = 1; r < k; ++r) acc = bor(acc, __ldg(rows + r * n + i));
    out[b * n + i] = acc;
  }
}

}  // namespace

// stack int32[B, K, W] -> out int32[B, W]
extern "C" int repro_bitmap_or_reduce(const void* stack, void* out,
                                      long long b, long long k, long long w,
                                      void* stream) {
  const bool vec = w % 4 == 0 && (uintptr_t)stack % 16 == 0 &&
                   (uintptr_t)out % 16 == 0;
  const int64_t n = vec ? w / 4 : w;
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 1024) blocks = 1024;
  const dim3 grid((unsigned)blocks, (unsigned)b);
  if (vec) {
    or_reduce_kernel<uint4><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint4*)stack, (uint4*)out, k, n);
  } else {
    or_reduce_kernel<uint32_t><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)stack, (uint32_t*)out, k, n);
  }
  return (int)cudaGetLastError();
}

// Message of a cudaError_t returned by any entry point of this library.
extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
