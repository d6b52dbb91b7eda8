// Frontier scatter-OR: set bit dst of the next "global queue" bitmap for
// every active edge slot (phase 1's "mark dst", the paper's atomic
// enqueue).
//
// Replaces the TPU kernel of src/repro/kernels/frontier_scatter.py:
//   frontier_scatter (_make_kernel) -> scatter_kernel
//
// What bounds it on the H100: bytes.  A slot reads one activity byte and
// one int32 offset; each block writes at most ww words of output.
//
// What the design does about it: one block per 512-slot edge block.  The
// TPU kernel counted hits with a one-hot f32 matrix product on the MXU;
// here the block ORs its valid, active slots into a ww-word tile in shared
// memory with atomicOr, then ORs the tile's nonzero words into the output
// with atomicOr.  The TPU kernel zeroed a window on its first block and
// ORed later blocks into it, which is only safe because the TPU grid runs
// in order; blocks of one window run at the same time here, so the output
// is zero-filled before the launch and every block ORs atomically.  OR is
// order-free, so the result is exact and deterministic, and windows that
// no block covers stay zero.  The block-window layout keeps the global
// atomics to at most ww per block.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void scatter_kernel(const uint8_t* __restrict__ active,
                               const int32_t* __restrict__ block_win,
                               const int32_t* __restrict__ dst_local,
                               uint32_t* __restrict__ out, int64_t n_blocks,
                               int64_t eb, int64_t n_out, int ww) {
  extern __shared__ uint32_t tile[];
  const int64_t rank = blockIdx.y;
  const int64_t block = rank * n_blocks + blockIdx.x;
  for (int t = threadIdx.x; t < ww; t += blockDim.x) tile[t] = 0u;
  __syncthreads();
  const uint32_t bits = (uint32_t)ww * 32u;
  const uint8_t* a = active + block * eb;
  const int32_t* d = dst_local + block * eb;
  for (int64_t e = threadIdx.x; e < eb; e += blockDim.x) {
    const uint32_t x = (uint32_t)d[e];
    if (x < bits && a[e]) atomicOr(&tile[x >> 5], 1u << (x & 31u));
  }
  __syncthreads();
  const int64_t first = (int64_t)block_win[block] * ww;
  if (first < 0 || first + ww > n_out) return;
  uint32_t* o = out + rank * n_out + first;
  for (int t = threadIdx.x; t < ww; t += blockDim.x) {
    const uint32_t v = tile[t];
    if (v) atomicOr(o + t, v);
  }
}

}  // namespace

// active uint8[P, n_blocks, eb], block_win int32[P, n_blocks],
// dst_local int32[P, n_blocks, eb], out int32[P, n_out] zero-filled,
// n_out == n_windows * ww.
extern "C" int repro_frontier_scatter(const void* active,
                                      const void* block_win,
                                      const void* dst_local, void* out,
                                      long long p, long long n_blocks,
                                      long long eb, long long n_out,
                                      long long ww, void* stream) {
  const dim3 grid((unsigned)n_blocks, (unsigned)p);
  scatter_kernel<<<grid, kThreads, (size_t)ww * sizeof(uint32_t),
                   (cudaStream_t)stream>>>(
      (const uint8_t*)active, (const int32_t*)block_win,
      (const int32_t*)dst_local, (uint32_t*)out, n_blocks, eb, n_out,
      (int)ww);
  return (int)cudaGetLastError();
}
