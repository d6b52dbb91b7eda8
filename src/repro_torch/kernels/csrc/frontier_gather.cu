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
// - gather_window: one warp per 512-slot edge block, on a persistent grid
//   (as many CTAs as the occupancy API, asked once, says fit at once), each
//   warp walking a contiguous run of blocks.  Lane i takes slots
//   16i..16i+15: four 16-byte loads of their ids and one 16-byte store of
//   their 16 result bytes.  The block's window (the TPU prefetched its
//   index as a scalar) is loaded once per run of blocks that share it: for
//   ww <= 32, lane j holds word j in a register and a slot's word is
//   fetched with __shfl_sync, so there is no shared memory and no barrier;
//   a larger window (up to 12288 words, 48 KB) is read word by word with
//   __ldg, through L1 and L2.  An eb that is not a multiple of 16, or a
//   pointer that is not 16-byte aligned (the wrapper checks and passes
//   `vec`), takes the same walk with 4-byte loads and 1-byte stores.
// Ids outside the bitmap (or the window) read as 0 and never address
// memory outside it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLaneSlots = 16;
constexpr int kWarpSlots = 32 * kLaneSlots;  // one 512-slot edge block
constexpr uint32_t kFull = 0xffffffffu;
constexpr uint32_t kNone = 0xffffffffu;  // an id outside every window

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

// words uint32[P, n_words], block_ws int32[total], src_local int32[total,
// eb] -> out uint8[total, eb], total = P * n_blocks.  Warp g of the grid
// takes blocks g*run .. g*run+run-1.  kShfl: ww <= 32.
template <bool kVec, bool kShfl>
__global__ void __launch_bounds__(kThreads)
    gather_window_kernel(const uint32_t* __restrict__ words,
                         const int32_t* __restrict__ block_ws,
                         const int32_t* __restrict__ src_local,
                         uint8_t* __restrict__ out, int64_t n_words,
                         int64_t n_blocks, int64_t total, int64_t eb, int ww,
                         int64_t run) {
  const int lane = threadIdx.x & 31;
  const int64_t b0 =
      ((int64_t)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5)) * run;
  const int64_t b1 = b0 + run < total ? b0 + run : total;
  const uint32_t bits = (uint32_t)ww * 32u;
  int64_t cur_rank = -1, cur_base = 0;  // the window `win` holds
  uint32_t win = 0u;
  for (int64_t b = b0; b < b1; ++b) {
    const int64_t rank = b / n_blocks;
    const int64_t base = (int64_t)__ldg(block_ws + b) * ww;
    const uint32_t* rw = words + rank * n_words;
    if (kShfl && (rank != cur_rank || base != cur_base)) {
      const int64_t j = base + lane;
      win = lane < ww && j >= 0 && j < n_words ? __ldg(rw + j) : 0u;
      cur_rank = rank;
      cur_base = base;
    }
    const int32_t* s = src_local + b * eb;
    uint8_t* o = out + b * eb;
    for (int64_t c = 0; c < eb; c += kWarpSlots) {
      const int64_t e0 = c + lane * kLaneSlots;
      uint32_t x[kLaneSlots];
      if (kVec) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          uint4 v = make_uint4(kNone, kNone, kNone, kNone);
          if (e0 < eb) v = __ldg(reinterpret_cast<const uint4*>(s + e0) + q);
          x[4 * q] = v.x;
          x[4 * q + 1] = v.y;
          x[4 * q + 2] = v.z;
          x[4 * q + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int j = 0; j < kLaneSlots; ++j)
          x[j] = e0 + j < eb ? (uint32_t)s[e0 + j] : kNone;
      }
      uint32_t packed[4] = {0u, 0u, 0u, 0u};  // 16 result bytes
#pragma unroll
      for (int j = 0; j < kLaneSlots; ++j) {
        uint32_t w;
        if (kShfl) {
          w = __shfl_sync(kFull, win, (x[j] >> 5) & 31u);
        } else {
          const int64_t g = base + (x[j] >> 5);
          w = x[j] < bits && g >= 0 && g < n_words ? __ldg(rw + g) : 0u;
        }
        const uint32_t bit = x[j] < bits ? (w >> (x[j] & 31u)) & 1u : 0u;
        packed[j >> 2] |= bit << (8 * (j & 3));
      }
      if (kVec) {
        if (e0 < eb)
          *reinterpret_cast<uint4*>(o + e0) =
              make_uint4(packed[0], packed[1], packed[2], packed[3]);
      } else {
#pragma unroll
        for (int j = 0; j < kLaneSlots; ++j)
          if (e0 + j < eb) o[e0 + j] = (packed[j >> 2] >> (8 * (j & 3))) & 1u;
      }
    }
  }
}

int sm_count() {
  static const int n = [] {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    return sms > 0 ? sms : 1;
  }();
  return n;
}

// Warps of gather_window_kernel<kVec, kShfl> that fit on the card at once,
// asked of the runtime once.
template <bool kVec, bool kShfl>
int64_t resident_warps() {
  static const int64_t n = [] {
    int per_sm = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, gather_window_kernel<kVec, kShfl>, kThreads, 0);
    return (int64_t)(per_sm > 0 ? per_sm : 1) * sm_count() * (kThreads / 32);
  }();
  return n;
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
// src_local int32[P, n_blocks, eb] -> out uint8[P, n_blocks, eb];
// ww <= 12288.  vec != 0: eb is a multiple of 16 and src_local and out are
// 16-byte aligned.
extern "C" int repro_frontier_gather(const void* words, const void* block_ws,
                                     const void* src_local, void* out,
                                     long long p, long long n_words,
                                     long long n_blocks, long long eb,
                                     long long ww, long long vec,
                                     void* stream) {
  const bool shfl = ww <= 32;
  const auto kernel = vec ? (shfl ? gather_window_kernel<true, true>
                                  : gather_window_kernel<true, false>)
                          : (shfl ? gather_window_kernel<false, true>
                                  : gather_window_kernel<false, false>);
  const int64_t resident = vec ? (shfl ? resident_warps<true, true>()
                                       : resident_warps<true, false>())
                               : (shfl ? resident_warps<false, true>()
                                       : resident_warps<false, false>());
  const int64_t warps = kThreads / 32;
  const int64_t total = p * n_blocks;
  const int64_t run = (total + resident - 1) / resident;
  const int64_t ctas = (total + run * warps - 1) / (run * warps);
  kernel<<<(unsigned)ctas, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)words, (const int32_t*)block_ws,
      (const int32_t*)src_local, (uint8_t*)out, n_words, n_blocks, total, eb,
      (int)ww, run);
  return (int)cudaGetLastError();
}
