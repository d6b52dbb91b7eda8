// Frontier scatter-OR: set bit dst of the next "global queue" bitmap for
// every active edge slot (phase 1's "mark dst", the paper's atomic
// enqueue).
//
// Replaces the TPU kernel of src/repro/kernels/frontier_scatter.py:
//   frontier_scatter (_make_kernel) -> scatter_kernel
//
// What bounds it on the H100: bytes.  Every activity byte and block window
// is read and every output word written once; a slot's int32 offset is
// needed only where the slot is active, so on the BFS's sparse levels most
// of dst_local need not be read at all.
//
// What the design does about it:
// - One warp per 512-slot edge block: lane i takes slots 16i..16i+15, with
//   one 16-byte load of their activity bytes and, for each four of them of
//   which any is active, one 16-byte load of their four offsets.  An
//   inactive slot sets nothing, so skipping its offset is exact.
// - A lane ORs bits into a register while its slots stay in one word (the
//   layout sorts a block by destination) and commits the word to its
//   warp's ww-word tile in shared memory with one atomicOr when the word
//   changes: a hub block costs each lane one shared atomic, not 16.
// - A persistent grid, as many CTAs as the occupancy API (asked once, not
//   per launch) says fit on all SMs at once; each warp walks a contiguous
//   run of blocks.  The blocks of one window are consecutive, so the tile
//   carries over from block to block and is flushed (the words touched,
//   nonzero ones only, one global atomicOr each) when the window changes.
//   Warps whose runs share a window OR into the same words, so the entry
//   point zero-fills the output first; OR is order-free, so the result is
//   exact and deterministic, and windows no block covers stay zero.
// - An eb that is not a multiple of 16, or a pointer that is not 16-byte
//   aligned (the wrapper checks and passes `vec`), takes the same walk with
//   1- and 4-byte loads.
// The TPU kernel's one-hot matrix product has no use here, and its "first
// block of a window zeroes it" holds only on an in-order grid.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kLaneSlots = 16;
constexpr int kWarpSlots = 32 * kLaneSlots;  // one 512-slot edge block
constexpr int kMaxWarps = 8;                 // warps per CTA
constexpr size_t kMaxTileBytes = 48 * 1024;  // per CTA, no opt-in needed
constexpr uint32_t kFull = 0xffffffffu;
constexpr uint32_t kNone = 0xffffffffu;  // an offset outside every window

// Activity (4 bytes to a word) and offsets of the 16 slots from e0 of one
// block; offsets of a group of four inactive slots are not read.
template <bool kVec>
__device__ __forceinline__ void load_slots(const uint8_t* a, const int32_t* d,
                                           int64_t e0, int64_t eb,
                                           uint32_t (&act)[4],
                                           uint32_t (&x)[kLaneSlots]) {
  if (kVec) {
    uint4 av = make_uint4(0u, 0u, 0u, 0u);
    if (e0 < eb) av = __ldg(reinterpret_cast<const uint4*>(a + e0));
    act[0] = av.x;
    act[1] = av.y;
    act[2] = av.z;
    act[3] = av.w;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint4 dv = make_uint4(kNone, kNone, kNone, kNone);
      if (act[q]) dv = __ldg(reinterpret_cast<const uint4*>(d + e0) + q);
      x[4 * q] = dv.x;
      x[4 * q + 1] = dv.y;
      x[4 * q + 2] = dv.z;
      x[4 * q + 3] = dv.w;
    }
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      act[q] = 0u;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int64_t e = e0 + 4 * q + k;
        const bool on = e < eb && a[e];
        act[q] |= (on ? 1u : 0u) << (8 * k);
        x[4 * q + k] = on ? (uint32_t)d[e] : kNone;
      }
    }
  }
}

// OR the tile's words lo..hi (over the warp) into out, nonzero ones only,
// and clear them.
__device__ __forceinline__ void flush(uint32_t* tile, uint32_t* out,
                                      uint32_t& lo, uint32_t& hi, int lane) {
  __syncwarp();
  const uint32_t first = __reduce_min_sync(kFull, lo);
  const uint32_t last = __reduce_max_sync(kFull, hi);
  if (first <= last) {
    for (uint32_t j = first + lane; j <= last; j += 32) {
      const uint32_t v = tile[j];
      if (v) {
        atomicOr(out + j, v);
        tile[j] = 0u;
      }
    }
  }
  __syncwarp();
  lo = kNone;
  hi = 0u;
}

// active uint8[total, eb], block_win int32[total], dst_local int32[total,
// eb] with total = P * n_blocks; out uint32[P, n_out] zero-filled.  Warp g
// of the grid takes blocks g*run .. g*run+run-1.
template <bool kVec>
__global__ void __launch_bounds__(kMaxWarps * 32)
    scatter_kernel(const uint8_t* __restrict__ active,
                   const int32_t* __restrict__ block_win,
                   const int32_t* __restrict__ dst_local,
                   uint32_t* __restrict__ out, int64_t n_blocks,
                   int64_t total, int64_t eb, int64_t n_out, int ww,
                   int64_t run) {
  extern __shared__ uint32_t tiles[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint32_t* tile = tiles + (size_t)warp * ww;
  for (int t = lane; t < ww; t += 32) tile[t] = 0u;
  __syncwarp();
  const int64_t b0 = ((int64_t)blockIdx.x * (blockDim.x >> 5) + warp) * run;
  const int64_t b1 = b0 + run < total ? b0 + run : total;
  const uint32_t bits = (uint32_t)ww * 32u;
  int64_t cur = -1;  // output offset of the window in the tile, -1: none
  uint32_t lo = kNone, hi = 0u;  // the lane's words touched in the tile
  for (int64_t b = b0; b < b1; ++b) {
    const int64_t first = (int64_t)__ldg(block_win + b) * ww;
    const int64_t off = first < 0 || first + ww > n_out
                            ? -1
                            : (b / n_blocks) * n_out + first;
    if (off != cur) {
      if (cur >= 0) flush(tile, out + cur, lo, hi, lane);
      cur = off;
    }
    if (off < 0) continue;
    const uint8_t* a = active + b * eb;
    const int32_t* d = dst_local + b * eb;
    for (int64_t c = 0; c < eb; c += kWarpSlots) {
      uint32_t act[4], x[kLaneSlots];
      load_slots<kVec>(a, d, c + lane * kLaneSlots, eb, act, x);
      uint32_t word = kNone, mask = 0u;
#pragma unroll
      for (int j = 0; j < kLaneSlots; ++j) {
        const bool on = ((act[j >> 2] >> (8 * (j & 3))) & 0xffu) && x[j] < bits;
        if (on) {
          const uint32_t w = x[j] >> 5;
          if (w != word) {
            if (mask) {
              atomicOr(tile + word, mask);
              lo = min(lo, word);
              hi = max(hi, word);
            }
            word = w;
            mask = 0u;
          }
          mask |= 1u << (x[j] & 31u);
        }
      }
      if (mask) {
        atomicOr(tile + word, mask);
        lo = min(lo, word);
        hi = max(hi, word);
      }
    }
  }
  if (cur >= 0) flush(tile, out + cur, lo, hi, lane);
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

// CTAs of scatter_kernel<kVec> with `warps` warps and `smem` bytes that fit
// on one SM at once.  The last answer is kept, keyed on (vec, ww), so the
// level loop does not ask the runtime on every launch.
int ctas_per_sm(bool vec, int warps, size_t smem, long long ww) {
  static std::atomic<uint64_t> last{0};  // key << 32 | answer, 0: none
  const uint64_t key = ((uint64_t)vec << 20 | (uint64_t)ww) + 1;
  const uint64_t seen = last.load(std::memory_order_relaxed);
  if (seen >> 32 == key) return (int)(seen & 0xffffffffu);
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, vec ? scatter_kernel<true> : scatter_kernel<false>, warps * 32, smem);
  n = n > 0 ? n : 1;
  last.store(key << 32 | (uint64_t)n, std::memory_order_relaxed);
  return n;
}

}  // namespace

// active uint8[P, n_blocks, eb], block_win int32[P, n_blocks],
// dst_local int32[P, n_blocks, eb] -> out int32[P, n_out], which this
// zero-fills first; n_out == n_windows * ww, ww <= 12288.  vec != 0: eb is
// a multiple of 16 and active and dst_local are 16-byte aligned.
extern "C" int repro_frontier_scatter(const void* active,
                                      const void* block_win,
                                      const void* dst_local, void* out,
                                      long long p, long long n_blocks,
                                      long long eb, long long n_out,
                                      long long ww, long long vec,
                                      void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err =
      cudaMemsetAsync(out, 0, (size_t)(p * n_out) * sizeof(uint32_t), s);
  if (err != cudaSuccess) return (int)err;
  const size_t tile = (size_t)ww * sizeof(uint32_t);
  int warps = (int)(kMaxTileBytes / tile);
  warps = warps < 1 ? 1 : warps > kMaxWarps ? kMaxWarps : warps;
  const size_t smem = (size_t)warps * tile;
  const auto kernel = vec ? scatter_kernel<true> : scatter_kernel<false>;
  const int64_t total = p * n_blocks;
  const int64_t resident =
      (int64_t)ctas_per_sm(vec, warps, smem, ww) * sm_count() * warps;
  const int64_t run = (total + resident - 1) / resident;
  const int64_t ctas = (total + run * warps - 1) / (run * warps);
  kernel<<<(unsigned)ctas, warps * 32, smem, s>>>(
      (const uint8_t*)active, (const int32_t*)block_win,
      (const int32_t*)dst_local, (uint32_t*)out, n_blocks, total, eb, n_out,
      (int)ww, run);
  return (int)cudaGetLastError();
}
