// Frontier bit-gather: is the source of each edge slot in the frontier?
//
// Replaces the TPU kernels of src/repro/kernels/frontier_gather.py:
//   frontier_gather_full (_full_kernel)     -> gather_full_l2_kernel
//   frontier_gather      (_windowed_kernel) -> gather_window_kernel
//
// What bounds it on the H100: bytes.  A slot reads one int32 vertex id and
// writes one byte, and the bitmap words it tests need come from device
// memory only once per rank.  Where a rank's ids are sorted, neighbouring
// slots share words, and the ids' and results' own bytes are the bound.
// Where they are in random order, each word read costs a 32-byte L2 sector
// for one bit, eight times the id's bytes, and L2 is the bound; a rank's
// bitmap (over 1 MB at Kronecker scale 23) is too large for one SM's
// shared memory, which is what the TPU kernel held it in (VMEM).
//
// What the design does about it.  The full gather treats each rank's
// slots as one flat row and reads the words with __ldg through L1 and L2;
// the wrapper picks one of two routes from the ids' order
// (frontier_gather.plan_gather_full):
// - walk (gather_full_l2_kernel<., 4>, sorted ids): lane i takes slots
//   4i..4i+3 of each 128, so a warp's one 16-byte id load reads 512
//   contiguous bytes and its 4-byte store writes 128; a persistent grid
//   (sized once from the occupancy API) walks the chunks grid-stride, so
//   the whole card works on one rank's bitmap at a time and L1 and L2 hold
//   it.
// - probe (gather_full_l2_kernel<., 1>, random ids): one slot a lane and a
//   warp for every 32 slots, in rank order, so that each SM has fewer
//   random reads in flight, and the ids and results streamed past L1
//   (__ldcs, __stcs), so that L1 keeps more of the bitmap; it measured
//   faster than the walk on them.  L2 bounds it: every slot reads a 32-byte
//   sector that L1 does not hold.
// - gather_window_kernel: one warp per 512-slot edge block, each warp
//   walking a contiguous run of blocks; lane i takes slots 16i..16i+15
//   (four 16-byte id loads, one 16-byte store).  The block's window (the
//   TPU prefetched its index as a scalar) is loaded once per run of blocks
//   that share it: for ww <= 32, lane j holds word j in a register and a
//   slot's word is fetched with __shfl_sync, so there is no shared memory
//   and no barrier; a larger window (up to 12288 words, 48 KB) is read with
//   __ldg.
// An eb (or a row) that is not a multiple of 16 (4), or a pointer that is
// not 16-byte aligned (the wrapper checks and passes `vec`), takes the
// same path with 4-byte loads and 1-byte stores.  Ids outside the bitmap
// (or the window) read as 0 and never address memory outside it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLaneSlots = 16;  // of a windowed gather's lane
constexpr int kWarpSlots = 32 * kLaneSlots;  // one 512-slot edge block
constexpr uint32_t kFull = 0xffffffffu;
constexpr uint32_t kNone = 0xffffffffu;  // an id outside every bitmap

// The ids of the kN (4 or 16) slots from e0 of one block; kNone past eb.
template <bool kVec, int kN>
__device__ __forceinline__ void load_ids(const int32_t* s, int64_t e0,
                                         int64_t eb, uint32_t (&x)[kN]) {
  if constexpr (kVec) {
#pragma unroll
    for (int q = 0; q < kN / 4; ++q) {
      uint4 v = make_uint4(kNone, kNone, kNone, kNone);
      if (e0 < eb) v = __ldg(reinterpret_cast<const uint4*>(s + e0) + q);
      x[4 * q] = v.x;
      x[4 * q + 1] = v.y;
      x[4 * q + 2] = v.z;
      x[4 * q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kN; ++j) x[j] = e0 + j < eb ? (uint32_t)s[e0 + j] : kNone;
  }
}

// Store the kN result bytes `packed` of the slots from e0 of one block.
template <bool kVec, int kN>
__device__ __forceinline__ void store_bits(uint8_t* o, int64_t e0, int64_t eb,
                                           const uint32_t (&packed)[kN / 4]) {
  if constexpr (kVec && kN == 16) {
    if (e0 < eb)
      *reinterpret_cast<uint4*>(o + e0) =
          make_uint4(packed[0], packed[1], packed[2], packed[3]);
  } else if constexpr (kVec) {
    if (e0 < eb) *reinterpret_cast<uint32_t*>(o + e0) = packed[0];
  } else {
#pragma unroll
    for (int j = 0; j < kN; ++j)
      if (e0 + j < eb) o[e0 + j] = (packed[j >> 2] >> (8 * (j & 3))) & 1u;
  }
}

// Bits a bitmap of n_words words holds, as the uint32 bound of an id.
__device__ __forceinline__ uint32_t bitmap_bits(int64_t n_words) {
  return n_words >= (int64_t(1) << 27) ? kFull : (uint32_t)n_words * 32u;
}

// words uint32[P, n_words], src int32[P, slots] -> out uint8[P, slots]:
// the full gather's rows are flat (P * n_blocks * eb slots, blocks do not
// matter to it).  kVec: slots % 4 == 0 and the rows 16-byte aligned.
// Lane i of a warp takes slots kN*i .. kN*i+kN-1 of a chunk of 32*kN, and
// warp g of a grid of G warps takes chunks g, g + G, ... of the rank-major
// chunk order (`chunks` a rank).  The words
// are read with __ldg through L1 and L2; with one slot a lane (random ids)
// the ids and results stream past L1 (__ldcs, __stcs), which is left to
// the words.  An id out of range reads word 0 and keeps bit 0, so every
// slot issues one load, unbranched.
template <bool kVec, int kN>
__global__ void __launch_bounds__(kThreads)
    gather_full_l2_kernel(const uint32_t* __restrict__ words,
                          const int32_t* __restrict__ src,
                          uint8_t* __restrict__ out, int64_t n_words,
                          int64_t slots, int64_t chunks, int64_t total) {
  const int lane = threadIdx.x & 31;
  const int64_t stride = (int64_t)gridDim.x * (blockDim.x >> 5);
  const uint32_t bits = bitmap_bits(n_words);
  for (int64_t c = (int64_t)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
       c < total; c += stride) {
    const int64_t rank = c / chunks;
    const int64_t e0 = (c - rank * chunks) * (32 * kN) + lane * kN;
    const uint32_t* rw = words + rank * n_words;
    const int32_t* s = src + rank * slots;
    uint8_t* o = out + rank * slots;
    uint32_t x[kN], w[kN], packed[(kN + 3) / 4] = {0u};
    if constexpr (kN == 1)
      x[0] = e0 < slots ? (uint32_t)__ldcs(s + e0) : kNone;
    else
      load_ids<kVec>(s, e0, slots, x);
#pragma unroll
    for (int j = 0; j < kN; ++j) w[j] = __ldg(rw + (x[j] < bits ? x[j] >> 5 : 0u));
#pragma unroll
    for (int j = 0; j < kN; ++j)
      packed[j >> 2] |= (x[j] < bits ? (w[j] >> (x[j] & 31u)) & 1u : 0u) << (8 * (j & 3));
    if constexpr (kN == 1) {
      if (e0 < slots)
        __stcs(reinterpret_cast<signed char*>(o + e0), (signed char)packed[0]);
    } else {
      store_bits<kVec, kN>(o, e0, slots, packed);
    }
  }
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
      load_ids<kVec>(s, e0, eb, x);
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
      store_bits<kVec, kLaneSlots>(o, e0, eb, packed);
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

// Warps of `kernel` (kThreads a CTA, no shared memory) that fit on the
// card at once, asked of the runtime the first time it is launched.
template <auto kernel>
int64_t resident_warps() {
  static const int64_t n = [] {
    int per_sm = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
    return (int64_t)(per_sm > 0 ? per_sm : 1) * sm_count() * (kThreads / 32);
  }();
  return n;
}

// Blocks each warp of a persistent grid of `resident` warps takes, and the
// CTAs of kThreads that cover `total` blocks that way.
void persistent_grid(int64_t total, int64_t resident, int64_t* run,
                     int64_t* ctas) {
  const int64_t warps = kThreads / 32;
  *run = (total + resident - 1) / resident;
  *ctas = (total + *run * warps - 1) / (*run * warps);
}

// The full gather on the walk (kN = 4, a persistent grid) or the probe
// (kN = 1, a warp for every 32 slots).
template <bool kVec, int kN>
int launch_gather_full(const void* words, const void* src, void* out,
                       int64_t p, int64_t n_words, int64_t slots,
                       cudaStream_t stream) {
  constexpr auto kernel = gather_full_l2_kernel<kVec, kN>;
  const int64_t chunks = (slots + 32 * kN - 1) / (32 * kN);
  const int64_t warps = kThreads / 32;
  int64_t ctas = (p * chunks + warps - 1) / warps;
  if (kN > 1) {
    const int64_t resident = resident_warps<kernel>() / warps;
    ctas = ctas < resident ? ctas : resident;
  }
  kernel<<<(unsigned)ctas, kThreads, 0, stream>>>(
      (const uint32_t*)words, (const int32_t*)src, (uint8_t*)out, n_words,
      slots, chunks, p * chunks);
  return (int)cudaGetLastError();
}

template <bool kVec, bool kShfl>
int launch_gather_window(const void* words, const void* block_ws,
                         const void* src_local, void* out, int64_t p,
                         int64_t n_words, int64_t n_blocks, int64_t eb,
                         int64_t ww, cudaStream_t stream) {
  constexpr auto kernel = gather_window_kernel<kVec, kShfl>;
  int64_t run, ctas;
  persistent_grid(p * n_blocks, resident_warps<kernel>(), &run, &ctas);
  kernel<<<(unsigned)ctas, kThreads, 0, stream>>>(
      (const uint32_t*)words, (const int32_t*)block_ws,
      (const int32_t*)src_local, (uint8_t*)out, n_words, n_blocks,
      p * n_blocks, eb, (int)ww, run);
  return (int)cudaGetLastError();
}

}  // namespace

// words int32[P, n_words], src int32[P, slots] -> out uint8[P, slots].
// walk == 0: the probe (random ids), else the walk (sorted ids).  vec != 0:
// slots is a multiple of 4 and src and out are 16-byte aligned.
extern "C" int repro_frontier_gather_full(const void* words, const void* src,
                                          void* out, long long p,
                                          long long n_words, long long slots,
                                          long long walk, long long vec,
                                          void* stream) {
  const auto launch = walk ? (vec ? launch_gather_full<true, 4>
                                  : launch_gather_full<false, 4>)
                           : (vec ? launch_gather_full<true, 1>
                                  : launch_gather_full<false, 1>);
  return launch(words, src, out, p, n_words, slots, (cudaStream_t)stream);
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
  const auto launch = vec ? (shfl ? launch_gather_window<true, true>
                                  : launch_gather_window<true, false>)
                          : (shfl ? launch_gather_window<false, true>
                                  : launch_gather_window<false, false>);
  return launch(words, block_ws, src_local, out, p, n_words, n_blocks, eb, ww,
                (cudaStream_t)stream);
}
