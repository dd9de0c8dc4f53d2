// Tile-key expansion for the (tile, depth) sort, hand-written for Hopper (sm_90a).
//
// Replaces: gausplat_tpu/ops/expand.py::fused_point_orders (its Pallas body
// _expand_kernel), which is bit-identical to the XLA formulation
// gausplat_tpu/ops/binning.py::make_point_orders. One call computes all four
// outputs of that function, bit-identical to it and to the plain version
// gausplat_tpu_torch/ops/binning.py::make_point_orders:
// - for each of `capacity` entry slots, the sort key and the source point id,
//   in point-major, AABB row-major order, truncated at capacity; pad slots get
//   key 0x7FFFFFFF and id P;
// - the inclusive scan of the per-point tile counts, and the true total.
// The key is the reference's u32 tile_index << 16 | depth16 with its sign bit
// flipped, stored as an int32 (u32 ^ 0x80000000): a signed 32-bit sort orders
// it as the u32, as the JAX package's sort_entries flips it before its int32
// sort. The u32 pad 0xFFFFFFFF becomes 0x7FFFFFFF and still sorts last.
//
// What bounds it on this card: bytes, not operations. Each point's five
// input words are read once and its inclusive offset written once; each slot
// takes a 4-byte key and a 4-byte id. At the training step's shapes (1.2M
// points, 3.76M slots) that is about 59 MB, some 18 us at 3.35 TB/s. Per slot
// the arithmetic is a 10-step binary search in shared memory and one divide.
//
// Design: the points fall into chunks of kChunk; two kernels, one launch each.
// 1. expand_chunk_sums: one CTA per chunk sums its counts. The last CTA to
//    finish (an atomic ticket taken after __threadfence, the threadfence
//    reduction; no CTA waits on another) scans the chunk sums into chunk
//    bases and writes the total.
// 2. expand_slots: one CTA per chunk loads the chunk's five inputs with
//    coalesced loads, all in flight at once, and stages each point's count
//    (then its inclusive end), first tile (y_min * tile_count_x + x_min,
//    wrapping as the key does), AABB width and depth16 in shared memory
//    (14 B per point). It scans the counts in the block, adds the chunk
//    base and writes offsets_inc. The chunk's slots are one contiguous
//    range; the CTA walks it slot-major with stride kThreads, each thread
//    finding its slot's point by an upper-bound binary search over the
//    staged ends (which skips points that touch no tile). So consecutive
//    lanes store consecutive 4-byte words, and a long run spreads over all
//    256 threads. CTAs past the chunk count write the pads [min(total,
//    capacity), capacity) with 16-byte stores, reading the total on the
//    device: the host never syncs.
// The design it replaces ran one thread per point over its whole run (lanes
// idle behind the longest run of their warp; each store instruction touched
// the runs of 32 points), after a separate scan and before a separate pad
// kernel, and held each key in 8 bytes. Tried on the card and no faster:
// chunks of 512 or 2,048 points (2,048: 11-23% slower), four slots
// a thread per pass, staging 256 points at a time with the next 256's loads
// in flight, the pad CTAs first, and four chunks to a CTA of the first kernel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Points per chunk (ops/expand.py::CHUNK_POINTS, which sizes the scratch: a
// ticket and one word per chunk).
constexpr int kChunk = 1024;
constexpr int kPerThread = kChunk / kThreads;

constexpr uint32_t kSignFlip = 0x80000000u;
constexpr int32_t kPadKey = 0x7FFFFFFF;  // the u32 pad 0xFFFFFFFF, flipped
// Pad CTAs: at most two per SM; each walks the pads with a grid stride.
constexpr int64_t kMaxPadBlocks = 264;

// Inclusive scan of one word per thread over the CTA (wrapping u32 adds, the
// int32 cumsum's wrap). Every thread must call it; it ends on a barrier, so
// `warp_sums` ([kWarps] shared) may be reused at once.
__device__ __forceinline__ uint32_t block_inclusive_scan(uint32_t v, uint32_t* warp_sums,
                                                         uint32_t* block_total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t up = __shfl_up_sync(0xFFFFFFFFu, v, d);
    if (lane >= d) v += up;
  }
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    uint32_t w = lane < kWarps ? warp_sums[lane] : 0u;
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      const uint32_t up = __shfl_up_sync(0xFFFFFFFFu, w, d);
      if (lane >= d) w += up;
    }
    if (lane < kWarps) warp_sums[lane] = w;
  }
  __syncthreads();
  const uint32_t inclusive = v + (warp > 0 ? warp_sums[warp - 1] : 0u);
  *block_total = warp_sums[kWarps - 1];
  __syncthreads();
  return inclusive;
}

// scratch: [0] the ticket (zeroed before the launch), [1 + c] chunk c's sum,
// which the last CTA replaces with chunk c's base.
__global__ void __launch_bounds__(kThreads) expand_chunk_sums(
    const int32_t* __restrict__ tile_counts,
    int32_t n_points,
    uint32_t* __restrict__ scratch,
    int32_t* __restrict__ total) {
  __shared__ uint32_t warp_sums[kWarps];
  __shared__ bool is_last;
  uint32_t* sums = scratch + 1;
  const int64_t first = (int64_t)blockIdx.x * kChunk;
  uint32_t sum = 0;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int64_t p = first + j * kThreads + threadIdx.x;
    if (p < n_points) sum += (uint32_t)tile_counts[p];
  }
  uint32_t chunk_sum;
  block_inclusive_scan(sum, warp_sums, &chunk_sum);
  if (threadIdx.x == 0) {
    sums[blockIdx.x] = chunk_sum;
    __threadfence();  // the sum is visible before the ticket is
    is_last = atomicAdd(scratch, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!is_last) return;

  // The last CTA: every chunk's sum was fenced before its ticket. Read them
  // from L2 (__ldcg), not from a stale L1 line, kPerThread consecutive sums
  // a thread, all loads in flight at once.
  __threadfence();
  uint32_t carry = 0;
  for (uint32_t c0 = 0; c0 < gridDim.x; c0 += kChunk) {
    const uint32_t mine = c0 + threadIdx.x * kPerThread;
    uint32_t v[kPerThread];
    uint32_t run = 0;
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      v[j] = mine + j < gridDim.x ? __ldcg(sums + mine + j) : 0u;
      run += v[j];
    }
    uint32_t tile_sum;
    uint32_t base = carry + block_inclusive_scan(run, warp_sums, &tile_sum) - run;
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      if (mine + j < gridDim.x) sums[mine + j] = base;
      base += v[j];
    }
    carry += tile_sum;
  }
  if (threadIdx.x == 0) *total = (int32_t)carry;
}

__global__ void __launch_bounds__(kThreads) expand_slots(
    const float* __restrict__ depths,
    const int32_t* __restrict__ tile_x_max,
    const int32_t* __restrict__ tile_x_min,
    const int32_t* __restrict__ tile_y_min,
    const int32_t* __restrict__ tile_counts,
    const uint32_t* __restrict__ scratch,
    const int32_t* __restrict__ total,
    int32_t n_points,
    int32_t n_chunks,
    int32_t tile_count_x,
    int64_t capacity,
    uint32_t depth_order_offset,
    int32_t* __restrict__ offsets_inc,
    int32_t* __restrict__ keys,
    int32_t* __restrict__ src) {
  if ((int32_t)blockIdx.x >= n_chunks) {
    // Pads. The clamp at 0 keeps the stores in bounds if the int32 total
    // wrapped (more than 2^31 entries; the outputs are then meaningless).
    const int64_t from = max(min((int64_t)*total, capacity), (int64_t)0);
    const int64_t stride = (int64_t)(gridDim.x - n_chunks) * kThreads;
    const int64_t t = (int64_t)(blockIdx.x - n_chunks) * kThreads + threadIdx.x;
    // Words up to a 16-byte boundary, then four words a store, then the rest
    // (the outputs come from the allocator, 16-byte aligned).
    const int64_t head = min((from + 3) & ~(int64_t)3, capacity);
    const int64_t body = max(capacity & ~(int64_t)3, head);
    for (int64_t e = from + t; e < head; e += stride) {
      keys[e] = kPadKey;
      src[e] = n_points;
    }
    const int4 key4 = make_int4(kPadKey, kPadKey, kPadKey, kPadKey);
    const int4 src4 = make_int4(n_points, n_points, n_points, n_points);
    for (int64_t v = head / 4 + t; v < body / 4; v += stride) {
      reinterpret_cast<int4*>(keys)[v] = key4;
      reinterpret_cast<int4*>(src)[v] = src4;
    }
    for (int64_t e = body + t; e < capacity; e += stride) {
      keys[e] = kPadKey;
      src[e] = n_points;
    }
    return;
  }

  __shared__ uint32_t warp_sums[kWarps];
  __shared__ int32_t s_end[kChunk];     // inclusive end of each point's slots
  __shared__ uint32_t s_tile[kChunk];   // tile of the point's first slot
  __shared__ int32_t s_width[kChunk];   // AABB width, at least 1
  __shared__ uint16_t s_depth[kChunk];  // depth16

  const int64_t first = (int64_t)blockIdx.x * kChunk;
  const int n = (int)min((int64_t)kChunk, (int64_t)n_points - first);
  const uint32_t base = scratch[1 + blockIdx.x];
  // Stage with coalesced loads, every load of the chunk in flight at once;
  // s_end holds the counts until the scan.
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int i = j * kThreads + threadIdx.x;
    if (i < n) {
      const int64_t p = first + i;
      s_end[i] = tile_counts[p];
      const int32_t x0 = tile_x_min[p];
      s_tile[i] = (uint32_t)tile_y_min[p] * (uint32_t)tile_count_x + (uint32_t)x0;
      s_width[i] = max(tile_x_max[p] - x0, 1);
      // Wrapping u32 add, then the top 16 of the remaining 21 bits
      // (rank/kernel.wgsl:112-114 of the reference).
      s_depth[i] = (uint16_t)(((__float_as_uint(depths[p]) + depth_order_offset) >> 11) & 0xFFFFu);
    }
  }
  __syncthreads();
  // Scan: each thread takes kPerThread consecutive points.
  const int mine = threadIdx.x * kPerThread;
  uint32_t counts[kPerThread];
  uint32_t run = 0;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    counts[j] = mine + j < n ? (uint32_t)s_end[mine + j] : 0u;
    run += counts[j];
  }
  uint32_t chunk_sum;  // the scan ends on a barrier: every count is read
  uint32_t end = base + block_inclusive_scan(run, warp_sums, &chunk_sum) - run;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    end += counts[j];
    if (mine + j < n) s_end[mine + j] = (int32_t)end;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int i = j * kThreads + threadIdx.x;
    if (i < n) offsets_inc[first + i] = s_end[i];
  }
  const uint32_t carry = base + chunk_sum;

  // The chunk's slots: [base, base + sum), cut at capacity (and kept in
  // bounds if the int32 offsets wrapped).
  const int64_t lo = max((int64_t)(int32_t)base, (int64_t)0);
  const int64_t hi = min((int64_t)(int32_t)carry, capacity);
  for (int64_t s = lo + threadIdx.x; s < hi; s += kThreads) {
    // The first point whose inclusive end exceeds s: the count of staged
    // ends <= s. It exists, since the chunk's last end exceeds every slot.
    int i = 0;
#pragma unroll
    for (int step = kChunk / 2; step > 0; step >>= 1) {
      if (i + step <= n && s_end[i + step - 1] <= s) i += step;
    }
    const int64_t start = i > 0 ? (int64_t)s_end[i - 1] : (int64_t)(int32_t)base;
    const int32_t local = (int32_t)(s - start);
    const int32_t width = s_width[i];
    const int32_t q = local / width;
    const int32_t r = local - q * width;
    const uint32_t tile = s_tile[i] + (uint32_t)q * (uint32_t)tile_count_x + (uint32_t)r;
    keys[s] = (int32_t)(((tile << 16) | s_depth[i]) ^ kSignFlip);
    src[s] = (int32_t)(first + i);
  }
}

}  // namespace

// Outputs: keys, src [capacity] int32; offsets_inc [n_points] int32; total
// [] int32. scratch: 1 + ceil(n_points / kChunk) int32 words.
extern "C" int gs_expand_point_orders(
    const void* depths, const void* tile_x_max, const void* tile_x_min,
    const void* tile_y_min, const void* tile_counts, int32_t n_points,
    int32_t tile_count_x, int64_t capacity, uint32_t depth_order_offset,
    void* keys, void* src, void* offsets_inc, void* total, void* scratch,
    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int32_t n_chunks = (int32_t)(((int64_t)n_points + kChunk - 1) / kChunk);
  cudaError_t err;
  if (n_chunks > 0) {
    err = cudaMemsetAsync(scratch, 0, sizeof(uint32_t), s);
    if (err != cudaSuccess) return (int)err;
    expand_chunk_sums<<<n_chunks, kThreads, 0, s>>>(
        (const int32_t*)tile_counts, n_points, (uint32_t*)scratch, (int32_t*)total);
  } else {
    err = cudaMemsetAsync(total, 0, sizeof(int32_t), s);
    if (err != cudaSuccess) return (int)err;
  }
  const int64_t want = (capacity + kThreads - 1) / kThreads;
  const int64_t pad_blocks = want < kMaxPadBlocks ? want : kMaxPadBlocks;
  if (n_chunks + pad_blocks > 0) {
    expand_slots<<<(unsigned)(n_chunks + pad_blocks), kThreads, 0, s>>>(
        (const float*)depths, (const int32_t*)tile_x_max, (const int32_t*)tile_x_min,
        (const int32_t*)tile_y_min, (const int32_t*)tile_counts,
        (const uint32_t*)scratch, (const int32_t*)total, n_points, n_chunks,
        tile_count_x, capacity, depth_order_offset, (int32_t*)offsets_inc,
        (int32_t*)keys, (int32_t*)src);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* gs_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
