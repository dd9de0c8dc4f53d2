// Tile-key expansion for the (tile, depth) sort, hand-written for Hopper (sm_90a).
//
// Replaces: gausplat_tpu/ops/expand.py::fused_point_orders (its Pallas body
// _expand_kernel), which is bit-identical to the XLA formulation
// gausplat_tpu/ops/binning.py::make_point_orders. The outputs here are
// bit-identical to both: for each of `capacity` entry slots, the sort key
// (tile_index << 16 | depth16, as a u32 held in an int64) and the source
// point id, in point-major, AABB row-major order, truncated at capacity;
// pad slots get key 0xFFFFFFFF and id P.
//
// What bounds it on this card: bytes, not operations. Each point is read
// once (5 words) and each slot written once (8-byte key + 4-byte id); the
// per-slot arithmetic is one integer divide. At the 1080p / 1M-point shape
// (1.87M slots) that is about 42 MB of traffic, some 13 us at the H100's
// 3.35 TB/s.
//
// Design: one thread per point writes its own tile run at its exclusive
// scan offset (the reference renderer's rank-kernel form). The TPU kernel's
// windowed span search, MXU one-hot select and 12/12-bit f32 split existed
// because the TPU cannot scatter cheaply; a GPU scatters natively, and
// integer division is exact, so all of that is gone. Neighbouring threads
// write neighbouring runs, so stores stay mostly coalesced when runs are
// short (about 2 tiles per visible point at 1080p); a point with a long
// run keeps its thread busy longer, which is the kernel's one imbalance.
// A second, grid-stride kernel writes the pads [min(total, capacity),
// capacity); it reads `total` on the device, so the host never syncs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void expand_entries(
    const float* __restrict__ depths,
    const int32_t* __restrict__ tile_x_max,
    const int32_t* __restrict__ tile_x_min,
    const int32_t* __restrict__ tile_y_min,
    const int32_t* __restrict__ tile_counts,
    const int32_t* __restrict__ offsets_inc,
    int32_t n_points,
    int32_t tile_count_x,
    int64_t capacity,
    uint32_t depth_order_offset,
    int64_t* __restrict__ keys,
    int32_t* __restrict__ src) {
  const int32_t p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_points) return;
  const int32_t count = tile_counts[p];
  if (count <= 0) return;
  const int64_t start = (int64_t)offsets_inc[p] - count;
  if (start >= capacity) return;
  const int64_t n = min((int64_t)count, capacity - start);

  const int32_t x0 = tile_x_min[p];
  const int32_t y0 = tile_y_min[p];
  const int32_t width = max(tile_x_max[p] - x0, 1);
  // Wrapping u32 add, then the top 16 of the remaining 21 bits
  // (rank/kernel.wgsl:112-114 of the reference).
  const uint32_t depth16 =
      ((__float_as_uint(depths[p]) + depth_order_offset) >> 11) & 0xFFFFu;

  for (int32_t local = 0; local < n; ++local) {
    const int32_t q = local / width;
    const int32_t r = local - q * width;
    const uint32_t tile = (uint32_t)((y0 + q) * tile_count_x + x0 + r);
    keys[start + local] = (int64_t)((tile << 16) | depth16);
    src[start + local] = p;
  }
}

__global__ void fill_pads(
    const int32_t* __restrict__ total,
    int64_t capacity,
    int32_t n_points,
    int64_t* __restrict__ keys,
    int32_t* __restrict__ src) {
  const int64_t first = min((int64_t)*total, capacity);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t e = first + (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       e < capacity; e += stride) {
    keys[e] = 0xFFFFFFFFll;
    src[e] = n_points;
  }
}

}  // namespace

extern "C" int gs_expand_point_orders(
    const void* depths, const void* tile_x_max, const void* tile_x_min,
    const void* tile_y_min, const void* tile_counts, const void* offsets_inc,
    const void* total, int32_t n_points, int32_t tile_count_x,
    int64_t capacity, uint32_t depth_order_offset, void* keys, void* src,
    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int threads = 256;
  if (n_points > 0) {
    expand_entries<<<(n_points + threads - 1) / threads, threads, 0, s>>>(
        (const float*)depths, (const int32_t*)tile_x_max,
        (const int32_t*)tile_x_min, (const int32_t*)tile_y_min,
        (const int32_t*)tile_counts, (const int32_t*)offsets_inc, n_points,
        tile_count_x, capacity, depth_order_offset, (int64_t*)keys,
        (int32_t*)src);
  }
  if (capacity > 0) {
    const int64_t want = (capacity + threads - 1) / threads;
    const int blocks = (int)(want < 1024 ? want : 1024);
    fill_pads<<<blocks, threads, 0, s>>>(
        (const int32_t*)total, capacity, n_points, (int64_t*)keys,
        (int32_t*)src);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* gs_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
