// Tile rasterization, backward: per-entry gradients of the front-to-back
// alpha compositing, hand-written for Hopper (sm_90a).
//
// Replaces: gausplat_tpu/ops/rasterize.py::rasterize_backward_pallas (its
// Pallas body _backward_kernel; the math is
// gausplat_tpu/ops/blend.py::backward_batch on its default path). Like the
// forward kernel it gathers each entry's nine floats through its sorted
// point id instead of reading a gathered entry stream.
//
// What it computes, per 16x16 tile over the tile's [r0, r1) range of the
// (tile, depth16)-sorted entries: each pixel replays the forward in order,
// carrying its transmittance T and <g, prefix colour> P, and stops
// contributing at its forward rendered count (it does not decide again
// where it stopped). For a blended (entry n, pixel) pair, with g the pixel's
// colour cotangent and C its forward colour:
//   w       = alpha T,   gdc = <g, c_n>,   P_n = P + w gdc
//   d_alpha = T gdc - (<g, C> - P_n) / (1 - alpha)
//   t0 = density d_alpha,   k = -opacity t0,   t1 = k dx,   t2 = k dy
// and the entry's gradient sums over the tile's 256 pixels:
//   colour  sum w g;   opacity (outer) sum t0;
//   conic   (0.5 sum t1 dx, sum t1 dy, 0.5 sum t2 dy)  (full xy cotangent);
//   pos2d   C_conic (sum t1, sum t2).
// Output: f32 rows [9, capacity] at the sorted positions. Every slot of a
// tile's range is written (zeros past the tile's largest count); no other
// slot is.
//
// What bounds it on this card: operations. At the 1080p / 1M-point bench
// shape about 1.76M entries x 256 pixels = 450M (entry, pixel) pairs lie in
// the tile ranges, of which the pixels' forward counts keep a part; each
// kept pair costs some 45 f32 operations (the density terms again, the
// replay, nine products and nine sums), against some 150 MB of traffic
// (per-point rows and ids, the grad / <g, C> / count tiles, the [9, cap]
// output).
//
// Design: one 256-thread CTA per tile, thread = ly * 16 + lx, as the
// forward kernel. The CTA stages 128 entries at a time into shared memory
// and every pixel walks them in order. The nine per-entry sums reduce
// inside the CTA, so no atomics are needed and the order is fixed: for each
// entry each warp sums its 32 lanes with __shfl_xor_sync and lane 0 writes
// the nine partials to partial[warp][row][j]; after the batch, thread j adds
// the 8 warp partials of entry j in warp order and writes column base + j.
// A warp in which no lane blends entry j skips the shuffles (__any_sync),
// which is most warps for most entries. The partials take 8 x 9 x 128 x 4 =
// 36,864 bytes and the staged entries 4,608, under the 48 KB of static
// shared memory, so a batch is 128 entries rather than 256. The CTA stops
// replaying once the batch passes the tile's largest forward count (the
// JAX window skip at rasterize.py:525-529) and writes zeros for the rest of
// its range.
//
// Rounding: built without fast math and with -fmad=false, and the density
// terms keep the JAX evaluation order, as the forward kernel does, so the
// replay takes the same blend decisions as the forward.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;
constexpr int kPixels = kTile * kTile;
constexpr int kWarps = kPixels / 32;
constexpr int kBatch = 128;
constexpr int kRows = 9;  // r, g, b, cxx, cxy, cyy, opacity, px, py

__global__ void __launch_bounds__(kPixels) rasterize_backward_kernel(
    const float* __restrict__ point_rows,  // [9, row_stride]
    int64_t row_stride,
    const int32_t* __restrict__ sorted_ids,  // [capacity]
    const int32_t* __restrict__ tile_ranges,  // [num_tiles, 2]
    int32_t tile_count_x,
    const float* __restrict__ grad_tiles,  // [num_tiles, 3, 256]
    const float* __restrict__ gdotc_tiles,  // [num_tiles, 256]
    const int32_t* __restrict__ count_tiles,  // [num_tiles, 256]
    float opacity_max,
    float opacity_min,
    int64_t capacity,
    float* __restrict__ out) {  // [9, capacity]
  __shared__ float staged[kRows][kBatch];
  __shared__ float partial[kWarps][kRows][kBatch];
  __shared__ int32_t max_count;

  const int32_t tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const float pix_x = (float)((tile % tile_count_x) * kTile + tid % kTile);
  const float pix_y = (float)((tile / tile_count_x) * kTile + tid / kTile);
  const int32_t r0 = tile_ranges[2 * tile];
  const int32_t r1 = tile_ranges[2 * tile + 1];
  const int64_t pixel = (int64_t)tile * kPixels + tid;
  const float gr = grad_tiles[((int64_t)tile * 3 + 0) * kPixels + tid];
  const float gg = grad_tiles[((int64_t)tile * 3 + 1) * kPixels + tid];
  const float gb = grad_tiles[((int64_t)tile * 3 + 2) * kPixels + tid];
  const float gdotc = gdotc_tiles[pixel];
  const int32_t count = count_tiles[pixel];

  if (tid == 0) max_count = 0;
  __syncthreads();
  atomicMax(&max_count, count);
  __syncthreads();

  float t = 1.0f;       // transmittance before the next entry
  float prefix = 0.0f;  // <g, colour blended so far>

  int32_t base = r0;
  for (; base < r1 && base - r0 < max_count; base += kBatch) {
    const int n = min(kBatch, r1 - base);
    if (tid < n) {
      const int64_t pid = sorted_ids[base + tid];
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        staged[k][tid] = point_rows[k * row_stride + pid];
      }
    }
    __syncthreads();

    for (int j = 0; j < n; ++j) {
      float v[kRows];
#pragma unroll
      for (int k = 0; k < kRows; ++k) v[k] = 0.0f;
      bool blended = false;
      if (base - r0 + j < count) {
        const float dx = staged[7][j] - pix_x;
        const float dy = staged[8][j] - pix_y;
        const float quad = staged[3][j] * dx * dx
                         + 2.0f * staged[4][j] * dx * dy
                         + staged[5][j] * dy * dy;
        const float density = expf(-0.5f * quad);
        const float opacity = staged[6][j];
        const float a = opacity * density;
        const float alpha = a > opacity_max ? opacity_max : a;
        if (density <= 1.0f && alpha >= opacity_min) {
          blended = true;
          const float w = alpha * t;
          const float gdc = staged[0][j] * gr + staged[1][j] * gg + staged[2][j] * gb;
          const float prefix_n = prefix + w * gdc;
          const float one_minus = 1.0f - alpha;
          const float d_alpha = t * gdc - (gdotc - prefix_n) / one_minus;
          const float t0 = density * d_alpha;
          const float k = t0 * (-opacity);
          const float t1 = k * dx;
          const float t2 = k * dy;
          v[0] = w * gr;
          v[1] = w * gg;
          v[2] = w * gb;
          v[3] = t1 * dx;
          v[4] = t1 * dy;
          v[5] = t2 * dy;
          v[6] = t0;
          v[7] = t1;
          v[8] = t2;
          t *= one_minus;
          prefix = prefix_n;
        }
      }
      if (__any_sync(0xffffffffu, blended)) {
#pragma unroll
        for (int k = 0; k < kRows; ++k) {
#pragma unroll
          for (int off = 16; off > 0; off /= 2) {
            v[k] += __shfl_xor_sync(0xffffffffu, v[k], off);
          }
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int k = 0; k < kRows; ++k) partial[warp][k][j] = v[k];
      }
    }
    __syncthreads();

    if (tid < n) {
      float s[kRows];
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        float acc = 0.0f;
        for (int w = 0; w < kWarps; ++w) acc += partial[w][k][tid];
        s[k] = acc;
      }
      const float cxx = staged[3][tid], cxy = staged[4][tid], cyy = staged[5][tid];
      const int64_t e = base + tid;
      out[0 * capacity + e] = s[0];
      out[1 * capacity + e] = s[1];
      out[2 * capacity + e] = s[2];
      out[3 * capacity + e] = 0.5f * s[3];
      out[4 * capacity + e] = s[4];
      out[5 * capacity + e] = 0.5f * s[5];
      out[6 * capacity + e] = s[6];
      out[7 * capacity + e] = cxx * s[7] + cxy * s[8];
      out[8 * capacity + e] = cxy * s[7] + cyy * s[8];
    }
    __syncthreads();  // the next batch overwrites `staged` and `partial`
  }

  // Entries past every pixel's count were blended by no pixel.
  for (int64_t e = (int64_t)base + tid; e < r1; e += kPixels) {
#pragma unroll
    for (int k = 0; k < kRows; ++k) out[k * capacity + e] = 0.0f;
  }
}

}  // namespace

extern "C" int gs_rasterize_backward(
    const void* point_rows, int64_t row_stride, const void* sorted_ids,
    const void* tile_ranges, int32_t num_tiles, int32_t tile_count_x,
    const void* grad_tiles, const void* gdotc_tiles, const void* count_tiles,
    float opacity_max, float opacity_min, int64_t capacity, void* out,
    void* stream) {
  if (num_tiles > 0) {
    rasterize_backward_kernel<<<num_tiles, kPixels, 0, (cudaStream_t)stream>>>(
        (const float*)point_rows, row_stride, (const int32_t*)sorted_ids,
        (const int32_t*)tile_ranges, tile_count_x, (const float*)grad_tiles,
        (const float*)gdotc_tiles, (const int32_t*)count_tiles, opacity_max,
        opacity_min, capacity, (float*)out);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* gs_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
