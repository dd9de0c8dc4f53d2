// Tile rasterization, forward: front-to-back alpha compositing, hand-written
// for Hopper (sm_90a).
//
// Replaces: gausplat_tpu/ops/rasterize.py::rasterize_forward_pallas (its
// Pallas body _forward_kernel; the blend math is
// gausplat_tpu/ops/blend.py::density_terms and forward_batch). It also
// absorbs the per-entry gather of build_entry_stream: each entry's nine
// floats are read through its sorted point id from the per-point rows.
// Both entry layouts of the TPU kernel (stream.packed) are entry points of
// this library, one instantiation each of the kernel's template over the
// row type (tile_batch.cuh): gs_rasterize_forward takes f32 rows [9, P + 1],
// gs_rasterize_forward_packed the packed bf16-pair rows [6, P + 1], whose
// words staging decodes into the same nine floats (exactly, as
// gausplat_tpu/ops/blend.py::entries_from_rows does); the footprint and
// the walk read only the decoded values, so the skip stays exact.
//
// What it computes, per 16x16 tile over the tile's [r0, r1) range of the
// (tile, depth16)-sorted entries, per pixel:
//   density = exp(-0.5 * (cxx dx^2 + 2 cxy dx dy + cyy dy^2)), skipped
//             unless density <= 1;
//   alpha   = min(opacity * density, 252/255), skipped if alpha < 1/255;
//   the pixel stops *before* a blend that would take its transmittance
//   below (1 - 252/255)^2; the rendered count is 1 + the segment position
//   of the last blended entry. Empty tiles get (0, 1, 0).
//
// What bounds it on this card: the per-(entry, pixel) exp and the dozen
// flops around it, not bytes. At the 1080p / 1M-point shape there are
// about 1.76M entries x 256 pixels = 450M pairs in the tile ranges; the
// entry data is 9 floats per entry (63 MB with the ids), read once per
// tile; 6 words in the packed layout (a third less). Most of those pairs
// cannot blend: the design spends the exp on the pairs that can.
//
// Design: one 256-thread CTA per tile, thread = ly * 16 + lx (the lane
// order of rasterize.py::_pixel_coords), walking its range in batches of
// 256 entries, one per thread (tile_batch.cuh):
// - thread j gathers entry j's nine floats into shared memory and computes
//   the entry's warp mask from them (tile_batch.cuh::entry_warp_mask,
//   shared with the backward kernel): the tile's 16x2 warp strips that its
//   alpha >= 1/255 ellipse can reach;
// - each warp walks only the entries whose bit it holds, in order (a ballot
//   per 32 entries, then the set bits); a skipped entry costs the warp no
//   exp. A skipped pair cannot blend, so the per-pixel order of the blended
//   entries, and every output, is that of walking every entry;
// - all threads read the same shared word at once (a broadcast); the whole
//   tile leaves early once every pixel is done (__syncthreads_count, also
//   the barrier before the next batch overwrites the staged one). The TPU
//   kernel's window/step machinery is gone: a CTA loops over its own range
//   instead of the grid stepping through (tile, window) pairs.
// - Two barriers per batch. Overlapping the next batch's gather with the
//   walk (double-buffered cp.async) was measured and did not pay (PERF.md,
//   Findings): the CTAs resident beside a staging CTA hide its gather. The
//   footprint is f32 (but for the determinant) to keep the registers, and
//   so the resident CTAs, where they were: in double it took 54 registers
//   and four CTAs per SM. __launch_bounds__(256, 8) holds both layouts to
//   32 registers and eight CTAs per SM: without the eight, each entry
//   point of the template takes 39 (six CTAs), the packed one for the
//   decode in staging.
//
// Rounding: built without fast math (expf, not __expf) and with
// -fmad=false, and the quadratic form keeps the JAX evaluation order
// cxx*dx*dx + 2*cxy*dx*dy + cyy*dy*dy; comparisons are written so a NaN
// takes the same branch as the JAX version (jnp.minimum propagates NaN).

#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_batch.cuh"

namespace {

using namespace gs;

constexpr uint32_t kAllLanes = 0xffffffffu;
constexpr int kMinBlocks = 8;  // resident CTAs per SM: at most 32 registers

template <typename Row>
__global__ void __launch_bounds__(kPixels, kMinBlocks) rasterize_forward_kernel(
    const Row* __restrict__ point_rows,  // [9 or 6, row_stride]
    int64_t row_stride,
    const int32_t* __restrict__ sorted_ids,  // [capacity]
    const int32_t* __restrict__ tile_ranges,  // [num_tiles, 2]
    int32_t tile_count_x,
    float opacity_max,
    float opacity_min,
    float transmittance_min,
    float* __restrict__ image,  // [num_tiles, 3, 256]
    float* __restrict__ transmittance,  // [num_tiles, 256]
    int32_t* __restrict__ counts) {  // [num_tiles, 256]
  __shared__ float staged[kRows][kPixels];
  __shared__ uint8_t mask[kPixels];  // bit w: warp w walks the entry

  const int32_t tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int32_t x0 = (tile % tile_count_x) * kTile;
  const int32_t y0 = (tile / tile_count_x) * kTile;
  const float pix_x = (float)(x0 + tid % kTile);
  const float pix_y = (float)(y0 + tid / kTile);
  const int32_t r0 = tile_ranges[2 * tile];
  const int32_t r1 = tile_ranges[2 * tile + 1];

  float cr = 0.0f, cg = 0.0f, cb = 0.0f;
  float t = 1.0f;
  int32_t rendered = 0;
  int done = 0;

  for (int32_t base = r0; base < r1; base += kPixels) {
    if (__syncthreads_count(done) == kPixels) break;
    const int32_t e = base + tid;
    mask[tid] = e < r1 ? (uint8_t)stage_entry<kPixels>(staged, tid, point_rows, row_stride,
                                                       sorted_ids[e], x0, y0, opacity_min)
                       : (uint8_t)0;
    __syncthreads();

    const int n = min(kPixels, r1 - base);
    for (int word = 0; word * 32 < n; ++word) {
      if (__all_sync(kAllLanes, done)) break;
      const int jj = word * 32 + lane;
      uint32_t bits = __ballot_sync(kAllLanes, jj < n && ((mask[jj] >> warp) & 1u));
      if (done) continue;
      while (bits) {
        const int j = word * 32 + __ffs(bits) - 1;
        bits &= bits - 1u;
        const float dx = staged[7][j] - pix_x;
        const float dy = staged[8][j] - pix_y;
        const float quad = staged[3][j] * dx * dx
                         + 2.0f * staged[4][j] * dx * dy
                         + staged[5][j] * dy * dy;
        const float density = expf(-0.5f * quad);
        if (!(density <= 1.0f)) continue;
        const float a = staged[6][j] * density;
        const float alpha = a > opacity_max ? opacity_max : a;
        if (!(alpha >= opacity_min)) continue;
        const float t_next = t * (1.0f - alpha);
        if (!(t_next >= transmittance_min)) {
          done = 1;
          break;
        }
        const float w = alpha * t;
        cr += staged[0][j] * w;
        cg += staged[1][j] * w;
        cb += staged[2][j] * w;
        rendered = base - r0 + j + 1;
        t = t_next;
      }
    }
  }

  image[((int64_t)tile * 3 + 0) * kPixels + tid] = cr;
  image[((int64_t)tile * 3 + 1) * kPixels + tid] = cg;
  image[((int64_t)tile * 3 + 2) * kPixels + tid] = cb;
  transmittance[(int64_t)tile * kPixels + tid] = t;
  counts[(int64_t)tile * kPixels + tid] = rendered;
}

template <typename Row>
int launch(const void* point_rows, int64_t row_stride, const void* sorted_ids,
           const void* tile_ranges, int32_t num_tiles, int32_t tile_count_x,
           float opacity_max, float opacity_min, float transmittance_min,
           void* image, void* transmittance, void* counts, void* stream) {
  if (num_tiles > 0) {
    rasterize_forward_kernel<Row><<<num_tiles, kPixels, 0, (cudaStream_t)stream>>>(
        (const Row*)point_rows, row_stride, (const int32_t*)sorted_ids,
        (const int32_t*)tile_ranges, tile_count_x, opacity_max, opacity_min,
        transmittance_min, (float*)image, (float*)transmittance,
        (int32_t*)counts);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// f32 rows [9, row_stride].
extern "C" int gs_rasterize_forward(
    const void* point_rows, int64_t row_stride, const void* sorted_ids,
    const void* tile_ranges, int32_t num_tiles, int32_t tile_count_x,
    float opacity_max, float opacity_min, float transmittance_min,
    void* image, void* transmittance, void* counts, void* stream) {
  return launch<float>(point_rows, row_stride, sorted_ids, tile_ranges, num_tiles,
                       tile_count_x, opacity_max, opacity_min, transmittance_min, image,
                       transmittance, counts, stream);
}

// Packed rows [6, row_stride] (int32 words).
extern "C" int gs_rasterize_forward_packed(
    const void* point_rows, int64_t row_stride, const void* sorted_ids,
    const void* tile_ranges, int32_t num_tiles, int32_t tile_count_x,
    float opacity_max, float opacity_min, float transmittance_min,
    void* image, void* transmittance, void* counts, void* stream) {
  return launch<uint32_t>(point_rows, row_stride, sorted_ids, tile_ranges, num_tiles,
                          tile_count_x, opacity_max, opacity_min, transmittance_min, image,
                          transmittance, counts, stream);
}

// Launch facts for a report (tile_batch.cuh::kernel_info), per layout.
extern "C" int gs_kernel_info(int32_t* registers, int32_t* shared_bytes,
                              int32_t* blocks_per_sm) {
  return gs::kernel_info(rasterize_forward_kernel<float>, registers, shared_bytes,
                         blocks_per_sm);
}

extern "C" int gs_kernel_info_packed(int32_t* registers, int32_t* shared_bytes,
                                     int32_t* blocks_per_sm) {
  return gs::kernel_info(rasterize_forward_kernel<uint32_t>, registers, shared_bytes,
                         blocks_per_sm);
}

extern "C" const char* gs_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
