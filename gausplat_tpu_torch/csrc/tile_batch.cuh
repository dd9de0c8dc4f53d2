// What the two rasterize kernels share: staging a batch of a tile's entries
// into shared memory, and each entry's footprint in its tile (the warp
// strips it can blend in). Included by rasterize_forward.cu and
// rasterize_backward.cu, so both kernels skip exactly the same
// (entry, warp) pairs. Plain version of the footprint:
// gausplat_tpu_torch/ops/rasterize.py::footprint_warp_masks.
//
// Footprint. A tile's 256 pixels are thread = ly * 16 + lx, so warp w holds
// the 16x2 strip of rows 2w and 2w + 1. A pair (entry, pixel) blends only
// if alpha = min(opacity * density, 252/255) >= opacity_min, that is
// opacity * exp(-q / 2) >= opacity_min with q = d^T C d, d the pixel's
// offset from the entry and C its conic: q <= q_max = 2 ln(opacity /
// opacity_min). For a positive definite C the ellipse q <= Q has the
// half-extents sqrt(Q cyy / det) in x and sqrt(Q cxx / det) in y. The mask
// sets the bit of every strip with a pixel inside that box (and none if no
// column of the tile is inside it).
//
// Margin: the kernels decide in f32, so Q must hold every pair the f32
// test can let through. With u = 2^-24:
// - alpha's product and the comparison cost a factor (1 - u), expf at
//   most 2 ulp: the f32 test passes only if the computed quad is at most
//   q_max + 2 (u + 2^-22) < q_max + 6.5e-7. kMarginQAbs = 1e-5 in q.
// - the computed quad (four roundings, no FMA, the JAX order) is within
//   4u / (1 - 4u) S of the exact form at the computed offsets, where
//   S = |cxx| dx^2 + 2 |cxy| |dx dy| + |cyy| dy^2 <= (lambda_max /
//   lambda_min) q <= (tr^2 / det) q. So the exact q there is at most
//   (q_max + 6.5e-7) / (1 - 2.4e-7 tr^2 / det); kMarginCond = 1e-6 per
//   unit of tr^2 / det, and an entry with 1e-6 tr^2 / det >= 0.5 (a conic
//   so near singular that the bound is loose) gets the full mask.
// - the computed offset px - pix_x is within u of the exact one, and the
//   footprint's own f32 arithmetic (det from exact products in double,
//   rounded once; then a division, logf, a product, a quotient and sqrtf,
//   each within 2 ulp; px - x0 and the box edges within u of the larger
//   operand, which is at most the half-extent + 17 where it matters) moves
//   each half-extent by under 1e-6 relative plus 1e-6 px. kMarginQScale =
//   1 + 1e-4 on Q (5e-5 on the half-extents) and kMarginPixels = 1e-3 px
//   on each half-extent cover it.
// Edge cases: opacity < opacity_min gives no bit (density <= 1 caps alpha
// at the opacity); a conic that is not positive definite, a det that is
// not a finite f32, or any value that is not finite gives the full mask,
// and every warp evaluates the entry as the kernels did before the skip.
// So a skipped pair is one whose f32 test fails: the skip changes no blend
// decision.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// GS_FOOTPRINT_SKIP=0 gives every entry the full mask: a build without
// the skip, which chip_smoke.py times beside the default build.
#ifndef GS_FOOTPRINT_SKIP
#define GS_FOOTPRINT_SKIP 1
#endif

namespace gs {

constexpr int kTile = 16;
constexpr int kPixels = kTile * kTile;
constexpr int kWarps = kPixels / 32;
constexpr int kRows = 9;  // r, g, b, cxx, cxy, cyy, opacity, px, py
constexpr uint32_t kFullMask = (1u << kWarps) - 1u;

constexpr float kMarginQAbs = 1e-5f;
constexpr float kMarginQScale = 1.0001f;
constexpr float kMarginCond = 1e-6f;
constexpr float kMarginPixels = 1e-3f;

// Bit w set: warp w of the tile whose top-left pixel is (x0, y0) may blend
// the entry; no bit: no pixel of the tile can. In f32 but for the
// determinant (ops/rasterize.py::footprint_warp_masks repeats it).
__device__ __forceinline__ uint32_t entry_warp_mask(
    float cxx, float cxy, float cyy, float opacity, float px, float py,
    int32_t x0, int32_t y0, float opacity_min) {
  if (opacity < opacity_min) return 0u;
  if (!(isfinite(cxx) && isfinite(cxy) && isfinite(cyy) && isfinite(opacity)
        && isfinite(px) && isfinite(py))) {
    return kFullMask;
  }
  const float det = (float)((double)cxx * cyy - (double)cxy * cxy);
  const float tr = cxx + cyy;
  const float cond = kMarginCond * (tr * tr / det);
  if (!(cxx > 0.0f && det > 0.0f && isfinite(det) && cond < 0.5f)) return kFullMask;
  const float q_max = 2.0f * logf(opacity / opacity_min);
  const float q = (q_max + kMarginQAbs) * kMarginQScale / (1.0f - cond);
  const float half_x = sqrtf(q * cyy / det) + kMarginPixels;
  const float half_y = sqrtf(q * cxx / det) + kMarginPixels;
  const float cx = px - (float)x0;
  const float cy = py - (float)y0;
  const float col_lo = fmaxf(ceilf(cx - half_x), 0.0f);
  const float col_hi = fminf(floorf(cx + half_x), (float)(kTile - 1));
  const float row_lo = fmaxf(ceilf(cy - half_y), 0.0f);
  const float row_hi = fminf(floorf(cy + half_y), (float)(kTile - 1));
  if (!(col_lo <= col_hi && row_lo <= row_hi)) return 0u;
  const int w_lo = (int)row_lo / 2;
  const int w_hi = (int)row_hi / 2;
  return ((2u << w_hi) - 1u) & ~((1u << w_lo) - 1u);
}

// --- row layouts ---------------------------------------------------------------
//
// The per-point rows (and kernel C's per-entry gradient rows) come in two
// layouts, told apart by their element type:
// - float: [9, stride] in the canonical order r, g, b, cxx, cxy, cyy,
//   opacity, px, py;
// - uint32_t: [6, stride] words [r|g, b|opacity, cxx|cxy, cyy|0, bits(px),
//   bits(py)], two bf16 values to a word, the first in the high half
//   (ops/blend.py::pack_rows, gausplat_tpu/ops/blend.py:105-147).
// Decoding is exact: a bf16 in a high half is the f32 with those bits.
// Encoding rounds half up on the bit pattern, in uint32_t so that the
// wrap JAX's int32 add makes (a NaN with payload >= 0x7FFF8000 becomes
// -0.0, +-FLT_MAX becomes +-inf) is defined here too.

constexpr int kPackedRows = 6;

__device__ __forceinline__ float unpack_hi(uint32_t w) { return __uint_as_float(w & 0xFFFF0000u); }
__device__ __forceinline__ float unpack_lo(uint32_t w) { return __uint_as_float(w << 16); }

__device__ __forceinline__ uint32_t round_bf16_bits(float x) {
  return (__float_as_uint(x) + 0x8000u) & 0xFFFF0000u;
}

__device__ __forceinline__ uint32_t pack_pair(float hi, float lo) {
  return round_bf16_bits(hi) | (round_bf16_bits(lo) >> 16);
}

// Point `pid`'s nine floats from rows of either layout.
__device__ __forceinline__ void load_entry(const float* __restrict__ rows, int64_t stride,
                                           int32_t pid, float (&v)[kRows]) {
#pragma unroll
  for (int k = 0; k < kRows; ++k) v[k] = rows[k * stride + pid];
}

__device__ __forceinline__ void load_entry(const uint32_t* __restrict__ rows, int64_t stride,
                                           int32_t pid, float (&v)[kRows]) {
  uint32_t w[kPackedRows];
#pragma unroll
  for (int k = 0; k < kPackedRows; ++k) w[k] = rows[k * stride + pid];
  v[0] = unpack_hi(w[0]);
  v[1] = unpack_lo(w[0]);
  v[2] = unpack_hi(w[1]);
  v[6] = unpack_lo(w[1]);
  v[3] = unpack_hi(w[2]);
  v[4] = unpack_lo(w[2]);
  v[5] = unpack_hi(w[3]);
  v[7] = __uint_as_float(w[4]);
  v[8] = __uint_as_float(w[5]);
}

// Entry `e`'s nine gradient values (canonical order) into rows of either
// layout ([9 or 6, capacity]).
__device__ __forceinline__ void store_entry(float* __restrict__ rows, int64_t capacity,
                                            int64_t e, const float (&v)[kRows]) {
#pragma unroll
  for (int k = 0; k < kRows; ++k) rows[k * capacity + e] = v[k];
}

__device__ __forceinline__ void store_entry(uint32_t* __restrict__ rows, int64_t capacity,
                                            int64_t e, const float (&v)[kRows]) {
  rows[0 * capacity + e] = pack_pair(v[0], v[1]);
  rows[1 * capacity + e] = pack_pair(v[2], v[6]);
  rows[2 * capacity + e] = pack_pair(v[3], v[4]);
  rows[3 * capacity + e] = pack_pair(v[5], 0.0f);
  rows[4 * capacity + e] = __float_as_uint(v[7]);
  rows[5 * capacity + e] = __float_as_uint(v[8]);
}

// --- staging -----------------------------------------------------------------

// Thread `slot`'s part of staging a batch: gather point `pid`'s nine floats
// from rows of either layout (decoded, for packed rows) into column `slot`
// of `staged` ([9][kBatch]), and return the entry's warp mask in the tile
// at (x0, y0), from the staged values: those are what the blend test sees.
template <int kBatch, typename Row>
__device__ __forceinline__ uint32_t stage_entry(float (*staged)[kBatch], int slot,
                                                const Row* __restrict__ point_rows,
                                                int64_t row_stride, int32_t pid, int32_t x0,
                                                int32_t y0, float opacity_min) {
  float v[kRows];
  load_entry(point_rows, row_stride, pid, v);
#pragma unroll
  for (int k = 0; k < kRows; ++k) staged[k][slot] = v[k];
  if (!GS_FOOTPRINT_SKIP) return kFullMask;
  return entry_warp_mask(v[3], v[4], v[5], v[6], v[7], v[8], x0, y0, opacity_min);
}

// --- launch facts --------------------------------------------------------------

// Registers per thread and static shared memory per CTA of `kernel` (the
// numbers ptxas reports), and its resident CTAs per SM at 256 threads with
// no dynamic shared memory (what both rasterize launches pass). Backs each
// library's gs_kernel_info (f32 rows) and gs_kernel_info_packed.
template <typename Kernel>
inline int kernel_info(Kernel* kernel, int32_t* registers, int32_t* shared_bytes,
                       int32_t* blocks_per_sm) {
  cudaFuncAttributes attributes;
  cudaError_t err = cudaFuncGetAttributes(&attributes, kernel);
  if (err != cudaSuccess) return (int)err;
  *registers = attributes.numRegs;
  *shared_bytes = (int32_t)attributes.sharedSizeBytes;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kPixels, 0);
  *blocks_per_sm = blocks;
  return (int)err;
}

}  // namespace gs
