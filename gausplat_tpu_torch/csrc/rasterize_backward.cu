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
// Output: rows at the sorted positions in the layout of the input rows
// (tile_batch.cuh): f32 [9, capacity] (gs_rasterize_backward), or packed
// words [6, capacity] (gs_rasterize_backward_packed, the layout of
// gausplat_tpu/ops/blend.py::grads_to_rows(..., packed=True)): pack_pair(s0,
// s1), pack_pair(s2, s6), pack_pair(0.5 s3, s4), pack_pair(0.5 s5, 0) and the
// position gradients' f32 bits, the f32 sums rounded half up on the bit
// pattern. The packed kernel stages decoded values (exactly), so the sums
// are those of the f32 kernel on the decoded rows. Every slot of a tile's
// range is written (zeros past the tile's largest count); no other slot is.
//
// What bounds it on this card: operations. At the 1080p / 1M-point bench
// shape about 1.76M entries x 256 pixels = 450M (entry, pixel) pairs lie in
// the tile ranges, of which the pixels' forward counts keep a part; each
// kept pair costs some 45 f32 operations (the density terms again, the
// replay, nine products and nine sums), against some 150 MB of traffic
// (per-point rows and ids, the grad / <g, C> / count tiles, the [9, cap]
// output). Most of the pairs in range cannot blend: the design spends the
// operations on the pairs that can.
//
// Design: one 256-thread CTA per tile, thread = ly * 16 + lx, as the
// forward kernel, walking its range in batches of kBatch (64) entries.
// - Staging: thread j gathers entry j's nine floats into shared memory and
//   computes its warp mask from them (tile_batch.cuh::entry_warp_mask,
//   shared with the forward kernel): the tile's 16x2 warp strips that its
//   alpha >= 1/255 ellipse can reach.
// - Footprint skip: each warp walks only the entries whose bit it holds (a
//   ballot per 32 entries, then the set bits in order) and below its own
//   largest count; a skipped entry costs the warp nothing (no expf, no
//   vote, no shuffle). A skipped pair cannot blend, so T and P do not
//   change and it adds 0.
// - Reduction: a warp in which some lane blends entry j sums its 32 lanes
//   in 14 shuffles (warp_sum_rows: a transposing reduce-scatter of rows
//   0-7, a butterfly for row 8) instead of 9 x 5; lane 4r then holds row r
//   and writes partial[warp][r][j], lane 0 also row 8, and sets the warp's
//   bit in contrib[j] (an integer atomicOr in shared memory). After the
//   batch thread j adds the partials of the warps in contrib[j], in warp
//   order, and writes column base + j. No float atomics; the order is
//   fixed, so a launch is deterministic.
// - Occupancy over batch size: partials 8 x 9 x 64 x 4 = 18,432 bytes and
//   the staged batch 2,304, static, and __launch_bounds__(256, 6) (40
//   registers): six CTAs per SM. Once the skip leaves warps uneven work,
//   resident CTAs pay better than fewer barriers: 256 entries in 94 KB of
//   dynamic shared memory (two CTAs per SM), 128 entries (four), and
//   double-buffered cp.async staging were each measured slower (PERF.md,
//   Findings).
// - The CTA stops replaying once the batch passes the tile's largest
//   forward count (the JAX window skip at rasterize.py:525-529) and writes
//   zeros for the rest of its range.
//
// Rounding: built without fast math and with -fmad=false, and the density
// terms keep the JAX evaluation order, as the forward kernel does, so the
// replay takes the same blend decisions as the forward.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_batch.cuh"

namespace {

using namespace gs;

constexpr int kBatch = 64;     // entries per batch
constexpr int kMinBlocks = 6;  // resident CTAs per SM: at most 40 registers
constexpr uint32_t kAllLanes = 0xffffffffu;

// Sum v[0..8] over the warp's 32 lanes. Rows 0-7 reduce as a transpose:
// at each of three steps a lane keeps half of its rows and adds its
// partner's copy of them (4 + 2 + 1 shuffles), which leaves lane L with
// row 4 (L >> 4 & 1) + 2 (L >> 3 & 1) + (L >> 2 & 1) summed over the 8
// lanes that share L's two low bits; two butterfly steps finish the sum,
// so lane 4r holds row r. Row 8 takes a plain butterfly and ends in every
// lane. The order of the additions is fixed.
__device__ __forceinline__ float warp_sum_rows(const float (&v)[kRows], int lane, float& row8) {
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
  float u[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float give = b4 ? v[i] : v[i + 4];
    u[i] = (b4 ? v[i + 4] : v[i]) + __shfl_xor_sync(kAllLanes, give, 16);
  }
  float w[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float give = b3 ? u[i] : u[i + 2];
    w[i] = (b3 ? u[i + 2] : u[i]) + __shfl_xor_sync(kAllLanes, give, 8);
  }
  const float give = b2 ? w[0] : w[1];
  float x = (b2 ? w[1] : w[0]) + __shfl_xor_sync(kAllLanes, give, 4);
  x += __shfl_xor_sync(kAllLanes, x, 2);
  x += __shfl_xor_sync(kAllLanes, x, 1);
  float y = v[8];
#pragma unroll
  for (int off = 16; off > 0; off /= 2) y += __shfl_xor_sync(kAllLanes, y, off);
  row8 = y;
  return x;
}

template <typename Row>
__global__ void __launch_bounds__(kPixels, kMinBlocks) rasterize_backward_kernel(
    const Row* __restrict__ point_rows,  // [9 or 6, row_stride]
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
    Row* __restrict__ out) {  // [9 or 6, capacity]
  __shared__ float staged[kRows][kBatch];
  __shared__ float partial[kWarps][kRows][kBatch];
  __shared__ uint32_t contrib[kBatch];  // bit w: warp w blended the entry
  __shared__ uint8_t mask[kBatch];      // bit w: warp w walks the entry
  __shared__ int32_t max_count;

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
  const int64_t pixel = (int64_t)tile * kPixels + tid;
  const float gr = grad_tiles[((int64_t)tile * 3 + 0) * kPixels + tid];
  const float gg = grad_tiles[((int64_t)tile * 3 + 1) * kPixels + tid];
  const float gb = grad_tiles[((int64_t)tile * 3 + 2) * kPixels + tid];
  const float gdotc = gdotc_tiles[pixel];
  const int32_t count = count_tiles[pixel];
  const int32_t warp_count = __reduce_max_sync(kAllLanes, count);

  if (tid == 0) max_count = 0;
  __syncthreads();
  if (lane == 0) atomicMax(&max_count, warp_count);
  __syncthreads();
  // Entries at or past `end` are blended by no pixel of the tile.
  const int32_t end = min(r1, r0 + max_count);

  float t = 1.0f;       // transmittance before the next entry
  float prefix = 0.0f;  // <g, colour blended so far>

  int32_t base = r0;
  for (; base < end; base += kBatch) {
    // The last batch's walk ended at a barrier, and its write-back reads
    // only this thread's own column.
    if (tid < kBatch) {
      const int32_t e = base + tid;
      mask[tid] = e < end ? (uint8_t)stage_entry<kBatch>(staged, tid, point_rows, row_stride,
                                                         sorted_ids[e], x0, y0, opacity_min)
                          : (uint8_t)0;
      contrib[tid] = 0u;
    }
    __syncthreads();

    // This warp's entries of the batch: footprint bit set, below its count.
    const int warp_end = min(min(kBatch, end - base), warp_count - (base - r0));
    for (int word = 0; word * 32 < warp_end; ++word) {
      const int jj = word * 32 + lane;
      uint32_t bits = __ballot_sync(kAllLanes, jj < warp_end && ((mask[jj] >> warp) & 1u));
      while (bits) {
        const int j = word * 32 + __ffs(bits) - 1;
        bits &= bits - 1u;
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
        if (__any_sync(kAllLanes, blended)) {
          float row8;
          const float x = warp_sum_rows(v, lane, row8);
          if ((lane & 3) == 0) partial[warp][lane >> 2][j] = x;
          if (lane == 0) {
            partial[warp][8][j] = row8;
            atomicOr(&contrib[j], 1u << warp);
          }
        }
      }
    }
    __syncthreads();  // every partial and contrib bit of the batch is written

    const int n = min(kBatch, r1 - base);
    if (tid < n) {
      const uint32_t m = contrib[tid];
      float s[kRows];
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        float acc = 0.0f;
        for (int w = 0; w < kWarps; ++w) {
          if ((m >> w) & 1u) acc += partial[w][k][tid];
        }
        s[k] = acc;
      }
      // No contribution: zero position gradients, whatever the conic (it
      // may not be finite).
      const float g[kRows] = {
          s[0], s[1], s[2], 0.5f * s[3], s[4], 0.5f * s[5], s[6],
          m ? staged[3][tid] * s[7] + staged[4][tid] * s[8] : 0.0f,
          m ? staged[4][tid] * s[7] + staged[5][tid] * s[8] : 0.0f};
      store_entry(out, capacity, (int64_t)base + tid, g);
    }
  }

  // Entries past every pixel's count were blended by no pixel.
  const float zeros[kRows] = {};
  for (int64_t e = (int64_t)base + tid; e < r1; e += kPixels) store_entry(out, capacity, e, zeros);
}

template <typename Row>
int launch(const void* point_rows, int64_t row_stride, const void* sorted_ids,
           const void* tile_ranges, int32_t num_tiles, int32_t tile_count_x,
           const void* grad_tiles, const void* gdotc_tiles, const void* count_tiles,
           float opacity_max, float opacity_min, int64_t capacity, void* out, void* stream) {
  if (num_tiles > 0) {
    rasterize_backward_kernel<Row><<<num_tiles, kPixels, 0, (cudaStream_t)stream>>>(
        (const Row*)point_rows, row_stride, (const int32_t*)sorted_ids,
        (const int32_t*)tile_ranges, tile_count_x, (const float*)grad_tiles,
        (const float*)gdotc_tiles, (const int32_t*)count_tiles, opacity_max,
        opacity_min, capacity, (Row*)out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// f32 rows [9, row_stride] in, f32 rows [9, capacity] out.
extern "C" int gs_rasterize_backward(
    const void* point_rows, int64_t row_stride, const void* sorted_ids,
    const void* tile_ranges, int32_t num_tiles, int32_t tile_count_x,
    const void* grad_tiles, const void* gdotc_tiles, const void* count_tiles,
    float opacity_max, float opacity_min, int64_t capacity, void* out,
    void* stream) {
  return launch<float>(point_rows, row_stride, sorted_ids, tile_ranges, num_tiles,
                       tile_count_x, grad_tiles, gdotc_tiles, count_tiles, opacity_max,
                       opacity_min, capacity, out, stream);
}

// Packed rows [6, row_stride] in, packed rows [6, capacity] out (int32 words).
extern "C" int gs_rasterize_backward_packed(
    const void* point_rows, int64_t row_stride, const void* sorted_ids,
    const void* tile_ranges, int32_t num_tiles, int32_t tile_count_x,
    const void* grad_tiles, const void* gdotc_tiles, const void* count_tiles,
    float opacity_max, float opacity_min, int64_t capacity, void* out,
    void* stream) {
  return launch<uint32_t>(point_rows, row_stride, sorted_ids, tile_ranges, num_tiles,
                          tile_count_x, grad_tiles, gdotc_tiles, count_tiles, opacity_max,
                          opacity_min, capacity, out, stream);
}

// Launch facts for a report (tile_batch.cuh::kernel_info), per layout.
extern "C" int gs_kernel_info(int32_t* registers, int32_t* shared_bytes,
                              int32_t* blocks_per_sm) {
  return gs::kernel_info(rasterize_backward_kernel<float>, registers, shared_bytes,
                         blocks_per_sm);
}

extern "C" int gs_kernel_info_packed(int32_t* registers, int32_t* shared_bytes,
                                     int32_t* blocks_per_sm) {
  return gs::kernel_info(rasterize_backward_kernel<uint32_t>, registers, shared_bytes,
                         blocks_per_sm);
}

extern "C" const char* gs_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
