// Host 3DGS PLY payload codec with a plain C interface (no Python.h).
//
// The payload shuffle between the on-disk interleaved 62-float vertex
// layout (reference import.rs:15-89 and export.rs:11-71) and the five
// scene arrays, in one multithreaded pass per direction:
//
//   colors_sh [P,48]  (f_dc + f_rest with channel-major -> coeff-major
//                      transpose), opacities [P,1], positions [P,3],
//   rotations [P,4]   (disk scalar-first wxyz -> array scalar-last xyzw),
//   scalings  [P,3]
//
// Built at first use with the host C++ compiler and loaded with ctypes by
// gausplat_tpu_torch/utils/native.py. Each entry point takes the element
// count of every buffer and returns 0, or 1 when a buffer is too small for
// `point_count` points (nothing is written then).

#include <cstdint>
#include <thread>
#include <vector>

namespace {

constexpr int64_t kProps = 62;
constexpr int kShRest = 15;  // higher-order SH coefficients per channel
constexpr int64_t kWidths[5] = {48, 1, 3, 4, 3};

// Decode one vertex: interleaved 62 floats -> the five array rows.
inline void decode_vertex(const float* v, float* colors_sh, float* opacities,
                          float* positions, float* rotations, float* scalings) {
  positions[0] = v[0];
  positions[1] = v[1];
  positions[2] = v[2];
  // v[3..6) are unused normals.
  colors_sh[0] = v[6];
  colors_sh[1] = v[7];
  colors_sh[2] = v[8];
  // f_rest on disk is channel-major [3][15]; the array is coeff-major [15][3].
  const float* rest = v + 9;
  for (int m = 0; m < kShRest; ++m) {
    colors_sh[3 + m * 3 + 0] = rest[0 * kShRest + m];
    colors_sh[3 + m * 3 + 1] = rest[1 * kShRest + m];
    colors_sh[3 + m * 3 + 2] = rest[2 * kShRest + m];
  }
  opacities[0] = v[54];
  scalings[0] = v[55];
  scalings[1] = v[56];
  scalings[2] = v[57];
  // Disk is scalar-first (w, x, y, z); the array is scalar-last (x, y, z, w).
  rotations[0] = v[59];
  rotations[1] = v[60];
  rotations[2] = v[61];
  rotations[3] = v[58];
}

inline void encode_vertex(float* v, const float* colors_sh,
                          const float* opacities, const float* positions,
                          const float* rotations, const float* scalings) {
  v[0] = positions[0];
  v[1] = positions[1];
  v[2] = positions[2];
  v[3] = v[4] = v[5] = 0.0f;  // normals are unused
  v[6] = colors_sh[0];
  v[7] = colors_sh[1];
  v[8] = colors_sh[2];
  float* rest = v + 9;
  for (int m = 0; m < kShRest; ++m) {
    rest[0 * kShRest + m] = colors_sh[3 + m * 3 + 0];
    rest[1 * kShRest + m] = colors_sh[3 + m * 3 + 1];
    rest[2 * kShRest + m] = colors_sh[3 + m * 3 + 2];
  }
  v[54] = opacities[0];
  v[55] = scalings[0];
  v[56] = scalings[1];
  v[57] = scalings[2];
  v[58] = rotations[3];
  v[59] = rotations[0];
  v[60] = rotations[1];
  v[61] = rotations[2];
}

template <typename Fn>
void parallel_for(int64_t count, Fn fn) {
  unsigned hw = std::thread::hardware_concurrency();
  int64_t n_threads = hw ? hw : 4;
  if (count < 1 << 14) n_threads = 1;
  if (n_threads > count) n_threads = count > 0 ? count : 1;
  std::vector<std::thread> threads;
  int64_t chunk = (count + n_threads - 1) / n_threads;
  for (int64_t t = 0; t < n_threads; ++t) {
    int64_t begin = t * chunk;
    int64_t end = begin + chunk < count ? begin + chunk : count;
    if (begin >= end) break;
    threads.emplace_back([=] { fn(begin, end); });
  }
  for (auto& th : threads) th.join();
}

// Whether the payload (`payload_len` floats) and the five arrays
// (`lens[i]` floats each) hold `point_count` points.
bool sizes_match(int64_t point_count, int64_t payload_len, const int64_t* lens) {
  if (point_count < 0 || payload_len < point_count * kProps) return false;
  for (int i = 0; i < 5; ++i) {
    if (lens[i] < point_count * kWidths[i]) return false;
  }
  return true;
}

}  // namespace

extern "C" {

// Deinterleave a 3DGS PLY payload into the five arrays.
int gs_ply_decode(const float* payload, int64_t payload_len, int64_t point_count,
                  float* colors_sh, float* opacities, float* positions,
                  float* rotations, float* scalings, const int64_t* lens) {
  if (!sizes_match(point_count, payload_len, lens)) return 1;
  parallel_for(point_count, [&](int64_t begin, int64_t end) {
    for (int64_t p = begin; p < end; ++p) {
      decode_vertex(payload + p * kProps, colors_sh + p * 48, opacities + p,
                    positions + p * 3, rotations + p * 4, scalings + p * 3);
    }
  });
  return 0;
}

// Interleave the five arrays into a 3DGS PLY payload.
int gs_ply_encode(const float* colors_sh, const float* opacities,
                  const float* positions, const float* rotations,
                  const float* scalings, const int64_t* lens, int64_t point_count,
                  float* payload, int64_t payload_len) {
  if (!sizes_match(point_count, payload_len, lens)) return 1;
  parallel_for(point_count, [&](int64_t begin, int64_t end) {
    for (int64_t p = begin; p < end; ++p) {
      encode_vertex(payload + p * kProps, colors_sh + p * 48, opacities + p,
                    positions + p * 3, rotations + p * 4, scalings + p * 3);
    }
  });
  return 0;
}

}  // extern "C"
