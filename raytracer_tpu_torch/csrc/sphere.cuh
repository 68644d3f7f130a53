// Device helpers shared by the Whitted kernels (whitted_trace.cu,
// nearest_hit.cu): the sphere table's layout, NaN-propagating clamps,
// normalisation, and the nearest-sphere sweep of
// raytracer_tpu/core/intersect.py::nearest_hit_c, op for op.
//
// Rounding: every file is built with -fmad=false (core/native.py), so each
// multiply and add rounds on its own, as the plain PyTorch version's
// separate operations do; sqrtf and '/' are IEEE (no fast math).

#pragma once

#include <cuda_runtime.h>

#include <cfloat>
#include <climits>

namespace sphere {

// Row of the table (core/cuda_intersect.py::SphereTable.spheres):
// cx cy cz r ior mirror glass pad (32 bytes).
constexpr int kRow = 8;
constexpr int kNoSuppress = INT_MIN;   // core/intersect.py NO_SUPPRESS

__device__ __forceinline__ float max_nan(float a, float b) {
  // torch.clamp_min(a, b) with a constant b: NaN in a propagates.
  return (a != a) ? a : fmaxf(a, b);
}

__device__ __forceinline__ float clamp_nan(float x, float lo, float hi) {
  // torch.clamp(x, lo, hi): NaN propagates.
  return (x != x) ? x : fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ void normalise3(float& x, float& y, float& z) {
  const float m = max_nan(sqrtf(x * x + y * y + z * z),
                          static_cast<float>(1e-20));
  x = x / m;
  y = y / m;
  z = z / m;
}

// Copies the table (n rows and ids) into shared memory; every thread of the
// block takes part, so call it before any thread returns.
__device__ __forceinline__ void stage(const float* __restrict__ spheres,
                                      const int* __restrict__ ids, int n,
                                      float* s_sph, int* s_ids) {
  for (int k = threadIdx.x; k < n * kRow; k += blockDim.x)
    s_sph[k] = spheres[k];
  for (int k = threadIdx.x; k < n; k += blockDim.x) s_ids[k] = ids[k];
  __syncthreads();
}

struct Hit {
  float t;     // FLT_MAX where nothing was hit
  int idx;     // 0 where nothing was hit
  bool found;  // some sphere passed the hit test (even with a NaN metric)
};

// Nearest non-suppressed hit along a unit direction: the near root
// t = tca - thc, ordered by signed t or by |t|; the strict '<' keeps the
// first minimum.  About 26 f32 operations a sphere (27 with by_abs; one
// fewer with fast).
__device__ __forceinline__ Hit sweep(const float* s_sph, const int* s_ids,
                                     int n, float ox, float oy, float oz,
                                     float dx, float dy, float dz, int sup,
                                     bool by_abs, bool fast) {
  float best_m = FLT_MAX;
  Hit h{FLT_MAX, 0, false};
  for (int s = 0; s < n; ++s) {
    const float* sp = s_sph + s * kRow;
    const float r = sp[3];
    const float lx = sp[0] - ox, ly = sp[1] - oy, lz = sp[2] - oz;
    const float tca = lx * dx + ly * dy + lz * dz;
    const float d2 = max_nan(lx * lx + ly * ly + lz * lz - tca * tca, 0.0f);
    const float rr = r * r;
    const float thc = sqrtf(max_nan(rr - d2, 0.0f));
    const float t = tca - thc;
    const bool inside = fast ? (d2 <= rr) : (sqrtf(d2) <= r);
    const bool valid = (tca >= 0.0f) && inside && s_ids[s] != sup;
    const float m = by_abs ? fabsf(t) : t;
    if (valid && m < best_m) {
      best_m = m;
      h.t = t;
      h.idx = s;
    }
    h.found = h.found || valid;
  }
  return h;
}

}  // namespace sphere
