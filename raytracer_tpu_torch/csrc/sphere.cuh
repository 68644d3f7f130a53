// Device helpers shared by the Whitted kernels (whitted_trace.cu,
// nearest_hit.cu): the sphere table as they stage it, NaN-propagating
// clamps, normalisation, and the nearest-sphere sweep of
// raytracer_tpu/core/intersect.py::nearest_hit_c with the same results bit
// for bit.
//
// Rounding: every file is built with -fmad=false (core/native.py), so each
// multiply and add rounds on its own, as the plain PyTorch version's
// separate operations do; sqrtf and '/' are IEEE (no fast math).
//
// The sweep does only the work its outputs need, by the argument of
// csrc/path_common.cuh::sweep: the plain version takes sqrt(d2) <= r
// (exact) and thc = sqrt(r*r - d2) for every sphere; here the exact inside
// test is d2 <= T(r), T(r) the largest float whose sqrtf is <= r
// (core/intersect.py::inside_threshold, staged in column 7 of the table),
// which holds exactly when sqrt(d2) <= r since sqrt is correctly rounded
// and monotone, for every d2 >= 0, +inf and NaN; d2 is computed only where
// tca >= 0, and thc, t and the metric only for a valid sphere, the only
// places where they can change an output.

#pragma once

#include <cuda_runtime.h>

#include <cfloat>
#include <climits>

namespace sphere {

// Row of the table in device memory (core/cuda_intersect.py::
// SphereTable.spheres): cx cy cz r ior mirror glass T(r) (32 bytes).
constexpr int kRow = 8;
constexpr int kNoSuppress = INT_MIN;   // core/intersect.py NO_SUPPRESS
// Shared memory a sphere takes once staged (Table).
constexpr int kStagedBytes = 2 * sizeof(float4) + sizeof(int);

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

// The table in shared memory, each sphere's words where the sweep reads
// them together: centre[s] = (cx, cy, cz, the inside test's threshold on
// d2: T(r) exact, r*r fast), one 16-byte broadcast a sphere test;
// attr[s] = (r*r, ior, mirror, glass) and id[s], read for a sphere that
// passes the inside test and by the Whitted kernel at a hit.
struct Table {
  float4* centre;
  float4* attr;
  int* id;
};

// The table's arrays in n spheres' worth of dynamic shared memory
// (n * kStagedBytes).
__device__ __forceinline__ Table carve(float4* smem, int n) {
  return Table{smem, smem + n, reinterpret_cast<int*>(smem + 2 * n)};
}

// Stages the table; every thread of the block takes part, so call it
// before any thread leaves.  r*r rounds as the plain version's r * r does
// (an exact product rounded once to float32).
__device__ __forceinline__ void stage(const Table& tb,
                                      const float* __restrict__ spheres,
                                      const int* __restrict__ ids, int n,
                                      bool fast) {
  for (int s = threadIdx.x; s < n; s += blockDim.x) {
    const float* row = spheres + s * kRow;
    const float r = row[3];
    const float rr = r * r;
    tb.centre[s] = make_float4(row[0], row[1], row[2], fast ? rr : row[7]);
    tb.attr[s] = make_float4(rr, row[4], row[5], row[6]);
    tb.id[s] = ids[s];
  }
  __syncthreads();
}

struct Hit {
  float m;     // the nearest hit's metric (t or |t|; FLT_MAX: none yet)
  float t;     // FLT_MAX where nothing was hit
  int idx;     // 0 where nothing was hit
  bool found;  // some sphere passed the hit test (even with a NaN metric)
};

__device__ __forceinline__ Hit miss() {
  return Hit{FLT_MAX, FLT_MAX, 0, false};
}

// Sphere s (its centre row c = tb.centre[s]) against one unit-direction
// ray: the near root t = tca - thc, ordered by signed t or by |t|; the
// strict '<' keeps the first minimum, as argmin does, so the spheres must
// be taken in order.  The operations it needs: 9 a test (l, tca and its
// test), 9 more where tca >= 0 (d2 and its test), 7 more for a valid
// sphere (thc, t, the metric and the nearest test), where the plain version
// computes all 26 for every test; chip_smoke.py counts them on each run's
// data (core/cuda_intersect.py::sweep_work).  front
// takes the first 8 and finish the rest, for a ray with tca >= 0 (false
// for NaN), so that a kernel with several rays a thread can branch once
// for all of them.
struct Front {
  float lx, ly, lz, tca;
};

__device__ __forceinline__ Front front(float4 c, float ox, float oy,
                                       float oz, float dx, float dy,
                                       float dz) {
  const float lx = c.x - ox, ly = c.y - oy, lz = c.z - oz;
  return Front{lx, ly, lz, lx * dx + ly * dy + lz * dz};
}

__device__ __forceinline__ void finish(Hit& h, const Table& tb, int s,
                                       float4 c, const Front& f, int sup,
                                       bool by_abs) {
  const float d2 = max_nan(f.lx * f.lx + f.ly * f.ly + f.lz * f.lz -
                               f.tca * f.tca,
                           0.0f);
  if (!(d2 <= c.w) || tb.id[s] == sup) return;
  const float t = f.tca - sqrtf(max_nan(tb.attr[s].x - d2, 0.0f));
  const float m = by_abs ? fabsf(t) : t;
  if (m < h.m) {
    h.m = m;
    h.t = t;
    h.idx = s;
  }
  h.found = true;
}

__device__ __forceinline__ void test(Hit& h, const Table& tb, int s,
                                     float4 c, float ox, float oy, float oz,
                                     float dx, float dy, float dz, int sup,
                                     bool by_abs) {
  const Front f = front(c, ox, oy, oz, dx, dy, dz);
  if (f.tca >= 0.0f) finish(h, tb, s, c, f, sup, by_abs);
}

// The nearest non-suppressed hit of one ray over the n staged spheres.
__device__ __forceinline__ Hit sweep(const Table& tb, int n, float ox,
                                     float oy, float oz, float dx, float dy,
                                     float dz, int sup, bool by_abs) {
  Hit h = miss();
  for (int s = 0; s < n; ++s)
    test(h, tb, s, tb.centre[s], ox, oy, oz, dx, dy, dz, sup, by_abs);
  return h;
}

}  // namespace sphere
