// Nearest-hit kernel for Hopper (sm_90a): four rays a thread.
//
// Replaces raytracer_tpu/core/pallas_intersect.py::_kernel (reached through
// nearest_hit_pallas): for each ray, the nearest non-suppressed sphere hit
// of raytracer_tpu/core/intersect.py::nearest_hit_c, by signed t or by |t|,
// with the exact sqrt(d2) <= r test or the fast d2 <= r*r test.  It writes
// t, idx and found; the point and normal are computed outside, as
// nearest_hit_pallas computes them.  The plain PyTorch version is
// core/cuda_intersect.py::nearest_hit_plain.
//
// What bounds it on an H100: per ray it reads the origin, the direction and
// the suppressed id (28 bytes; 24 with none) and writes t, idx and found (9
// bytes); its sweep needs 9 f32 operations a sphere test, 9 more in front
// of the ray and 7 more for a valid sphere (csrc/sphere.cuh::test).  Both
// shapes chip_smoke.py times are bytes-bound by that count: planets2's
// shadow sweep (10 spheres, 75% of tests in front) and the stepwise path
// level's sweep of the chandelier's 29 spheres (10% in front), whose
// operations come within 8% of its bytes.  The parent design (one ray a
// thread, the table staged by every 128-ray block before its rays were
// read, six strided scalar loads a ray, two IEEE square roots a sphere)
// took 2.4x its bound on the shadow sweep and 6.9x on the level's.
//
// Design for that bound: the sweep of sphere.cuh, without the square roots
// that cannot change an output (the largest gain: tools/sweep_variants.py's
// two_sqrt variant); four rays a thread, so each sphere's staged row is one
// 16-byte shared-memory broadcast for four ray tests, the thread branches
// once a sphere for its four rays when none is in front (most tests of the
// level's sweep), and its rays are 48 contiguous bytes of origins and of
// directions, read as three 16-byte loads each (the suppressed ids as one,
// t and idx written as one each, found as one 32-bit store); 128-thread
// blocks of 512 rays.  The rays' loads are issued before the table is
// staged, so their latency overlaps the staging and its barrier (at 512-ray
// blocks the stage_first variant measures the same).  A thread
// whose rays run past the end, or pointers not 16-byte aligned, take
// scalar loads and stores; rays past the end are NaN and are rejected at
// their first test.  tools/sweep_variants.py times the other shapes and
// orders.

#include <cstdint>

#include "sphere.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kRays = 4;                  // rays a thread
constexpr int kBlockRays = kThreads * kRays;

// A float's or an int's 32 bits, and back.
__device__ __forceinline__ uint32_t word(float x) {
  return __float_as_uint(x);
}
__device__ __forceinline__ uint32_t word(int x) {
  return static_cast<uint32_t>(x);
}
__device__ __forceinline__ void unword(uint32_t w, float& x) {
  x = __uint_as_float(w);
}
__device__ __forceinline__ void unword(uint32_t w, int& x) {
  x = static_cast<int>(w);
}

// N consecutive 32-bit words of p into v: 16 bytes at a time where whole
// (p then 16-byte aligned), else one at a time, with `fill` past `valid`.
template <typename T, int N>
__device__ __forceinline__ void load(const T* __restrict__ p, bool whole,
                                     int valid, T fill, T (&v)[N]) {
  if constexpr (N % 4 == 0) {
    if (whole) {
#pragma unroll
      for (int j = 0; j < N / 4; ++j) {
        const uint4 q = __ldg(reinterpret_cast<const uint4*>(p) + j);
        unword(q.x, v[4 * j]);
        unword(q.y, v[4 * j + 1]);
        unword(q.z, v[4 * j + 2]);
        unword(q.w, v[4 * j + 3]);
      }
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < N; ++j) v[j] = j < valid ? __ldg(p + j) : fill;
}

// N 32-bit words of v to p, as load reads them (only the first `valid`).
template <typename T, int N>
__device__ __forceinline__ void store(T* __restrict__ p, bool whole,
                                      int valid, const T (&v)[N]) {
  if constexpr (N % 4 == 0) {
    if (whole) {
#pragma unroll
      for (int j = 0; j < N / 4; ++j)
        reinterpret_cast<uint4*>(p)[j] =
            make_uint4(word(v[4 * j]), word(v[4 * j + 1]),
                       word(v[4 * j + 2]), word(v[4 * j + 3]));
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < N; ++j)
    if (j < valid) p[j] = v[j];
}

__global__ void __launch_bounds__(kThreads)
nearest_hit_kernel(const float* __restrict__ origins,
                   const float* __restrict__ dirs,
                   const int* __restrict__ suppress,
                   const float* __restrict__ spheres,
                   const int* __restrict__ ids, int n_spheres,
                   long long n_rays, int by_abs, int fast, int aligned,
                   float* __restrict__ t_out, int* __restrict__ idx_out,
                   bool* __restrict__ found_out) {
  extern __shared__ float4 s_mem[];
  const sphere::Table tb = sphere::carve(s_mem, n_spheres);

  // This thread's rays, first: their loads are in flight while the table
  // is staged.  Rays past the end are NaN.
  const long long first =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * kRays;
  const long long left = n_rays - first;
  const int here = left >= kRays ? kRays
                                 : (left > 0 ? static_cast<int>(left) : 0);
  const bool whole = aligned != 0 && here == kRays;
  const float nan = __int_as_float(0x7fc00000);
  float o[3 * kRays], d[3 * kRays];
  int sup[kRays];
  load(origins + 3 * first, whole, 3 * here, nan, o);
  load(dirs + 3 * first, whole, 3 * here, nan, d);
  if (suppress != nullptr) {
    load(suppress + first, whole, here, sphere::kNoSuppress, sup);
  } else {
#pragma unroll
    for (int k = 0; k < kRays; ++k) sup[k] = sphere::kNoSuppress;
  }

  sphere::stage(tb, spheres, ids, n_spheres, fast != 0);
  if (here == 0) return;

  sphere::Hit h[kRays];
#pragma unroll
  for (int k = 0; k < kRays; ++k) h[k] = sphere::miss();
  for (int s = 0; s < n_spheres; ++s) {
    const float4 c = tb.centre[s];
    sphere::Front f[kRays];
    bool ahead = false;
#pragma unroll
    for (int k = 0; k < kRays; ++k) {
      f[k] = sphere::front(c, o[3 * k], o[3 * k + 1], o[3 * k + 2],
                           d[3 * k], d[3 * k + 1], d[3 * k + 2]);
      ahead |= f[k].tca >= 0.0f;
    }
    if (!ahead) continue;              // the common case: one branch
#pragma unroll
    for (int k = 0; k < kRays; ++k)
      if (f[k].tca >= 0.0f)
        sphere::finish(h[k], tb, s, c, f[k], sup[k], by_abs != 0);
  }

  float t[kRays];
  int idx[kRays];
#pragma unroll
  for (int k = 0; k < kRays; ++k) {
    t[k] = h[k].t;
    idx[k] = h[k].idx;
  }
  store(t_out + first, whole, here, t);
  store(idx_out + first, whole, here, idx);
  if (whole && kRays == 4) {
    uint32_t f = 0;
#pragma unroll
    for (int k = 0; k < kRays; ++k)
      f |= static_cast<uint32_t>(h[k].found) << (8 * k);
    *reinterpret_cast<uint32_t*>(found_out + first) = f;
  } else {
#pragma unroll
    for (int k = 0; k < kRays; ++k)
      if (k < here) found_out[first + k] = h[k].found;
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// Returns a cudaError_t: cudaErrorInvalidValue for arguments the kernel does
// not take, else cudaGetLastError() after the launch.
extern "C" int nearest_hit_launch(const float* origins, const float* dirs,
                                  const int* suppress, const float* spheres,
                                  const int* ids, int n_spheres,
                                  long long n_rays, int by_abs, int fast,
                                  float* t, int* idx, bool* found,
                                  void* stream) {
  const size_t smem = static_cast<size_t>(n_spheres) * sphere::kStagedBytes;
  if (n_spheres < 1 || smem > 48 * 1024 || n_rays < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rays == 0) return static_cast<int>(cudaSuccess);
  const long long blocks = (n_rays + kBlockRays - 1) / kBlockRays;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int aligned = aligned16(origins) && aligned16(dirs) &&
                      (suppress == nullptr || aligned16(suppress)) &&
                      aligned16(t) && aligned16(idx) &&
                      reinterpret_cast<uintptr_t>(found) % 4 == 0;
  nearest_hit_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      origins, dirs, suppress, spheres, ids, n_spheres, n_rays, by_abs, fast,
      aligned, t, idx, found);
  return static_cast<int>(cudaGetLastError());
}
