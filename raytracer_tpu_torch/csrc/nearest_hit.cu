// Nearest-hit kernel for Hopper (sm_90a): one thread per ray.
//
// Replaces raytracer_tpu/core/pallas_intersect.py::_kernel (reached through
// nearest_hit_pallas): for each ray, the nearest non-suppressed sphere hit
// of raytracer_tpu/core/intersect.py::nearest_hit_c, by signed t or by |t|,
// with the exact sqrt(d2) <= r test or the fast d2 <= r*r test.  It writes
// t, idx and found; the point and normal are computed outside, as
// nearest_hit_pallas computes them.  The plain PyTorch version is
// core/cuda_intersect.py::nearest_hit_plain.
//
// What bounds it on an H100: bytes.  Per ray it reads the origin, the
// direction and the suppressed id (28 bytes) and writes t, idx and found
// (9 bytes); its sweep is about 26 f32 operations a sphere, ~260 a ray on
// the notebook scenes (10 spheres), below the card's ~20 operations a byte
// times 37 bytes.  chip_smoke.py counts both from each run's data.
//
// Design for that bound: one thread per ray, a 128-thread block with a
// masked ragged tail; the scene table staged in shared memory once per
// block (its size set at launch, so one build serves every scene); the
// running minimum in registers, with a strict '<' so the first minimum
// wins, as argmin does.

#include "sphere.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
nearest_hit_kernel(const float* __restrict__ origins,
                   const float* __restrict__ dirs,
                   const int* __restrict__ suppress,
                   const float* __restrict__ spheres,
                   const int* __restrict__ ids, int n_spheres,
                   long long n_rays, int by_abs, int fast,
                   float* __restrict__ t_out, int* __restrict__ idx_out,
                   bool* __restrict__ found_out) {
  extern __shared__ float s_mem[];
  float* s_sph = s_mem;
  int* s_ids = reinterpret_cast<int*>(s_mem + n_spheres * sphere::kRow);
  sphere::stage(spheres, ids, n_spheres, s_sph, s_ids);

  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= n_rays) return;
  const int sup = suppress != nullptr ? suppress[i] : sphere::kNoSuppress;
  const sphere::Hit h = sphere::sweep(
      s_sph, s_ids, n_spheres, origins[3 * i], origins[3 * i + 1],
      origins[3 * i + 2], dirs[3 * i], dirs[3 * i + 1], dirs[3 * i + 2], sup,
      by_abs != 0, fast != 0);
  t_out[i] = h.t;
  idx_out[i] = h.idx;
  found_out[i] = h.found;
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
  const size_t smem = static_cast<size_t>(n_spheres) *
                      (sphere::kRow * sizeof(float) + sizeof(int));
  if (n_spheres < 1 || smem > 48 * 1024 || n_rays < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rays == 0) return static_cast<int>(cudaSuccess);
  const long long blocks = (n_rays + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  nearest_hit_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      origins, dirs, suppress, spheres, ids, n_spheres, n_rays, by_abs, fast,
      t, idx, found);
  return static_cast<int>(cudaGetLastError());
}
