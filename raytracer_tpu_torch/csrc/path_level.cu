// One bounce level of the path tracer for Hopper (sm_90a): one thread per
// ray.
//
// Replaces raytracer_tpu/core/pallas_path.py::_level_kernel (reached through
// run_level_kernel), the per-level kernel of trace_path(impl="hybrid"): the
// sweep, direct light, the hit point and normal, the offset origin, and the
// bounce direction a lane takes unless the guide overrides it (the mirror
// reflection, or the cosine bounce from the level's uniforms).  Its
// arithmetic is path_common.cuh's, the same code path_trace.cu runs, so the
// hybrid equals the whole-trace kernel bit for bit.  The plain PyTorch
// version beside it is core/cuda_level.py::path_level_plain.
//
// Outputs (each lane written once; zeros / the input ray where unset):
//   state [R] uint8: running 1, found 2, emissive 4, small light 8,
//     mirror 16, continuing 32 (core/cuda_level.py ST_*);
//   rec [R, 6]: albedo (found lanes) and direct light (continuing lanes);
//   o_next, d_next [R, 3]: the offset origin and the bounce direction on
//     continuing lanes, the input ray elsewhere;
//   hit [R, 11] (optional, for the guide's observation): point, normal,
//     reflective, transparent, emitive, ior, id on continuing lanes.
// The TPU kernel's 32 f32 planes are not copied: the state is one byte and
// only what the hybrid reads is written.
//
// What bounds it on an H100, at the guided hybrid's shapes: bytes and
// operations come close.  A lane reads 24 B of ray, 1 of state and 8 of
// uniforms and writes 1 + 24 + 12 + 12 + 44 = 93 B at 3.35 TB/s; a running
// lane needs the level's f32 operations (path_trace.cu's count, none fused,
// -fmad=false) at 33.5 T/s.  chip_smoke.py counts both on each run's data.
// Design: one thread per ray in 128-thread blocks, each staging the scene
// table in shared memory; the level is path_common.cuh's, with the sweep's
// inside test without its square root and the lights whose term is
// provably zero skipped, and a diffuse lane skips the mirror reflection it
// would not keep; a lane that is not running writes its pass-through values
// and leaves.

#include <cuda_runtime.h>

#include <cstdint>

#include "path_common.cuh"

namespace {

constexpr int kThreads = 128;

constexpr unsigned char kStRunning = 1;
constexpr unsigned char kStFound = 2;
constexpr unsigned char kStEmissive = 4;
constexpr unsigned char kStSmall = 8;
constexpr unsigned char kStMirror = 16;
constexpr unsigned char kStCont = 32;
constexpr int kHit = 11;

struct Params {
  const float* o;
  const float* d;
  const unsigned char* running;
  const float* u;          // [R, 2], or null (no diffuse bounce)
  const float* spheres;
  const int* flags;
  const int* emissive;
  const float* inside;     // PathTable.inside [n_spheres]
  const float* light_cut;  // PathTable.light_cut [n_emissive]
  unsigned char* state;
  float* rec;
  float* o_next;
  float* d_next;
  float* hit;              // [R, 11], or null
  long long n_rays;
  int n_spheres, n_emissive, fast;
};

__global__ void __launch_bounds__(kThreads) path_level_kernel(Params p) {
  __shared__ path::Table tb;
  path::stage(tb, p.spheres, p.flags, p.emissive, p.inside, p.light_cut,
              p.n_spheres, p.n_emissive, p.fast);
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= p.n_rays) return;

  const float ox = p.o[3 * i], oy = p.o[3 * i + 1], oz = p.o[3 * i + 2];
  const float dx = p.d[3 * i], dy = p.d[3 * i + 1], dz = p.d[3 * i + 2];
  unsigned char st = 0;
  float rec[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float hit[kHit] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f,
                     0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float nox = ox, noy = oy, noz = oz, ndx = dx, ndy = dy, ndz = dz;

  if (p.running[i]) {
    st |= kStRunning;
    const path::Hit h = path::sweep(tb, p.n_spheres, ox, oy, oz, dx, dy, dz);
    if (h.found) {
      st |= kStFound;
      if (h.flags & path::kFlagSmall) st |= kStSmall;
      const float* sp = tb.sph + h.idx * path::kRow;
      rec[0] = sp[4];
      rec[1] = sp[5];
      rec[2] = sp[6];
      if (h.flags & path::kFlagEmissive) {
        st |= kStEmissive;
      } else {
        st |= kStCont;
        const bool mirror = (h.flags & path::kFlagMirror) != 0;
        if (mirror) st |= kStMirror;
        path::direct_light(tb, p.n_emissive, h, p.fast, rec[3], rec[4],
                           rec[5]);
        // The plain version computes both directions and keeps one.
        if (!mirror && p.u != nullptr)
          path::cosine_bounce(p.u[2 * i], p.u[2 * i + 1], h.nx, h.ny, h.nz,
                              ndx, ndy, ndz);
        else
          path::reflect(dx, dy, dz, h.nx, h.ny, h.nz, ndx, ndy, ndz);
        const float kOffset = static_cast<float>(0.001);
        nox = h.px + h.nx * kOffset;
        noy = h.py + h.ny * kOffset;
        noz = h.pz + h.nz * kOffset;
        const float v[kHit] = {h.px, h.py, h.pz, h.nx, h.ny, h.nz,
                               sp[7], sp[8], sp[9], sp[10], sp[11]};
#pragma unroll
        for (int k = 0; k < kHit; ++k) hit[k] = v[k];
      }
    }
  }
  p.state[i] = st;
#pragma unroll
  for (int k = 0; k < 6; ++k) p.rec[6 * i + k] = rec[k];
  p.o_next[3 * i] = nox;
  p.o_next[3 * i + 1] = noy;
  p.o_next[3 * i + 2] = noz;
  p.d_next[3 * i] = ndx;
  p.d_next[3 * i + 1] = ndy;
  p.d_next[3 * i + 2] = ndz;
  if (p.hit != nullptr) {
#pragma unroll
    for (int k = 0; k < kHit; ++k) p.hit[kHit * i + k] = hit[k];
  }
}

}  // namespace

// Returns a cudaError_t: cudaErrorInvalidValue for arguments beyond the
// compile-time capacities, else cudaGetLastError() after the launch.
extern "C" int path_level_launch(
    const float* o, const float* d, const unsigned char* running,
    const float* u, const float* spheres, const int* flags,
    const int* emissive, const float* inside, const float* light_cut,
    int n_spheres, int n_emissive, long long n_rays, int fast,
    unsigned char* state, float* rec, float* o_next, float* d_next,
    float* hit, void* stream) {
  if (n_spheres < 1 || n_spheres > path::kMaxSpheres || n_emissive < 0 ||
      n_emissive > path::kMaxEmissive || n_rays < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rays == 0) return static_cast<int>(cudaSuccess);
  const long long blocks = (n_rays + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  Params p{o, d, running, u, spheres, flags, emissive, inside, light_cut,
           state, rec, o_next, d_next, hit, n_rays, n_spheres, n_emissive,
           fast};
  path_level_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
