// Whole-trace Whitted kernel for Hopper (sm_90a): one thread per ray.
//
// Replaces raytracer_tpu/core/pallas_whitted.py::_kernel (reached through
// trace_whitted_pallas).  Semantics are those of
// raytracer_tpu/trace/whitted.py::trace_whitted, in its order of steps, for
// each of max_bounces + 2 levels: the nearest-sphere sweep by signed t with
// the suppressed id; a miss or bounces > max_bounces ends the chain with the
// reflective fallback or none; a terminal sphere records the hit; a mirror
// (reflective == 1) records the fallback and reflects; glass
// (transparent == 1) refracts in, takes at most 10 total-internal-reflection
// steps against the sphere's far root and refracts out, or, trapped, ends
// with the fallback or none; mirror and glass continue with the hit
// sphere's id suppressed, and only glass counts as passed through.  The
// plain PyTorch version is core/cuda_whitted.py::whitted_trace_plain.
//
// Rounding: as in sphere.cuh (-fmad=false, IEEE sqrt and division,
// NaN-propagating clamps); constants are (float)<double>.
//
// What bounds it on an H100: bytes.  Per ray it reads the origin and the
// direction (24 bytes, 28 with suppressed ids) and writes the result (41
// bytes: hit, idx, t, point, normal, bounces, through).  Its arithmetic, in
// each level a ray runs, is the sweep's (csrc/sphere.cuh::test: 9 f32
// operations a sphere test, 9 more in front of the ray, 7 more for a valid
// sphere), 20 more a level that hits, 42 for a mirror bounce, 98 for a
// glass entry, and 61 for each walk step (82 more when that step reflects
// internally): on the notebook scenes (10 spheres, ~1-2 levels a ray) a few
// hundred operations a ray against ~65 bytes, below the card's ~10
// non-fused operations a byte.  chip_smoke.py counts both from each run's
// data.
//
// Design for that bound: one thread per ray and a 128-thread block with a
// masked ragged tail (no tiles, no padding); the scene table is staged in
// shared memory once per block as sphere.cuh lays it out, its size set at
// launch, so one build serves every scene; a runtime level loop that a ray
// leaves as soon as it is no longer active, and a walk loop that it leaves
// as soon as it exits the sphere (this equals the TPU kernel's fixed unroll
// and the plain version's loop with early exit, since a lane that has
// exited is frozen); the result and fallback records stay in registers, so
// device memory sees the inputs once and the result once.

#include "sphere.cuh"

namespace {

using sphere::max_nan;
using sphere::clamp_nan;
using sphere::normalise3;

constexpr int kThreads = 128;
constexpr int kWalkSteps = 10;

constexpr int kActive = 0;
constexpr int kDoneHit = 1;
constexpr int kDoneNone = 2;

struct Record {
  int idx;
  float px, py, pz, nx, ny, nz, t;
  int bounces, through;
};

// vec.reflect_c: normalise both, reflect, renormalise.
__device__ __forceinline__ void reflect3(float vx, float vy, float vz,
                                         float nx, float ny, float nz,
                                         float& rx, float& ry, float& rz) {
  normalise3(vx, vy, vz);
  normalise3(nx, ny, nz);
  const float s = 2.0f * (vx * nx + vy * ny + vz * nz);
  rx = vx - nx * s;
  ry = vy - ny * s;
  rz = vz - nz * s;
  normalise3(rx, ry, rz);
}

// vec.refract_c with eta = eta_a / eta_b; returns true on total internal
// reflection (the direction is then garbage).
__device__ __forceinline__ bool refract3(float vx, float vy, float vz,
                                         float nx, float ny, float nz,
                                         float eta, float& ox, float& oy,
                                         float& oz) {
  normalise3(vx, vy, vz);
  normalise3(nx, ny, nz);
  const float cos_i = fabsf(clamp_nan(vx * nx + vy * ny + vz * nz, -1.0f,
                                      1.0f));
  const float k = 1.0f - eta * eta * (1.0f - cos_i * cos_i);
  const float f = eta * cos_i - sqrtf(max_nan(k, 0.0f));
  ox = vx * eta + nx * f;
  oy = vy * eta + ny * f;
  oz = vz * eta + nz * f;
  normalise3(ox, oy, oz);
  return k < 0.0f;
}

// intersect.single_sphere_exit_c: the far root t = tca + thc against the
// ray's own sphere (rr = r*r, as staged), its point and outward normal.
__device__ __forceinline__ void sphere_exit(float ox, float oy, float oz,
                                            float dx, float dy, float dz,
                                            float cx, float cy, float cz,
                                            float rr, float& px, float& py,
                                            float& pz, float& nx, float& ny,
                                            float& nz) {
  const float lx = cx - ox, ly = cy - oy, lz = cz - oz;
  const float tca = lx * dx + ly * dy + lz * dz;
  const float d2 = max_nan(lx * lx + ly * ly + lz * lz - tca * tca, 0.0f);
  const float thc = sqrtf(max_nan(rr - d2, 0.0f));
  const float t = tca + thc;
  px = ox + dx * t;
  py = oy + dy * t;
  pz = oz + dz * t;
  nx = px - cx;
  ny = py - cy;
  nz = pz - cz;
  normalise3(nx, ny, nz);
}

__global__ void __launch_bounds__(kThreads)
whitted_trace_kernel(const float* __restrict__ origins,
                     const float* __restrict__ dirs,
                     const int* __restrict__ suppress,
                     const float* __restrict__ spheres,
                     const int* __restrict__ ids, int n_spheres,
                     long long n_rays, int max_bounces, int fast,
                     bool* __restrict__ hit_out, int* __restrict__ idx_out,
                     float* __restrict__ t_out,
                     float* __restrict__ point_out,
                     float* __restrict__ normal_out,
                     int* __restrict__ bounces_out,
                     int* __restrict__ through_out) {
  extern __shared__ float4 s_mem[];
  const sphere::Table tb = sphere::carve(s_mem, n_spheres);
  sphere::stage(tb, spheres, ids, n_spheres, fast != 0);

  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= n_rays) return;

  float ox = origins[3 * i], oy = origins[3 * i + 1], oz = origins[3 * i + 2];
  float dx = dirs[3 * i], dy = dirs[3 * i + 1], dz = dirs[3 * i + 2];
  normalise3(dx, dy, dz);
  int sup = suppress != nullptr ? suppress[i] : sphere::kNoSuppress;

  int status = kActive;
  int bounces = 0, through = 0;
  Record res{0, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0, 0};
  Record fb = res;
  bool fb_valid = false;

  for (int lvl = 0; lvl < max_bounces + 2; ++lvl) {
    const sphere::Hit h = sphere::sweep(tb, n_spheres, ox, oy, oz, dx, dy,
                                        dz, sup, false);
    // Chain fails: no hit, or the bounce budget is spent.
    if (!h.found || bounces > max_bounces) {
      if (fb_valid) res = fb;
      status = fb_valid ? kDoneHit : kDoneNone;
      break;
    }
    const float4 c = tb.centre[h.idx];
    const float4 at = tb.attr[h.idx];         // r*r ior mirror glass
    const float px = ox + dx * h.t;
    const float py = oy + dy * h.t;
    const float pz = oz + dz * h.t;
    float nx = px - c.x, ny = py - c.y, nz = pz - c.z;
    normalise3(nx, ny, nz);
    const Record here{h.idx, px, py, pz, nx, ny, nz, h.t, bounces, through};
    const bool mirror = at.z != 0.0f;
    const bool glass = !mirror && at.w != 0.0f;
    if (!mirror && !glass) {                     // terminal
      res = here;
      status = kDoneHit;
      break;
    }
    if (mirror) {                                // fallback, then bounce
      fb = here;
      fb_valid = true;
      float rx, ry, rz;
      reflect3(dx, dy, dz, nx, ny, nz, rx, ry, rz);
      ox = px;
      oy = py;
      oz = pz;
      dx = rx;
      dy = ry;
      dz = rz;
    } else {                                     // glass walk
      const float cx = c.x, cy = c.y, cz = c.z, rr = at.x;
      const float ior = at.y;
      float rdx, rdy, rdz;
      const bool tir_in = refract3(dx, dy, dz, nx, ny, nz, 1.0f / ior, rdx,
                                   rdy, rdz);
      float epx, epy, epz, enx, eny, enz;
      sphere_exit(px, py, pz, rdx, rdy, rdz, cx, cy, cz, rr, epx, epy, epz,
                  enx, eny, enz);
      bool exited = false;
      float wpx = 0.0f, wpy = 0.0f, wpz = 0.0f;
      float wdx = 0.0f, wdy = 0.0f, wdz = 0.0f;
      for (int w = 0; w < kWalkSteps; ++w) {
        float ex, ey, ez;
        // Outward: eta = ior / 1 = ior exactly.
        if (!refract3(rdx, rdy, rdz, -enx, -eny, -enz, ior, ex, ey, ez)) {
          wpx = epx;
          wpy = epy;
          wpz = epz;
          wdx = ex;
          wdy = ey;
          wdz = ez;
          exited = true;
          break;
        }
        // Total internal reflection: reflect and find the next exit point.
        float rlx, rly, rlz;
        reflect3(rdx, rdy, rdz, enx, eny, enz, rlx, rly, rlz);
        float npx, npy, npz, nnx, nny, nnz;
        sphere_exit(epx, epy, epz, rlx, rly, rlz, cx, cy, cz, rr, npx, npy,
                    npz, nnx, nny, nnz);
        rdx = rlx;
        rdy = rly;
        rdz = rlz;
        epx = npx;
        epy = npy;
        epz = npz;
        enx = nnx;
        eny = nny;
        enz = nnz;
      }
      if (!exited || tir_in) {                   // trapped
        if (fb_valid) res = fb;
        status = fb_valid ? kDoneHit : kDoneNone;
        break;
      }
      ox = wpx;
      oy = wpy;
      oz = wpz;
      dx = wdx;
      dy = wdy;
      dz = wdz;
      ++through;
    }
    sup = tb.id[h.idx];
    ++bounces;
  }

  hit_out[i] = status == kDoneHit;
  idx_out[i] = res.idx;
  t_out[i] = res.t;
  point_out[3 * i] = res.px;
  point_out[3 * i + 1] = res.py;
  point_out[3 * i + 2] = res.pz;
  normal_out[3 * i] = res.nx;
  normal_out[3 * i + 1] = res.ny;
  normal_out[3 * i + 2] = res.nz;
  bounces_out[i] = res.bounces;
  through_out[i] = res.through;
}

}  // namespace

// Returns a cudaError_t: cudaErrorInvalidValue for arguments the kernel does
// not take, else cudaGetLastError() after the launch.
extern "C" int whitted_trace_launch(const float* origins, const float* dirs,
                                    const int* suppress,
                                    const float* spheres, const int* ids,
                                    int n_spheres, long long n_rays,
                                    int max_bounces, int fast, bool* hit,
                                    int* idx, float* t, float* point,
                                    float* normal, int* bounces,
                                    int* through, void* stream) {
  const size_t smem = static_cast<size_t>(n_spheres) * sphere::kStagedBytes;
  if (n_spheres < 1 || smem > 48 * 1024 || n_rays < 0 || max_bounces < 0 ||
      max_bounces > INT_MAX - 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rays == 0) return static_cast<int>(cudaSuccess);
  const long long blocks = (n_rays + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  whitted_trace_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      origins, dirs, suppress, spheres, ids, n_spheres, n_rays, max_bounces,
      fast, hit, idx, t, point, normal, bounces, through);
  return static_cast<int>(cudaGetLastError());
}
