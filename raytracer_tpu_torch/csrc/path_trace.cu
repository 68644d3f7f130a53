// Whole-trace path kernel for Hopper (sm_90a): one thread per ray.
//
// Replaces raytracer_tpu/core/pallas_path.py::_kernel, unguided branch
// (reached through trace_path_pallas_impl).  Semantics are those of
// raytracer_tpu/trace/path.py::_trace_path_lean_impl, op for op: for each
// level, a nearest-sphere sweep by |t| with in-sweep attribute selection;
// direct light as the sum over emissive spheres of
// trunc(0.3*max(0,cos)/d^2*colour), skipping the hit sphere; a mirror
// reflect, or a cosine bounce theta = acos(sqrt(u0)), phi = 2*pi*u1 from the
// level's uniforms; the 0.001 normal offset.  Then the reverse fold
// trunc(albedo * min(255, direct + child) / 255), background on a miss.
// The plain PyTorch version beside it is core/cuda_path.py::path_trace_plain.
//
// Rounding: built with -fmad=false (core/native.py), so no multiply-add is
// contracted and every operation rounds on its own, as the plain version's
// separate PyTorch operations do on the card; sqrtf and '/' are IEEE (no
// fast math).  Constants are written as (float)<double>, the rounding
// PyTorch applies to a Python float scalar.  NaN-propagating max() mirrors
// torch.clamp_min / jnp.maximum.
//
// What bounds it on an H100: operations.  Per ray and level run, the sweep
// costs about 26 f32 operations a sphere (29 spheres in the chandelier), and
// a level that continues adds about 32 a light for direct lighting (21
// emissive spheres) plus about 80 for the hit point, normal, reflection,
// offset and fold: about 1.5 k operations a ray-level, so the frame's
// ray-levels (3.84 M rays at 800x600x8 spp, a few levels each) take
// ~0.1-0.5 ms at 67 TFLOP/s f32.  Its I/O is 52 bytes a ray (origin and
// direction in; rgb and four counts out), ~0.2 GB a frame or ~0.06 ms at
// 3.35 TB/s.  chip_smoke.py counts both from each run's data.
//
// Design for that bound: one thread per ray and a 128-thread block with a
// masked ragged tail (no padding of the ray count); the scene table (sphere
// rows, material flags, emissive list) is staged in shared memory once per
// block, so every thread's sweep reads it from there and one build serves
// every scene; a ray leaves the level loop as soon as it terminates, so the
// work done is the work its path needs (no masked lanes carried to the last
// level); the level records for the fold stay in thread-local storage, so
// nothing but the result goes back to device memory.  Making it fast (warp
// coherence, fewer divides) is later work.

#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

namespace {

constexpr int kMaxSpheres = 64;   // core/cuda_path.py MAX_SPHERES
constexpr int kMaxEmissive = 64;  // core/cuda_path.py MAX_EMISSIVE
constexpr int kMaxBounces = 16;   // core/cuda_path.py MAX_BOUNCES
constexpr int kThreads = 128;
constexpr int kRow = 7;           // cx cy cz r colr colg colb

constexpr int kFlagEmissive = 1;
constexpr int kFlagSmall = 2;
constexpr int kFlagMirror = 4;

constexpr unsigned char kMiss = 1;
constexpr unsigned char kEmissive = 2;
constexpr unsigned char kContinue = 3;

__device__ __forceinline__ float max_nan(float a, float b) {
  // torch.clamp_min(a, b) with a constant b: NaN in a propagates.
  return (a != a) ? a : fmaxf(a, b);
}

__device__ __forceinline__ void normalise3(float& x, float& y, float& z) {
  const float m = max_nan(sqrtf(x * x + y * y + z * z),
                          static_cast<float>(1e-20));
  x = x / m;
  y = y / m;
  z = z / m;
}

struct Level {
  float ar, ag, ab, dr, dg, db;
};

__global__ void __launch_bounds__(kThreads)
path_trace_kernel(const float* __restrict__ origins,
                  const float* __restrict__ dirs,
                  const float* __restrict__ uniforms,
                  const float* __restrict__ spheres,
                  const int* __restrict__ flags,
                  const int* __restrict__ emissive, int n_spheres,
                  int n_emissive, long long n_rays, int max_bounces,
                  float bg_r, float bg_g, float bg_b, int fast,
                  float* __restrict__ rgb, int* __restrict__ counts) {
  __shared__ float s_sph[kMaxSpheres * kRow];
  __shared__ int s_flags[kMaxSpheres];
  __shared__ int s_emis[kMaxEmissive];
  for (int k = threadIdx.x; k < n_spheres * kRow; k += blockDim.x)
    s_sph[k] = spheres[k];
  for (int k = threadIdx.x; k < n_spheres; k += blockDim.x)
    s_flags[k] = flags[k];
  for (int k = threadIdx.x; k < n_emissive; k += blockDim.x)
    s_emis[k] = emissive[k];
  __syncthreads();

  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= n_rays) return;

  float ox = origins[3 * i], oy = origins[3 * i + 1], oz = origins[3 * i + 2];
  float dx = dirs[3 * i], dy = dirs[3 * i + 1], dz = dirs[3 * i + 2];
  normalise3(dx, dy, dz);

  const float kOffset = static_cast<float>(0.001);
  const float kTwoPi = static_cast<float>(2.0 * 3.141592653589793);
  const float kTangentZ = static_cast<float>(0.9);
  const float kLightScale = static_cast<float>(0.3);

  unsigned char kind[kMaxBounces];
  Level rec[kMaxBounces];
  int n_run = 0, n_found = 0, n_emis = 0, n_small = 0;
  int n_levels = 0;
  bool running = true;

  for (int lvl = 0; lvl < max_bounces; ++lvl) {
    ++n_run;
    n_levels = lvl + 1;

    // Nearest hit by |t|, attributes selected in the sweep.
    float best_m = FLT_MAX, best_t = FLT_MAX;
    int best_i = 0, best_flags = 0;
    float bcx = 0.0f, bcy = 0.0f, bcz = 0.0f;
    float ar = 0.0f, ag = 0.0f, ab = 0.0f;
    bool found = false;
    for (int s = 0; s < n_spheres; ++s) {
      const float* sp = s_sph + s * kRow;
      const float cx = sp[0], cy = sp[1], cz = sp[2], r = sp[3];
      const float lx = cx - ox, ly = cy - oy, lz = cz - oz;
      const float tca = lx * dx + ly * dy + lz * dz;
      const float d2 = max_nan(lx * lx + ly * ly + lz * lz - tca * tca, 0.0f);
      const float rr = r * r;
      const float thc = sqrtf(max_nan(rr - d2, 0.0f));
      const float t = tca - thc;
      const bool inside = fast ? (d2 <= rr) : (sqrtf(d2) <= r);
      const bool valid = (tca >= 0.0f) && inside;
      const float m = fabsf(t);
      if (valid && m < best_m) {
        best_m = m;
        best_t = t;
        best_i = s;
        bcx = cx;
        bcy = cy;
        bcz = cz;
        ar = sp[4];
        ag = sp[5];
        ab = sp[6];
        best_flags = s_flags[s];
      }
      found = found || valid;
    }
    if (!found) {
      kind[lvl] = kMiss;
      running = false;
      break;
    }
    ++n_found;
    if (best_flags & kFlagSmall) ++n_small;
    if (best_flags & kFlagEmissive) {
      ++n_emis;
      kind[lvl] = kEmissive;
      rec[lvl].ar = ar;
      rec[lvl].ag = ag;
      rec[lvl].ab = ab;
      running = false;
      break;
    }

    const float px = ox + dx * best_t;
    const float py = oy + dy * best_t;
    const float pz = oz + dz * best_t;
    float nx = px - bcx, ny = py - bcy, nz = pz - bcz;
    normalise3(nx, ny, nz);

    // Direct light from every emissive sphere but the hit one.
    float dr = 0.0f, dg = 0.0f, db = 0.0f;
    for (int k = 0; k < n_emissive; ++k) {
      const int s = s_emis[k];
      if (s == best_i) continue;               // w = 0: adds trunc(0) = 0
      const float* sp = s_sph + s * kRow;
      const float tx = sp[0] - px, ty = sp[1] - py, tz = sp[2] - pz;
      const float d2 = tx * tx + ty * ty + tz * tz;
      float w;
      if (fast) {
        const float inv = rsqrtf(max_nan(d2, static_cast<float>(1e-30)));
        const float ldotn = tx * nx + ty * ny + tz * nz;
        w = max_nan(ldotn * inv, 0.0f) * (inv * inv) * kLightScale;
      } else {
        const float dist = sqrtf(d2);
        const float den = max_nan(dist, static_cast<float>(1e-20));
        const float cosang = (tx / den) * nx + (ty / den) * ny +
                             (tz / den) * nz;
        w = max_nan(cosang, 0.0f) /
            max_nan(dist * dist, static_cast<float>(1e-30)) * kLightScale;
      }
      dr = dr + truncf(w * sp[4]);
      dg = dg + truncf(w * sp[5]);
      db = db + truncf(w * sp[6]);
    }

    // Mirror reflect: normalise both, reflect, renormalise.
    float vx = dx, vy = dy, vz = dz;
    normalise3(vx, vy, vz);
    float mx = nx, my = ny, mz = nz;
    normalise3(mx, my, mz);
    const float sdot = 2.0f * (vx * mx + vy * my + vz * mz);
    float rx = vx - mx * sdot, ry = vy - my * sdot, rz = vz - mz * sdot;
    normalise3(rx, ry, rz);

    const bool mirror = (best_flags & kFlagMirror) != 0;
    if (!mirror && uniforms != nullptr) {
      // Cosine bounce in the renderer tangent frame.
      const float* u = uniforms + 2 * (static_cast<long long>(lvl) * n_rays + i);
      const float theta = acosf(sqrtf(u[0]));
      const float phi = kTwoPi * u[1];
      const bool above = fabsf(nz) > kTangentZ;
      float tx = above ? 1.0f : -ny;
      float ty = above ? 0.0f : nx;
      float tz = 0.0f;
      normalise3(tx, ty, tz);
      float bx = ny * tz - nz * ty;
      float by = nz * tx - nx * tz;
      float bz = nx * ty - ny * tx;
      normalise3(bx, by, bz);
      const float st = sinf(theta);
      const float lx = st * cosf(phi);
      const float ly = st * sinf(phi);
      const float lz = cosf(theta);
      rx = lx * tx + ly * bx + lz * nx;
      ry = lx * ty + ly * by + lz * ny;
      rz = lx * tz + ly * bz + lz * nz;
      normalise3(rx, ry, rz);
    }

    ox = px + nx * kOffset;
    oy = py + ny * kOffset;
    oz = pz + nz * kOffset;
    dx = rx;
    dy = ry;
    dz = rz;
    kind[lvl] = kContinue;
    rec[lvl] = Level{ar, ag, ab, dr, dg, db};
  }
  // A ray still running after the last level makes one more trace() call
  // that the reference counts before its bounce-budget return.
  if (running) ++n_run;

  float vr = bg_r, vg = bg_g, vb = bg_b;
  for (int lvl = n_levels - 1; lvl >= 0; --lvl) {
    const Level& l = rec[lvl];
    if (kind[lvl] == kContinue) {
      vr = truncf(l.ar * fminf(255.0f, l.dr + vr) / 255.0f);
      vg = truncf(l.ag * fminf(255.0f, l.dg + vg) / 255.0f);
      vb = truncf(l.ab * fminf(255.0f, l.db + vb) / 255.0f);
    } else if (kind[lvl] == kEmissive) {
      vr = l.ar;
      vg = l.ag;
      vb = l.ab;
    } else {
      vr = bg_r;
      vg = bg_g;
      vb = bg_b;
    }
  }
  rgb[3 * i] = vr;
  rgb[3 * i + 1] = vg;
  rgb[3 * i + 2] = vb;
  counts[4 * i] = n_run;
  counts[4 * i + 1] = n_found;
  counts[4 * i + 2] = n_emis;
  counts[4 * i + 3] = n_small;
}

}  // namespace

// Returns a cudaError_t: cudaErrorInvalidValue for arguments beyond the
// compile-time capacities, else cudaGetLastError() after the launch.
extern "C" int path_trace_launch(const float* origins, const float* dirs,
                                 const float* uniforms, const float* spheres,
                                 const int* flags, const int* emissive,
                                 int n_spheres, int n_emissive,
                                 long long n_rays, int max_bounces,
                                 float bg_r, float bg_g, float bg_b, int fast,
                                 float* rgb, int* counts, void* stream) {
  if (n_spheres < 1 || n_spheres > kMaxSpheres || n_emissive < 0 ||
      n_emissive > kMaxEmissive || max_bounces < 1 ||
      max_bounces > kMaxBounces || n_rays < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rays == 0) return static_cast<int>(cudaSuccess);
  const long long blocks = (n_rays + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  path_trace_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      origins, dirs, uniforms, spheres, flags, emissive, n_spheres,
      n_emissive, n_rays, max_bounces, bg_r, bg_g, bg_b, fast, rgb, counts);
  return static_cast<int>(cudaGetLastError());
}
