// Device code shared by the path kernels (path_trace.cu, path_level.cu):
// the scene table's layout and one bounce level of
// raytracer_tpu/trace/path.py::_trace_path_lean_impl, op for op: the
// nearest-sphere sweep by |t| with in-sweep attribute selection, the hit
// point and normal, direct light, the mirror reflection and the
// renderer-frame hemisphere direction.  Both kernels run this code, so a
// level of the hybrid equals a level of the whole-trace kernel bit for bit.
//
// Rounding: built with -fmad=false (core/native.py), so no multiply-add is
// contracted and every operation rounds on its own, as the plain version's
// separate PyTorch operations do on the card; sqrtf and '/' are IEEE (no
// fast math).  Constants are written as (float)<double>, the rounding
// PyTorch applies to a Python float scalar.  NaN-propagating max() mirrors
// torch.clamp_min / jnp.maximum.

#pragma once

#include <cuda_runtime.h>

#include <cfloat>

namespace path {

constexpr int kMaxSpheres = 64;   // core/cuda_path.py MAX_SPHERES
constexpr int kMaxEmissive = 64;  // core/cuda_path.py MAX_EMISSIVE
// Row of the table (core/cuda_path.py::PathTable.spheres):
// cx cy cz r colr colg colb refl transp emit ior id.
constexpr int kRow = 12;

constexpr int kFlagEmissive = 1;
constexpr int kFlagSmall = 2;
constexpr int kFlagMirror = 4;

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

// The scene table in shared memory.
struct Table {
  float sph[kMaxSpheres * kRow];
  int flags[kMaxSpheres];
  int emis[kMaxEmissive];
};

// Copies the table into shared memory; every thread of the block takes
// part, so call it before any thread leaves.
__device__ __forceinline__ void stage(Table& t, const float* __restrict__ sph,
                                      const int* __restrict__ flags,
                                      const int* __restrict__ emis,
                                      int n_spheres, int n_emissive) {
  for (int k = threadIdx.x; k < n_spheres * kRow; k += blockDim.x)
    t.sph[k] = sph[k];
  for (int k = threadIdx.x; k < n_spheres; k += blockDim.x)
    t.flags[k] = flags[k];
  for (int k = threadIdx.x; k < n_emissive; k += blockDim.x)
    t.emis[k] = emis[k];
  __syncthreads();
}

struct Hit {
  bool found;
  int idx;       // index of the hit sphere (0 where nothing was hit)
  int flags;     // its material flags
  float t;
  float px, py, pz, nx, ny, nz;
};

// Nearest hit by |t| (the strict '<' keeps the first minimum), then the hit
// point and the normalised normal.  About 26 f32 operations a sphere.
__device__ __forceinline__ Hit sweep(const Table& tb, int n_spheres,
                                     float ox, float oy, float oz, float dx,
                                     float dy, float dz, bool fast) {
  float best_m = FLT_MAX;
  Hit h{false, 0, 0, FLT_MAX, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float bcx = 0.0f, bcy = 0.0f, bcz = 0.0f;
  for (int s = 0; s < n_spheres; ++s) {
    const float* sp = tb.sph + s * kRow;
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
      h.t = t;
      h.idx = s;
      bcx = cx;
      bcy = cy;
      bcz = cz;
    }
    h.found = h.found || valid;
  }
  h.flags = tb.flags[h.idx];
  h.px = ox + dx * h.t;
  h.py = oy + dy * h.t;
  h.pz = oz + dz * h.t;
  h.nx = h.px - bcx;
  h.ny = h.py - bcy;
  h.nz = h.pz - bcz;
  normalise3(h.nx, h.ny, h.nz);
  return h;
}

// Direct light at the hit from every emissive sphere but the hit one: the
// sum of trunc(0.3*max(0,cos)/d^2*colour) per channel.  About 32 f32
// operations a light.
__device__ __forceinline__ void direct_light(const Table& tb, int n_emissive,
                                             const Hit& h, bool fast,
                                             float& dr, float& dg,
                                             float& db) {
  const float kLightScale = static_cast<float>(0.3);
  dr = 0.0f;
  dg = 0.0f;
  db = 0.0f;
  for (int k = 0; k < n_emissive; ++k) {
    const int s = tb.emis[k];
    if (s == h.idx) continue;                 // w = 0: adds trunc(0) = 0
    const float* sp = tb.sph + s * kRow;
    const float tx = sp[0] - h.px, ty = sp[1] - h.py, tz = sp[2] - h.pz;
    const float d2 = tx * tx + ty * ty + tz * tz;
    float w;
    if (fast) {
      const float inv = rsqrtf(max_nan(d2, static_cast<float>(1e-30)));
      const float ldotn = tx * h.nx + ty * h.ny + tz * h.nz;
      w = max_nan(ldotn * inv, 0.0f) * (inv * inv) * kLightScale;
    } else {
      const float dist = sqrtf(d2);
      const float den = max_nan(dist, static_cast<float>(1e-20));
      const float cosang = (tx / den) * h.nx + (ty / den) * h.ny +
                           (tz / den) * h.nz;
      w = max_nan(cosang, 0.0f) /
          max_nan(dist * dist, static_cast<float>(1e-30)) * kLightScale;
    }
    dr = dr + truncf(w * sp[4]);
    dg = dg + truncf(w * sp[5]);
    db = db + truncf(w * sp[6]);
  }
}

// Mirror reflect of d in n: normalise both, reflect, renormalise.
__device__ __forceinline__ void reflect(float dx, float dy, float dz,
                                        float nx, float ny, float nz,
                                        float& rx, float& ry, float& rz) {
  float vx = dx, vy = dy, vz = dz;
  normalise3(vx, vy, vz);
  float mx = nx, my = ny, mz = nz;
  normalise3(mx, my, mz);
  const float sdot = 2.0f * (vx * mx + vy * my + vz * mz);
  rx = vx - mx * sdot;
  ry = vy - my * sdot;
  rz = vz - mz * sdot;
  normalise3(rx, ry, rz);
}

// The direction at polar theta / azimuth phi about n, renderer tangent
// frame (trace/sampling.py::local_to_world_c).
__device__ __forceinline__ void local_to_world(float theta, float phi,
                                               float nx, float ny, float nz,
                                               float& rx, float& ry,
                                               float& rz) {
  const float kTangentZ = static_cast<float>(0.9);
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

// The cosine bounce theta = acos(sqrt(u0)), phi = 2*pi*u1.
__device__ __forceinline__ void cosine_bounce(float u0, float u1, float nx,
                                              float ny, float nz, float& rx,
                                              float& ry, float& rz) {
  const float kTwoPi = static_cast<float>(2.0 * 3.141592653589793);
  local_to_world(acosf(sqrtf(u0)), kTwoPi * u1, nx, ny, nz, rx, ry, rz);
}

}  // namespace path
