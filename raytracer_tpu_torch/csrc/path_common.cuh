// Device code shared by the path kernels (path_trace.cu, path_level.cu,
// path_guided.cu): the scene table's layout and one bounce level of
// raytracer_tpu/trace/path.py::_trace_path_lean_impl, with the same
// results bit for bit: the nearest-sphere sweep by |t| with in-sweep
// attribute selection, the hit point and normal, direct light, the mirror
// reflection and the renderer-frame hemisphere direction.  Every kernel runs
// this code, so a level of the hybrid equals a level of the whole-trace
// kernel bit for bit.
//
// Rounding: built with -fmad=false (core/native.py), so no multiply-add is
// contracted and every operation rounds on its own, as the plain version's
// separate PyTorch operations do on the card; sqrtf and '/' are IEEE (no
// fast math).  Constants are written as (float)<double>, the rounding
// PyTorch applies to a Python float scalar.  NaN-propagating max() mirrors
// torch.clamp_min / jnp.maximum.
//
// What bounds the level on an H100: the instructions it runs.  Each IEEE sqrtf
// and '/' is a multi-instruction sequence, so the level skips the ones
// whose result cannot change an output (the plain version computes them
// all): the sweep's inside test compares d2 with a threshold staged per
// sphere instead of taking sqrt(d2), and computes t only for a valid
// sphere; direct light skips, before any divide or square root, a light
// whose term is provably +-0 (direct_light).

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

// Light culls (direct_light; core/cuda_path.py CULL_MIN_D2 and
// LIGHT_CUT_MARGIN, the latter inside each light's staged cut): the least
// squared distance either cull takes, and the back-facing test's factor on
// |n|^2 with its floor.
constexpr float kCullMinD2 = 0x1p-60f;
constexpr float kBackK = 0x1p-40f;
constexpr float kBackFloor = 0x1p-60f;

// The scene table in shared memory.  sphere[s]: the centre and the inside
// test's threshold on d2 (exact: T(r), the largest float whose sqrtf is
// <= r, core/cuda_path.py::inside_threshold; fast: r*r).  light[k]: the
// centre of emissive sphere k and its far cut on d2; light_col[k]: its
// colour and its sphere index (int bits).
struct Table {
  float4 sphere[kMaxSpheres];
  float4 light[kMaxEmissive];
  float4 light_col[kMaxEmissive];
  float sph[kMaxSpheres * kRow];
  int flags[kMaxSpheres];
};

// Copies the table into shared memory; every thread of the block takes
// part, so call it before any thread leaves.  inside [n_spheres] and cut
// [n_emissive] are PathTable's planes.
__device__ __forceinline__ void stage(Table& t, const float* __restrict__ sph,
                                      const int* __restrict__ flags,
                                      const int* __restrict__ emis,
                                      const float* __restrict__ inside,
                                      const float* __restrict__ cut,
                                      int n_spheres, int n_emissive,
                                      bool fast) {
  for (int k = threadIdx.x; k < n_spheres * kRow; k += blockDim.x)
    t.sph[k] = sph[k];
  for (int s = threadIdx.x; s < n_spheres; s += blockDim.x) {
    const float* row = sph + s * kRow;
    const float r = row[3];
    t.sphere[s] = make_float4(row[0], row[1], row[2],
                              fast ? r * r : inside[s]);
    t.flags[s] = flags[s];
  }
  for (int k = threadIdx.x; k < n_emissive; k += blockDim.x) {
    const int s = emis[k];
    const float* row = sph + s * kRow;
    t.light[k] = make_float4(row[0], row[1], row[2], cut[k]);
    t.light_col[k] = make_float4(row[4], row[5], row[6], __int_as_float(s));
  }
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
// point and the normalised normal.  The plain version's inside test is
// sqrt(d2) <= r (exact) or d2 <= r*r (fast); sqrt is correctly rounded and
// monotone, so sqrt(d2) <= r holds exactly when d2 <= T(r), for every d2
// >= 0, +inf and NaN, and the staged threshold serves both modes.  d2, thc
// and t are used only where tca >= 0 and for a valid sphere, so only there
// are they computed.
__device__ __forceinline__ Hit sweep(const Table& tb, int n_spheres,
                                     float ox, float oy, float oz, float dx,
                                     float dy, float dz) {
  float best_m = FLT_MAX;
  Hit h{false, 0, 0, FLT_MAX, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float bcx = 0.0f, bcy = 0.0f, bcz = 0.0f;
  for (int s = 0; s < n_spheres; ++s) {
    const float4 c = tb.sphere[s];
    const float lx = c.x - ox, ly = c.y - oy, lz = c.z - oz;
    const float tca = lx * dx + ly * dy + lz * dz;
    if (!(tca >= 0.0f)) continue;             // behind the ray, or NaN
    const float d2 = max_nan(lx * lx + ly * ly + lz * lz - tca * tca, 0.0f);
    if (d2 <= c.w) {
      const float r = tb.sph[s * kRow + 3];
      const float t = tca - sqrtf(max_nan(r * r - d2, 0.0f));
      const float m = fabsf(t);
      if (m < best_m) {
        best_m = m;
        h.t = t;
        h.idx = s;
        bcx = c.x;
        bcy = c.y;
        bcz = c.z;
      }
      h.found = true;
    }
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
// sum of trunc(w*colour) per channel, w = 0.3*max(0,cos)/d^2 (exact: cos
// from t/|t| by sqrtf and four divides; fast: one rsqrtf).  Every term is
// integer-valued or NaN and the sum starts at +0, so it is never -0, and
// adding a term of +-0 leaves it as it is: a light whose term is provably
// +-0 is skipped before any divide or square root.  With u = 2^-24, a
// normal from normalise3 (finite: |n| <= 1 + 2e-5, the most a sum of
// subnormal squares can lose) and d2 > kCullMinD2 = 2^-60 (so no clamp
// binds and no square that matters underflows):
//  * far: d2 > cut = 0.3*max|colour|*(1 + 2^-10), rounded once on the
//    host (cut = +inf for a colour that is not finite: 0*inf is NaN).
//    Then cos <= |n|(1 + 8u) in both modes (|t|/dist and |t|*rsqrt(d2)
//    within 3u of 1, rsqrtf within 2 ulp), the denominator dist*dist or
//    1/inv^2 is >= d2(1 - 9u), and w*|colour| rounds to
//    <= (1 + 2e-5)(1 + 32u) / (1 + 2^-10) < 1: trunc gives +-0.
//  * back-facing: g = t.n < 0 and g*g > max(2^-40*|n|^2, 2^-60)*d2, so
//    |g| > 16u*|t||n|(1 - 4u) >= 16u*S(1 - 4u), S = sum |t_i n_i|.  The
//    exact t.n is within 3u*S of g, and the reference's rounded cos
//    within 4u*S/dist of t.n/dist, so cos < 0: max(cos, 0) = 0 (fast:
//    g*inv < 0), w = +-0, and with a finite colour the term is +-0.
__device__ __forceinline__ void direct_light(const Table& tb, int n_emissive,
                                             const Hit& h, bool fast,
                                             float& dr, float& dg,
                                             float& db) {
  const float kLightScale = static_cast<float>(0.3);
  dr = 0.0f;
  dg = 0.0f;
  db = 0.0f;
  const float nn = h.nx * h.nx + h.ny * h.ny + h.nz * h.nz;
  const bool cull = nn <= FLT_MAX;            // a finite normal
  const float kh = fmaxf(kBackK * nn, kBackFloor);
  for (int k = 0; k < n_emissive; ++k) {
    const float4 l = tb.light[k];
    const float tx = l.x - h.px, ty = l.y - h.py, tz = l.z - h.pz;
    const float d2 = tx * tx + ty * ty + tz * tz;
    const float ldotn = tx * h.nx + ty * h.ny + tz * h.nz;
    if (cull && d2 > kCullMinD2 && d2 <= FLT_MAX &&
        (d2 > l.w ||
         (ldotn < 0.0f && ldotn * ldotn > kh * d2 && l.w <= FLT_MAX)))
      continue;                               // its term is +-0
    const float4 col = tb.light_col[k];
    if (__float_as_int(col.w) == h.idx) continue;   // w = 0: adds trunc(0)
    float w;
    if (fast) {
      const float inv = rsqrtf(max_nan(d2, static_cast<float>(1e-30)));
      w = max_nan(ldotn * inv, 0.0f) * (inv * inv) * kLightScale;
    } else {
      const float dist = sqrtf(d2);
      const float den = max_nan(dist, static_cast<float>(1e-20));
      const float cosang = (tx / den) * h.nx + (ty / den) * h.ny +
                           (tz / den) * h.nz;
      w = max_nan(cosang, 0.0f) /
          max_nan(dist * dist, static_cast<float>(1e-30)) * kLightScale;
    }
    dr = dr + truncf(w * col.x);
    dg = dg + truncf(w * col.y);
    db = db + truncf(w * col.z);
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
