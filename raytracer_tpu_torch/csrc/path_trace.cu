// Whole-trace path kernel for Hopper (sm_90a): one thread per ray.
//
// Replaces raytracer_tpu/core/pallas_path.py::_kernel, both branches
// (reached through trace_path_pallas_impl): unguided, and guided with the
// distilled student inside the kernel (_student_mlp, student_guide_spec)
// for an f32 student.  A bf16 student, the deployed mode, takes
// csrc/path_guided.cu, the student on the tensor cores.
// Semantics are those of raytracer_tpu/trace/path.py::_trace_path_lean_impl,
// op for op: for each level, a nearest-sphere sweep by |t| with in-sweep
// attribute selection; direct light as the sum over emissive spheres of
// trunc(0.3*max(0,cos)/d^2*colour), skipping the hit sphere; a mirror
// reflect, or on a diffuse hit a cosine bounce theta = acos(sqrt(u0)),
// phi = 2*pi*u1 from the level's uniforms, or, guided and where the level's
// fb uniform is below fb_prob, the student's action on the 22-D observation
// (clipped to [-1, 1]; theta = (a0+1)*pi/4, phi = a1*pi); the 0.001 normal
// offset.  Then the reverse fold trunc(albedo * min(255, direct + child) /
// 255), background on a miss.  The level's arithmetic is path_common.cuh's,
// the student's student.cuh's.  The plain PyTorch version beside it is
// core/cuda_path.py::path_trace_plain.
//
// What bounds it on an H100: operations, none of them fused (-fmad=false),
// so at 33.5 T f32 operations/s.  Per ray and level run, the sweep needs 9
// f32 operations a sphere (29 in the chandelier), 9 more for a sphere ahead
// of the ray and 7 more for one the ray meets; a level that continues needs
// 14 a light (21 emissive spheres), 24 more for a light whose term is not
// provably zero, 40 for the hit point, normal, offset and fold and 42 for a
// mirror reflection.  The plain version computes every term, about 1.5 k
// operations a ray-level.  Its IEEE square roots and divides are
// instruction sequences, so the shared level (path_common.cuh) takes the
// sweep's inside test without its square root and skips the lights whose
// term is provably zero.  A guided bounce adds
// the student's 2*(22*128 + 128*128 + 128*2) = 38,912 flops at the shipped
// width, work for the tensor cores (989 TFLOP/s dense bf16) that this first
// kernel does as f32 multiply-adds in the CUDA cores.  Its I/O is 52 bytes a
// ray (origin and direction in; rgb and four counts out), plus, guided,
// 12 bytes a ray-level of uniforms in and 8 bytes of counts out.
// chip_smoke.py counts the bound from each run's data.
//
// Design for that bound: one thread per ray in 128-thread blocks with a
// masked ragged tail; the scene table (sphere rows with their material
// columns, flags, the emissive list, the inside thresholds and light cuts)
// is staged in shared memory once per block; a ray leaves the level loop
// as soon as it terminates; the level records for the fold (16 B a level)
// stay in thread-local storage.  Guided, the student's f32 weights (about
// 80 KB at 22->128->128->2) and one activation tile a warp sit in dynamic
// shared memory, and the grid is cut to the blocks that fit on the card at
// once, each looping over ray tiles, so every block stages the weights
// once.  The MLP runs for the lanes of a warp that take the
// guide at the same level, together, as scalar multiply-adds: in f32 the
// tensor cores' TF32 would change its results.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

#include "path_common.cuh"
#include "student.cuh"

namespace {

constexpr int kMaxBounces = 16;   // core/cuda_path.py MAX_BOUNCES
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

// A ray's level record for the fold, 16 B: the hit sphere's index (-1 on a
// miss) and, on a level that continues, its direct light; the albedo is
// the table's.
struct Level {
  int idx;
  float direct[3];
};

struct Params {
  const float* origins;
  const float* dirs;
  const float* uniforms;      // [L, R, 2] or null (no diffuse bounce)
  const float* fb_uniforms;   // [L, R], guided only
  const float* spheres;
  const int* flags;
  const int* emissive;
  const float* inside;        // PathTable.inside [n_spheres]
  const float* light_cut;     // PathTable.light_cut [n_emissive]
  const float* student;       // packed student (student.cuh), or null
  float* rgb;
  int* counts;                // [R, 4], guided [R, 6]
  long long n_rays;
  int n_spheres, n_emissive, max_bounces, fast;
  float bg_r, bg_g, bg_b, fb_prob;
  student::Dims dims;
};

// Dynamic shared memory of a guided launch: the weights, then one tile a
// warp.
template <typename T>
size_t guided_smem(student::Dims d) {
  return (static_cast<size_t>(student::packed_size(d)) +
          static_cast<size_t>(kWarps) * d.h1 * 32) * sizeof(T);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) path_trace_kernel(Params p) {
  __shared__ path::Table tb;
  extern __shared__ __align__(16) unsigned char s_dyn[];
  path::stage(tb, p.spheres, p.flags, p.emissive, p.inside, p.light_cut,
              p.n_spheres, p.n_emissive, p.fast);
  const bool guided = p.student != nullptr;
  T* s_w = reinterpret_cast<T*>(s_dyn);
  T* s_tile = nullptr;
  if (guided) {
    const int nw = student::packed_size(p.dims);
    for (int k = threadIdx.x; k < nw; k += blockDim.x)
      s_w[k] = student::from_f<T>(p.student[k]);
    s_tile = s_w + nw + (threadIdx.x / 32) * p.dims.h1 * 32;
    __syncthreads();
  }
  const int lane = threadIdx.x % 32;
  const long long n_rays = p.n_rays;
  const float kOffset = static_cast<float>(0.001);
  const float kPi = static_cast<float>(3.141592653589793);

  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n_rays; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float ox = p.origins[3 * i], oy = p.origins[3 * i + 1],
          oz = p.origins[3 * i + 2];
    float dx = p.dirs[3 * i], dy = p.dirs[3 * i + 1], dz = p.dirs[3 * i + 2];
    path::normalise3(dx, dy, dz);

    Level rec[kMaxBounces];
    int n_run = 0, n_found = 0, n_emis = 0, n_small = 0, n_fb = 0;
    int n_levels = 0;
    bool running = true;

    for (int lvl = 0; lvl < p.max_bounces; ++lvl) {
      ++n_run;
      n_levels = lvl + 1;
      const path::Hit h = path::sweep(tb, p.n_spheres, ox, oy, oz, dx, dy,
                                      dz);
      if (!h.found) {
        rec[lvl] = Level{-1, {0.0f, 0.0f, 0.0f}};
        running = false;
        break;
      }
      ++n_found;
      if (h.flags & path::kFlagSmall) ++n_small;
      const float* sp = tb.sph + h.idx * path::kRow;
      if (h.flags & path::kFlagEmissive) {
        ++n_emis;
        rec[lvl] = Level{h.idx, {0.0f, 0.0f, 0.0f}};
        running = false;
        break;
      }

      float dr, dg, db;
      path::direct_light(tb, p.n_emissive, h, p.fast, dr, dg, db);
      // The plain version computes the reflection on every lane and keeps
      // it where no diffuse direction replaces it; only those lanes need it.
      float rx, ry, rz;
      const bool mirror = (h.flags & path::kFlagMirror) != 0;
      if (mirror || p.uniforms == nullptr) {
        path::reflect(dx, dy, dz, h.nx, h.ny, h.nz, rx, ry, rz);
      } else {
        const long long at = static_cast<long long>(lvl) * n_rays + i;
        const bool use_fb = guided && p.fb_uniforms[at] < p.fb_prob;
        if (use_fb) {
          ++n_fb;
          // make_observation: colour 0, through 0, pads 0.5.
          const float obs[student::kObs] = {
              h.px, h.py, h.pz, dx, dy, dz, h.nx, h.ny, h.nz,
              sp[7], sp[8], sp[9], sp[10], 0.0f, 0.0f, 0.0f,
              static_cast<float>(lvl) / static_cast<float>(p.max_bounces),
              0.0f, sp[11] / 100.0f, 0.5f, 0.5f, 0.5f};
          float a0, a1;
          student::forward<T>(s_w, s_tile, p.dims, obs, lane, a0, a1);
          a0 = path::clamp_nan(a0, -1.0f, 1.0f);
          a1 = path::clamp_nan(a1, -1.0f, 1.0f);
          path::local_to_world((a0 + 1.0f) * kPi / 4.0f, a1 * kPi, h.nx,
                               h.ny, h.nz, rx, ry, rz);
        } else {
          const float* u = p.uniforms + 2 * at;
          path::cosine_bounce(u[0], u[1], h.nx, h.ny, h.nz, rx, ry, rz);
        }
      }

      ox = h.px + h.nx * kOffset;
      oy = h.py + h.ny * kOffset;
      oz = h.pz + h.nz * kOffset;
      dx = rx;
      dy = ry;
      dz = rz;
      rec[lvl] = Level{h.idx, {dr, dg, db}};
    }
    // A ray still running after the last level makes one more trace() call
    // that the reference counts before its bounce-budget return.
    if (running) ++n_run;

    float v[3] = {p.bg_r, p.bg_g, p.bg_b};
    bool ended_on_light = false;
    for (int lvl = n_levels - 1; lvl >= 0; --lvl) {
      const int s = rec[lvl].idx;
      const float* a = tb.sph + (s < 0 ? 0 : s) * path::kRow + 4;  // albedo
      const bool light = s >= 0 && (tb.flags[s] & path::kFlagEmissive);
      if (lvl == n_levels - 1) ended_on_light = light;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        if (s < 0)
          v[c] = c == 0 ? p.bg_r : (c == 1 ? p.bg_g : p.bg_b);
        else if (light)
          v[c] = a[c];
        else
          v[c] = truncf(a[c] * fminf(255.0f, rec[lvl].direct[c] + v[c]) /
                        255.0f);
      }
    }
    const float vr = v[0], vg = v[1], vb = v[2];
    p.rgb[3 * i] = vr;
    p.rgb[3 * i + 1] = vg;
    p.rgb[3 * i + 2] = vb;
    const int nc = guided ? 6 : 4;
    int* c = p.counts + nc * i;
    c[0] = n_run;
    c[1] = n_found;
    c[2] = n_emis;
    c[3] = n_small;
    if (guided) {
      // fb_success: the lane's guided bounces, if it ended on a light.
      c[4] = n_fb;
      c[5] = ended_on_light ? n_fb : 0;
    }
  }
}

template <typename T>
int launch(const Params& p, cudaStream_t stream) {
  const long long blocks = (p.n_rays + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  unsigned grid = static_cast<unsigned>(blocks);
  size_t smem = 0;
  if (p.student != nullptr) {
    smem = guided_smem<T>(p.dims);
    cudaError_t err = cudaFuncSetAttribute(
        path_trace_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    // As many blocks as fit on the card at once, each staging the weights
    // once and looping over ray tiles.
    int device = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&device)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      device)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, path_trace_kernel<T>, kThreads, smem)) != cudaSuccess)
      return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    const long long fit = static_cast<long long>(sms) * per_sm;
    if (fit < blocks) grid = static_cast<unsigned>(fit);
  }
  path_trace_kernel<T><<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns a cudaError_t: cudaErrorInvalidValue for arguments beyond the
// compile-time capacities, else the launch's status.  student: null
// (unguided), or the packed f32 student with its dims (n_hidden 1 or 2,
// padded widths h1, h2).  A bf16 student takes csrc/path_guided.cu.
extern "C" int path_trace_launch(
    const float* origins, const float* dirs, const float* uniforms,
    const float* fb_uniforms, float fb_prob, const float* spheres,
    const int* flags, const int* emissive, const float* inside,
    const float* light_cut, int n_spheres, int n_emissive, long long n_rays,
    int max_bounces, float bg_r, float bg_g, float bg_b, int fast,
    const float* student, int n_hidden, int h1, int h2, float* rgb,
    int* counts, void* stream) {
  if (n_spheres < 1 || n_spheres > path::kMaxSpheres || n_emissive < 0 ||
      n_emissive > path::kMaxEmissive || max_bounces < 1 ||
      max_bounces > kMaxBounces || n_rays < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (student != nullptr &&
      (uniforms == nullptr || fb_uniforms == nullptr || n_hidden < 1 ||
       n_hidden > 2 || h1 < 8 || h1 > student::kMaxWidth || h1 % 8 != 0 ||
       (n_hidden == 2 &&
        (h2 < 8 || h2 > student::kMaxWidth || h2 % 8 != 0))))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rays == 0) return static_cast<int>(cudaSuccess);
  Params p{origins, dirs, uniforms, fb_uniforms, spheres, flags, emissive,
           inside, light_cut, student, rgb, counts, n_rays, n_spheres,
           n_emissive, max_bounces, fast, bg_r, bg_g, bg_b, fb_prob,
           student::Dims{n_hidden, h1, n_hidden == 2 ? h2 : 0}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return launch<float>(p, s);
}
