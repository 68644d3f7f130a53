// Whitted terminal shading for Hopper (sm_90a): one thread per terminus,
// its shadow sweeps inside.
//
// Replaces no pallas_call: the JAX package shades in plain jnp
// (raytracer_tpu/trace/shade.py::terminal_rgb), with one nearest_hit_pallas
// launch a point light for the shadow sweeps.  The port ran the same as
// ~150 PyTorch passes over the wavefront, three nearest-hit launches and
// host reads of the lights and the table a frame, about two thirds of the
// planets2 frame's device time; this kernel does all of it in one launch.
// Semantics: raytracer_tpu_torch/trace/shade.py::terminal_rgb with
// shadow_max_bounces == 0 (every reference call site) and the misses'
// colour of render/renderer.py::shade_flat, in their order of operations:
// the emissive term albedo * emitive; each global light's linear angular
// falloff of the angle between the normal and its vector, times its
// strength; each point light's shadow ray from the terminus toward it
// (the direction normalised as vec.normalise_safe_c does), swept by signed
// t with the shaded sphere's id suppressed (csrc/sphere.cuh::sweep, the
// code nearest_hit.cu runs, so its hits are that kernel's), ending in none
// on a glass blocker (transparent == 1 and reflective != 1), lit only if
// it ends on the sphere carrying the light's id and that is not the shaded
// sphere's own, its falloff divided by the distance where func == 0; each
// light's term added in light order; then background + rint(albedo *
// light / 255) a channel, and the miss colour where nothing was hit.  The
// plain PyTorch version is terminal_rgb(impl="plain").
//
// Rounding: as in sphere.cuh (-fmad=false, IEEE sqrt and division,
// NaN-propagating clamps), so each multiply and add rounds on its own as
// the plain version's separate passes do; acosf is the CUDA math
// library's, which ATen's acos calls; rintf rounds half to even, as
// torch.round does; constants are (float)<double>.
//
// What bounds it on an H100: operations.  Per terminus it reads hit, idx,
// point and normal (29 bytes) and writes RGB (12 bytes): 41 bytes, 164 MB
// at planets2 2001x2001, 0.049 ms at 3.35 TB/s.  Its arithmetic: ~45 f32
// operations a global light (the dot, the light's norm, the cosine, acos,
// the falloff), ~230 a point light (the direction and its normalisation,
// the sweep over the scene's 10 spheres at 9 operations a sphere test, 9
// more in front of the ray and 7 more for a valid sphere, the angle, the
// falloff and the distance), ~15 for the rounding: ~760 a terminus on
// planets2 (three point lights, a global light), 3.0 G operations, ~0.09
// ms at 33.5 T/s without fused multiply-adds.  So operations bound it, at
// about twice its bytes.
//
// Design for that bound: one thread per terminus, 128-thread blocks with a
// masked ragged tail; the scene table staged in shared memory once per
// block as sphere.cuh lays it out, its size set at launch, so one build
// serves any scene of 1 to 1024 spheres; the sweep runs in registers
// against it, each sphere's row one shared-memory broadcast to the warp;
// the lights and the scene's colour columns are read through the read-only
// cache, where every thread of a warp reads the same light.  Work that
// cannot change an output is skipped: a miss writes the miss colour and
// nothing more; a point light carrying the shaded sphere's id is not
// swept; the angle, falloff and distance of a point light are computed
// only for a lit terminus (the plain version computes them everywhere and
// zeroes them, then adds the zero, as this kernel adds its 0.0f).
// Everything between the 29 bytes in and the 12 out stays in registers.

#include "sphere.cuh"

namespace {

using sphere::clamp_nan;
using sphere::max_nan;

constexpr int kThreads = 128;
constexpr int kNoId = INT_MIN + 1;   // trace/shade.py NO_ID

// The scene's own columns, indexed by sphere: colour [N, 3], emitive,
// transparent and reflective [N].
struct Materials {
  const float* colour;
  const float* emitive;
  const float* transparent;
  const float* reflective;
};

// The lights as GlobalLights and PointLights hold them.
struct Lights {
  const float* g_vector;     // [G, 3]
  const float* g_colour;     // [G, 3]
  const float* g_strength;   // [G]
  const float* g_max_angle;  // [G]
  int n_global;
  const int* p_id;           // [P]
  const float* p_position;   // [P, 3]
  const float* p_colour;     // [P, 3]
  const float* p_strength;   // [P]
  const float* p_max_angle;  // [P]
  const int* p_func;         // [P]
  int n_point;
};

// vec.angle_between_c from the dot product and both norms, then incidence
// (the linear falloff) times the strength.
__device__ __forceinline__ float falloff(float dot, float mag_n, float mag_l,
                                        float max_angle, float strength) {
  const float c = dot / (mag_n * mag_l);
  const float angle = acosf(clamp_nan(c, -1.0f, 1.0f));
  const float rel = angle > max_angle ? 0.0f
                                      : (max_angle - angle) / max_angle;
  return rel * strength;
}

__global__ void __launch_bounds__(kThreads)
whitted_shade_kernel(const bool* __restrict__ hit,
                     const int* __restrict__ idx,
                     const float* __restrict__ point,
                     const float* __restrict__ normal,
                     const float* __restrict__ spheres,
                     const int* __restrict__ ids, int n_spheres,
                     Materials mat, Lights li, float3 background, float3 miss,
                     long long n_rays, float* __restrict__ rgb) {
  extern __shared__ float4 s_mem[];
  const sphere::Table tb = sphere::carve(s_mem, n_spheres);
  sphere::stage(tb, spheres, ids, n_spheres, false);
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n_rays) return;

  float out_r = miss.x, out_g = miss.y, out_b = miss.z;
  const bool is_hit = hit[i];
  const int s = is_hit ? idx[i] : 0;
  if (is_hit && (s < 0 || s >= n_spheres)) {
    // Not a sphere of this table: the plain version's gather raises.
    out_r = out_g = out_b = __int_as_float(0x7fc00000);
  } else if (is_hit) {
    const float px = point[3 * i], py = point[3 * i + 1],
                pz = point[3 * i + 2];
    const float nx = normal[3 * i], ny = normal[3 * i + 1],
                nz = normal[3 * i + 2];
    const float alb_r = __ldg(mat.colour + 3 * s);
    const float alb_g = __ldg(mat.colour + 3 * s + 1);
    const float alb_b = __ldg(mat.colour + 3 * s + 2);
    const float emit = __ldg(mat.emitive + s);
    float il_r = alb_r * emit, il_g = alb_g * emit, il_b = alb_b * emit;
    const float mag_n = sqrtf(nx * nx + ny * ny + nz * nz);

    for (int k = 0; k < li.n_global; ++k) {
      const float gx = __ldg(li.g_vector + 3 * k);
      const float gy = __ldg(li.g_vector + 3 * k + 1);
      const float gz = __ldg(li.g_vector + 3 * k + 2);
      const float rel = falloff(nx * gx + ny * gy + nz * gz, mag_n,
                                sqrtf(gx * gx + gy * gy + gz * gz),
                                __ldg(li.g_max_angle + k),
                                __ldg(li.g_strength + k));
      il_r = il_r + rel * __ldg(li.g_colour + 3 * k);
      il_g = il_g + rel * __ldg(li.g_colour + 3 * k + 1);
      il_b = il_b + rel * __ldg(li.g_colour + 3 * k + 2);
    }

    const int self_id = tb.id[s];
    for (int k = 0; k < li.n_point; ++k) {
      const int light_id = __ldg(li.p_id + k);
      const float tx = __ldg(li.p_position + 3 * k) - px;
      const float ty = __ldg(li.p_position + 3 * k + 1) - py;
      const float tz = __ldg(li.p_position + 3 * k + 2) - pz;
      float rel = 0.0f;
      if (self_id != light_id) {
        const float mag_t = sqrtf(tx * tx + ty * ty + tz * tz);
        const float m = max_nan(mag_t, static_cast<float>(1e-20));
        const sphere::Hit h = sphere::sweep(tb, n_spheres, px, py, pz,
                                            tx / m, ty / m, tz / m, self_id,
                                            false);
        const bool glass = __ldg(mat.transparent + h.idx) == 1.0f &&
                           __ldg(mat.reflective + h.idx) != 1.0f;
        const int terminus = h.found && !glass ? tb.id[h.idx] : kNoId;
        if (terminus == light_id) {
          rel = falloff(nx * tx + ny * ty + nz * tz, mag_n, mag_t,
                        __ldg(li.p_max_angle + k), __ldg(li.p_strength + k));
          if (__ldg(li.p_func + k) == 0) rel = rel / mag_t;
        }
      }
      il_r = il_r + rel * __ldg(li.p_colour + 3 * k);
      il_g = il_g + rel * __ldg(li.p_colour + 3 * k + 1);
      il_b = il_b + rel * __ldg(li.p_colour + 3 * k + 2);
    }

    out_r = background.x + rintf((alb_r * il_r) / 255.0f);
    out_g = background.y + rintf((alb_g * il_g) / 255.0f);
    out_b = background.z + rintf((alb_b * il_b) / 255.0f);
  }
  rgb[3 * i] = out_r;
  rgb[3 * i + 1] = out_g;
  rgb[3 * i + 2] = out_b;
}

}  // namespace

// Returns a cudaError_t: cudaErrorInvalidValue for arguments the kernel does
// not take, else cudaGetLastError() after the launch.
extern "C" int whitted_shade_launch(
    const bool* hit, const int* idx, const float* point, const float* normal,
    const float* spheres, const int* ids, int n_spheres,
    const float* colour, const float* emitive, const float* transparent,
    const float* reflective, const float* g_vector, const float* g_colour,
    const float* g_strength, const float* g_max_angle, int n_global,
    const int* p_id, const float* p_position, const float* p_colour,
    const float* p_strength, const float* p_max_angle, const int* p_func,
    int n_point, float bg_r, float bg_g, float bg_b, float miss_r,
    float miss_g, float miss_b, long long n_rays, float* rgb, void* stream) {
  const size_t smem = static_cast<size_t>(n_spheres) * sphere::kStagedBytes;
  if (n_spheres < 1 || smem > 48 * 1024 || n_rays < 0 || n_global < 0 ||
      n_point < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rays == 0) return static_cast<int>(cudaSuccess);
  const long long blocks = (n_rays + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const Materials mat{colour, emitive, transparent, reflective};
  const Lights li{g_vector, g_colour, g_strength, g_max_angle, n_global,
                  p_id,     p_position, p_colour, p_strength, p_max_angle,
                  p_func,   n_point};
  whitted_shade_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      hit, idx, point, normal, spheres, ids, n_spheres, mat, li,
      make_float3(bg_r, bg_g, bg_b), make_float3(miss_r, miss_g, miss_b),
      n_rays, rgb);
  return static_cast<int>(cudaGetLastError());
}
