// Guided whole-trace path kernel for Hopper (sm_90a), bf16 students: the
// student on the tensor cores over the lanes of a warp that take the guide.
//
// Replaces raytracer_tpu/core/pallas_path.py::_kernel's guided branch
// (_student_mlp, student_guide_spec, the gate; reached through
// trace_path_pallas_impl) for a student that runs in bf16, the deployed
// mode (fb/registry.py::guide_for).  An f32 student and the unguided trace
// stay on csrc/path_trace.cu.  Semantics are path_trace.cu's guided
// branch, op for op: the level arithmetic is path_common.cuh's (sweep,
// direct light, reflect, cosine bounce, local_to_world, offset), the
// 22-D observation, the gate (fb_u < fb_prob on a non-mirror diffuse hit),
// the clamps and the reverse fold are the same code; the student is
// student_mma.cuh's, whose rounding is student.cuh's bf16 mode.  The plain
// PyTorch version beside it is core/cuda_path.py::path_trace_plain.
//
// What bounds it on an H100: operations.  About 1.5 k f32 operations a
// ray-level for the sweep, direct light and bounce (path_trace.cu's note),
// and the student's 2*(22*128 + 128*128 + 128*2) = 38,912 flops a guided
// ray-level at the shipped width, tensor-core work (989 TFLOP/s dense
// bf16).  chip_smoke.py counts both from each run's data.
//
// Design for that bound: a persistent grid (the blocks that fit on the card
// at once, each staging the packed weights into shared memory once); each
// warp walks over 32-ray tiles, taking the next from a global counter when
// it finishes one, and over the levels of a tile in a loop that every lane
// takes, a lane carrying a running flag, until no lane of the warp runs.
// At each level the lanes that take the guide are counted with
// __ballot_sync and packed: a guided lane writes its observation as
// row popc(ballot & lanemask_lt) of the warp's [32 x 32] bf16 tile, every
// other lane (finished, past the ragged tail, or not guided) a zero row
// after them; the warp runs one 16-row m-tile of mma.sync per 16 guided
// lanes (none when no lane is guided), and each guided lane takes its
// action from the lane that holds its output row, by shuffle.  A hidden
// layer's epilogue (round, bias, round, ReLU) runs on packed bf16x2 pairs.
//
// Occupancy is what the sweep, latency-bound, needs most, and the weights
// set it: the block holds them once (bf16, 43.5 KB at 22->128->128->2) and
// a 2 KB tile a warp in dynamic shared memory, so 14 warps share them and
// two blocks (28 warps) fit on an SM, at 72 registers a thread with a few
// hundred bytes spilled to L1.  On the H100 that beat 4 blocks of 4 warps
// at 120 registers by ~20% and 2 blocks of 16 warps at 64 registers by
// ~3-5% (raytracer_tpu_torch/tools/guided_variants.py; PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "path_common.cuh"
#include "student_mma.cuh"

namespace {

constexpr int kMaxBounces = 16;   // core/cuda_path.py MAX_BOUNCES
constexpr int kThreads = 448;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 2;     // resident blocks an SM: 28 warps

constexpr unsigned char kMiss = 1;
constexpr unsigned char kEmissive = 2;
constexpr unsigned char kContinue = 3;

struct Level {
  float ar, ag, ab, dr, dg, db;
};

struct Params {
  const float* origins;
  const float* dirs;
  const float* uniforms;      // [L, R, 2]
  const float* fb_uniforms;   // [L, R]
  const float* spheres;
  const int* flags;
  const int* emissive;
  const float* inside;        // PathTable.inside [n_spheres]
  const float* light_cut;     // PathTable.light_cut [n_emissive]
  const __nv_bfloat16* student;   // packed (student_mma.cuh)
  float* rgb;
  int* counts;                // [R, 6]
  unsigned long long* next_tile;   // tiles handed out, 0 at launch
  long long n_rays;
  int n_spheres, n_emissive, max_bounces, fast;
  float bg_r, bg_g, bg_b, fb_prob;
  smma::Dims dims;
};

// Dynamic shared memory: the weights, then one tile a warp.
size_t guided_smem(smma::Dims d) {
  return (static_cast<size_t>(smma::packed_size(d)) +
          static_cast<size_t>(kWarps) * smma::kTileElems) *
         sizeof(__nv_bfloat16);
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
    path_guided_kernel(Params p) {
  __shared__ path::Table tb;
  extern __shared__ __align__(16) unsigned char s_dyn[];
  __nv_bfloat16* s_w = reinterpret_cast<__nv_bfloat16*>(s_dyn);
  const int nw = smma::packed_size(p.dims);   // a multiple of 8
  {
    const uint4* src = reinterpret_cast<const uint4*>(p.student);
    uint4* dst = reinterpret_cast<uint4*>(s_w);
    for (int k = threadIdx.x; k < nw / 8; k += blockDim.x) dst[k] = src[k];
  }
  path::stage(tb, p.spheres, p.flags, p.emissive, p.inside, p.light_cut,
              p.n_spheres, p.n_emissive, p.fast);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __nv_bfloat16* s_tile = s_w + nw + warp * smma::kTileElems;
  const unsigned lanes_below = (1u << lane) - 1u;
  const long long n_rays = p.n_rays;
  const long long n_tiles = (n_rays + 31) / 32;
  const float kOffset = static_cast<float>(0.001);
  const float kPi = static_cast<float>(3.141592653589793);

  // Every loop below is taken by the whole warp.  A warp's first tile is
  // its own, every next one is handed out in order by one atomic.
  const long long first_free = static_cast<long long>(gridDim.x) * kWarps;
  long long tile = static_cast<long long>(blockIdx.x) * kWarps + warp;
  while (tile < n_tiles) {
    unsigned long long next = 0;
    if (lane == 0) next = atomicAdd(p.next_tile, 1ull);
    next = __shfl_sync(smma::kFull, next, 0);
    const long long i = tile * 32 + lane;
    const bool valid = i < n_rays;
    float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f;
    if (valid) {
      ox = p.origins[3 * i];
      oy = p.origins[3 * i + 1];
      oz = p.origins[3 * i + 2];
      dx = p.dirs[3 * i];
      dy = p.dirs[3 * i + 1];
      dz = p.dirs[3 * i + 2];
      path::normalise3(dx, dy, dz);
    }

    unsigned char kind[kMaxBounces];
    Level rec[kMaxBounces];
    int n_run = 0, n_found = 0, n_emis = 0, n_small = 0, n_fb = 0;
    int n_levels = 0;
    bool running = valid;

    for (int lvl = 0; lvl < p.max_bounces; ++lvl) {
      if (!__any_sync(smma::kFull, running)) break;
      bool use_fb = false;
      path::Hit h{};
      const float* sp = tb.sph;
      float dr = 0.0f, dg = 0.0f, db = 0.0f;
      float rx = 0.0f, ry = 0.0f, rz = 0.0f;
      if (running) {
        ++n_run;
        n_levels = lvl + 1;
        h = path::sweep(tb, p.n_spheres, ox, oy, oz, dx, dy, dz);
        if (!h.found) {
          kind[lvl] = kMiss;
          running = false;
        } else {
          ++n_found;
          if (h.flags & path::kFlagSmall) ++n_small;
          sp = tb.sph + h.idx * path::kRow;
          if (h.flags & path::kFlagEmissive) {
            ++n_emis;
            kind[lvl] = kEmissive;
            rec[lvl].ar = sp[4];
            rec[lvl].ag = sp[5];
            rec[lvl].ab = sp[6];
            running = false;
          } else {
            path::direct_light(tb, p.n_emissive, h, p.fast, dr, dg, db);
            path::reflect(dx, dy, dz, h.nx, h.ny, h.nz, rx, ry, rz);
            if (!(h.flags & path::kFlagMirror)) {
              const long long at = static_cast<long long>(lvl) * n_rays + i;
              use_fb = p.fb_uniforms[at] < p.fb_prob;
              if (!use_fb) {
                const float* u = p.uniforms + 2 * at;
                path::cosine_bounce(u[0], u[1], h.nx, h.ny, h.nz, rx, ry,
                                    rz);
              }
            }
          }
        }
      }

      const unsigned guided = __ballot_sync(smma::kFull, use_fb);
      if (guided != 0u) {
        // Pack: guided lanes first, in lane order, then zero rows.
        const int n = __popc(guided);
        const int row = use_fb ? __popc(guided & lanes_below)
                               : n + __popc(~guided & lanes_below);
        // make_observation: colour 0, through 0, pads 0.5.
        const float obs[student::kObs] = {
            h.px, h.py, h.pz, dx, dy, dz, h.nx, h.ny, h.nz,
            sp[7], sp[8], sp[9], sp[10], 0.0f, 0.0f, 0.0f,
            static_cast<float>(lvl) / static_cast<float>(p.max_bounces),
            0.0f, sp[11] / 100.0f, 0.5f, 0.5f, 0.5f};
        smma::store_row(s_tile, row, obs, use_fb);
        __syncwarp();
        float a0, a1;
        smma::forward(s_w, s_tile, p.dims, n, row, lane, a0, a1);
        __syncwarp();   // the tile is rewritten at the next level
        if (use_fb) {
          ++n_fb;
          a0 = path::clamp_nan(a0, -1.0f, 1.0f);
          a1 = path::clamp_nan(a1, -1.0f, 1.0f);
          path::local_to_world((a0 + 1.0f) * kPi / 4.0f, a1 * kPi, h.nx,
                               h.ny, h.nz, rx, ry, rz);
        }
      }

      if (running) {
        ox = h.px + h.nx * kOffset;
        oy = h.py + h.ny * kOffset;
        oz = h.pz + h.nz * kOffset;
        dx = rx;
        dy = ry;
        dz = rz;
        kind[lvl] = kContinue;
        rec[lvl] = Level{sp[4], sp[5], sp[6], dr, dg, db};
      }
    }
    if (valid) {
      // A ray still running after the last level makes one more trace()
      // call that the reference counts before its bounce-budget return.
      if (running) ++n_run;
      float vr = p.bg_r, vg = p.bg_g, vb = p.bg_b;
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
          vr = p.bg_r;
          vg = p.bg_g;
          vb = p.bg_b;
        }
      }
      p.rgb[3 * i] = vr;
      p.rgb[3 * i + 1] = vg;
      p.rgb[3 * i + 2] = vb;
      int* c = p.counts + 6 * i;
      c[0] = n_run;
      c[1] = n_found;
      c[2] = n_emis;
      c[3] = n_small;
      // fb_success: the lane's guided bounces, if it ended on a light.
      c[4] = n_fb;
      c[5] = (kind[n_levels - 1] == kEmissive) ? n_fb : 0;
    }
    tile = first_free + static_cast<long long>(next);
  }
}

// Shared memory and resident blocks an SM of a launch with these dims.
cudaError_t occupancy(smma::Dims d, size_t& smem, int& per_sm) {
  smem = guided_smem(d);
  cudaError_t err = cudaFuncSetAttribute(
      path_guided_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, path_guided_kernel, kThreads, smem);
}

bool dims_ok(int n_hidden, int h1, int h2) {
  const auto width_ok = [](int h) {
    return h >= 16 && h <= student::kMaxWidth && h % 16 == 0;
  };
  return (n_hidden == 1 || n_hidden == 2) && width_ok(h1) &&
         (n_hidden == 1 || width_ok(h2));
}

}  // namespace

// Returns a cudaError_t: cudaErrorInvalidValue for arguments beyond the
// compile-time capacities or a misaligned student, else the launch's
// status.  student: the packed bf16 student (core/cuda_path.py::
// pack_student_mma) with n_hidden 1 or 2 and padded widths h1, h2;
// next_tile: one zeroed counter the kernel's warps take tiles from.
extern "C" int path_guided_launch(
    const float* origins, const float* dirs, const float* uniforms,
    const float* fb_uniforms, float fb_prob, const float* spheres,
    const int* flags, const int* emissive, const float* inside,
    const float* light_cut, int n_spheres, int n_emissive, long long n_rays,
    int max_bounces, float bg_r, float bg_g, float bg_b, int fast,
    const void* student, int n_hidden, int h1, int h2, float* rgb,
    int* counts, unsigned long long* next_tile, void* stream) {
  if (n_spheres < 1 || n_spheres > path::kMaxSpheres || n_emissive < 0 ||
      n_emissive > path::kMaxEmissive || max_bounces < 1 ||
      max_bounces > kMaxBounces || n_rays < 0 || uniforms == nullptr ||
      fb_uniforms == nullptr || student == nullptr || next_tile == nullptr ||
      reinterpret_cast<uintptr_t>(student) % 16 != 0 ||
      !dims_ok(n_hidden, h1, h2))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rays == 0) return static_cast<int>(cudaSuccess);
  const smma::Dims dims{n_hidden, h1, n_hidden == 2 ? h2 : 0};
  size_t smem = 0;
  int per_sm = 0, device = 0, sms = 0;
  cudaError_t err;
  if ((err = occupancy(dims, smem, per_sm)) != cudaSuccess ||
      (err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess)
    return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  // As many blocks as fit on the card at once, each staging the weights
  // once and its warps looping over 32-ray tiles.
  const long long tiles = (n_rays + 31) / 32;
  const long long blocks = (tiles + kWarps - 1) / kWarps;
  const long long fit = static_cast<long long>(sms) * per_sm;
  const unsigned grid = static_cast<unsigned>(blocks < fit ? blocks : fit);
  Params p{origins, dirs, uniforms, fb_uniforms, spheres, flags, emissive,
           inside, light_cut, static_cast<const __nv_bfloat16*>(student), rgb,
           counts, next_tile, n_rays, n_spheres, n_emissive, max_bounces,
           fast, bg_r, bg_g, bg_b, fb_prob, dims};
  path_guided_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(
                                                 stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The launch's dynamic shared memory in bytes and its resident blocks an
// SM, for a student of these dims (reported by chip_smoke.py).
extern "C" int path_guided_occupancy(int n_hidden, int h1, int h2,
                                     long long* smem_bytes,
                                     int* blocks_per_sm) {
  if (!dims_ok(n_hidden, h1, h2))
    return static_cast<int>(cudaErrorInvalidValue);
  size_t smem = 0;
  int per_sm = 0;
  const cudaError_t err =
      occupancy(smma::Dims{n_hidden, h1, n_hidden == 2 ? h2 : 0}, smem,
                per_sm);
  *smem_bytes = static_cast<long long>(smem);
  *blocks_per_sm = per_sm;
  return static_cast<int>(err);
}
