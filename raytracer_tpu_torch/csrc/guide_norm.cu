// The full FB agent's elementwise passes for Hopper (sm_90a): one warp a
// row.
//
// The f32 guide (fb/fused_guide.py) calls torch.matmul for each product and
// then this kernel on the product's raw output y [R, D], D = 128, 256 or 512,
// in place:
//
//   out = post(LN?(y + bias))
//
// LN? is flax's LayerNorm (fb/networks.py::LayerNorm): mean = E[x],
// var = max(0, E[x^2] - mean^2), then (x - mean) * (rsqrt(var + 1e-6) *
// scale) + bias; post is the identity, ReLU, or + residual.  The module path
// writes each of these steps to device memory (about nine passes a
// LayerNorm); here the row stays in registers and y is read and written once.
// The plain PyTorch version beside it is core/cuda_norm.py::guide_norm_plain.
// It replaces no Pallas kernel: the JAX package leaves the guide to XLA,
// which fuses these passes into its own kernels; PyTorch runs each op as a
// pass over device memory, which took half the guide's device time.
//
// Every rounding is the plain ops' own, in their order (-fmad=false: no
// multiply-add contracts): the bias add, x * x, x - mean, the two products
// and the LayerNorm bias add, ReLU as ATen's clamp_min (NaN passes), the
// residual add.  The two row sums take the order of ATen's CUDA reduce for
// a mean over the last, contiguous axis (Reduce.cuh, vectorised input; read
// off PyTorch 2.11's outputs on an H100 at widths 128, 256 and 512): lane t
// loads the float4s t, t + 32, ..., keeps one accumulator a component, joins
// them in order, then the warp sums by shfl_down at offsets 16, 8, 4, 2, 1
// and lane 0's sum is scaled by 1/D.  So the kernel equals the plain version
// bit for bit while ATen keeps that order.
//
// What bounds it on an H100: bytes.  A row reads 4D bytes of y (and 4D of
// the residual) and writes 4D at 3.35 TB/s; at [160,000, 512] that is
// 0.196 ms, 0.293 ms with a residual.  Design: 256-thread blocks, a warp a
// row in a grid-stride loop, the bias and LayerNorm parameters held in
// registers across rows, 128-bit loads and stores.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarp * kWarpsPerBlock;
constexpr unsigned kAll = 0xffffffffu;

enum Post { kNone = 0, kRelu = 1, kResidual = 2 };

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float4 mul4(float4 a, float4 b) {
  return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
}

// torch.relu_ is clamp_min(x, 0): NaN passes, otherwise fmaxf.
__device__ __forceinline__ float relu1(float v) {
  return isnan(v) ? v : fmaxf(v, 0.0f);
}

// The row's sum of v, in ATen's order (above), on every lane.
template <int K>
__device__ __forceinline__ float row_sum(const float4 (&v)[K]) {
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
  for (int k = 0; k < K; ++k) acc = add4(acc, v[k]);
  float s = acc.x;
  s = s + acc.y;
  s = s + acc.z;
  s = s + acc.w;
#pragma unroll
  for (int offset = kWarp / 2; offset > 0; offset >>= 1)
    s = s + __shfl_down_sync(kAll, s, offset);
  return __shfl_sync(kAll, s, 0);
}

template <int K, bool LN, int POST>
__global__ void __launch_bounds__(kThreads)
guide_norm_kernel(const float* y, const float* __restrict__ bias,
                  const float* __restrict__ scale,
                  const float* __restrict__ ln_bias,
                  const float* __restrict__ residual, float* out,
                  long long rows) {
  constexpr int D = K * 4 * kWarp;
  constexpr float kInvD = 1.0f / D;  // a power of two: exact, as ATen's
  const int lane = threadIdx.x % kWarp;
  float4 b[K], s[K], lb[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = lane + k * kWarp;
    b[k] = __ldg(reinterpret_cast<const float4*>(bias) + c);
    if (LN) {
      s[k] = __ldg(reinterpret_cast<const float4*>(scale) + c);
      lb[k] = __ldg(reinterpret_cast<const float4*>(ln_bias) + c);
    }
  }
  const long long step = static_cast<long long>(gridDim.x) * kWarpsPerBlock;
  for (long long row = static_cast<long long>(blockIdx.x) * kWarpsPerBlock +
                       threadIdx.x / kWarp;
       row < rows; row += step) {
    const float4* yr = reinterpret_cast<const float4*>(y + row * D);
    float4 v[K], r[K];
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = yr[lane + k * kWarp];
    if (POST == kResidual) {
      const float4* rr = reinterpret_cast<const float4*>(residual + row * D);
#pragma unroll
      for (int k = 0; k < K; ++k) r[k] = __ldg(rr + lane + k * kWarp);
    }
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = add4(v[k], b[k]);
    if (LN) {
      float4 sq[K];
#pragma unroll
      for (int k = 0; k < K; ++k) sq[k] = mul4(v[k], v[k]);
      const float mean = row_sum<K>(v) * kInvD;
      const float mean2 = row_sum<K>(sq) * kInvD;
      float var = mean2 - mean * mean;
      var = isnan(var) ? var : fmaxf(var, 0.0f);
      const float inv = rsqrtf(var + 1e-6f);
      const float4 m4 = make_float4(mean, mean, mean, mean);
      const float4 i4 = make_float4(inv, inv, inv, inv);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float4 d = make_float4(v[k].x - m4.x, v[k].y - m4.y,
                                     v[k].z - m4.z, v[k].w - m4.w);
        v[k] = add4(mul4(d, mul4(i4, s[k])), lb[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (POST == kRelu)
        v[k] = make_float4(relu1(v[k].x), relu1(v[k].y), relu1(v[k].z),
                           relu1(v[k].w));
      else if (POST == kResidual)
        v[k] = add4(v[k], r[k]);
    }
    float4* orow = reinterpret_cast<float4*>(out + row * D);
#pragma unroll
    for (int k = 0; k < K; ++k) orow[lane + k * kWarp] = v[k];
  }
}

template <int K, bool LN, int POST>
int launch(const float* y, const float* bias, const float* scale,
           const float* ln_bias, const float* residual, float* out,
           long long rows, cudaStream_t stream) {
  auto kernel = guide_norm_kernel<K, LN, POST>;
  // Resident blocks a card, found once for each instantiation.
  static int grid_cap = 0;
  if (grid_cap == 0) {
    int device = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          kThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    grid_cap = sms * (per_sm > 0 ? per_sm : 1);
  }
  const long long need = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int grid = static_cast<int>(need < grid_cap ? need : grid_cap);
  kernel<<<grid, kThreads, 0, stream>>>(y, bias, scale, ln_bias, residual,
                                        out, rows);
  return static_cast<int>(cudaGetLastError());
}

template <int K, bool LN>
int by_post(int post, const float* y, const float* bias, const float* scale,
            const float* ln_bias, const float* residual, float* out,
            long long rows, cudaStream_t stream) {
  switch (post) {
    case kNone:
      return launch<K, LN, kNone>(y, bias, scale, ln_bias, residual, out,
                                  rows, stream);
    case kRelu:
      return launch<K, LN, kRelu>(y, bias, scale, ln_bias, residual, out,
                                  rows, stream);
    case kResidual:
      return launch<K, LN, kResidual>(y, bias, scale, ln_bias, residual, out,
                                      rows, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int K>
int by_ln(int post, const float* y, const float* bias, const float* scale,
          const float* ln_bias, const float* residual, float* out,
          long long rows, cudaStream_t stream) {
  return scale != nullptr
             ? by_post<K, true>(post, y, bias, scale, ln_bias, residual, out,
                                rows, stream)
             : by_post<K, false>(post, y, bias, scale, ln_bias, residual,
                                 out, rows, stream);
}

}  // namespace

// y, residual, out [rows, width] f32 rows; bias, scale, ln_bias [width]; all
// 16-byte aligned.  scale == nullptr: no LayerNorm (ln_bias unread).  post:
// 0 identity, 1 ReLU, 2 + residual.  out may be y.
extern "C" int guide_norm_launch(const float* y, const float* bias,
                                 const float* scale, const float* ln_bias,
                                 const float* residual, float* out,
                                 long long rows, int width, int post,
                                 void* stream) {
  if (rows < 0 || (post == kResidual) != (residual != nullptr) ||
      (scale != nullptr) != (ln_bias != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (width) {
    case 128:
      return by_ln<1>(post, y, bias, scale, ln_bias, residual, out, rows, s);
    case 256:
      return by_ln<2>(post, y, bias, scale, ln_bias, residual, out, rows, s);
    case 512:
      return by_ln<4>(post, y, bias, scale, ln_bias, residual, out, rows, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
