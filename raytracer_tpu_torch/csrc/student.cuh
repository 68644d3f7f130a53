// The distilled FB student inside a path kernel: obs[22] -> action[2]
// through one or two ReLU hidden layers of at most 128 units.
//
// Replaces raytracer_tpu/core/pallas_path.py::_student_mlp.  Semantics are
// those of the port's plain guide (fb/distill.py::StudentGuide), which
// follows flax's Dense chain under XLA:
//   bf16 mode: obs and weights are bf16 values; each layer's product is
//     accumulated in f32 and rounded to bf16 (round to nearest even), the
//     bias is added and, on a hidden layer, the sum rounded to bf16 again,
//     then ReLU; the output layer's bias add stays in f32.
//   f32 mode: x @ W + b per layer in f32, ReLU between.
// The products of bf16 values are exact in f32, so a fused multiply-add
// rounds as the separate multiply and add would: the sums differ from the
// plain version's matmul only in their order (one-hot weights agree bit for
// bit; a dense student to f32 rounding before its bf16 rounding).
//
// Layout (core/cuda_path.py::pack_student): each layer's output width is
// padded with zero units to a multiple of 8 and its kernel stored [in][out]
// row-major, then its bias: W0 [22][h1], b0 [h1], (W1 [h1][h2], b1 [h2]),
// Wout [h][8], bout [8].  A padded unit is ReLU(0) = 0 and its weights in
// the next layer are 0, so padding changes no value.  The block keeps the
// weights in shared memory in the mode's type T (bf16 values are exact in
// both), and each warp a tile [h1][32] of T for its lanes' first hidden
// layer: lane l owns column l, so a lane reads only what it wrote and the
// warp needs no barrier.  Weights are read as 16-byte (bf16) or 2x16-byte
// (f32) broadcasts of 8 consecutive outputs, 8 accumulators a thread.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace student {

constexpr int kObs = 22;
constexpr int kOutPad = 8;
constexpr int kMaxWidth = 128;   // core/cuda_path.py MAX_STUDENT_WIDTH
constexpr int kChunk = 8;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// 8 consecutive values at p as floats (p 16-byte aligned for bf16, 32 for
// f32: every offset of the layout is a multiple of 8 values).
__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = a.z;
  v[3] = a.w;
  v[4] = b.x;
  v[5] = b.y;
  v[6] = b.z;
  v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {   // little-endian: the lower half first
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// One unit's epilogue: bias, the mode's roundings, ReLU on hidden layers.
template <bool kBf16>
__device__ __forceinline__ float finish(float acc, float bias, bool hidden) {
  float y;
  if (kBf16) {
    y = round_bf16(acc) + bias;
    if (hidden) y = round_bf16(y);
  } else {
    y = acc + bias;
  }
  if (hidden) y = (y != y) ? y : fmaxf(y, 0.0f);   // torch.relu
  return y;
}

struct Dims {
  int n_hidden;   // 1 or 2
  int h1, h2;     // padded widths (multiples of 8, at most kMaxWidth)
};

// Values in the packed layout.
__host__ __device__ inline int packed_size(Dims d) {
  const int last = d.n_hidden == 2 ? d.h2 : d.h1;
  int n = kObs * d.h1 + d.h1;
  if (d.n_hidden == 2) n += d.h1 * d.h2 + d.h2;
  return n + last * kOutPad + kOutPad;
}

// The student's action for one lane.  w: the packed weights in shared
// memory; tile: this warp's [h1][32] tile; lane: threadIdx.x % 32.
template <typename T>
__device__ __forceinline__ void forward(const T* w, T* tile, Dims dm,
                                        const float (&obs)[kObs], int lane,
                                        float& a0, float& a1) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  const T* W0 = w;
  const T* b0 = W0 + kObs * dm.h1;
  const T* W1 = b0 + dm.h1;
  const T* b1 = W1 + dm.h1 * dm.h2;
  const T* Wo = dm.n_hidden == 2 ? b1 + dm.h2 : W1;
  const int last = dm.n_hidden == 2 ? dm.h2 : dm.h1;
  const T* bo = Wo + last * kOutPad;

  float x[kObs];
#pragma unroll
  for (int k = 0; k < kObs; ++k) x[k] = kBf16 ? round_bf16(obs[k]) : obs[k];

  // Hidden layer 1: obs (registers) -> tile.
  for (int j0 = 0; j0 < dm.h1; j0 += kChunk) {
    float acc[kChunk];
#pragma unroll
    for (int jj = 0; jj < kChunk; ++jj) acc[jj] = 0.0f;
#pragma unroll
    for (int k = 0; k < kObs; ++k) {
      float wv[kChunk];
      load8(W0 + k * dm.h1 + j0, wv);
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj)
        acc[jj] = __fmaf_rn(x[k], wv[jj], acc[jj]);
    }
    float bv[kChunk];
    load8(b0 + j0, bv);
#pragma unroll
    for (int jj = 0; jj < kChunk; ++jj)
      tile[(j0 + jj) * 32 + lane] = from_f<T>(finish<kBf16>(acc[jj], bv[jj],
                                                            true));
  }

  float out0 = 0.0f, out1 = 0.0f;
  if (dm.n_hidden == 2) {
    // Hidden layer 2 from the tile, 8 units at a time; each finished unit
    // goes straight into the output layer's sums, in unit order.
    for (int j0 = 0; j0 < dm.h2; j0 += kChunk) {
      float acc[kChunk];
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) acc[jj] = 0.0f;
#pragma unroll 4
      for (int k = 0; k < dm.h1; ++k) {
        const float xk = to_f(tile[k * 32 + lane]);
        float wv[kChunk];
        load8(W1 + k * dm.h2 + j0, wv);
#pragma unroll
        for (int jj = 0; jj < kChunk; ++jj)
          acc[jj] = __fmaf_rn(xk, wv[jj], acc[jj]);
      }
      float bv[kChunk];
      load8(b1 + j0, bv);
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const float h = finish<kBf16>(acc[jj], bv[jj], true);
        const T* wo = Wo + (j0 + jj) * kOutPad;
        out0 = __fmaf_rn(h, to_f(wo[0]), out0);
        out1 = __fmaf_rn(h, to_f(wo[1]), out1);
      }
    }
  } else {
    for (int k = 0; k < dm.h1; ++k) {
      const float xk = to_f(tile[k * 32 + lane]);
      out0 = __fmaf_rn(xk, to_f(Wo[k * kOutPad]), out0);
      out1 = __fmaf_rn(xk, to_f(Wo[k * kOutPad + 1]), out1);
    }
  }
  a0 = finish<kBf16>(out0, to_f(bo[0]), false);
  a1 = finish<kBf16>(out1, to_f(bo[1]), false);
}

}  // namespace student
