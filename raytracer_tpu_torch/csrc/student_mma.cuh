// The distilled FB student on the tensor cores, one warp at a time:
// obs[22] -> action[2] for up to 32 rows that the warp has packed into a
// shared-memory tile, through one or two ReLU hidden layers of at most 128
// units, on mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32.
//
// Replaces raytracer_tpu/core/pallas_path.py::_student_mlp for bf16
// students (csrc/path_guided.cu; an f32 student keeps student.cuh's scalar
// route).  Semantics are student.cuh's bf16 mode, which is the port's
// plain guide (fb/distill.py::StudentGuide) and flax's Dense chain under
// XLA: obs and weights bf16; each layer's product accumulated in f32 and
// rounded to bf16, the bias added and, on a hidden layer, the sum rounded
// to bf16 again, then ReLU (NaN propagates); the output layer's bias add
// stays in f32.  An output element takes student::finish<true>, a hidden
// pair the same arithmetic in packed bf16x2 (hidden2).
// Products of bf16 values are exact in f32, so only the order of the sums
// differs from the plain version's matmul: one-hot students agree bit for
// bit, a dense student to f32 rounding before its bf16 rounding.
//
// Layout (core/cuda_path.py::pack_student_mma), bf16 values: each layer's
// kernel [K][N] with K padded by zero rows (22 -> 32; a hidden width to
// the previous layer's padded width) and N by zero units (a hidden width
// to a multiple of 16, the output to 8), stored in 8-wide k-chunks,
// element (k, n) at ((k / 8) * N + n) * 8 + k % 8, then its bias [N]:
// W0 [32 x h1], b0, (W1 [h1 x h2], b1,) Wout [h x 8], bout.  A chunk of
// 8 units x 8 k is 128 contiguous bytes, one ldmatrix 8x8 matrix, so the
// B fragments load with no bank conflict and no padding.  A padded unit
// is ReLU(0) = 0 with zero weights out, so padding changes no value.
//
// The observation tile [32 rows x 32] of a warp is stored the same way
// (element (row, k) at ((k / 8) * 32 + row) * 8 + k % 8).  Layer l's C
// fragments (16 rows x 8 units, f32) are packed pairwise into layer l+1's
// A fragments (16 rows x 16 k, bf16) in registers: the m16n8k16
// accumulator layout is the A operand layout, so no activation goes back
// to shared memory.  A hidden layer runs 16 units at a time, and with two
// hidden layers each 16 units of the second go straight into the output
// product, so the registers hold the first layer's activations (32 at
// width 128) and a few fragments.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "student.cuh"

namespace smma {

constexpr int kK0 = 32;                                // obs, padded
constexpr int kOutPad = 8;                             // one n-tile
constexpr int kMaxSteps = student::kMaxWidth / 16;     // 16-unit steps
constexpr int kTileRows = 32;
constexpr int kTileElems = kK0 * kTileRows;            // a warp's tile
constexpr unsigned kFull = 0xffffffffu;

struct Dims {
  int n_hidden;   // 1 or 2
  int h1, h2;     // padded widths (multiples of 16, at most kMaxWidth)
};

// bf16 values in the packed layout.
__host__ __device__ inline int packed_size(Dims d) {
  const int last = d.n_hidden == 2 ? d.h2 : d.h1;
  int n = kK0 * d.h1 + d.h1;
  if (d.n_hidden == 2) n += d.h1 * d.h2 + d.h2;
  return n + last * kOutPad + kOutPad;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4],
                                            const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x2(unsigned (&r)[2],
                                            const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p))
               : "memory");
}

// c += a b for one 16x8 tile, k = 16.
__device__ __forceinline__ void mma(float (&c)[4], const unsigned (&a)[4],
                                    unsigned b0, unsigned b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // lo: low half
  return *reinterpret_cast<const unsigned*>(&v);
}

// One hidden epilogue on a pair of units, packed: round each f32 sum to
// bf16, add the bias in bf16 (one rounding of the exact sum, which is
// student::finish<true>'s f32 add and second rounding: the f32 sum of two
// bf16 values rounds to bf16 as the exact sum does), ReLU with NaN
// propagating (torch.relu).  Returns the A-fragment register.
__device__ __forceinline__ unsigned hidden2(float x0, float x1,
                                            const __nv_bfloat16* bias) {
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(bias);
  const __nv_bfloat162 y = __hmax2_nan(
      __hadd2(__floats2bfloat162_rn(x0, x1), b), __float2bfloat162_rn(0.0f));
  return *reinterpret_cast<const unsigned*>(&y);
}

// Writes one row of the warp's tile: obs rounded to bf16 and zero-padded
// to 32 where keep, else zeros.
__device__ __forceinline__ void store_row(__nv_bfloat16* tile, int row,
                                          const float (&obs)[student::kObs],
                                          bool keep) {
  unsigned w[kK0 / 2];
#pragma unroll
  for (int k = 0; k < kK0 / 2; ++k) {
    const float lo = (keep && 2 * k < student::kObs) ? obs[2 * k] : 0.0f;
    const float hi =
        (keep && 2 * k + 1 < student::kObs) ? obs[2 * k + 1] : 0.0f;
    w[k] = pack2(lo, hi);
  }
#pragma unroll
  for (int c = 0; c < kK0 / 8; ++c)
    *reinterpret_cast<uint4*>(tile + (c * kTileRows + row) * 8) =
        make_uint4(w[4 * c], w[4 * c + 1], w[4 * c + 2], w[4 * c + 3]);
}

// A fragments of m-tile mt, k-step ks of the tile.
__device__ __forceinline__ void load_a(const __nv_bfloat16* tile, int mt,
                                       int ks, int lane, unsigned (&a)[4]) {
  const int q = lane >> 3, r = lane & 7;
  ldmatrix_x4(a, tile + ((2 * ks + (q >> 1)) * kTileRows + 16 * mt +
                         (q & 1) * 8 + r) * 8);
}

// B fragments of units n0..n0+7 (b[0], b[1]) and n0+8..n0+15 (b[2], b[3])
// at k-step ks of a layer with n units.
__device__ __forceinline__ void load_b(const __nv_bfloat16* w, int n,
                                       int ks, int n0, int lane,
                                       unsigned (&b)[4]) {
  const int q = lane >> 3, r = lane & 7;
  ldmatrix_x4(b, w + ((2 * ks + (q & 1)) * n + n0 + (q >> 1) * 8 + r) * 8);
}

// B fragments of the output layer's 8 units at k-step ks.
__device__ __forceinline__ void load_b_out(const __nv_bfloat16* w, int ks,
                                           int lane, unsigned (&b)[2]) {
  const int q = (lane >> 3) & 1, r = lane & 7;
  ldmatrix_x2(b, w + ((2 * ks + q) * kOutPad + r) * 8);
}

// The hidden epilogue of units n0..n0+15 (C tiles c0, c1) into one k-step
// of the next layer's A fragments.
__device__ __forceinline__ void hidden_to_a(const float (&c0)[4],
                                            const float (&c1)[4],
                                            const __nv_bfloat16* bias, int t,
                                            unsigned (&a)[4]) {
  a[0] = hidden2(c0[0], c0[1], bias + 2 * t);
  a[1] = hidden2(c0[2], c0[3], bias + 2 * t);
  a[2] = hidden2(c1[0], c1[1], bias + 8 + 2 * t);
  a[3] = hidden2(c1[2], c1[3], bias + 8 + 2 * t);
}

// The output C tile (rows g and g+8 of the m-tile, units 2t and 2t+1) of
// m-tile mt for the warp's tile.
__device__ __forceinline__ void mtile(const __nv_bfloat16* w,
                                      const __nv_bfloat16* tile, Dims dm,
                                      int mt, int lane, float (&out)[4]) {
  const int t = lane & 3;
  const __nv_bfloat16* W0 = w;
  const __nv_bfloat16* b0 = W0 + kK0 * dm.h1;
  const __nv_bfloat16* W1 = b0 + dm.h1;
  const __nv_bfloat16* b1 = W1 + dm.h1 * dm.h2;
  const __nv_bfloat16* Wo = dm.n_hidden == 2 ? b1 + dm.h2 : W1;
  const int last = dm.n_hidden == 2 ? dm.h2 : dm.h1;
  const __nv_bfloat16* bo = Wo + last * kOutPad;
  const int s1 = dm.h1 / 16, s2 = dm.h2 / 16;

  unsigned x[kK0 / 16][4];
#pragma unroll
  for (int ks = 0; ks < kK0 / 16; ++ks) load_a(tile, mt, ks, lane, x[ks]);

  // Hidden layer 1, 16 units a step, into A fragments.
  unsigned h[kMaxSteps][4];
#pragma unroll
  for (int s = 0; s < kMaxSteps; ++s) {
    h[s][0] = h[s][1] = h[s][2] = h[s][3] = 0u;
    if (s < s1) {
      float c0[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      float c1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int ks = 0; ks < kK0 / 16; ++ks) {
        unsigned b[4];
        load_b(W0, dm.h1, ks, 16 * s, lane, b);
        mma(c0, x[ks], b[0], b[1]);
        mma(c1, x[ks], b[2], b[3]);
      }
      hidden_to_a(c0, c1, b0 + 16 * s, t, h[s]);
    }
  }

  out[0] = out[1] = out[2] = out[3] = 0.0f;
  if (dm.n_hidden == 2) {
    // Hidden layer 2, 16 units a step, each step straight into the output
    // product.
    for (int s = 0; s < s2; ++s) {
      float c0[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      float c1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int ks = 0; ks < kMaxSteps; ++ks) {
        if (ks < s1) {
          unsigned b[4];
          load_b(W1, dm.h2, ks, 16 * s, lane, b);
          mma(c0, h[ks], b[0], b[1]);
          mma(c1, h[ks], b[2], b[3]);
        }
      }
      unsigned a[4];
      hidden_to_a(c0, c1, b1 + 16 * s, t, a);
      unsigned bo2[2];
      load_b_out(Wo, s, lane, bo2);
      mma(out, a, bo2[0], bo2[1]);
    }
  } else {
#pragma unroll
    for (int ks = 0; ks < kMaxSteps; ++ks) {
      if (ks < s1) {
        unsigned bo2[2];
        load_b_out(Wo, ks, lane, bo2);
        mma(out, h[ks], bo2[0], bo2[1]);
      }
    }
  }
  const float bo0 = __bfloat162float(bo[2 * t]);
  const float bo1 = __bfloat162float(bo[2 * t + 1]);
  out[0] = student::finish<true>(out[0], bo0, false);
  out[1] = student::finish<true>(out[1], bo1, false);
  out[2] = student::finish<true>(out[2], bo0, false);
  out[3] = student::finish<true>(out[3], bo1, false);
}

// The student on the n packed rows of the warp's tile (rows n..31 zero);
// every lane of the warp calls it, converged.  A lane whose row is below n
// gets that row's action in (a0, a1); the others get the action of a zero
// row or of nothing, to be ignored.
__device__ __forceinline__ void forward(const __nv_bfloat16* w,
                                        const __nv_bfloat16* tile, Dims dm,
                                        int n, int row, int lane, float& a0,
                                        float& a1) {
  const int n_mt = n > 16 ? 2 : 1;
  const int src = (row & 7) * 4;   // the lane that holds the row's units 0, 1
  a0 = a1 = 0.0f;
#pragma unroll 1
  for (int mt = 0; mt < n_mt; ++mt) {
    float out[4];
    mtile(w, tile, dm, mt, lane, out);
    const float v0 = __shfl_sync(kFull, out[0], src);
    const float v1 = __shfl_sync(kFull, out[1], src);
    const float v2 = __shfl_sync(kFull, out[2], src);
    const float v3 = __shfl_sync(kFull, out[3], src);
    if ((row >> 4) == mt) {
      const bool low = (row & 15) < 8;
      a0 = low ? v0 : v2;
      a1 = low ? v1 : v3;
    }
  }
}

}  // namespace smma
