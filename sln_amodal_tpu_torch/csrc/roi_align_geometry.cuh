// Sampling geometry of the FPN RoIAlign, shared by the forward kernel
// (roi_align.cu) and its backward (roi_align_backward.cu), so that both
// compute the same levels, sample positions, corners and validity, bit for
// bit as ops/roi_align.py::sample_geometry computes them on the card:
//   - the level rule in the boxes' dtype: sqrt (correctly rounded), the CUDA
//     math library's log2 (the function ATen's log2 calls), rint for
//     torch.round's half-to-even; the division by the host scalar
//     224 / sqrt(image area) is a product with its reciprocal, as ATen's
//     true division by a CPU scalar computes it, so the host passes that
//     reciprocal;
//   - the coordinates in float32: scale = (hi - lo) * dim1 * recip with the
//     float32 reciprocal of (out_size - 1) from the host, and the sample
//     position step * scale + lo * dim1 as one exact float64 product and add
//     rounded once to float32 (what the plain version's _fma_f32 does; not
//     fmaf, which rounds differently in rare double-rounding cases);
//     out_size == 1 samples the centre 0.5 * (lo + hi) * dim1.
// Every rounding is spelled out (__fadd_rn, ...), and the sources are built
// with -fmad=false.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace roi_geometry {

constexpr int kMaxLevels = 4;

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ float log2_lib(float a) { return log2f(a); }
__device__ __forceinline__ float rint_(float a) { return rintf(a); }
__device__ __forceinline__ float to_f32(float a) { return a; }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double sqrt_rn(double a) { return __dsqrt_rn(a); }
__device__ __forceinline__ double log2_lib(double a) { return log2(a); }
__device__ __forceinline__ double rint_(double a) { return rint(a); }
__device__ __forceinline__ float to_f32(double a) { return __double2float_rn(a); }

// Feature dtype codes of the C entry points (ops/roi_align_cuda.py).
constexpr int kFloat32 = 0;
constexpr int kFloat64 = 1;
constexpr int kBFloat16 = 2;

// The dtype a feature dtype is interpolated and accumulated in: bfloat16
// in float32, the others in themselves; conversions in and out (one
// round-to-nearest-even into bfloat16).
template <typename T>
struct Wide {
  using type = T;
};
template <>
struct Wide<__nv_bfloat16> {
  using type = float;
};
__device__ __forceinline__ float widen(float a) { return a; }
__device__ __forceinline__ double widen(double a) { return a; }
__device__ __forceinline__ float widen(__nv_bfloat16 a) { return __bfloat162float(a); }
template <typename T>
__host__ __device__ __forceinline__ T narrow(typename Wide<T>::type a) {
  return a;
}
template <>
__host__ __device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float a) {
  return __float2bfloat16_rn(a);
}

// The pyramid: n levels (P2, P3, ...) of [B, H_l, W_l, C].
struct Levels {
  const void* ptr[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
  int n;
};

// One axis of one sample: clamped corner indices, lerp weight, validity.
struct Sample {
  int lo;
  int hi;
  float lerp;
  int valid;
};

// Index of a box's pyramid level, as ops/roi_align.py::roi_levels and the
// clamp of sample_geometry compute it on the card, in the boxes' dtype BT.
template <typename BT>
__device__ int level_index(BT y1, BT x1, BT y2, BT x2, BT inv_scale, int n_levels) {
  BT hw = mul_rn(sub_rn(y2, y1), sub_rn(x2, x1));
  const BT tiny = static_cast<BT>(1e-12);
  if (hw < tiny) hw = tiny;                        // clamp_min (NaN passes)
  const BT lvl = add_rn(log2_lib(mul_rn(sqrt_rn(hw), inv_scale)), static_cast<BT>(4.0));
  BT r = rint_(lvl);                               // torch.round: half to even
  r = r < static_cast<BT>(2.0) ? static_cast<BT>(2.0) : r;
  r = r > static_cast<BT>(5.0) ? static_cast<BT>(5.0) : r;
  const int idx = static_cast<int>(r) - 2;
  return min(max(idx, 0), n_levels - 1);
}

// Sample `step` of `out_size` along one axis of extent `dim` between the
// normalized edges lo and hi (float32): ops/roi_align.py::_coords, then the
// validity, clamps and lerp of sample_geometry.
__device__ __forceinline__ Sample axis_sample(float lo, float hi, int step, int out_size,
                                              float recip, int dim) {
  const float dim1 = sub_rn(static_cast<float>(dim), 1.0f);
  float in;
  if (out_size > 1) {
    const float scale = mul_rn(mul_rn(sub_rn(hi, lo), dim1), recip);
    const float start = mul_rn(lo, dim1);
    in = __double2float_rn(__dadd_rn(__dmul_rn(static_cast<double>(step),
                                               static_cast<double>(scale)),
                                     static_cast<double>(start)));
  } else {
    in = mul_rn(mul_rn(0.5f, add_rn(lo, hi)), dim1);
  }
  const float fl = floorf(in);
  Sample s;
  s.valid = in >= 0.0f && in <= dim1;
  s.lo = static_cast<int>(fminf(fmaxf(fl, 0.0f), dim1));
  s.hi = static_cast<int>(fminf(fmaxf(ceilf(in), 0.0f), dim1));
  s.lerp = sub_rn(in, fl);
  return s;
}

}  // namespace roi_geometry
