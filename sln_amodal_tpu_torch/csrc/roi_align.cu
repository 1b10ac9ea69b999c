// Batched FPN RoIAlign (TF-legacy crop_and_resize sampling), for Hopper.
//
// Replaces the TPU kernel sln_amodal_tpu/ops/roi_patch_pallas.py::_patch_kernel
// (reached through roi_pool_patches / pyramid_roi_align_patch), and computes
// the function of its exact oracle, ops/roi_align.py::
// pyramid_roi_align_gather_batched: out[b, n, i, j, :] is the bilinear
// sample of ROI n's pyramid level at row coordinate i and column j, or the
// extrapolation value where the sample lies outside the level.
//
// As on the TPU, the sampling geometry (level, clamped corner indices, lerp
// weights, validity) is computed outside the kernel, in PyTorch, by the same
// function the plain version uses; the kernel only gathers and lerps.
//
// What bounds it on this card: bytes. Each output cell reads four corner
// rows of C channels (the rows neighbouring samples share come from L1/L2)
// and writes one; there are 3 flops per corner pair. Design: one block per
// (ROI, output row); its threads run over the channels, so the four corner
// reads and the output write of a sample are each one coalesced,
// contiguous C-wide access of the NHWC level. A sample's geometry is the
// same for every thread of the block and is read once per thread from
// L1-cached global memory. No span limit: unlike the TPU kernel's fixed
// 32x40 DMA patch, any box shape is sampled in place, so there is no spill
// path and no fallback.
// Exactness: the lerp is top = tl + (tr - tl) * xl, bot = bl + (br - bl) * xl,
// out = top + (bot - top) * yl in the feature dtype with each rounding
// spelled out (no fused multiply-add, -fmad=false), the order of the plain
// PyTorch version, so the two agree bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

struct Levels {
  const void* ptr[4];
  int h[4];
  int w[4];
};

template <typename T>
__global__ void roi_align_kernel(Levels levels, int c, int n_per_image, int ch, int cw,
                                 const int32_t* __restrict__ lvl,
                                 const int32_t* __restrict__ top,
                                 const int32_t* __restrict__ bottom,
                                 const T* __restrict__ y_lerp,
                                 const uint8_t* __restrict__ valid_y,
                                 const int32_t* __restrict__ left,
                                 const int32_t* __restrict__ right,
                                 const T* __restrict__ x_lerp,
                                 const uint8_t* __restrict__ valid_x,
                                 T extrapolation, T* __restrict__ out) {
  const int r = blockIdx.x;   // flat ROI index b * n_per_image + n
  const int i = blockIdx.y;   // output row
  const int b = r / n_per_image;
  const int l = lvl[r];
  const int hl = levels.h[l];
  const int wl = levels.w[l];
  const T* base = static_cast<const T*>(levels.ptr[l]) + (size_t)b * hl * wl * c;

  const int gy = r * ch + i;
  const bool vy = valid_y[gy] != 0;
  const T yl = y_lerp[gy];
  const T* row_t = base + (size_t)top[gy] * wl * c;
  const T* row_b = base + (size_t)bottom[gy] * wl * c;
  T* o = out + (size_t)gy * cw * c;

  for (int j = 0; j < cw; ++j) {
    const int gx = r * cw + j;
    T* oj = o + (size_t)j * c;
    if (!(vy && valid_x[gx] != 0)) {
      for (int k = threadIdx.x; k < c; k += blockDim.x) oj[k] = extrapolation;
      continue;
    }
    const T xl = x_lerp[gx];
    const size_t lo = (size_t)left[gx] * c;
    const size_t hi = (size_t)right[gx] * c;
    for (int k = threadIdx.x; k < c; k += blockDim.x) {
      const T tl = row_t[lo + k], tr = row_t[hi + k];
      const T bl = row_b[lo + k], br = row_b[hi + k];
      const T tv = add_rn(tl, mul_rn(sub_rn(tr, tl), xl));
      const T bv = add_rn(bl, mul_rn(sub_rn(br, bl), xl));
      oj[k] = add_rn(tv, mul_rn(sub_rn(bv, tv), yl));
    }
  }
}

template <typename T>
int launch(const void* const* level_ptrs, const int* heights, const int* widths,
           int c, int batch, int n_per_image, int ch, int cw,
           const int32_t* lvl, const int32_t* top, const int32_t* bottom,
           const void* y_lerp, const uint8_t* valid_y, const int32_t* left,
           const int32_t* right, const void* x_lerp, const uint8_t* valid_x,
           double extrapolation, void* out, void* stream) {
  Levels levels;
  for (int l = 0; l < 4; ++l) {
    levels.ptr[l] = level_ptrs[l];
    levels.h[l] = heights[l];
    levels.w[l] = widths[l];
  }
  const int threads = c >= 256 ? 256 : ((c + 31) / 32) * 32;
  dim3 grid(batch * n_per_image, ch);
  roi_align_kernel<T><<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      levels, c, n_per_image, ch, cw, lvl, top, bottom,
      static_cast<const T*>(y_lerp), valid_y, left, right,
      static_cast<const T*>(x_lerp), valid_x, static_cast<T>(extrapolation),
      static_cast<T*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

// levels: 4 NHWC tensors [B, H_l, W_l, C] (P2..P5); geometry over the B*N
// flat ROIs: lvl [BN], top/bottom/valid_y [BN, ch], y_lerp [BN, ch] in the
// feature dtype, left/right/valid_x [BN, cw], x_lerp [BN, cw];
// out [B, N, ch, cw, C]. double_precision selects f64 features (else f32).
extern "C" int roi_align_batched(const void* const* level_ptrs, const int* heights,
                                 const int* widths, int c, int batch, int n_per_image,
                                 int ch, int cw, const int32_t* lvl,
                                 const int32_t* top, const int32_t* bottom,
                                 const void* y_lerp, const uint8_t* valid_y,
                                 const int32_t* left, const int32_t* right,
                                 const void* x_lerp, const uint8_t* valid_x,
                                 double extrapolation, int double_precision,
                                 void* out, void* stream) {
  if (double_precision)
    return launch<double>(level_ptrs, heights, widths, c, batch, n_per_image, ch, cw,
                          lvl, top, bottom, y_lerp, valid_y, left, right, x_lerp,
                          valid_x, extrapolation, out, stream);
  return launch<float>(level_ptrs, heights, widths, c, batch, n_per_image, ch, cw,
                       lvl, top, bottom, y_lerp, valid_y, left, right, x_lerp,
                       valid_x, extrapolation, out, stream);
}
