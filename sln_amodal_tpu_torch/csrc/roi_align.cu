// Batched FPN RoIAlign (TF-legacy crop_and_resize sampling), for Hopper.
//
// Replaces the TPU kernel sln_amodal_tpu/ops/roi_patch_pallas.py::_patch_kernel
// (reached through roi_pool_patches / pyramid_roi_align_patch), and computes
// the function of its exact oracle, ops/roi_align.py::
// pyramid_roi_align_gather_batched: out[b, n, i, j, :] is the bilinear
// sample of ROI n's pyramid level at row coordinate i and column j, or the
// extrapolation value where the sample lies outside the level.
//
// One launch per call: the kernel reads the boxes themselves and computes
// the sampling geometry (FPN level, sample coordinates, clamped corner
// indices, lerp weights, validity) that ops/roi_align.py::sample_geometry
// computes, bit for bit as the card runs those PyTorch ops, with the device
// functions of roi_align_geometry.cuh (shared with the backward kernel,
// roi_align_backward.cu).
//
// What bounds it on this card: bytes. Each output cell reads four corner
// rows of C channels (neighbouring samples share rows, which L1/L2 serve)
// and writes one; there are 9 flops per output element. A gather that walks
// a row's columns in turn, reading each column's geometry from global
// memory before its features, is bound by latency instead (two dependent
// global round trips per column, few loads in flight). Here:
//   - one block per (ROI, output row, chunk of columns); warp 0 computes
//     the block's geometry into shared memory, then every thread samples
//     one (column, channel vector) pair, so all columns of the row are in
//     flight at once and no feature load waits on a global geometry read;
//   - channels move as 16-byte vectors (4 float32, 2 float64 or 8
//     bfloat16; the wrapper requires C and the pointers to allow it): each
//     corner read and each output write of a warp is a contiguous,
//     coalesced run of the NHWC level and of the output;
//   - samples outside the level write the extrapolation value and read no
//     features; output stores are streaming (evict first).
// Exactness: the lerp is top = tl + (tr - tl) * xl, bot = bl + (br - bl) * xl,
// out = top + (bot - top) * yl in the feature dtype with each rounding
// spelled out (no fused multiply-add, -fmad=false), the order of the plain
// PyTorch version, so the two agree bit for bit. bfloat16 features are
// widened to float32, interpolated in that order in float32 with the
// float32 lerps, and rounded once to bfloat16 at the store (as the plain
// version computes them).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "roi_align_geometry.cuh"

namespace {

using namespace roi_geometry;

constexpr int kMaxThreads = 512;

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

// Output stores bypass L2's normal retention (evict first), so the output,
// larger than L2, does not push out the feature rows neighbouring samples
// read again.
template <typename T, int V>
__device__ __forceinline__ void store_streaming(T* p, const Vec<T, V>& x) {
  static_assert(sizeof(T) * V == 16, "16-byte vectors");
  if constexpr (sizeof(T) == 8)
    __stcs(reinterpret_cast<double2*>(p), *reinterpret_cast<const double2*>(&x));
  else
    __stcs(reinterpret_cast<float4*>(p), *reinterpret_cast<const float4*>(&x));
}

template <typename T, typename BT, int V>
__global__ void __launch_bounds__(kMaxThreads)
roi_align_kernel(Levels levels, const BT* __restrict__ boxes, int c, int n_per_image,
                 int ch, int cw, int cols_per_block, BT inv_scale, float recip_y,
                 float recip_x, T extrapolation, T* __restrict__ out) {
  extern __shared__ Sample cols[];  // [cols_per_block]
  __shared__ Sample row;
  __shared__ const T* row_top;
  __shared__ const T* row_bottom;

  const int r = blockIdx.x;  // flat ROI index b * n_per_image + n
  const int i = blockIdx.y;  // output row
  const int j0 = blockIdx.z * cols_per_block;
  const int ncols = min(cols_per_block, cw - j0);

  // Geometry: warp 0 computes the level and the row, and the columns of
  // this block into shared memory (the box is one broadcast load).
  if (threadIdx.x < 32) {
    const BT* box = boxes + static_cast<size_t>(r) * 4;
    const BT y1 = box[0], x1 = box[1], y2 = box[2], x2 = box[3];
    const int l = level_index(y1, x1, y2, x2, inv_scale, levels.n);
    const void* ptr = levels.ptr[0];
    int hl = levels.h[0], wl = levels.w[0];
#pragma unroll
    for (int k = 1; k < kMaxLevels; ++k) {
      if (k == l) {
        ptr = levels.ptr[k];
        hl = levels.h[k];
        wl = levels.w[k];
      }
    }
    for (int j = threadIdx.x; j < ncols; j += 32)
      cols[j] = axis_sample(to_f32(x1), to_f32(x2), j0 + j, cw, recip_x, wl);
    if (threadIdx.x == 0) {
      const Sample s = axis_sample(to_f32(y1), to_f32(y2), i, ch, recip_y, hl);
      const size_t row_elems = static_cast<size_t>(wl) * c;
      const T* base = static_cast<const T*>(ptr) +
                      static_cast<size_t>(r / n_per_image) * hl * row_elems;
      row = s;
      row_top = base + s.lo * row_elems;
      row_bottom = base + s.hi * row_elems;
    }
  }
  __syncthreads();

  // Gather: one (column, channel vector) per thread, all columns at once.
  using A = typename Wide<T>::type;
  const int cv = c / V;
  const bool vy = row.valid != 0;
  const A yl = static_cast<A>(row.lerp);
  const T* top = row_top;
  const T* bottom = row_bottom;
  T* o = out + ((static_cast<size_t>(r) * ch + i) * cw + j0) * c;
  for (int e = threadIdx.x; e < ncols * cv; e += blockDim.x) {
    const int j = e / cv;
    const int k = (e - j * cv) * V;
    const Sample s = cols[j];
    Vec<T, V> res;
    if (vy && s.valid) {
      const A xl = static_cast<A>(s.lerp);
      const size_t lo = static_cast<size_t>(s.lo) * c + k;
      const size_t hi = static_cast<size_t>(s.hi) * c + k;
      const Vec<T, V> tl = *reinterpret_cast<const Vec<T, V>*>(top + lo);
      const Vec<T, V> tr = *reinterpret_cast<const Vec<T, V>*>(top + hi);
      const Vec<T, V> bl = *reinterpret_cast<const Vec<T, V>*>(bottom + lo);
      const Vec<T, V> br = *reinterpret_cast<const Vec<T, V>*>(bottom + hi);
#pragma unroll
      for (int q = 0; q < V; ++q) {
        const A a_tl = widen(tl.v[q]), a_tr = widen(tr.v[q]);
        const A a_bl = widen(bl.v[q]), a_br = widen(br.v[q]);
        const A tv = add_rn(a_tl, mul_rn(sub_rn(a_tr, a_tl), xl));
        const A bv = add_rn(a_bl, mul_rn(sub_rn(a_br, a_bl), xl));
        res.v[q] = narrow<T>(add_rn(tv, mul_rn(sub_rn(bv, tv), yl)));
      }
    } else {
#pragma unroll
      for (int q = 0; q < V; ++q) res.v[q] = extrapolation;
    }
    store_streaming(o + static_cast<size_t>(j) * c + k, res);
  }
}

template <typename T, typename BT>
int launch(const Levels& levels, const void* boxes, int c, int batch, int n_per_image,
           int ch, int cw, double inv_scale, float recip_y, float recip_x,
           double extrapolation, void* out, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const int cv = c / V;
  const int cols_per_block = min(cw, max(1, kMaxThreads / cv));
  const int per_block = cols_per_block * cv;
  const int threads = min(kMaxThreads, ((per_block + 31) / 32) * 32);
  const dim3 grid(batch * n_per_image, ch, (cw + cols_per_block - 1) / cols_per_block);
  const size_t smem = static_cast<size_t>(cols_per_block) * sizeof(Sample);
  roi_align_kernel<T, BT, V><<<grid, threads, smem, stream>>>(
      levels, static_cast<const BT*>(boxes), c, n_per_image, ch, cw, cols_per_block,
      static_cast<BT>(inv_scale), recip_y, recip_x,
      narrow<T>(static_cast<typename Wide<T>::type>(extrapolation)), static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_for_boxes(const Levels& levels, const void* boxes, int boxes_double, int c,
                     int batch, int n_per_image, int ch, int cw, double inv_scale,
                     float recip_y, float recip_x, double extrapolation, void* out,
                     cudaStream_t stream) {
  if (boxes_double)
    return launch<T, double>(levels, boxes, c, batch, n_per_image, ch, cw, inv_scale,
                             recip_y, recip_x, extrapolation, out, stream);
  return launch<T, float>(levels, boxes, c, batch, n_per_image, ch, cw, inv_scale, recip_y,
                          recip_x, extrapolation, out, stream);
}

}  // namespace

// levels: n_levels (1..4) NHWC tensors [B, H_l, W_l, C] (P2, P3, ...) of the
// feature dtype (dtype_code: kFloat32, kFloat64 or kBFloat16); boxes [B, N, 4]
// normalized (y1, x1, y2, x2), f64 if boxes_double, else f32; inv_scale the
// reciprocal of 224 / sqrt(image area) in the boxes' dtype; recip_y/recip_x
// the float32 1 / (ch - 1) and 1 / (cw - 1) (unused where that size is 1);
// out [B, N, ch, cw, C]. C is a multiple of 16 / sizeof(feature) and every
// level and out are 16-byte aligned. Launches once on `stream`.
extern "C" int roi_align_batched(const void* const* level_ptrs, const int* heights,
                                 const int* widths, int n_levels, int c, int batch,
                                 int n_per_image, int ch, int cw, const void* boxes,
                                 int boxes_double, double inv_scale, float recip_y,
                                 float recip_x, double extrapolation, int dtype_code,
                                 void* out, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels) return static_cast<int>(cudaErrorInvalidValue);
  Levels levels;
  for (int l = 0; l < kMaxLevels; ++l) {
    const int k = l < n_levels ? l : 0;
    levels.ptr[l] = level_ptrs[k];
    levels.h[l] = heights[k];
    levels.w[l] = widths[k];
  }
  levels.n = n_levels;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype_code) {
    case kFloat32:
      return launch_for_boxes<float>(levels, boxes, boxes_double, c, batch, n_per_image, ch,
                                     cw, inv_scale, recip_y, recip_x, extrapolation, out, s);
    case kFloat64:
      return launch_for_boxes<double>(levels, boxes, boxes_double, c, batch, n_per_image, ch,
                                      cw, inv_scale, recip_y, recip_x, extrapolation, out, s);
    case kBFloat16:
      return launch_for_boxes<__nv_bfloat16>(levels, boxes, boxes_double, c, batch,
                                             n_per_image, ch, cw, inv_scale, recip_y, recip_x,
                                             extrapolation, out, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
