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
// computes, bit for bit as the card runs those PyTorch ops:
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
//   - channels move as 16-byte vectors (float4, double2; the wrapper
//     requires C and the pointers to allow it): each corner read and each
//     output write of a warp is a contiguous, coalesced run of the NHWC
//     level and of the output;
//   - samples outside the level write the extrapolation value and read no
//     features; output stores are streaming (evict first).
// Exactness: the lerp is top = tl + (tr - tl) * xl, bot = bl + (br - bl) * xl,
// out = top + (bot - top) * yl in the feature dtype with each rounding
// spelled out (no fused multiply-add, -fmad=false), the order of the plain
// PyTorch version, so the two agree bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 4;
constexpr int kMaxThreads = 512;

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
  if constexpr (sizeof(T) == 4)
    __stcs(reinterpret_cast<float4*>(p), *reinterpret_cast<const float4*>(&x));
  else
    __stcs(reinterpret_cast<double2*>(p), *reinterpret_cast<const double2*>(&x));
}

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
__device__ Sample axis_sample(float lo, float hi, int step, int out_size, float recip, int dim) {
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
  const int cv = c / V;
  const bool vy = row.valid != 0;
  const T yl = static_cast<T>(row.lerp);
  const T* top = row_top;
  const T* bottom = row_bottom;
  T* o = out + ((static_cast<size_t>(r) * ch + i) * cw + j0) * c;
  for (int e = threadIdx.x; e < ncols * cv; e += blockDim.x) {
    const int j = e / cv;
    const int k = (e - j * cv) * V;
    const Sample s = cols[j];
    Vec<T, V> res;
    if (vy && s.valid) {
      const T xl = static_cast<T>(s.lerp);
      const size_t lo = static_cast<size_t>(s.lo) * c + k;
      const size_t hi = static_cast<size_t>(s.hi) * c + k;
      const Vec<T, V> tl = *reinterpret_cast<const Vec<T, V>*>(top + lo);
      const Vec<T, V> tr = *reinterpret_cast<const Vec<T, V>*>(top + hi);
      const Vec<T, V> bl = *reinterpret_cast<const Vec<T, V>*>(bottom + lo);
      const Vec<T, V> br = *reinterpret_cast<const Vec<T, V>*>(bottom + hi);
#pragma unroll
      for (int q = 0; q < V; ++q) {
        const T tv = add_rn(tl.v[q], mul_rn(sub_rn(tr.v[q], tl.v[q]), xl));
        const T bv = add_rn(bl.v[q], mul_rn(sub_rn(br.v[q], bl.v[q]), xl));
        res.v[q] = add_rn(tv, mul_rn(sub_rn(bv, tv), yl));
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
      static_cast<BT>(inv_scale), recip_y, recip_x, static_cast<T>(extrapolation),
      static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// levels: n_levels (1..4) NHWC tensors [B, H_l, W_l, C] (P2, P3, ...) of the
// feature dtype (f64 if double_precision, else f32); boxes [B, N, 4]
// normalized (y1, x1, y2, x2), f64 if boxes_double, else f32; inv_scale the
// reciprocal of 224 / sqrt(image area) in the boxes' dtype; recip_y/recip_x
// the float32 1 / (ch - 1) and 1 / (cw - 1) (unused where that size is 1);
// out [B, N, ch, cw, C]. C is a multiple of 16 / sizeof(feature) and every
// level and out are 16-byte aligned. Launches once on `stream`.
extern "C" int roi_align_batched(const void* const* level_ptrs, const int* heights,
                                 const int* widths, int n_levels, int c, int batch,
                                 int n_per_image, int ch, int cw, const void* boxes,
                                 int boxes_double, double inv_scale, float recip_y,
                                 float recip_x, double extrapolation,
                                 int double_precision, void* out, void* stream) {
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
  if (double_precision) {
    if (boxes_double)
      return launch<double, double>(levels, boxes, c, batch, n_per_image, ch, cw,
                                    inv_scale, recip_y, recip_x, extrapolation, out, s);
    return launch<double, float>(levels, boxes, c, batch, n_per_image, ch, cw,
                                 inv_scale, recip_y, recip_x, extrapolation, out, s);
  }
  if (boxes_double)
    return launch<float, double>(levels, boxes, c, batch, n_per_image, ch, cw,
                                 inv_scale, recip_y, recip_x, extrapolation, out, s);
  return launch<float, float>(levels, boxes, c, batch, n_per_image, ch, cw, inv_scale,
                              recip_y, recip_x, extrapolation, out, s);
}
