// Backward of the batched FPN RoIAlign (roi_align.cu), for Hopper.
//
// The JAX package gives this gradient through the custom VJP of
// sln_amodal_tpu/ops/roi_align.py::pyramid_roi_align_batched (:650-673),
// two XLA einsums over one-hot axis weights, not a Pallas kernel. It
// computes, for every level l, image b, row y, column x and channel c,
//
//   dF_l[b, y, x, c] = sum over ROIs n of image b on level l, rows i:
//                      yw[n, i, y] * sum over columns j: xw[n, j, x] * g[b, n, i, j, c]
//
// with yw[n, i, y] = (top == y) * (1 - y_lerp) + (bottom == y) * y_lerp for a
// valid row sample (0 otherwise), xw likewise along x, the cotangent g read
// in float32 whatever the level dtype, the sums in float32, and dF cast to
// the level's dtype at the end (float32, float64, or bfloat16 with one
// round-to-nearest-even). The gradient into the boxes is zero (the
// wrapper returns none). The geometry comes from roi_align_geometry.cuh, the
// forward kernel's own code, so levels, corners, lerps and validity are the
// forward's bit for bit.
//
// Deterministic: no floating-point atomics. One block owns one output row
// (level, image, y) over a chunk of channels, and accumulates it in shared
// memory [W_l, chunk] in float32. It scans the image's ROIs in passes: each
// thread takes one ROI, computes its level and, if it is this block's, the
// row samples i that touch y (their y weight); a block-wide prefix sum lists
// the (ROI, i, weight) entries in ROI order. Then, ROI by ROI, the block
// computes the ROI's column samples into shared memory and walks its
// entries: thread (channel, group q) adds wy * (wx * g) for every column
// sample whose corner x it owns (x mod groups == q), its cotangent loads for
// 16 columns issued together. Each cell of the row buffer has one owner
// thread that adds in a fixed order, so two launches give the same bits. The block then writes its row whole, zeros included:
// the gradient needs no separate zero fill.
//
// What bounds it on this card: bytes. It must write every level's gradient
// whole (P2..P5 at 1024^2, B=2, C=256, float32: 178.3 MB) and read the
// cotangent (10.0 MB at pool 7, 52.4 MB at pool 16 for 100 ROIs per image;
// half of each in bfloat16).
// Cotangent loads are coalesced runs of one (ROI, i, j) row's channels; the
// row buffer's accesses are conflict-free (a warp covers 32 consecutive
// channels of one cell); the row is written as coalesced runs of the NHWC
// level. The scan repeats the ROIs' level and row geometry in every block
// (ALU work, no memory traffic); a later version may share it with the
// forward pass.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "roi_align_geometry.cuh"

namespace {

using namespace roi_geometry;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTapBatch = 16;   // cotangent loads a thread keeps in flight

// One row sample of one ROI that touches this block's row: the flat
// cotangent row (b * N + n) * ch + i and its y weight.
struct Entry {
  int row;
  float w;
};

// A ROI with entries in this pass: its index n, first entry, entry count.
struct Active {
  int n;
  int first;
  int count;
};

// One column sample's two corners and their x weights (0 where invalid).
struct XTap {
  int lo;
  int hi;
  float w_lo;
  float w_hi;
};

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const double* p) { return __double2float_rn(*p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_from_f32(double* p, float v) { *p = static_cast<double>(v); }
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Exclusive prefix sum of v over the block; *total gets the sum. All
// threads must call it.
__device__ int block_exclusive_scan(int v, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < kWarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, d);
      if (lane >= d) s += y;
    }
    if (lane < kWarps) warp_sums[lane] = s;  // inclusive over warps
  }
  __syncthreads();
  const int before = (warp > 0 ? warp_sums[warp - 1] : 0) + x - v;
  *total = warp_sums[kWarps - 1];
  __syncthreads();  // warp_sums may be reused by the next call
  return before;
}

// The x weights of JAX's _axis_weights for one column sample: a one-hot
// row with (1 - lerp) at lo and lerp at hi, their sum where lo == hi, all
// zero for an invalid sample.
__device__ __forceinline__ XTap x_tap(const Sample& s) {
  XTap t;
  t.lo = s.lo;
  t.hi = s.hi;
  const float w_lo = sub_rn(1.0f, s.lerp);
  if (!s.valid) {
    t.w_lo = 0.0f;
    t.w_hi = 0.0f;
  } else if (s.lo == s.hi) {
    t.w_lo = add_rn(w_lo, s.lerp);
    t.w_hi = 0.0f;
  } else {
    t.w_lo = w_lo;
    t.w_hi = s.lerp;
  }
  return t;
}

template <typename T, typename BT>
__global__ void __launch_bounds__(kThreads)
roi_align_backward_kernel(Levels grads, const BT* __restrict__ boxes,
                          const T* __restrict__ grad_out, int c, int batch, int n_per_image,
                          int ch, int cw, int chunk, int rois_per_pass, BT inv_scale,
                          float recip_y, float recip_x) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int warp_sums[kWarps];
  __shared__ int n_active;

  // This block's row: level l, image b, row y; channels [c0, c0 + chunk).
  int r = blockIdx.x, l = 0;
  while (l + 1 < grads.n && r >= batch * grads.h[l]) {
    r -= batch * grads.h[l];
    ++l;
  }
  const int hl = grads.h[l], wl = grads.w[l];
  const int b = r / hl, y = r - b * hl;
  const int c0 = blockIdx.y * chunk;

  int w_max = grads.w[0];
  for (int k = 1; k < grads.n; ++k) w_max = max(w_max, grads.w[k]);
  float* buf = reinterpret_cast<float*>(smem);                       // [w_max, chunk]
  XTap* taps = reinterpret_cast<XTap*>(buf + static_cast<size_t>(w_max) * chunk);
  Active* active = reinterpret_cast<Active*>(taps + cw);             // [rois_per_pass]
  Entry* entries = reinterpret_cast<Entry*>(active + rois_per_pass); // [rois_per_pass * ch]

  for (int e = threadIdx.x; e < wl * chunk; e += kThreads) buf[e] = 0.0f;

  // Thread (cl, q): channel c0 + cl, owner of the columns x with x % groups == q.
  const int groups = kThreads / chunk;
  const int cl = threadIdx.x % chunk, q = threadIdx.x / chunk;
  const int channel = c0 + cl;
  const bool has_channel = channel < c;

  for (int pass = 0; pass < n_per_image; pass += rois_per_pass) {
    // 1. Scan: which row samples of which ROIs touch row y of this level.
    const int n = pass + threadIdx.x;
    int count = 0;
    const BT* box = boxes + (static_cast<size_t>(b) * n_per_image + n) * 4;
    BT y1 = 0, x1 = 0, y2 = 0, x2 = 0;
    const bool mine = threadIdx.x < rois_per_pass && n < n_per_image;
    bool on_level = false;
    if (mine) {
      y1 = box[0];
      x1 = box[1];
      y2 = box[2];
      x2 = box[3];
      on_level = level_index(y1, x1, y2, x2, inv_scale, grads.n) == l;
      if (on_level) {
        for (int i = 0; i < ch; ++i) {
          const Sample s = axis_sample(to_f32(y1), to_f32(y2), i, ch, recip_y, hl);
          count += s.valid && (s.lo == y || s.hi == y);
        }
      }
    }
    int total;
    const int first = block_exclusive_scan(count, warp_sums, &total);
    int n_act;
    const int slot = block_exclusive_scan(count > 0, warp_sums, &n_act);
    if (count > 0) {
      int k = first;
      for (int i = 0; i < ch; ++i) {
        const Sample s = axis_sample(to_f32(y1), to_f32(y2), i, ch, recip_y, hl);
        if (!s.valid || (s.lo != y && s.hi != y)) continue;
        const float w_lo = sub_rn(1.0f, s.lerp);
        float w;
        if (s.lo == y && s.hi == y) w = add_rn(w_lo, s.lerp);
        else if (s.lo == y) w = w_lo;
        else w = s.lerp;
        entries[k++] = Entry{(b * n_per_image + n) * ch + i, w};
      }
      active[slot] = Active{n, first, count};
    }
    if (threadIdx.x == 0) n_active = n_act;
    __syncthreads();

    // 2. Accumulate, ROI by ROI in order.
    for (int a = 0; a < n_active; ++a) {
      const Active act = active[a];
      const BT* abox = boxes + (static_cast<size_t>(b) * n_per_image + act.n) * 4;
      for (int j = threadIdx.x; j < cw; j += kThreads)
        taps[j] = x_tap(axis_sample(to_f32(abox[1]), to_f32(abox[3]), j, cw, recip_x, wl));
      __syncthreads();
      if (has_channel) {
        for (int e = act.first; e < act.first + act.count; ++e) {
          const Entry en = entries[e];
          const T* g = grad_out + static_cast<size_t>(en.row) * cw * c + channel;
          for (int j0 = 0; j0 < cw; j0 += kTapBatch) {
            // all of the batch's cotangent loads in flight at once, then
            // the adds in column order
            float gv[kTapBatch];
#pragma unroll
            for (int k = 0; k < kTapBatch; ++k)
              gv[k] = j0 + k < cw ? load_f32(g + static_cast<size_t>(j0 + k) * c) : 0.0f;
#pragma unroll
            for (int k = 0; k < kTapBatch; ++k) {
              if (j0 + k >= cw) break;
              const XTap t = taps[j0 + k];
              if (t.w_lo != 0.0f && (t.lo & (groups - 1)) == q) {
                float* cell = buf + t.lo * chunk + cl;
                *cell = add_rn(*cell, mul_rn(en.w, mul_rn(t.w_lo, gv[k])));
              }
              if (t.w_hi != 0.0f && (t.hi & (groups - 1)) == q) {
                float* cell = buf + t.hi * chunk + cl;
                *cell = add_rn(*cell, mul_rn(en.w, mul_rn(t.w_hi, gv[k])));
              }
            }
          }
        }
      }
      __syncthreads();
    }
  }

  // 3. The row, whole, in the level's dtype.
  T* out = static_cast<T*>(const_cast<void*>(grads.ptr[l])) +
           (static_cast<size_t>(b) * hl + y) * wl * c;
  for (int e = threadIdx.x; e < wl * chunk; e += kThreads) {
    const int x = e / chunk, k = e - x * chunk;
    if (c0 + k < c) store_from_f32(out + static_cast<size_t>(x) * c + c0 + k, buf[e]);
  }
}

template <typename T, typename BT>
int launch(const Levels& grads, const void* boxes, const void* grad_out, int c, int batch,
           int n_per_image, int ch, int cw, int chunk, int rois_per_pass, double inv_scale,
           float recip_y, float recip_x, cudaStream_t stream) {
  int rows = 0, w_max = 0;
  for (int l = 0; l < grads.n; ++l) {
    rows += batch * grads.h[l];
    w_max = max(w_max, grads.w[l]);
  }
  const size_t smem = static_cast<size_t>(w_max) * chunk * sizeof(float) +
                      static_cast<size_t>(cw) * sizeof(XTap) +
                      static_cast<size_t>(rois_per_pass) * sizeof(Active) +
                      static_cast<size_t>(rois_per_pass) * ch * sizeof(Entry);
  auto kernel = roi_align_backward_kernel<T, BT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(rows, (c + chunk - 1) / chunk);
  kernel<<<grid, kThreads, smem, stream>>>(
      grads, static_cast<const BT*>(boxes), static_cast<const T*>(grad_out), c, batch,
      n_per_image, ch, cw, chunk, rois_per_pass, static_cast<BT>(inv_scale), recip_y, recip_x);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_for_boxes(const Levels& grads, const void* boxes, int boxes_double,
                     const void* grad_out, int c, int batch, int n_per_image, int ch, int cw,
                     int chunk, int rois_per_pass, double inv_scale, float recip_y,
                     float recip_x, cudaStream_t stream) {
  if (boxes_double)
    return launch<T, double>(grads, boxes, grad_out, c, batch, n_per_image, ch, cw, chunk,
                             rois_per_pass, inv_scale, recip_y, recip_x, stream);
  return launch<T, float>(grads, boxes, grad_out, c, batch, n_per_image, ch, cw, chunk,
                          rois_per_pass, inv_scale, recip_y, recip_x, stream);
}

}  // namespace

// grads: n_levels (1..4) NHWC outputs [B, H_l, W_l, C] (P2, P3, ...) of the
// level dtype (dtype_code: kFloat32, kFloat64 or kBFloat16), written
// whole; boxes [B, N, 4] normalized (y1, x1, y2, x2), f64 if boxes_double,
// else f32; grad_out [B, N, ch, cw, C] of the level dtype; inv_scale,
// recip_y, recip_x as for roi_align_batched. chunk is the channels of one
// block (a power of two dividing 256), rois_per_pass the ROIs one scan pass
// takes (at most 256). Launches once on `stream`.
extern "C" int roi_align_backward_batched(void* const* grad_ptrs, const int* heights,
                                          const int* widths, int n_levels, int c, int batch,
                                          int n_per_image, int ch, int cw, const void* boxes,
                                          int boxes_double, double inv_scale, float recip_y,
                                          float recip_x, const void* grad_out, int dtype_code,
                                          int chunk, int rois_per_pass, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || chunk < 1 || chunk > kThreads ||
      kThreads % chunk != 0 || rois_per_pass < 1 || rois_per_pass > kThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  Levels grads;
  for (int l = 0; l < kMaxLevels; ++l) {
    const int k = l < n_levels ? l : 0;
    grads.ptr[l] = grad_ptrs[k];
    grads.h[l] = heights[k];
    grads.w[l] = widths[k];
  }
  grads.n = n_levels;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype_code) {
    case kFloat32:
      return launch_for_boxes<float>(grads, boxes, boxes_double, grad_out, c, batch,
                                     n_per_image, ch, cw, chunk, rois_per_pass, inv_scale,
                                     recip_y, recip_x, s);
    case kFloat64:
      return launch_for_boxes<double>(grads, boxes, boxes_double, grad_out, c, batch,
                                      n_per_image, ch, cw, chunk, rois_per_pass, inv_scale,
                                      recip_y, recip_x, s);
    case kBFloat16:
      return launch_for_boxes<__nv_bfloat16>(grads, boxes, boxes_double, grad_out, c, batch,
                                             n_per_image, ch, cw, chunk, rois_per_pass,
                                             inv_scale, recip_y, recip_x, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
