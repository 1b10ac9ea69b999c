// Batched greedy NMS over score-sorted boxes, for Hopper (sm_90a).
//
// Replaces the TPU kernel sln_amodal_tpu/ops/nms_pallas.py::_nms_kernel
// (reached through nms_sorted_pallas_batched). Same contract as the JAX
// package's ops/nms.py::nms_sorted: boxes [B, N, 4] (y1, x1, y2, x2) f32,
// already sorted by score, a validity mask [B, N]; legacy +1 IoU; box j is
// suppressed by an earlier kept box i when IoU > thr (>= with
// suppress_at_equal). Output: the first max_out kept indices per image in
// score order, padded with pad_value, and their validity.
//
// What bounds it on this card: neither bytes nor operations. The inputs are
// ~100 KB per image and the IoU work (~N^2/2 pairs, ~15 flops each) is
// microseconds of the card's f32 rate; the greedy scan is a chain of
// dependent decisions, so the time is latency: launches and the serial scan.
// The design follows the reference CUDA kernel's two-pass bitmask:
//   pass 1 (nms_mask_kernel): a grid over (column block of 64, row block of
//     64, image); each thread computes one row box's IoU against the 64
//     column boxes held in shared memory and writes one 64-bit suppression
//     word per (row, column block), for j > i only. All pairs in parallel.
//   pass 2 (nms_scan_kernel): one block per image walks the boxes in score
//     order one 64-box word at a time. The removed-bitmask (N/64 words)
//     lives in shared memory and starts from ~valid. One thread resolves
//     the 64 boxes of the current word against the word's diagonal masks
//     (preloaded into shared memory); then all threads OR the rows of the
//     boxes just kept into the later words in parallel. The scan stops once
//     max_out boxes are kept.
// Exactness: keeps near the threshold must equal the plain PyTorch version
// bit for bit, so each IoU is computed in the op order of the JAX package's
// ops/boxes.py::box_iou_plus_one with every rounding spelled out
// (__fadd_rn/__fsub_rn/__fmul_rn/__fdiv_rn), and the file is compiled with
// -fmad=false and without fast math.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 64;
constexpr int kScanThreads = 128;

__device__ __forceinline__ float iou_plus_one(const float a[4], const float b[4]) {
  const float y1 = fmaxf(a[0], b[0]);
  const float x1 = fmaxf(a[1], b[1]);
  const float y2 = fminf(a[2], b[2]);
  const float x2 = fminf(a[3], b[3]);
  const float ih = fmaxf(__fadd_rn(__fsub_rn(y2, y1), 1.0f), 0.0f);
  const float iw = fmaxf(__fadd_rn(__fsub_rn(x2, x1), 1.0f), 0.0f);
  const float inter = __fmul_rn(ih, iw);
  const float area_a = __fmul_rn(__fadd_rn(__fsub_rn(a[2], a[0]), 1.0f),
                                 __fadd_rn(__fsub_rn(a[3], a[1]), 1.0f));
  const float area_b = __fmul_rn(__fadd_rn(__fsub_rn(b[2], b[0]), 1.0f),
                                 __fadd_rn(__fsub_rn(b[3], b[1]), 1.0f));
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  return __fdiv_rn(inter, uni != 0.0f ? uni : 1.0f);
}

__global__ void nms_mask_kernel(const float* __restrict__ boxes, int n,
                                int col_blocks, float thr, int at_equal,
                                unsigned long long* __restrict__ mask) {
  const int col_block = blockIdx.x;
  const int row_block = blockIdx.y;
  const int b = blockIdx.z;
  if (col_block < row_block) return;  // only j > i is ever read

  __shared__ float cols[kBlock][4];
  const float* img = boxes + (size_t)b * n * 4;
  const int col_start = col_block * kBlock;
  const int ncols = min(n - col_start, kBlock);
  if (threadIdx.x < ncols) {
    for (int k = 0; k < 4; ++k) cols[threadIdx.x][k] = img[(size_t)(col_start + threadIdx.x) * 4 + k];
  }
  __syncthreads();

  const int i = row_block * kBlock + threadIdx.x;
  if (i >= n) return;
  float a[4];
  for (int k = 0; k < 4; ++k) a[k] = img[(size_t)i * 4 + k];
  unsigned long long bits = 0;
  const int start = (col_block == row_block) ? threadIdx.x + 1 : 0;
  for (int t = start; t < ncols; ++t) {
    const float iou = iou_plus_one(a, cols[t]);
    const bool hit = at_equal ? (iou >= thr) : (iou > thr);
    if (hit) bits |= 1ULL << t;
  }
  mask[((size_t)b * n + i) * col_blocks + col_block] = bits;
}

__global__ void nms_scan_kernel(const uint8_t* __restrict__ valid,
                                const unsigned long long* __restrict__ mask,
                                int n, int col_blocks, int max_out, int pad_value,
                                int32_t* __restrict__ keep,
                                uint8_t* __restrict__ keep_valid) {
  extern __shared__ unsigned long long removed[];  // [col_blocks]
  __shared__ unsigned long long diag[kBlock];
  __shared__ int kept[kBlock];
  __shared__ int n_kept_word;
  __shared__ int count;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const uint8_t* v = valid + (size_t)b * n;
  const unsigned long long* m = mask + (size_t)b * n * col_blocks;
  int32_t* k_out = keep + (size_t)b * max_out;

  for (int w = tid; w < col_blocks; w += blockDim.x) {
    unsigned long long bits = 0;
    for (int t = 0; t < kBlock; ++t) {
      const int i = w * kBlock + t;
      if (i >= n || !v[i]) bits |= 1ULL << t;
    }
    removed[w] = bits;
  }
  if (tid == 0) count = 0;
  __syncthreads();

  for (int w = 0; w < col_blocks; ++w) {
    if (count >= max_out) break;  // uniform: read after a barrier
    if (tid < kBlock) {
      const int i = w * kBlock + tid;
      diag[tid] = i < n ? m[(size_t)i * col_blocks + w] : 0ULL;
    }
    __syncthreads();
    if (tid == 0) {
      unsigned long long rem = removed[w];
      int c = count;
      int nk = 0;
      for (int t = 0; t < kBlock && c < max_out; ++t) {
        if (!((rem >> t) & 1ULL)) {
          kept[nk++] = w * kBlock + t;
          k_out[c++] = w * kBlock + t;
          rem |= diag[t];
        }
      }
      removed[w] = rem;
      n_kept_word = nk;
      count = c;
    }
    __syncthreads();
    const int nk = n_kept_word;
    for (int w2 = w + 1 + tid; w2 < col_blocks; w2 += blockDim.x) {
      unsigned long long acc = removed[w2];
      for (int k = 0; k < nk; ++k) acc |= m[(size_t)kept[k] * col_blocks + w2];
      removed[w2] = acc;
    }
    __syncthreads();
  }

  const int c = count;
  for (int k = tid; k < max_out; k += blockDim.x) {
    if (k >= c) k_out[k] = pad_value;
    keep_valid[(size_t)b * max_out + k] = k < c ? 1 : 0;
  }
}

}  // namespace

// boxes [B, N, 4] f32, valid [B, N] u8, mask scratch [B, N, ceil(N/64)] u64,
// keep [B, max_out] i32, keep_valid [B, max_out] u8. Launches on `stream`.
extern "C" int nms_sorted_batched(const float* boxes, const uint8_t* valid,
                                  int batch, int n, int max_out, float thr,
                                  int at_equal, int pad_value,
                                  unsigned long long* mask, int32_t* keep,
                                  uint8_t* keep_valid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int col_blocks = (n + kBlock - 1) / kBlock;
  dim3 grid1(col_blocks, col_blocks, batch);
  nms_mask_kernel<<<grid1, kBlock, 0, s>>>(boxes, n, col_blocks, thr, at_equal, mask);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (size_t)col_blocks * sizeof(unsigned long long);
  nms_scan_kernel<<<batch, kScanThreads, smem, s>>>(
      valid, mask, n, col_blocks, max_out, pad_value, keep, keep_valid);
  return (int)cudaGetLastError();
}
