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
// dependent decisions, so the time is latency and instruction issue. Two
// passes, the reference CUDA kernel's bitmask split:
//   pass 1 (nms_mask_kernel): one block of 64 threads per (row block of 64
//     boxes, column block of 64, image), launched over the col >= row
//     triangle only (a linear index decoded into the pair), since only
//     j > i is ever read. The column boxes and their areas come into shared
//     memory (16-byte box loads); each thread tests one row box against them
//     and writes one 64-bit suppression word, stored column block major,
//     mask[b][col_block][row], so a block's 64 words are one coalesced
//     512-byte store and the scan reads a column's words contiguously. The
//     IEEE division of each IoU is most of this pass's instructions, so a
//     fast quotient with a proven error bound decides every pair that is
//     not within 2^-12 of the threshold, and the exact IoU the rest
//     (suppresses()). Diagonal blocks also write, for each box, the word of
//     the earlier boxes of its own word that suppress it.
//   pass 2 (nms_scan_kernel): one block per image walks the boxes one
//     64-box word at a time. A single warp resolves word w in parallel: the
//     greedy keeps of a word are the one fixed point of "alive and not
//     suppressed by an earlier keep", and iterating that map with two
//     ballots per round settles one more leading box per round, so a word
//     takes as many rounds as its longest suppression chain, not one step
//     per box. The removed bits of word w are built lazily rather than by
//     OR-ing every kept box's row into all later words as soon as it is
//     kept:
//       removed[w] = invalid[w] | G[w] | L[w], where
//       invalid[w] comes from the validity mask, by ballots, before the scan;
//       G[w] = OR of mask[w][k] over boxes k kept in words < w - 1, gathered
//         by the other 15 warps while warp 0 resolves word w - 1 (up to four
//         independent loads in flight per thread, one L2 round trip per
//         word), reduced with __reduce_or_sync and a shared atomicOr;
//       L[w] = OR of mask[w][k] over boxes k kept in word w - 1, from the
//         (row block w - 1, column block w) words that warp 1 brought into
//         shared memory with cp.async a word ahead (with the next word's
//         suppressed-by words), reduced inside warp 0 right after it
//         resolves word w - 1.
//     So the serial chain per word is a few ballot rounds and one barrier;
//     every global load is issued a word ahead. The scan stops once max_out
//     boxes are kept, mid-word if need be.
// Exactness: keeps near the threshold must equal the plain PyTorch version
// bit for bit, so each IoU is computed in the op order of the JAX package's
// ops/boxes.py::box_iou_plus_one with every rounding spelled out
// (__fadd_rn/__fsub_rn/__fmul_rn/__fdiv_rn), the file is compiled with
// -fmad=false and without fast math, and the fast quotient only decides
// pairs whose exact outcome it proves.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kBlock = 64;
constexpr int kScanThreads = 512;
constexpr int kWarps = kScanThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

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

// +1 area of a box, as iou_plus_one computes it.
__device__ __forceinline__ float area_plus_one(const float a[4]) {
  return __fmul_rn(__fadd_rn(__fsub_rn(a[2], a[0]), 1.0f), __fadd_rn(__fsub_rn(a[3], a[1]), 1.0f));
}

// The outcome of iou_plus_one(a, b) > thr (>= with at_equal), with the IEEE
// division only where its rounding can matter. area_a and area_b are the
// boxes' area_plus_one, so inter and uni below are iou_plus_one's. For uni
// in [1e-30, 1e30], __fdividef is within 2 ulp of inter / uni (or overflows
// to inf where the quotient does), and the rounded quotient is within
// 1/2 ulp of it, so a fast quotient beyond thr * (1 +- 2^-12) decides both
// comparisons exactly; between those bounds, for any other union (zero,
// negative, tiny, huge, NaN), and for a threshold outside [1e-30, 1e30],
// the exact iou_plus_one decides. The keeps are iou_plus_one's, bit for bit.
__device__ __forceinline__ bool suppresses(const float a[4], float area_a, const float b[4],
                                           float area_b, float thr, float thr_hi,
                                           float thr_lo, bool filter, int at_equal) {
  const float ih = fmaxf(__fadd_rn(__fsub_rn(fminf(a[2], b[2]), fmaxf(a[0], b[0])), 1.0f), 0.0f);
  const float iw = fmaxf(__fadd_rn(__fsub_rn(fminf(a[3], b[3]), fmaxf(a[1], b[1])), 1.0f), 0.0f);
  const float inter = __fmul_rn(ih, iw);
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  if (filter && uni >= 1e-30f && uni <= 1e30f) {
    const float q = __fdividef(inter, uni);
    if (q >= thr_hi) return true;
    if (q <= thr_lo) return false;
  }
  const float iou = iou_plus_one(a, b);
  return at_equal ? (iou >= thr) : (iou > thr);
}

// OR over the warp, one reduction instruction per 32-bit half.
__device__ __forceinline__ u64 warp_or(u64 v) {
  const unsigned hi = __reduce_or_sync(kFull, static_cast<unsigned>(v >> 32));
  const unsigned lo = __reduce_or_sync(kFull, static_cast<unsigned>(v));
  return (static_cast<u64>(hi) << 32) | lo;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// mask[b][col_block][row] for row < col_blocks * 64 (rows past n are 0),
// then mask[b][c][col_blocks * 64 + t]: the boxes of word c before box t
// that suppress it (the diagonal block read by column). Row stride
// (col_blocks + 1) * 64.
__global__ void nms_mask_kernel(const float4* __restrict__ boxes, int n, int col_blocks,
                                float thr, int at_equal, u64* __restrict__ mask) {
  // blockIdx.x enumerates the triangle column by column: column block c
  // holds row blocks 0..c, starting at c * (c + 1) / 2.
  const int t = blockIdx.x;
  int c = static_cast<int>((sqrt(8.0 * t + 1.0) - 1.0) * 0.5);
  while ((c + 1) * (c + 2) / 2 <= t) ++c;
  while (c * (c + 1) / 2 > t) --c;
  const int row_block = t - c * (c + 1) / 2;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;

  __shared__ float4 cols[kBlock];
  __shared__ float col_area[kBlock];
  const float4* img = boxes + static_cast<size_t>(b) * n;
  const int col_start = c * kBlock;
  const int ncols = min(n - col_start, kBlock);
  const int i = row_block * kBlock + tid;
  const float4 av = i < n ? img[i] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (tid < ncols) {
    const float4 bv = img[col_start + tid];
    const float bb[4] = {bv.x, bv.y, bv.z, bv.w};
    cols[tid] = bv;
    col_area[tid] = area_plus_one(bb);
  }
  __syncthreads();

  const bool filter = thr >= 1e-30f && thr <= 1e30f;
  const float thr_hi = __fmul_rn(thr, 1.0f + 1.0f / 4096.0f);
  const float thr_lo = __fmul_rn(thr, 1.0f - 1.0f / 4096.0f);
  const bool diagonal = c == row_block;
  u64 later = 0, earlier = 0;
  if (i < n) {
    const float a[4] = {av.x, av.y, av.z, av.w};
    const float area_a = area_plus_one(a);
    for (int k = 0; k < ncols; ++k) {
      if (diagonal && k == tid) continue;
      const float4 bv = cols[k];
      const float bb[4] = {bv.x, bv.y, bv.z, bv.w};
      // the +1 IoU is symmetric bit for bit, so on the diagonal the pair
      // (k, i) for k < i is the one box k computes for column i
      if (suppresses(a, area_a, bb, col_area[k], thr, thr_hi, thr_lo, filter, at_equal)) {
        if (diagonal && k < tid) earlier |= 1ULL << k;
        else later |= 1ULL << k;
      }
    }
  }
  u64* out = mask + (static_cast<size_t>(b) * col_blocks + c) * (static_cast<size_t>(col_blocks + 1) * kBlock);
  out[i] = later;
  if (diagonal) out[static_cast<size_t>(col_blocks) * kBlock + tid] = earlier;
}

// Warp 1's look-ahead for word w: the suppressed-by words of its boxes and
// the words of its boxes against word w + 1, by cp.async (committed here,
// waited for by the caller after its other work). 64 words = 512 bytes =
// 32 copies of 16.
__device__ __forceinline__ void prefetch_word(int w, int lane, int col_blocks, const u64* m,
                                              u64* earlier, u64* next) {
  const size_t stride = static_cast<size_t>(col_blocks + 1) * kBlock;
  cp_async16(earlier + 2 * lane, m + w * stride + col_blocks * kBlock + 2 * lane);
  if (w + 1 < col_blocks)
    cp_async16(next + 2 * lane, m + (w + 1) * stride + w * kBlock + 2 * lane);
  cp_async_commit();
}

__global__ void __launch_bounds__(kScanThreads)
nms_scan_kernel(const uint8_t* __restrict__ valid, const u64* __restrict__ mask, int n,
                int col_blocks, int max_out, int pad_value, int32_t* __restrict__ keep,
                uint8_t* __restrict__ keep_valid) {
  extern __shared__ u64 dyn[];
  u64* invalid = dyn;                                  // [col_blocks] removed bits
  int* kept = reinterpret_cast<int*>(dyn + col_blocks);  // [max_out]
  __shared__ __align__(16) u64 earlier[2][kBlock];  // suppressed-by words of word w
  __shared__ __align__(16) u64 next[2][kBlock];     // mask[w + 1][64w + t]
  __shared__ u64 gathered[2];                       // G[w], by the parity of w
  __shared__ int count_after[2];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const uint8_t* v = valid + static_cast<size_t>(b) * n;
  const size_t stride = static_cast<size_t>(col_blocks + 1) * kBlock;
  const u64* m = mask + static_cast<size_t>(b) * col_blocks * stride;
  int32_t* k_out = keep + static_cast<size_t>(b) * max_out;

  // Every word's removed bits from the validity (invalid or past n), by
  // ballots, before the scan; and the look-ahead of word 0.
  for (int w = warp; w < col_blocks; w += kWarps) {
    const int i0 = w * kBlock + lane;
    const unsigned lo = __ballot_sync(kFull, i0 < n && v[i0] != 0);
    const unsigned hi = __ballot_sync(kFull, i0 + 32 < n && v[i0 + 32] != 0);
    if (lane == 0) invalid[w] = ~((static_cast<u64>(hi) << 32) | lo);
  }
  if (warp == 1) {
    prefetch_word(0, lane, col_blocks, m, earlier[0], next[0]);
    cp_async_wait_all();
  }
  if (tid < 2) gathered[tid] = 0ULL;
  __syncthreads();

  int count = 0;     // boxes kept in the words before w (every thread)
  u64 late = 0ULL;   // warp 0: L[w]
  for (int w = 0; w < col_blocks; ++w) {
    const int p = w & 1;
    if (warp == 0) {
      const u64 alive = ~(invalid[w] | late | gathered[p]);
      const u64 e_lo = earlier[p][lane], e_hi = earlier[p][lane + 32];
      __syncwarp();
      if (lane == 0) gathered[p] = 0ULL;  // refilled for word w + 2 after the barrier
      // The word's greedy keeps are the one set K with K = {alive boxes no
      // earlier box of K suppresses}; iterating that map from K = alive
      // fixes one more leading box per round, so it stops there, after as
      // many rounds as the word's longest suppression chain.
      u64 k_set = alive;
      for (;;) {
        const unsigned s_lo = __ballot_sync(kFull, (e_lo & k_set) != 0ULL);
        const unsigned s_hi = __ballot_sync(kFull, (e_hi & k_set) != 0ULL);
        const u64 next_set = alive & ~((static_cast<u64>(s_hi) << 32) | s_lo);
        if (next_set == k_set) break;
        k_set = next_set;
      }
      // the first max_out - count of them, each written at its rank
      const int room = max_out - count;
      const int r_lo = __popcll(k_set & ((1ULL << lane) - 1ULL));
      const int r_hi = __popcll(k_set & ((1ULL << (lane + 32)) - 1ULL));
      const bool in_lo = ((k_set >> lane) & 1ULL) && r_lo < room;
      const bool in_hi = ((k_set >> (lane + 32)) & 1ULL) && r_hi < room;
      if (in_lo) {
        kept[count + r_lo] = w * kBlock + lane;
        k_out[count + r_lo] = w * kBlock + lane;
      }
      if (in_hi) {
        kept[count + r_hi] = w * kBlock + lane + 32;
        k_out[count + r_hi] = w * kBlock + lane + 32;
      }
      if (w + 1 < col_blocks) {
        u64 acc = in_lo ? next[p][lane] : 0ULL;
        if (in_hi) acc |= next[p][lane + 32];
        late = warp_or(acc);
      }
      const int kept_now = __popc(__ballot_sync(kFull, in_lo)) + __popc(__ballot_sync(kFull, in_hi));
      if (lane == 0) count_after[p] = count + kept_now;
    } else if (w + 1 < col_blocks) {
      if (warp == 1) prefetch_word(w + 1, lane, col_blocks, m, earlier[p ^ 1], next[p ^ 1]);
      // G[w + 1]: the boxes kept before word w against word w + 1, four
      // independent loads in flight per thread
      const u64* col = m + (w + 1) * stride;
      constexpr int kGatherers = kScanThreads - 32;
      u64 acc = 0ULL;
      for (int k0 = tid - 32; k0 < count; k0 += 4 * kGatherers) {
        int idx[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) idx[u] = k0 + u * kGatherers < count ? kept[k0 + u * kGatherers] : -1;
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (idx[u] >= 0) acc |= col[idx[u]];
      }
      acc = warp_or(acc);
      if (lane == 0 && acc != 0ULL) atomicOr(&gathered[p ^ 1], acc);
      if (warp == 1) cp_async_wait_all();
    }
    __syncthreads();
    count = count_after[p];
    if (count >= max_out) break;  // uniform: read after a barrier
  }

  for (int k = tid; k < max_out; k += kScanThreads) {
    if (k >= count) k_out[k] = pad_value;
    keep_valid[static_cast<size_t>(b) * max_out + k] = k < count ? 1 : 0;
  }
}

}  // namespace

// boxes [B, N, 4] f32 (16-byte aligned), valid [B, N] bytes (bool),
// mask scratch [B, ceil(N/64), (ceil(N/64) + 1) * 64] u64, keep [B, max_out] i32,
// keep_valid [B, max_out] bytes (bool). Launches both passes on `stream`.
extern "C" int nms_sorted_batched(const float* boxes, const uint8_t* valid,
                                  int batch, int n, int max_out, float thr,
                                  int at_equal, int pad_value,
                                  unsigned long long* mask, int32_t* keep,
                                  uint8_t* keep_valid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int col_blocks = (n + kBlock - 1) / kBlock;
  const dim3 grid1(col_blocks * (col_blocks + 1) / 2, batch);
  nms_mask_kernel<<<grid1, kBlock, 0, s>>>(reinterpret_cast<const float4*>(boxes), n,
                                           col_blocks, thr, at_equal, mask);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = static_cast<size_t>(col_blocks) * sizeof(u64) +
                      static_cast<size_t>(max_out) * sizeof(int);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(nms_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  nms_scan_kernel<<<batch, kScanThreads, smem, s>>>(valid, mask, n, col_blocks, max_out,
                                                    pad_value, keep, keep_valid);
  return static_cast<int>(cudaGetLastError());
}
