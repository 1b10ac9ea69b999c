// Squash resize of raw uint8 HWC frames to size x size, bit-equal to
// Pillow's fixed-point bilinear (Image.resize(..., Image.BILINEAR)), for
// Hopper (sm_90a).
//
// Computes the op sln_amodal::resize_bilinear_u8, whose plain version is
// ops/resize.py::resize_bilinear_u8_plain. It replaces no TPU kernel: the
// JAX package, like the port before it, resizes each frame with PIL on the
// host (utils/image.py::mold_inputs), and that resize was the largest host
// cost of a detect request. Here the host uploads the raw frames and the
// card resizes them, before the captured graph of the model.
//
// Exactness: the float work of Pillow's resample is all in its coefficient
// tables, which the host makes as Pillow does (ops/resize.py::coefficients:
// per output index (lo, n, k_0..) with int32 weights at 22 fractional
// bits). The kernel does only Pillow's integer arithmetic on them: the
// horizontal pass into a uint8 intermediate,
//   clip8((1 << 21) + sum_t px[lo + t] * k_t),  clip8(v) = clamp(v >> 22, 0, 255),
// then the vertical pass on that intermediate in the same form. Sums are
// int32, as in Pillow (255 * 2^22 * sum(k) + 2^21 stays below 2^31 for
// the tent's non-negative weights).
//
// Design: one block per (frame, band of `band` output rows), all frames of
// a launch (up to kMaxFrames, mixed sizes) in one grid, each frame's
// descriptor (source offset, sizes, its two coefficient tables on the
// device) passed by value and read in place (__grid_constant__).
//   - horizontal pass: the block resamples exactly the input rows its band
//     reads (from the first output row's lo to the last one's lo + n) into
//     shared memory, as uint8, one thread per output column: Pillow's
//     intermediate, restricted to the band;
//   - vertical pass: each thread makes 16 consecutive output bytes of one
//     row (the channels interleaved: the pass is per byte column) from
//     16-byte shared-memory loads of the rows it reads, and writes them
//     with one 16-byte store.
// The tap counts come from the tables: 2-3 when scaling up, 2 * ceil(scale)
// + 1 when scaling down; the host sizes the shared rows from the largest
// band of the launch, so a downscale runs in the same kernel.
//
// What bounds it: bytes. A COCO-size frame (640x480) to 1024 square reads
// 0.92 MB and writes 3.15 MB: 1.2 us at 3.35 TB/s. Its ~20 integer
// multiply-adds per output byte are well under the card's integer rate.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPrecisionBits = 22;
constexpr int kHalf = 1 << (kPrecisionBits - 1);
constexpr int kChannels = 3;
constexpr int kThreads = 256;
constexpr int kMaxFrames = 64;
constexpr int kDescriptorFields = 6;

struct Frame {
  long long src;        // byte offset of the frame in the packed buffer
  const int* hcoef;     // [size, hstride]: (lo, n, k...) per output column
  const int* vcoef;     // [size, vstride]: (lo, n, k...) per output row
  int width;
  int hstride, vstride; // 2 + the taps of each table
};

struct Frames {
  Frame f[kMaxFrames];
};

__device__ __forceinline__ unsigned char clip8(int v) {
  v >>= kPrecisionBits;
  return static_cast<unsigned char>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

__global__ void __launch_bounds__(kThreads)
resize_bilinear_kernel(const unsigned char* __restrict__ packed,
                       unsigned char* __restrict__ out,
                       const __grid_constant__ Frames frames, int size, int band,
                       int smem_rows, int pitch) {
  extern __shared__ __align__(16) unsigned char rows[];  // [smem_rows][pitch]
  const int bands = (size + band - 1) / band;
  const int image = blockIdx.x / bands;
  const int y0 = (blockIdx.x % bands) * band;
  const int y1 = min(y0 + band, size);
  const Frame fr = frames.f[image];
  const int row_bytes = size * kChannels;

  // the input rows the band reads
  const int* vfirst = fr.vcoef + static_cast<long long>(y0) * fr.vstride;
  const int* vlast = fr.vcoef + static_cast<long long>(y1 - 1) * fr.vstride;
  const int r0 = __ldg(vfirst);
  const int r1 = __ldg(vlast) + __ldg(vlast + 1);
  if (r1 - r0 > smem_rows) __trap();  // the host sized the rows from these tables

  // horizontal pass into shared memory
  const unsigned char* src = packed + fr.src;
  const long long in_row = static_cast<long long>(fr.width) * kChannels;
  for (int x = threadIdx.x; x < size; x += kThreads) {
    const int* c = fr.hcoef + static_cast<long long>(x) * fr.hstride;
    const int lo = __ldg(c), n = __ldg(c + 1);
    const unsigned char* first = src + static_cast<long long>(lo) * kChannels;
    for (int r = r0; r < r1; ++r) {
      const unsigned char* p = first + r * in_row;
      int s0 = kHalf, s1 = kHalf, s2 = kHalf;
      for (int t = 0; t < n; ++t) {
        const int k = __ldg(c + 2 + t);
        s0 += static_cast<int>(__ldg(p + kChannels * t)) * k;
        s1 += static_cast<int>(__ldg(p + kChannels * t + 1)) * k;
        s2 += static_cast<int>(__ldg(p + kChannels * t + 2)) * k;
      }
      unsigned char* d = rows + (r - r0) * pitch + x * kChannels;
      d[0] = clip8(s0);
      d[1] = clip8(s1);
      d[2] = clip8(s2);
    }
  }
  __syncthreads();

  // vertical pass, 16 output bytes a thread
  const int chunks = (row_bytes + 15) / 16;
  const bool whole = row_bytes % 16 == 0;
  unsigned char* dst = out + static_cast<long long>(image) * size * row_bytes;
  for (int i = threadIdx.x; i < (y1 - y0) * chunks; i += kThreads) {
    const int y = y0 + i / chunks, col = (i % chunks) * 16;
    const int* c = fr.vcoef + static_cast<long long>(y) * fr.vstride;
    const int lo = __ldg(c) - r0, n = __ldg(c + 1);
    int s[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) s[j] = kHalf;
    for (int t = 0; t < n; ++t) {
      const int k = __ldg(c + 2 + t);
      const uint4 raw = *reinterpret_cast<const uint4*>(rows + (lo + t) * pitch + col);
      const unsigned char* b = reinterpret_cast<const unsigned char*>(&raw);
#pragma unroll
      for (int j = 0; j < 16; ++j) s[j] += static_cast<int>(b[j]) * k;
    }
    unsigned char* d = dst + static_cast<long long>(y) * row_bytes + col;
    if (whole) {
      uint4 packed16;
      unsigned char* v = reinterpret_cast<unsigned char*>(&packed16);
#pragma unroll
      for (int j = 0; j < 16; ++j) v[j] = clip8(s[j]);
      *reinterpret_cast<uint4*>(d) = packed16;
    } else {
      for (int j = 0; j < 16 && col + j < row_bytes; ++j) d[j] = clip8(s[j]);
    }
  }
}

}  // namespace

// One launch over `count` frames (at most kMaxFrames). `frames` is a host
// int64 array [count, 6]: source byte offset, the device addresses of the
// horizontal and vertical coefficient tables, width, and the two tables'
// row strides. `out` is [count, size, size, 3] uint8, 16-byte
// aligned; `smem_rows` the most input rows any band of the launch reads.
extern "C" int resize_bilinear(const void* packed, void* out, const long long* frames,
                               int count, int size, int band, int smem_rows,
                               cudaStream_t stream) {
  if (count <= 0 || count > kMaxFrames || size <= 0 || band <= 0 || smem_rows <= 0)
    return cudaErrorInvalidValue;
  const int pitch = (size * kChannels + 15) / 16 * 16;
  const size_t smem = static_cast<size_t>(smem_rows) * pitch;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        resize_bilinear_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  Frames batch;
  for (int i = 0; i < count; ++i) {
    const long long* f = frames + static_cast<long long>(i) * kDescriptorFields;
    batch.f[i] = Frame{f[0],
                       reinterpret_cast<const int*>(static_cast<uintptr_t>(f[1])),
                       reinterpret_cast<const int*>(static_cast<uintptr_t>(f[2])),
                       static_cast<int>(f[3]), static_cast<int>(f[4]),
                       static_cast<int>(f[5])};
  }
  const int bands = (size + band - 1) / band;
  resize_bilinear_kernel<<<count * bands, kThreads, smem, stream>>>(
      static_cast<const unsigned char*>(packed), static_cast<unsigned char*>(out), batch,
      size, band, smem_rows, pitch);
  return cudaGetLastError();
}
