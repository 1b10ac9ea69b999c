// Shifted-window multi-head self-attention (Swin Transformer), for Hopper.
//
// Computes the op sln_amodal::window_attention, whose plain version is
// ops/window_attention.py::window_attention_plain: for each batch row,
// window of the cyclically rolled token grid and head, the scores
//   S_ij = (q_i * scale) . k_j + table[rel(i, j), h] + M_ij
// (M_ij = -100 between tokens the shift brought from different regions),
// P = softmax(S) in float32, and O = P V written back at each token's own
// grid position. In plain PyTorch that is a dozen passes over the tokens
// (roll, partition, score matmul, bias gather and add, mask add, softmax,
// value matmul, reverse, roll back); here it is one launch per block:
//   - one thread block per (window, head, batch row), one thread per query
//     token (64 threads for the 49 tokens of a 7x7 window);
//   - each token's source position ((y' + s) mod Hp, (x' + s) mod Wp), its
//     shift region (bands [0, Hp - 7), [Hp - 7, Hp - s), [Hp - s, Hp) in
//     each axis) and the relative-position index come from coordinates, so
//     there are no index or mask buffers;
//   - the window's keys and values are read once into shared memory as
//     float32 (16-byte loads of the qkv rows); each thread keeps its scaled
//     query, its 49 scores and its 32 outputs in registers, so the score
//     and value loops read shared memory only as broadcasts;
//   - the output is written as 16-byte vectors at the source positions.
// Arithmetic is float32 for float32 and bfloat16 data (the output rounded
// once, to nearest even); the dot products use explicit fused multiply-adds
// (the build passes -fmad=false, which leaves fmaf alone), so the result
// equals the plain version's to float32 rounding, not bit for bit.
//
// What bounds it: per image at Swin-S's 1024-square frame the qkv read and
// the output write are 443 MB (bf16), 10.9 GFLOP; without tensor cores the
// float32 units, not the bytes, set its pace.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWindow = 7;
constexpr int kTokens = kWindow * kWindow;
constexpr int kHeadDim = 32;
constexpr int kThreads = 64;
constexpr int kBiasSide = 2 * kWindow - 1;
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 2;

__device__ __forceinline__ void unpack(const uint4& raw, float* out, float) {
  const float* f = reinterpret_cast<const float*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) out[i] = f[i];
}

__device__ __forceinline__ void unpack(const uint4& raw, float* out, __nv_bfloat16) {
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = __bfloat162float(h[i]);
}

__device__ __forceinline__ uint4 pack(const float* in, float) {
  uint4 raw;
  float* f = reinterpret_cast<float*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) f[i] = in[i];
  return raw;
}

__device__ __forceinline__ uint4 pack(const float* in, __nv_bfloat16) {
  uint4 raw;
  __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) h[i] = __float2bfloat16_rn(in[i]);
  return raw;
}

// 0, 1 or 2: the shift band of rolled coordinate y in a grid of n
__device__ __forceinline__ int band(int y, int n, int shift) {
  return y < n - kWindow ? 0 : (y < n - shift ? 1 : 2);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
swin_window_attention_kernel(const T* __restrict__ qkv, const float* __restrict__ table,
                             T* __restrict__ out, int hp, int wp, int heads, int shift,
                             float scale) {
  constexpr int kVec = 16 / sizeof(T);           // elements per 16-byte vector
  constexpr int kRowVecs = kHeadDim / kVec;      // vectors per head row
  __shared__ __align__(16) float keys[kTokens * kHeadDim];
  __shared__ __align__(16) float values[kTokens * kHeadDim];
  __shared__ float bias[kBiasSide * kBiasSide];
  __shared__ int source[kTokens];
  __shared__ int region[kTokens];

  const int windows_x = wp / kWindow;
  const int wy = blockIdx.x / windows_x, wx = blockIdx.x % windows_x;
  const int head = blockIdx.y;
  const int channels = heads * kHeadDim;
  const long long row = 3LL * channels;
  const T* base = qkv + (long long)blockIdx.z * hp * wp * row;
  const int t = threadIdx.x;

  if (t < kTokens) {
    const int y = wy * kWindow + t / kWindow, x = wx * kWindow + t % kWindow;
    const int sy = y + shift < hp ? y + shift : y + shift - hp;
    const int sx = x + shift < wp ? x + shift : x + shift - wp;
    source[t] = sy * wp + sx;
    region[t] = shift > 0 ? 3 * band(y, hp, shift) + band(x, wp, shift) : 0;
  }
  for (int i = t; i < kBiasSide * kBiasSide; i += kThreads) bias[i] = table[i * heads + head];
  __syncthreads();

  for (int e = t; e < 2 * kTokens * kRowVecs; e += kThreads) {
    const int part = e / (kTokens * kRowVecs);     // 0: keys, 1: values
    const int r = e - part * kTokens * kRowVecs;
    const int tok = r / kRowVecs, v = r - tok * kRowVecs;
    const uint4 raw = *reinterpret_cast<const uint4*>(
        base + source[tok] * row + (part + 1) * channels + head * kHeadDim + v * kVec);
    unpack(raw, (part ? values : keys) + tok * kHeadDim + v * kVec, T());
  }
  float q[kHeadDim];
  if (t < kTokens) {
#pragma unroll
    for (int v = 0; v < kRowVecs; ++v) {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          base + source[t] * row + head * kHeadDim + v * kVec);
      unpack(raw, q + v * kVec, T());
    }
#pragma unroll
    for (int d = 0; d < kHeadDim; ++d) q[d] = __fmul_rn(q[d], scale);
  }
  __syncthreads();
  if (t >= kTokens) return;

  const int yi = t / kWindow, xi = t % kWindow;
  const int my_region = region[t];
  // each score sums its 32 products in order; the loop over keys is the
  // inner one, so the 49 chains of dependent multiply-adds interleave
  float s[kTokens];
#pragma unroll
  for (int j = 0; j < kTokens; ++j) s[j] = 0.0f;
#pragma unroll
  for (int d = 0; d < kHeadDim / 4; ++d) {
#pragma unroll
    for (int j = 0; j < kTokens; ++j) {
      const float4 kv = reinterpret_cast<const float4*>(keys + j * kHeadDim)[d];
      s[j] = fmaf(q[4 * d], kv.x, s[j]);
      s[j] = fmaf(q[4 * d + 1], kv.y, s[j]);
      s[j] = fmaf(q[4 * d + 2], kv.z, s[j]);
      s[j] = fmaf(q[4 * d + 3], kv.w, s[j]);
    }
  }
  float top = -INFINITY;
#pragma unroll
  for (int j = 0; j < kTokens; ++j) {
    const int yj = j / kWindow, xj = j % kWindow;
    s[j] = __fadd_rn(s[j], bias[(yi - yj + kWindow - 1) * kBiasSide + (xi - xj + kWindow - 1)]);
    if (region[j] != my_region) s[j] = __fadd_rn(s[j], -100.0f);
    top = fmaxf(top, s[j]);
  }
  float sum = 0.0f;
#pragma unroll
  for (int j = 0; j < kTokens; ++j) {
    s[j] = expf(__fsub_rn(s[j], top));
    sum = __fadd_rn(sum, s[j]);
  }
  float o[kHeadDim];
#pragma unroll
  for (int d = 0; d < kHeadDim; ++d) o[d] = 0.0f;
#pragma unroll
  for (int j = 0; j < kTokens; ++j) {
    const float p = __fdiv_rn(s[j], sum);
    const float4* v = reinterpret_cast<const float4*>(values + j * kHeadDim);
#pragma unroll
    for (int d = 0; d < kHeadDim / 4; ++d) {
      const float4 vv = v[d];
      o[4 * d] = fmaf(p, vv.x, o[4 * d]);
      o[4 * d + 1] = fmaf(p, vv.y, o[4 * d + 1]);
      o[4 * d + 2] = fmaf(p, vv.z, o[4 * d + 2]);
      o[4 * d + 3] = fmaf(p, vv.w, o[4 * d + 3]);
    }
  }
  T* dst = out + (long long)blockIdx.z * hp * wp * channels + (long long)source[t] * channels +
           head * kHeadDim;
#pragma unroll
  for (int v = 0; v < kRowVecs; ++v)
    *reinterpret_cast<uint4*>(dst + v * kVec) = pack(o + v * kVec, T());
}

template <typename T>
cudaError_t launch(const void* qkv, const void* table, void* out, int batch, int hp, int wp,
                   int heads, int shift, float scale, cudaStream_t stream) {
  const dim3 grid((hp / kWindow) * (wp / kWindow), heads, batch);
  swin_window_attention_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(qkv), static_cast<const float*>(table), static_cast<T*>(out), hp,
      wp, heads, shift, scale);
  return cudaGetLastError();
}

}  // namespace

// qkv [batch, hp, wp, 3 * heads * head_dim] (dtype_code: kFloat32 or
// kBFloat16), 16-byte aligned; table [(2 * window - 1)^2, heads] float32;
// out [batch, hp, wp, heads * head_dim]. hp and wp multiples of the window;
// the kernel is built for window 7 and head size 32. Returns the launch's
// cudaError_t.
extern "C" int window_attention(const void* qkv, const void* table, void* out, int batch,
                                int hp, int wp, int heads, int head_dim, int window, int shift,
                                float scale, int dtype_code, cudaStream_t stream) {
  if (window != kWindow || head_dim != kHeadDim || hp % kWindow || wp % kWindow ||
      shift < 0 || shift >= kWindow || heads <= 0 || heads > 65535 || batch > 65535)
    return cudaErrorInvalidValue;
  switch (dtype_code) {
    case kFloat32:
      return launch<float>(qkv, table, out, batch, hp, wp, heads, shift, scale, stream);
    case kBFloat16:
      return launch<__nv_bfloat16>(qkv, table, out, batch, hp, wp, heads, shift, scale,
                                   stream);
    default:
      return cudaErrorInvalidValue;
  }
}
