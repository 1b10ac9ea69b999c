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
// What bounds it: the longest chain of dependent steps into one output
// cell, then bytes. The training step pads its 100 sampled ROIs per image
// with all-zero boxes (detect/targets.py); each of those goes to P2 with
// every sample valid on row 0, column 0, so its whole ch x cw cotangent
// lands on one cell, and real ROIs crowd the few rows where the objects
// are. A kernel that walks each row's (ROI, row sample) entries one by one
// makes such a cell a chain of ch x cw adds per padded ROI in one block
// while the rest of the card idles. Here two
// kernels share the work, so no chain is longer than ch + cw adds inside a
// ROI plus one add per ROI covering the cell:
//
//   1. roi_align_backward_fold: one block per (image x ROI, channel chunk).
//      It computes the ROI's level and sample taps, and the ROI's distinct
//      touched rows and columns as short ascending lists (at most 2 ch and
//      2 cw: each sample touches its floor and ceil), with each sample's
//      contributions sorted by (slot, sample). It folds the cotangent into
//      the ROI's own float32 patch P[roi, row slot, col slot, c], first
//      along x (a[i, col slot] = sum over j of wx * g, in j order, its
//      cotangent loads issued together), then along y (P[row slot, col slot]
//      = sum over i of wy * a, in i order), each cell summed by one thread.
//      The channel-chunk-0 block writes the ROI's metadata: a header
//      {level, counts, row range, column range} and the two lists. A padded
//      ROI folds to one slot in ch + cw adds, in parallel with every other
//      ROI.
//   2. roi_align_backward_gather: one block per (level, image, output row,
//      tile of columns, channel chunk). A block-wide prefix scan over the
//      image's ROI headers lists, in ROI order, the ROIs of its level whose
//      row list holds its row and whose columns meet its tile, with their
//      row slot and column slots there. Their column slots form one stream
//      in ROI order; the block copies it into shared memory a stage at a
//      time (cp.async, the loads of many ROIs in flight together), and the
//      owner thread of each output cell adds the stage's slots that land on
//      it, in stream order, into a float32 tile buffer. It writes the tile
//      whole, zeros included, cast once: the gradient needs no separate
//      zero fill. Crowded rows are split over column tiles, and their blocks
//      start first.
//
// Deterministic: no floating-point atomics; every sum has one order. The
// patch and the metadata are a workspace the caller allocates (no zero
// fill: only the slots a ROI touches are written and read). Bytes: the
// gradient written whole (P2..P5 at 1024^2, B=2, C=256: 178.3 MB in float32,
// 89.1 MB in bfloat16), the cotangent read once (in 16-byte vectors), the
// touched patch slots written and read once in float32.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "roi_align_geometry.cuh"

namespace {

using namespace roi_geometry;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kFoldBatch = 4;     // cotangent loads a fold thread issues together

// One sample along one axis: its two corners and their weights (0 where
// the sample is invalid; at lo alone where lo == hi).
struct Tap {
  int lo;
  int hi;
  float w_lo;
  float w_hi;
};

template <typename T>
struct alignas(16) Vec {
  static constexpr int kN = 16 / sizeof(T);
  T v[kN];
};

__device__ __forceinline__ float to_float(float a) { return a; }
__device__ __forceinline__ float to_float(double a) { return __double2float_rn(a); }
__device__ __forceinline__ float to_float(__nv_bfloat16 a) { return __bfloat162float(a); }
__device__ __forceinline__ void from_float(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_float(double* p, float v) { *p = static_cast<double>(v); }
__device__ __forceinline__ void from_float(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// The weights of JAX's _axis_weights for one sample: a one-hot row with
// (1 - lerp) at lo and lerp at hi, their sum where lo == hi, all zero for
// an invalid sample. A valid sample has lo = floor, hi = ceil (no clamp),
// so w_lo > 0 and, where lo != hi, w_hi > 0.
__device__ __forceinline__ Tap make_tap(const Sample& s) {
  Tap t;
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

// Workspace of one call, for R = B * N ROIs:
//   headers[R]: {level (-1: adds nothing), rows | columns << 16,
//                first row << 16 | last row, first column << 16 | last column};
//   lists[R, 2 ch + 2 cw]: the ascending rows, then the ascending columns;
//   patch[R, 2 ch, 2 cw, C] float32: the folded cotangent at (row slot,
//   column slot).
template <typename T, typename BT>
__global__ void __launch_bounds__(kThreads)
roi_align_backward_fold(Levels levels, const BT* __restrict__ boxes,
                        const T* __restrict__ grad_out, int c, int ch, int cw, int chunk,
                        BT inv_scale, float recip_y, float recip_x, int4* __restrict__ headers,
                        int* __restrict__ lists, float* __restrict__ patch) {
  constexpr int V = Vec<T>::kN;
  extern __shared__ __align__(16) unsigned char smem[];
  // per key (thread t < 2 (ch + cw)): its row or column, its slot
  __shared__ int keys[kThreads];
  __shared__ int slots[kThreads];
  __shared__ int firsts[kThreads];
  // the keys' contributions sorted by (slot, sample): the sample and its
  // weight; starts[s] the first of slot s (rows, then columns from 2 ch + 1)
  __shared__ int sample_of[kThreads];
  __shared__ float weight_of[kThreads];
  __shared__ int starts[kThreads + 2];
  __shared__ Tap taps[kThreads / 2];  // ch row taps, then cw column taps
  __shared__ int row_first, row_last, col_first, col_last;
  float* folded = reinterpret_cast<float*>(smem);  // [ch, columns, chunk]

  const int r = blockIdx.x;  // image * N + ROI
  const int c0 = blockIdx.y * chunk;
  const int t = threadIdx.x;
  const BT* box = boxes + static_cast<size_t>(r) * 4;
  const BT y1 = box[0], x1 = box[1], y2 = box[2], x2 = box[3];
  const int l = level_index(y1, x1, y2, x2, inv_scale, levels.n);
  const int hl = levels.h[l], wl = levels.w[l];

  // 1. The taps of every row and column sample.
  if (t < ch)
    taps[t] = make_tap(axis_sample(to_f32(y1), to_f32(y2), t, ch, recip_y, hl));
  else if (t < ch + cw)
    taps[t] = make_tap(axis_sample(to_f32(x1), to_f32(x2), t - ch, cw, recip_x, wl));
  __syncthreads();

  // 2. The distinct rows and columns, ascending. Thread k < 2 ch holds row
  // key k (corner k & 1 of row sample k / 2), thread 2 ch + k column key k;
  // a key's slot is the number of distinct keys of its axis below it.
  const int m_rows = 2 * ch, m_all = 2 * (ch + cw);
  const bool is_row = t < m_rows;
  const int k = is_row ? t : t - m_rows;
  int key = -1;
  float w = 0.0f;
  if (t < m_all) {
    const Tap& tap = taps[is_row ? (k >> 1) : ch + (k >> 1)];
    w = (k & 1) ? tap.w_hi : tap.w_lo;
    if (w != 0.0f) key = (k & 1) ? tap.hi : tap.lo;
    keys[t] = key;
  }
  __syncthreads();
  const int g0 = is_row ? 0 : m_rows, g1 = is_row ? m_rows : m_all;
  bool first = key >= 0;
  for (int u = g0; first && u < t; ++u) first = keys[u] != key;
  firsts[t] = first;
  const int nrows = __syncthreads_count(first && is_row);
  const int ncols = __syncthreads_count(first && !is_row);
  if (nrows == 0 || ncols == 0) {  // no valid sample on one axis: adds nothing
    if (blockIdx.y == 0 && t == 0) headers[r] = make_int4(-1, 0, 0, 0);
    return;
  }
  int slot = -1;
  if (key >= 0) {
    slot = 0;
    for (int u = g0; u < g1; ++u) slot += firsts[u] && keys[u] < key;
    if (first) {
      if (blockIdx.y == 0) lists[static_cast<size_t>(r) * m_all + g0 + slot] = key;
      if (slot == 0) (is_row ? row_first : col_first) = key;
      if (slot == (is_row ? nrows : ncols) - 1) (is_row ? row_last : col_last) = key;
    }
  }
  if (t < m_all) slots[t] = slot;
  __syncthreads();
  if (key >= 0) {  // this key's place among its axis' contributions
    int pos = 0;
    for (int u = g0; u < g1; ++u)
      pos += keys[u] >= 0 && (slots[u] < slot || (slots[u] == slot && u < t));
    sample_of[g0 + pos] = k >> 1;
    weight_of[g0 + pos] = w;
  }
  // starts[s] for s <= nrows (rows) and 2 ch + 1 + s for s <= ncols
  for (int e = t; e < nrows + ncols + 2; e += kThreads) {
    const bool row = e <= nrows;
    const int s = row ? e : e - nrows - 1;
    const int u0 = row ? 0 : m_rows, u1 = row ? m_rows : m_all;
    int before = u0;
    for (int u = u0; u < u1; ++u) before += keys[u] >= 0 && slots[u] < s;
    starts[row ? s : m_rows + 1 + s] = before;
  }
  __syncthreads();
  if (blockIdx.y == 0 && t == 0)
    headers[r] = make_int4(l, nrows | (ncols << 16), (row_first << 16) | row_last,
                           (col_first << 16) | col_last);
  const int* col_starts = starts + m_rows + 1;

  // 3. Along x: folded[i, col slot, :] = sum over j of wx * g[i, j, :], in
  // j order; thread (i, col slot, vector of V channels), its cotangent
  // loads issued kFoldBatch at a time.
  const int vecs = chunk / V;
  for (int e = t; e < ch * ncols * vecs; e += kThreads) {
    const int kv = e % vecs, rest = e / vecs;
    const int cs = rest % ncols, i = rest / ncols;
    const int cv = c0 + kv * V;
    float acc[V];
#pragma unroll
    for (int q = 0; q < V; ++q) acc[q] = 0.0f;
    if (cv < c) {
      const T* g = grad_out + (static_cast<size_t>(r) * ch + i) * cw * c + cv;
      const int p1 = col_starts[cs + 1];
      for (int p0 = col_starts[cs]; p0 < p1; p0 += kFoldBatch) {
        Vec<T> gv[kFoldBatch];
#pragma unroll
        for (int u = 0; u < kFoldBatch; ++u)
          if (p0 + u < p1)
            gv[u] = *reinterpret_cast<const Vec<T>*>(
                g + static_cast<size_t>(sample_of[p0 + u]) * c);
#pragma unroll
        for (int u = 0; u < kFoldBatch; ++u) {
          if (p0 + u >= p1) break;
          const float wx = weight_of[p0 + u];
#pragma unroll
          for (int q = 0; q < V; ++q) acc[q] = add_rn(acc[q], mul_rn(wx, to_float(gv[u].v[q])));
        }
      }
    }
    float* dst = folded + (static_cast<size_t>(i) * ncols + cs) * chunk + kv * V;
#pragma unroll
    for (int q = 0; q < V; ++q) dst[q] = acc[q];
  }
  __syncthreads();

  // 4. Along y: patch[row slot, col slot, :] = sum over i of wy * folded[i,
  // col slot, :], in i order; thread (row slot, col slot, vector).
  for (int e = t; e < nrows * ncols * vecs; e += kThreads) {
    const int kv = e % vecs, rest = e / vecs;
    const int cs = rest % ncols, rs = rest / ncols;
    const int cv = c0 + kv * V;
    if (cv >= c) continue;
    float acc[V];
#pragma unroll
    for (int q = 0; q < V; ++q) acc[q] = 0.0f;
    for (int p = starts[rs]; p < starts[rs + 1]; ++p) {
      const float wy = weight_of[p];
      const float* a = folded + (static_cast<size_t>(sample_of[p]) * ncols + cs) * chunk + kv * V;
#pragma unroll
      for (int q = 0; q < V; ++q) acc[q] = add_rn(acc[q], mul_rn(wy, a[q]));
    }
    float* dst = patch + ((static_cast<size_t>(r) * m_rows + rs) * (2 * cw) + cs) * c + cv;
    if constexpr (V % 4 == 0) {
#pragma unroll
      for (int q = 0; q < V; q += 4)
        *reinterpret_cast<float4*>(dst + q) = make_float4(acc[q], acc[q + 1], acc[q + 2],
                                                          acc[q + 3]);
    } else {
      *reinterpret_cast<float2*>(dst) = make_float2(acc[0], acc[1]);
    }
  }
}

// The first index of the ascending v[0, n) whose value is >= x.
__device__ __forceinline__ int lower_bound(const int* v, int n, int x) {
  int a = 0, z = n;
  while (a < z) {
    const int m = (a + z) >> 1;
    if (v[m] < x)
      a = m + 1;
    else
      z = m;
  }
  return a;
}

// The slots [*first, *last) of a ROI's ascending list v[0, n) (first value
// lo, last hi) whose values lie in [x0, x1); a dense list (every value
// from lo to hi) needs no search.
__device__ __forceinline__ void slot_range(const int* v, int n, int lo, int hi, int x0, int x1,
                                           int* first, int* last) {
  if (hi - lo + 1 == n) {
    *first = max(x0, lo) - lo;
    *last = min(x1, hi + 1) - lo;
  } else {
    *first = lower_bound(v, n, x0);
    *last = lower_bound(v, n, x1);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
roi_align_backward_gather(Levels grads, const int4* __restrict__ headers,
                          const int* __restrict__ lists, const float* __restrict__ patch,
                          int c, int batch, int n_per_image, int ch, int cw, int chunk,
                          int tile, int stage_slots) {
  constexpr int V = Vec<T>::kN;
  constexpr int PV = V >= 4 ? 4 : 2;  // floats of one asynchronous patch copy
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int warp_sums[kWarps];
  __shared__ int4 active[kThreads];  // {ROI, row slot, first and end column slot}

  // This block: level l, row y, image b, columns [x0, x0 + xw), channels
  // [c0, c0 + chunk). Chunks, then tiles, then images are neighbours in
  // launch order, so the rows start in order (the crowded top of P2 first).
  const int chunks = (c + chunk - 1) / chunk;
  int rr = blockIdx.x / chunks, l = 0;
  const int c0 = (blockIdx.x - rr * chunks) * chunk;
  int tiles = (grads.w[0] + tile - 1) / tile;
  while (l + 1 < grads.n && rr >= batch * grads.h[l] * tiles) {
    rr -= batch * grads.h[l] * tiles;
    ++l;
    tiles = (grads.w[l] + tile - 1) / tile;
  }
  const int hl = grads.h[l], wl = grads.w[l];
  const int y = rr / (batch * tiles);
  rr -= y * batch * tiles;
  const int b = rr / tiles;
  const int x0 = (rr - b * tiles) * tile, xw = min(tile, wl - x0);
  const int m_rows = 2 * ch, m_all = 2 * (ch + cw);

  float* buf = reinterpret_cast<float*>(smem);                        // [tile, chunk]
  float* stage = buf + static_cast<size_t>(tile) * chunk;              // [stage_slots, chunk]
  int* stage_cols = reinterpret_cast<int*>(stage + static_cast<size_t>(stage_slots) * chunk);
  // thread (kk, q) adds into the cells (x0 + x, kk) with x % groups == q
  const int groups = kThreads / chunk;
  const int kk = threadIdx.x % chunk, q = threadIdx.x / chunk;
  bool filled = false;

  for (int pass = 0; pass < n_per_image; pass += kThreads) {
    // 1. Which ROIs of this level hold row y and columns of this tile, in
    // ROI order: the ROI, its row slot, its column slots in the tile.
    const int n = pass + threadIdx.x;
    const int r = b * n_per_image + n;
    int rs = -1, cs0 = 0, cs1 = 0;
    if (n < n_per_image) {
      const int4 h = headers[r];
      const int nrows = h.y & 0xffff, ncols = h.y >> 16;
      const int r_lo = h.z >> 16, r_hi = h.z & 0xffff;
      const int c_lo = h.w >> 16, c_hi = h.w & 0xffff;
      if (h.x == l && r_lo <= y && y <= r_hi && c_lo < x0 + xw && c_hi >= x0) {
        const int* rows = lists + static_cast<size_t>(r) * m_all;
        int r_end;
        slot_range(rows, nrows, r_lo, r_hi, y, y + 1, &rs, &r_end);
        if (r_end == rs) rs = -1;  // a row between two of the ROI's rows
        slot_range(rows + m_rows, ncols, c_lo, c_hi, x0, x0 + xw, &cs0, &cs1);
        if (cs1 == cs0) rs = -1;
      }
    }
    int total;
    const int slot = block_exclusive_scan(rs >= 0, warp_sums, &total);
    if (rs >= 0) active[slot] = make_int4(r, rs, cs0, cs1);
    if (total > 0 && !filled) {
      for (int e = threadIdx.x; e < xw * chunk; e += kThreads) buf[e] = 0.0f;
      filled = true;
    }
    __syncthreads();

    // 2. The listed ROIs' column slots in the tile as one stream, in ROI
    // order, staged stage_slots at a time: the patch rows' cells and their
    // columns copied asynchronously into shared memory, then each cell's
    // owner thread adds the stage's slots in stream order. No two threads
    // add into one cell.
    int a = 0, cs = total > 0 ? active[0].z : 0;  // the stream's position
    while (a < total) {
      int s = 0;
      while (s < stage_slots && a < total) {
        const int4 e = active[a];
        const int k = min(stage_slots - s, e.w - cs);
        const float* p = patch +
            ((static_cast<size_t>(e.x) * m_rows + e.y) * (2 * cw) + cs) * c + c0;
        for (int v = threadIdx.x * PV; v < k * chunk; v += kThreads * PV) {
          const int j = v / chunk, kv = v - j * chunk;
          if (c0 + kv < c)
            __pipeline_memcpy_async(stage + (s + j) * chunk + kv,
                                    p + static_cast<size_t>(j) * c + kv, PV * sizeof(float));
        }
        const int* cols = lists + static_cast<size_t>(e.x) * m_all + m_rows + cs;
        for (int j = threadIdx.x; j < k; j += kThreads)
          __pipeline_memcpy_async(stage_cols + s + j, cols + j, sizeof(int));
        s += k;
        cs += k;
        if (cs == e.w && ++a < total) cs = active[a].z;
      }
      __pipeline_commit();
      __pipeline_wait_prior(0);
      __syncthreads();
      if (c0 + kk < c) {
        for (int j = 0; j < s; ++j) {
          const int x = stage_cols[j] - x0;
          if ((x & (groups - 1)) == q) {
            float* cell = buf + x * chunk + kk;
            *cell = add_rn(*cell, stage[j * chunk + kk]);
          }
        }
      }
      __syncthreads();
    }
  }

  // 3. The tile of the row, whole, in the level's dtype, as 16-byte vectors
  // (zeros where no ROI was listed).
  T* out = static_cast<T*>(const_cast<void*>(grads.ptr[l])) +
           ((static_cast<size_t>(b) * hl + y) * wl + x0) * c;
  const int vecs = chunk / V;
  for (int e = threadIdx.x; e < xw * vecs; e += kThreads) {
    const int x = e / vecs, kv = e - x * vecs;
    const int cv = c0 + kv * V;
    if (cv >= c) continue;
    Vec<T> res;
#pragma unroll
    for (int k = 0; k < V; ++k)
      from_float(&res.v[k], filled ? buf[x * chunk + kv * V + k] : 0.0f);
    *reinterpret_cast<Vec<T>*>(out + static_cast<size_t>(x) * c + cv) = res;
  }
}

size_t fold_smem_bytes(int ch, int cw, int chunk) {
  return static_cast<size_t>(ch) * 2 * cw * chunk * sizeof(float);
}

size_t gather_smem_bytes(int tile, int chunk, int stage_slots) {
  return static_cast<size_t>(tile + stage_slots) * chunk * sizeof(float) +
         static_cast<size_t>(stage_slots) * sizeof(int);
}

template <typename T, typename BT>
int launch(const Levels& grads, const void* boxes, const void* grad_out, int c, int batch,
           int n_per_image, int ch, int cw, int fold_chunk, int gather_chunk, int tile,
           int stage_slots, double inv_scale, float recip_y, float recip_x, void* meta, void* patch,
           cudaStream_t stream) {
  constexpr int V = Vec<T>::kN;
  if (fold_chunk % V || gather_chunk % V) return static_cast<int>(cudaErrorInvalidValue);
  int row_tiles = 0;
  for (int l = 0; l < grads.n; ++l) row_tiles += batch * grads.h[l] * ((grads.w[l] + tile - 1) / tile);
  const int n_rois = batch * n_per_image;
  int4* headers = static_cast<int4*>(meta);
  int* lists = reinterpret_cast<int*>(headers + n_rois);
  float* work = static_cast<float*>(patch);

  const size_t fold_smem = fold_smem_bytes(ch, cw, fold_chunk);
  auto fold = roi_align_backward_fold<T, BT>;
  cudaError_t err = cudaFuncSetAttribute(fold, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(fold_smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  fold<<<dim3(n_rois, (c + fold_chunk - 1) / fold_chunk), kThreads, fold_smem, stream>>>(
      grads, static_cast<const BT*>(boxes), static_cast<const T*>(grad_out), c, ch, cw,
      fold_chunk, static_cast<BT>(inv_scale), recip_y, recip_x, headers, lists, work);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t gather_smem = gather_smem_bytes(tile, gather_chunk, stage_slots);
  auto gather = roi_align_backward_gather<T>;
  err = cudaFuncSetAttribute(gather, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(gather_smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = row_tiles * ((c + gather_chunk - 1) / gather_chunk);
  gather<<<blocks, kThreads, gather_smem, stream>>>(grads, headers, lists, work, c, batch,
                                                    n_per_image, ch, cw, gather_chunk, tile,
                                                    stage_slots);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_for_boxes(const Levels& grads, const void* boxes, int boxes_double,
                     const void* grad_out, int c, int batch, int n_per_image, int ch, int cw,
                     int fold_chunk, int gather_chunk, int tile, int stage_slots,
                     double inv_scale,
                     float recip_y, float recip_x, void* meta, void* patch,
                     cudaStream_t stream) {
  if (boxes_double)
    return launch<T, double>(grads, boxes, grad_out, c, batch, n_per_image, ch, cw,
                             fold_chunk, gather_chunk, tile, stage_slots, inv_scale,
                             recip_y, recip_x, meta, patch, stream);
  return launch<T, float>(grads, boxes, grad_out, c, batch, n_per_image, ch, cw, fold_chunk,
                          gather_chunk, tile, stage_slots, inv_scale, recip_y, recip_x, meta,
                          patch, stream);
}

}  // namespace

// grads: n_levels (1..4) NHWC outputs [B, H_l, W_l, C] (P2, P3, ...) of the
// level dtype (dtype_code: kFloat32, kFloat64 or kBFloat16), written
// whole; boxes [B, N, 4] normalized (y1, x1, y2, x2), f64 if boxes_double,
// else f32; grad_out [B, N, ch, cw, C] of the level dtype; inv_scale,
// recip_y, recip_x as for roi_align_batched. fold_chunk and gather_chunk are
// the channels of one block of each kernel (powers of two up to 256,
// multiples of the 16-byte vector); tile the columns of one gather block,
// stage_slots the column slots it stages at a time; 2 (ch + cw) <= 256. meta (int32, B N (4 + 2 ch +
// 2 cw)) and patch (float32, B N 2 ch 2 cw C) are the workspace, 16-byte
// aligned, uninitialised. Launches the fold, then the gather, on `stream`.
extern "C" int roi_align_backward_batched(void* const* grad_ptrs, const int* heights,
                                          const int* widths, int n_levels, int c, int batch,
                                          int n_per_image, int ch, int cw, const void* boxes,
                                          int boxes_double, double inv_scale, float recip_y,
                                          float recip_x, const void* grad_out, int dtype_code,
                                          int fold_chunk, int gather_chunk, int tile,
                                          int stage_slots, void* meta, void* patch,
                                          void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || ch < 1 || cw < 1 ||
      2 * (ch + cw) > kThreads || fold_chunk < 1 || gather_chunk < 1 ||
      fold_chunk > kThreads || gather_chunk > kThreads ||
      (fold_chunk & (fold_chunk - 1)) || (gather_chunk & (gather_chunk - 1)) ||
      tile < 1 || stage_slots < 1 || reinterpret_cast<uintptr_t>(meta) % 16 ||
      reinterpret_cast<uintptr_t>(patch) % 16)
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
                                     n_per_image, ch, cw, fold_chunk, gather_chunk, tile,
                                     stage_slots, inv_scale, recip_y, recip_x, meta, patch, s);
    case kFloat64:
      return launch_for_boxes<double>(grads, boxes, boxes_double, grad_out, c, batch,
                                      n_per_image, ch, cw, fold_chunk, gather_chunk, tile,
                                      stage_slots, inv_scale, recip_y, recip_x, meta, patch,
                                      s);
    case kBFloat16:
      return launch_for_boxes<__nv_bfloat16>(grads, boxes, boxes_double, grad_out, c, batch,
                                             n_per_image, ch, cw, fold_chunk, gather_chunk,
                                             tile, stage_slots, inv_scale, recip_y, recip_x, meta,
                                             patch, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
