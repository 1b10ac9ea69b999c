// COCO-compatible run-length-encoded mask library (fresh C++ implementation).
//
// Implements the semantics of the COCO mask API (the reference vendors it as
// cocoapi/common/maskApi.c) with a C ABI for ctypes binding:
// column-major binary masks, runs alternating 0s/1s starting with zeros,
// 6-bit LEB128-style string codec with cnts[i-2] deltas for i > 2, and the
// COCO polygon rasterization convention (5x supersampling, +.5 rounding,
// column-crossing fill).
//
// Build: g++ -O3 -shared -fPIC -std=c++17 rle.cpp -o librle.so
// (driven by sln_amodal_tpu_torch/native/build.py)

#include <algorithm>
#include <climits>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

using std::size_t;
using u32 = uint32_t;
using u8 = uint8_t;

namespace {

// Zip two run-lists with a boolean op. Op: 0=union, 1=intersect.
static std::vector<u32> zip_runs(const u32* a, int ma, const u32* b, int mb,
                                 int intersect) {
  std::vector<u32> out;
  out.reserve(size_t(ma) + size_t(mb));
  long ra = ma > 0 ? long(a[0]) : 0;  // remaining in current run of A
  long rb = mb > 0 ? long(b[0]) : 0;
  int ia = 1, ib = 1;
  bool va = false, vb = false;        // value of current run
  bool cur = false;
  long acc = 0;
  long remaining_total = ra + rb;
  bool first = true;
  while (true) {
    long step = std::min(ra, rb);
    acc += step;
    ra -= step;
    rb -= step;
    long more = 0;
    if (ra == 0 && ia < ma) { ra = long(a[ia++]); va = !va; }
    more += ra;
    if (rb == 0 && ib < mb) { rb = long(b[ib++]); vb = !vb; }
    more += rb;
    bool v = intersect ? (va && vb) : (va || vb);
    if (v != cur || more == 0) {
      out.push_back(u32(acc));
      acc = 0;
      cur = v;
    }
    if (more == 0) break;
    (void)first;
    (void)remaining_total;
  }
  return out;
}

// Runs of an H x W zero frame with a binary [h, w] crop pasted at
// (y1, x1): column-major, alternating, zeros first. The crop's pixel (i, j)
// is crop[i * rs + j * cs]: (w, 1) for a row-major crop, (1, h) for a
// column-major one.
inline int pasted_runs(const u8* crop, long rs, long cs, int h, int w, int y1,
                       int x1, int H, int W, u32* counts_out) {
  int m = 0;
  u8 prev = 0;
  u32 run = 0;
  auto append = [&](u8 v, long c) {
    if (c <= 0) return;
    if (v == prev) {
      run += u32(c);
      return;
    }
    counts_out[m++] = run;
    prev = v;
    run = u32(c);
  };
  append(0, long(x1) * H);               // all-zero columns left of the box
  for (int j = 0; j < w; ++j) {          // frame column x1+j
    const u8* col = crop + long(j) * cs;
    append(0, y1);
    int i = 0;                           // crop column j, run-compressed
    while (i < h) {
      u8 v = col[long(i) * rs] ? 1 : 0;
      int k = i + 1;
      while (k < h && (col[long(k) * rs] ? 1 : 0) == v) ++k;
      append(v, k - i);
      i = k;
    }
    append(0, H - y1 - h);
  }
  append(0, long(W - x1 - w) * H);       // all-zero columns right of the box
  counts_out[m++] = run;
  return m;
}

// 6-bit LEB128-style codec (ascii 48..111), delta vs cnts[i-2] for i>2.
// Writes no terminator; returns the chars written.
inline int counts_to_chars(const u32* counts, int m, char* out) {
  int p = 0;
  for (int i = 0; i < m; ++i) {
    long x = long(counts[i]);
    if (i > 2) x -= long(counts[i - 2]);
    bool more = true;
    while (more) {
      char c = char(x & 0x1f);
      x >>= 5;
      more = (c & 0x10) ? (x != -1) : (x != 0);
      if (more) c |= 0x20;
      c += 48;
      out[p++] = c;
    }
  }
  return p;
}

}  // namespace

extern "C" {

// Encode a column-major binary mask. Returns run count m (<= h*w+1).
int sln_rle_encode(const u8* mask, int h, int w, u32* counts_out) {
  const long a = long(h) * long(w);
  int m = 0;
  u8 prev = 0;
  u32 run = 0;
  for (long j = 0; j < a; ++j) {
    if (mask[j] != prev) {
      counts_out[m++] = run;
      run = 0;
      prev = mask[j];
    }
    ++run;
  }
  counts_out[m++] = run;
  return m;
}

// Encode the column-major RLE of an H x W zero frame with a ROW-major
// binary crop [h, w] pasted at (y1, x1). Bit-identical to materializing
// the frame and calling sln_rle_encode, but O(h*w + 1) work instead of
// O(H*W) — the eval path's detection masks are box crops pasted into a
// zero frame, so full-frame encoding wastes ~2000x on small boxes.
int sln_rle_encode_pasted(const u8* crop, int h, int w, int y1, int x1,
                          int H, int W, u32* counts_out) {
  return pasted_runs(crop, w, 1, h, w, y1, x1, H, W, counts_out);
}

// COCO strings of n binary crops, each pasted into its own H x W zero
// frame: equal, crop by crop, to sln_rle_to_string of
// sln_rle_encode_pasted. `crops` holds the crops' row-major pixels back to
// back, `dims` (h, w, y1, x1) per crop. The strings are written back to back
// into `out` (crop i's at [offsets[i], offsets[i+1])), which holds
// 7 * sum(w * (h + 2) + 3) chars: a crop has at most w * (h + 2) + 3 runs and
// a run takes at most 7 chars. Returns the chars written. Each crop is
// transposed once, so its runs are scanned down contiguous columns.
long sln_rle_encode_pasted_strings(const u8* crops, const int* dims, int n,
                                   int H, int W, char* out, long* offsets) {
  long most_pixels = 0, most_runs = 0;
  for (int k = 0; k < n; ++k) {
    const long h = dims[4 * k], w = dims[4 * k + 1];
    most_pixels = std::max(most_pixels, h * w);
    most_runs = std::max(most_runs, w * (h + 2) + 3);
  }
  std::vector<u8> cols(static_cast<size_t>(most_pixels) + 1);
  std::vector<u32> runs(static_cast<size_t>(most_runs));
  long p = 0;
  offsets[0] = 0;
  for (int k = 0; k < n; ++k) {
    const int h = dims[4 * k], w = dims[4 * k + 1];
    for (int i = 0; i < h; ++i)
      for (int j = 0; j < w; ++j)
        cols[long(j) * h + i] = crops[long(i) * w + j];
    const int m = pasted_runs(cols.data(), 1, h, h, w, dims[4 * k + 2],
                              dims[4 * k + 3], H, W, runs.data());
    p += counts_to_chars(runs.data(), m, out + p);
    offsets[k + 1] = p;
    crops += long(h) * w;
  }
  return p;
}

// Decode runs into a column-major binary mask of size h*w.
void sln_rle_decode(const u32* counts, int m, u8* mask_out, long size) {
  long p = 0;
  u8 v = 0;
  for (int j = 0; j < m; ++j) {
    long c = long(counts[j]);
    if (p + c > size) c = size - p;
    std::memset(mask_out + p, v, size_t(c));
    p += c;
    v = !v;
  }
  if (p < size) std::memset(mask_out + p, 0, size_t(size - p));
}

long sln_rle_area(const u32* counts, int m) {
  long a = 0;
  for (int j = 1; j < m; j += 2) a += long(counts[j]);
  return a;
}

// Merge n RLEs (concatenated counts + per-RLE lengths). Returns out length.
int sln_rle_merge(const u32* counts, const int* ms, int n, int intersect,
                  u32* out) {
  if (n == 0) return 0;
  std::vector<u32> acc(counts, counts + ms[0]);
  const u32* p = counts + ms[0];
  for (int i = 1; i < n; ++i) {
    acc = zip_runs(acc.data(), int(acc.size()), p, ms[i], intersect);
    p += ms[i];
  }
  std::copy(acc.begin(), acc.end(), out);
  return int(acc.size());
}

// Bounding box (x, y, w, h) of each RLE — COCO rleToBbox semantics.
void sln_rle_to_bbox(const u32* counts, const int* ms, int n, int h,
                     double* bb) {
  const u32* p = counts;
  for (int i = 0; i < n; ++i) {
    int m = (ms[i] / 2) * 2;
    if (m == 0) {
      bb[4 * i] = bb[4 * i + 1] = bb[4 * i + 2] = bb[4 * i + 3] = 0;
      p += ms[i];
      continue;
    }
    long cc = 0;
    long xs = LONG_MAX, ys = LONG_MAX, xe = -1, ye = -1, xp = 0;
    for (int j = 0; j < m; ++j) {
      cc += long(p[j]);
      long t = cc - (j % 2);
      long y = t % h;
      long x = (t - y) / h;
      if (j % 2 == 0) {
        xp = x;
      } else if (xp < x) {
        ys = 0;
        ye = h - 1;
      }
      xs = std::min(xs, x);
      xe = std::max(xe, x);
      ys = std::min(ys, y);
      ye = std::max(ye, y);
    }
    bb[4 * i + 0] = double(xs);
    bb[4 * i + 2] = double(xe - xs + 1);
    bb[4 * i + 1] = double(ys);
    bb[4 * i + 3] = double(ye - ys + 1);
    p += ms[i];
  }
}

void sln_bb_iou(const double* dt, const double* gt, int m, int n,
                const u8* iscrowd, double* out) {
  for (int g = 0; g < n; ++g) {
    const double* G = gt + g * 4;
    double ga = G[2] * G[3];
    bool crowd = iscrowd != nullptr && iscrowd[g];
    for (int d = 0; d < m; ++d) {
      const double* D = dt + d * 4;
      double da = D[2] * D[3];
      out[g * m + d] = 0;
      double w = std::min(D[2] + D[0], G[2] + G[0]) - std::max(D[0], G[0]);
      if (w <= 0) continue;
      double hh = std::min(D[3] + D[1], G[3] + G[1]) - std::max(D[1], G[1]);
      if (hh <= 0) continue;
      double inter = w * hh;
      double u = crowd ? da : da + ga - inter;
      out[g * m + d] = inter / u;
    }
  }
}

// Mask IoU matrix [n_gt, n_dt] flattened as o[g*m+d] — COCO rleIou semantics
// (bbox prefilter, run-zipper intersection, crowd → union = dt area).
void sln_rle_iou(const u32* dt_counts, const int* dt_ms, int m,
                 const u32* gt_counts, const int* gt_ms, int n, int h,
                 const u8* iscrowd, double* out) {
  std::vector<double> db(size_t(m) * 4), gb(size_t(n) * 4);
  sln_rle_to_bbox(dt_counts, dt_ms, m, h, db.data());
  sln_rle_to_bbox(gt_counts, gt_ms, n, h, gb.data());
  sln_bb_iou(db.data(), gb.data(), m, n, iscrowd, out);

  std::vector<const u32*> dp(m), gp(n);
  {
    const u32* p = dt_counts;
    for (int d = 0; d < m; ++d) { dp[d] = p; p += dt_ms[d]; }
    p = gt_counts;
    for (int g = 0; g < n; ++g) { gp[g] = p; p += gt_ms[g]; }
  }

  for (int g = 0; g < n; ++g) {
    for (int d = 0; d < m; ++d) {
      if (out[g * m + d] <= 0) continue;
      bool crowd = iscrowd != nullptr && iscrowd[g];
      long ca = dt_ms[d] ? long(dp[d][0]) : 0;
      long cb = gt_ms[g] ? long(gp[g][0]) : 0;
      int a = 1, b = 1;
      bool va = false, vb = false;
      long inter = 0, uni = 0;
      long more = 1;
      while (more > 0) {
        long c = std::min(ca, cb);
        if (va || vb) {
          uni += c;
          if (va && vb) inter += c;
        }
        more = 0;
        ca -= c;
        if (ca == 0 && a < dt_ms[d]) { ca = long(dp[d][a++]); va = !va; }
        more += ca;
        cb -= c;
        if (cb == 0 && b < gt_ms[g]) { cb = long(gp[g][b++]); vb = !vb; }
        more += cb;
      }
      if (inter == 0)
        uni = 1;
      else if (crowd)
        uni = sln_rle_area(dp[d], dt_ms[d]);
      out[g * m + d] = double(inter) / double(uni);
    }
  }
}

// Greedy NMS over masks in the given order — COCO rleNms semantics
// (maskApi.c:99-107): for each kept mask, suppress every later mask whose
// IoU with it exceeds thr. counts/ms as in sln_rle_iou; keep[i] in {0,1}.
void sln_rle_nms(const u32* counts, const int* ms, int n, int h, double thr,
                 u8* keep) {
  std::vector<const u32*> p(n);
  {
    const u32* q = counts;
    for (int i = 0; i < n; ++i) { p[i] = q; q += ms[i]; }
  }
  for (int i = 0; i < n; ++i) keep[i] = 1;
  double u;
  for (int i = 0; i < n; ++i) {
    if (!keep[i]) continue;
    for (int j = i + 1; j < n; ++j) {
      if (!keep[j]) continue;
      sln_rle_iou(p[i], ms + i, 1, p[j], ms + j, 1, h, nullptr, &u);
      if (u > thr) keep[j] = 0;
    }
  }
}

// Polygon → RLE with the COCO rasterization convention.
// xy: k (x, y) vertex pairs. Writes at most out_cap runs to `out` and
// returns the run count; returns -needed when out_cap is insufficient
// (the crossing count is bounded by boundary travel, not by h*w).
int sln_rle_from_poly(const double* xy, int k, int h, int w, u32* out,
                      int out_cap) {
  const double scale = 5.0;
  std::vector<long> px(k + 1), py(k + 1);
  for (int j = 0; j < k; ++j) px[j] = long(scale * xy[2 * j] + 0.5);
  for (int j = 0; j < k; ++j) py[j] = long(scale * xy[2 * j + 1] + 0.5);
  px[k] = px[0];
  py[k] = py[0];

  // dense boundary points at 5x resolution
  std::vector<long> u, v;
  for (int j = 0; j < k; ++j) {
    long xs = px[j], xe = px[j + 1], ys = py[j], ye = py[j + 1];
    long dx = std::labs(xe - xs), dy = std::labs(ys - ye);
    bool flip = (dx >= dy && xs > xe) || (dx < dy && ys > ye);
    if (flip) { std::swap(xs, xe); std::swap(ys, ye); }
    if (dx >= dy) {
      double s = dx ? double(ye - ys) / double(dx) : 0.0;
      for (long d = 0; d <= dx; ++d) {
        long t = flip ? dx - d : d;
        u.push_back(t + xs);
        v.push_back(long(ys + s * t + 0.5));
      }
    } else {
      double s = dy ? double(xe - xs) / double(dy) : 0.0;
      for (long d = 0; d <= dy; ++d) {
        long t = flip ? dy - d : d;
        v.push_back(t + ys);
        u.push_back(long(xs + s * t + 0.5));
      }
    }
  }

  // column crossings, downsampled to pixel resolution
  std::vector<u32> a;
  for (size_t j = 1; j < u.size(); ++j) {
    if (u[j] == u[j - 1]) continue;
    double xd = double(u[j] < u[j - 1] ? u[j] : u[j] - 1);
    xd = (xd + 0.5) / scale - 0.5;
    if (std::floor(xd) != xd || xd < 0 || xd > w - 1) continue;
    double yd = double(v[j] < v[j - 1] ? v[j] : v[j - 1]);
    yd = (yd + 0.5) / scale - 0.5;
    if (yd < 0) yd = 0;
    else if (yd > h) yd = double(h);
    yd = std::ceil(yd);
    a.push_back(u32(long(xd) * h + long(yd)));
  }

  // crossings → runs (sort, delta, fold zero-gaps)
  a.push_back(u32(long(h) * long(w)));
  std::sort(a.begin(), a.end());
  u32 p = 0;
  for (auto& t : a) {
    u32 tmp = t;
    t -= p;
    p = tmp;
  }
  std::vector<u32> b;
  size_t j = 0;
  b.push_back(a[j++]);
  while (j < a.size()) {
    if (a[j] > 0) {
      b.push_back(a[j++]);
    } else {
      ++j;
      if (j < a.size()) b.back() += a[j++];
    }
  }
  if (int(b.size()) > out_cap) return -int(b.size());
  std::copy(b.begin(), b.end(), out);
  return int(b.size());
}

// The COCO string of m runs (counts_to_chars), NUL-terminated.
int sln_rle_to_string(const u32* counts, int m, char* out) {
  const int p = counts_to_chars(counts, m, out);
  out[p] = 0;
  return p;
}

int sln_rle_from_string(const char* s, u32* out) {
  int m = 0, p = 0;
  while (s[p]) {
    long x = 0;
    int kk = 0;
    bool more = true;
    while (more) {
      char c = char(s[p] - 48);
      x |= long(c & 0x1f) << (5 * kk);
      more = (c & 0x20) != 0;
      ++p;
      ++kk;
      if (!more && (c & 0x10)) x |= -1L << (5 * kk);
    }
    if (m > 2) x += long(out[m - 2]);
    out[m++] = u32(x);
  }
  return m;
}

}  // extern "C"
