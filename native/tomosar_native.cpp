// tomosar_native: C++ host-runtime kernels for the framework's data path.
//
// The reference offloads its host hot loops to third-party native code
// (laspy's numpy internals, rasterio/GDAL, open3d; SURVEY.md §2.2). Here the
// equivalents are first-party: LAS parsing, 2D bbox cropping, homogeneous
// point transforms, cell-id bucketing/sorting for scatter-friendly layouts,
// max-z rasterization, and the generator's weighted blend accumulation.
// Exposed as a plain C ABI for ctypes (no pybind11 in the image).
//
// Build: make -C native  (g++ -O3 -march=native -shared -fPIC)

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// 2D strict bbox crop: writes indices of points with xmin < x < xmax,
// ymin < y < ymax (parity: reference utils/crop_cloud.py:8-29).
// Returns the number of hits. pts is (n, stride) row-major float64.
int64_t ts_crop_pc_2d(const double* pts, int64_t n, int64_t stride,
                      double xmin, double ymin, double xmax, double ymax,
                      int64_t* out_idx) {
  int64_t k = 0;
  for (int64_t i = 0; i < n; ++i) {
    const double x = pts[i * stride];
    const double y = pts[i * stride + 1];
    // branch-free accumulate compiles to SIMD-friendly code
    const bool in = (x > xmin) & (x < xmax) & (y > ymin) & (y < ymax);
    out_idx[k] = i;
    k += in;
  }
  return k;
}

// ---------------------------------------------------------------------------
// Apply a row-major 4x4 homogeneous transform to (n, 3) float64 points,
// writing float32 output (the dataset's normalize-and-cast step,
// reference dataset.py:274-275). w-divide included for generality.
void ts_transform_points_f32(const double* pts, int64_t n, const double* m4,
                             float* out) {
  const double m00 = m4[0], m01 = m4[1], m02 = m4[2], m03 = m4[3];
  const double m10 = m4[4], m11 = m4[5], m12 = m4[6], m13 = m4[7];
  const double m20 = m4[8], m21 = m4[9], m22 = m4[10], m23 = m4[11];
  const double m30 = m4[12], m31 = m4[13], m32 = m4[14], m33 = m4[15];
  for (int64_t i = 0; i < n; ++i) {
    const double x = pts[i * 3], y = pts[i * 3 + 1], z = pts[i * 3 + 2];
    const double w = m30 * x + m31 * y + m32 * z + m33;
    const double inv = 1.0 / w;
    out[i * 3] = static_cast<float>((m00 * x + m01 * y + m02 * z + m03) * inv);
    out[i * 3 + 1] = static_cast<float>((m10 * x + m11 * y + m12 * z + m13) * inv);
    out[i * 3 + 2] = static_cast<float>((m20 * x + m21 * y + m22 * z + m23) * inv);
  }
}

// ---------------------------------------------------------------------------
// Fused crop + transform + re-crop for the patch sampler's inner loop
// (reference dataset.py:233-278 does this in three numpy passes):
// selects points inside the world bbox, transforms to normalized space,
// keeps those strictly inside the unit square, writes float32 (m, 3).
// Returns m. out must have room for n points.
int64_t ts_crop_transform_patch(const double* pts, int64_t n,
                                double xmin, double ymin, double xmax, double ymax,
                                const double* m4, float* out) {
  const double m00 = m4[0], m01 = m4[1], m02 = m4[2], m03 = m4[3];
  const double m10 = m4[4], m11 = m4[5], m12 = m4[6], m13 = m4[7];
  const double m20 = m4[8], m21 = m4[9], m22 = m4[10], m23 = m4[11];
  int64_t k = 0;
  for (int64_t i = 0; i < n; ++i) {
    const double x = pts[i * 3], y = pts[i * 3 + 1], z = pts[i * 3 + 2];
    if (x <= xmin || x >= xmax || y <= ymin || y >= ymax) continue;
    const float nx = static_cast<float>(m00 * x + m01 * y + m02 * z + m03);
    const float ny = static_cast<float>(m10 * x + m11 * y + m12 * z + m13);
    const float nz = static_cast<float>(m20 * x + m21 * y + m22 * z + m23);
    if (nx <= 0.f || nx >= 1.f || ny <= 0.f || ny >= 1.f) continue;
    out[k * 3] = nx;
    out[k * 3 + 1] = ny;
    out[k * 3 + 2] = nz;
    ++k;
  }
  return k;
}

// ---------------------------------------------------------------------------
// LAS 1.0-1.4 reader: header parse + scaled xyz extraction
// (parity: reference utils/io_cloud.py:34-50 via laspy).
// Returns n_points (>=0) or a negative error code; fills out (n, 3) float64
// if out != nullptr, else just reports the count (two-call protocol).
// Errors: -1 open, -2 magic, -3 laz, -4 truncated.
int64_t ts_las_read(const char* path, double* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  unsigned char header[375];
  size_t got = std::fread(header, 1, sizeof(header), f);
  if (got < 227 || std::memcmp(header, "LASF", 4) != 0) {
    std::fclose(f);
    return -2;
  }
  auto rd_u16 = [&](size_t o) { uint16_t v; std::memcpy(&v, header + o, 2); return v; };
  auto rd_u32 = [&](size_t o) { uint32_t v; std::memcpy(&v, header + o, 4); return v; };
  auto rd_u64 = [&](size_t o) { uint64_t v; std::memcpy(&v, header + o, 8); return v; };
  auto rd_f64 = [&](size_t o) { double v; std::memcpy(&v, header + o, 8); return v; };

  const uint8_t ver_major = header[24], ver_minor = header[25];
  const uint32_t offset = rd_u32(96);
  const uint8_t point_format = header[104];
  if (point_format >= 128) {  // LAZ compressed
    std::fclose(f);
    return -3;
  }
  const uint16_t record_len = rd_u16(105);
  uint64_t n = rd_u32(107);
  if (ver_major == 1 && ver_minor >= 4 && n == 0 && got >= 255) n = rd_u64(247);
  const double sx = rd_f64(131), sy = rd_f64(139), sz = rd_f64(147);
  const double ox = rd_f64(155), oy = rd_f64(163), oz = rd_f64(171);

  if (out == nullptr) {
    std::fclose(f);
    return static_cast<int64_t>(n);
  }

  if (std::fseek(f, static_cast<long>(offset), SEEK_SET) != 0) {
    std::fclose(f);
    return -4;
  }
  std::vector<unsigned char> buf(static_cast<size_t>(n) * record_len);
  got = std::fread(buf.data(), 1, buf.size(), f);
  std::fclose(f);
  if (got < buf.size()) return -4;

  for (uint64_t i = 0; i < n; ++i) {
    int32_t xi, yi, zi;
    const unsigned char* rec = buf.data() + i * record_len;
    std::memcpy(&xi, rec, 4);
    std::memcpy(&yi, rec + 4, 4);
    std::memcpy(&zi, rec + 8, 4);
    out[i * 3] = xi * sx + ox;
    out[i * 3 + 1] = yi * sy + oy;
    out[i * 3 + 2] = zi * sz + oz;
  }
  return static_cast<int64_t>(n);
}

// ---------------------------------------------------------------------------
// Cell-id bucketing: cell = floor(x*reso) + reso*floor(y*reso), clipped
// (parity: utils/coordinate.py:12-28) + counting-sort permutation so points
// land cell-contiguous (a scatter-friendly layout for the device).
// pts is (n, stride) float32 normalized coords; writes cell ids and the
// sorted order.
void ts_bucket_points(const float* pts, int64_t n, int64_t stride, int32_t reso,
                      int32_t* cells, int64_t* order) {
  const int64_t ncell = static_cast<int64_t>(reso) * reso;
  std::vector<int64_t> count(ncell + 1, 0);
  for (int64_t i = 0; i < n; ++i) {
    int32_t cx = static_cast<int32_t>(pts[i * stride] * reso);
    int32_t cy = static_cast<int32_t>(pts[i * stride + 1] * reso);
    cx = std::min(std::max(cx, 0), reso - 1);
    cy = std::min(std::max(cy, 0), reso - 1);
    const int32_t c = cx + reso * cy;
    cells[i] = c;
    ++count[c + 1];
  }
  for (int64_t c = 0; c < ncell; ++c) count[c + 1] += count[c];
  for (int64_t i = 0; i < n; ++i) order[count[cells[i]]++] = i;
}

// ---------------------------------------------------------------------------
// Max-z rasterization (the classical-baseline reduction,
// reference scripts/interpolate_*.py pre-step): grid is (rows, cols) float32
// initialized by the caller to -inf; row 0 = north (max y).
void ts_max_z_grid(const double* pts, int64_t n, double xmin, double ymin,
                   double xmax, double ymax, double px, double py,
                   float* grid, int64_t rows, int64_t cols) {
  for (int64_t i = 0; i < n; ++i) {
    const double x = pts[i * 3], y = pts[i * 3 + 1];
    const int64_t c = static_cast<int64_t>(std::floor((x - xmin) / px));
    const int64_t r = static_cast<int64_t>(std::floor((ymax - y) / py));
    if (c < 0 || c >= cols || r < 0 || r >= rows) continue;
    float& cell = grid[r * cols + c];
    const float z = static_cast<float>(pts[i * 3 + 2]);
    if (z > cell) cell = z;
  }
}

// ---------------------------------------------------------------------------
// Weighted patch accumulation for sliding-window stitching
// (reference generator.py:152-154 inner loop): dsm/weight are (H, W) float64
// scene rasters; patch is (ph, pw) float64; w is the (ph, pw) blend weight.
void ts_blend_accumulate(double* dsm, double* weight, int64_t H, int64_t W,
                         const double* patch, const double* w,
                         int64_t ph, int64_t pw, int64_t row0, int64_t col0) {
  for (int64_t r = 0; r < ph; ++r) {
    const int64_t rr = row0 + r;
    if (rr < 0 || rr >= H) continue;
    double* drow = dsm + rr * W;
    double* wrow = weight + rr * W;
    const double* prow = patch + r * pw;
    const double* wprow = w + r * pw;
    for (int64_t c = 0; c < pw; ++c) {
      const int64_t cc = col0 + c;
      if (cc < 0 || cc >= W) continue;
      drow[cc] += prow[c] * wprow[c];
      wrow[cc] += wprow[c];
    }
  }
}

// ---------------------------------------------------------------------------
// Batched, THREADED blend accumulation: one call blends a
// whole batch of patches. Threads partition the SCENE raster into horizontal
// bands — sliding-window patches overlap each other, so parallelizing over
// patches would race on the += of shared pixels; disjoint scene bands cannot.
// patches is (B, ph, pw) float64; w is the shared (ph, pw) blend weight;
// valid[b] == 0 skips patch b (padded loader entries).
void ts_blend_accumulate_batch(double* dsm, double* weight, int64_t H, int64_t W,
                               const double* patches, const double* w,
                               int64_t B, int64_t ph, int64_t pw,
                               const int64_t* rows0, const int64_t* cols0,
                               const uint8_t* valid, int64_t nthreads) {
  nthreads = std::max<int64_t>(1, std::min<int64_t>(nthreads, H));
  auto work = [&](int64_t band_lo, int64_t band_hi) {
    for (int64_t b = 0; b < B; ++b) {
      if (!valid[b]) continue;
      const int64_t r0 = rows0[b], c0 = cols0[b];
      const int64_t rlo = std::max(band_lo, std::max<int64_t>(r0, 0));
      const int64_t rhi = std::min(band_hi, std::min(H, r0 + ph));
      const int64_t clo = std::max<int64_t>(c0, 0);
      const int64_t chi = std::min(W, c0 + pw);
      if (clo >= chi) continue;
      const double* pbase = patches + b * ph * pw;
      for (int64_t rr = rlo; rr < rhi; ++rr) {
        const double* prow = pbase + (rr - r0) * pw - c0;
        const double* srow = w + (rr - r0) * pw - c0;
        double* drow = dsm + rr * W;
        double* wrow = weight + rr * W;
        for (int64_t cc = clo; cc < chi; ++cc) {
          drow[cc] += prow[cc] * srow[cc];
          wrow[cc] += srow[cc];
        }
      }
    }
  };
  if (nthreads <= 1) {
    work(0, H);
    return;
  }
  std::vector<std::thread> threads;
  const int64_t band = (H + nthreads - 1) / nthreads;
  for (int64_t t = 0; t < nthreads; ++t) {
    const int64_t lo = t * band;
    const int64_t hi = std::min(H, lo + band);
    if (lo >= hi) break;
    threads.emplace_back(work, lo, hi);
  }
  for (auto& th : threads) th.join();
}

// version tag for the loader's staleness check
const char* ts_version() { return "tomosar_native 4"; }

}  // extern "C"
