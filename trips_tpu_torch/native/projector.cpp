// Native fan-/parallel-beam projector matrix builder (CSR, line model).
//
// Replaces the host-side matrix generation that the reference obtains from
// the ASTRA C++ toolbox (trips/test_problems/Tomography.py:49-68,
// astra.projector.matrix extraction at trips/utilities/cil_io.py:270-294).
// Incremental Siddon traversal: O(nx + ny) per ray with a tiny constant.
//
// Geometry conventions match trips_tpu/problems/projector.py exactly:
//   image pixel size 1 centered at the origin, row 0 at the top;
//   source S = (so*sin t, -so*cos t); detector center (-od*sin t, od*cos t);
//   detector axis u = (cos t, sin t); sinogram rows angle-major.
//
// A copy of trips_tpu/native/projector.cpp. Built at first use by
// trips_tpu_torch/native/__init__.py (g++, into trips_tpu_torch/_build/).

#include <cmath>
#include <cstdint>
#include <algorithm>
#include <limits>
#include <vector>
#include <cstring>

namespace {

struct Tri {
  int64_t *rowptr;
  int32_t *col;
  double *val;
  int64_t nnz;
  int64_t cap;
};

// Trace one ray S + t*D through the nx x ny unit grid centered at origin,
// appending (pixel, length) pairs for the current CSR row.
inline bool trace_ray(double sx, double sy, double dx, double dy, int nx,
                      int ny, Tri &out) {
  const double xmin = -0.5 * nx, ymin = -0.5 * ny;
  const double xmax = 0.5 * nx, ymax = 0.5 * ny;
  const double inf = std::numeric_limits<double>::infinity();

  double t0 = -inf, t1 = inf;
  // slab clip
  if (std::fabs(dx) > 1e-300) {
    double a = (xmin - sx) / dx, b = (xmax - sx) / dx;
    t0 = std::max(t0, std::min(a, b));
    t1 = std::min(t1, std::max(a, b));
  } else if (sx < xmin || sx > xmax) {
    return true;
  }
  if (std::fabs(dy) > 1e-300) {
    double a = (ymin - sy) / dy, b = (ymax - sy) / dy;
    t0 = std::max(t0, std::min(a, b));
    t1 = std::min(t1, std::max(a, b));
  } else if (sy < ymin || sy > ymax) {
    return true;
  }
  if (t1 <= t0) return true;

  const double norm = std::sqrt(dx * dx + dy * dy);

  // entry point, nudged inside
  double eps = 1e-12 * (t1 - t0);
  double t = t0;
  double px = sx + t * dx, py = sy + t * dy;
  int ix = (int)std::floor(px - xmin);
  int iy = (int)std::floor(py - ymin);
  ix = std::min(std::max(ix, 0), nx - 1);
  iy = std::min(std::max(iy, 0), ny - 1);

  const int step_x = dx > 0 ? 1 : -1;
  const int step_y = dy > 0 ? 1 : -1;
  // t at next x/y grid crossing
  double tx = (std::fabs(dx) > 1e-300)
                  ? ((xmin + (ix + (step_x > 0 ? 1 : 0))) - sx) / dx
                  : inf;
  double ty = (std::fabs(dy) > 1e-300)
                  ? ((ymin + (iy + (step_y > 0 ? 1 : 0))) - sy) / dy
                  : inf;
  const double dtx = (std::fabs(dx) > 1e-300) ? step_x / dx : inf;
  const double dty = (std::fabs(dy) > 1e-300) ? step_y / dy : inf;

  while (t < t1 - eps) {
    double tn = std::min(std::min(tx, ty), t1);
    double seg = (tn - t) * norm;
    if (seg > 1e-12) {
      if (out.nnz >= out.cap) return false;
      int row_img = ny - 1 - iy;
      out.col[out.nnz] = row_img * nx + ix;
      out.val[out.nnz] = seg;
      out.nnz++;
    }
    if (tx <= ty) {
      ix += step_x;
      tx += dtx;
    } else {
      iy += step_y;
      ty += dty;
    }
    t = tn;
    if (ix < 0 || ix >= nx || iy < 0 || iy >= ny) break;
  }
  return true;
}

}  // namespace

extern "C" {

// Returns total nnz, or -1 on capacity overflow.
int64_t fan_beam_csr(int nx, int ny, int n_angles, const double *angles,
                     int det_count, double det_width, double so, double od,
                     int64_t *rowptr, int32_t *col, double *val,
                     int64_t cap) {
  Tri out{rowptr, col, val, 0, cap};
  rowptr[0] = 0;
  int64_t row = 0;
  for (int a = 0; a < n_angles; ++a) {
    double th = angles[a];
    double sx = so * std::sin(th), sy = -so * std::cos(th);
    double cx = -od * std::sin(th), cy = od * std::cos(th);
    double ux = std::cos(th), uy = std::sin(th);
    for (int j = 0; j < det_count; ++j) {
      double off = (j - (det_count - 1) * 0.5) * det_width;
      double ex = cx + off * ux, ey = cy + off * uy;
      if (!trace_ray(sx, sy, ex - sx, ey - sy, nx, ny, out)) return -1;
      rowptr[++row] = out.nnz;
    }
  }
  return out.nnz;
}

int64_t parallel_beam_csr(int nx, int ny, int n_angles, const double *angles,
                          int det_count, double det_width, int64_t *rowptr,
                          int32_t *col, double *val, int64_t cap) {
  Tri out{rowptr, col, val, 0, cap};
  rowptr[0] = 0;
  int64_t row = 0;
  const double far = 2.0 * (nx + ny);
  for (int a = 0; a < n_angles; ++a) {
    double th = angles[a];
    double ux = std::cos(th), uy = std::sin(th);   // detector axis
    double dx = std::sin(th), dy = -std::cos(th);  // ray direction
    for (int j = 0; j < det_count; ++j) {
      double off = (j - (det_count - 1) * 0.5) * det_width;
      double sx = -far * dx + off * ux, sy = -far * dy + off * uy;
      if (!trace_ray(sx, sy, dx * 2 * far, dy * 2 * far, nx, ny, out))
        return -1;
      rowptr[++row] = out.nnz;
    }
  }
  return out.nnz;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Banded-pack hot loop (sparse/banded.py::_pack_angle native twin).
//
// One angle's (detector, line, column) triplets -> per-line integer shear
// (median start), per-(group, detector) predictor (min of rel), and the tap
// index t = c - shift[i] - P[g(i), d] for every nnz. Bit-identical to the
// NumPy implementation (same floor-median, same nearest-present fill with
// first-minimum tie-break). Returns T_a = max(t)+1, or -1 if any t < 0
// (pack invariant violation).
// ---------------------------------------------------------------------------

extern "C" {

int32_t pack_angle(int64_t nnz, const int32_t *d, const int32_t *line,
                   const int32_t *c, int32_t n, int32_t p, int32_t n_groups,
                   int32_t n_pad, int32_t *t_out, int32_t *shift_out,
                   int32_t *P_out) {
  const int32_t INF = std::numeric_limits<int32_t>::max();
  // cmin[i*p + d] = min column of (line i, detector d)
  std::vector<int32_t> cmin((size_t)n * p, INF);
  for (int64_t k = 0; k < nnz; ++k) {
    int32_t &m = cmin[(size_t)line[k] * p + d[k]];
    if (c[k] < m) m = c[k];
  }
  // per-line shear: floor-midpoint median of the valid cmin values
  // (banded.py:62-71 — lo = a[(cnt-1)/2], hi = a[min(cnt/2, p-1)])
  for (int32_t i = 0; i < n_pad; ++i) shift_out[i] = 0;
  std::vector<int32_t> buf(p);
  for (int32_t i = 0; i < n; ++i) {
    int32_t cnt = 0;
    for (int32_t dd = 0; dd < p; ++dd) {
      int32_t v = cmin[(size_t)i * p + dd];
      if (v != INF) buf[cnt++] = v;
    }
    if (!cnt) continue;
    std::sort(buf.begin(), buf.begin() + cnt);
    int32_t lo = buf[(cnt - 1) / 2];
    int32_t hi = buf[std::min(cnt / 2, p - 1)];
    // python floor division of a non-negative sum
    shift_out[i] = (lo + hi) >= 0 ? (lo + hi) / 2 : -(((-(lo + hi)) + 1) / 2);
  }
  // per-group predictor: min over the group's lines of (cmin - shift)
  const int32_t gsize = n_pad / n_groups;
  for (int64_t k = 0; k < (int64_t)n_groups * p; ++k) P_out[k] = INF;
  for (int32_t i = 0; i < n; ++i) {
    int32_t g = i / gsize;
    for (int32_t dd = 0; dd < p; ++dd) {
      int32_t v = cmin[(size_t)i * p + dd];
      if (v == INF) continue;
      int32_t rel = v - shift_out[i];
      int32_t &m = P_out[(size_t)g * p + dd];
      if (rel < m) m = rel;
    }
  }
  // (g, d) cells with no data: nearest present detector of the group,
  // first-minimum tie-break (numpy argmin semantics)
  std::vector<int32_t> ok(p);
  for (int32_t g = 0; g < n_groups; ++g) {
    int32_t *Pg = P_out + (size_t)g * p;
    int32_t nok = 0;
    for (int32_t dd = 0; dd < p; ++dd)
      if (Pg[dd] != INF) ok[nok++] = dd;
    if (nok == 0) {
      for (int32_t dd = 0; dd < p; ++dd) Pg[dd] = 0;
      continue;
    }
    if (nok == p) continue;
    for (int32_t dd = 0; dd < p; ++dd) {
      if (Pg[dd] != INF) continue;
      int32_t best = ok[0], bestdist = std::abs(dd - ok[0]);
      for (int32_t j = 1; j < nok; ++j) {
        int32_t dist = std::abs(dd - ok[j]);
        if (dist < bestdist) { bestdist = dist; best = ok[j]; }
      }
      Pg[dd] = Pg[best];
    }
  }
  // tap index per nnz
  int32_t tmax = -1;
  for (int64_t k = 0; k < nnz; ++k) {
    int32_t g = line[k] / gsize;
    int32_t t = c[k] - shift_out[line[k]] - P_out[(size_t)g * p + d[k]];
    if (t < 0) return -1;
    t_out[k] = t;
    if (t > tmax) tmax = t;
  }
  return tmax + 1;  // T_a (>= 1 enforced by caller for empty angles)
}

}  // extern "C"

// Scatter-fill of one angle's packed weights into the preallocated
// (T, n_pad, p_pad) slab: W[t, i, d] = v. The f32->bf16 conversion is
// round-to-nearest-even, matching numpy/ml_dtypes astype exactly.

extern "C" {

void scatter_fill_f32(int64_t nnz, const int32_t *t, const int32_t *i,
                      const int32_t *d, const float *v, float *W,
                      int64_t sT, int64_t sI) {
  for (int64_t k = 0; k < nnz; ++k)
    W[(int64_t)t[k] * sT + (int64_t)i[k] * sI + d[k]] = v[k];
}

void scatter_fill_bf16(int64_t nnz, const int32_t *t, const int32_t *i,
                       const int32_t *d, const float *v, uint16_t *W,
                       int64_t sT, int64_t sI) {
  for (int64_t k = 0; k < nnz; ++k) {
    uint32_t u;
    std::memcpy(&u, &v[k], 4);
    if ((u & 0x7fffffffu) > 0x7f800000u) {
      u = (u >> 16) | 0x0040u;  // quiet NaN, numpy semantics
    } else {
      u += 0x7fffu + ((u >> 16) & 1u);
      u >>= 16;
    }
    W[(int64_t)t[k] * sT + (int64_t)i[k] * sI + d[k]] = (uint16_t)u;
  }
}

}  // extern "C"
