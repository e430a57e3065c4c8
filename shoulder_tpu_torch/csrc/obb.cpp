// Minimum-volume OBB search over hull-face normals.
//
// The PyTorch port's own copy of the JAX package's csrc/obb.cpp, built
// with this directory's ingest.cpp by shoulder_tpu_torch/io/native.py and
// called by shoulder_tpu_torch/host/obb.py::oriented_bounds; the numpy
// loop there (search_numpy) is the semantic oracle.  For every candidate
// face normal of the 3D convex hull, build an in-plane basis, project the
// hull vertices, take the exact 2D minimum-area rectangle (rotating
// calipers over the 2D hull edges), and keep the minimum-volume box, in
// double precision.  Built with -ffp-contract=off: no FMA contraction, so
// every scalar expression rounds as numpy's separate operations do.
//
// Exposed via ctypes (a plain C interface).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

struct P2 {
  double x, y;
};

inline double cross2(const P2 &o, const P2 &a, const P2 &b) {
  return (a.x - o.x) * (b.y - o.y) - (a.y - o.y) * (b.x - o.x);
}

// Andrew monotone chain; returns hull points in CCW order.
void hull2d(std::vector<P2> &pts, std::vector<P2> &out) {
  std::sort(pts.begin(), pts.end(), [](const P2 &a, const P2 &b) {
    return a.x < b.x || (a.x == b.x && a.y < b.y);
  });
  const size_t n = pts.size();
  out.clear();
  if (n < 3) {
    out = pts;
    return;
  }
  std::vector<P2> h(2 * n);
  size_t k = 0;
  for (size_t i = 0; i < n; ++i) {
    while (k >= 2 && cross2(h[k - 2], h[k - 1], pts[i]) <= 0) --k;
    h[k++] = pts[i];
  }
  const size_t lower = k + 1;
  for (size_t i = n - 1; i-- > 0;) {
    while (k >= lower && cross2(h[k - 2], h[k - 1], pts[i]) <= 0) --k;
    h[k++] = pts[i];
  }
  h.resize(k - 1);
  out.swap(h);
}

}  // namespace

namespace {

// Shared inner step: given the in-plane projection of the candidate's
// 2D hull boundary points and the height extent, update the best box.
struct BoxState {
  double best_vol = -1.0;
  double axes[9], lo[3], hi[3];
};

// SoA caliper sweep: xs/ys hold the boundary points.  The per-edge
// extents are min/max reductions over the SAME u/v expressions as the
// original AoS loop — min/max are associative and commutative (values
// are finite here), so the `omp simd` reduction reorder is value-exact;
// the build keeps -ffp-contract=off so no FMA contraction can perturb
// the scalar arithmetic either.  This loop is the OBB search's dominant
// cost (O(m^2) over ~2.7k candidates).
inline void consider_rect(const double *xs, const double *ys, size_t m,
                          double hmin, double hmax, double ax, double ay,
                          double az, double bx, double by, double bz,
                          double nx, double ny, double nz, BoxState &st) {
  for (size_t e = 0; e < m; ++e) {
    const size_t e1 = (e + 1) % m;
    double dx = xs[e1] - xs[e], dy = ys[e1] - ys[e];
    const double dl = std::sqrt(dx * dx + dy * dy);
    if (dl < 1e-15) continue;
    dx /= dl;
    dy /= dl;
    double umin = 1e300, umax = -1e300, vmin = 1e300, vmax = -1e300;
#pragma omp simd reduction(min : umin, vmin) reduction(max : umax, vmax)
    for (size_t i = 0; i < m; ++i) {
      const double u = xs[i] * dx + ys[i] * dy;
      const double v = -xs[i] * dy + ys[i] * dx;
      umin = umin < u ? umin : u;
      umax = umax > u ? umax : u;
      vmin = vmin < v ? vmin : v;
      vmax = vmax > v ? vmax : v;
    }
    const double vol = (umax - umin) * (vmax - vmin) * (hmax - hmin);
    if (st.best_vol < 0.0 || vol < st.best_vol) {
      st.best_vol = vol;
      st.axes[0] = dx * ax + dy * bx;
      st.axes[1] = dx * ay + dy * by;
      st.axes[2] = dx * az + dy * bz;
      st.axes[3] = -dy * ax + dx * bx;
      st.axes[4] = -dy * ay + dx * by;
      st.axes[5] = -dy * az + dx * bz;
      st.axes[6] = nx;
      st.axes[7] = ny;
      st.axes[8] = nz;
      st.lo[0] = umin;
      st.lo[1] = vmin;
      st.lo[2] = hmin;
      st.hi[0] = umax;
      st.hi[1] = vmax;
      st.hi[2] = hmax;
    }
  }
}

}  // namespace

// Silhouette-based exact search: for each candidate normal, the 2D convex
// hull of the projected 3D-hull vertices is exactly the polytope's
// silhouette cycle (edges shared by one front-facing and one back-facing
// hull facet).  Classifying T facets by the sign of normal-dot replaces the
// per-candidate O(H log H) point sort of the plain search — ~4-10x less
// work per candidate with bit-identical rectangles (same in-plane basis,
// same caliper loop).  Candidates whose silhouette fails to chain into one
// clean cycle (near-degenerate normals) fall back to the full 2D hull.
//
// simplices must be consistently wound CCW as seen from outside (host
// orients them against qhull's outward equations before the call);
// neighbors[f][k] is the facet sharing the edge OPPOSITE vertex k (scipy
// ConvexHull convention), i.e. edge (v_{k+1}, v_{k+2}).
extern "C" int shoulder_min_volume_obb_sil(
    const double *hull_pts, int32_t n_pts,
    const int32_t *simplices,   // (T, 3) indices into hull_pts
    const int32_t *neighbors,   // (T, 3)
    const double *face_normals, // (T, 3) outward unit (or unnormalized)
    int32_t n_faces,
    const double *cands, int32_t n_cands,  // (N, 3) candidate normals
    double *out_axes, double *out_lo, double *out_hi) {
  if (n_pts < 3 || n_faces < 1 || n_cands < 1) return 1;

  BoxState st;
  std::vector<uint8_t> front(n_faces);
  std::vector<int32_t> stamp(n_pts, -1), nxt(n_pts);
  std::vector<P2> proj, h2tmp;
  std::vector<double> hxs, hys;
  std::vector<int32_t> cyc;

  // SoA copies of the strided inputs so the per-candidate classification
  // and height loops vectorize
  std::vector<double> px(n_pts), py(n_pts), pz(n_pts);
  for (int32_t i = 0; i < n_pts; ++i) {
    px[i] = hull_pts[3 * i];
    py[i] = hull_pts[3 * i + 1];
    pz[i] = hull_pts[3 * i + 2];
  }
  std::vector<double> fx(n_faces), fy(n_faces), fz(n_faces);
  for (int32_t f = 0; f < n_faces; ++f) {
    fx[f] = face_normals[3 * f];
    fy[f] = face_normals[3 * f + 1];
    fz[f] = face_normals[3 * f + 2];
  }
  // area-weighted facet normals (0.5 * cross of the CCW-wound edges):
  // sum over front facets of (An_f . n) is EXACTLY the projected area of
  // the silhouette polygon — the prune bound below rides the
  // classification pass with them
  std::vector<double> awx(n_faces), awy(n_faces), awz(n_faces);
  for (int32_t f = 0; f < n_faces; ++f) {
    const int32_t i0 = simplices[3 * f], i1 = simplices[3 * f + 1],
                  i2 = simplices[3 * f + 2];
    const double ux = px[i1] - px[i0], uy = py[i1] - py[i0],
                 uz = pz[i1] - pz[i0];
    const double vx = px[i2] - px[i0], vy = py[i2] - py[i0],
                 vz = pz[i2] - pz[i0];
    awx[f] = 0.5 * (uy * vz - uz * vy);
    awy[f] = 0.5 * (uz * vx - ux * vz);
    awz[f] = 0.5 * (ux * vy - uy * vx);
  }

  for (int32_t ci = 0; ci < n_cands; ++ci) {
    const double *nr = cands + 3 * ci;
    double nx = nr[0], ny = nr[1], nz = nr[2];
    const double nn = std::sqrt(nx * nx + ny * ny + nz * nz);
    if (nn < 1e-300) continue;
    nx /= nn;
    ny /= nn;
    nz /= nn;
    // in-plane basis: identical construction to the plain search / oracle
    const double an[3] = {std::fabs(nx), std::fabs(ny), std::fabs(nz)};
    int hidx = 0;
    if (an[1] < an[hidx]) hidx = 1;
    if (an[2] < an[hidx]) hidx = 2;
    double hx = hidx == 0, hy = hidx == 1, hz = hidx == 2;
    double ax = hy * nz - hz * ny;
    double ay = hz * nx - hx * nz;
    double az = hx * ny - hy * nx;
    const double al = std::sqrt(ax * ax + ay * ay + az * az);
    if (al < 1e-300) continue;
    ax /= al;
    ay /= al;
    az /= al;
    const double bx = ny * az - nz * ay;
    const double by = nz * ax - nx * az;
    const double bz = nx * ay - ny * ax;

    // height extent first: the prune bound needs it
    double hmin = 1e300, hmax = -1e300;
#pragma omp simd reduction(min : hmin) reduction(max : hmax)
    for (int32_t i = 0; i < n_pts; ++i) {
      const double hh = px[i] * nx + py[i] * ny + pz[i] * nz;
      hmin = hmin < hh ? hmin : hh;
      hmax = hmax > hh ? hmax : hh;
    }

    // facet classification (elementwise over the SoA normals) fused with
    // the projected-silhouette-area accumulation: any rectangle
    // containing the silhouette polygon has area >= the polygon's, so
    // vol >= hext * aproj.  aproj is a sum over n_faces terms, so its
    // relative rounding error grows ~n*ulp (≈5e-12 at the 40960-face
    // config ceiling); the 1e-10 margin covers that with two orders of
    // slack while still pruning effectively (real losers lose by orders
    // of magnitude).  Survivors run the identical edge-scan/caliper
    // path, so pruning never changes the winner.
    double aproj = 0.0;
#pragma omp simd reduction(+ : aproj)
    for (int32_t f = 0; f < n_faces; ++f) {
      const bool fr = (fx[f] * nx + fy[f] * ny + fz[f] * nz) > 0.0;
      front[f] = fr;
      aproj += fr ? (awx[f] * nx + awy[f] * ny + awz[f] * nz) : 0.0;
    }
    if (st.best_vol >= 0.0 &&
        (hmax - hmin) * aproj * (1.0 - 1e-10) >= st.best_vol) {
      continue;
    }

    // directed silhouette edges chained via per-candidate stamps
    int32_t n_edges = 0, start = -1;
    bool ok = true;
    for (int32_t f = 0; f < n_faces && ok; ++f) {
      if (!front[f]) continue;
      for (int k = 0; k < 3; ++k) {
        const int32_t g = neighbors[3 * f + k];
        if (g >= 0 && g < n_faces && front[g]) continue;
        const int32_t a = simplices[3 * f + (k + 1) % 3];
        const int32_t b = simplices[3 * f + (k + 2) % 3];
        if (stamp[a] == ci) {  // second out-edge from one vertex
          ok = false;
          break;
        }
        stamp[a] = ci;
        nxt[a] = b;
        ++n_edges;
        start = a;
      }
    }
    if (ok && n_edges >= 3) {
      cyc.clear();
      int32_t v = start;
      for (int32_t i = 0; i < n_edges; ++i) {
        if (stamp[v] != ci) {  // chain broke before using every edge
          ok = false;
          break;
        }
        cyc.push_back(v);
        v = nxt[v];
      }
      if (v != start) ok = false;  // not one closed cycle
    } else {
      ok = false;
    }

    if (ok) {
      hxs.resize(cyc.size());
      hys.resize(cyc.size());
      for (size_t i = 0; i < cyc.size(); ++i) {
        const int32_t c = cyc[i];
        hxs[i] = px[c] * ax + py[c] * ay + pz[c] * az;
        hys[i] = px[c] * bx + py[c] * by + pz[c] * bz;
      }
    } else {
      // degenerate silhouette: full projected-hull fallback (exactness)
      proj.resize(n_pts);
      for (int32_t i = 0; i < n_pts; ++i) {
        proj[i].x = px[i] * ax + py[i] * ay + pz[i] * az;
        proj[i].y = px[i] * bx + py[i] * by + pz[i] * bz;
      }
      hull2d(proj, h2tmp);
      if (h2tmp.size() < 2) continue;
      hxs.resize(h2tmp.size());
      hys.resize(h2tmp.size());
      for (size_t i = 0; i < h2tmp.size(); ++i) {
        hxs[i] = h2tmp[i].x;
        hys[i] = h2tmp[i].y;
      }
    }
    consider_rect(hxs.data(), hys.data(), hxs.size(), hmin, hmax, ax, ay, az,
                  bx, by, bz, nx, ny, nz, st);
  }
  if (st.best_vol < 0.0) return 2;
  for (int i = 0; i < 9; ++i) out_axes[i] = st.axes[i];
  for (int i = 0; i < 3; ++i) {
    out_lo[i] = st.lo[i];
    out_hi[i] = st.hi[i];
  }
  return 0;
}

extern "C" int shoulder_min_volume_obb(
    const double *hull_pts,  // (H, 3) row-major 3D hull vertices
    int32_t n_pts,
    const double *normals,  // (N, 3) candidate face normals (deduped)
    int32_t n_normals,
    double *out_axes,  // (3, 3) rows u, v, n (world -> obb rows)
    double *out_lo,    // (3,)
    double *out_hi) {  // (3,)
  if (n_pts < 3 || n_normals < 1) return 1;

  std::vector<P2> proj(n_pts), h2;
  std::vector<double> hgt(n_pts);
  double best_vol = -1.0;

  for (int32_t ni = 0; ni < n_normals; ++ni) {
    const double *nr = normals + 3 * ni;
    double nx = nr[0], ny = nr[1], nz = nr[2];
    const double nn = std::sqrt(nx * nx + ny * ny + nz * nz);
    if (nn < 1e-300) continue;
    nx /= nn;
    ny /= nn;
    nz /= nn;
    // helper = unit axis with the smallest |n| component (matches numpy)
    const double an[3] = {std::fabs(nx), std::fabs(ny), std::fabs(nz)};
    int hidx = 0;
    if (an[1] < an[hidx]) hidx = 1;
    if (an[2] < an[hidx]) hidx = 2;
    double hx = hidx == 0, hy = hidx == 1, hz = hidx == 2;
    // a = cross(helper, n) normalized; b = cross(n, a)
    double ax = hy * nz - hz * ny;
    double ay = hz * nx - hx * nz;
    double az = hx * ny - hy * nx;
    const double al = std::sqrt(ax * ax + ay * ay + az * az);
    if (al < 1e-300) continue;
    ax /= al;
    ay /= al;
    az /= al;
    const double bx = ny * az - nz * ay;
    const double by = nz * ax - nx * az;
    const double bz = nx * ay - ny * ax;

    double hmin = 1e300, hmax = -1e300;
    for (int32_t i = 0; i < n_pts; ++i) {
      const double px = hull_pts[3 * i], py = hull_pts[3 * i + 1],
                   pz = hull_pts[3 * i + 2];
      proj[i].x = px * ax + py * ay + pz * az;
      proj[i].y = px * bx + py * by + pz * bz;
      const double hh = px * nx + py * ny + pz * nz;
      hgt[i] = hh;
      hmin = std::min(hmin, hh);
      hmax = std::max(hmax, hh);
    }
    std::vector<P2> tmp(proj);
    hull2d(tmp, h2);
    const size_t m = h2.size();
    if (m < 2) continue;

    // rotating over 2D hull edges: rectangle aligned to each edge
    for (size_t e = 0; e < m; ++e) {
      const P2 &p0 = h2[e];
      const P2 &p1 = h2[(e + 1) % m];
      double dx = p1.x - p0.x, dy = p1.y - p0.y;
      const double dl = std::sqrt(dx * dx + dy * dy);
      if (dl < 1e-15) continue;
      dx /= dl;
      dy /= dl;
      double umin = 1e300, umax = -1e300, vmin = 1e300, vmax = -1e300;
      for (size_t i = 0; i < m; ++i) {
        const double u = h2[i].x * dx + h2[i].y * dy;
        const double v = -h2[i].x * dy + h2[i].y * dx;
        umin = std::min(umin, u);
        umax = std::max(umax, u);
        vmin = std::min(vmin, v);
        vmax = std::max(vmax, v);
      }
      const double vol = (umax - umin) * (vmax - vmin) * (hmax - hmin);
      if (best_vol < 0.0 || vol < best_vol) {
        best_vol = vol;
        // u3 = dx*a + dy*b ; v3 = -dy*a + dx*b
        out_axes[0] = dx * ax + dy * bx;
        out_axes[1] = dx * ay + dy * by;
        out_axes[2] = dx * az + dy * bz;
        out_axes[3] = -dy * ax + dx * bx;
        out_axes[4] = -dy * ay + dx * by;
        out_axes[5] = -dy * az + dx * bz;
        out_axes[6] = nx;
        out_axes[7] = ny;
        out_axes[8] = nz;
        out_lo[0] = umin;
        out_lo[1] = vmin;
        out_lo[2] = hmin;
        out_hi[0] = umax;
        out_hi[1] = vmax;
        out_hi[2] = hmax;
      }
    }
  }
  return best_vol < 0.0 ? 2 : 0;
}
