// Native bone ingest for the PyTorch port: binary STL or a triangle soup
// -> welded indexed mesh + per-face edge adjacency.
//
// The port's own copy of the JAX package's csrc/ingest.cpp, built by g++
// from this directory and bound with ctypes by shoulder_tpu_torch/io/
// native.py.  The numpy functions of shoulder_tpu_torch/io/stl.py are the
// oracle.  Two entries share one weld and one adjacency:
//
//   * shoulder_ingest_stl (binary STL bytes in) gives what the JAX
//     package's native path gives, bit for bit: its weld keys compare by
//     memcmp, so -0.0 and +0.0 are two vertices, and a non-manifold edge
//     keeps its first two incidences paired;
//   * shoulder_weld_soup (float32 triangles in, as marching tetrahedra
//     writes them) gives what stl.weld followed by stl.edge_face_adjacency
//     gives, bit for bit: its keys compare by value (np.unique), so -0.0
//     and +0.0 are one vertex that keeps the first-seen bits, and only an
//     edge with exactly two incidences is paired.
//
// Semantics shared with io/stl.py:
//   * vertex order = np.unique(..., axis=0)'s lexicographic order (x, then
//     y, then z), first occurrence keeps the vertex,
//   * degenerate faces (repeated vertex index) dropped,
//   * neighbors[f][k] = face sharing edge (faces[f][k], faces[f][(k+1)%3]),
//     -1 on a boundary; watertight iff every edge has exactly two
//     incident faces.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <utility>
#include <vector>

namespace {

struct Key3 {
  float x, y, z;
  bool operator==(const Key3& o) const {
    return std::memcmp(this, &o, sizeof(Key3)) == 0;
  }
};

struct Key3Hash {
  size_t operator()(const Key3& k) const {
    uint32_t a, b, c;
    std::memcpy(&a, &k.x, 4);
    std::memcpy(&b, &k.y, 4);
    std::memcpy(&c, &k.z, 4);
    uint64_t h = a;
    h = h * 0x9E3779B97F4A7C15ull ^ b;
    h = h * 0x9E3779B97F4A7C15ull ^ c;
    return static_cast<size_t>(h);
  }
};

// -0.0f -> +0.0f; every other value keeps its bits
inline float plus_zero(float v) { return v == 0.0f ? 0.0f : v; }

// Weld n_tri triangles whose vertex k lies at base + t * stride + 12 * k
// (three float32).  Writes the vertices in lexicographic order and the
// non-degenerate faces; returns 0, -2 (too many vertices) or -3 (too many
// faces).  by_value: weld keys compare by value (-0.0 == +0.0), not bits.
int weld(const uint8_t* base, int64_t stride, int64_t n_tri, bool by_value,
         float* out_verts, int32_t max_verts, int32_t* out_faces,
         int32_t max_faces, int32_t* n_verts_out, int32_t* n_faces_out) {
  std::unordered_map<Key3, int32_t, Key3Hash> seen;
  seen.reserve(static_cast<size_t>(n_tri) * 2);
  std::vector<Key3> verts;  // first-seen bits
  verts.reserve(static_cast<size_t>(n_tri) / 2 + 8);
  std::vector<int32_t> tri_idx(static_cast<size_t>(n_tri) * 3);

  const uint8_t* rec = base;
  for (int64_t t = 0; t < n_tri; ++t, rec += stride) {
    for (int k = 0; k < 3; ++k) {
      Key3 v;
      std::memcpy(&v, rec + 12 * k, 12);
      Key3 key = v;
      if (by_value) {
        key.x = plus_zero(v.x);
        key.y = plus_zero(v.y);
        key.z = plus_zero(v.z);
      }
      auto it = seen.find(key);
      int32_t idx;
      if (it == seen.end()) {
        idx = static_cast<int32_t>(verts.size());
        verts.push_back(v);
        seen.emplace(key, idx);
      } else {
        idx = it->second;
      }
      tri_idx[t * 3 + k] = idx;
    }
  }
  const int32_t n_verts = static_cast<int32_t>(verts.size());
  if (n_verts > max_verts) return -2;

  // renumber to lexicographic (x,y,z) order to match np.unique
  std::vector<int32_t> order(n_verts);
  for (int32_t i = 0; i < n_verts; ++i) order[i] = i;
  std::sort(order.begin(), order.end(), [&](int32_t a, int32_t b) {
    const Key3& u = verts[a];
    const Key3& v = verts[b];
    if (u.x != v.x) return u.x < v.x;
    if (u.y != v.y) return u.y < v.y;
    return u.z < v.z;
  });
  std::vector<int32_t> rank(n_verts);
  for (int32_t i = 0; i < n_verts; ++i) rank[order[i]] = i;
  for (int32_t i = 0; i < n_verts; ++i) {
    const Key3& v = verts[order[i]];
    out_verts[i * 3 + 0] = v.x;
    out_verts[i * 3 + 1] = v.y;
    out_verts[i * 3 + 2] = v.z;
  }

  int32_t n_faces = 0;
  for (int64_t t = 0; t < n_tri; ++t) {
    const int32_t a = rank[tri_idx[t * 3 + 0]];
    const int32_t b = rank[tri_idx[t * 3 + 1]];
    const int32_t c = rank[tri_idx[t * 3 + 2]];
    if (a == b || b == c || c == a) continue;
    if (n_faces >= max_faces) return -3;
    out_faces[n_faces * 3 + 0] = a;
    out_faces[n_faces * 3 + 1] = b;
    out_faces[n_faces * 3 + 2] = c;
    ++n_faces;
  }
  *n_verts_out = n_verts;
  *n_faces_out = n_faces;
  return 0;
}

// Edge adjacency of faces (n_faces, 3), grouped by sorted (min, max) key
// in (face, slot) order as np.lexsort groups them.  exactly_two: pair only
// edges with two incidences (stl.edge_face_adjacency); otherwise the first
// two incidences of any edge pair up (the JAX package's native ingest).
// Returns watertight: every edge has exactly two incidences.
bool edge_adjacency(const int32_t* faces, int32_t n_faces, bool exactly_two,
                    int32_t* out_neighbors) {
  const int64_t n_slots = static_cast<int64_t>(n_faces) * 3;
  std::vector<std::pair<uint64_t, int64_t>> edges(n_slots);
  for (int64_t s = 0; s < n_slots; ++s) {
    const int64_t f = s / 3, k = s % 3;
    const int32_t u = faces[f * 3 + k];
    const int32_t v = faces[f * 3 + (k + 1) % 3];
    const uint64_t key = (static_cast<uint64_t>(std::min(u, v)) << 32) |
                         static_cast<uint32_t>(std::max(u, v));
    edges[s] = {key, s};
    out_neighbors[s] = -1;
  }
  std::sort(edges.begin(), edges.end());
  bool watertight = true;
  for (int64_t i = 0; i < n_slots;) {
    int64_t j = i + 1;
    while (j < n_slots && edges[j].first == edges[i].first) ++j;
    const int64_t count = j - i;
    if (count != 2) watertight = false;
    if (count == 2 || (!exactly_two && count > 2)) {
      const int64_t a = edges[i].second, b = edges[i + 1].second;
      out_neighbors[a] = static_cast<int32_t>(b / 3);
      out_neighbors[b] = static_cast<int32_t>(a / 3);
    }
    i = j;
  }
  return watertight;
}

}  // namespace

extern "C" {

// Binary STL -> welded mesh.  Returns 0 on success; -1 malformed STL,
// -2 too many vertices, -3 too many faces.
// out_counts = {n_verts, n_faces, watertight(0/1)}
int shoulder_ingest_stl(const uint8_t* data, int64_t n_bytes,
                        float* out_verts, int32_t max_verts,
                        int32_t* out_faces, int32_t* out_neighbors,
                        int32_t max_faces, int32_t* out_counts) {
  if (n_bytes < 84) return -1;
  uint32_t n_tri;
  std::memcpy(&n_tri, data + 80, 4);
  if (84 + static_cast<int64_t>(n_tri) * 50 > n_bytes) return -1;
  int32_t n_verts = 0, n_faces = 0;
  const int rc = weld(data + 84 + 12, 50, n_tri, false, out_verts, max_verts,
                      out_faces, max_faces, &n_verts, &n_faces);
  if (rc != 0) return rc;
  const bool wt = edge_adjacency(out_faces, n_faces, false, out_neighbors);
  out_counts[0] = n_verts;
  out_counts[1] = n_faces;
  out_counts[2] = wt ? 1 : 0;
  return 0;
}

// Float32 triangle soup (n_tri, 3, 3) -> welded mesh, as
// stl.weld + stl.edge_face_adjacency.  Return codes and out_counts as
// shoulder_ingest_stl's.
int shoulder_weld_soup(const float* tris, int64_t n_tri, float* out_verts,
                       int32_t max_verts, int32_t* out_faces,
                       int32_t* out_neighbors, int32_t max_faces,
                       int32_t* out_counts) {
  if (n_tri < 0) return -1;
  int32_t n_verts = 0, n_faces = 0;
  const int rc = weld(reinterpret_cast<const uint8_t*>(tris), 36, n_tri, true,
                      out_verts, max_verts, out_faces, max_faces, &n_verts,
                      &n_faces);
  if (rc != 0) return rc;
  const bool wt = edge_adjacency(out_faces, n_faces, true, out_neighbors);
  out_counts[0] = n_verts;
  out_counts[1] = n_faces;
  out_counts[2] = wt ? 1 : 0;
  return 0;
}

}  // extern "C"
