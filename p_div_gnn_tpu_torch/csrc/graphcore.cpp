// graphcore — native host-side graph construction for p_div_gnn_tpu_torch:
// the copy of the JAX package's csrc/graphcore.cpp.
//
// Face→edge extraction with canonical coalescing, boundary-region node
// labeling, and periodic boundary pairing, behind a plain C ABI that
// graphs/native.py loads with ctypes. The numpy implementations in
// graphs/build.py, labels.py and periodic.py remain the behavioral
// reference. It includes no PyTorch header.
//
// Build (graphs/native.py does it at first use):
//   g++ -O3 -shared -fPIC -std=c++17 -o graphcore.so graphcore.cpp

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <unordered_map>
#include <vector>

extern "C" {

// Faces (n_faces × arity, row-major int64 node ids) → undirected,
// symmetrized, deduped edge list sorted by (sender, receiver).
// out_edges must have capacity 2 * arity * n_faces * 2 entries
// (sender/receiver interleaved per edge is NOT used; layout: all senders,
// then all receivers at offset `capacity`).
// Returns the number of edges written.
int64_t pdg_faces_to_edges(const int64_t* faces, int64_t n_faces,
                           int64_t arity, int64_t n_nodes,
                           int64_t* out_senders, int64_t* out_receivers) {
  std::vector<uint64_t> keys;
  keys.reserve(2 * arity * n_faces);
  const uint64_t n = static_cast<uint64_t>(n_nodes);
  for (int64_t f = 0; f < n_faces; ++f) {
    const int64_t* face = faces + f * arity;
    for (int64_t i = 0; i < arity; ++i) {
      // triangles pair (0,1),(1,2),(2,0); quads pair consecutive + wrap,
      // skipping diagonals — same pairings as build.faces_to_edge_index.
      uint64_t a = static_cast<uint64_t>(face[i]);
      uint64_t b = static_cast<uint64_t>(face[(i + 1) % arity]);
      keys.push_back(a * n + b);
      keys.push_back(b * n + a);
    }
  }
  std::sort(keys.begin(), keys.end());
  keys.erase(std::unique(keys.begin(), keys.end()), keys.end());
  const int64_t m = static_cast<int64_t>(keys.size());
  for (int64_t i = 0; i < m; ++i) {
    out_senders[i] = static_cast<int64_t>(keys[i] / n);
    out_receivers[i] = static_cast<int64_t>(keys[i] % n);
  }
  return m;
}

// Node labels: 0 interior, 1 external boundary, -1 internal boundary.
// Boundary edges = undirected edges incident to exactly one face;
// connected components via union-find; the component touching the 2D
// bounding box is external. Requires exactly two boundary regions;
// returns number of regions found (caller asserts == 2), or -1 on error.
static int64_t uf_find(std::vector<int64_t>& parent, int64_t a) {
  int64_t root = a;
  while (parent[root] != root) root = parent[root];
  while (parent[a] != root) {
    int64_t next = parent[a];
    parent[a] = root;
    a = next;
  }
  return root;
}

int64_t pdg_label_nodes(const int64_t* faces, int64_t n_faces, int64_t arity,
                        int64_t n_nodes, const double* pts2d,
                        int64_t* out_labels) {
  std::vector<uint64_t> keys;
  keys.reserve(arity * n_faces);
  const uint64_t n = static_cast<uint64_t>(n_nodes);
  for (int64_t f = 0; f < n_faces; ++f) {
    const int64_t* face = faces + f * arity;
    for (int64_t i = 0; i < arity; ++i) {
      uint64_t a = static_cast<uint64_t>(face[i]);
      uint64_t b = static_cast<uint64_t>(face[(i + 1) % arity]);
      if (a > b) std::swap(a, b);
      keys.push_back(a * n + b);
    }
  }
  std::sort(keys.begin(), keys.end());
  // keep keys appearing exactly once
  std::vector<int64_t> parent(n_nodes);
  std::iota(parent.begin(), parent.end(), 0);
  std::vector<uint8_t> on_boundary(n_nodes, 0);
  for (size_t i = 0; i < keys.size();) {
    size_t j = i;
    while (j < keys.size() && keys[j] == keys[i]) ++j;
    if (j - i == 1) {
      int64_t a = static_cast<int64_t>(keys[i] / n);
      int64_t b = static_cast<int64_t>(keys[i] % n);
      on_boundary[a] = on_boundary[b] = 1;
      int64_t ra = uf_find(parent, a), rb = uf_find(parent, b);
      if (ra != rb) parent[rb] = ra;
    }
    i = j;
  }
  // bounding box
  double min_x = 1e300, max_x = -1e300, min_y = 1e300, max_y = -1e300;
  for (int64_t i = 0; i < n_nodes; ++i) {
    min_x = std::min(min_x, pts2d[2 * i]);
    max_x = std::max(max_x, pts2d[2 * i]);
    min_y = std::min(min_y, pts2d[2 * i + 1]);
    max_y = std::max(max_y, pts2d[2 * i + 1]);
  }
  std::unordered_map<int64_t, int64_t> region_of_root;
  std::vector<uint8_t> region_touches_bounds;
  for (int64_t i = 0; i < n_nodes; ++i) {
    if (!on_boundary[i]) continue;
    int64_t r = uf_find(parent, i);
    auto it = region_of_root.find(r);
    int64_t rid;
    if (it == region_of_root.end()) {
      rid = static_cast<int64_t>(region_of_root.size());
      region_of_root.emplace(r, rid);
      region_touches_bounds.push_back(0);
    } else {
      rid = it->second;
    }
    const double x = pts2d[2 * i], y = pts2d[2 * i + 1];
    if (x == min_x || x == max_x || y == min_y || y == max_y)
      region_touches_bounds[rid] = 1;
  }
  const int64_t n_regions = static_cast<int64_t>(region_of_root.size());
  if (n_regions != 2) return n_regions;
  // external = region touching bounds
  int64_t external = region_touches_bounds[0] ? 0 : 1;
  for (int64_t i = 0; i < n_nodes; ++i) {
    if (!on_boundary[i]) {
      out_labels[i] = 0;
      continue;
    }
    int64_t rid = region_of_root[uf_find(parent, i)];
    out_labels[i] = (rid == external) ? 1 : -1;
  }
  return 2;
}

// Periodic boundary pairing: writes (senders, receivers) of the extra
// periodic links (both directions for sides, crossed corners), exactly the
// construction of periodic.periodic_boundary_pairs / datasets.py:39-108.
// Buffers must hold 2*(n_left + n_bottom) + 4 entries. Returns count, or
// -1 if side node counts mismatch / corners missing.
int64_t pdg_periodic_pairs(const double* pts2d, int64_t n_nodes,
                           int64_t* out_senders, int64_t* out_receivers) {
  double min_x = 1e300, max_x = -1e300, min_y = 1e300, max_y = -1e300;
  for (int64_t i = 0; i < n_nodes; ++i) {
    min_x = std::min(min_x, pts2d[2 * i]);
    max_x = std::max(max_x, pts2d[2 * i]);
    min_y = std::min(min_y, pts2d[2 * i + 1]);
    max_y = std::max(max_y, pts2d[2 * i + 1]);
  }
  std::vector<int64_t> left, right, lower, upper;
  int64_t ll = -1, lu = -1, rl = -1, ru = -1;
  for (int64_t i = 0; i < n_nodes; ++i) {
    const double x = pts2d[2 * i], y = pts2d[2 * i + 1];
    if (x == min_x) left.push_back(i);
    if (x == max_x) right.push_back(i);
    if (y == min_y) lower.push_back(i);
    if (y == max_y) upper.push_back(i);
    if (x == min_x && y == min_y) ll = i;
    if (x == min_x && y == max_y) lu = i;
    if (x == max_x && y == min_y) rl = i;
    if (x == max_x && y == max_y) ru = i;
  }
  if (left.size() != right.size() || lower.size() != upper.size()) return -1;
  if (ll < 0 || lu < 0 || rl < 0 || ru < 0) return -1;
  // lexsort: primary y, secondary x (datasets.py:49-63)
  auto by_y_then_x = [&](int64_t a, int64_t b) {
    if (pts2d[2 * a + 1] != pts2d[2 * b + 1])
      return pts2d[2 * a + 1] < pts2d[2 * b + 1];
    return pts2d[2 * a] < pts2d[2 * b];
  };
  std::sort(left.begin(), left.end(), by_y_then_x);
  std::sort(right.begin(), right.end(), by_y_then_x);
  std::sort(lower.begin(), lower.end(), by_y_then_x);
  std::sort(upper.begin(), upper.end(), by_y_then_x);
  int64_t k = 0;
  for (size_t i = 0; i < left.size(); ++i) {
    out_senders[k] = left[i];
    out_receivers[k++] = right[i];
  }
  for (size_t i = 0; i < right.size(); ++i) {
    out_senders[k] = right[i];
    out_receivers[k++] = left[i];
  }
  for (size_t i = 0; i < lower.size(); ++i) {
    out_senders[k] = lower[i];
    out_receivers[k++] = upper[i];
  }
  for (size_t i = 0; i < upper.size(); ++i) {
    out_senders[k] = upper[i];
    out_receivers[k++] = lower[i];
  }
  const int64_t corners[4] = {ll, lu, rl, ru};
  const int64_t flipped[4] = {ru, rl, lu, ll};
  for (int i = 0; i < 4; ++i) {
    out_senders[k] = corners[i];
    out_receivers[k++] = flipped[i];
  }
  return k;
}

}  // extern "C"
