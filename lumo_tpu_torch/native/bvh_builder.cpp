// Native host-side BVH builder (binned SAH, thread-parallel subtrees).
//
// The port's own copy of lumo_tpu/native/bvh_builder.cpp, the counterpart
// of the reference's host accel builders — the Rust SAH sweep
// (src/tracer/object/bvh/node.rs:74-143) and the thread-forking kd-tree
// construction (src/tracer/object/kdtree/node.rs:298-320).  The device
// never builds trees; this library produces the flattened DFS node arrays
// (left child = self+1, explicit right index, reference bvh/node.rs:8-14)
// that lumo_tpu_torch/csrc/bvh_traverse.cu walks.
//
// Exported C ABI (ctypes-friendly, no pybind11):
//   int lumo_build_bvh(const float* lo, const float* hi, int64 P,
//                      float* node_lo, float* node_hi, int* node_right,
//                      int* node_first, int* node_count, int* node_axis,
//                      int* order, int64* n_nodes_out, int* max_depth_out)
// Caller allocates node buffers for 2P-1 nodes (the worst case).
// Returns 0 on success.
//
// Matches lumo_tpu_torch/accel/build.py exactly in layout and heuristics:
// LEAF_SIZE=4 (bvh.rs:10), 16 bins, COST_INTERSECT=15 / COST_TRAVERSE=20
// (bvh/node.rs:4-6), median-split fallback below MEDIAN_DEPTH.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <thread>
#include <vector>

namespace {

constexpr int LEAF_SIZE = 4;
constexpr int N_BINS = 16;
constexpr double COST_INTERSECT = 15.0;
constexpr double COST_TRAVERSE = 20.0;
constexpr int MEDIAN_DEPTH = 32;
// Fork subtree builds onto threads while depth < FORK_DEPTH and the
// subtree is big enough to amortize a thread (reference kdtree/node.rs:3-5
// uses depth 8 / 16384 events; we fork shallower since binned SAH is
// cheaper per level).
constexpr int FORK_DEPTH = 4;
constexpr int64_t FORK_MIN_PRIMS = 16384;

struct V3 {
  double x, y, z;
};

inline V3 vmin(const V3& a, const V3& b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
inline V3 vmax(const V3& a, const V3& b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}
inline double area(const V3& lo, const V3& hi) {
  double ex = std::max(hi.x - lo.x, 0.0);
  double ey = std::max(hi.y - lo.y, 0.0);
  double ez = std::max(hi.z - lo.z, 0.0);
  return 2.0 * (ex * ey + ey * ez + ez * ex);
}
inline double axis_get(const V3& v, int a) {
  return a == 0 ? v.x : (a == 1 ? v.y : v.z);
}

struct Node {
  V3 lo, hi;
  int32_t right, first, count, axis;
};

struct Shared {
  const V3* plo;
  const V3* phi;
  const V3* cent;
  // Node slots and the prim permutation are claimed with atomics so
  // forked subtrees can emit independently; the final pass relabels the
  // emit order into DFS preorder.
  std::atomic<int64_t> n_nodes{0};
  std::atomic<int64_t> placed{0};
  std::atomic<int> max_depth{1};
  Node* nodes;          // scratch, emit order
  int32_t* node_parent; // -1 root; (parent<<1)|is_right packed
  int32_t* order;       // final prim permutation (claimed contiguously)
};

// Binned SAH split of idx[0..n). Returns split axis or -1; partitions idx
// in place with mid = boundary when a split is taken.
int sah_split(Shared& S, int32_t* idx, int64_t n, const V3& nlo,
              const V3& nhi, int64_t* mid_out) {
  double area_parent = area(nlo, nhi);
  if (area_parent <= 0.0) return -1;
  int best_axis = -1;
  int best_cut = -1;
  double best_cost = std::numeric_limits<double>::infinity();
  for (int ax = 0; ax < 3; ++ax) {
    double lo_a = axis_get(nlo, ax), hi_a = axis_get(nhi, ax);
    double ext = hi_a - lo_a;
    if (ext <= 1e-12) continue;
    int64_t counts[N_BINS] = {0};
    V3 blo[N_BINS], bhi[N_BINS];
    for (int b = 0; b < N_BINS; ++b) {
      blo[b] = {1e300, 1e300, 1e300};
      bhi[b] = {-1e300, -1e300, -1e300};
    }
    for (int64_t i = 0; i < n; ++i) {
      int32_t p = idx[i];
      double t = (axis_get(S.cent[p], ax) - lo_a) / ext;
      int b = (int)(t * N_BINS);
      b = std::min(std::max(b, 0), N_BINS - 1);
      counts[b]++;
      blo[b] = vmin(blo[b], S.plo[p]);
      bhi[b] = vmax(bhi[b], S.phi[p]);
    }
    // prefix/suffix sweep
    int64_t lcnt[N_BINS - 1], rcnt[N_BINS - 1];
    double la[N_BINS - 1], ra[N_BINS - 1];
    {
      V3 acc_lo = blo[0], acc_hi = bhi[0];
      int64_t c = counts[0];
      for (int b = 0; b < N_BINS - 1; ++b) {
        if (b > 0) {
          acc_lo = vmin(acc_lo, blo[b]);
          acc_hi = vmax(acc_hi, bhi[b]);
          c += counts[b];
        }
        lcnt[b] = c;
        la[b] = area(acc_lo, acc_hi);
      }
      acc_lo = blo[N_BINS - 1];
      acc_hi = bhi[N_BINS - 1];
      c = counts[N_BINS - 1];
      for (int b = N_BINS - 2; b >= 0; --b) {
        if (b < N_BINS - 2) {
          acc_lo = vmin(acc_lo, blo[b + 1]);
          acc_hi = vmax(acc_hi, bhi[b + 1]);
          c += counts[b + 1];
        }
        rcnt[b] = c;
        ra[b] = area(acc_lo, acc_hi);
      }
    }
    for (int b = 0; b < N_BINS - 1; ++b) {
      if (lcnt[b] == 0 || rcnt[b] == 0) continue;
      double cost = COST_TRAVERSE +
                    COST_INTERSECT * (la[b] * lcnt[b] + ra[b] * rcnt[b]) /
                        area_parent;
      if (cost < best_cost) {
        best_cost = cost;
        best_axis = ax;
        best_cut = b;
      }
    }
  }
  if (best_axis < 0) return -1;
  double lo_a = axis_get(nlo, best_axis);
  double ext = axis_get(nhi, best_axis) - lo_a;
  auto bin_of = [&](int32_t p) {
    double t = (axis_get(S.cent[p], best_axis) - lo_a) / ext;
    int b = (int)(t * N_BINS);
    return std::min(std::max(b, 0), N_BINS - 1);
  };
  int32_t* split = std::partition(
      idx, idx + n, [&](int32_t p) { return bin_of(p) <= best_cut; });
  int64_t mid = split - idx;
  if (mid == 0 || mid == n) return -1;
  *mid_out = mid;
  return best_axis;
}

// Build the subtree over idx[0..n) at `depth`, emitting into S.nodes in
// claim order; returns the emitted slot. `parent_link` = (parent<<1)|right.
int64_t build_node(Shared& S, int32_t* idx, int64_t n, int depth,
                   int32_t parent_link) {
  int64_t slot = S.n_nodes.fetch_add(1);
  int cur = S.max_depth.load(std::memory_order_relaxed);
  while (depth > cur &&
         !S.max_depth.compare_exchange_weak(cur, depth)) {
  }
  V3 nlo = S.plo[idx[0]], nhi = S.phi[idx[0]];
  for (int64_t i = 1; i < n; ++i) {
    nlo = vmin(nlo, S.plo[idx[i]]);
    nhi = vmax(nhi, S.phi[idx[i]]);
  }
  S.node_parent[slot] = parent_link;

  int axis = -1;
  int64_t mid = 0;
  if (n > LEAF_SIZE) {
    if (depth < MEDIAN_DEPTH) axis = sah_split(S, idx, n, nlo, nhi, &mid);
    if (axis < 0) {
      // median split on the widest axis — bounded depth guarantee
      double ex = nhi.x - nlo.x, ey = nhi.y - nlo.y, ez = nhi.z - nlo.z;
      axis = ex >= ey ? (ex >= ez ? 0 : 2) : (ey >= ez ? 1 : 2);
      mid = n / 2;
      std::nth_element(idx, idx + mid, idx + n, [&](int32_t a, int32_t b) {
        return axis_get(S.cent[a], axis) < axis_get(S.cent[b], axis);
      });
    }
  }
  if (axis < 0) {
    int64_t first = S.placed.fetch_add(n);
    for (int64_t i = 0; i < n; ++i) S.order[first + i] = idx[i];
    S.nodes[slot] = {nlo, nhi, 0, (int32_t)first, (int32_t)n, 0};
    return slot;
  }

  int64_t left_slot, right_slot;
  if (depth < FORK_DEPTH && std::min(mid, n - mid) >= FORK_MIN_PRIMS) {
    std::thread tl([&] {
      left_slot =
          build_node(S, idx, mid, depth + 1, (int32_t)((slot << 1) | 0));
    });
    right_slot = build_node(S, idx + mid, n - mid, depth + 1,
                            (int32_t)((slot << 1) | 1));
    tl.join();
  } else {
    left_slot = build_node(S, idx, mid, depth + 1, (int32_t)((slot << 1) | 0));
    right_slot = build_node(S, idx + mid, n - mid, depth + 1,
                            (int32_t)((slot << 1) | 1));
  }
  (void)left_slot;
  S.nodes[slot] = {nlo, nhi, (int32_t)right_slot, 0, 0, (int32_t)axis};
  return slot;
}

}  // namespace

extern "C" {

int lumo_build_bvh(const float* lo, const float* hi, int64_t P,
                   float* out_lo, float* out_hi, int32_t* out_right,
                   int32_t* out_first, int32_t* out_count, int32_t* out_axis,
                   int32_t* out_order, int64_t* n_nodes_out,
                   int32_t* max_depth_out) {
  if (P <= 0) return 1;
  std::vector<V3> plo(P), phi(P), cent(P);
  for (int64_t i = 0; i < P; ++i) {
    plo[i] = {lo[3 * i], lo[3 * i + 1], lo[3 * i + 2]};
    phi[i] = {hi[3 * i], hi[3 * i + 1], hi[3 * i + 2]};
    cent[i] = {0.5 * (plo[i].x + phi[i].x), 0.5 * (plo[i].y + phi[i].y),
               0.5 * (plo[i].z + phi[i].z)};
  }
  int64_t max_nodes = 2 * P - 1;
  if (max_nodes < 1) max_nodes = 1;
  std::vector<Node> nodes(max_nodes);
  std::vector<int32_t> parent(max_nodes);
  std::vector<int32_t> idx(P);
  for (int64_t i = 0; i < P; ++i) idx[i] = (int32_t)i;

  Shared S;
  S.plo = plo.data();
  S.phi = phi.data();
  S.cent = cent.data();
  S.nodes = nodes.data();
  S.node_parent = parent.data();
  S.order = out_order;
  build_node(S, idx.data(), P, 1, -1);
  int64_t M = S.n_nodes.load();

  // Relabel claim order -> DFS preorder (left child = parent slot + 1).
  // Children in claim order: scan parent links.
  std::vector<int32_t> child_l(M, -1), child_r(M, -1);
  int64_t root = -1;
  for (int64_t i = 0; i < M; ++i) {
    int32_t pl = parent[i];
    if (pl < 0) {
      root = i;
    } else if (pl & 1) {
      child_r[pl >> 1] = (int32_t)i;
    } else {
      child_l[pl >> 1] = (int32_t)i;
    }
  }
  std::vector<int64_t> dfs_of(M);
  std::vector<int64_t> stack;
  stack.push_back(root);
  int64_t next = 0;
  std::vector<int64_t> emit_at_dfs(M);
  while (!stack.empty()) {
    int64_t s = stack.back();
    stack.pop_back();
    dfs_of[s] = next;
    emit_at_dfs[next] = s;
    ++next;
    if (nodes[s].count == 0 && child_l[s] >= 0) {
      stack.push_back(child_r[s]);  // right popped after left subtree
      stack.push_back(child_l[s]);
    }
  }
  for (int64_t d = 0; d < M; ++d) {
    const Node& nd = nodes[emit_at_dfs[d]];
    out_lo[3 * d] = (float)nd.lo.x;
    out_lo[3 * d + 1] = (float)nd.lo.y;
    out_lo[3 * d + 2] = (float)nd.lo.z;
    out_hi[3 * d] = (float)nd.hi.x;
    out_hi[3 * d + 1] = (float)nd.hi.y;
    out_hi[3 * d + 2] = (float)nd.hi.z;
    out_right[d] = nd.count == 0 ? (int32_t)dfs_of[nd.right] : 0;
    out_first[d] = nd.first;
    out_count[d] = nd.count;
    out_axis[d] = nd.axis;
  }
  *n_nodes_out = M;
  *max_depth_out = S.max_depth.load();
  return 0;
}

}  // extern "C"
