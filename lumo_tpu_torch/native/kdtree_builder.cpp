// Native host-side kd-tree builder (Wald-Havran SAH event sweep,
// thread-parallel subtrees).
//
// The port's own copy of lumo_tpu/native/kdtree_builder.cpp, the
// counterpart of the reference's O(n log n) kd-tree construction
// (src/tracer/object/kdtree/node.rs): per-axis
// start/end/planar events sorted and swept incrementally
// (node.rs:124-195), leaf-vs-split cost termination (node.rs:245-256),
// subtree builds forked onto threads up to depth 8 / >=16384 events
// (node.rs:3-5, :298-320).  The device never builds trees; this library
// emits flattened DFS node arrays (left child = self+1, explicit right
// index) that lumo_tpu_torch/accel/kd_kernel.py packs for
// lumo_tpu_torch/csrc/kd_traverse.cu.  Unlike the BVH, kd leaves reference
// prims through an indirection list (a prim can land in several leaves),
// and leaves have no size cap.
//
// Exported C ABI (ctypes, no pybind11):
//   int lumo_build_kdtree(const float* lo, const float* hi, int64 P,
//                         int64 node_cap, int64 ref_cap,
//                         float* out_split, int* out_axis, int* out_right,
//                         int* out_first, int* out_count, int* out_prims,
//                         float* root_lo, float* root_hi,
//                         int64* n_nodes_out, int64* n_refs_out,
//                         int* max_depth_out)
// Returns 0 on success, 2 if node_cap/ref_cap exceeded (caller retries
// with bigger buffers).
//
// Cost constants mirror the reference (kdtree/node.rs:7-9):
// COST_TRAVERSE=15, COST_INTERSECT=20, EMPTY_BONUS=0.2.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <limits>
#include <thread>
#include <vector>

namespace {

constexpr double KD_COST_TRAVERSE = 15.0;
constexpr double KD_COST_INTERSECT = 20.0;
constexpr double KD_EMPTY_BONUS = 0.2;
constexpr int KD_MAX_DEPTH = 48;  // device stack is 64 deep
constexpr int KD_FORK_DEPTH = 8;          // reference kdtree/node.rs:3-5
constexpr int64_t KD_FORK_MIN = 16384;

struct KV3 {
  double v[3];
};

inline double karea(const KV3& lo, const KV3& hi) {
  double ex = std::max(hi.v[0] - lo.v[0], 0.0);
  double ey = std::max(hi.v[1] - lo.v[1], 0.0);
  double ez = std::max(hi.v[2] - lo.v[2], 0.0);
  return 2.0 * (ex * ey + ey * ez + ez * ex);
}

struct KNode {
  double split;
  int32_t axis;  // 0/1/2 interior, 3 leaf
  int32_t right;
  int32_t first, count;
};

struct KShared {
  const KV3* plo;
  const KV3* phi;
  std::atomic<int64_t> n_nodes{0};
  std::atomic<int64_t> n_refs{0};
  std::atomic<int> max_depth{1};
  std::atomic<bool> overflow{false};
  int64_t node_cap, ref_cap;
  KNode* nodes;
  int32_t* parent;  // (parent<<1)|is_right, -1 root
  int32_t* prims;   // leaf indirection list (claim order)
};

// Event types ordered so ties sort END < PLANAR < START
// (reference kdtree/event.rs:1-47).
enum { EV_END = 0, EV_PLANAR = 1, EV_START = 2 };

struct KEvent {
  double pos;
  int32_t prim;
  int32_t type;
};

// SAH split cost with empty-side bonus (reference kdtree/node.rs:245-256).
inline double split_cost(const KV3& nlo, const KV3& nhi, int ax, double pos,
                         int64_t nl, int64_t nr, double inv_sa) {
  KV3 llo = nlo, lhi = nhi, rlo = nlo, rhi = nhi;
  lhi.v[ax] = pos;
  rlo.v[ax] = pos;
  double c = (karea(llo, lhi) * nl + karea(rlo, rhi) * nr) * inv_sa;
  if (nl == 0 || nr == 0) c *= (1.0 - KD_EMPTY_BONUS);
  return KD_COST_TRAVERSE + KD_COST_INTERSECT * c;
}

int64_t kd_build(KShared& S, std::vector<int32_t>& ids, const KV3& nlo,
                 const KV3& nhi, int depth, int32_t parent_link) {
  int64_t slot = S.n_nodes.fetch_add(1);
  if (slot >= S.node_cap) {
    S.overflow.store(true);
    return 0;
  }
  int cur = S.max_depth.load(std::memory_order_relaxed);
  while (depth > cur && !S.max_depth.compare_exchange_weak(cur, depth)) {
  }
  S.parent[slot] = parent_link;
  int64_t n = (int64_t)ids.size();

  int best_axis = -1;
  double best_pos = 0.0, best_cost = std::numeric_limits<double>::infinity();
  bool best_planar_left = false;
  double sa = karea(nlo, nhi);
  if (n > 1 && depth < KD_MAX_DEPTH && sa > 0.0) {
    double inv_sa = 1.0 / sa;
    std::vector<KEvent> ev;
    ev.reserve(2 * n);
    for (int ax = 0; ax < 3; ++ax) {
      if (nhi.v[ax] - nlo.v[ax] <= 1e-12) continue;
      ev.clear();
      for (int32_t p : ids) {
        double s0 = S.plo[p].v[ax], e0 = S.phi[p].v[ax];
        if (s0 == e0) {
          ev.push_back({s0, p, EV_PLANAR});
        } else {
          ev.push_back({s0, p, EV_START});
          ev.push_back({e0, p, EV_END});
        }
      }
      std::sort(ev.begin(), ev.end(), [](const KEvent& a, const KEvent& b) {
        return a.pos < b.pos || (a.pos == b.pos && a.type < b.type);
      });
      // incremental sweep (reference kdtree/node.rs:124-195)
      int64_t nl = 0, nr = n;
      size_t i = 0;
      while (i < ev.size()) {
        double pos = ev[i].pos;
        int64_t pe = 0, pp = 0, ps = 0;
        while (i < ev.size() && ev[i].pos == pos && ev[i].type == EV_END) {
          ++pe, ++i;
        }
        while (i < ev.size() && ev[i].pos == pos && ev[i].type == EV_PLANAR) {
          ++pp, ++i;
        }
        while (i < ev.size() && ev[i].pos == pos && ev[i].type == EV_START) {
          ++ps, ++i;
        }
        nr -= pp + pe;
        if (pos > nlo.v[ax] && pos < nhi.v[ax]) {
          double cl = split_cost(nlo, nhi, ax, pos, nl + pp, nr, inv_sa);
          double cr = split_cost(nlo, nhi, ax, pos, nl, nr + pp, inv_sa);
          double c = std::min(cl, cr);
          if (c < best_cost) {
            best_cost = c;
            best_axis = ax;
            best_pos = pos;
            best_planar_left = cl <= cr;
          }
        }
        nl += ps + pp;
      }
    }
  }

  double leaf_cost = KD_COST_INTERSECT * (double)n;
  if (best_axis < 0 || best_cost >= leaf_cost) {
    int64_t first = S.n_refs.fetch_add(n);
    if (first + n > S.ref_cap) {
      S.overflow.store(true);
      return slot;
    }
    for (int64_t i = 0; i < n; ++i) S.prims[first + i] = ids[i];
    S.nodes[slot] = {0.0, 3, 0, (int32_t)first, (int32_t)n};
    return slot;
  }

  // classify (reference kdtree/node.rs:197-230): lo < pos -> left,
  // hi > pos -> right, planar-on-plane -> winning side
  std::vector<int32_t> lids, rids;
  lids.reserve(n);
  rids.reserve(n);
  for (int32_t p : ids) {
    double s0 = S.plo[p].v[best_axis], e0 = S.phi[p].v[best_axis];
    if (s0 == best_pos && e0 == best_pos) {
      (best_planar_left ? lids : rids).push_back(p);
    } else {
      if (s0 < best_pos) lids.push_back(p);
      if (e0 > best_pos) rids.push_back(p);
    }
  }
  ids.clear();
  ids.shrink_to_fit();

  KV3 lhi = nhi, rlo = nlo;
  lhi.v[best_axis] = best_pos;
  rlo.v[best_axis] = best_pos;

  int64_t right_slot;
  if (depth < KD_FORK_DEPTH &&
      (int64_t)std::min(lids.size(), rids.size()) >= KD_FORK_MIN) {
    std::thread tl([&] {
      kd_build(S, lids, nlo, lhi, depth + 1, (int32_t)((slot << 1) | 0));
    });
    right_slot =
        kd_build(S, rids, rlo, nhi, depth + 1, (int32_t)((slot << 1) | 1));
    tl.join();
  } else {
    kd_build(S, lids, nlo, lhi, depth + 1, (int32_t)((slot << 1) | 0));
    right_slot =
        kd_build(S, rids, rlo, nhi, depth + 1, (int32_t)((slot << 1) | 1));
  }
  S.nodes[slot] = {best_pos, (int32_t)best_axis, (int32_t)right_slot, 0, 0};
  return slot;
}

}  // namespace

extern "C" {

int lumo_build_kdtree(const float* lo, const float* hi, int64_t P,
                      int64_t node_cap, int64_t ref_cap, float* out_split,
                      int32_t* out_axis, int32_t* out_right,
                      int32_t* out_first, int32_t* out_count,
                      int32_t* out_prims, float* root_lo, float* root_hi,
                      int64_t* n_nodes_out, int64_t* n_refs_out,
                      int32_t* max_depth_out) {
  if (P <= 0) return 1;
  std::vector<KV3> plo(P), phi(P);
  KV3 rlo = {{1e300, 1e300, 1e300}}, rhi = {{-1e300, -1e300, -1e300}};
  for (int64_t i = 0; i < P; ++i) {
    for (int a = 0; a < 3; ++a) {
      plo[i].v[a] = lo[3 * i + a];
      phi[i].v[a] = hi[3 * i + a];
      rlo.v[a] = std::min(rlo.v[a], plo[i].v[a]);
      rhi.v[a] = std::max(rhi.v[a], phi[i].v[a]);
    }
  }

  std::vector<KNode> nodes(node_cap);
  std::vector<int32_t> parent(node_cap);
  KShared S;
  S.plo = plo.data();
  S.phi = phi.data();
  S.node_cap = node_cap;
  S.ref_cap = ref_cap;
  S.nodes = nodes.data();
  S.parent = parent.data();
  S.prims = out_prims;

  std::vector<int32_t> ids(P);
  for (int64_t i = 0; i < P; ++i) ids[i] = (int32_t)i;
  kd_build(S, ids, rlo, rhi, 1, -1);
  if (S.overflow.load()) return 2;
  int64_t M = S.n_nodes.load();

  // relabel claim order -> DFS preorder (left child = parent + 1)
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
  std::vector<int64_t> dfs_of(M), stack;
  std::vector<int64_t> emit_at_dfs(M);
  stack.push_back(root);
  int64_t next = 0;
  while (!stack.empty()) {
    int64_t s = stack.back();
    stack.pop_back();
    dfs_of[s] = next;
    emit_at_dfs[next] = s;
    ++next;
    if (nodes[s].axis != 3 && child_l[s] >= 0) {
      stack.push_back(child_r[s]);
      stack.push_back(child_l[s]);
    }
  }
  for (int64_t d = 0; d < M; ++d) {
    const KNode& nd = nodes[emit_at_dfs[d]];
    out_split[d] = (float)nd.split;
    out_axis[d] = nd.axis;
    out_right[d] = nd.axis == 3 ? 0 : (int32_t)dfs_of[nd.right];
    out_first[d] = nd.first;
    out_count[d] = nd.count;
  }
  for (int a = 0; a < 3; ++a) {
    root_lo[a] = (float)rlo.v[a];
    root_hi[a] = (float)rhi.v[a];
  }
  *n_nodes_out = M;
  *n_refs_out = S.n_refs.load();
  *max_depth_out = S.max_depth.load();
  return 0;
}

}  // extern "C"
