// kd-tree closest-hit and any-hit traversal for Hopper (sm_90a), one thread
// per ray.
//
// Replaces lumo_tpu/accel/pallas_kd.py::_kd_kernel, the TPU packet walk over
// a collapsed block kd-tree.  It computes the same function: per ray, the
// nearest triangle hit in (0, t_max) as (t, prim), prim = -1 and t = INF on
// a miss; or an occlusion flag with early exit.  The walk is the per-ray
// reference walk the TPU kernel vectorises (lumo_tpu/accel/traverse.py::
// _kd_walk, reference kdtree.rs:101-169) over the flat tree of
// lumo_tpu_torch/accel/kdtree.py:
//   - root entry: slab against the root bounds, far side inflated by
//     1.00000024, clipped to [0, t_max]; a ray with t_max <= 0 (a dead
//     lane) or an empty interval misses at once;
//   - inner node: tplane = (split - o_axis) * inv_d_axis with inv_d
//     clamped to +-1e30, so tplane is never NaN; near child by `below`;
//     only near when tplane > t1 or tplane <= 0, only far when tplane < t0,
//     else near over [t0, tplane] then far over [tplane, t1]; a ray lying
//     in the split plane (d_axis == 0 and o_axis == split) visits both
//     children;
//   - closest hit: a popped cell whose t0 lies beyond the best hit is
//     skipped; a hit beyond the cell's t1 is still a candidate, since a
//     triangle that straddles a plane sits in several leaves; equal t keeps
//     the smaller prim id;
//   - any hit: the ray stops at its first hit in (0, t_max).
// The leaf test is woop.cuh's, shared with bvh_traverse.cu, so t is
// bit-equal to the plain version's and to the BVH kernel's.
//
// A stack entry is two words, (far child, t1): t0 is rebuilt on the pop.
// Without in-plane rays the walk is front to back along the ray, and the
// cell on top of the stack starts where the current cell ends: a push of
// both children stacks [tplane, t1] and continues over [t0, tplane]; a
// one-child step keeps the interval; a finished or skipped cell ends at
// its own t1.  So the popped t0 is the t1 of the cell before it, the same
// float a three-word entry would store.  A ray lying in a split plane
// stacks its far child over the same [t0, t1] as the near one, which breaks
// that chain; the entry is flagged and pops with t0 = 0, a superset of the
// cell's interval: the walk then visits more cells and tests more
// triangles but never fewer, and every triangle it tests is a true
// candidate, so the answer is the same closest hit.
//
// None of the TPU layout carries over (pack_kd_blocks' 16384-node block
// tree, leaf blocks, synthetic AXIS_BOTH chains, packet-majority child
// order, the Morton ray sort).  Layout (lumo_tpu_torch/accel/kd_kernel.py::
// pack_kd, which raises beyond the limits):
//   nodes  int2 per node, 8 bytes:
//          x = bits(split) for an inner node, the leaf's first
//              reference for a leaf (< 2^31);
//          y = (right << 2 | axis) for an inner node, (count << 2 | 3)
//              for a leaf (right, count < 2^30).
//          The left child is node + 1.
//   refs   int32 prim id per leaf reference, a leaf's contiguous;
//   tris   float4 triples (a, b, c) per triangle, in prim order (48 bytes
//          each, stored once however many leaves hold it);
//   root   6 floats: lo.xyz, hi.xyz.
// For the 327,692-triangle scene that is 18.7 MB of nodes, 6.7 MB of
// references and 15.7 MB of triangles: 41 MB, inside the 50 MB L2, where a
// 48-byte copy per reference took 99 MB.  A leaf loads its next reference
// while it tests the current triangle.
//
// What bounds it on an H100: the latency of dependent loads, not bandwidth
// or arithmetic, and divergence: a kd walk is deep (26 node visits and 10
// triangle tests per first-bounce ray on that scene) and lanes differ in
// length.  Measured against persistent warps with dynamic ray fetch and a
// while-while loop (as bvh_traverse.cu runs), the plain grid was faster for
// this walk, whose node steps are too cheap to pay for the warp votes
// (PERF.md); the gain here is the smaller layout and stack.

#include <climits>

#include "woop.cuh"

namespace {

using namespace lumo;

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kThreads = 128;
constexpr int kStack = 64;
constexpr int kDone = -1;          // the walk is over
constexpr int kInPlane = INT_MIN;  // flag of a stack entry: pops with t0 = 0

template <bool kAny, bool kCount>
__global__ void __launch_bounds__(kThreads)
    kd_traverse(const int2* __restrict__ nodes, const int* __restrict__ refs,
                const float4* __restrict__ tris,
                const float* __restrict__ root, const float* __restrict__ o,
                const float* __restrict__ d, const float* __restrict__ tmax,
                int n, float* __restrict__ t_out,
                long long* __restrict__ prim_out, bool* __restrict__ occ_out,
                unsigned long long* __restrict__ counts,
                unsigned char* __restrict__ seen_nodes,
                unsigned char* __restrict__ seen_refs,
                unsigned char* __restrict__ seen_tris) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const float t_max = i < n ? tmax[i] : 0.f;
  float best_t = INFINITY;
  int best_p = -1;
  bool occluded = false;
  unsigned long long n_nodes = 0, n_tris = 0;
  if (t_max > 0.f) {  // dead lanes (t_max <= 0, or NaN) miss at once
    const Ray r = make_ray(o, d, i);
    const float t0x = (__ldg(&root[0]) - r.ox) * r.ix;
    const float t1x = (__ldg(&root[3]) - r.ox) * r.ix;
    const float t0y = (__ldg(&root[1]) - r.oy) * r.iy;
    const float t1y = (__ldg(&root[4]) - r.oy) * r.iy;
    const float t0z = (__ldg(&root[2]) - r.oz) * r.iz;
    const float t1z = (__ldg(&root[5]) - r.oz) * r.iz;
    const float lo_t =
        fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
    const float hi_t =
        fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z)) *
        kInflate;
    float t0 = fmaxf(lo_t, 0.f), t1 = fminf(hi_t, t_max);
    int2 stack[kStack];
    int sp = 0;
    int cur = t0 <= t1 ? 0 : kDone;
    while (cur != kDone) {
      const int2 nd = __ldg(&nodes[cur]);
      if (kCount) {
        ++n_nodes;
        if (seen_nodes != nullptr) seen_nodes[cur] = 1;
      }
      const int axis = nd.y & 3;
      const int arg = static_cast<int>(static_cast<unsigned>(nd.y) >> 2);
      if (axis != 3) {
        const float split = __int_as_float(nd.x);
        const float o_a = axis == 0 ? r.ox : (axis == 1 ? r.oy : r.oz);
        const float d_a = axis == 0 ? r.dx : (axis == 1 ? r.dy : r.dz);
        const float i_a = axis == 0 ? r.ix : (axis == 1 ? r.iy : r.iz);
        const float tplane = (split - o_a) * i_a;
        const bool below = o_a < split || (o_a == split && d_a <= 0.f);
        const int c_near = below ? cur + 1 : arg;
        const int c_far = below ? arg : cur + 1;
        const bool in_plane = d_a == 0.f && o_a == split;
        const bool only_near = tplane > t1 || tplane <= 0.f;
        const bool only_far = !only_near && tplane < t0;
        if (in_plane || (!only_near && !only_far)) {
          stack[sp++] = make_int2(in_plane ? (c_far | kInPlane) : c_far,
                                  __float_as_int(t1));
          cur = c_near;
          if (!in_plane) t1 = tplane;
        } else {
          cur = only_far ? c_far : c_near;
        }
        continue;
      }
      // leaf: arg references from nd.x, the next index loaded ahead
      int p = arg > 0 ? __ldg(&refs[nd.x]) : 0;
      for (int k = nd.x; k < nd.x + arg; ++k) {
        const int q = p;
        if (k + 1 < nd.x + arg) p = __ldg(&refs[k + 1]);
        const float t = woop_t(r, __ldg(&tris[3 * q]), __ldg(&tris[3 * q + 1]),
                               __ldg(&tris[3 * q + 2]), t_max);
        if (kCount) {
          ++n_tris;
          if (seen_refs != nullptr) {
            seen_refs[k] = 1;
            seen_tris[q] = 1;
          }
        }
        if (kAny) {
          if (t < INFINITY) {
            occluded = true;
            break;
          }
        } else if (t < best_t ||
                   (t == best_t && t < INFINITY && q < best_p)) {
          best_t = t;
          best_p = q;
        }
      }
      if (kAny && occluded) break;
      // the next cell from the stack, t0 rebuilt; cells that start beyond
      // the best hit are skipped
      cur = kDone;
      while (sp > 0) {
        const int2 e = stack[--sp];
        t0 = (e.x & kInPlane) ? 0.f : t1;
        t1 = __int_as_float(e.y);
        if (!kAny && !(t0 <= best_t)) continue;
        cur = e.x & ~kInPlane;
        break;
      }
    }
  }
  if (kCount) {
    // warp trips: the longest lane's steps (lanes past n count none)
    const unsigned long long w_inner = __reduce_max_sync(
        kFullMask, static_cast<unsigned>(n_nodes));
    const unsigned long long w_leaf = __reduce_max_sync(
        kFullMask, static_cast<unsigned>(n_tris));
    atomicAdd(&counts[0], n_nodes);
    atomicAdd(&counts[1], n_tris);
    if ((threadIdx.x & 31) == 0) {
      atomicAdd(&counts[2], w_inner);
      atomicAdd(&counts[3], w_leaf);
    }
  }
  if (i >= n) return;
  if (kAny) {
    occ_out[i] = occluded;
  } else {
    t_out[i] = best_t;
    prim_out[i] = best_p;
  }
}

// the kernel of a mode: 0 closest, 1 any, 2 and 3 their counting launches
using KernelFn = void (*)(const int2*, const int*, const float4*,
                          const float*, const float*, const float*,
                          const float*, int, float*, long long*, bool*,
                          unsigned long long*, unsigned char*, unsigned char*,
                          unsigned char*);

KernelFn kernel_of(int mode) {
  switch (mode) {
    case 0: return kd_traverse<false, false>;
    case 1: return kd_traverse<true, false>;
    case 2: return kd_traverse<false, true>;
    default: return kd_traverse<true, true>;
  }
}

// one thread per ray: the grid of a launch over n rays (n < 2^31)
int grid_of(int n) { return n > 0 ? (n - 1) / kThreads + 1 : 0; }

int launch(int mode, const void* nodes, const void* refs, const void* tris,
           const void* root, const void* o, const void* d, const void* tmax,
           int n, void* t_out, void* prim_out, void* occ_out, void* counts,
           void* seen_nodes, void* seen_refs, void* seen_tris, void* stream) {
  if (n <= 0) return 0;
  const KernelFn k = kernel_of(mode);
  k<<<grid_of(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int2*>(nodes), static_cast<const int*>(refs),
      static_cast<const float4*>(tris), static_cast<const float*>(root),
      static_cast<const float*>(o), static_cast<const float*>(d),
      static_cast<const float*>(tmax), n, static_cast<float*>(t_out),
      static_cast<long long*>(prim_out), static_cast<bool*>(occ_out),
      static_cast<unsigned long long*>(counts),
      static_cast<unsigned char*>(seen_nodes),
      static_cast<unsigned char*>(seen_refs),
      static_cast<unsigned char*>(seen_tris));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Closest hit: t_out (n,) float32, prim_out (n,) int64.  counts, when not
// null, is a zeroed (4,) 64-bit integer that receives the node visits and
// the triangle tests, and their sums over warps of the warp's largest lane
// count (the warp's trips: SIMT efficiency is counts[0] / (32 counts[2]));
// seen_nodes (M,), seen_refs (R,) and seen_tris (T,), zeroed bytes that
// may be null together, then receive a 1 for each node, leaf reference and
// triangle the launch read.  Returns the cudaError_t of the launch.
int lumo_kd_closest(const void* nodes, const void* refs, const void* tris,
                    const void* root, const void* o, const void* d,
                    const void* tmax, int n, void* t_out, void* prim_out,
                    void* counts, void* seen_nodes, void* seen_refs,
                    void* seen_tris, void* stream) {
  return launch(counts != nullptr ? 2 : 0, nodes, refs, tris, root, o, d,
                tmax, n, t_out, prim_out, nullptr, counts, seen_nodes,
                seen_refs, seen_tris, stream);
}

// Any hit: occ_out (n,) bool.
int lumo_kd_any(const void* nodes, const void* refs, const void* tris,
                const void* root, const void* o, const void* d,
                const void* tmax, int n, void* occ_out, void* counts,
                void* seen_nodes, void* seen_refs, void* seen_tris,
                void* stream) {
  return launch(counts != nullptr ? 3 : 1, nodes, refs, tris, root, o, d,
                tmax, n, nullptr, nullptr, occ_out, counts, seen_nodes,
                seen_refs, seen_tris, stream);
}

// Resident blocks per SM of a mode's kernel (0 closest, 1 any, 2 and 3
// their counting launches) on the current device, and the grid of its
// launch over n rays (one thread per ray), into out[0] and out[1].
int lumo_kd_grid(int mode, int n, int* out) {
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], kernel_of(mode),
                                                kThreads, 0);
  out[1] = grid_of(n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
