// kd-tree closest-hit and any-hit traversal for Hopper (sm_90a), one thread
// per ray.
//
// Replaces lumo_tpu/accel/pallas_kd.py::_kd_kernel, the TPU packet walk over
// a collapsed block kd-tree.  It computes the same function: per ray, the
// nearest triangle hit in (0, t_max) as (t, prim), prim = -1 and t = INF on
// a miss; or an occlusion flag with early exit.  The walk is the per-ray
// reference walk the TPU kernel vectorises (lumo_tpu/accel/traverse.py::
// _kd_walk, reference kdtree.rs:101-169) over the flat Wald-Havran tree of
// lumo_tpu_torch/accel/kdtree.py:
//   - root entry: slab against the root bounds, far side inflated by
//     1.00000024, clipped to [0, t_max]; a ray with t_max <= 0 (a dead
//     lane) or an empty interval misses at once;
//   - interior node: tplane = (split - o_axis) * inv_d_axis with inv_d
//     clamped to +-1e30, so tplane is never NaN; near child by `below`;
//     only near when tplane > t1 or tplane <= 0, only far when tplane < t0,
//     else near over [t0, tplane] then far over [tplane, t1]; a ray lying
//     in the split plane (d_axis == 0 and o_axis == split) visits both
//     children over the whole interval;
//   - closest hit: a popped cell whose t0 lies beyond the best hit is
//     skipped; a hit beyond the cell's t1 is still a candidate, since a
//     triangle that straddles a plane sits in several leaves; equal t keeps
//     the smaller prim id;
//   - any hit: the ray stops at its first hit in (0, t_max).
// The leaf test is woop.cuh's, shared with bvh_traverse.cu, so t is
// bit-equal to the plain version's and to the BVH kernel's.
//
// None of the TPU layout carries over (pack_kd_blocks' 16384-node block
// tree, leaf blocks, synthetic AXIS_BOTH chains, packet-majority child
// order, the Morton ray sort).  Layout chosen here
// (lumo_tpu_torch/accel/kd_kernel.py::pack_kd, which raises beyond the
// limits):
//   nodes  int2 per node, 8 bytes:
//          x = bits(split) for an interior node, the leaf's first
//              reference for a leaf (< 2^31);
//          y = (right << 2 | axis) for an interior node, (count << 2 | 3)
//              for a leaf (right, count < 2^30).
//          The left child is node + 1.
//   tris   float4 triples (a, b, c) per leaf REFERENCE, in reference
//          order, a.w = bits(prim id): a leaf reads count consecutive
//          triples and needs no prims indirection.  A triangle in k leaves
//          is stored k times (48 bytes each).
//   root   6 floats: lo.xyz, hi.xyz.
// A 64-entry per-thread stack of (node, t0, t1) holds far children; one
// level adds at most one entry, the builder caps depth at 48, and the
// wrapper rejects deeper trees.  The stack is 768 bytes per thread and
// lives in local memory (L1-cached); see the ptxas report of the build.
//
// What bounds it on an H100: as for the BVH kernel, the latency of
// dependent loads, not bandwidth or arithmetic.  A kd step is an 8-byte
// node fetch and a plane test, a quarter of a BVH node's bytes and a few
// operations, but the tree is deeper, leaves hold more triangles, and each
// stack entry is three words.  The design answers with small nodes (four
// per 32-byte sector), reads through the read-only path (__ldg), and
// occupancy to hide the latency.

#include "woop.cuh"

namespace {

using namespace lumo;

constexpr int kStack = 64;
constexpr int kThreads = 128;

template <bool kAny, bool kCount>
__global__ void __launch_bounds__(kThreads)
    kd_traverse(const int2* __restrict__ nodes,
                const float4* __restrict__ tris,
                const float* __restrict__ root, const float* __restrict__ o,
                const float* __restrict__ d, const float* __restrict__ tmax,
                int n, float* __restrict__ t_out,
                long long* __restrict__ prim_out, bool* __restrict__ occ_out,
                unsigned long long* __restrict__ counts,
                unsigned char* __restrict__ seen_nodes,
                unsigned char* __restrict__ seen_refs) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float t_max = tmax[i];
  float best_t = INFINITY;
  long long best_p = -1;
  bool occluded = false;
  unsigned long long n_nodes = 0, n_tris = 0;
  if (t_max > 0.f) {  // dead lanes (t_max <= 0, or NaN) miss at once
    const Ray r = make_ray(o, d, i);
    // root entry interval
    float e0, e1;
    {
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
      e0 = fmaxf(lo_t, 0.f);
      e1 = fminf(hi_t, t_max);
    }
    int stack_n[kStack];
    float stack_t0[kStack];
    float stack_t1[kStack];
    int sp = 0;
    int node = 0;
    float t0 = e0, t1 = e1;
    bool have = e0 <= e1;
    while (true) {
      if (!have) {
        if (sp == 0) break;
        --sp;
        node = stack_n[sp];
        t0 = stack_t0[sp];
        t1 = stack_t1[sp];
        // a cell that starts beyond the best hit holds nothing closer
        if (!kAny && !(t0 <= best_t)) continue;
      }
      have = false;
      const int2 nd = __ldg(&nodes[node]);
      if (kCount) {
        ++n_nodes;
        if (seen_nodes != nullptr) seen_nodes[node] = 1;
      }
      const int axis = nd.y & 3;
      const int arg = static_cast<int>(static_cast<unsigned>(nd.y) >> 2);
      if (axis != 3) {  // interior
        const float split = __int_as_float(nd.x);
        const float o_a = axis == 0 ? r.ox : (axis == 1 ? r.oy : r.oz);
        const float d_a = axis == 0 ? r.dx : (axis == 1 ? r.dy : r.dz);
        const float i_a = axis == 0 ? r.ix : (axis == 1 ? r.iy : r.iz);
        const float tplane = (split - o_a) * i_a;
        const bool below = o_a < split || (o_a == split && d_a <= 0.f);
        const int c_near = below ? node + 1 : arg;
        const int c_far = below ? arg : node + 1;
        const bool in_plane = d_a == 0.f && o_a == split;
        const bool only_near = tplane > t1 || tplane <= 0.f;
        const bool only_far = !only_near && tplane < t0;
        if (in_plane || (!only_near && !only_far)) {
          // both: far goes on the stack, near is walked next
          stack_n[sp] = c_far;
          stack_t0[sp] = in_plane ? t0 : tplane;
          stack_t1[sp] = t1;
          ++sp;
          node = c_near;
          t1 = in_plane ? t1 : tplane;
        } else {
          node = only_far ? c_far : c_near;
        }
        have = true;
        continue;
      }
      // leaf: arg references starting at nd.x
      const int first = nd.x;
      for (int k = 0; k < arg; ++k) {
        const int ref = first + k;
        const float4 va = __ldg(&tris[3 * ref]);
        const float t = woop_t(r, va, __ldg(&tris[3 * ref + 1]),
                               __ldg(&tris[3 * ref + 2]), t_max);
        if (kCount) {
          ++n_tris;
          if (seen_refs != nullptr) seen_refs[ref] = 1;
        }
        if (kAny) {
          if (t < INFINITY) {
            occluded = true;
            break;
          }
        } else {
          const long long p = static_cast<long long>(__float_as_int(va.w));
          if (t < best_t || (t == best_t && t < INFINITY && p < best_p)) {
            best_t = t;
            best_p = p;
          }
        }
      }
      if (kAny && occluded) break;
    }
  }
  if (kAny) {
    occ_out[i] = occluded;
  } else {
    t_out[i] = best_t;
    prim_out[i] = best_p;
  }
  if (kCount) {
    atomicAdd(&counts[0], n_nodes);
    atomicAdd(&counts[1], n_tris);
  }
}

template <bool kAny>
int launch(const void* nodes, const void* tris, const void* root,
           const void* o, const void* d, const void* tmax, int n, void* t_out,
           void* prim_out, void* occ_out, void* counts, void* seen_nodes,
           void* seen_refs, void* stream) {
  if (n <= 0) return 0;
  const dim3 grid((n + kThreads - 1) / kThreads), block(kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int2* nd = static_cast<const int2*>(nodes);
  const float4* tr = static_cast<const float4*>(tris);
  const float* rt = static_cast<const float*>(root);
  const float* of = static_cast<const float*>(o);
  const float* df = static_cast<const float*>(d);
  const float* tm = static_cast<const float*>(tmax);
  float* to = static_cast<float*>(t_out);
  long long* po = static_cast<long long*>(prim_out);
  bool* oc = static_cast<bool*>(occ_out);
  unsigned long long* cn = static_cast<unsigned long long*>(counts);
  unsigned char* sn = static_cast<unsigned char*>(seen_nodes);
  unsigned char* sr = static_cast<unsigned char*>(seen_refs);
  if (cn != nullptr) {
    kd_traverse<kAny, true><<<grid, block, 0, s>>>(nd, tr, rt, of, df, tm, n,
                                                   to, po, oc, cn, sn, sr);
  } else {
    kd_traverse<kAny, false><<<grid, block, 0, s>>>(
        nd, tr, rt, of, df, tm, n, to, po, oc, nullptr, nullptr, nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Closest hit: t_out (n,) float32, prim_out (n,) int64.  counts, when not
// null, is a zeroed (2,) 64-bit integer that receives the node visits and
// triangle tests of the launch; seen_nodes (M,) and seen_refs (R,), zeroed
// bytes that may be null, then receive a 1 for each node and leaf reference
// the launch read.  Returns the cudaError_t of the launch.
int lumo_kd_closest(const void* nodes, const void* tris, const void* root,
                    const void* o, const void* d, const void* tmax, int n,
                    void* t_out, void* prim_out, void* counts,
                    void* seen_nodes, void* seen_refs, void* stream) {
  return launch<false>(nodes, tris, root, o, d, tmax, n, t_out, prim_out,
                       nullptr, counts, seen_nodes, seen_refs, stream);
}

// Any hit: occ_out (n,) bool.
int lumo_kd_any(const void* nodes, const void* tris, const void* root,
                const void* o, const void* d, const void* tmax, int n,
                void* occ_out, void* counts, void* seen_nodes,
                void* seen_refs, void* stream) {
  return launch<true>(nodes, tris, root, o, d, tmax, n, nullptr, nullptr,
                      occ_out, counts, seen_nodes, seen_refs, stream);
}

}  // extern "C"
