// BVH closest-hit and any-hit traversal for Hopper (sm_90a), one thread per
// ray.
//
// Replaces lumo_tpu/accel/pallas_bvh.py::_traverse_kernel, the TPU packet
// walk, with its leaf test _pairwise_tri_t inlined.  It computes the same
// function: per ray, the nearest triangle hit in (0, t_max) as (t, prim),
// prim = -1 and t = INF on a miss, ties to the smaller prim id; or an
// occlusion flag with early exit.  The leaf test mirrors
// lumo_tpu_torch/geometry/intersect.py::triangle_t operation for operation
// (Woop watertight shear, edge functions, range check, conservative gamma
// bound on t), so with contraction off (--fmad=false) and IEEE division
// the kernel's t is bit-equal to the plain version's wherever the prims
// agree.
//
// None of the TPU layout carries over: the 1024-ray packets, the scalar
// SMEM stack, the (8, 128) tiles, the Morton ray sort and the leaf-block
// DMA exist for the TPU's scalar/vector split.  Here each ray walks the
// builder's binary DFS tree (accel/build.py) on its own:
//   nodes  float4 pairs: (lo.xyz, bits(right << 2 | axis)),
//                        (hi.xyz, bits(first << 3 | count))
//   tris   float4 triples (a, b, c) in leaf order; first/count index them
//          directly and the index is the global prim id.
// A 64-entry per-thread stack holds far children (the wrapper rejects
// deeper trees); the near child is taken first by the sign of the ray
// direction on the split axis; nodes are pruned against the best hit so
// far, inflated by 1.00000024 as the TPU kernel does, so fp error in the
// slab test never drops the true closest triangle.
//
// The stats variant (lumo_bvh_closest_stats) replaces the TPU kernel's
// stats=True mode (pallas_bvh.py:489, behind closest_hit_stats): the same
// closest hit plus counters of the interior nodes fetched, the leaves
// fetched and the triangles tested.  The TPU accumulates them per 1024-ray
// packet, its unit of divergence; on this card the unit is the warp, so
// each thread counts in registers and the warp reduces them
// (__reduce_add_sync, __reduce_max_sync): lane 0 writes the sum and the
// maximum over the warp's 32 consecutive rays, (ceil(n / 32), 2, 3) int32.
//
// What bounds it on an H100: not bandwidth or arithmetic but the latency
// of dependent loads.  Every step of the walk is a 32-byte node fetch
// whose address depends on the previous one, and rays of one warp diverge
// in path and trip count.  The design answers with occupancy and cache:
// small per-thread state so many warps hide each other's latency, all
// reads through the read-only path (__ldg), and a layout in which the
// 327,692-triangle scene (about 21 MB of nodes and 16 MB of triangles)
// fits in the 50 MB L2, so a walk's loads hit L2 rather than HBM.

#include "woop.cuh"

namespace {

using namespace lumo;

constexpr int kStack = 64;
constexpr int kThreads = 128;

// conservative slab test of a node box against (0, bound)
__device__ __forceinline__ bool slab(const Ray& r, float4 lo, float4 hi,
                                     float bound) {
  const float t0x = (lo.x - r.ox) * r.ix, t1x = (hi.x - r.ox) * r.ix;
  const float t0y = (lo.y - r.oy) * r.iy, t1y = (hi.y - r.oy) * r.iy;
  const float t0z = (lo.z - r.oz) * r.iz, t1z = (hi.z - r.oz) * r.iz;
  const float tn =
      fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
  const float tf =
      fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z)) *
      kInflate;
  return tn <= tf && tf > 0.f && tn < bound * kInflate;
}

template <bool kAny, bool kCount, bool kStats>
__global__ void __launch_bounds__(kThreads)
    traverse(const float4* __restrict__ nodes, const float4* __restrict__ tris,
             const float* __restrict__ o, const float* __restrict__ d,
             const float* __restrict__ tmax, int n, float* __restrict__ t_out,
             long long* __restrict__ prim_out, bool* __restrict__ occ_out,
             unsigned long long* __restrict__ counts,
             unsigned char* __restrict__ seen_nodes,
             unsigned char* __restrict__ seen_tris,
             int* __restrict__ stats) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  // the stats variant keeps lanes past the end for its warp reductions;
  // they count as dead lanes
  const bool in_range = i < n;
  if (!kStats && !in_range) return;
  const float t_max = in_range ? tmax[i] : 0.f;
  float best_t = INFINITY;
  long long best_p = -1;
  bool occluded = false;
  unsigned long long n_nodes = 0, n_tris = 0;
  int n_interior = 0, n_leaf = 0, n_tests = 0;
  if (t_max > 0.f) {  // dead lanes (t_max <= 0, or NaN) miss at once
    const Ray r = make_ray(o, d, i);
    int stack[kStack];
    int sp = 0;
    int node = 0;
    while (true) {
      const float4 lo = __ldg(&nodes[2 * node]);
      const float4 hi = __ldg(&nodes[2 * node + 1]);
      if (kCount) {
        ++n_nodes;
        if (seen_nodes != nullptr) seen_nodes[node] = 1;
      }
      if (kStats) {
        if ((__float_as_uint(hi.w) & 7u) == 0u) {
          ++n_interior;
        } else {
          ++n_leaf;
        }
      }
      const float bound = kAny ? t_max : fminf(best_t, t_max);
      if (slab(r, lo, hi, bound)) {
        const unsigned lo_w = __float_as_uint(lo.w);
        const unsigned hi_w = __float_as_uint(hi.w);
        const int count = static_cast<int>(hi_w & 7u);
        if (count == 0) {  // interior: descend near child, stack the far
          const int axis = static_cast<int>(lo_w & 3u);
          const int right = static_cast<int>(lo_w >> 2);
          const float dax = axis == 0 ? r.dx : (axis == 1 ? r.dy : r.dz);
          const bool left_first = !(dax < 0.f);
          stack[sp++] = left_first ? right : node + 1;
          node = left_first ? node + 1 : right;
          continue;
        }
        const int first = static_cast<int>(hi_w >> 3);
        for (int k = 0; k < count; ++k) {
          const int p = first + k;
          const float t = woop_t(r, __ldg(&tris[3 * p]),
                                 __ldg(&tris[3 * p + 1]),
                                 __ldg(&tris[3 * p + 2]), t_max);
          if (kCount) {
            ++n_tris;
            if (seen_tris != nullptr) seen_tris[p] = 1;
          }
          if (kStats) ++n_tests;
          if (kAny) {
            if (t < INFINITY) {
              occluded = true;
              break;
            }
          } else if (t < best_t || (t == best_t && t < INFINITY &&
                                    p < best_p)) {
            best_t = t;
            best_p = p;
          }
        }
        if (kAny && occluded) break;
      }
      if (sp == 0) break;
      node = stack[--sp];
    }
  }
  if (kStats) {
    const unsigned all = 0xffffffffu;
    const int sums[3] = {__reduce_add_sync(all, n_interior),
                         __reduce_add_sync(all, n_leaf),
                         __reduce_add_sync(all, n_tests)};
    const int peaks[3] = {__reduce_max_sync(all, n_interior),
                          __reduce_max_sync(all, n_leaf),
                          __reduce_max_sync(all, n_tests)};
    // a block holds whole warps of rays; a warp wholly past the end has
    // no row
    if ((threadIdx.x & 31) == 0 && in_range) {
      int* row = stats + 6 * (i >> 5);
      for (int k = 0; k < 3; ++k) {
        row[k] = sums[k];
        row[3 + k] = peaks[k];
      }
    }
    if (!in_range) return;
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
int launch(const void* nodes, const void* tris, const void* o, const void* d,
           const void* tmax, int n, void* t_out, void* prim_out,
           void* occ_out, void* counts, void* seen_nodes, void* seen_tris,
           void* stats, void* stream) {
  if (n <= 0) return 0;
  const dim3 grid((n + kThreads - 1) / kThreads), block(kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* nd = static_cast<const float4*>(nodes);
  const float4* tr = static_cast<const float4*>(tris);
  const float* of = static_cast<const float*>(o);
  const float* df = static_cast<const float*>(d);
  const float* tm = static_cast<const float*>(tmax);
  float* to = static_cast<float*>(t_out);
  long long* po = static_cast<long long*>(prim_out);
  bool* oc = static_cast<bool*>(occ_out);
  unsigned long long* cn = static_cast<unsigned long long*>(counts);
  unsigned char* sn = static_cast<unsigned char*>(seen_nodes);
  unsigned char* st = static_cast<unsigned char*>(seen_tris);
  if (stats != nullptr) {
    traverse<kAny, false, true><<<grid, block, 0, s>>>(
        nd, tr, of, df, tm, n, to, po, oc, nullptr, nullptr, nullptr,
        static_cast<int*>(stats));
  } else if (cn != nullptr) {
    traverse<kAny, true, false><<<grid, block, 0, s>>>(
        nd, tr, of, df, tm, n, to, po, oc, cn, sn, st, nullptr);
  } else {
    traverse<kAny, false, false><<<grid, block, 0, s>>>(
        nd, tr, of, df, tm, n, to, po, oc, nullptr, nullptr, nullptr,
        nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Closest hit: t_out (n,) float32, prim_out (n,) int64.  counts, when not
// null, is a zeroed (2,) 64-bit integer that receives the node visits and
// triangle tests of the launch; seen_nodes (M,) and seen_tris (T,), zeroed
// bytes that may be null, then receive a 1 for each node and triangle the
// launch read.  Returns the cudaError_t of the launch.
int lumo_bvh_closest(const void* nodes, const void* tris, const void* o,
                     const void* d, const void* tmax, int n, void* t_out,
                     void* prim_out, void* counts, void* seen_nodes,
                     void* seen_tris, void* stream) {
  return launch<false>(nodes, tris, o, d, tmax, n, t_out, prim_out, nullptr,
                       counts, seen_nodes, seen_tris, nullptr, stream);
}

// Closest hit with counters: stats (ceil(n / 32), 2, 3) int32 receives, per
// warp of 32 consecutive rays, the sum and the maximum over its lanes of
// the interior nodes fetched, the leaves fetched and the triangles tested.
int lumo_bvh_closest_stats(const void* nodes, const void* tris,
                           const void* o, const void* d, const void* tmax,
                           int n, void* t_out, void* prim_out, void* stats,
                           void* stream) {
  if (stats == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch<false>(nodes, tris, o, d, tmax, n, t_out, prim_out, nullptr,
                       nullptr, nullptr, nullptr, stats, stream);
}

// Any hit: occ_out (n,) bool.
int lumo_bvh_any(const void* nodes, const void* tris, const void* o,
                 const void* d, const void* tmax, int n, void* occ_out,
                 void* counts, void* seen_nodes, void* seen_tris,
                 void* stream) {
  return launch<true>(nodes, tris, o, d, tmax, n, nullptr, nullptr, occ_out,
                      counts, seen_nodes, seen_tris, nullptr, stream);
}

}  // extern "C"
