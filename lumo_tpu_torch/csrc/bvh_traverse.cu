// BVH closest-hit and any-hit traversal for Hopper (sm_90a): persistent
// warps over child-pair nodes.
//
// Replaces lumo_tpu/accel/pallas_bvh.py::_traverse_kernel, the TPU packet
// walk, with its leaf test _pairwise_tri_t inlined.  It computes the same
// function: per ray, the nearest triangle hit in (0, t_max) as (t, prim),
// prim = -1 and t = INF on a miss, ties to the smaller prim id; or an
// occlusion flag with early exit.  The leaf test is woop.cuh's (--fmad=false,
// IEEE division), so t is bit-equal to the plain version's wherever the
// prims agree.
//
// None of the TPU layout carries over (1024-ray packets, scalar SMEM
// stack, (8, 128) tiles, Morton sort, leaf-block DMA).  Layout
// (lumo_tpu_torch/accel/bvh_kernel.py::pack_nodes): the builder's binary
// DFS tree repacked as child pairs, one 64-byte record per inner node:
//   [0] = (lo.xyz of child 0, bits(link 0))
//   [1] = (hi.xyz of child 0, bits(link 1))
//   [2] = (lo.xyz of child 1, 0)
//   [3] = (hi.xyz of child 1, 0)
// A link below 2^30 is the record of an inner child; a link of 2^30 and
// above is a leaf, with link - 2^30 = first << 3 | count into tris (float4
// triples (a, b, c) in leaf order; the index is the global prim id).  With
// first < 2^26 no link word is a NaN pattern, so the records stay equal
// under any float copy.  Record 0 holds the root's children (a tree that
// is one leaf gets a record whose second child is an empty leaf).
//
// The walk: one fetch tests both children of a record; it descends into
// the nearer hit child by entry distance, pushes the other (link and entry
// distance) only if both hit, and pops when neither does.  A popped entry
// is skipped when its entry distance is no longer below the best hit so
// far, inflated by 1.00000024 as the TPU kernel does, which is the slab
// test's own bound at the time of the pop, so fp error never drops the true
// closest triangle.  The scheduling is persistent.cuh's: resident blocks
// only, rays fetched per warp, an interior phase and a leaf phase.
//
// The stats variant (lumo_bvh_closest_stats) replaces the TPU kernel's
// stats=True mode (pallas_bvh.py:489, behind closest_hit_stats): the same
// closest hit plus, per ray, the inner records fetched, the leaves entered
// and the triangles tested, reduced per group of 32 consecutive rays to a
// sum and a maximum (atomicAdd and atomicMax into the wrapper's zeroed
// (ceil(n / 32), 2, 3) int32).  The counting launch (counts != null) adds
// the launch's totals and the warp trips of each phase, from which SIMT
// efficiency of the persistent schedule follows.
//
// What bounds it on an H100: the latency of dependent loads, not bandwidth
// or arithmetic (the 327,692-triangle scene, about 10 MB of records and
// 16 MB of triangles, sits in the 50 MB L2).  Child pairs halve the
// dependent node loads and never fetch a box that misses; persistent warps
// with refill keep lanes busy where one thread per ray left a warp waiting
// on its slowest lane and a second wave's tail idle.

#include "persistent.cuh"
#include "woop.cuh"

namespace {

using namespace lumo;

constexpr int kStack = 64;
constexpr int kLeafLink = 1 << 30;  // links from here on are leaves
constexpr int kNoLink = -1;         // an empty stack

// conservative slab test of a box against (0, bound); tn is the entry
// distance
__device__ __forceinline__ bool slab(const Ray& r, float4 lo, float4 hi,
                                     float bound, float& tn) {
  const float t0x = (lo.x - r.ox) * r.ix, t1x = (hi.x - r.ox) * r.ix;
  const float t0y = (lo.y - r.oy) * r.iy, t1y = (hi.y - r.oy) * r.iy;
  const float t0z = (lo.z - r.oz) * r.iz, t1z = (hi.z - r.oz) * r.iz;
  tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
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
             unsigned char* __restrict__ seen_tris, int* __restrict__ stats,
             int* __restrict__ work) {
  const int lane = threadIdx.x & 31;
  int stack_l[kStack];
  float stack_t[kStack];
  int sp = 0;
  int ray = -1, cur = kDone, tri = 0, tri_end = 0;
  RayQueue queue = make_queue(n);
  Ray r;
  float t_max = 0.f, best_t = INFINITY;
  int best_p = -1;
  bool occluded = false;
  // per ray (stats): inner records, leaves, tests
  int c_inner = 0, c_leaf = 0, c_test = 0;
  // per thread (counting launch): fetches, tests; per warp: phase trips
  unsigned long long n_nodes = 0, n_tris = 0, w_inner = 0, w_leaf = 0;

  // the next record or leaf from the stack, skipping entries that start
  // beyond the best hit; kDone when it is empty
  auto pop = [&]() -> int {
    const float bound = fminf(best_t, t_max) * kInflate;
    while (sp > 0) {
      --sp;
      if (kAny || stack_t[sp] < bound) return stack_l[sp];
    }
    return kNoLink;
  };
  auto go = [&](int link) {
    if (link < 0) {
      cur = kDone;
    } else if (link < kLeafLink) {
      cur = link;
    } else {
      const int leaf = link - kLeafLink;
      tri = leaf >> 3;
      tri_end = tri + (leaf & 7);
      cur = kLeaf;
      if (kStats) ++c_leaf;
    }
  };

  while (true) {
    ray = refill(ray, work, n, queue);
    if (ray >= 0 && cur == kDone) {  // a new ray
      t_max = tmax[ray];
      if (!(t_max > 0.f)) {  // dead lanes (t_max <= 0, or NaN) miss at once
        if (kAny) {
          occ_out[ray] = false;
        } else {
          t_out[ray] = INFINITY;
          prim_out[ray] = -1;
        }
        ray = -1;
      } else {
        r = make_ray(o, d, ray);
        best_t = INFINITY;
        best_p = -1;
        occluded = false;
        sp = 0;
        cur = 0;
        c_inner = c_leaf = c_test = 0;
      }
    }
    if (__ballot_sync(kFullMask, ray >= 0) == 0) {
      if (queue.empty()) break;
      continue;
    }

    // interior phase
    while (true) {
      const bool inner = cur >= 0;
      if (__ballot_sync(kFullMask, inner) == 0) break;
      if (kCount && lane == 0) ++w_inner;
      if (!inner) continue;
      const float4* rec = nodes + 4 * static_cast<size_t>(cur);
      const float4 lo0 = __ldg(rec), hi0 = __ldg(rec + 1);
      const float4 lo1 = __ldg(rec + 2), hi1 = __ldg(rec + 3);
      if (kCount) {
        ++n_nodes;
        if (seen_nodes != nullptr) seen_nodes[cur] = 1;
      }
      if (kStats) ++c_inner;
      const float bound = kAny ? t_max : fminf(best_t, t_max);
      float tn0, tn1;
      const bool h0 = slab(r, lo0, hi0, bound, tn0);
      const bool h1 = slab(r, lo1, hi1, bound, tn1);
      const int l0 = __float_as_int(lo0.w), l1 = __float_as_int(hi0.w);
      if (h0 && h1) {
        const bool first0 = tn0 <= tn1;
        stack_l[sp] = first0 ? l1 : l0;
        if (!kAny) stack_t[sp] = first0 ? tn1 : tn0;
        ++sp;
        go(first0 ? l0 : l1);
      } else if (h0 || h1) {
        go(h0 ? l0 : l1);
      } else {
        go(pop());
      }
    }

    // leaf phase: one triangle per lane and trip
    while (true) {
      const bool in_leaf = cur == kLeaf;
      if (__ballot_sync(kFullMask, in_leaf) == 0) break;
      if (kCount && lane == 0) ++w_leaf;
      if (!in_leaf) continue;
      if (tri < tri_end) {
        const int p = tri++;
        const float t = woop_t(r, __ldg(&tris[3 * p]), __ldg(&tris[3 * p + 1]),
                               __ldg(&tris[3 * p + 2]), t_max);
        if (kCount) {
          ++n_tris;
          if (seen_tris != nullptr) seen_tris[p] = 1;
        }
        if (kStats) ++c_test;
        if (kAny) {
          if (t < INFINITY) {
            occluded = true;
            cur = kDone;
            continue;
          }
        } else if (t < best_t ||
                   (t == best_t && t < INFINITY && p < best_p)) {
          best_t = t;
          best_p = p;
        }
      }
      if (tri >= tri_end) go(pop());
    }

    // lanes whose walk is over write their ray's result
    if (ray >= 0 && cur == kDone) {
      if (kAny) {
        occ_out[ray] = occluded;
      } else {
        t_out[ray] = best_t;
        prim_out[ray] = best_p;
      }
      if (kStats) {
        int* row = stats + 6 * (ray >> 5);
        atomicAdd(&row[0], c_inner);
        atomicAdd(&row[1], c_leaf);
        atomicAdd(&row[2], c_test);
        atomicMax(&row[3], c_inner);
        atomicMax(&row[4], c_leaf);
        atomicMax(&row[5], c_test);
      }
      ray = -1;
    }
  }
  if (kCount) {
    atomicAdd(&counts[0], n_nodes);
    atomicAdd(&counts[1], n_tris);
    if (lane == 0) {
      atomicAdd(&counts[2], w_inner);
      atomicAdd(&counts[3], w_leaf);
    }
  }
}

// the launch's kernel for a mode: 0 closest, 1 any, 2 closest counting,
// 3 any counting, 4 stats
using KernelFn = void (*)(const float4*, const float4*, const float*,
                          const float*, const float*, int, float*, long long*,
                          bool*, unsigned long long*, unsigned char*,
                          unsigned char*, int*, int*);

KernelFn kernel_of(int mode) {
  switch (mode) {
    case 0: return traverse<false, false, false>;
    case 1: return traverse<true, false, false>;
    case 2: return traverse<false, true, false>;
    case 3: return traverse<true, true, false>;
    default: return traverse<false, false, true>;
  }
}

int launch(int mode, const void* nodes, const void* tris, const void* o,
           const void* d, const void* tmax, int n, void* t_out,
           void* prim_out, void* occ_out, void* counts, void* seen_nodes,
           void* seen_tris, void* stats, void* work, void* stream) {
  if (n <= 0) return 0;
  if (work == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const KernelFn k = kernel_of(mode);
  k<<<launch_grid(k, mode, n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(nodes), static_cast<const float4*>(tris),
      static_cast<const float*>(o), static_cast<const float*>(d),
      static_cast<const float*>(tmax), n, static_cast<float*>(t_out),
      static_cast<long long*>(prim_out), static_cast<bool*>(occ_out),
      static_cast<unsigned long long*>(counts),
      static_cast<unsigned char*>(seen_nodes),
      static_cast<unsigned char*>(seen_tris), static_cast<int*>(stats),
      static_cast<int*>(work));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Closest hit: t_out (n,) float32, prim_out (n,) int64.  work is a zeroed
// int32 the launch counts its rays with.  counts, when not null, is a
// zeroed (4,) 64-bit integer that receives the inner records fetched, the
// triangles tested, and the warp trips of the interior and the leaf phase;
// seen_nodes (K,) and seen_tris (T,), zeroed bytes that may be null, then
// receive a 1 for each record and triangle the launch read.  Returns the
// cudaError_t of the launch.
int lumo_bvh_closest(const void* nodes, const void* tris, const void* o,
                     const void* d, const void* tmax, int n, void* t_out,
                     void* prim_out, void* counts, void* seen_nodes,
                     void* seen_tris, void* work, void* stream) {
  return launch(counts != nullptr ? 2 : 0, nodes, tris, o, d, tmax, n, t_out,
                prim_out, nullptr, counts, seen_nodes, seen_tris, nullptr,
                work, stream);
}

// Closest hit with counters: stats, a zeroed (ceil(n / 32), 2, 3) int32,
// receives per group of 32 consecutive rays the sum and the maximum over
// its rays of the inner records fetched, the leaves entered and the
// triangles tested.
int lumo_bvh_closest_stats(const void* nodes, const void* tris,
                           const void* o, const void* d, const void* tmax,
                           int n, void* t_out, void* prim_out, void* stats,
                           void* work, void* stream) {
  if (n > 0 && stats == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch(4, nodes, tris, o, d, tmax, n, t_out, prim_out, nullptr,
                nullptr, nullptr, nullptr, stats, work, stream);
}

// Any hit: occ_out (n,) bool.
int lumo_bvh_any(const void* nodes, const void* tris, const void* o,
                 const void* d, const void* tmax, int n, void* occ_out,
                 void* counts, void* seen_nodes, void* seen_tris, void* work,
                 void* stream) {
  return launch(counts != nullptr ? 3 : 1, nodes, tris, o, d, tmax, n,
                nullptr, nullptr, occ_out, counts, seen_nodes, seen_tris,
                nullptr, work, stream);
}

// Resident blocks per SM of a mode's kernel (0 closest, 1 any, 2 and 3
// their counting launches, 4 stats) on the current device, and the grid of
// its launch over n rays, into out[0] and out[1].
int lumo_bvh_grid(int mode, int n, int* out) {
  const KernelFn k = kernel_of(mode);
  resident_grid(k, mode, &out[0]);
  out[1] = n > 0 ? launch_grid(k, mode, n) : 0;
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
