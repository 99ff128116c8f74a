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
// What bounds it on an H100: not bandwidth or arithmetic but the latency
// of dependent loads.  Every step of the walk is a 32-byte node fetch
// whose address depends on the previous one, and rays of one warp diverge
// in path and trip count.  The design answers with occupancy and cache:
// small per-thread state so many warps hide each other's latency, all
// reads through the read-only path (__ldg), and a layout in which the
// 327,692-triangle scene (about 21 MB of nodes and 16 MB of triangles)
// fits in the 50 MB L2, so a walk's loads hit L2 rather than HBM.

#include <cfloat>
#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kStack = 64;
constexpr int kThreads = 128;

// gamma(n) = n e / (1 - n e) with e = 2^-24 (config.gamma_bound), rounded to
// float as torch rounds a Python scalar operand of a float32 tensor.
constexpr double kEpsHalf = 5.9604644775390625e-08;
constexpr float kG2 = static_cast<float>(2 * kEpsHalf / (1.0 - 2 * kEpsHalf));
constexpr float kG3 = static_cast<float>(3 * kEpsHalf / (1.0 - 3 * kEpsHalf));
constexpr float kG5 = static_cast<float>(5 * kEpsHalf / (1.0 - 5 * kEpsHalf));
// conservative slab inflation (pallas_bvh.py:548-552)
constexpr float kInflate = 1.00000024f;

struct Ray {
  float ox, oy, oz;
  float dx, dy, dz;
  int kz;
  float sx, sy, sz;  // Woop shear constants (intersect.ray_setup)
  float ix, iy, iz;  // slab reciprocals
};

// cyclic permutation moving axis kz to z (intersect._permute_axes)
__device__ __forceinline__ void permute(float x, float y, float z, int kz,
                                        float& px, float& py, float& pz) {
  px = kz == 0 ? y : (kz == 1 ? z : x);
  py = kz == 0 ? z : (kz == 1 ? x : y);
  pz = kz == 0 ? x : (kz == 1 ? y : z);
}

// reciprocal with the +-1e-30 clamp of pallas_bvh.py:502-504
__device__ __forceinline__ float inv_clamped(float v) {
  const float tiny = v < 0.f ? -1e-30f : 1e-30f;
  return 1.0f / (fabsf(v) < 1e-30f ? tiny : v);
}

__device__ __forceinline__ Ray make_ray(const float* o, const float* d,
                                        int i) {
  Ray r;
  r.ox = o[3 * i];
  r.oy = o[3 * i + 1];
  r.oz = o[3 * i + 2];
  r.dx = d[3 * i];
  r.dy = d[3 * i + 1];
  r.dz = d[3 * i + 2];
  const float adx = fabsf(r.dx), ady = fabsf(r.dy), adz = fabsf(r.dz);
  r.kz = (adx > ady && adx > adz) ? 0 : (ady > adz ? 1 : 2);
  float dpx, dpy, dpz;
  permute(r.dx, r.dy, r.dz, r.kz, dpx, dpy, dpz);
  const float inv_z = 1.0f / dpz;
  r.sx = -dpx * inv_z;
  r.sy = -dpy * inv_z;
  r.sz = inv_z;
  r.ix = inv_clamped(r.dx);
  r.iy = inv_clamped(r.dy);
  r.iz = inv_clamped(r.dz);
  return r;
}

__device__ __forceinline__ void shear_vertex(const Ray& r, float4 v,
                                             float& X, float& Y, float& Z) {
  float px, py, pz;
  permute(v.x - r.ox, v.y - r.oy, v.z - r.oz, r.kz, px, py, pz);
  X = px + r.sx * pz;
  Y = py + r.sy * pz;
  Z = r.sz * pz;
}

// Watertight Woop test, t only: intersect.triangle_t with t_min = 0.
__device__ __forceinline__ float woop_t(const Ray& r, float4 va, float4 vb,
                                        float4 vc, float t_max) {
  float ax, ay, az, bx, by, bz, cx, cy, cz;
  shear_vertex(r, va, ax, ay, az);
  shear_vertex(r, vb, bx, by, bz);
  shear_vertex(r, vc, cx, cy, cz);
  const float e0 = bx * cy - by * cx;
  const float e1 = cx * ay - cy * ax;
  const float e2 = ax * by - ay * bx;
  const bool miss_sign = (fminf(fminf(e0, e1), e2) < 0.f) &&
                         (fmaxf(fmaxf(e0, e1), e2) > 0.f);
  const float det = e0 + e1 + e2;
  const float t_scaled = e0 * az + e1 * bz + e2 * cz;
  const float t_min = 0.f;
  const bool out_range =
      det < 0.f ? (t_scaled > t_min * det || t_scaled < t_max * det)
                : (t_scaled < t_min * det || t_scaled > t_max * det);
  if (miss_sign || det == 0.f || out_range) return INFINITY;
  const float t = t_scaled / det;
  // conservative fp error bound on t (reference triangle.rs:133-153)
  const float max_z = fmaxf(fabsf(az), fmaxf(fabsf(bz), fabsf(cz)));
  const float max_x = fmaxf(fabsf(ax), fmaxf(fabsf(bx), fabsf(cx)));
  const float max_y = fmaxf(fabsf(ay), fmaxf(fabsf(by), fabsf(cy)));
  const float d_z = kG3 * max_z;
  const float d_x = kG5 * (max_x + max_z);
  const float d_y = kG5 * (max_y + max_z);
  const float d_e = 2.0f * (kG2 * max_x * max_y + d_y * max_x + d_x * max_y);
  const float max_e = fmaxf(fabsf(e0), fmaxf(fabsf(e1), fabsf(e2)));
  const float abs_det = fmaxf(fabsf(det), FLT_MIN);
  const float d_t =
      3.0f * (kG3 * max_e * max_z + d_e * max_z + d_z * max_e) / abs_det;
  return t <= t_min + d_t ? INFINITY : t;
}

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

template <bool kAny, bool kCount>
__global__ void __launch_bounds__(kThreads)
    traverse(const float4* __restrict__ nodes, const float4* __restrict__ tris,
             const float* __restrict__ o, const float* __restrict__ d,
             const float* __restrict__ tmax, int n, float* __restrict__ t_out,
             long long* __restrict__ prim_out, bool* __restrict__ occ_out,
             unsigned long long* __restrict__ counts,
             unsigned char* __restrict__ seen_nodes,
             unsigned char* __restrict__ seen_tris) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float t_max = tmax[i];
  float best_t = INFINITY;
  long long best_p = -1;
  bool occluded = false;
  unsigned long long n_nodes = 0, n_tris = 0;
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
           void* stream) {
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
  if (cn != nullptr) {
    traverse<kAny, true><<<grid, block, 0, s>>>(nd, tr, of, df, tm, n, to,
                                                po, oc, cn, sn, st);
  } else {
    traverse<kAny, false><<<grid, block, 0, s>>>(nd, tr, of, df, tm, n, to,
                                                 po, oc, nullptr, nullptr,
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
                       counts, seen_nodes, seen_tris, stream);
}

// Any hit: occ_out (n,) bool.
int lumo_bvh_any(const void* nodes, const void* tris, const void* o,
                 const void* d, const void* tmax, int n, void* occ_out,
                 void* counts, void* seen_nodes, void* seen_tris,
                 void* stream) {
  return launch<true>(nodes, tris, o, d, tmax, n, nullptr, nullptr, occ_out,
                      counts, seen_nodes, seen_tris, stream);
}

}  // extern "C"
