// Ray set-up and the watertight Woop triangle test shared by the BVH and
// kd-tree traversal kernels (bvh_traverse.cu, kd_traverse.cu).
//
// The test mirrors lumo_tpu_torch/geometry/intersect.py::triangle_t
// operation for operation (Woop shear, edge functions, range check,
// conservative gamma bound on t).  Both kernels are built with
// --fmad=false and IEEE division, so the t of a (ray, triangle) pair is
// bit-equal to the plain PyTorch version's and equal between the kernels.
#pragma once

#include <cfloat>
#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

namespace lumo {

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

}  // namespace lumo
