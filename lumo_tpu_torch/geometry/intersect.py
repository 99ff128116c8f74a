"""Batched ray-triangle intersection (the dense reference path).

Counterpart of ``lumo_tpu/geometry/intersect.py``: triangles and
spheres (the analytic kinds are ``geometry/analytic.py``).  The
watertight Woop et al. 2013 permute+shear triangle test with its
PBR-style gamma error bound (reference ``triangle.rs:63-187``) is the
arithmetic the CUDA traversal kernel mirrors operation for operation, so
this module is also the plain version that kernel is held against.
"""
from __future__ import annotations

import math

import torch

from lumo_tpu_torch.config import INF, gamma_bound
from lumo_tpu_torch.geometry.onb import cross, dot, normalize

_F32_TINY = float(torch.finfo(torch.float32).tiny)
_F32_EPS = float(torch.finfo(torch.float32).eps)


def _permute_axes(v, kz):
    """Cyclically permute xyz so that axis kz lands in z."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    px = torch.where(kz == 0, y, torch.where(kz == 1, z, x))
    py = torch.where(kz == 0, z, torch.where(kz == 1, x, y))
    pz = torch.where(kz == 0, x, torch.where(kz == 1, y, z))
    return torch.stack([px, py, pz], dim=-1)


def ray_setup(d):
    """Per-ray Woop constants: d (N, 3) -> (kz (N,) int64, shear (N, 3))
    with shear = (-dx/dz, -dy/dz, 1/dz) in permuted space."""
    ad = torch.abs(d)
    kz = torch.where((ad[..., 0] > ad[..., 1]) & (ad[..., 0] > ad[..., 2]), 0,
                     torch.where(ad[..., 1] > ad[..., 2], 1, 2))
    dp = _permute_axes(d, kz)
    inv_z = 1.0 / dp[..., 2]
    shear = torch.stack([-dp[..., 0] * inv_z, -dp[..., 1] * inv_z, inv_z],
                        dim=-1)
    return kz, shear


def triangle_t(o, kz, shear, a, b, c, t_min, t_max):
    """Watertight triangle test, t only.

    o (N, 3); kz (N,), shear (N, 3) from :func:`ray_setup`; a, b, c
    (N|1, T, 3); t_min, t_max scalars or (N, 1).  Returns (t (N, T) with
    INF on a miss, det, (e0, e1, e2))."""
    kzb = kz[..., None]
    sx = shear[..., 0][..., None]
    sy = shear[..., 1][..., None]
    sz = shear[..., 2][..., None]
    ox = o[..., 0][..., None]
    oy = o[..., 1][..., None]
    oz = o[..., 2][..., None]

    def shear_xyz(v):
        rx = v[..., 0] - ox
        ry = v[..., 1] - oy
        rz = v[..., 2] - oz
        px = torch.where(kzb == 0, ry, torch.where(kzb == 1, rz, rx))
        py = torch.where(kzb == 0, rz, torch.where(kzb == 1, rx, ry))
        pz = torch.where(kzb == 0, rx, torch.where(kzb == 1, ry, rz))
        return px + sx * pz, py + sy * pz, sz * pz

    ax, ay, az = shear_xyz(a)
    bx, by, bz = shear_xyz(b)
    cx, cy, cz = shear_xyz(c)

    e0 = bx * cy - by * cx
    e1 = cx * ay - cy * ax
    e2 = ax * by - ay * bx

    # all edges same sign (watertight: zero edges pass)
    miss_sign = ((torch.minimum(torch.minimum(e0, e1), e2) < 0.0)
                 & (torch.maximum(torch.maximum(e0, e1), e2) > 0.0))
    det = e0 + e1 + e2
    t_scaled = e0 * az + e1 * bz + e2 * cz

    neg = det < 0.0
    out_range = torch.where(
        neg,
        (t_scaled > t_min * det) | (t_scaled < t_max * det),
        (t_scaled < t_min * det) | (t_scaled > t_max * det),
    )
    ok = ~miss_sign & (det != 0.0) & ~out_range
    t = torch.where(ok, t_scaled / torch.where(det == 0.0, 1.0, det), INF)

    # conservative fp error bound on t (reference ``triangle.rs:133-153``)
    max_z = torch.maximum(torch.abs(az), torch.maximum(torch.abs(bz),
                                                       torch.abs(cz)))
    max_x = torch.maximum(torch.abs(ax), torch.maximum(torch.abs(bx),
                                                       torch.abs(cx)))
    max_y = torch.maximum(torch.abs(ay), torch.maximum(torch.abs(by),
                                                       torch.abs(cy)))
    d_z = gamma_bound(3) * max_z
    d_x = gamma_bound(5) * (max_x + max_z)
    d_y = gamma_bound(5) * (max_y + max_z)
    d_e = 2.0 * (gamma_bound(2) * max_x * max_y + d_y * max_x + d_x * max_y)
    max_e = torch.maximum(torch.abs(e0), torch.maximum(torch.abs(e1),
                                                       torch.abs(e2)))
    abs_det = torch.clamp(torch.abs(det), min=_F32_TINY)
    d_t = 3.0 * (gamma_bound(3) * max_e * max_z + d_e * max_z
                 + d_z * max_e) / abs_det
    t = torch.where(t <= t_min + d_t, INF, t)
    return t, det, (e0, e1, e2)


def triangle_detail(o, d, a, b, c, na, nb, nc, uva, uvb, uvc):
    """Shading data for the selected triangle per ray; all args (N, ...).
    Returns dict with p, ng, ns, uv, err (fp error bound vector)."""
    kz, shear = ray_setup(d)
    _, det, (e0, e1, e2) = triangle_t(o, kz, shear, a[:, None], b[:, None],
                                      c[:, None], 0.0, INF)
    det = det[:, 0]
    inv_det = 1.0 / torch.where(det == 0.0, 1.0, det)
    al = (e0[:, 0] * inv_det)[..., None]
    be = (e1[:, 0] * inv_det)[..., None]
    ga = (e2[:, 0] * inv_det)[..., None]
    p = al * a + be * b + ga * c
    ng = normalize(cross(b - a, c - a))
    ns_raw = al * na + be * nb + ga * nc
    has_ns = (dot(ns_raw, ns_raw) > 1e-12)[..., None]
    ns = torch.where(has_ns, normalize(torch.where(has_ns, ns_raw, ng)), ng)
    uv = al * uva + be * uvb + ga * uvc
    err = gamma_bound(7) * (torch.abs(al * a) + torch.abs(be * b)
                            + torch.abs(ga * c))
    return {"p": p, "ng": ng, "ns": ns, "uv": uv, "err": err}


def _safe_root(disc):
    """sqrt(max(disc, 0)) whose gradient is 0, not NaN, where disc <= 0:
    a miss lane's zero cotangent times sqrt'(0) = INF would be NaN (the
    JAX package's clamp-then-sqrt gives NaN camera gradients there)."""
    pos = disc > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, disc, 1.0)), 0.0)


def sphere_t(o, d, center, radius, t_min, t_max):
    """Robust sphere test, t only: o, d (N, 3); center (N|1, S, 3);
    radius (N|1, S); t_min, t_max scalars or (N, 1).  Returns t (N, S),
    INF on a miss.  The stable quadratic with a conservative epsilon on t
    stands for the reference's EFloat bounds; ``sphere_detail``'s
    reprojection recovers the precision that matters."""
    oc = o[..., None, :] - center                       # (N, S, 3)
    half_b = dot(oc, d[..., None, :])                  # d is unit: A = 1
    cc = dot(oc, oc) - radius * radius
    disc = half_b * half_b - cc
    ok = disc >= 0.0
    root = _safe_root(disc)
    q = -(half_b + torch.sign(half_b) * root)
    t0 = torch.where(torch.abs(q) > 0, cc / torch.where(q == 0, 1.0, q), INF)
    lo = torch.minimum(t0, q)
    hi = torch.maximum(t0, q)
    eps = 32.0 * _F32_EPS * torch.clamp(torch.abs(hi), min=1.0)
    lo_ok = ok & (lo > t_min + eps) & (lo < t_max)
    hi_ok = ok & (hi > t_min + eps) & (hi < t_max)
    return torch.where(lo_ok, lo, torch.where(hi_ok, hi, INF))


def sphere_detail(o, d, t, center, radius):
    """Shading data of the selected sphere hit per ray (all (N, ...)),
    the hit point reprojected onto the surface (reference
    ``sphere.rs:63-64``)."""
    rel = o + t[..., None] * d - center
    rel = rel * (radius[..., None] / torch.clamp(
        torch.linalg.vector_norm(rel, dim=-1, keepdim=True), min=_F32_TINY))
    p = center + rel
    ng = rel / radius[..., None]
    theta = torch.arccos(torch.clamp(-ng[..., 1], -1.0, 1.0))
    phi = torch.atan2(-ng[..., 2], ng[..., 0]) + math.pi
    uv = torch.stack([phi / (2.0 * math.pi), theta / math.pi], dim=-1)
    err = gamma_bound(5) * torch.abs(p)
    return {"p": p, "ng": ng, "ns": ng, "uv": uv, "err": err}


def offset_ray_origin(p, err, ng, wi):
    """Offset a secondary-ray origin out of the surface by the accumulated
    fp error bound, then one ulp further (reference ``hit.rs:86-110``)."""
    scaled = dot(err, torch.abs(ng))[..., None]
    outside = (dot(wi, ng) >= 0.0)[..., None]
    offset = torch.where(outside, 1.0, -1.0) * scaled * ng
    xi = p + offset
    # the nextafter walk is a sub-ulp correction whose derivative is 1:
    # applied straight through, as in ``lumo_tpu/geometry/intersect.py``
    xs = xi.detach()
    up = torch.nextafter(xs, torch.full_like(xs, INF))
    down = torch.nextafter(xs, torch.full_like(xs, -INF))
    walked = torch.where(offset > 0.0, up, torch.where(offset < 0.0, down, xs))
    return xi + (walked - xs)
