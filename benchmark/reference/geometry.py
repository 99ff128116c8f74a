"""Vectors, shading frames, square-to-disk warps and the watertight
triangle test (frozen copies of ``lumo_tpu_torch/config.py``'s float32
constants, ``geometry/{onb,intersect}.py`` and ``sampling/maps.py``)."""
from __future__ import annotations

import math

import numpy as np
import torch

PI = math.pi
INF = float(np.inf)
EPSILON = 1e-4                      # the float32 intersection epsilon
_EPS_HALF = float(np.finfo(np.float32).eps) / 2.0


def gamma_bound(n: int) -> float:
    return n * _EPS_HALF / (1.0 - n * _EPS_HALF)


def safe_sqrt(x, eps=1e-24):
    return torch.sqrt(torch.clamp(x, min=eps))


def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def norm(v):
    return torch.sqrt(dot(v, v))


def normalize(v, eps=0.0):
    n = safe_sqrt(dot(v, v))[..., None]
    return v / torch.clamp(n, min=eps if eps else torch.finfo(v.dtype).tiny)


def onb_frame(w):
    z = w[..., 2]
    sgn = torch.where(z >= 0.0, 1.0, -1.0)
    a = -1.0 / (sgn + z)
    b = w[..., 0] * w[..., 1] * a
    u = torch.stack([1.0 + sgn * w[..., 0] ** 2 * a, sgn * b,
                     -sgn * w[..., 0]], dim=-1)
    v = torch.stack([b, sgn + w[..., 1] ** 2 * a, -w[..., 1]], dim=-1)
    return u, v


def to_local(w, vec):
    u, v = onb_frame(w)
    return torch.stack([dot(vec, u), dot(vec, v), dot(vec, w)], dim=-1)


def to_world(w, vec):
    u, v = onb_frame(w)
    return vec[..., 0:1] * u + vec[..., 1:2] * v + vec[..., 2:3] * w


def same_hemisphere(a, b):
    return a[..., 2] * b[..., 2] > 0.0


def reflect_z(wo):
    return torch.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]], dim=-1)


def _safe_div(a, b):
    return torch.where(b == 0.0, 0.0, a / torch.where(b == 0.0, 1.0, b))


def square_to_disk(u):
    ox = 2.0 * u[..., 0] - 1.0
    oy = 2.0 * u[..., 1] - 1.0
    use_x = torch.abs(ox) > torch.abs(oy)
    r = torch.where(use_x, ox, oy)
    theta = torch.where(use_x, PI / 4.0 * _safe_div(oy, ox),
                        PI / 2.0 - PI / 4.0 * _safe_div(ox, oy))
    zero = (ox == 0.0) & (oy == 0.0)
    x = torch.where(zero, 0.0, r * torch.cos(theta))
    y = torch.where(zero, 0.0, r * torch.sin(theta))
    return torch.stack([x, y], dim=-1)


def square_to_cos_hemisphere(u):
    d = square_to_disk(u)
    z = safe_sqrt(1.0 - d[..., 0] ** 2 - d[..., 1] ** 2)
    return torch.cat([d, z[..., None]], dim=-1)


# ---------------------------------------------------------------------------
# the watertight triangle test (Woop et al. 2013)

def _permute_axes(v, kz):
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    px = torch.where(kz == 0, y, torch.where(kz == 1, z, x))
    py = torch.where(kz == 0, z, torch.where(kz == 1, x, y))
    pz = torch.where(kz == 0, x, torch.where(kz == 1, y, z))
    return torch.stack([px, py, pz], dim=-1)


def ray_setup(d):
    ad = torch.abs(d)
    kz = torch.where((ad[..., 0] > ad[..., 1]) & (ad[..., 0] > ad[..., 2]), 0,
                     torch.where(ad[..., 1] > ad[..., 2], 1, 2))
    dp = _permute_axes(d, kz)
    inv_z = 1.0 / dp[..., 2]
    shear = torch.stack([-dp[..., 0] * inv_z, -dp[..., 1] * inv_z, inv_z],
                        dim=-1)
    return kz, shear


def triangle_t(o, kz, shear, a, b, c, t_min, t_max):
    """o (N, 3), kz (N,), shear (N, 3); a, b, c (N|1, T, 3); t_max a
    scalar or (N, 1) -> (t (N, T), INF on a miss; det; (e0, e1, e2))."""
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
    miss_sign = ((torch.minimum(torch.minimum(e0, e1), e2) < 0.0)
                 & (torch.maximum(torch.maximum(e0, e1), e2) > 0.0))
    det = e0 + e1 + e2
    t_scaled = e0 * az + e1 * bz + e2 * cz
    neg = det < 0.0
    out_range = torch.where(
        neg, (t_scaled > t_min * det) | (t_scaled < t_max * det),
        (t_scaled < t_min * det) | (t_scaled > t_max * det))
    ok = ~miss_sign & (det != 0.0) & ~out_range
    t = torch.where(ok, t_scaled / torch.where(det == 0.0, 1.0, det), INF)
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
    abs_det = torch.clamp(torch.abs(det), min=torch.finfo(t.dtype).tiny)
    d_t = 3.0 * (gamma_bound(3) * max_e * max_z + d_e * max_z
                 + d_z * max_e) / abs_det
    t = torch.where(t <= t_min + d_t, INF, t)
    return t, det, (e0, e1, e2)


def triangle_detail(o, d, a, b, c, na, nb, nc):
    """Hit point, normals and error bound on the selected triangle of
    each ray (all (N, ...))."""
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
    err = gamma_bound(7) * (torch.abs(al * a) + torch.abs(be * b)
                            + torch.abs(ga * c))
    return {"p": p, "ng": ng, "ns": ns, "err": err}


def offset_ray_origin(p, err, ng, wi):
    scaled = dot(err, torch.abs(ng))[..., None]
    outside = (dot(wi, ng) >= 0.0)[..., None]
    offset = torch.where(outside, 1.0, -1.0) * scaled * ng
    xi = p + offset
    xs = xi.detach()
    up = torch.nextafter(xs, torch.full_like(xs, INF))
    down = torch.nextafter(xs, torch.full_like(xs, -INF))
    walked = torch.where(offset > 0.0, up, torch.where(offset < 0.0, down, xs))
    return xi + (walked - xs)
