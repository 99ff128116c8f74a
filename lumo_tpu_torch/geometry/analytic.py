"""Analytic primitives: infinite plane, disk, cone, cylinder and ellipsoid.

Counterpart of ``lumo_tpu/geometry/analytic.py`` (reference
``object/{plane,disk,cone,cylinder}.rs``): each primitive is a local
frame (world->local rows ``rot`` and a translation) with (radius, height)
parameters, and a wavefront of N rays is tested against all A primitives
as dense (N, A) math, the kinds selected by integer tags.

Local-space conventions (world -> local: ``xl = rot @ (x - trans)``):

* PLANE    - the z = 0 plane, normal +z, infinite (``plane.rs:41-121``);
  uv = fract of the world point's projection on the local x/y axes.
* DISK     - z = 0, ``x^2 + y^2 <= r^2`` (``disk.rs:47-121``);
  uv = (xl/r, yl/r).
* CONE     - y axis, base circle of radius r at y = 0, apex at
  y = height (``cone.rs:28-90``).
* CYLINDER - y axis, base at y = 0, top at y = height, radius r
  (``cylinder.rs:28-90``); the hit's x/z are reprojected onto the surface.
* SPHERE   - the unit sphere under a general affine frame, the
  reference's ellipsoid ``Instance<Sphere>`` (``instance.rs:81-105``):
  the direction is not renormalized, so t stays the world parameter.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from lumo_tpu_torch.config import INF, epsilon, gamma_bound
from lumo_tpu_torch.geometry.intersect import _safe_root

PLANE = 0
DISK = 1
CONE = 2
CYLINDER = 3
SPHERE = 4

PI = math.pi


def _to_local(o, d, rot, trans):
    """Rays (N, 3) in the local frames of A primitives: rot (A, 3, 3)
    world->local rows, trans (A, 3) -> ol, dl (N, A, 3)."""
    rel = o[:, None, :] - trans[None, :, :]
    ol = (rot[None] * rel[:, :, None, :]).sum(-1)
    dl = (rot[None] * d[:, None, None, :]).sum(-1)
    return ol, dl


def _stable_quadratic(a, b, c):
    """Numerically stable quadratic roots (lo, hi, ok), the float32
    analogue of the reference's ``EFloat::quadratic``
    (``efloat.rs:68-84``)."""
    disc = b * b - 4.0 * a * c
    ok = (disc >= 0.0) & (torch.abs(a) > 0.0)
    root = _safe_root(disc)
    sgn = torch.where(b >= 0.0, 1.0, -1.0)    # sign(0) must be 1, not 0
    q = -0.5 * (b + sgn * root)
    a_safe = torch.where(a == 0.0, 1.0, a)
    q_safe = torch.where(q == 0.0, 1.0, q)
    t0 = q / a_safe
    t1 = torch.where(q == 0.0, torch.where(disc == 0.0, t0, INF), c / q_safe)
    return torch.minimum(t0, t1), torch.maximum(t0, t1), ok


def analytic_t(o, d, kind, rot, trans, radius, height, t_min, t_max):
    """t-only test of N rays against A analytic primitives.

    o, d (N, 3); kind (A,); rot (A, 3, 3); trans (A, 3); radius, height
    (A,); t_min, t_max scalars or (N, 1).  Returns t (N, A), INF on a
    miss."""
    ol, dl = _to_local(o, d, rot, trans)
    ox, oy, oz = ol[..., 0], ol[..., 1], ol[..., 2]
    dx, dy, dz = dl[..., 0], dl[..., 1], dl[..., 2]
    kindb = kind[None, :]
    r = radius[None, :]
    h = height[None, :]
    is_planar = (kindb == PLANE) | (kindb == DISK)
    is_cone = kindb == CONE

    # plane / disk: t = -oz / dz (``plane.rs:44-66``)
    coplanar = torch.abs(dz) < epsilon()
    t_pl = -oz / torch.where(coplanar, 1.0, dz)
    px = ox + t_pl * dx
    py = oy + t_pl * dy
    in_disk = px * px + py * py <= r * r
    ok_pl = ~coplanar & ((kindb == PLANE) | in_disk)

    # cone / cylinder / sphere quadratic (``cone.rs:37-69``,
    # ``cylinder.rs:40-70``, ``sphere.rs:28-74``)
    is_sph = kindb == SPHERE
    tan2 = torch.where(is_cone, (r / torch.clamp(h, min=1e-30)) ** 2, 0.0)
    oyh = torch.where(is_cone, oy - h, 0.0)
    # sphere lanes add the y^2 terms (|ol + t dl|^2 = r^2)
    sph = is_sph.to(o.dtype)
    qa = dx * dx + dz * dz - tan2 * dy * dy + sph * dy * dy
    qb = 2.0 * (dx * ox + dz * oz - tan2 * dy * oyh + sph * dy * oy)
    qc = ox * ox + oz * oz - tan2 * oyh * oyh + sph * oy * oy \
        - torch.where(is_cone, 0.0, r * r)
    lo, hi, ok_q = _stable_quadratic(qa, qb, qc)
    # both roots against the height clamp (``cone.rs:59-69``); spheres
    # have none
    y_lo = oy + lo * dy
    y_hi = oy + hi * dy
    eps_q = 32.0 * torch.finfo(o.dtype).eps * torch.clamp(
        torch.abs(torch.where(ok_q, hi, 1.0)), min=1.0)
    in_lo = (is_sph | ((y_lo >= 0.0) & (y_lo <= h))) \
        & (lo > t_min + eps_q) & (lo < t_max)
    in_hi = (is_sph | ((y_hi >= 0.0) & (y_hi <= h))) \
        & (hi > t_min + eps_q) & (hi < t_max)
    t_q = torch.where(ok_q & in_lo, lo, torch.where(ok_q & in_hi, hi, INF))

    eps_pl = 32.0 * torch.finfo(o.dtype).eps * torch.clamp(torch.abs(t_pl),
                                                           min=1.0)
    ok_pl = ok_pl & (t_pl > t_min + eps_pl) & (t_pl < t_max)
    return torch.where(is_planar, torch.where(ok_pl, t_pl, INF), t_q)


def _inv3(m):
    """Batched closed-form 3x3 inverse (adjugate / det); m (N, 3, 3)."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d_, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    co = torch.stack([
        torch.stack([e * i - f * h, c * h - b * i, b * f - c * e], -1),
        torch.stack([f * g - d_ * i, a * i - c * g, c * d_ - a * f], -1),
        torch.stack([d_ * h - e * g, b * g - a * h, a * e - b * d_], -1),
    ], -2)
    det = a * (e * i - f * h) - b * (d_ * i - f * g) + c * (d_ * h - e * g)
    det = torch.where(torch.abs(det) < 1e-30, 1.0, det)
    return co / det[..., None, None]


def _mv(m, v):
    """Batched m @ v: (N, 3, 3), (N, 3) -> (N, 3)."""
    return (m * v[:, None, :]).sum(-1)


def _mtv(m, v):
    """Batched m^T @ v."""
    return (m * v[:, :, None]).sum(-2)


def _unit(v):
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                           min=1e-30)


def analytic_detail(o, d, t, kind, rot, trans, radius, height):
    """Shading data of the selected analytic hit per ray.

    o, d (N, 3); t (N,); kind, rot, trans, radius, height gathered per ray
    ((N,), (N, 3, 3), (N, 3), (N,), (N,)).  Returns dict p, ng, ns, uv,
    err."""
    pl = _mv(rot, o - trans) + t[..., None] * _mv(rot, d)
    x, y, z = pl[..., 0], pl[..., 1], pl[..., 2]
    r = torch.clamp(radius, min=1e-30)
    h = torch.clamp(height, min=1e-30)

    # local normals; lanes of the other kinds stay finite, not merely
    # masked, so no NaN reaches a gradient through the selects
    is_cone_s = kind == CONE
    is_cyl_s = kind == CYLINDER
    is_sph_s = kind == SPHERE
    n_planar = torch.zeros_like(pl)
    n_planar[..., 2] = 1.0
    rad_xz = torch.sqrt(torch.clamp(x * x + z * z, min=1e-30))
    tan_th = torch.where(is_cone_s, radius, 0.0) / h
    n_cone = _unit(torch.stack([x, rad_xz * tan_th, z], dim=-1))
    # cylinder: reproject x/z onto the surface (``cylinder.rs:74-82``)
    rr2 = torch.where(is_cyl_s, radius * radius, 1.0) \
        / torch.maximum(x * x + z * z,
                        torch.where(is_cyl_s, 1e-30, 1.0))
    cx, cz = x * rr2, z * rr2
    n_cyl = torch.stack([cx, torch.zeros_like(y), cz], dim=-1) / r[..., None]
    # sphere: reproject onto the local sphere (``sphere.rs:63-64``)
    pl_norm = torch.sqrt(torch.clamp((pl * pl).sum(-1), min=1e-30))
    p_sph = pl * torch.where(is_sph_s, r / pl_norm, 1.0)[..., None]
    n_sph = p_sph / r[..., None]

    is_planar = ((kind == PLANE) | (kind == DISK))[..., None]
    is_cyl = is_cyl_s[..., None]
    is_sph = is_sph_s[..., None]
    nl = torch.where(is_planar, n_planar,
                     torch.where(is_cone_s[..., None], n_cone,
                                 torch.where(is_sph, n_sph, n_cyl)))
    pl_out = torch.where(is_cyl, torch.stack([cx, y, cz], dim=-1),
                         torch.where(is_sph, p_sph, pl))

    # uv (``plane.rs:71-85``, ``disk.rs:85-89``, ``cone.rs:82-85``); the
    # plane's is the fract of the WORLD point's projection, so the
    # anchor's projection is added back
    u_pl = torch.remainder(x + (rot[:, 0, :] * trans).sum(-1), 1.0)
    v_pl = torch.remainder(y + (rot[:, 1, :] * trans).sum(-1), 1.0)
    u_rad = (torch.atan2(-pl_out[..., 2], pl_out[..., 0]) + PI) / (2.0 * PI)
    v_sph = torch.arccos(torch.clamp(-nl[..., 1], -1.0, 1.0)) / PI
    u = torch.where(kind == PLANE, u_pl,
                    torch.where(kind == DISK, x / r, u_rad))
    v = torch.where(kind == PLANE, v_pl,
                    torch.where(kind == DISK, y / r,
                                torch.where(is_sph_s, v_sph, y / h)))
    uv = torch.stack([u, v], dim=-1)

    # back to world: points by rot^-1 (the ellipsoid frame is general
    # affine), normals by rot^T, renormalized
    p = _mv(_inv3(rot), pl_out) + trans
    ng = _unit(_mtv(rot, nl))
    err = gamma_bound(7) * (torch.abs(p) + torch.abs(trans)
                            + torch.abs(t[..., None] * d))
    return {"p": p, "ng": ng, "ns": ng, "uv": uv, "err": err}


def frame_from_normal(n):
    """Host: world->local rows (u, v, n) of a plane or disk with world
    normal n (Duff et al. branchless ONB, float64)."""
    n = np.asarray(n, np.float64)
    n = n / np.linalg.norm(n)
    s = 1.0 if n[2] >= 0.0 else -1.0
    a = -1.0 / (s + n[2])
    b = n[0] * n[1] * a
    u = np.array([1.0 + s * n[0] * n[0] * a, s * b, -s * n[0]])
    v = np.array([b, s + n[1] * n[1] * a, -n[1]])
    return np.stack([u, v, n])


def affine_frame(transform, center=(0, 0, 0), radius=1.0):
    """Host: world->local affine map and translation of a sphere of
    ``radius`` at ``center`` under a general affine ``transform``, an
    ellipsoid (reference ``Instance<Sphere>``, ``instance.rs:81-105``).
    Local space is the unit sphere."""
    m = np.eye(4) if transform is None else np.asarray(transform, np.float64)
    s = np.eye(4)
    s[:3, :3] *= float(radius)
    s[:3, 3] = np.asarray(center, np.float64)
    full = m @ s
    lin = full[:3, :3]
    if abs(np.linalg.det(lin)) < 1e-30:
        raise ValueError("singular ellipsoid transform")
    return np.linalg.inv(lin), full[:3, 3].copy()


def frame_from_transform(transform):
    """Host: a rigid (+ uniform scale) 4x4 as (world->local rows,
    translation, scale); the scale folds into radius and height
    (reference ``instance.rs:202-299``)."""
    if transform is None:
        return np.eye(3), np.zeros(3), 1.0
    m = np.asarray(transform, np.float64)
    a = m[:3, :3]
    scale = float(np.cbrt(abs(np.linalg.det(a))))
    rot_l2w = a / scale
    err = np.abs(rot_l2w @ rot_l2w.T - np.eye(3)).max()
    if err > 1e-6:
        raise ValueError("analytic primitives support rigid + uniform-scale "
                         f"transforms only (orthogonality error {err:.2e})")
    return rot_l2w.T, m[:3, 3].copy(), scale
