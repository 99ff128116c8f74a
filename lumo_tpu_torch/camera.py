"""Perspective and orthographic cameras with thin-lens depth of field.

Counterpart of ``lumo_tpu/camera.py`` (reference ``camera*``): matrices
are baked on the host in float64 numpy; ray generation and the
bidirectional queries of the BDPT integrator (inverse raster lookup, lens
sampling towards a point, importance and its pdfs) run over wavefronts.

Every field but ``kind`` and ``resolution`` is a tensor, so ``c2w_t``,
``c2w_rot``, ``lens_radius`` and ``focal_length`` can be differentiated
(``dataclasses.replace`` with leaves that require grad); ``generate_ray``
computes the pinhole and the thin-lens rays and selects with
``torch.where``, as the JAX camera does.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from lumo_tpu_torch.config import resolve_device
from lumo_tpu_torch.geometry.onb import dot, normalize
from lumo_tpu_torch.sampling import maps

PERSPECTIVE = 0
ORTHOGRAPHIC = 1

_TINY = 1e-30
PI = math.pi


def _perspective_matrix(vfov_deg: float) -> np.ndarray:
    near, far = 1e-2, 1e3
    a = far / (far - near)
    b = -far * near / (far - near)
    proj = np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, a, b], [0, 0, 1, 0]],
                    dtype=np.float64)
    ti = 1.0 / np.tan(np.radians(vfov_deg) / 2.0)
    scale = np.diag([ti, ti, 1.0, 1.0])
    return scale @ proj


def _orthographic_matrix() -> np.ndarray:
    return np.diag([1.0, 1.0, 1.0, 1.0])


def _world_to_camera(origin, towards, up) -> np.ndarray:
    origin = np.asarray(origin, np.float64)
    forward = np.asarray(towards, np.float64) - origin
    forward /= np.linalg.norm(forward)
    right = np.cross(forward, np.asarray(up, np.float64))
    right /= np.linalg.norm(right)
    up2 = np.cross(right, forward)
    m = np.eye(4)
    m[0, :3], m[1, :3], m[2, :3] = right, up2, forward
    m[:3, 3] = -(m[:3, :3] @ origin)
    return m


def _screen_to_raster(resolution, zoom) -> np.ndarray:
    w, h = resolution
    aspect = w / h
    if aspect > 1.0:
        smin = np.array([-aspect, -1.0])
        smax = np.array([aspect, 1.0])
    else:
        smin = np.array([-1.0, -1.0 / aspect])
        smax = np.array([1.0, 1.0 / aspect])
    d = smax - smin
    m = np.diag([float(w), -float(h), 1.0, 1.0])
    m = m @ np.diag([1.0 / d[0], 1.0 / d[1], 1.0, 1.0])
    t = np.eye(4)
    t[0, 3], t[1, 3] = -smin[0], -smax[1]
    m = m @ t
    return m @ np.diag([zoom, zoom, zoom, 1.0])


def _project(m, p):
    """A 4x4 applied to (..., 3) points with the projective division
    (numpy)."""
    q = p @ m[:3, :3].T + m[:3, 3]
    w = p @ m[3, :3].T + m[3, 3]
    return q / w[..., None]


@dataclasses.dataclass(frozen=True)
class Camera:
    r2c: torch.Tensor            # (4, 4) raster -> camera (projective)
    c2r: torch.Tensor            # (4, 4) camera -> raster
    c2w_rot: torch.Tensor        # (3, 3) camera -> world rotation
    c2w_t: torch.Tensor          # (3,) camera origin in world
    lens_radius: torch.Tensor    # () thin-lens radius, 0 for a pinhole
    focal_length: torch.Tensor   # () focus distance of the thin lens
    image_plane_area: torch.Tensor  # () image plane area in camera space
    kind: int
    resolution: tuple

    def _apply4(self, m, p):
        q = p @ m[:3, :3].T + m[:3, 3]
        w = p @ m[3, :3] + m[3, 3]
        return q / torch.where(w == 0.0, 1.0, w)[..., None]

    def to_world_dir(self, v):
        return v @ self.c2w_rot.T

    def to_local_dir(self, v):
        return v @ self.c2w_rot

    def to_world_pt(self, p):
        return p @ self.c2w_rot.T + self.c2w_t

    def to_local_pt(self, p):
        return (p - self.c2w_t) @ self.c2w_rot

    def generate_ray(self, raster_xy, u_dof):
        """raster (N, 2) + lens uniforms (N, 2) -> (o, d) world rays
        (reference ``camera.rs:221-268``)."""
        N = raster_xy.shape[0]
        zeros = torch.zeros((N, 1), dtype=raster_xy.dtype,
                            device=raster_xy.device)
        p_cam = self._apply4(self.r2c, torch.cat([raster_xy, zeros], -1))
        if self.kind == PERSPECTIVE:
            xo_local = torch.zeros_like(p_cam)
            wi_local = normalize(p_cam)
        else:
            xo_local = p_cam
            wi_local = torch.zeros_like(p_cam)
            wi_local[:, 2] = 1.0
        # thin-lens depth of field (reference ``camera.rs:221-243``), both
        # branches computed so that lens_radius stays differentiable
        lens = self._lens(u_dof)
        focus_dist = self.focal_length / torch.clamp(wi_local[..., 2:3],
                                                     min=_TINY)
        use_dof = self.lens_radius > 0.0
        xo_local = torch.where(use_dof, xo_local + lens, xo_local)
        wi_local = torch.where(use_dof, focus_dist * wi_local - lens,
                               wi_local)
        return self.to_world_pt(xo_local), normalize(
            self.to_world_dir(wi_local))

    # ---- bidirectional side (reference ``camera.rs:271-388``) ----

    def _lens(self, u):
        """Lens points (N, 3) in camera space from uniforms u (N, 2)."""
        lens_xy = self.lens_radius * maps.square_to_disk(u)
        return torch.cat([lens_xy, torch.zeros_like(lens_xy[..., :1])], -1)

    def raster_xy(self, o, d):
        """Inverse lookup of the ray (o, d): raster coordinates (N, 2) and
        whether they fall on the film (reference ``camera.rs:174-213``)."""
        w, h = self.resolution
        if self.kind == ORTHOGRAPHIC:
            r = self._apply4(self.c2r, self.to_local_pt(o))[..., :2]
        else:
            wi_local = self.to_local_dir(d)
            cos = wi_local[..., 2]
            fl = torch.where(self.lens_radius == 0.0, 1.0, self.focal_length) \
                / torch.clamp(cos, min=_TINY)
            focus = self.to_local_pt(o) + wi_local * fl[..., None]
            r = self._apply4(self.c2r, focus)[..., :2]
            r = torch.where(cos[..., None] > 0.0, r, -torch.ones_like(r))
        ok = ((r[..., 0] >= 0.0) & (r[..., 0] < w)
              & (r[..., 1] >= 0.0) & (r[..., 1] < h))
        return r, ok

    def lens_area(self):
        return torch.where(self.lens_radius == 0.0, 1.0,
                           PI * self.lens_radius ** 2)

    def sample_towards(self, xi, u):
        """A lens point and the ray from it towards world points xi (N, 3)
        (reference ``camera.rs:271-295``): (o, d, ok)."""
        lens = self._lens(u)
        xi_local = self.to_local_pt(xi)
        if self.kind == ORTHOGRAPHIC:
            xo_local = xi_local * torch.tensor([1.0, 1.0, 0.0],
                                               dtype=xi.dtype,
                                               device=xi.device)
            o = self.to_world_pt(xo_local + lens)
            d = normalize(xi - o)
        else:
            o = self.to_world_pt(lens)
            d = normalize(self.to_world_dir(normalize(xi_local - lens)))
        return o, d, self.raster_xy(o, d)[1]

    def pdf_importance(self, o, d, xi):
        """Solid-angle pdf of importance arriving at xi along (o, d)
        (reference ``camera.rs:343-366``)."""
        _, ok = self.raster_xy(o, d)
        ng = self.to_world_dir(torch.tensor([0.0, 0.0, 1.0], dtype=o.dtype,
                                            device=o.device))
        rel = xi - o
        pdf = dot(rel, rel) / torch.clamp(
            torch.abs(dot(ng, d)) * self.lens_area(), min=_TINY)
        return torch.where(ok, torch.clamp(pdf, min=0.0), 0.0)

    def sample_importance(self, o, d):
        """Incident importance W_e of lens rays (reference
        ``camera.rs:369-388``): (importance (N,), raster (N, 2), ok)."""
        r, ok = self.raster_xy(o, d)
        if self.kind == ORTHOGRAPHIC:
            imp = torch.ones_like(o[..., 0]) / self.image_plane_area
        else:
            cos = torch.clamp(self.to_local_dir(d)[..., 2], min=_TINY)
            imp = 1.0 / (self.image_plane_area * cos ** 4 * self.lens_area())
        return torch.where(ok, imp, 0.0), r, ok

    def pdf_xo(self, o):
        """Area pdf of the lens point o (reference ``camera.rs:298-321``)."""
        if self.kind == ORTHOGRAPHIC:
            return torch.ones_like(o[..., 0]) / self.image_plane_area
        xo_local = self.to_local_pt(o)
        on_lens = dot(xo_local, xo_local) < (self.lens_radius + 1e-6) ** 2
        return torch.where(on_lens, 1.0 / self.lens_area(), 0.0)

    def pdf_wi(self, o, d):
        """Solid-angle pdf of the direction d from o (reference
        ``camera.rs:324-341``)."""
        _, ok = self.raster_xy(o, d)
        cos = self.to_local_dir(d)[..., 2]
        if self.kind == ORTHOGRAPHIC:
            return torch.where(1.0 - cos < 1e-6, 1.0, 0.0)
        pdf = 1.0 / torch.clamp(self.image_plane_area * cos ** 3, min=_TINY)
        return torch.where(ok & (cos > 0.0), pdf, 0.0)


def build_camera(origin=(0.0, 0.0, 0.0), towards=(0.0, 0.0, -1.0),
                 up=(0.0, 1.0, 0.0), zoom=1.0, lens_radius=0.0,
                 focal_length=0.0, resolution=(1024, 768), vfov=90.0,
                 kind=PERSPECTIVE, dtype=torch.float32, device=None) -> Camera:
    """Fluent-equivalent of the reference ``CameraBuilder`` defaults
    (``camera/builder.rs:33-56``); every tensor field in ``dtype``.
    ``device`` defaults to the card."""
    device = resolve_device(device)
    c2s = _perspective_matrix(vfov) if kind == PERSPECTIVE else _orthographic_matrix()
    w2c = _world_to_camera(origin, towards, up)
    s2r = _screen_to_raster(resolution, zoom)
    c2r = s2r @ c2s
    r2c = np.linalg.inv(c2r)
    c2w = np.linalg.inv(w2c)
    # image plane area in camera space (reference ``camera.rs:56-77``)
    w, h = resolution
    corner = lambda x, y: _project(np.linalg.inv(c2s), _project(
        np.linalg.inv(s2r), np.array([[x, y, 0.0]])))[0]
    p_min, p_max = corner(0.0, 0.0), corner(float(w), float(h))
    p_min2 = p_min[:2] / (p_min[2] if p_min[2] != 0.0 else 1.0)
    p_max2 = p_max[:2] / (p_max[2] if p_max[2] != 0.0 else 1.0)
    extent = p_max2 - p_min2
    jf = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
    return Camera(r2c=jf(r2c), c2r=jf(c2r), c2w_rot=jf(c2w[:3, :3]),
                  c2w_t=jf(c2w[:3, 3]), lens_radius=jf(lens_radius),
                  focal_length=jf(focal_length),
                  image_plane_area=jf(abs(extent[0] * extent[1])),
                  kind=kind, resolution=(int(w), int(h)))


def cornell_camera(resolution=(512, 512), dtype=torch.float32,
                   device=None) -> Camera:
    """The Cornell-box camera (reference ``camera.rs:139-148``).
    ``device`` defaults to the card."""
    return build_camera(origin=(278.0, 273.0, -800.0),
                        towards=(278.0, 273.0, 0.0), zoom=2.8,
                        focal_length=0.035, resolution=resolution,
                        dtype=dtype, device=device)
