"""Perspective and orthographic cameras with thin-lens depth of field.

Counterpart of ``lumo_tpu/camera.py`` (reference ``camera*``), forward
ray generation only: matrices are baked on the host in float64 numpy and
``generate_ray`` runs over raster-coordinate wavefronts.  The
bidirectional importance/pdf queries come with the BDPT slice.

Every field but ``kind`` and ``resolution`` is a tensor, so ``c2w_t``,
``c2w_rot``, ``lens_radius`` and ``focal_length`` can be differentiated
(``dataclasses.replace`` with leaves that require grad); ``generate_ray``
computes the pinhole and the thin-lens rays and selects with
``torch.where``, as the JAX camera does.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lumo_tpu_torch.config import resolve_device
from lumo_tpu_torch.geometry.onb import normalize
from lumo_tpu_torch.sampling import maps

PERSPECTIVE = 0
ORTHOGRAPHIC = 1

_TINY = 1e-30


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


@dataclasses.dataclass(frozen=True)
class Camera:
    r2c: torch.Tensor            # (4, 4) raster -> camera (projective)
    c2w_rot: torch.Tensor        # (3, 3) camera -> world rotation
    c2w_t: torch.Tensor          # (3,) camera origin in world
    lens_radius: torch.Tensor    # () thin-lens radius, 0 for a pinhole
    focal_length: torch.Tensor   # () focus distance of the thin lens
    kind: int
    resolution: tuple

    def _apply4(self, m, p):
        q = p @ m[:3, :3].T + m[:3, 3]
        w = p @ m[3, :3] + m[3, 3]
        return q / torch.where(w == 0.0, 1.0, w)[..., None]

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
        lens_xy = self.lens_radius * maps.square_to_disk(u_dof)
        lens = torch.cat([lens_xy, zeros], -1)
        focus_dist = self.focal_length / torch.clamp(wi_local[..., 2:3],
                                                     min=_TINY)
        use_dof = self.lens_radius > 0.0
        xo_local = torch.where(use_dof, xo_local + lens, xo_local)
        wi_local = torch.where(use_dof, focus_dist * wi_local - lens,
                               wi_local)
        o = xo_local @ self.c2w_rot.T + self.c2w_t
        d = normalize(wi_local @ self.c2w_rot.T)
        return o, d


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
    r2c = np.linalg.inv(s2r @ c2s)
    c2w = np.linalg.inv(w2c)
    jf = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
    w, h = resolution
    return Camera(r2c=jf(r2c), c2w_rot=jf(c2w[:3, :3]), c2w_t=jf(c2w[:3, 3]),
                  lens_radius=jf(lens_radius), focal_length=jf(focal_length),
                  kind=kind, resolution=(int(w), int(h)))


def cornell_camera(resolution=(512, 512), dtype=torch.float32,
                   device=None) -> Camera:
    """The Cornell-box camera (reference ``camera.rs:139-148``).
    ``device`` defaults to the card."""
    return build_camera(origin=(278.0, 273.0, -800.0),
                        towards=(278.0, 273.0, 0.0), zoom=2.8,
                        focal_length=0.035, resolution=resolution,
                        dtype=dtype, device=device)
