"""The pinhole perspective camera (frozen copy of the parts of
``lumo_tpu_torch/camera.py`` the benchmark's cameras use: no lens)."""
from __future__ import annotations

import numpy as np
import torch

from .geometry import normalize


def _perspective(vfov_deg: float) -> np.ndarray:
    near, far = 1e-2, 1e3
    a = far / (far - near)
    b = -far * near / (far - near)
    proj = np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, a, b], [0, 0, 1, 0]],
                    dtype=np.float64)
    ti = 1.0 / np.tan(np.radians(vfov_deg) / 2.0)
    return np.diag([ti, ti, 1.0, 1.0]) @ proj


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
        smin, smax = np.array([-aspect, -1.0]), np.array([aspect, 1.0])
    else:
        smin, smax = np.array([-1.0, -1.0 / aspect]), np.array([1.0,
                                                              1.0 / aspect])
    d = smax - smin
    m = np.diag([float(w), -float(h), 1.0, 1.0])
    m = m @ np.diag([1.0 / d[0], 1.0 / d[1], 1.0, 1.0])
    t = np.eye(4)
    t[0, 3], t[1, 3] = -smin[0], -smax[1]
    return m @ t @ np.diag([zoom, zoom, zoom, 1.0])


class Camera:
    """A pinhole camera from the configuration's ``camera`` arguments
    (``origin``, ``towards``, ``up``, ``zoom``, ``vfov``) at
    ``resolution`` (w, h)."""

    def __init__(self, args: dict, resolution, device):
        if float(args.get("lens_radius", 0.0)) != 0.0:
            raise ValueError("the reference camera has no lens")
        c2s = _perspective(float(args.get("vfov", 90.0)))
        w2c = _world_to_camera(args.get("origin", (0.0, 0.0, 0.0)),
                               args.get("towards", (0.0, 0.0, -1.0)),
                               args.get("up", (0.0, 1.0, 0.0)))
        s2r = _screen_to_raster(resolution, float(args.get("zoom", 1.0)))
        r2c = np.linalg.inv(s2r @ c2s)
        c2w = np.linalg.inv(w2c)
        f32 = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32,
                                        device=device)
        self.r2c, self.c2w_rot, self.c2w_t = (f32(r2c), f32(c2w[:3, :3]),
                                              f32(c2w[:3, 3]))
        self.resolution = (int(resolution[0]), int(resolution[1]))

    def generate_ray(self, raster_xy):
        """raster (N, 2) -> world rays (o, d)."""
        N = raster_xy.shape[0]
        zeros = torch.zeros((N, 1), dtype=raster_xy.dtype,
                            device=raster_xy.device)
        p = torch.cat([raster_xy, zeros], -1)
        m = self.r2c
        q = p @ m[:3, :3].T + m[:3, 3]
        w = p @ m[3, :3] + m[3, 3]
        p_cam = q / torch.where(w == 0.0, 1.0, w)[..., None]
        xo_local = torch.zeros_like(p_cam)
        wi_local = normalize(p_cam)
        return (xo_local @ self.c2w_rot.T + self.c2w_t,
                normalize(wi_local @ self.c2w_rot.T))
