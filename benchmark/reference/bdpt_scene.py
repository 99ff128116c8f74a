"""The BDPT reference's scene and camera: the path reference's triangle
tables, lights and exact cluster queries (``scene.py``) over the BDPT
reference's material table (``bdpt_bsdf.py``), points and rays leaving a
light, and the camera's bidirectional side.  Frozen copies of
``lumo_tpu_torch/scene/trace.py``'s ``sample_on``, ``sample_leaving``,
``sample_leaving_pdf`` and ``light_area`` for triangle lights, and of
``lumo_tpu_torch/camera.py``'s inverse raster lookup, lens sampling,
importance and pdfs for a pinhole perspective camera."""
from __future__ import annotations

import numpy as np
import torch

from . import camera as camera_mod
from . import scene as scene_mod
from .bdpt_bsdf import material_row, tables
from .bsdf import LIGHT
from .geometry import (PI, cross, dot, gamma_bound, norm, normalize,
                       square_to_cos_hemisphere, square_to_disk, to_world)


class Scene(scene_mod.Scene):
    """The reference scene of the BDPT configurations (material kinds
    ``diffuse``, ``mirror``, ``glass``, ``light``); ``precision="bf16"``
    holds the float tables in bfloat16 (the control)."""

    def __init__(self, groups, device, precision="float32"):
        rows = [material_row(g["material"]) for g in groups]
        # the path reference's triangle, light and cluster tables: its
        # lights as they are, the other groups under a stand-in material,
        # whose table is replaced below
        blank = {"kind": "lambertian", "kd": [0, 0, 0]}
        super().__init__([g if r["kind"] == LIGHT else {**g,
                                                        "material": blank}
                          for g, r in zip(groups, rows)], device, precision)
        self.materials = tables(rows, self.device, self._store)
        self.kinds = frozenset(r["kind"] for r in rows)


# ---------------------------------------------------------------------------
# lights (``trace.py``)

def light_area(scene: Scene, light):
    a, b, c, _ = scene_mod._light_tri(scene, light)
    return 0.5 * norm(cross(b - a, c - a))


def sample_on(scene: Scene, light, u):
    """Uniform points on the lights (sqrt-warped barycentrics): (p, ng,
    ns, err, mat); the lights have no shading normals, so ns = ng."""
    a, b, c, mat = scene_mod._light_tri(scene, light)
    gamma = 1.0 - torch.sqrt(torch.clamp(1.0 - u[..., 0], min=0.0))
    beta = u[..., 1] * (1.0 - gamma)
    e1 = b - a
    e2 = c - a
    p = a + beta[..., None] * e1 + gamma[..., None] * e2
    ng = normalize(cross(e1, e2))
    err = gamma_bound(6) * (torch.abs(a) + torch.abs(beta[..., None] * e1)
                            + torch.abs(gamma[..., None] * e2))
    return p, ng, ng, err, mat


def sample_leaving(scene: Scene, light, u0, u1):
    """A ray leaving a light: a point and a cosine-weighted direction
    about its normal: (p, d, ng, ns, err, mat)."""
    p, ng, ns, err, mat = sample_on(scene, light, u0)
    d = to_world(ns, square_to_cos_hemisphere(u1))
    return p, normalize(d), ng, ns, err, mat


def sample_leaving_pdf(scene: Scene, light, d, ng):
    """(pdf_origin, pdf_dir) of :func:`sample_leaving`."""
    pdf_origin = 1.0 / torch.clamp(light_area(scene, light), min=1e-30)
    return pdf_origin, dot(ng, d) / PI


# ---------------------------------------------------------------------------
# the camera's bidirectional side (``camera.py``)

_TINY = 1e-30


def _project(m, p):
    q = p @ m[:3, :3].T + m[:3, 3]
    w = p @ m[3, :3].T + m[3, 3]
    return q / w[..., None]


class Camera(camera_mod.Camera):
    """The pinhole camera with its inverse lookup, lens sampling,
    importance and pdfs (a lens of radius 0)."""

    def __init__(self, args: dict, resolution, device):
        super().__init__(args, resolution, device)
        c2s = camera_mod._perspective(float(args.get("vfov", 90.0)))
        s2r = camera_mod._screen_to_raster(resolution,
                                           float(args.get("zoom", 1.0)))
        w, h = self.resolution
        corner = lambda x, y: _project(np.linalg.inv(c2s), _project(
            np.linalg.inv(s2r), np.array([[x, y, 0.0]])))[0]
        p_min, p_max = corner(0.0, 0.0), corner(float(w), float(h))
        p_min2 = p_min[:2] / (p_min[2] if p_min[2] != 0.0 else 1.0)
        p_max2 = p_max[:2] / (p_max[2] if p_max[2] != 0.0 else 1.0)
        extent = p_max2 - p_min2
        f32 = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32,
                                        device=device)
        self.c2r = f32(s2r @ c2s)
        self.image_plane_area = f32(abs(extent[0] * extent[1]))
        self.lens_radius = f32(0.0)

    def _apply4(self, m, p):
        q = p @ m[:3, :3].T + m[:3, 3]
        w = p @ m[3, :3] + m[3, 3]
        return q / torch.where(w == 0.0, 1.0, w)[..., None]

    def _local_pt(self, p):
        return (p - self.c2w_t) @ self.c2w_rot

    def lens_area(self):
        return torch.where(self.lens_radius == 0.0, 1.0,
                           PI * self.lens_radius ** 2)

    def _lens(self, u):
        lens_xy = self.lens_radius * square_to_disk(u)
        return torch.cat([lens_xy, torch.zeros_like(lens_xy[..., :1])], -1)

    def raster_xy(self, o, d):
        """Raster coordinates (N, 2) of the ray (o, d) and whether they
        fall on the film."""
        w, h = self.resolution
        wi_local = d @ self.c2w_rot
        cos = wi_local[..., 2]
        fl = torch.where(self.lens_radius == 0.0, 1.0, 0.0) \
            / torch.clamp(cos, min=_TINY)
        focus = self._local_pt(o) + wi_local * fl[..., None]
        r = self._apply4(self.c2r, focus)[..., :2]
        r = torch.where(cos[..., None] > 0.0, r, -torch.ones_like(r))
        ok = ((r[..., 0] >= 0.0) & (r[..., 0] < w)
              & (r[..., 1] >= 0.0) & (r[..., 1] < h))
        return r, ok

    def sample_towards(self, xi, u):
        """A lens point and the ray from it towards the points xi: (o, d,
        ok)."""
        lens = self._lens(u)
        xi_local = self._local_pt(xi)
        o = lens @ self.c2w_rot.T + self.c2w_t
        d = normalize(normalize(xi_local - lens) @ self.c2w_rot.T)
        return o, d, self.raster_xy(o, d)[1]

    def pdf_importance(self, o, d, xi):
        _, ok = self.raster_xy(o, d)
        ng = torch.tensor([0.0, 0.0, 1.0], dtype=o.dtype,
                          device=o.device) @ self.c2w_rot.T
        rel = xi - o
        pdf = dot(rel, rel) / torch.clamp(
            torch.abs(dot(ng, d)) * self.lens_area(), min=_TINY)
        return torch.where(ok, torch.clamp(pdf, min=0.0), 0.0)

    def sample_importance(self, o, d):
        """(importance (N,), raster (N, 2), ok)."""
        r, ok = self.raster_xy(o, d)
        cos = torch.clamp((d @ self.c2w_rot)[..., 2], min=_TINY)
        imp = 1.0 / (self.image_plane_area * cos ** 4 * self.lens_area())
        return torch.where(ok, imp, 0.0), r, ok

    def pdf_xo(self, o):
        xo_local = self._local_pt(o)
        on_lens = dot(xo_local, xo_local) < (self.lens_radius + 1e-6) ** 2
        return torch.where(on_lens, 1.0 / self.lens_area(), 0.0)

    def pdf_wi(self, o, d):
        _, ok = self.raster_xy(o, d)
        cos = (d @ self.c2w_rot)[..., 2]
        pdf = 1.0 / torch.clamp(self.image_plane_area * cos ** 3, min=_TINY)
        return torch.where(ok & (cos > 0.0), pdf, 0.0)
