"""Warps from the unit square to disks, hemispheres and the sphere.

Counterpart of ``lumo_tpu/sampling/maps.py`` (reference ``maps.rs``);
u is (..., 2)."""
from __future__ import annotations

import math

import torch

from lumo_tpu_torch.geometry.onb import safe_sqrt

PI = math.pi


def _safe_div(a, b):
    return torch.where(b == 0.0, 0.0, a / torch.where(b == 0.0, 1.0, b))


def square_to_disk(u):
    """Shirley-Chiu concentric square -> disk (reference ``maps.rs:4-26``)."""
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
    """Malley's method: concentric disk lifted to the z+ hemisphere
    (reference ``maps.rs:30-37``)."""
    d = square_to_disk(u)
    z = safe_sqrt(1.0 - d[..., 0] ** 2 - d[..., 1] ** 2)
    return torch.cat([d, z[..., None]], dim=-1)


def square_to_sphere(u):
    """Uniform point on the unit sphere (reference ``maps.rs``)."""
    z = 1.0 - 2.0 * u[..., 0]
    r = safe_sqrt(1.0 - z * z)
    phi = 2.0 * PI * u[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def square_to_hemisphere(u):
    """Uniform direction on the z+ hemisphere."""
    z = u[..., 0]
    r = safe_sqrt(1.0 - z * z)
    phi = 2.0 * PI * u[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)
