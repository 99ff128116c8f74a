"""Orthonormal bases and shading-space helpers over (N, 3) wavefronts.

Counterpart of ``lumo_tpu/geometry/onb.py`` (reference ``onb.rs``, Duff et
al. 2017 branchless ONB).  Three-component sums are written out in a fixed
order so the CPU and the card round alike.
"""
from __future__ import annotations

import torch

_F32_TINY = float(torch.finfo(torch.float32).tiny)


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
    return v / torch.clamp(n, min=eps if eps else _F32_TINY)


def onb_frame(w):
    """Duff et al. 2017 branchless ONB from unit normal w (..., 3) ->
    (u, v) tangent vectors."""
    z = w[..., 2]
    sgn = torch.where(z >= 0.0, 1.0, -1.0)
    a = -1.0 / (sgn + z)
    b = w[..., 0] * w[..., 1] * a
    u = torch.stack([1.0 + sgn * w[..., 0] ** 2 * a, sgn * b, -sgn * w[..., 0]],
                    dim=-1)
    v = torch.stack([b, sgn + w[..., 1] ** 2 * a, -w[..., 1]], dim=-1)
    return u, v


def to_local(w, vec):
    """World direction -> shading space with normal w as +z."""
    u, v = onb_frame(w)
    return torch.stack([dot(vec, u), dot(vec, v), dot(vec, w)], dim=-1)


def to_world(w, vec):
    u, v = onb_frame(w)
    return vec[..., 0:1] * u + vec[..., 1:2] * v + vec[..., 2:3] * w


def cos_theta(w):
    return w[..., 2]


def same_hemisphere(a, b):
    return cos_theta(a) * cos_theta(b) > 0.0


def reflect_z(wo):
    """Mirror reflection about +z."""
    return torch.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]], dim=-1)
