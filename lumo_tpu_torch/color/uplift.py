"""Spectral uplift: RGB -> sigmoid-polynomial reflectance spectra.

Counterpart of ``lumo_tpu/color/uplift.py`` (Jakob & Hanika 2019).  The
port reads the fitted table its package carries, a byte copy of the JAX
package's ``uplift_srgb_64.npz``; the Gauss-Newton fit that produced it
is not repeated here.

A spectrum is (c0, c1, c2, scale): s(lambda) = scale * S(c0 x^2 + c1 x +
c2) with S(t) = 1/2 + t / (2 sqrt(1 + t^2)) and x = (lambda - 360) / 470.
"""
from __future__ import annotations

import os
from functools import lru_cache

import numpy as np
import torch

from lumo_tpu_torch.color import dense, space
from lumo_tpu_torch.config import LAMBDA_MAX, LAMBDA_MIN

RES = 64  # table resolution per axis
_DATA = os.path.join(os.path.dirname(__file__), "data", f"uplift_srgb_{RES}.npz")

_X_SCALE = 1.0 / (LAMBDA_MAX - LAMBDA_MIN)


@lru_cache(maxsize=1)
def table() -> dict:
    """The fitted uplift table: {'coeffs': (3, RES, RES, RES, 3),
    'scale': (RES,)} - axes [maxc, z, y, x]."""
    with np.load(_DATA) as d:
        return {"coeffs": d["coeffs"], "scale": d["scale"]}


def from_rgb(rgb) -> np.ndarray:
    """Linear RGB (..., 3) -> spectrum coefficients (..., 4) (host;
    trilinear table lookup, reference ``spectrum.rs:49-74``)."""
    rgb = np.atleast_2d(np.asarray(rgb, dtype=np.float64))
    shape = rgb.shape
    rgb = rgb.reshape(-1, 3)
    t = table()
    coeffs_t = t["coeffs"].astype(np.float64)
    scale_nodes = t["scale"].astype(np.float64)

    maxc = np.argmax(rgb, axis=-1)
    mx = rgb[np.arange(len(rgb)), maxc]
    black = mx <= 0.0
    mx_safe = np.where(black, 1.0, mx)

    # HDR values fold brightness > 1 into the scale term
    # (reference ``spectrum.rs:55-59`` uses 2*max)
    scale_mult = np.where(mx > 1.0, 2.0 * mx, 1.0)
    xn = rgb[np.arange(len(rgb)), (maxc + 1) % 3] / mx_safe
    yn = rgb[np.arange(len(rgb)), (maxc + 2) % 3] / mx_safe
    zn = np.clip(mx / scale_mult, 0.0, 1.0)

    x = np.clip(xn, 0.0, 1.0) * (RES - 1)
    y = np.clip(yn, 0.0, 1.0) * (RES - 1)
    xi = np.minimum(x.astype(np.int64), RES - 2)
    yi = np.minimum(y.astype(np.int64), RES - 2)
    zi = np.clip(np.searchsorted(scale_nodes, zn, side="right") - 1, 0, RES - 2)
    x1 = x - xi
    y1 = y - yi
    dz = scale_nodes[zi + 1] - scale_nodes[zi]
    z1 = np.where(dz > 0, (zn - scale_nodes[zi]) / np.where(dz > 0, dz, 1.0), 0.0)

    out = np.zeros((len(rgb), 3))
    for dzi in (0, 1):
        for dyi in (0, 1):
            for dxi in (0, 1):
                w = (np.where(dzi, z1, 1 - z1)
                     * np.where(dyi, y1, 1 - y1)
                     * np.where(dxi, x1, 1 - x1))
                out += w[:, None] * coeffs_t[maxc, zi + dzi, yi + dyi, xi + dxi]

    res = np.concatenate([out, scale_mult[:, None]], axis=-1)
    res[black] = 0.0
    return res.reshape(shape[:-1] + (4,))


def sample(coeffs, lam):
    """Device side: coefficients (..., 4) at wavelengths ``lam`` (...) ->
    values (...).  lambda == 0 (terminated) yields 0."""
    x = (lam - LAMBDA_MIN) * _X_SCALE
    t = coeffs[..., 0] * x * x + coeffs[..., 1] * x + coeffs[..., 2]
    s = 0.5 + t / (2.0 * torch.sqrt(1.0 + t * t))
    return torch.where(lam == 0.0, 0.0, coeffs[..., 3] * s)


def from_srgb8(r, g, b) -> np.ndarray:
    """8-bit sRGB -> spectrum coefficients (reference ``spectrum.rs:39-43``)."""
    u = np.array([r, g, b], dtype=np.float64) / 255.0
    lin = np.where(u <= 0.04045, u / 12.92, np.power((u + 0.055) / 1.055, 2.4))
    return from_rgb(lin)


def from_points(pts: str) -> np.ndarray:
    """Parse "lambda:v lambda:v ..." -> dense spectrum -> XYZ -> sRGB ->
    coefficients (reference ``spectrum.rs:81-100``)."""
    pairs = []
    for tok in pts.split():
        lam_s, v_s = tok.split(":")
        pairs.append((float(lam_s), float(v_s)))
    pairs.sort()
    ds = dense.from_points([p[0] for p in pairs], [p[1] for p in pairs])
    xyz = dense.to_xyz(ds)
    rgb = space.get("sRGB").xyz_to_rgb @ xyz
    return from_rgb(rgb)
