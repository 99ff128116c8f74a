"""Color spaces, XYZ conversion, Von Kries white balance.

Counterpart of ``lumo_tpu/color/space.py`` (reference
``color/{space,xyz}.rs``).  Matrices are built on the host in float64
numpy; the spectral -> XYZ/RGB conversion runs over whole wavefronts.
Four-sample means are summed left to right, as the JAX reduction does.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from lumo_tpu_torch.color import dense, wavelength


def from_xyY(xy, Y=1.0) -> np.ndarray:
    x, y = float(xy[0]), float(xy[1])
    if y == 0.0:
        return np.zeros(3)
    return np.array([x * Y / y, Y, (1.0 - x - y) * Y / y])


def to_xyY(xyz) -> np.ndarray:
    s = float(xyz[0] + xyz[1] + xyz[2])
    return np.array([xyz[0] / s, xyz[1] / s])


# Stockman & Sharpe 2000 XYZ<->LMS (reference ``space.rs:117-127``)
XYZ_TO_LMS = np.array([
    [0.210576, 0.855098, -0.0396983],
    [-0.417076, 1.177260, 0.0786283],
    [0.0, 0.0, 0.5168350],
])
LMS_TO_XYZ = np.linalg.inv(XYZ_TO_LMS)


def _xyz_to_rgb_matrix(r_xy, g_xy, b_xy, W) -> np.ndarray:
    """RGB primaries + white point -> XYZ->RGB matrix
    (reference ``space.rs:162-177``)."""
    R, G, B = from_xyY(r_xy), from_xyY(g_xy), from_xyY(b_xy)
    RGB_c = np.stack([R, G, B], axis=-1)
    C = np.linalg.solve(RGB_c, W)
    return np.linalg.inv(RGB_c @ np.diag(C))


class ColorSpace:
    """A named RGB color space: XYZ->RGB matrix and white point."""

    def __init__(self, name, xyz_to_rgb, white):
        self.name = name
        self.xyz_to_rgb = xyz_to_rgb
        self.white = white

    def wb_matrix(self, illuminant: np.ndarray) -> np.ndarray:
        """Von Kries chromatic adaptation in LMS for a camera
        ``illuminant`` dense spectrum (reference ``space.rs:143-151``)."""
        illum_xy = to_xyY(dense.to_xyz(illuminant))
        diag = (XYZ_TO_LMS @ self.white) / (XYZ_TO_LMS @ from_xyY(illum_xy))
        return LMS_TO_XYZ @ np.diag(diag) @ XYZ_TO_LMS


@lru_cache(maxsize=None)
def get(name: str = "DCI-P3") -> ColorSpace:
    W = from_xyY(to_xyY(dense.to_xyz(dense.table("D65"))))
    primaries = {"sRGB": ((0.64, 0.33), (0.3, 0.6), (0.15, 0.06)),
                 "DCI-P3": ((0.68, 0.32), (0.265, 0.69), (0.15, 0.06)),
                 "Rec2020": ((0.708, 0.292), (0.170, 0.797), (0.131, 0.046))}
    if name not in primaries:
        raise ValueError(name)
    return ColorSpace(name, _xyz_to_rgb_matrix(*primaries[name], W), W)


def _mean4(x):
    return (((x[..., 0] + x[..., 1]) + x[..., 2]) + x[..., 3]) / 4.0


def _weighted(color, lam):
    """color / pdf(lam), zero where the pdf is zero (lambda outside the
    visible range after float32 rounding)."""
    p = wavelength.pdf(lam)
    ok = p > 0.0
    return torch.where(ok, color / torch.where(ok, p, 1.0), 0.0)


def luminance(color, lam):
    """Color (..., 4) at wavelengths (..., 4) -> luminance (...)
    (reference ``color.rs:91-95``)."""
    p = wavelength.pdf(lam)
    y = dense.sample(dense.device_table("Y", lam.device), lam)
    ok = p > 0.0
    contrib = torch.where(ok, y * color / torch.where(ok, p, 1.0), 0.0)
    return _mean4(contrib) / dense.Y_INTEGRAL


def to_xyz(color, lam):
    """Color (..., 4) sampled at lambda (..., 4) -> XYZ (..., 3)
    (reference ``color.rs:98-107``)."""
    w = _weighted(color, lam)
    out = torch.stack([_mean4(dense.sample(dense.device_table(k, lam.device), lam) * w)
                       for k in ("X", "Y", "Z")], dim=-1)
    return out / dense.Y_INTEGRAL


def to_rgb(color, lam, xyz_to_rgb_wb):
    """Spectral color -> linear RGB through a fused (XYZ->RGB)(WB) matrix."""
    xyz = to_xyz(color, lam)
    m = torch.as_tensor(xyz_to_rgb_wb, dtype=color.dtype, device=color.device)
    return xyz @ m.T
