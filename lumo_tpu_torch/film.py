"""Film: spectral samples to linear RGB.

Counterpart of the conversion half of ``lumo_tpu/film.py`` (reference
``film/tile.rs:65-111``): XYZ, then white balance, then RGB, at sample
time.  Filtered accumulation, tone mapping and PNG output come with the
Renderer slice.
"""
from __future__ import annotations

import numpy as np

from lumo_tpu_torch.color import dense, space


def spectral_to_rgb(color4, lam, xyz_to_rgb_wb):
    """Spectral sample (N, 4) at wavelengths (N, 4) -> linear RGB (N, 3)."""
    return space.to_rgb(color4, lam, xyz_to_rgb_wb)


def wb_matrix(colorspace: str, illuminant) -> np.ndarray:
    """Fused (XYZ->RGB)(Von Kries WB) matrix for the film."""
    cs = space.get(colorspace)
    illum = dense.table(illuminant) if isinstance(illuminant, str) else illuminant
    return cs.xyz_to_rgb @ cs.wb_matrix(illum)
