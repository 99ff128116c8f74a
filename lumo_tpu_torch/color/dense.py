"""Densely sampled spectra (95 samples, 5nm steps over [360, 830] nm).

Counterpart of ``lumo_tpu/color/dense.py`` (reference
``dense_spectrum.rs``).  Host-side tables and resampling are numpy; the
device-side lookup at hero wavelengths is a linear interpolation between
the two neighbouring bins, which is what the JAX package's hat-basis
contraction computes (its other 93 terms are exact zeros).
"""
from __future__ import annotations

import os
from functools import lru_cache

import numpy as np
import torch

from lumo_tpu_torch.config import DENSE_SAMPLES, LAMBDA_MAX, LAMBDA_MIN

STEP = (LAMBDA_MAX - LAMBDA_MIN) / (DENSE_SAMPLES - 1)  # = 5nm

_DATA = os.path.join(os.path.dirname(__file__), "data", "spectra.npz")

# Integral of the CIE 1931 Y curve (reference ``color/xyz.rs:33``).
Y_INTEGRAL = 106.856895


@lru_cache(maxsize=1)
def _tables() -> dict:
    with np.load(_DATA) as d:
        return {k: d[k].astype(np.float64) for k in d.files}


def table(name: str) -> np.ndarray:
    """Named public data spectrum (95,) float64: CIE 1931 'X','Y','Z',
    illuminants 'A','D50','D65','F2','F7','CORNELL', materials
    'diamond_eta','glass_eta','mirror_eta','mirror_k'."""
    return _tables()[name]


def from_points(wavelengths, values) -> np.ndarray:
    """Resample piecewise-linear (lambda, v) data onto the dense 5nm grid
    (reference ``dense_spectrum.rs:34-66``)."""
    wavelengths = np.asarray(wavelengths, dtype=np.float64)
    values = np.asarray(values, dtype=np.float64)
    order = np.argsort(wavelengths, kind="stable")
    wavelengths, values = wavelengths[order], values[order]

    grid = LAMBDA_MIN + STEP * np.arange(DENSE_SAMPLES)
    out = np.zeros(DENSE_SAMPLES)
    for i, lam in enumerate(grid):
        b1 = np.searchsorted(wavelengths, lam, side="left")
        if b1 < len(wavelengths) and wavelengths[b1] == lam:
            out[i] = values[b1]
            continue
        l1, i1 = (lam, 0.0) if b1 == len(wavelengths) else (wavelengths[b1], values[b1])
        l0, i0 = (lam, 0.0) if b1 == 0 else (wavelengths[b1 - 1], values[b1 - 1])
        dl = l1 - l0
        if dl == 0.0:
            out[i] = i0
            continue
        x1 = (lam - l0) / dl
        out[i] = (1.0 - x1) * i0 + x1 * i1
    return out


def _interp(lookup, lam):
    """sum_b max(0, 1 - |x - b|) * v[b] over the two bins that can carry
    weight, x = (lam - 360) / 5; ``lookup(bin)`` gathers v at long bins."""
    x = (lam - LAMBDA_MIN) / STEP
    b0 = torch.floor(x)
    out = None
    for b in (b0, b0 + 1.0):
        w = torch.clamp(1.0 - torch.abs(x - b), min=0.0)
        inside = (b >= 0.0) & (b <= DENSE_SAMPLES - 1)
        v = lookup(torch.clamp(b, 0, DENSE_SAMPLES - 1).long())
        term = torch.where(inside, w * v, 0.0)
        out = term if out is None else out + term
    return torch.where(lam == 0.0, 0.0, out)


@lru_cache(maxsize=None)
def device_table(name: str, device: torch.device,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """:func:`table` as a ``dtype`` tensor on ``device``, copied once."""
    return torch.as_tensor(table(name), dtype=dtype, device=device)


def sample(values, lam):
    """One shared dense spectrum ``values`` (95,) tensor (e.g. a CIE
    curve from :func:`device_table`) sampled at wavelengths ``lam``
    (...).  lambda == 0 (a terminated hero sample) yields 0 (reference
    ``dense_spectrum.rs:80-83``)."""
    return _interp(lambda i: values[i], lam)


def sample_rows(table, rows, lam):
    """Per-ray rows of a dense-spectrum table: table (M, 95), rows (N,)
    int, lam (N, 4) -> (N, 4)."""
    return _interp(lambda i: table[rows[:, None], i], lam)


def to_xyz(values) -> np.ndarray:
    """Dense spectrum (..., 95) -> CIE XYZ (..., 3) (host, float64;
    reference ``dense_spectrum.rs:100-109``)."""
    v = np.asarray(values, dtype=np.float64)
    cmf = np.stack([table("X"), table("Y"), table("Z")], axis=-1)  # (95,3)
    return v @ cmf / Y_INTEGRAL
