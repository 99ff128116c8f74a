"""Hero-wavelength sampling (Wilkie et al. 2014 style, 4 stratified samples).

Counterpart of ``lumo_tpu/color/wavelength.py`` (reference
``wavelength.rs``): the wavelength state of N rays is one (N, 4) tensor;
a terminated state has its trailing samples zeroed and the leading pdf
divided by 4.
"""
from __future__ import annotations

import torch

from lumo_tpu_torch.config import LAMBDA_MAX, LAMBDA_MIN, SPECTRUM_SAMPLES

# Integral of cosh^-2(0.0072 (lambda - 538)) over [360, 830]
# (reference ``wavelength.rs:3-8``).
SAMPLE_VISIBLE_INTEGRAL = 253.819


def sample_one(u):
    """Importance-sample one wavelength from the visible-weighted cosh^-2
    distribution (reference ``wavelength.rs:56-60``), clamped into
    [LAMBDA_MIN, LAMBDA_MAX] against float32 rounding at u -> 0/1."""
    lam = 538.0 - 138.888889 * torch.atanh(
        0.85691062 - SAMPLE_VISIBLE_INTEGRAL * u * 0.0072)
    return torch.clamp(lam, LAMBDA_MIN, LAMBDA_MAX)


def sample(u):
    """Stratified hero-wavelength sample: u (...) in [0, 1) -> (..., 4)
    (reference ``wavelength.rs:35-44``)."""
    i = torch.arange(SPECTRUM_SAMPLES, dtype=u.dtype, device=u.device)
    v = u[..., None] + i / SPECTRUM_SAMPLES
    v = torch.where(v > 1.0, v - 1.0, v)
    return sample_one(v)


def sample_uniform_one(u):
    return LAMBDA_MIN + u * (LAMBDA_MAX - LAMBDA_MIN)


def pdf_one(lam):
    """(reference ``wavelength.rs:60-66``)."""
    inside = (lam >= LAMBDA_MIN) & (lam <= LAMBDA_MAX)
    p = 1.0 / (SAMPLE_VISIBLE_INTEGRAL * torch.cosh(0.0072 * (lam - 538.05)) ** 2)
    return torch.where(inside, p, 0.0)


def is_terminated(lam):
    """(..., 4) -> (...) bool: all trailing samples zero."""
    return torch.all(lam[..., 1:] == 0.0, dim=-1)


def pdf(lam):
    """Per-sample pdf (..., 4); the leading pdf is scaled by 1/4 when the
    state is terminated (reference ``wavelength.rs:24-33``)."""
    p = pdf_one(lam)
    lead_scale = torch.where(is_terminated(lam), 1.0 / SPECTRUM_SAMPLES, 1.0)
    return torch.cat([p[..., :1] * lead_scale[..., None], p[..., 1:]], dim=-1)


def terminate(lam, do):
    """Zero the trailing samples where the (...) bool mask ``do`` holds."""
    keep = torch.cat([torch.ones_like(lam[..., :1], dtype=torch.bool),
                      (~do[..., None]).expand(lam[..., 1:].shape)], dim=-1)
    return torch.where(keep, lam, 0.0)


def leading(lam):
    return lam[..., 0]
