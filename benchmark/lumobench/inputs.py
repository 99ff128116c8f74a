"""The inputs the benchmark makes from ``--seed`` and hands to both the
program and the reference: per-unit seeds and the gradient traffic's
rays (frozen copy of ``lumo_tpu_torch/bench.py``'s ``grad_rays``, on the
benchmark's own camera)."""
from __future__ import annotations

import torch

from reference import spectra
from reference.rng import MASK32, hash_u32, randfloat


def unit_seed(seed: int, k: int) -> int:
    """The 31-bit seed of unit ``k`` of a run seeded ``seed``."""
    x = hash_u32(torch.tensor([(seed ^ (seed >> 32)) & MASK32]))
    x = hash_u32(x ^ (k * 0x9E3779B9 & MASK32))
    return int(x) & 0x7FFFFFFF


def grad_rays(camera, sample_ids, device):
    """Jittered camera rays of each sample ``sp`` of ``sample_ids`` at
    every pixel, concatenated: (o, d, lam, ray_key) with ray_key =
    hash(pixel ^ hash(sp))."""
    w, h = camera.resolution
    pix = torch.arange(w * h, dtype=torch.int64, device=device)
    parts = []
    for sp in sample_ids:
        jx = randfloat(pix, sp ^ 0x51633E2D)
        jy = randfloat(pix, sp ^ 0x68BC21EB)
        raster = torch.stack([(pix % w).float() + jx,
                              (pix // w).float() + jy], -1)
        o, d = camera.generate_ray(raster)
        lam = spectra.sample_wavelengths(randfloat(pix, sp ^ 0x02E5BE93))
        parts.append((o, d, lam,
                      hash_u32(pix ^ hash_u32(torch.full_like(pix, sp)))))
    return tuple(torch.cat(x) for x in zip(*parts))


def step_samples(seed: int, k: int, spp: int):
    """The sample ids of gradient step ``k``: ``spp`` consecutive ids
    from the run's base."""
    base = unit_seed(seed, 1 << 20)
    return [(base + spp * k + j) & MASK32 for j in range(spp)]
