"""The reference's renders: the progressive pass of
``Renderer(...).samples(spp).seed(seed).render()`` worked out again for
chosen pixels (frozen copy of the batch path of
``lumo_tpu_torch/renderer.py`` with the Gaussian film of ``film.py``),
and the material-gradient step of the ``grad`` traffic."""
from __future__ import annotations

import math

import numpy as np
import torch

from . import spectra
from .integrator import integrate
from .rng import MASK32, hash_u32, mul32, pixel_offsets, randfloat

FILTER_RADIUS = np.float32(1.5)
FILTER_SIGMA = np.float32(1.5 / 4.0)
R_DISC = 1
_F = np.float32


def _gauss_consts():
    s = FILTER_SIGMA
    return float(_F(2.0) * s * s), float(np.sqrt(_F(2.0 * math.pi) * s * s))


def _gauss(x):
    den, nrm = _gauss_consts()
    return torch.exp(-x * x / den) / nrm


def _gauss_scalar(x) -> float:
    den, nrm = _gauss_consts()
    x = _F(x)
    return float(np.exp(-x * x / _F(den)) / _F(nrm))


def filter_weight(v):
    """The Gaussian pixel filter at offsets v (..., 2)."""
    gr = _gauss_scalar(FILTER_RADIUS)
    return (torch.clamp(_gauss(v[..., 0]) - gr, min=0.0)
            * torch.clamp(_gauss(v[..., 1]) - gr, min=0.0))


def auto_batch(res, spp):
    """Samples a step of the Renderer's batch mode (``_auto_batch``)."""
    w, h = res
    return max(1, min(max(1, int(2_000_000 / max(w * h, 1))), spp))


def camera_samples(camera, idx, seed, total_spp):
    """The Renderer's camera samples of sample ids ``idx`` (pixel ``idx %
    n_pix``, sample ``idx // n_pix``) under ``seed``."""
    w, h = camera.resolution
    n_pix = w * h
    pix = idx % n_pix
    sidx = (idx // n_pix) & MASK32
    lam_seed = (seed * 7919 + 13) & MASK32
    key_seed = (seed * 0x85EBCA6B + 0x9E3779B9) & MASK32
    offs = pixel_offsets(sidx, total_spp, pix, seed)
    raster = torch.stack([(pix % w).to(torch.float32) + offs[..., 0],
                          (pix // w).to(torch.float32) + offs[..., 1]], -1)
    lam = spectra.sample_wavelengths(
        randfloat(pix, lam_seed ^ mul32(sidx, 0x9E3779B9)))
    key = hash_u32(pix ^ hash_u32(sidx ^ key_seed))
    o, d = camera.generate_ray(raster)
    return o, d, lam, key, raster, pix


def _delta(stats):
    cnt = torch.clamp(stats["n"], min=1.0)
    var = stats["f2"] - stats["f"] ** 2 / cnt
    ok = (var > 0.0) & (stats["cost"] > 0.0) & (stats["n"] > 1.0)
    return torch.where(ok, torch.sqrt(torch.where(ok, var, 1.0)
                                      / torch.clamp(stats["cost"], min=1.0)),
                       1e-5)


def render_pixels(scene, camera, spp, seed, pixels, batch=None):
    """The linear-RGB values (P, 3) that a pass of ``spp`` samples under
    ``seed`` gives at the flat pixel ids ``pixels``: every sample of the
    pixels whose filter footprint reaches them is traced, each batch step
    under the adaptive Russian-roulette threshold that the steps before
    it left in its pixel's statistics.  ``batch``: samples a step, by
    default the Renderer's automatic one."""
    dev = scene.device
    w, h = camera.resolution
    n_pix = w * h
    pixels = torch.as_tensor(pixels, dtype=torch.int64, device=dev)
    px, py = pixels % w, pixels // w
    around = []
    for dy in range(-R_DISC, R_DISC + 1):
        for dx in range(-R_DISC, R_DISC + 1):
            x, y = px + dx, py + dy
            inb = (x >= 0) & (x < w) & (y >= 0) & (y < h)
            around.append((y * w + x)[inb])
    src = torch.unique(torch.cat(around))               # pixels traced
    slot = torch.full((n_pix,), -1, dtype=torch.int64, device=dev)
    slot[src] = torch.arange(src.shape[0], device=dev)
    out_slot = torch.full((n_pix,), -1, dtype=torch.int64, device=dev)
    out_slot[pixels] = torch.arange(pixels.shape[0], device=dev)
    stats = {k: torch.zeros(src.shape[0], device=dev)
             for k in ("f", "f2", "cost", "n")}
    color = torch.zeros((pixels.shape[0], 3), device=dev)
    weight = torch.zeros(pixels.shape[0], device=dev)
    m_wb = spectra.wb_matrix("DCI-P3", "D65")  # the Renderer's film
    batch = auto_batch((w, h), spp) if batch is None else batch
    for base in range(0, spp, batch):
        # the step's camera samples at its full size (a whole batch, as
        # the program's last step is too), then the traced pixels' lanes
        ids = base * n_pix + torch.arange(batch * n_pix, device=dev)
        o, d, lam, key, raster, pix = camera_samples(camera, ids, seed, spp)
        keep = slot[pix] >= 0
        o, d, lam, key, raster, pix = (x[keep] for x in
                                       (o, d, lam, key, raster, pix))
        delta = _delta(stats)[slot[pix]]
        radiance, lam_out, depth = integrate(scene, o, d, lam, key, delta)
        rgb = spectra.to_rgb(radiance, lam_out, m_wb)
        f_lum = spectra.luminance(radiance, lam_out)
        s = slot[pix]
        stats = {"f": stats["f"].index_add(0, s, f_lum),
                 "f2": stats["f2"].index_add(0, s, f_lum * f_lum),
                 "cost": stats["cost"].index_add(
                     0, s, depth.to(torch.float32) * 2.0 + 1.0),
                 "n": stats["n"].index_add(0, s, torch.ones_like(f_lum))}
        cell = torch.floor(raster).to(torch.int64)
        for dy in range(-R_DISC, R_DISC + 1):
            for dx in range(-R_DISC, R_DISC + 1):
                fx, fy = cell[:, 0] + dx, cell[:, 1] + dy
                mid = torch.stack([fx.to(torch.float32) + 0.5,
                                   fy.to(torch.float32) + 0.5], -1)
                wgt = filter_weight(raster - mid)
                inb = (fx >= 0) & (fx < w) & (fy >= 0) & (fy < h)
                tgt = out_slot[torch.clamp(fy, 0, h - 1) * w
                               + torch.clamp(fx, 0, w - 1)]
                use = inb & (tgt >= 0)
                color.index_add_(0, tgt[use], wgt[use, None] * rgb[use])
                weight.index_add_(0, tgt[use], wgt[use])
    return color / torch.clamp(weight[:, None], min=1e-30)


def grad_step(scene, o, d, lam, key, depth, loss_fn):
    """The loss and the gradients of every float material table of one
    fixed-depth step of the ``grad`` traffic: (loss, {table: gradient})."""
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in scene.materials.items() if v.is_floating_point()}
    sc = scene.with_materials(leaves)
    with torch.enable_grad():
        r, lam_out, _ = integrate(sc, o, d, lam, key, fixed_depth=depth)
        loss = loss_fn(r, lam_out)
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
    return loss.detach(), {k: (torch.zeros_like(v) if g is None else g)
                           for (k, v), g in zip(leaves.items(), grads)}


def loss_rgb(wb_space, wb_illuminant):
    """mean(rgb^2) through the film's colour matrix."""
    m = spectra.wb_matrix(wb_space, wb_illuminant)
    return lambda r, lam: (spectra.to_rgb(r, lam, m) ** 2).mean()


def loss_r2(r, lam):
    """mean(r^2) of the spectral radiance."""
    return (r * r).mean()
