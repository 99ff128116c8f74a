"""Film: filter-weighted sample accumulation via scatter-add, splat buffer,
tone mapping, PNG output.

Counterpart of ``lumo_tpu/film.py`` (reference
``src/tracer/{film,filter}.rs`` + ``src/tone_mapping.rs``).  The whole
wavefront scatter-adds into the film through a statically unrolled
(2r+1)^2 footprint loop; spectral -> RGB conversion happens at sample time
(``film/tile.rs:65-111``: XYZ, then white balance, then RGB, then filter
weights).  Unlike the JAX package's pure functions, ``add_samples``
updates the film it is given in place (``index_add_``); on the card those
adds are atomic, so sums differ from run to run in their last bits.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from lumo_tpu_torch.color import dense, space, uplift

# filter kinds
SQUARE, TRIANGLE, GAUSSIAN, MITCHELL = range(4)

_TINY = 1e-30
_F = np.float32


@dataclasses.dataclass(frozen=True)
class PixelFilter:
    radius: float   # held as the float32 value the JAX package computes with
    sigma: float    # gaussian sigma or mitchell b
    kind: int
    r_disc: int

    @staticmethod
    def make(kind=GAUSSIAN, radius=1.5, sigma=None):
        if sigma is None:
            sigma = radius / 4.0 if kind == GAUSSIAN else (1.0 / 3.0)
        r_disc = int(math.ceil(radius - 0.5))
        return PixelFilter(radius=float(_F(radius)), sigma=float(_F(sigma)),
                           kind=kind, r_disc=r_disc)

    @staticmethod
    def square(radius=0.5):
        return PixelFilter.make(SQUARE, radius)

    @staticmethod
    def gaussian(radius=1.5, sigma=None):
        return PixelFilter.make(GAUSSIAN, radius, sigma)

    @staticmethod
    def triangle(radius=1.0):
        return PixelFilter.make(TRIANGLE, radius)

    @staticmethod
    def mitchell(radius=2.0, b=1.0 / 3.0):
        return PixelFilter.make(MITCHELL, radius, b)


def _gauss_consts(sigma):
    """float32 (2 sigma^2, sqrt(2 pi sigma^2)), rounded step by step as
    the JAX package's float32 scalars round."""
    s = _F(sigma)
    return float(_F(2.0) * s * s), float(np.sqrt(_F(2.0 * math.pi) * s * s))


def _gauss(x, sigma):
    den, norm = _gauss_consts(sigma)
    return torch.exp(-x * x / den) / norm


def _gauss_scalar(x, sigma) -> float:
    """``_gauss`` of one float32 value, in float32."""
    den, norm = _gauss_consts(sigma)
    x = _F(x)
    return float(np.exp(-x * x / _F(den)) / _F(norm))


def _mitch(x, b):
    b = _F(b)
    c = (_F(1.0) - b) / _F(2.0)
    k = lambda v: float(_F(v))
    ax = torch.abs(x)
    p1 = (k(12.0 - 9.0 * b - 6.0 * c) * ax ** 3
          + k(-18.0 + 12.0 * b + 6.0 * c) * ax ** 2 + k(6.0 - 2.0 * b))
    p2 = (k(-b - 6.0 * c) * ax ** 3 + k(6.0 * b + 30.0 * c) * ax ** 2
          + k(-12.0 * b - 48.0 * c) * ax + k(8.0 * b + 24.0 * c))
    return torch.where(ax < 1.0, p1, torch.where(ax < 2.0, p2, 0.0)) / 6.0


def filter_eval(filt: PixelFilter, v):
    """Filter weight at offset v (..., 2) (reference ``filter.rs:80-101``)."""
    x, y = v[..., 0], v[..., 1]
    r = filt.radius
    if filt.kind == SQUARE:
        return torch.where((torch.abs(x) < r) & (torch.abs(y) < r), 1.0, 0.0)
    if filt.kind == TRIANGLE:
        ox = torch.clamp(r - torch.abs(x), min=0.0)
        oy = torch.clamp(r - torch.abs(y), min=0.0)
        return ox * oy
    if filt.kind == GAUSSIAN:
        gr = _gauss_scalar(r, filt.sigma)
        return (torch.clamp(_gauss(x, filt.sigma) - gr, min=0.0)
                * torch.clamp(_gauss(y, filt.sigma) - gr, min=0.0))
    return _mitch(2.0 * x / r, filt.sigma) * _mitch(2.0 * y / r, filt.sigma)


def filter_integral(filt: PixelFilter) -> float:
    """Closed-form integral of the filter (reference ``filter.rs:104-117``)."""
    r = float(filt.radius)
    s = float(filt.sigma)
    if filt.kind == SQUARE:
        return 4.0 * r * r
    if filt.kind == TRIANGLE:
        return r ** 4
    if filt.kind == MITCHELL:
        return r * r * 0.25
    denom = s * math.sqrt(2.0)
    ig = 0.5 * (math.erf(r / denom) - math.erf(-r / denom))
    return (ig - 2.0 * r * _gauss_scalar(r, s)) ** 2


# ---------------------------------------------------------------------------
# tone mapping (reference ``tone_mapping.rs:38-64``)

NOMAP, CLAMP, REINHARD = range(3)
_TM_NAMES = {"nomap": NOMAP, "none": NOMAP, "clamp": CLAMP,
             "reinhard": REINHARD}

# debug radiance sanitizer (reference ``tone_mapping.rs:9,42-56``)
SUSPICIOUSLY_LARGE_VALUE = 1000.0


def tone_map_kind(kind):
    """Normalize a tone-map spec (int constant or name string) to an int."""
    if isinstance(kind, str):
        return _TM_NAMES[kind.lower()]
    kind = int(kind)
    if kind not in (NOMAP, CLAMP, REINHARD):
        raise ValueError(f"unknown tone map {kind}")
    return kind


def tone_map(kind, color, lam, arg=1.0, debug=False):
    """Tone-map spectral samples.  With ``debug=True``, estimator bugs are
    painted instead of scrubbed (reference debug build,
    ``tone_mapping.rs:42-56``): NaN -> green, negative -> red, suspiciously
    large -> blue, each at 32x brightness so they glow in the output."""
    kind = tone_map_kind(kind)
    if kind == NOMAP:
        out = color
    elif kind == CLAMP:
        out = torch.clamp(color, 0.0, arg)
    else:
        lum = space.luminance(color, lam)
        out = color / (1.0 + lum[..., None])
    if debug:
        nan = (~torch.isfinite(color)).any(dim=-1)
        neg = (color < 0.0).any(dim=-1)
        huge = color.amax(dim=-1) > SUSPICIOUSLY_LARGE_VALUE
        paint = {name: 32.0 * uplift.sample(
                     torch.as_tensor(uplift.from_rgb(rgb), dtype=color.dtype,
                                     device=color.device)[None, :], lam)
                 for name, rgb in (("g", [0, 1, 0]), ("r", [1, 0, 0]),
                                   ("b", [0, 0, 1]))}
        out = torch.where(nan[..., None], paint["g"],
              torch.where(neg[..., None], paint["r"],
              torch.where(huge[..., None], paint["b"], out)))
    return out


# ---------------------------------------------------------------------------
# film accumulation

def new_film(resolution, dtype=torch.float32, device=None):
    """(color (H, W, 3), weight (H, W), splat (H, W, 3)) accumulators."""
    w, h = resolution
    return (torch.zeros((h, w, 3), dtype=dtype, device=device),
            torch.zeros((h, w), dtype=dtype, device=device),
            torch.zeros((h, w, 3), dtype=dtype, device=device))


def add_samples(film, filt: PixelFilter, raster_xy, rgb, resolution,
                splat=False, mask=None):
    """Scatter a wavefront of RGB samples through the pixel filter into
    ``film``, in place; returns ``film``.

    film: (color, weight, splat) triplet; raster_xy (N, 2); rgb (N, 3).
    The (2r+1)^2 filter footprint loop is unrolled (r_disc <= 2 for all
    stock filters)."""
    color, weight, splats = film
    w_res, h_res = resolution
    px = torch.floor(raster_xy).to(torch.int64)
    if mask is None:
        mask = torch.ones(raster_xy.shape[:-1], dtype=torch.bool,
                          device=raster_xy.device)
    r = filt.r_disc
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            fx = px[..., 0] + dx
            fy = px[..., 1] + dy
            mid = torch.stack([fx.to(raster_xy.dtype) + 0.5,
                               fy.to(raster_xy.dtype) + 0.5], dim=-1)
            wgt = filter_eval(filt, raster_xy - mid)
            inb = (fx >= 0) & (fx < w_res) & (fy >= 0) & (fy < h_res) & mask
            wgt = torch.where(inb, wgt, 0.0)
            flat = (fy.clamp(0, h_res - 1) * w_res
                    + fx.clamp(0, w_res - 1)).reshape(-1)
            val = (wgt[..., None] * rgb).reshape(-1, 3)
            if splat:
                splats.view(-1, 3).index_add_(0, flat, val)
            else:
                color.view(-1, 3).index_add_(0, flat, val)
                weight.view(-1).index_add_(0, flat, wgt.reshape(-1))
    return film


def spectral_to_rgb(color4, lam, xyz_to_rgb_wb):
    """Spectral sample (N, 4) at wavelengths (N, 4) -> linear RGB (N, 3)."""
    return space.to_rgb(color4, lam, xyz_to_rgb_wb)


def finalize(film, filt: PixelFilter, splat_scale: float):
    """pixels / weight + splats * scale / integral(filter) -> linear RGB
    image (H, W, 3) (reference ``film.rs:173-192``)."""
    color, weight, splats = film
    direct = color / torch.clamp(weight[..., None], min=_TINY)
    return direct + splats * (splat_scale / filter_integral(filt))


def save_png(rgb_linear, path: str, colorspace="sRGB"):
    """Encode with the color space transfer curve and write a PNG."""
    from PIL import Image
    cs = space.get(colorspace)
    img = cs.encode(np.asarray(rgb_linear))
    Image.fromarray(img, "RGB").save(path)


def wb_matrix(colorspace: str, illuminant) -> np.ndarray:
    """Fused (XYZ->RGB)(Von Kries WB) matrix for the film."""
    cs = space.get(colorspace)
    illum = dense.table(illuminant) if isinstance(illuminant, str) else illuminant
    return cs.xyz_to_rgb @ cs.wb_matrix(illum)
