"""Hero wavelengths, dense spectra, colour spaces and the RGB-to-spectrum
uplift (frozen copies of ``lumo_tpu_torch/color/{wavelength,dense,space,
uplift}.py``, cut to what the benchmark's scenes use).  The CIE curves,
the illuminants and the fitted uplift table are read from frozen copies
of the port's raw data files in ``reference/data/``; nothing of the port
is imported or read."""
from __future__ import annotations

import os
from functools import lru_cache

import numpy as np
import torch

LAMBDA_MIN = 360.0
LAMBDA_MAX = 830.0
DENSE_SAMPLES = 95
STEP = (LAMBDA_MAX - LAMBDA_MIN) / (DENSE_SAMPLES - 1)
Y_INTEGRAL = 106.856895
SAMPLE_VISIBLE_INTEGRAL = 253.819
UPLIFT_RES = 64

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


# ---------------------------------------------------------------------------
# data files

@lru_cache(maxsize=1)
def _tables() -> dict:
    with np.load(os.path.join(DATA, "spectra.npz")) as d:
        return {k: d[k].astype(np.float64) for k in d.files}


def table(name: str) -> np.ndarray:
    """A named dense spectrum (95,) float64 ('X', 'Y', 'Z', 'D65',
    'CORNELL', ...)."""
    return _tables()[name]


@lru_cache(maxsize=1)
def uplift_table():
    with np.load(os.path.join(DATA, f"uplift_srgb_{UPLIFT_RES}.npz")) as d:
        return d["coeffs"].astype(np.float64), d["scale"].astype(np.float64)


@lru_cache(maxsize=None)
def device_table(name: str, device, dtype=torch.float32) -> torch.Tensor:
    return torch.as_tensor(table(name), dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# hero wavelengths

def sample_wavelengths(u):
    """Stratified hero wavelengths: u (...) in [0, 1) -> (..., 4)."""
    i = torch.arange(4, dtype=u.dtype, device=u.device)
    v = u[..., None] + i / 4
    v = torch.where(v > 1.0, v - 1.0, v)
    lam = 538.0 - 138.888889 * torch.atanh(
        0.85691062 - SAMPLE_VISIBLE_INTEGRAL * v * 0.0072)
    return torch.clamp(lam, LAMBDA_MIN, LAMBDA_MAX)


def wavelength_pdf(lam):
    inside = (lam >= LAMBDA_MIN) & (lam <= LAMBDA_MAX)
    p = 1.0 / (SAMPLE_VISIBLE_INTEGRAL
               * torch.cosh(0.0072 * (lam - 538.05)) ** 2)
    p = torch.where(inside, p, 0.0)
    terminated = torch.all(lam[..., 1:] == 0.0, dim=-1)
    lead = torch.where(terminated, 1.0 / 4, 1.0)
    return torch.cat([p[..., :1] * lead[..., None], p[..., 1:]], dim=-1)


# ---------------------------------------------------------------------------
# dense spectra

def _interp(lookup, lam):
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


def dense_sample(values, lam):
    """One dense spectrum (95,) at wavelengths ``lam`` (...)."""
    return _interp(lambda i: values[i], lam)


def dense_rows(tbl, rows, lam):
    """Per-ray rows of a dense table: (M, 95), rows (N,), lam (N, 4)."""
    return _interp(lambda i: tbl[rows[:, None], i], lam)


def dense_from_points(wavelengths, values) -> np.ndarray:
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
        l1, i1 = ((lam, 0.0) if b1 == len(wavelengths)
                  else (wavelengths[b1], values[b1]))
        l0, i0 = (lam, 0.0) if b1 == 0 else (wavelengths[b1 - 1],
                                             values[b1 - 1])
        dl = l1 - l0
        if dl == 0.0:
            out[i] = i0
            continue
        x1 = (lam - l0) / dl
        out[i] = (1.0 - x1) * i0 + x1 * i1
    return out


def dense_to_xyz(values) -> np.ndarray:
    v = np.asarray(values, dtype=np.float64)
    cmf = np.stack([table("X"), table("Y"), table("Z")], axis=-1)
    return v @ cmf / Y_INTEGRAL


# ---------------------------------------------------------------------------
# colour spaces (host matrices in float64)

XYZ_TO_LMS = np.array([
    [0.210576, 0.855098, -0.0396983],
    [-0.417076, 1.177260, 0.0786283],
    [0.0, 0.0, 0.5168350],
])
LMS_TO_XYZ = np.linalg.inv(XYZ_TO_LMS)
PRIMARIES = {"sRGB": ((0.64, 0.33), (0.3, 0.6), (0.15, 0.06)),
             "DCI-P3": ((0.68, 0.32), (0.265, 0.69), (0.15, 0.06))}


def _from_xyY(xy, Y=1.0) -> np.ndarray:
    x, y = float(xy[0]), float(xy[1])
    if y == 0.0:
        return np.zeros(3)
    return np.array([x * Y / y, Y, (1.0 - x - y) * Y / y])


def _to_xyY(xyz) -> np.ndarray:
    s = float(xyz[0] + xyz[1] + xyz[2])
    return np.array([xyz[0] / s, xyz[1] / s])


def _white():
    return _from_xyY(_to_xyY(dense_to_xyz(table("D65"))))


def xyz_to_rgb(space: str) -> np.ndarray:
    W = _white()
    R, G, B = (_from_xyY(p) for p in PRIMARIES[space])
    rgb_c = np.stack([R, G, B], axis=-1)
    C = np.linalg.solve(rgb_c, W)
    return np.linalg.inv(rgb_c @ np.diag(C))


def wb_matrix(space: str, illuminant: str) -> np.ndarray:
    """(XYZ -> RGB)(Von Kries white balance to ``illuminant``)."""
    illum_xy = _to_xyY(dense_to_xyz(table(illuminant)))
    diag = (XYZ_TO_LMS @ _white()) / (XYZ_TO_LMS @ _from_xyY(illum_xy))
    wb = LMS_TO_XYZ @ np.diag(diag) @ XYZ_TO_LMS
    return xyz_to_rgb(space) @ wb


def _mean4(x):
    return (((x[..., 0] + x[..., 1]) + x[..., 2]) + x[..., 3]) / 4.0


def luminance(color, lam):
    p = wavelength_pdf(lam)
    y = dense_sample(device_table("Y", lam.device, color.dtype), lam)
    ok = p > 0.0
    contrib = torch.where(ok, y * color / torch.where(ok, p, 1.0), 0.0)
    return _mean4(contrib) / Y_INTEGRAL


def to_rgb(color, lam, m_wb):
    """Spectral samples (N, 4) at ``lam`` -> linear RGB (N, 3)."""
    p = wavelength_pdf(lam)
    ok = p > 0.0
    w = torch.where(ok, color / torch.where(ok, p, 1.0), 0.0)
    xyz = torch.stack(
        [_mean4(dense_sample(device_table(k, lam.device, color.dtype), lam)
                * w) for k in ("X", "Y", "Z")], dim=-1) / Y_INTEGRAL
    m = torch.as_tensor(m_wb, dtype=color.dtype, device=color.device)
    return xyz @ m.T


# ---------------------------------------------------------------------------
# RGB -> sigmoid-polynomial spectra (Jakob & Hanika 2019)

def from_rgb(rgb) -> np.ndarray:
    """Linear RGB (3,) -> coefficients (4,) (trilinear table lookup)."""
    rgb = np.atleast_2d(np.asarray(rgb, dtype=np.float64))
    coeffs_t, scale_nodes = uplift_table()
    res = UPLIFT_RES
    rows = np.arange(len(rgb))
    maxc = np.argmax(rgb, axis=-1)
    mx = rgb[rows, maxc]
    black = mx <= 0.0
    mx_safe = np.where(black, 1.0, mx)
    scale_mult = np.where(mx > 1.0, 2.0 * mx, 1.0)
    xn = rgb[rows, (maxc + 1) % 3] / mx_safe
    yn = rgb[rows, (maxc + 2) % 3] / mx_safe
    zn = np.clip(mx / scale_mult, 0.0, 1.0)
    x = np.clip(xn, 0.0, 1.0) * (res - 1)
    y = np.clip(yn, 0.0, 1.0) * (res - 1)
    xi = np.minimum(x.astype(np.int64), res - 2)
    yi = np.minimum(y.astype(np.int64), res - 2)
    zi = np.clip(np.searchsorted(scale_nodes, zn, side="right") - 1, 0,
                 res - 2)
    x1, y1 = x - xi, y - yi
    dz = scale_nodes[zi + 1] - scale_nodes[zi]
    z1 = np.where(dz > 0, (zn - scale_nodes[zi]) / np.where(dz > 0, dz, 1.0),
                  0.0)
    out = np.zeros((len(rgb), 3))
    for dzi in (0, 1):
        for dyi in (0, 1):
            for dxi in (0, 1):
                w = (np.where(dzi, z1, 1 - z1) * np.where(dyi, y1, 1 - y1)
                     * np.where(dxi, x1, 1 - x1))
                out += w[:, None] * coeffs_t[maxc, zi + dzi, yi + dyi,
                                             xi + dxi]
    res4 = np.concatenate([out, scale_mult[:, None]], axis=-1)
    res4[black] = 0.0
    return res4[0]


def from_srgb8(r, g, b) -> np.ndarray:
    u = np.array([r, g, b], dtype=np.float64) / 255.0
    lin = np.where(u <= 0.04045, u / 12.92,
                   np.power((u + 0.055) / 1.055, 2.4))
    return from_rgb(lin)


def from_points(pts: str) -> np.ndarray:
    """"lambda:v ..." -> dense -> XYZ -> sRGB -> coefficients."""
    pairs = sorted((float(a), float(b)) for a, b in
                   (tok.split(":") for tok in pts.split()))
    ds = dense_from_points([p[0] for p in pairs], [p[1] for p in pairs])
    return from_rgb(xyz_to_rgb("sRGB") @ dense_to_xyz(ds))


def spectrum(spec) -> np.ndarray:
    """A material's spectrum spec: "lambda:v ..." points, an RGB triple,
    or a scalar reflectance -> coefficients (4,)."""
    if isinstance(spec, str):
        return from_points(spec)
    x = np.asarray(spec, dtype=np.float64)
    if x.shape == (3,):
        return from_rgb(x)
    if x.shape == ():
        return from_rgb([float(x)] * 3)
    raise ValueError(f"bad spectrum spec {spec!r}")


def uplift_sample(coeffs, lam):
    """Coefficients (..., 4) at wavelengths ``lam`` (...)."""
    x = (lam - LAMBDA_MIN) * (1.0 / (LAMBDA_MAX - LAMBDA_MIN))
    t = coeffs[..., 0] * x * x + coeffs[..., 1] * x + coeffs[..., 2]
    s = 0.5 + t / (2.0 * torch.sqrt(1.0 + t * t))
    return torch.where(lam == 0.0, 0.0, coeffs[..., 3] * s)
