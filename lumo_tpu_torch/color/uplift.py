"""Spectral uplift: RGB -> sigmoid-polynomial reflectance spectra.

Counterpart of ``lumo_tpu/color/uplift.py`` (Jakob & Hanika 2019).  The
port reads the fitted table its package carries, a byte copy of the JAX
package's ``uplift_srgb_64.npz``; where that file is missing,
:func:`table` fits the table again with :func:`fit_table` (a vectorised
Gauss-Newton fit in float64, on the card unless the caller names another
device, one batched 3x3 solve over the rows of a slice each iteration)
and writes it.

Fit criterion: the D65-weighted CIE XYZ of s, converted to linear sRGB,
must reproduce the input RGB (the original rgb2spec generator's).

A spectrum is (c0, c1, c2, scale): s(lambda) = scale * S(c0 x^2 + c1 x +
c2) with S(t) = 1/2 + t / (2 sqrt(1 + t^2)) and x = (lambda - 360) / 470.
"""
from __future__ import annotations

import os
import tempfile
from functools import lru_cache

import numpy as np
import torch

from lumo_tpu_torch.color import dense, space
from lumo_tpu_torch.config import LAMBDA_MAX, LAMBDA_MIN, resolve_device

RES = 64  # table resolution per axis
_DATA = os.path.join(os.path.dirname(__file__), "data", f"uplift_srgb_{RES}.npz")

_X_SCALE = 1.0 / (LAMBDA_MAX - LAMBDA_MIN)

FIT_ITERS = 18       # Gauss-Newton steps a slice
FIT_DAMPING = 1e-12  # added to the normal equations' diagonal


def _sigmoid(t):
    return 0.5 + t / (2.0 * torch.sqrt(1.0 + t * t))


def _sigmoid_grad(t):
    return 0.5 / torch.pow(1.0 + t * t, 1.5)


def _smoothstep(x):
    return x * x * (3.0 - 2.0 * x)


@lru_cache(maxsize=1)
def _fit_basis():
    """(A, xs) float64 numpy: A (3, 95) maps a 95-sample spectrum to
    linear sRGB under D65; xs are the normalised wavelengths of the dense
    grid."""
    lam = LAMBDA_MIN + dense.STEP * np.arange(dense.DENSE_SAMPLES)
    xs = (lam - LAMBDA_MIN) * _X_SCALE
    d65 = dense.table("D65")
    cmf = np.stack([dense.table("X"), dense.table("Y"), dense.table("Z")])
    xyz_of = cmf * d65[None, :]                 # spectrum -> XYZ
    norm = 1.0 / (d65 @ dense.table("Y"))       # white -> Y = 1
    A = space.get("sRGB").xyz_to_rgb @ (xyz_of * norm)
    return A, xs


def _fit_slice(c_init, targets, iters=FIT_ITERS):
    """Gauss-Newton fit of (P, 3) float64 coefficient rows, from
    ``c_init``, against (P, 3) linear-RGB ``targets``: each iteration one
    batched solve of the damped (P, 3, 3) normal equations."""
    dev = targets.device
    A, xs = (torch.as_tensor(x, dtype=torch.float64, device=dev)
             for x in _fit_basis())
    basis = torch.stack([xs * xs, xs, torch.ones_like(xs)])      # (3, 95)
    # J[p, o, k] = sum_i A[o, i] g[p, i] basis[k, i] = g @ ab
    ab = (A[:, None, :] * basis[None, :, :]).reshape(9, -1).T     # (95, 9)
    damping = FIT_DAMPING * torch.eye(3, dtype=torch.float64, device=dev)
    c = c_init.clone()
    for _ in range(iters):
        poly = c @ basis                                          # (P, 95)
        resid = _sigmoid(poly) @ A.T - targets                    # (P, 3)
        J = (_sigmoid_grad(poly) @ ab).reshape(-1, 3, 3)          # (P, o, k)
        jtj = J.transpose(1, 2) @ J + damping
        jtr = (J.transpose(1, 2) @ resid[..., None])[..., 0]
        c = c - torch.linalg.solve(jtj, jtr[..., None])[..., 0]
    return c


def fit_table(res=RES, device=None) -> dict:
    """Fit the uplift table at ``res`` nodes an axis on ``device`` (the
    card when None; raises without one): for each maximum channel maxc,
    the brightness slices k are fitted in order, each batched over its
    res^2 rows and warm-started from the slice before it, in two sweeps
    out from the middle slice (up from it starting at zero, then down from
    it).  Returns {'coeffs': (3, res, res, res, 3), 'scale': (res,)}
    float32 numpy, axes [maxc, z, y, x]."""
    dev = resolve_device(device)
    f64 = dict(dtype=torch.float64, device=dev)
    nodes = torch.arange(res, **f64) / (res - 1)
    scale_nodes = _smoothstep(_smoothstep(nodes))
    yg, xg = torch.meshgrid(nodes, nodes, indexing="ij")
    xg, yg = xg.reshape(-1), yg.reshape(-1)
    coeffs = torch.zeros((3, res, res * res, 3), **f64)
    mid = res // 2
    for maxc in range(3):
        for ks in (range(mid, res), range(mid - 1, -1, -1)):
            c = (torch.zeros((res * res, 3), **f64) if ks[0] == mid
                 else coeffs[maxc, mid].clone())
            for k in ks:
                z = scale_nodes[k]
                rgb = torch.zeros((res * res, 3), **f64)
                rgb[:, maxc] = z
                rgb[:, (maxc + 1) % 3] = xg * z
                rgb[:, (maxc + 2) % 3] = yg * z
                c = _fit_slice(c, rgb)
                coeffs[maxc, k] = c
    return {"coeffs": coeffs.reshape(3, res, res, res, 3).cpu().numpy()
            .astype(np.float32),
            "scale": scale_nodes.cpu().numpy().astype(np.float32)}


@lru_cache(maxsize=1)
def table(device=None) -> dict:
    """The fitted uplift table: {'coeffs': (3, RES, RES, RES, 3),
    'scale': (RES,)} - axes [maxc, z, y, x].  Read from ``_DATA``; where
    that file is missing, fitted on ``device`` (the card when None, so
    that without a card a missing table raises unless the caller passes
    ``device="cpu"``) and written there: into a temporary file first,
    then moved into place, so that processes fitting at once never read
    a half-written file.  :func:`from_rgb` reads it with no device: call
    ``table(device="cpu")`` first to build scenes without a card."""
    if not os.path.exists(_DATA):
        out = fit_table(RES, device)
        folder = os.path.dirname(_DATA)
        os.makedirs(folder, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=folder, suffix=".npz.part")
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez_compressed(f, **out)
            os.replace(tmp, _DATA)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
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


BLACK = np.zeros(4)


def white() -> np.ndarray:
    return from_rgb([1.0, 1.0, 1.0])
