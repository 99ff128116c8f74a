"""Diagnose the float32 against float64 gap of the theta gradient.

Counterpart of ``tools/diag_grad.py``.  The per-pixel dL/dtheta of the
Cornell box (fixed depth 2; theta a scalar scaling the material table
``kd``; L = mean(rgb^2)) by forward mode (``torch.autograd.forward_ad``:
theta is a scalar, so one tangent gives every pixel's derivative), in
float32 and in float64 (``config.use_f64``), with the quality harness's
ray, wavelength and key draws (``tools/quality.py``).  It prints

- the cancellation ratio sum|g_i| / |sum g_i|: when it is much above 1
  the net gradient is a small difference of large terms, and float32's
  relative error on the net is amplified by that ratio;
- whether the float32 error is spread (accumulation rounding) or held
  by a few pixels (discrete or ill-conditioned lanes): the share of the
  ten largest errors, and those ten pixels.

The renders run on the card unless ``--device`` names another device.

    python -m lumo_tpu_torch.tools.diag_grad [res spp] [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch
from torch.autograd import forward_ad

from lumo_tpu_torch import film
from lumo_tpu_torch.integrators import path_trace
from lumo_tpu_torch.tools.quality import (CORNELL_DEPTH, FLIP, cornell_setup,
                                          precision, sample_rays)


def per_pixel_tangent(dtype, res, spp, scale_key="kd", device=None):
    """(g (N,), rgb (N, 3)) as float64 numpy: each pixel's term of
    dL/dtheta for L = mean(rgb^2), before the 1/N of the mean, and its
    mean RGB over ``spp`` samples, in ``dtype`` (torch.float32 or
    torch.float64; call float64 under ``quality.precision``)."""
    scene, cam = cornell_setup(dtype, res, device)
    dev = cam.c2w_t.device
    wbm = film.wb_matrix("DCI-P3", "CORNELL")
    n = res * res
    rgb = torch.zeros((n, 3), dtype=dtype, device=dev)
    tan = torch.zeros((n, 3), dtype=dtype, device=dev)
    one = torch.ones((), dtype=dtype, device=dev)
    with torch.no_grad(), forward_ad.dual_level():
        theta = forward_ad.make_dual(one, one)
        mats = dict(scene.materials)
        mats[scale_key] = mats[scale_key] * theta
        sc = dataclasses.replace(scene, materials=mats)
        for s in range(spp):
            o, d, lam, key = sample_rays(cam, res, s, dtype)
            r, lam_out, _ = path_trace.integrate(sc, o, d, lam, ray_key=key,
                                                 fixed_depth=CORNELL_DEPTH)
            p, t = forward_ad.unpack_dual(
                film.spectral_to_rgb(r, lam_out, wbm))
            rgb, tan = rgb + p, tan + t
    rgb, tan = rgb / spp, tan / spp
    as64 = lambda x: x.cpu().numpy().astype(np.float64)
    # dL/dtheta per pixel for L = mean(rgb^2): 2 rgb tan / n (before the /n)
    return (2.0 * as64(rgb) * as64(tan)).sum(axis=1), as64(rgb)


def main(res=64, spp=4, device=None):
    """Print the JAX tool's lines; returns their numbers as a dict."""
    g32, rgb32 = per_pixel_tangent(torch.float32, res, spp, device=device)
    with precision(torch.float64):
        g64, rgb64 = per_pixel_tangent(torch.float64, res, spp,
                                       device=device)
    stable = np.abs(rgb32 - rgb64).max(axis=1) < FLIP
    n = g64.size
    g32m = np.where(stable, g32, 0.0) / n
    g64m = np.where(stable, g64, 0.0) / n
    net64, gross64 = g64m.sum(), np.abs(g64m).sum()
    net32 = g32m.sum()
    err = g32m - g64m
    order = np.argsort(-np.abs(err))
    out = {"net64": net64, "gross64": gross64,
           "cancellation": gross64 / abs(net64), "net32": net32,
           "rel_err_net": abs(net32 - net64) / abs(net64),
           "rel_err_gross": abs(net32 - net64) / gross64,
           "sum_abs_err": np.abs(err).sum(),
           "top10_share": np.abs(err[order[:10]]).sum() / np.abs(err).sum()}
    print(f"net64={net64:.6e} gross64={gross64:.6e} "
          f"cancellation={out['cancellation']:.1f}x")
    print(f"net32={net32:.6e} rel_err_net={out['rel_err_net']:.4f}")
    print(f"rel_err_gross={out['rel_err_gross']:.2e}")
    print(f"sum|err|={out['sum_abs_err']:.3e}  "
          f"top10 |err| share={out['top10_share']:.3f}")
    for i in order[:10]:
        print(f"  pix {i:5d}: g64={g64m[i]:+.3e} g32={g32m[i]:+.3e} "
              f"err={err[i]:+.3e} rgb64={rgb64[i]}")
    return {k: float(v) for k, v in out.items()}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("size", nargs="*", type=int, help="res spp")
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    main(*args.size, device=args.device)
