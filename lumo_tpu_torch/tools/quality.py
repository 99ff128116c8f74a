"""Quality harness of the port: float32 against a float64 reference, and
reverse-mode AD against finite differences.

Counterpart of ``tools/quality.py``.  The same code renders twice, in
float64 (the reference mode, ``config.use_f64``) and in float32, with
the same sample streams: the counter hash emits float32 in both modes,
cast to the dtype, so every light pick, jitter and wavelength decision
matches.  It reports

- the per-spectral-bin radiance error of float32 against float64 (max,
  p99.9 and mean) on stable rays, and the rays whose float32 closest hit
  picks another primitive (a coplanar tie, an edge), an O(emission)
  difference, as the count ``flipped_rays``;
- the gradient of a pixel loss mean(rgb^2) in theta, a scalar scaling
  the diffuse reflectance table ``kd``: float64 AD
  (``torch.autograd.grad``) against a float64 5-point central finite
  difference (the loss is about cubic in theta, so a 2-point stencil's
  truncation would hide the comparison), and float32 AD against float64
  AD, on stable rays whose per-bounce prims agree in both precisions
  (the others counted as ``grad_flipped_rays``).

:func:`run` covers the Cornell box: direct light for the radiance error,
the fixed-depth path tracer (depth 2) for the topology and the
gradients.  :func:`run_bvh` covers the instanced, textured blob scene
(:func:`bvh_scene`, fixed depth 3), whose float32 renders walk each
instance's BVH with K2, one query an instance, and whose float64 renders
take the plain float64 route (``accel/cuda_build.reference_route``).
The renders run on the card unless ``device`` names another device; the
float64 switch is set only inside ``try``/``finally``.

    python -m lumo_tpu_torch.tools.quality [res spp] [--device cpu]

prints one JSON line: ``run(res, spp)`` (default 64, 4) with
``run_bvh()`` (32, 2) under "bvh".
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json

import numpy as np
import torch

from lumo_tpu_torch import config, film
from lumo_tpu_torch.camera import build_camera, cornell_camera
from lumo_tpu_torch.color import wavelength
from lumo_tpu_torch.integrators import direct_light, path_trace
from lumo_tpu_torch.sampling.samplers import MASK32, _randfloat
from lumo_tpu_torch.scene import shapes
from lumo_tpu_torch.scene.cornell import cornell_box, empty_box
from lumo_tpu_torch.scene.instance import Mesh, rotate_y, scale, translation
from lumo_tpu_torch.scene.materials import Material

SCALE_KEY = "kd"        # the material table theta scales
CORNELL_DEPTH = 2       # fixed depth of the Cornell gradient renders
BVH_DEPTH = 3           # fixed depth of the blob scene's renders
FD_H = 1e-3             # finite-difference step in theta
# a ray whose largest bin differs by this much between precisions flipped
FLIP = 0.5


@contextlib.contextmanager
def precision(dtype):
    """``config.use_f64`` for renders in ``dtype`` (torch.float32 or
    torch.float64), restored on the way out."""
    was = config.float_dtype() == torch.float64
    config.use_f64(dtype == torch.float64)
    try:
        yield
    finally:
        config.use_f64(was)


def _np(dtype):
    return np.float64 if dtype == torch.float64 else np.float32


def sample_rays(cam, res, s, dtype):
    """Camera rays and draws of sample ``s`` of a res x res frame, the
    JAX harness's streams: (o, d, lam, ray_key)."""
    dev = cam.c2w_t.device
    n = res * res
    pix = torch.arange(n, dtype=torch.int64, device=dev)
    sp = (0x9E3779B9 * (s + 1)) & MASK32
    raster = torch.stack(
        [(pix % res).to(dtype) + _randfloat(pix, sp ^ 0x51633E2D).to(dtype),
         (pix // res).to(dtype) + _randfloat(pix, sp ^ 0x68BC21EB).to(dtype)],
        dim=-1)
    o, d = cam.generate_ray(raster, torch.full((n, 2), 0.5, dtype=dtype,
                                               device=dev))
    lam = wavelength.sample(_randfloat(pix, sp ^ 0x02E5BE93).to(dtype))
    key = ((pix * 2654435761) & MASK32) ^ sp
    return o, d, lam, key


def _scaled(scene, theta):
    mats = dict(scene.materials)
    mats[SCALE_KEY] = mats[SCALE_KEY] * theta
    return dataclasses.replace(scene, materials=mats)


def cornell_setup(dtype, res, device):
    """(scene, camera) of the Cornell harness in ``dtype``; call under
    :func:`precision`."""
    return (cornell_box().build(dtype=_np(dtype), device=device),
            cornell_camera(resolution=(res, res), dtype=dtype,
                           device=device))


def render_cornell(scene, cam, res, spp, theta=1.0, grad_mode=False,
                   mask=None, want_prims=False):
    """Cornell res^2 at spp -> (radiance (N, 4), loss[, prims]).
    ``grad_mode`` False: the direct-light integrator; True: the
    fixed-depth path tracer, with ``want_prims`` its (spp, depth, N)
    per-bounce prims.  ``mask`` (N,) weights the rays of the loss."""
    dtype = scene.tri_a.dtype
    sc = _scaled(scene, theta)
    wbm = film.wb_matrix("DCI-P3", "CORNELL")
    rad = rgb = 0.0
    prims = []
    for s in range(spp):
        o, d, lam, key = sample_rays(cam, res, s, dtype)
        if grad_mode:
            r, lam_out, _, pr = path_trace.integrate(
                sc, o, d, lam, ray_key=key, fixed_depth=CORNELL_DEPTH,
                trace_prims=True)
            prims.append(pr.cpu().numpy())
        else:
            r, lam_out, _ = direct_light.integrate(sc, o, d, lam, ray_key=key)
        rad = rad + r
        rgb = rgb + film.spectral_to_rgb(r, lam_out, wbm)
    rad, rgb = rad / spp, rgb / spp
    if mask is not None:
        rgb = rgb * torch.as_tensor(mask, dtype=dtype,
                                    device=rgb.device)[:, None]
    loss = torch.mean(rgb ** 2)
    if want_prims:
        return rad, loss, np.stack(prims)
    return rad, loss


def bvh_scene(dtype, device):
    """The accelerated, instanced, textured scene: two runtime instances
    of a 20,480-triangle blob (each group walked by K2 in float32) in an
    empty box over a checkerboard floor; call under :func:`precision`."""
    sb = empty_box((0.95, 0.95, 0.95), Material.diffuse((0.9, 0.1, 0.1)),
                   Material.diffuse((0.1, 0.9, 0.1)))
    checker = sb.textures.checkerboard((0.1, 0.1, 0.1), (0.9, 0.9, 0.9),
                                       8.0)
    sb.add_rectangle((-0.99, -0.795, -1.99), (0.99, -0.795, -1.99),
                     (-0.99, -0.795, -0.01),
                     Material.diffuse((1.0, 1.0, 1.0), kd_tex=checker))
    v, f, vn = shapes.blob(subdiv=5, seed=11, amp=0.22)
    mesh = Mesh(v, f, normals=vn)
    mesh.to_unit_size().to_origin()
    mats = [Material.diffuse((0.8, 0.6, 0.2)),
            Material.diffuse((0.2, 0.5, 0.8))]
    ts = [translation(-0.45, -0.45, -1.5) @ rotate_y(0.7)
          @ scale(0.6, 0.6, 0.6),
          translation(0.45, -0.5, -1.2) @ scale(0.5, 0.5, 0.5)]
    mesh.add_instances_to(sb, ts, mats)
    return sb.build(dtype=_np(dtype), device=device)


def bvh_setup(dtype, res, device):
    """(scene, camera) of the blob harness in ``dtype``."""
    return (bvh_scene(dtype, device),
            build_camera(resolution=(res, res), dtype=dtype, device=device))


def render_bvh(scene, cam, res, spp, theta=1.0, mask=None):
    """(radiance (N, 4), loss mean(rad^2)) of the blob scene, fixed depth
    ``BVH_DEPTH``; theta's gradient passes the opaque group walks through
    the differentiable hit distance."""
    dtype = scene.tri_a.dtype
    sc = _scaled(scene, theta)
    rad = 0.0
    for s in range(spp):
        o, d, lam, key = sample_rays(cam, res, s, dtype)
        r, _, _ = path_trace.integrate(sc, o, d, lam, ray_key=key,
                                       fixed_depth=BVH_DEPTH)
        rad = rad + r
    rad = rad / spp
    lrad = rad if mask is None else rad * torch.as_tensor(
        mask, dtype=dtype, device=rad.device)[:, None]
    return rad, torch.mean(lrad ** 2)


def _errors(rad32, rad64):
    """(stable rays, continuous error stats) of float32 against float64."""
    r64 = rad64.detach().cpu().numpy()
    err = np.abs(rad32.detach().cpu().numpy().astype(np.float64) - r64)
    stable = err.max(axis=1) < FLIP
    err_s = err[stable]
    rel = err_s / (np.abs(r64[stable]) + 1e-3)
    return stable, {
        "flipped_rays": int((~stable).sum()), "rays": int(stable.size),
        "bin_abs_err_max": float(err_s.max()),
        "bin_abs_err_mean": float(err_s.mean()),
        "bin_rel_err_p999": float(np.quantile(rel, 0.999)),
        "bin_rel_err_mean": float(rel.mean()),
    }


def _ad(render, dtype, device):
    """d(loss)/d(theta) at theta = 1 by reverse-mode AD."""
    theta = torch.ones((), dtype=dtype, device=device, requires_grad=True)
    (g,) = torch.autograd.grad(render(theta)[1], theta)
    return float(g)


def _fd(render, fd_h):
    """The 5-point central finite difference of the loss at theta = 1."""
    f = lambda th: float(render(th)[1])
    return ((8.0 * (f(1.0 + fd_h) - f(1.0 - fd_h))
             - (f(1.0 + 2 * fd_h) - f(1.0 - 2 * fd_h))) / (12.0 * fd_h))


def _grads(g32, g64, g_fd):
    return {
        "pixel_grad_ad_f32": g32,
        "pixel_grad_ad_f64": g64,
        "pixel_grad_fd_f64": g_fd,
        # AD against FD on the same float64 estimator: the correctness of
        # the reverse-mode machinery
        "grad_ad_vs_fd_rel_err": abs(g64 - g_fd) / (abs(g_fd) + 1e-12),
        # float32 AD against float64 AD on stable rays: the production
        # path's precision gap
        "grad_f32_vs_ref_rel_err": abs(g32 - g64) / (abs(g64) + 1e-12),
    }


def run(res=64, spp=4, fd_h=FD_H, device=None):
    """The Cornell harness (``tools/quality.py::run``'s keys)."""
    device = config.resolve_device(device)
    f32, f64 = torch.float32, torch.float64
    with precision(f32):
        sc32, cam32 = cornell_setup(f32, res, device)
        rad32, _ = render_cornell(sc32, cam32, res, spp)
        _, _, pr32 = render_cornell(sc32, cam32, res, spp, grad_mode=True,
                                    want_prims=True)
    with precision(f64):
        sc64, cam64 = cornell_setup(f64, res, device)
        rad64, _ = render_cornell(sc64, cam64, res, spp)
        _, _, pr64 = render_cornell(sc64, cam64, res, spp, grad_mode=True,
                                    want_prims=True)
    stable, out = _errors(rad32, rad64)
    # rays whose float32 bounce hits another prim than float64 (a sampled
    # direction crossing an edge, the light quad coplanar with the
    # ceiling) carry O(1) gradient differences: masked out and counted
    topo = (pr32 == pr64).all(axis=(0, 1))
    mask = stable & topo

    with precision(f64):
        ren64 = lambda th: render_cornell(sc64, cam64, res, spp, th, True,
                                          mask)
        g_fd = _fd(ren64, fd_h)
        g64 = _ad(ren64, f64, device)
    with precision(f32):
        g32 = _ad(lambda th: render_cornell(sc32, cam32, res, spp, th, True,
                                            mask), f32, device)
    return {"res": res, "spp": spp, "scale_key": SCALE_KEY, **out,
            "grad_flipped_rays": int((stable & ~topo).sum()),
            **_grads(g32, g64, g_fd)}


def run_bvh(res=32, spp=2, fd_h=FD_H, device=None):
    """The blob-scene harness (``tools/quality.py::run_bvh``'s keys)."""
    device = config.resolve_device(device)
    f32, f64 = torch.float32, torch.float64
    with precision(f32):
        sc32, cam32 = bvh_setup(f32, res, device)
        rad32, _ = render_bvh(sc32, cam32, res, spp)
    with precision(f64):
        sc64, cam64 = bvh_setup(f64, res, device)
        rad64, _ = render_bvh(sc64, cam64, res, spp)
    stable, out = _errors(rad32, rad64)
    with precision(f32):
        g32 = _ad(lambda th: render_bvh(sc32, cam32, res, spp, th, stable),
                  f32, device)
    with precision(f64):
        ren64 = lambda th: render_bvh(sc64, cam64, res, spp, th, stable)
        g64 = _ad(ren64, f64, device)
        g_fd = _fd(ren64, fd_h)
    return {"res": res, "spp": spp, **out, **_grads(g32, g64, g_fd)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("res", type=int, nargs="?", default=64)
    ap.add_argument("spp", type=int, nargs="?", default=4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    out = run(args.res, args.spp, device=args.device)
    out["bvh"] = run_bvh(device=args.device)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
