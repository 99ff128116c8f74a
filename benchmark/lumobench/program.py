"""The system under test, driven through its public entry points: the
scene builder, the camera, ``Renderer`` and ``path_trace.integrate``.
The benchmark hands it the raw scene groups, the camera arguments, the
configuration's renderer settings and, for the gradient traffic, the
rays; everything else is the program's own.

What a configuration may name of the program, each checked against its
reference (``cells.admit``) before anything is built:

- ``RENDER_SETTINGS``: the one-argument ``Renderer`` methods that its
  ``render`` object may hold, applied after ``samples`` and ``seed``;
  without the object the renderer's defaults (``DEFAULT_INTEGRATOR``).
- ``MATERIAL_KINDS``: the ``Material`` constructors a group's material
  spec may name by ``kind``, its other keys the constructor's own
  parameters (lambertian's ``spec`` is ``kd``; no texture ids), a
  value ``{"srgb8": [r, g, b]}`` the uplift of that 8-bit sRGB colour."""
from __future__ import annotations

import contextlib
import dataclasses
import inspect
import sys

import torch

RENDER_SETTINGS = ("integrator", "bdpt_depth")
DEFAULT_INTEGRATOR = "path"         # the Renderer's own default
MATERIAL_KINDS = ("lambertian", "diffuse", "metal", "transparent", "mirror",
                  "glass", "light")


def _material(spec: dict):
    from lumo_tpu_torch.color import uplift
    from lumo_tpu_torch.scene.materials import Material
    kind = spec["kind"]
    if kind not in MATERIAL_KINDS:
        raise ValueError(f"unknown material kind {kind!r}")
    make = getattr(Material, kind)
    # a key is the constructor's parameter; lambertian's ``spec`` keeps
    # the configurations' key ``kd``
    keys = {"kd" if p == "spec" else p: p
            for p in inspect.signature(make).parameters
            if not p.endswith("_tex")}
    args = {k: v for k, v in spec.items() if k != "kind"}
    if set(args) - set(keys):
        raise ValueError(f"material kind {kind!r} takes no "
                         f"{sorted(set(args) - set(keys))}")
    return make(**{keys[k]: uplift.from_srgb8(*v["srgb8"]).reshape(4)
                   if isinstance(v, dict) else v for k, v in args.items()})


def build_scene(groups, accel: str, device):
    """The program's scene of the raw groups, one material row a group;
    the builder's progress lines go to standard error."""
    from lumo_tpu_torch.scene.scene import SceneBuilder
    sb = SceneBuilder()
    for g in groups:
        n = g.get("n")
        sb.add_triangles(g["v"], g["f"], _material(g["material"]), normals=n,
                         vertex_normal_idx=None if n is None else g["f"])
    with contextlib.redirect_stdout(sys.stderr):
        return sb.build(accel=accel, device=device)


def build_camera(args: dict, resolution, device):
    from lumo_tpu_torch.camera import build_camera as build
    return build(resolution=tuple(resolution), device=device,
                 **{k: tuple(v) if isinstance(v, list) else v
                    for k, v in args.items()})


def render_pass(scene, camera, spp: int, seed: int, **settings):
    """One progressive pass through the system's normal entry, with the
    configuration's renderer ``settings`` (``RENDER_SETTINGS``) applied
    after ``samples`` and ``seed``; the image is copied back to the host,
    as a user's program does."""
    from lumo_tpu_torch.renderer import Renderer
    r = Renderer(scene, camera).samples(spp).seed(seed)
    for key, value in settings.items():
        r = getattr(r, key)(value)
    return r.render(verbose=False)


def grad_leaves(scene):
    """The scene with its float material tables as leaves that require
    grad: (scene, {table: leaf})."""
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in scene.materials.items() if v.is_floating_point()}
    return (dataclasses.replace(scene,
                                materials={**scene.materials, **leaves}),
            leaves)


def loss_fn(spec: dict):
    """The configuration's loss over the program's colour conversion."""
    from lumo_tpu_torch import film
    if spec["loss"] == "rgb2":
        m = film.wb_matrix(*spec["wb"])
        return lambda r, lam: (film.spectral_to_rgb(r, lam, m) ** 2).mean()
    if spec["loss"] == "r2":
        return lambda r, lam: (r * r).mean()
    raise ValueError(f"unknown loss {spec['loss']!r}")


def grad_step(scene, leaves, rays, depth: int, loss, spans=None):
    """One fixed-depth forward, the loss and its gradients in every leaf,
    read back to the host: (loss, {table: gradient}) as numpy.
    ``spans`` (traced runs) closes the forward and the backward each
    with a synchronize and records their seconds."""
    from lumo_tpu_torch.integrators import path_trace
    o, d, lam, key = rays
    with _span(spans, "forward"):
        r, lam_out, _ = path_trace.integrate(scene, o, d, lam, ray_key=key,
                                             fixed_depth=depth)
        value = loss(r, lam_out)
    with _span(spans, "backward"):
        grads = torch.autograd.grad(value, list(leaves.values()),
                                    allow_unused=True)
    return (float(value.detach().cpu()),
            {k: None if g is None else g.detach().cpu().numpy()
             for k, g in zip(leaves, grads)})


@contextlib.contextmanager
def _span(spans, name):
    if spans is None:
        yield
        return
    with spans.span(name, synced=True):
        yield


def k2_closest_launches() -> int:
    """K2's closest-hit launch counter."""
    from lumo_tpu_torch.accel import bvh_kernel
    return bvh_kernel.LAUNCHES["closest"]
