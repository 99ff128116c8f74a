"""The system under test, driven through its public entry points: the
scene builder, the camera, ``Renderer`` and ``path_trace.integrate``.
The benchmark hands it the raw scene groups, the camera arguments and,
for the gradient traffic, the rays; everything else is the program's
own."""
from __future__ import annotations

import contextlib
import dataclasses
import sys

import torch


def _material(spec: dict):
    from lumo_tpu_torch.color import uplift
    from lumo_tpu_torch.scene.materials import Material
    kind = spec["kind"]
    if kind == "lambertian":
        return Material.lambertian(spec["kd"])
    if kind == "diffuse":
        return Material.diffuse(spec["kd"])
    if kind == "metal":
        return Material.metal(spec["ks"], spec["roughness"], spec["eta"],
                              spec["k"])
    if kind == "light":
        ke = spec["ke"]
        if isinstance(ke, dict):
            ke = uplift.from_srgb8(*ke["srgb8"]).reshape(4)
        return Material.light(ke, scale=float(spec.get("scale", 1.0)),
                              illuminant=spec.get("illuminant", "D65"),
                              two_sided=bool(spec.get("two_sided", False)))
    raise ValueError(f"unknown material kind {kind!r}")


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


def render_pass(scene, camera, spp: int, seed: int):
    """One progressive pass through the system's normal entry; the image
    is copied back to the host, as a user's program does."""
    from lumo_tpu_torch.renderer import Renderer
    return Renderer(scene, camera).samples(spp).seed(seed).render(
        verbose=False)


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
