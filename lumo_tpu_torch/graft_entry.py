"""Driver entry points of the port: a one-device forward step and the
multi-device dryrun of the full differentiable training step
(counterpart of the JAX package's ``__graft_entry__.py``).

``entry()`` returns a forward render step on the flagship workload (64
rays of the Cornell box, fixed depth 4) with its arguments.
``dryrun_multichip(n)`` starts n processes, one a device, joined by
``torch.distributed`` (``parallel.distributed``), and runs on each, over
the rich scene (a 1,282-triangle blob through the BVH, a disk light and
the box's triangle light):

- one training step: render -> loss -> gradients of the float material
  tables (the "weights") -> ``pmean`` -> SGD update, the rays split into
  contiguous blocks, one a rank (:func:`train_step`);
- a BDPT film whose light-traced splats land anywhere on the film, so
  the ranks' films are ``psum``'d (:func:`bdpt_film`);
- the 1 -> n scaling protocol: rays/s per device of ``Renderer`` steps
  through ``mesh.shard_step`` over the first 1, 2, 4 and 8 ranks
  (:func:`scaling`).

JAX's ``jax.random`` keys become explicit ``torch.Generator``s, drawn on
the CPU so that a seed gives the same draws on every device: the training
step's wavelengths come from a generator seeded by (TRAIN_SEED, rank), as
``fold_in(key, me)`` gives each JAX shard its own; the BDPT film's from
one generator over all ray ids, of which each rank takes its block, so
that the film does not depend on the split (JAX draws the same numbers in
every shard instead).

Run it as ``python -m lumo_tpu_torch.graft_entry [dryrun N] [--cpu]
[--res R]``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from lumo_tpu_torch.config import resolve_device

ENTRY_RAYS = 64
ENTRY_DEPTH = 4
LOSS_DEPTH = 2
BDPT_VERTS = 3
LR = 1e-3             # the SGD step on the material tables
TRAIN_SEED = 0        # the JAX dryrun's PRNGKey(0)
BDPT_SEED = 1         # its PRNGKey(1)
SCALING_SEED = 7      # its Renderer(...).seed(7)
SCALING_SPP = 4
SCALING_DEVICES = (1, 2, 4, 8)
WB = ("DCI-P3", "CORNELL")
RANK_TIMEOUT_S = 900  # the longest wait for the ranks of a dryrun


def tiny_scene_camera(res=8, device=None):
    """The Cornell box (32 triangles, the dense path) and its camera."""
    from lumo_tpu_torch.camera import cornell_camera
    from lumo_tpu_torch.scene.cornell import cornell_box
    dev = resolve_device(device)
    return (cornell_box().build(device=dev),
            cornell_camera(resolution=(res, res), device=dev))


def rich_scene_camera(res=8, device=None):
    """The dryrun scene, covering what ``Renderer.devices()`` ships: a
    BVH-accelerated mesh (1,282 triangles with the box's), an analytic
    disk light and the box's triangle light."""
    from lumo_tpu_torch.camera import build_camera
    from lumo_tpu_torch.scene import shapes
    from lumo_tpu_torch.scene.cornell import empty_box
    from lumo_tpu_torch.scene.instance import Mesh
    from lumo_tpu_torch.scene.materials import Material
    dev = resolve_device(device)
    sb = empty_box((0.9, 0.9, 0.9), Material.diffuse((0.8, 0.2, 0.2)),
                   Material.diffuse((0.2, 0.8, 0.2)))
    v, f, vn = shapes.blob(subdiv=3, seed=5, amp=0.2)
    (Mesh(v, f, normals=vn).to_unit_size().to_origin().set_y(-0.5)
     .translate(0.0, 0.0, -1.2)
     .add_to(sb, Material.metal((0.9, 0.7, 0.2), 0.3, 2.5, 3.0)))
    sb.add_disk((0.6, 0.5, -1.0), (-0.5, -0.6, 0.2), 0.25,
                Material.light((1.0, 0.9, 0.7), scale=3.0))
    scene = sb.build(accel="bvh", device=dev)
    assert scene.bvh is not None, "dryrun mesh must exercise the BVH"
    assert scene.n_analytic > 0
    return scene, build_camera(resolution=(res, res), device=dev)


def _generator(*seeds):
    """A CPU generator seeded by the tuple ``seeds``."""
    s = 0x9E3779B97F4A7C15
    for x in seeds:
        s = (s * 0x100000001B3 ^ (int(x) & 0xFFFFFFFF)) & ((1 << 63) - 1)
    return torch.Generator().manual_seed(s)


def entry(device=None):
    """(fn, args): ``fn(o, d, lam, ray_key=None)`` -> radiance (64, 4) of
    ``path_trace.integrate(..., fixed_depth=4)`` on the Cornell box;
    ``args`` = (o, d, lam) of 64 random camera rays.  Without
    ``ray_key`` the per-ray keys are drawn from a generator seeded 0."""
    from lumo_tpu_torch.color import wavelength
    from lumo_tpu_torch.integrators import path_trace
    scene, camera = tiny_scene_camera(8, device)
    dev = scene.device

    def fwd(o, d, lam, ray_key=None):
        if ray_key is None:
            ray_key = path_trace.ray_keys(_generator(TRAIN_SEED), o.shape[0],
                                          device=o.device)
        return path_trace.integrate(scene, o, d, lam, ray_key=ray_key,
                                    fixed_depth=ENTRY_DEPTH)[0]

    g = _generator(TRAIN_SEED)
    raster = torch.rand((ENTRY_RAYS, 2), generator=g) * 8.0
    u = torch.rand((ENTRY_RAYS, 2), generator=g)
    lam = wavelength.sample(torch.rand(ENTRY_RAYS, generator=g))
    o, d = camera.generate_ray(raster.to(dev), u.to(dev))
    return fwd, (o, d, lam.to(dev))


def float_tables(scene):
    """The float tables of the scene's material table: the weights."""
    return {k: v for k, v in scene.materials.items() if v.is_floating_point()}


def pixel_rays(camera, ray_ids):
    """(raster, o, d, pixel) of the pixel centres of ``ray_ids`` (modulo
    the pixel count), with the lens sample 0.5."""
    w, h = camera.resolution
    pix = ray_ids % (w * h)
    raster = torch.stack([(pix % w).float() + 0.5,
                          (pix // w).float() + 0.5], -1)
    o, d = camera.generate_ray(raster, torch.full_like(raster, 0.5))
    return raster, o, d, pix


def _k2_launches():
    from lumo_tpu_torch.accel import bvh_kernel
    return {k: bvh_kernel.LAUNCHES[k] for k in ("closest", "any")}


def loss_and_grads(scene, camera, mat_float, ray_ids, lam, ray_key,
                   launches=None):
    """(loss, grads) of the dryrun's loss with respect to ``mat_float``
    (the float material tables): each ray of ``ray_ids`` at its pixel's
    centre, ``path_trace.integrate(..., fixed_depth=2)``, the spectral
    radiance to RGB with ``wb_matrix("DCI-P3", "CORNELL")``, scattered
    through a square filter into a new film; the loss is the sum of the
    squared colour accumulation (target 0) over the pixel count.  With a
    dict ``launches``, K2's launches of the forward and of the backward
    are added under ``"fwd"`` and ``"bwd"``."""
    from lumo_tpu_torch import film as film_mod
    from lumo_tpu_torch.integrators import path_trace
    w, h = camera.resolution
    n_pix = w * h
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in mat_float.items()}
    sc = dataclasses.replace(scene, materials={**scene.materials, **leaves})
    before = _k2_launches()
    raster, o, d, _ = pixel_rays(camera, ray_ids)
    radiance, lam_out, _ = path_trace.integrate(
        sc, o, d, lam, ray_key=ray_key, fixed_depth=LOSS_DEPTH)
    rgb = film_mod.spectral_to_rgb(radiance, lam_out,
                                   film_mod.wb_matrix(*WB))
    film = film_mod.new_film((w, h), device=o.device)
    film_mod.add_samples(film, film_mod.PixelFilter.square(), raster, rgb,
                         (w, h))
    loss = (film[0] ** 2).sum() / n_pix
    mid = _k2_launches()
    g = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    if launches is not None:
        after = _k2_launches()
        for part, (a, b) in (("fwd", (before, mid)), ("bwd", (mid, after))):
            acc = launches.setdefault(part, {k: 0 for k in a})
            for k in a:
                acc[k] += b[k] - a[k]
    grads = {k: torch.zeros_like(v) if gk is None else gk
             for (k, v), gk in zip(leaves.items(), g)}
    return loss.detach(), grads


def block(mesh, n):
    """This rank's contiguous block of ``arange(n)``, as ``P(AXIS)``
    splits it."""
    if n % mesh.size:
        raise ValueError(f"{n} rays do not divide over {mesh.size} ranks")
    per = n // mesh.size
    return torch.arange(mesh.rank * per, (mesh.rank + 1) * per,
                        dtype=torch.int64)


def train_wavelengths(rank, n, device):
    """The hero wavelengths (n, 4) of rank ``rank``'s training rays:
    from a generator seeded by (TRAIN_SEED, rank)."""
    from lumo_tpu_torch.color import wavelength
    u = torch.rand(n, generator=_generator(TRAIN_SEED, rank, 3))
    return wavelength.sample(u).to(device)


def train_step(mesh, scene, camera, mat_float, launches=None):
    """One sharded training step: this rank's block of the pixels, its
    loss and gradients (:func:`loss_and_grads`, ray keys the pixel ids),
    both ``pmean``'d over the mesh, and the SGD update ``v - LR g`` of
    every table.  Returns (loss, new tables, gradients), the same on every
    rank."""
    from lumo_tpu_torch.parallel import mesh as mesh_mod
    w, h = camera.resolution
    dev = scene.device
    ray_ids = block(mesh, w * h).to(dev)
    lam = train_wavelengths(mesh.rank, ray_ids.shape[0], dev)
    loss, grads = loss_and_grads(scene, camera, mat_float, ray_ids, lam,
                                 ray_ids, launches=launches)
    loss, grads = mesh_mod.pmean((loss, grads), mesh)
    new = {k: v.detach() - LR * grads[k] for k, v in mat_float.items()}
    return loss, new, grads


def bdpt_film(mesh, scene, camera):
    """The BDPT film of one sample per pixel (``bdpt.integrate(...,
    max_verts=3)``, square filter, the splats in their ``(reps, N, ...)``
    layout added to the splat buffer), this rank's block of the pixels,
    ``psum``'d over the mesh: (color, weight, splat)."""
    from lumo_tpu_torch import film as film_mod
    from lumo_tpu_torch.color import wavelength
    from lumo_tpu_torch.integrators import bdpt
    from lumo_tpu_torch.parallel import mesh as mesh_mod
    w, h = camera.resolution
    dev = scene.device
    ids = block(mesh, w * h)
    lam = wavelength.sample(torch.rand(w * h, generator=_generator(BDPT_SEED, 5))
                            [ids]).to(dev)
    raster, o, d, pix = pixel_rays(camera, ids.to(dev))
    wbm = film_mod.wb_matrix(*WB)
    filt = film_mod.PixelFilter.square()
    with torch.no_grad():
        r, lam_out, sr, sc, sm, _ = bdpt.integrate(
            scene, camera, o, d, lam, ray_key=pix, max_verts=BDPT_VERTS)
        film = film_mod.new_film((w, h), device=dev)
        film_mod.add_samples(film, filt, raster,
                             film_mod.spectral_to_rgb(r, lam_out, wbm), (w, h))
        reps = sr.shape[0]
        lam_s = lam_out.expand((reps,) + lam_out.shape).reshape(-1, 4)
        rgb_s = film_mod.spectral_to_rgb(sc.reshape(-1, 4), lam_s, wbm)
        film_mod.add_samples(film, filt, sr.reshape(-1, 2), rgb_s, (w, h),
                             splat=True, mask=sm.reshape(-1))
    return mesh_mod.psum(film, mesh)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def scaling(mesh, scene, camera):
    """The scaling protocol: for nd in 1, 2, 4, 8 up to the mesh size, the
    first nd ranks (``mesh.sub_mesh``) run ``Renderer(scene,
    camera).samples(4).seed(7)``'s one-sample work through
    ``mesh.shard_step`` over all pixels, one warm-up step and one timed
    one.  Returns {str(nd): rays/s per device} on the ranks that took part
    in every count (rank 0), a partial dict on the others.  Every rank of
    the process group must call it."""
    import torch.distributed as dist
    from lumo_tpu_torch import film as film_mod
    from lumo_tpu_torch.parallel import mesh as mesh_mod
    from lumo_tpu_torch.renderer import Renderer
    w, h = camera.resolution
    dev = scene.device
    out = {}
    for nd in SCALING_DEVICES:
        if nd > mesh.size:
            break
        sub = mesh_mod.sub_mesh(mesh, nd)
        if sub is None:
            continue
        r = Renderer(scene, camera).samples(SCALING_SPP).seed(SCALING_SEED)
        step = mesh_mod.shard_step(sub, r._make_work(1, SCALING_SPP), w * h)
        film0 = film_mod.new_film((w, h), device=dev)
        stats0 = r.new_stats(w * h)
        step(film0, stats0, 0)
        _sync(dev)
        t0 = time.perf_counter()
        rays = int(step(film0, stats0, 0)[2])
        _sync(dev)
        out[str(nd)] = rays / (time.perf_counter() - t0) / nd
    if mesh.group is not None:
        dist.barrier(group=mesh.group)
    return out


def l1(tensors):
    return float(sum(float(x.abs().sum()) for x in tensors))


def run_dryrun(mesh, res=8):
    """What one rank of :func:`dryrun_multichip` computes on ``mesh`` (on
    its device): the rich scene's training step, the BDPT film and the
    scaling protocol, with the K2 launches of the step's forward and
    backward."""
    dev = mesh.device
    scene, camera = rich_scene_camera(res, dev)
    mats = float_tables(scene)
    launches = {}
    loss, new, grads = train_step(mesh, scene, camera, mats,
                                  launches=launches)
    film = bdpt_film(mesh, scene, camera)
    rates = scaling(mesh, scene, camera)
    return {"loss": float(loss), "params_l1": l1(new.values()),
            "bdpt_film_l1": l1(film),
            "new_mats": {k: v.cpu() for k, v in new.items()},
            "grads": {k: v.cpu() for k, v in grads.items()},
            "film": tuple(x.cpu() for x in film), "scaling": rates,
            "launches": launches, "rank": mesh.rank,
            "device": str(dev), "n_tris": scene.n_tris}


def _dryrun_rank(rank, world, init_url, out_dir, devices, res, backend):
    """One spawned rank on ``devices[rank]``: join the group,
    :func:`run_dryrun`, save it to ``out_dir/rank{rank}.pt``."""
    from lumo_tpu_torch.parallel import distributed
    from lumo_tpu_torch.parallel import mesh as mesh_mod
    device = devices[rank]
    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)
    else:
        torch.backends.cuda.matmul.allow_tf32 = False
    distributed.initialize(coordinator=init_url, num_processes=world,
                           process_id=rank, backend=backend, device=device)
    try:
        out = run_dryrun(mesh_mod.make_mesh(), res)
        out["backend"] = torch.distributed.get_backend()
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        distributed.shutdown()


def rank_layout(n, device=None):
    """(rank devices, backend) of an n-rank dryrun: on the CPU, gloo; on
    the card, NCCL when every rank has its own card, else gloo with the
    ranks sharing one (NCCL refuses two ranks on one card)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        devices = [str(dev)] * n
    elif dev.index is None and torch.cuda.device_count() >= n:
        devices = [f"cuda:{r}" for r in range(n)]
    else:
        index = torch.cuda.current_device() if dev.index is None else dev.index
        devices = [f"cuda:{index}"] * n
    own = dev.type == "cuda" and len(set(devices)) == n
    return devices, "nccl" if own and n > 1 else "gloo"


def dryrun_multichip(n_devices: int, device=None, res=8) -> dict:
    """Run the full sharded training step, the sharded BDPT film and the
    scaling protocol over ``n_devices`` ranks, one process each (spawned
    here, joined through a ``file://`` rendezvous), on the card unless
    ``device`` names another (``"cpu"``: gloo ranks on the CPU).  The
    backend is gloo unless every rank has its own card (then NCCL).
    Checks that the ranks agree; returns rank 0's results with every
    rank's under ``"ranks"``, and prints the scaling line and the summary
    line of the JAX package's dryrun."""
    from lumo_tpu_torch.parallel import distributed
    n = int(n_devices)
    devices, backend = rank_layout(n, device)
    with tempfile.TemporaryDirectory() as tmp:
        distributed.spawn_ranks(_dryrun_rank, n, (
            f"file://{tmp}/rendezvous", tmp, devices, res, backend),
            RANK_TIMEOUT_S)
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                            weights_only=False) for r in range(n)]
    first = ranks[0]
    for out in ranks[1:]:
        same = (out["loss"] == first["loss"]
                and all(torch.equal(out["grads"][k], first["grads"][k])
                        for k in first["grads"])
                and all(torch.equal(a, b)
                        for a, b in zip(out["film"], first["film"])))
        if not same:
            raise AssertionError(f"dryrun: rank {out['rank']} disagrees "
                                 f"with rank 0")
    if not np.isfinite(first["bdpt_film_l1"]):
        raise AssertionError("BDPT sharded film not finite")
    result = {k: first[k] for k in ("loss", "params_l1", "bdpt_film_l1",
                                    "scaling")}
    result.update(backend=backend, devices=devices, ranks=ranks)
    print("scaling_rays_per_s_per_device:",
          json.dumps({k: round(v, 1) for k, v in first["scaling"].items()}))
    print(f"dryrun_multichip({n}): loss={first['loss']:.6f} "
          f"params_l1={first['params_l1']:.3f} "
          f"bdpt_film_l1={first['bdpt_film_l1']:.3f} OK", flush=True)
    return result


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m lumo_tpu_torch.graft_entry",
        description="The port's entry step, or with 'dryrun N' the "
                    "sharded training step over N ranks.")
    p.add_argument("mode", nargs="?", default="entry",
                   choices=("entry", "dryrun"))
    p.add_argument("n", nargs="?", type=int, default=8)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (gloo ranks) instead of the card")
    p.add_argument("--res", type=int, default=8)
    args = p.parse_args(argv)
    device = "cpu" if args.cpu else None
    if args.mode == "dryrun":
        dryrun_multichip(args.n, device=device, res=args.res)
    else:
        fn, fargs = entry(device)
        out = fn(*fargs)
        print("entry OK", tuple(out.shape), float(out.sum()))
    return 0


if __name__ == "__main__":
    # through the imported module, so that spawned ranks unpickle its
    # functions by their module's name
    from lumo_tpu_torch import graft_entry
    sys.exit(graft_entry.main())
