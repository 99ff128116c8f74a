"""Ranks of the port's multi-process tests (``tests/test_torch_parallel.py``
and, on the card, ``tests/test_torch_cuda.py``), the counterpart of
``tests/_distributed_worker.py``.  Imports neither JAX nor lumo_tpu.

The rank functions run in processes started by :func:`spawn` (the spawn
method: a fresh interpreter, so the functions are module-level and their
arguments picklable); each joins a gloo group through a ``file://``
rendezvous in a temporary directory, so concurrent test workers share no
port, and writes what it computed to ``out_dir/rank{r}.pt``.

Run as a script (``python _torch_shard_worker.py PORT RANK``), it is one
of two processes that join through ``localhost:PORT`` and print the
checksum of the default ``Renderer``'s image over the world.
"""
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from lumo_tpu_torch.parallel import distributed  # noqa: E402

RES = 16
SPP = 4
SEED = 5
BATCH = 2             # samples a step: two steps, the second's adaptive
                      # Russian roulette from the first's summed stats
INTEGRATORS = ("path", "direct", "stream", "bdpt")
# the longest wait for the ranks of one test
SPAWN_TIMEOUT_S = 240


def spawn(fn, world, *args):
    """Run ``fn(rank, world, *args)`` in ``world`` spawned processes and
    wait for all (``chip_smoke.spawn_ranks``: a rank that raises stops the
    others and raises here; ranks still running after SPAWN_TIMEOUT_S
    seconds are stopped)."""
    import chip_smoke
    chip_smoke.spawn_ranks(fn, world, args, SPAWN_TIMEOUT_S)


def cornell(dev):
    from lumo_tpu_torch.camera import cornell_camera
    from lumo_tpu_torch.scene.cornell import cornell_box
    return (cornell_box().build(device=dev),
            cornell_camera(resolution=(RES, RES), device=dev))


def empty_box(dev):
    """``tests/test_torch_renderer.py``'s dense scene: the empty Cornell
    box (its light off the ceiling's plane)."""
    from lumo_tpu_torch.camera import build_camera
    from lumo_tpu_torch.scene.cornell import empty_box
    from lumo_tpu_torch.scene.materials import Material
    sb = empty_box((0.9, 0.9, 0.9), Material.diffuse((0.8, 0.2, 0.2)),
                   Material.diffuse((0.2, 0.8, 0.2)))
    return (sb.build(device=dev),
            build_camera(resolution=(RES, RES), device=dev))


def renderer(scene, camera, kind, spp=SPP, seed=SEED):
    """The Renderer of one of ``INTEGRATORS`` in steps of ``BATCH``
    samples; ``stream`` is the path integrator's persistent wavefront
    with the fixed Russian-roulette threshold 1 (its adaptive one follows
    each rank's own running stats), ``stream-adaptive`` with the
    adaptive one."""
    from lumo_tpu_torch.renderer import Renderer
    r = Renderer(scene, camera).samples(spp).seed(seed)
    if kind == "stream":
        return r.stream().fixed_rr_delta(1.0)
    if kind == "stream-adaptive":
        return r.stream()
    return r.integrator(kind).batch_samples(BATCH)


def grad_rays(camera, n):
    """``tests/test_parallel.py::_rays``: pixel centres, a wavelength and a
    key per pixel."""
    from lumo_tpu_torch.color import wavelength
    from lumo_tpu_torch.sampling.samplers import _hash_u32, _randfloat
    pix = torch.arange(n, dtype=torch.int64, device=camera.c2w_t.device)
    raster = torch.stack([(pix % RES).float() + 0.5,
                          (pix // RES).float() + 0.5], -1)
    o, d = camera.generate_ray(raster, torch.full_like(raster, 0.5))
    lam = wavelength.sample(_randfloat(pix, 17))
    return o, d, lam, _hash_u32(pix ^ 0xA511E9B3)


def r2_grads(scene, o, d, lam, key, weight=None):
    """Gradients of mean(r^2) at fixed depth 2 in every float leaf of the
    material table (``test_sharded_grads_pmean_correct``'s loss); with
    ``weight`` (N,), of mean(weight r^2)."""
    import dataclasses
    from lumo_tpu_torch.integrators import path_trace
    mats = {k: v.detach().clone().requires_grad_(True)
            for k, v in scene.materials.items() if v.is_floating_point()}
    s2 = dataclasses.replace(scene, materials={**scene.materials, **mats})
    r2 = path_trace.integrate(s2, o, d, lam, ray_key=key,
                              fixed_depth=2)[0] ** 2
    if weight is not None:
        r2 = weight[:, None] * r2
    g = torch.autograd.grad(r2.mean(), list(mats.values()),
                            allow_unused=True)
    return {k: torch.zeros_like(v) if gk is None else gk
            for (k, v), gk in zip(mats.items(), g)}


def render_ranks(rank, world, init_url, out_dir, weight):
    """One CPU rank: the Cornell box through ``.devices(world)`` for each
    integrator and through the default Renderer, the empty box's path
    image, the pmean of this rank's block of the gradient (unweighted and
    with ``weight``, a numpy (RES^2,) array), the process summary, the
    refusals of a scene on another device and of ranks that render
    different seeds; then :func:`external_group`."""
    from lumo_tpu_torch.parallel import mesh as mesh_mod
    from lumo_tpu_torch.renderer import Renderer
    torch.set_num_threads(1)
    distributed.initialize(coordinator=init_url, num_processes=world,
                           process_id=rank, device="cpu")
    try:
        scene, camera = cornell("cpu")
        kinds = INTEGRATORS + ("stream-adaptive",)
        out = {"images": {k: renderer(scene, camera, k).devices(world)
                          .render(verbose=False) for k in kinds},
               "default": renderer(scene, camera, "path").render(
                   verbose=False),
               "empty_box": renderer(*empty_box("cpu"), "path")
               .devices(world).render(verbose=False)}
        mesh = mesh_mod.make_mesh()
        n = RES * RES
        block = slice(rank * n // world, (rank + 1) * n // world)
        rays = [x[block] for x in grad_rays(camera, n)]
        out["grads"] = mesh_mod.pmean(r2_grads(scene, *rays), mesh)
        out["grads_weighted"] = mesh_mod.pmean(
            r2_grads(scene, *rays, weight=torch.as_tensor(weight)[block]),
            mesh)
        out["summary"] = distributed.process_summary()
        out["multi"] = distributed.is_multi_process()
        from lumo_tpu_torch.camera import cornell_camera
        try:
            Renderer(scene.to("meta"),
                     cornell_camera(resolution=(RES, RES), device="meta")
                     ).devices(world).render(verbose=False)
        except ValueError as e:
            out["other_device"] = str(e)
        try:    # each rank another seed
            renderer(scene, camera, "path", seed=SEED + rank).devices(
                world).render(verbose=False)
        except ValueError as e:
            out["disagree"] = str(e)
    finally:
        distributed.shutdown()
    out["external"] = external_group(rank, world, init_url + "-ext")
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


def external_group(rank, world, init_url):
    """The path image of the default Renderer (over the world) and of
    ``.devices(1)`` (this rank alone) in a group joined by
    ``torch.distributed.init_process_group``, as torchrun's programs
    join it, not by ``distributed.initialize``."""
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=init_url, rank=rank,
                            world_size=world, timeout=distributed.TIMEOUT)
    try:
        scene, camera = cornell("cpu")
        return {"default": renderer(scene, camera, "path").render(
                    verbose=False),
                "one": renderer(scene, camera, "path").devices(1).render(
                    verbose=False)}
    finally:
        dist.destroy_process_group()


def bench_ranks(rank, world, init_url, out_dir, res):
    """One gloo rank on ``cuda:0`` (ranks share the card): the bench scene
    (``chip_smoke.bench_scene``, 327,692 triangles) through
    ``.devices(world)``, path integrator, ``SPP`` samples at ``res``^2,
    and the K2 launches it made."""
    import chip_smoke
    from lumo_tpu_torch.accel import bvh_kernel
    from lumo_tpu_torch.camera import build_camera
    from lumo_tpu_torch.renderer import Renderer
    distributed.initialize(coordinator=init_url, num_processes=world,
                           process_id=rank, backend="gloo", device="cuda:0")
    try:
        dev = distributed.device()
        scene = chip_smoke.bench_scene(dev)
        camera = build_camera(resolution=(res, res), device=dev)
        before = dict(bvh_kernel.LAUNCHES)
        img = Renderer(scene, camera).samples(SPP).devices(world).render(
            verbose=False)
        launches = {k: bvh_kernel.LAUNCHES[k] - before[k] for k in before}
        torch.save({"image": img, "launches": launches},
                   os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        distributed.shutdown()


def main(port, rank):
    """One of two processes joined through ``localhost:port``: the
    default Renderer (its devices the world size) over the Cornell box,
    8 spp, seed 7, and the image's checksum."""
    torch.set_num_threads(1)
    distributed.initialize(coordinator=f"localhost:{port}", num_processes=2,
                           process_id=rank, device="cpu")
    try:
        print(distributed.process_summary(), file=sys.stderr)
        scene, camera = cornell("cpu")
        img = renderer(scene, camera, "path", spp=8, seed=7).render(
            verbose=False).astype("float64")
        print(f"CHECKSUM {img.sum():.9e} {abs(img).max():.9e}", flush=True)
    finally:
        distributed.shutdown()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]))
