"""Rays split over the ranks, scene replicated, films summed with one
``all_reduce`` (counterpart of ``lumo_tpu/parallel/mesh.py``).

The JAX package shards the (pixel x sample) wavefront over a 1-D device
mesh with ``shard_map`` and ``psum``s the films.  Here the mesh is the
default process group of :mod:`lumo_tpu_torch.parallel.distributed`, one
rank a device: rank r takes the contiguous block r of the ray ids (as
``P(AXIS)`` does) and ``psum`` is ``all_reduce(SUM)`` over the group.

``Renderer.render`` builds its per-ray ``work`` function once
(``renderer.py:_make_work``) and always steps through :func:`shard_step`
(one device is the one-rank mesh, whose ``psum`` is the identity): single-
device and sharded rendering run the same function over the same
counter-based randomness, so each sample's radiance does not depend on
the split (``tests/test_torch_parallel.py``), for the path,
direct-light and bidirectional integrators alike.
"""
from __future__ import annotations

import dataclasses
import hashlib

import torch
import torch.distributed as dist

from lumo_tpu_torch.parallel import distributed

AXIS = "rays"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks a render spans: ``group`` (None for one rank alone: no
    collective), its ``size``, this process's ``rank`` and its
    ``device``."""
    group: object
    size: int
    rank: int
    device: torch.device | None


def make_mesh(n_devices=None, device=None) -> Mesh:
    """The mesh over the default process group.  ``n_devices`` None means
    the whole world (one rank without a group); 1 means this rank alone,
    with no collective, as JAX's ``make_mesh(1)`` takes the first device
    only; any other count must equal the world size (one rank a device;
    no subgroups).  The device of a mesh over the group is the one
    ``distributed.initialize`` chose, or ``device`` where the group was
    joined another way (torchrun with ``init_process_group``); a one-rank
    mesh's is ``device``."""
    n = None if n_devices is None else int(n_devices)
    if n == 1 or (n is None and not dist.is_initialized()):
        return Mesh(None, 1, 0, None if device is None
                    else torch.device(device))
    if not dist.is_initialized():
        raise ValueError(
            f"{n} devices need a process group of {n} ranks: call "
            f"lumo_tpu_torch.parallel.distributed.initialize in each of {n}"
            f" processes first")
    world = dist.get_world_size()
    if n is not None and n != world:
        raise ValueError(
            f"{n} devices over a process group of {world} ranks: one rank "
            f"drives one device, so start {n} processes and call "
            f"lumo_tpu_torch.parallel.distributed.initialize in each")
    return Mesh(dist.group.WORLD, world, dist.get_rank(),
                distributed.device(device))


def same_on_all(key: bytes | None, mesh: Mesh) -> bool:
    """Whether every rank of the mesh passed the same ``key`` (None: a
    rank that cannot take part, which agrees with no other): one
    ``all_reduce`` of max over (d, -d) of a 48-bit digest d of the key,
    so every rank gets the same answer and none is left waiting in a
    later collective."""
    if mesh.group is None:
        return True
    d = (-1.0 if key is None else float(int.from_bytes(
        hashlib.blake2b(key, digest_size=6).digest(), "big")))
    both = torch.tensor([d, -d], dtype=torch.float64, device=mesh.device)
    dist.all_reduce(both, op=dist.ReduceOp.MAX, group=mesh.group)
    return bool(both[0] == -both[1])


def psum(tree, mesh: Mesh):
    """``jax.lax.psum`` over the mesh's axis: the sum over the ranks of
    each tensor of ``tree`` (tensors, tuples, lists and dicts of them),
    as a tree of the same structure and dtypes.  One ``all_reduce`` of a
    flat copy for each dtype among the leaves (a step's tree: the float32
    film and stats, then its int64 ray count)."""
    if mesh.group is None:
        return tree
    leaves, rebuild = _flatten(tree)
    out = list(leaves)
    for dtype in dict.fromkeys(x.dtype for x in leaves):
        idx = [i for i, x in enumerate(leaves) if x.dtype == dtype]
        flat = torch.cat([leaves[i].reshape(-1) for i in idx])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.group)
        at = 0
        for i in idx:
            out[i] = flat[at:at + leaves[i].numel()].reshape(leaves[i].shape)
            at += leaves[i].numel()
    return rebuild(iter(out))


def pmean(tree, mesh: Mesh):
    """``jax.lax.pmean`` over the mesh's axis: :func:`psum` over the
    ranks divided by their number."""
    leaves, rebuild = _flatten(psum(tree, mesh))
    return rebuild(iter([x / mesh.size for x in leaves]))


def _flatten(tree):
    """(the tensors of ``tree`` in order, rebuild(iterator of tensors))."""
    leaves = []

    def walk(node):
        if isinstance(node, torch.Tensor):
            leaves.append(node)
            return lambda it: next(it)
        if isinstance(node, dict):
            parts = {k: walk(v) for k, v in node.items()}
            return lambda it: {k: f(it) for k, f in parts.items()}
        if isinstance(node, (tuple, list)):
            parts = [walk(v) for v in node]
            return lambda it: type(node)(f(it) for f in parts)
        raise TypeError(f"psum: not a tensor, tuple, list or dict: "
                        f"{type(node).__name__}")

    return leaves, walk(tree)


def shard_step(mesh: Mesh, work, n_rays: int):
    """Lift a per-ray ``work(ray_ids, sample_base, stats)`` ->
    (film_partial, stats_partial, rays) onto ``mesh``: returns
    ``step(film, stats, sample_base)`` that runs ``work`` on this rank's
    block of the ray ids, sums the partial film (color, weight, splat),
    stats and ray count over the ranks in one ``all_reduce``, and adds
    them to the accumulators (the same on every rank).

    n_rays must divide by the mesh size (the Renderer sizes its batches
    so it does)."""
    assert n_rays % mesh.size == 0, "wavefront must divide the mesh"
    per = n_rays // mesh.size
    lo = mesh.rank * per

    def step(film, stats, sample_base):
        ray_ids = torch.arange(lo, lo + per, dtype=torch.int64,
                               device=film[0].device)
        film_p, stats_p, rays = psum(work(ray_ids, sample_base, stats), mesh)
        return (tuple(a + b for a, b in zip(film, film_p)),
                {k: stats[k] + stats_p[k] for k in stats}, rays)

    return step
