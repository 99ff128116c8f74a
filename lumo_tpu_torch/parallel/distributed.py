"""Rendering over several devices: one process per device, joined by
``torch.distributed`` (counterpart of ``lumo_tpu/parallel/distributed.py``).

JAX runs one controller per host over a global device mesh; PyTorch's
idiom is one process per device.  Every process runs the same program
and builds the same scene on its own device (the replicated scene, the
reference's ``Arc<Scene>``); each is a rank of the default process group,
and the group is the mesh's ``"rays"`` axis (``parallel/mesh.py``).  The
(pixel x sample) wavefront is split into contiguous blocks, one a rank,
and films, stats and gradients are summed with one ``all_reduce`` a
step, so a collective's latency is paid once a batch, not once a sample.

Usage (the same program in every process):

    from lumo_tpu_torch.parallel import distributed
    distributed.initialize(coordinator="host0:29500", num_processes=2,
                           process_id=rank)
    img = Renderer(scene, camera).samples(1024).render()

With no arguments the layout comes from torchrun's ``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK``.  After
``initialize`` the ordinary ``Renderer`` renders over every rank (its
device count defaults to the world size), and every rank returns the
same image.  Every random draw is a counter hash of (pixel, sample), so
the image does not depend on the process count beyond the order in which
the films' float sums are added.
"""
from __future__ import annotations

import datetime
import os
import time

import torch
import torch.distributed as dist

# longest wait at the rendezvous and in one collective: a rank whose peer
# died stops with an error instead of hanging
TIMEOUT = datetime.timedelta(minutes=10)

_device = None


def _rank_device(device, process_id):
    if device is not None:
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            # as a tensor's device reads: cuda with its index
            return torch.device("cuda", torch.cuda.current_device())
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible; pass device='cpu' to "
                           "run the ranks on the CPU")
    local = os.environ.get("LOCAL_RANK")
    if local is None:
        local = process_id % torch.cuda.device_count()
    return torch.device("cuda", int(local))


def initialize(coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               backend: str | None = None, device=None):
    """Join this process to the default process group (idempotent).

    coordinator: ``"host:port"`` of rank 0's store (``tcp://host:port``),
        or an init URL such as ``file:///tmp/rendezvous``; None takes
        ``MASTER_ADDR``/``MASTER_PORT`` from the environment.
    num_processes / process_id: world size and rank; None takes
        ``WORLD_SIZE``/``RANK`` from the environment.
    backend: the collective backend; by default ``"nccl"`` on a card and
        ``"gloo"`` on the CPU.  ``"gloo"`` on a card is how several ranks
        share one card (NCCL refuses two ranks on one GPU).  JAX's
        ``cpu_collectives`` is this argument on the CPU; its
        ``local_devices`` has no counterpart, one process driving one
        device.
    device: this rank's device; None means ``cuda:LOCAL_RANK`` (else
        ``cuda:process_id % device_count``) and raises without a card.
    """
    global _device
    if process_id is None:
        process_id = int(os.environ.get("RANK", 0))
    dev = _rank_device(device, process_id)
    if dist.is_initialized():
        _device = dev
        return
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"NCCL needs a card for each rank; this rank's "
                         f"device is {dev}: use gloo")
    if coordinator is None:
        init = "env://"
    elif "://" in coordinator:
        init = coordinator
    else:
        init = f"tcp://{coordinator}"
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", 1))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init, timeout=TIMEOUT,
                            world_size=num_processes, rank=process_id)
    _device = dev


def device(default=None) -> torch.device:
    """This rank's device, as :func:`initialize` chose it; where the
    group was joined without it (``torch.distributed.init_process_group``
    under torchrun), ``default``."""
    if _device is not None:
        return _device
    if default is None:
        raise RuntimeError("no rank device: call lumo_tpu_torch.parallel."
                           "distributed.initialize first")
    return torch.device(default)


def shutdown():
    """Leave the process group (the counterpart of
    ``jax.distributed.shutdown``); call it in ``finally``."""
    global _device
    if dist.is_initialized():
        dist.destroy_process_group()
    _device = None


def start_ranks(fn, world, args):
    """Start ``fn(rank, world, *args)`` in ``world`` processes with the
    spawn method (a fresh interpreter: never fork a process that may hold
    a CUDA context); the context to :func:`join_ranks`, or to
    :func:`stop_ranks` to abandon them."""
    import torch.multiprocessing as mp
    return mp.start_processes(fn, args=(world,) + tuple(args), nprocs=world,
                              join=False, start_method="spawn")


def join_ranks(ctx, timeout):
    """Wait for every rank of ``ctx``: a rank that raises stops the others
    and raises here with its traceback, as do ranks still running after
    ``timeout`` seconds; no rank outlives the call."""
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() > deadline:
                raise TimeoutError(f"ranks still running after {timeout} s")
    finally:
        stop_ranks(ctx)


def stop_ranks(ctx):
    """Terminate the ranks of ``ctx`` still running and reap them all."""
    for p in ctx.processes:
        if p.is_alive():
            p.terminate()
    for p in ctx.processes:
        p.join(timeout=10)


def spawn_ranks(fn, world, args, timeout):
    """Run ``fn(rank, world, *args)`` in ``world`` spawned processes and
    wait for all (:func:`start_ranks`, then :func:`join_ranks`)."""
    join_ranks(start_ranks(fn, world, args), timeout)


def is_multi_process() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def process_summary() -> str:
    rank = dist.get_rank() if dist.is_initialized() else 0
    world = dist.get_world_size() if dist.is_initialized() else 1
    return f"process {rank}/{world}, 1 local / {world} global devices"
