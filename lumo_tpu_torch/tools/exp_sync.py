"""Cost per trip of a loop inside one kernel against a loop on the host.

Counterpart of ``tools/exp_sync.py``, which measures a Pallas while_loop
on the TPU.  ``csrc/exp_sync.cu`` is the hand-written Hopper kernel that
replaces ``make(variant).kern``: one block of 1024 threads runs ``iters``
trips over an (8, 128) float32 tile in one of six variants (a bare loop, a
vector op, a block vote feeding a counter, a vote feeding a branch, four
votes, a packed block-wide sum).  The time per trip is the result.  On
the card the question it answers is what ``path_trace.integrate`` pays for
testing ``alive.any()`` on the host every bounce: ``main`` prints, beside
the vote-and-branch variant, the time of one ``tensor.any().item()`` round
trip.

Times are taken with CUDA events around the launch and nothing is
subtracted.  The TPU kernel never initialises its ``acc`` scratch; the
port starts it at zero, so the outputs are deterministic.

    python -m lumo_tpu_torch.tools.exp_sync        # on a machine with a card

Dispatch is by device: a CPU tensor takes the plain version
(:func:`run_plain`, the same loop as a Python loop over tensors), a CUDA
tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import subprocess
import time

import torch

from lumo_tpu_torch.accel import cuda_build
from lumo_tpu_torch.accel.cuda_build import check_tensor, ptr, raise_on, stream
from lumo_tpu_torch.config import resolve_device

ITERS = 100000
VARIANTS = ("scalar", "vec", "reduce1", "branch1", "reduce4", "packed2")
TILE = (8, 128)

# Launches of the kernel since the last reset; the wrapper adds one per
# launch and nothing else touches it.
LAUNCHES = {"exp_sync": 0}

_VP, _CI = ctypes.c_void_p, ctypes.c_int
LIB = cuda_build.Library("exp_sync", {
    "lumo_exp_sync": [_CI, _VP, _VP, _CI, _VP]})


def run(variant: str, x: torch.Tensor, iters: int = ITERS) -> torch.Tensor:
    """``iters`` trips of ``variant`` over the (8, 128) float32 tile ``x``
    -> the (8, 128) float32 output ``float(s) + acc``."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    if not 0 <= iters < 1 << 20:
        raise ValueError("iters must lie in [0, 2**20): packed2 counts "
                         "2048 per trip in 32 bits")
    if x.device.type == "cpu":
        return run_plain(variant, x, iters)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    check_tensor("x", x, x.device, torch.float32, shape=TILE)
    lib = LIB.load()
    out = torch.empty(TILE, dtype=torch.float32, device=x.device)
    rc = lib.lumo_exp_sync(VARIANTS.index(variant), ptr(x), ptr(out), iters,
                           stream(x.device))
    raise_on(rc, f"exp_sync {variant}")
    LAUNCHES["exp_sync"] += 1
    return out


def run_plain(variant: str, x: torch.Tensor, iters: int = ITERS):
    """Plain PyTorch version of :func:`run`: the same loop, one tensor
    operation per step."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    acc = torch.zeros_like(x)
    s = torch.zeros((), dtype=torch.int32, device=x.device)
    for i in range(iters):
        if variant == "vec":
            acc = acc + x * 1.000001
        elif variant == "reduce1":
            s = s + (x + float(i) > 1.5).any().to(torch.int32)
        elif variant == "branch1":
            acc = torch.where((x + float(i) > 1.5).any(), acc + 1.0, acc)
        elif variant == "reduce4":
            for k in range(4):
                s = s + (x + float(i + k) > 1.5).any().to(torch.int32)
        elif variant == "packed2":
            xi = x + float(i)
            v = (xi > 1.5).to(torch.int32) + ((xi > 1.2).to(torch.int32) << 12)
            m = v.sum(dtype=torch.int32)
            s = s + (m & 4095) + (m >> 12)
    return torch.zeros_like(x) + s.to(torch.float32) + acc


def make(variant: str, iters: int = ITERS, device=None):
    """A callable that runs ``variant`` on a tile of 0.5 on ``device`` (the
    card when ``None``) and returns the (8, 128) float32 output."""
    x = torch.full(TILE, 0.5, dtype=torch.float32,
                   device=resolve_device(device))
    return lambda: run(variant, x, iters)


def timed_ms(fn, reps: int = 5) -> float:
    """The least device time of ``fn`` over ``reps`` calls after a
    warm-up, from CUDA events."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(stop))
    return best


def host_sync_us(device, reps: int = 200) -> float:
    """Mean host time of one ``tensor.any().item()`` round trip on a
    262,144-lane mask, the per-bounce test of ``path_trace.integrate``."""
    alive = torch.ones(262144, dtype=torch.bool, device=device)
    for _ in range(10):
        alive.any().item()
    t0 = time.perf_counter()
    for _ in range(reps):
        alive.any().item()
    return (time.perf_counter() - t0) / reps * 1e6


def measure(iters: int = ITERS, device=None) -> dict:
    """{variant: (ms, ns per trip)} and the host round trip in us."""
    device = resolve_device(device)
    out = {}
    for v in VARIANTS:
        ms = timed_ms(make(v, iters, device))
        out[v] = (ms, ms * 1e6 / iters)
    out["host_any_item_us"] = host_sync_us(device)
    return out


def main():
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    res = measure()
    for v in VARIANTS:
        ms, ns = res[v]
        print(f"{v:10s} {ms:9.3f} ms  ({ns:7.1f} ns/trip)", flush=True)
    print(f"tensor.any().item() on 262,144 lanes: "
          f"{res['host_any_item_us']:.1f} us per round trip "
          f"(branch1: {res['branch1'][1]:.1f} ns per trip on the device)",
          flush=True)


if __name__ == "__main__":
    main()
