"""BVH closest-hit and any-hit queries: the CUDA kernel and its plain
PyTorch version.

Counterpart of ``lumo_tpu/accel/pallas_bvh.py`` (``closest_hit``,
``any_hit``).  ``csrc/bvh_traverse.cu`` is the hand-written Hopper kernel
that replaces the TPU kernel ``pallas_bvh._traverse_kernel``; it is
compiled with nvcc for sm_90a at first use into the repository's
``build/`` directory and bound with ctypes.

Dispatch is by device, never by failure: a CPU tensor takes the plain
version, a CUDA tensor launches the kernel or raises.  The plain versions
(``closest_hit_plain``, ``any_hit_plain``) are a chunked dense Woop test
over the BVH's triangles with ``geometry.intersect.triangle_t`` and an
argmin (lowest index on ties, as the kernel breaks them); the CPU tests
use them, and ``chip_smoke.py`` holds the kernel against them on the card.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time

import numpy as np
import torch

from lumo_tpu_torch.config import INF
from lumo_tpu_torch.geometry.intersect import ray_setup, triangle_t

STACK = 64  # per-thread traversal stack of the kernel

# Launches of the kernel's two entry points since the last reset; the
# wrappers add one per launch and nothing else touches them.
LAUNCHES = {"closest": 0, "any": 0}

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "bvh_traverse.cu")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build")
_SO = os.path.join(BUILD_DIR, "libbvh_traverse.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "--fmad=false", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None
# what the last build printed (ptxas register and spill report) and took
BUILD_INFO = {"log": "", "seconds": None}


def pack_nodes(bvh: dict) -> np.ndarray:
    """Binary DFS tables -> (M, 2, 4) float32 for the kernel: per node
    (lo.xyz, bits(right << 2 | axis)), (hi.xyz, bits(first << 3 | count))."""
    right = np.asarray(bvh["right"], np.int64)
    axis = np.asarray(bvh["axis"], np.int64)
    first = np.asarray(bvh["first"], np.int64)
    count = np.asarray(bvh["count"], np.int64)
    if count.max(initial=0) > 7 or count.min(initial=0) < 0:
        raise ValueError("leaf counts must lie in [0, 7] for the node packing")
    if first.max(initial=0) >= 1 << 29 or right.max(initial=0) >= 1 << 30:
        raise ValueError("BVH too large for the 32-bit node packing")
    if axis.min(initial=0) < 0 or axis.max(initial=0) > 2:
        raise ValueError("split axis out of range")
    w0 = ((right << 2) | axis).astype(np.uint32).view(np.float32)
    w1 = ((first << 3) | count).astype(np.uint32).view(np.float32)
    out = np.empty((len(right), 2, 4), np.float32)
    out[:, 0, :3] = np.asarray(bvh["lo"], np.float32)
    out[:, 0, 3] = w0
    out[:, 1, :3] = np.asarray(bvh["hi"], np.float32)
    out[:, 1, 3] = w1
    return out


def pack_tris(a, b, c) -> np.ndarray:
    """Leaf-order vertices (T, 3) each -> (T, 3, 4) float32 (w = 0)."""
    out = np.zeros((len(a), 3, 4), np.float32)
    for j, v in enumerate((a, b, c)):
        out[:, j, :3] = v
    return out


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the BVH kernel cannot be built")
    return path


def build() -> None:
    """Compile ``csrc/bvh_traverse.cu`` into ``build/`` (raises on error)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n{res.stderr}")
    os.replace(tmp, _SO)
    BUILD_INFO["log"] = res.stderr + res.stdout
    BUILD_INFO["seconds"] = time.perf_counter() - t0


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if (not os.path.exists(_SO)
                or os.path.getmtime(_SO) < os.path.getmtime(SOURCE)):
            build()
        lib = ctypes.CDLL(_SO)
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.lumo_bvh_closest.argtypes = [vp, vp, vp, vp, vp, ci, vp, vp, vp,
                                         vp, vp, vp]
        lib.lumo_bvh_closest.restype = ci
        lib.lumo_bvh_any.argtypes = [vp, vp, vp, vp, vp, ci, vp, vp, vp, vp,
                                     vp]
        lib.lumo_bvh_any.restype = ci
        _lib = lib
        return _lib


def _check_inputs(bvh, o, d, t_max, counts, seen):
    dev = o.device
    if bvh["depth"] > STACK:
        raise ValueError(f"BVH depth {bvh['depth']} exceeds the kernel's "
                         f"{STACK}-entry stack")
    N = o.shape[0]
    want = {"o": (o, (N, 3), torch.float32), "d": (d, (N, 3), torch.float32),
            "t_max": (t_max, (N,), torch.float32),
            "nodes": (bvh["nodes"], None, torch.float32),
            "tris": (bvh["tris"], None, torch.float32)}
    for name, (x, shape, dtype) in want.items():
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, rays on {dev}")
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if shape is not None and tuple(x.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if bvh["nodes"].ndim != 3 or bvh["nodes"].shape[1:] != (2, 4):
        raise ValueError("nodes must be (M, 2, 4)")
    if bvh["tris"].ndim != 3 or bvh["tris"].shape[1:] != (3, 4):
        raise ValueError("tris must be (T, 3, 4)")
    if N >= 1 << 31:
        raise ValueError("too many rays for one launch")
    if counts is not None and (counts.device != dev
                               or counts.dtype != torch.int64
                               or tuple(counts.shape) != (2,)):
        raise ValueError("counts must be a (2,) int64 tensor on the rays' "
                         "device")
    if seen is not None:
        M, T = bvh["nodes"].shape[0], bvh["tris"].shape[0]
        if counts is None:
            raise ValueError("seen is filled only together with counts")
        if (seen.device != dev or seen.dtype != torch.uint8
                or tuple(seen.shape) != (M + T,) or not seen.is_contiguous()):
            raise ValueError(f"seen must be a contiguous ({M + T},) uint8 "
                             f"tensor on the rays' device")


def _stats_ptrs(bvh, counts, seen):
    """(counts, seen nodes, seen triangles) pointers, None where unused."""
    if counts is None:
        return None, None, None
    if seen is None:
        return _ptr(counts), None, None
    M = bvh["nodes"].shape[0]
    return _ptr(counts), _ptr(seen[:M]), _ptr(seen[M:])


def _ptr(x):
    return ctypes.c_void_p(x.data_ptr())


def _stream(dev):
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def _raise_on(rc, what):
    if rc != 0:
        raise RuntimeError(f"BVH {what} kernel launch failed: cudaError {rc}")


def rows(t_max, o):
    """A scalar ``t_max`` as one value per ray of ``o``."""
    if isinstance(t_max, (int, float)):
        return torch.full(o.shape[:1], float(t_max), dtype=o.dtype,
                          device=o.device)
    return t_max


def closest_hit(bvh, tri, o, d, t_max=INF, counts=None, seen=None):
    """Nearest triangle hit in (0, t_max) per ray -> (t (N,), prim (N,)
    int64), prim = -1 and t = INF on a miss.  ``bvh`` is a scene's BVH
    dict; ``tri`` its (a, b, c) leaf-order vertices, read by the plain
    version.  ``counts``, a zeroed (2,) int64 CUDA tensor, receives the
    kernel's node visits and triangle tests; ``seen``, a zeroed (M + T,)
    uint8 CUDA tensor given with ``counts``, receives a 1 for each of the
    M nodes and T triangles the launch read."""
    t_max = rows(t_max, o)
    if o.device.type == "cpu":
        return closest_hit_plain(bvh, tri, o, d, t_max)
    if o.device.type != "cuda":
        raise ValueError(f"unsupported device {o.device}")
    _check_inputs(bvh, o, d, t_max, counts, seen)
    lib = _load()
    N = o.shape[0]
    t = torch.empty(N, dtype=torch.float32, device=o.device)
    prim = torch.empty(N, dtype=torch.int64, device=o.device)
    rc = lib.lumo_bvh_closest(
        _ptr(bvh["nodes"]), _ptr(bvh["tris"]), _ptr(o), _ptr(d), _ptr(t_max),
        N, _ptr(t), _ptr(prim), *_stats_ptrs(bvh, counts, seen),
        _stream(o.device))
    _raise_on(rc, "closest-hit")
    LAUNCHES["closest"] += 1
    return t, prim


def any_hit(bvh, tri, o, d, t_max=INF, counts=None, seen=None):
    """True where any triangle lies in (0, t_max); see :func:`closest_hit`."""
    t_max = rows(t_max, o)
    if o.device.type == "cpu":
        return any_hit_plain(bvh, tri, o, d, t_max)
    if o.device.type != "cuda":
        raise ValueError(f"unsupported device {o.device}")
    _check_inputs(bvh, o, d, t_max, counts, seen)
    lib = _load()
    N = o.shape[0]
    occ = torch.empty(N, dtype=torch.bool, device=o.device)
    rc = lib.lumo_bvh_any(
        _ptr(bvh["nodes"]), _ptr(bvh["tris"]), _ptr(o), _ptr(d), _ptr(t_max),
        N, _ptr(occ), *_stats_ptrs(bvh, counts, seen), _stream(o.device))
    _raise_on(rc, "any-hit")
    LAUNCHES["any"] += 1
    return occ


def _chunks(o, T):
    """(ray chunk, triangle chunk) sizes bounding the (R, C) candidate
    tensors at ~2**24 elements on the card, 2**18 on the CPU."""
    budget = 1 << (24 if o.device.type == "cuda" else 18)
    C = max(1, min(T, 4096))
    return max(1, budget // C), C


def _dense_rows(tri, o, d, t_max):
    """Yield (ray slice, tri offset, t (R, C)) over the chunked dense test."""
    a, b, c = tri
    N, T = o.shape[0], a.shape[0]
    kz, shear = ray_setup(d)
    R, C = _chunks(o, T)
    for r0 in range(0, N, R):
        rs = slice(r0, min(N, r0 + R))
        for c0 in range(0, T, C):
            cs = slice(c0, min(T, c0 + C))
            t, _, _ = triangle_t(o[rs], kz[rs], shear[rs], a[None, cs],
                                 b[None, cs], c[None, cs], 0.0,
                                 t_max[rs, None])
            yield rs, c0, t


def closest_hit_plain(bvh, tri, o, d, t_max=INF):
    """Plain PyTorch version of :func:`closest_hit` (``bvh`` unused)."""
    t_max = rows(t_max, o)
    N = o.shape[0]
    best_t = torch.full((N,), INF, dtype=o.dtype, device=o.device)
    best_p = torch.full((N,), -1, dtype=torch.int64, device=o.device)
    for rs, c0, t in _dense_rows(tri, o, d, t_max):
        i = torch.argmin(t, dim=1)
        tc = torch.gather(t, 1, i[:, None])[:, 0]
        # strict: an earlier chunk (lower prim ids) keeps its ties
        better = tc < best_t[rs]
        best_t[rs] = torch.where(better, tc, best_t[rs])
        best_p[rs] = torch.where(better, i + c0, best_p[rs])
    return best_t, torch.where(torch.isfinite(best_t), best_p, -1)


def any_hit_plain(bvh, tri, o, d, t_max=INF):
    """Plain PyTorch version of :func:`any_hit` (``bvh`` unused)."""
    t_max = rows(t_max, o)
    occ = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
    for rs, _, t in _dense_rows(tri, o, d, t_max):
        occ[rs] |= torch.isfinite(t).any(dim=1)
    return occ
