"""Building and loading the port's hand-written CUDA kernels.

Each kernel source under ``lumo_tpu_torch/csrc`` has a plain C interface.
A :class:`Library` compiles one source with nvcc for sm_90a into a shared
library in the repository's ``build/`` directory at first use (or when the
source or one of its headers is newer) and loads it with ctypes.  A
failed compile raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build")
# --fmad=false: no contraction of a*b + c, so a kernel's float arithmetic
# rounds as the plain PyTorch version's does
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "--fmad=false", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


class Library:
    """One ``csrc/<name>.cu`` and its ctypes binding.  ``functions`` maps
    each exported name to its ``argtypes``; every function returns the
    ``cudaError_t`` of its launch as an int."""

    def __init__(self, name: str, functions: dict, headers=()):
        self.name = name
        self.source = os.path.join(CSRC, f"{name}.cu")
        self.deps = [self.source] + [os.path.join(CSRC, h) for h in headers]
        self.so = os.path.join(BUILD_DIR, f"lib{name}.so")
        self.functions = functions
        # what the last build printed (ptxas registers and spills) and took
        self.info = {"log": "", "seconds": None}
        self._lock = threading.Lock()
        self._lib = None

    def stale(self) -> bool:
        return (not os.path.exists(self.so)
                or os.path.getmtime(self.so)
                < max(os.path.getmtime(p) for p in self.deps))

    def build(self) -> None:
        """Compile the source into ``build/`` (raises on error)."""
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{self.so}.{os.getpid()}.tmp"
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, self.source]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n{res.stderr}")
        os.replace(tmp, self.so)
        self.info["log"] = res.stderr + res.stdout
        self.info["seconds"] = time.perf_counter() - t0

    def load(self):
        with self._lock:
            if self._lib is None:
                if self.stale():
                    self.build()
                lib = ctypes.CDLL(self.so)
                for fn, argtypes in self.functions.items():
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = ctypes.c_int
                self._lib = lib
            return self._lib

    def ptxas_lines(self):
        """The register, stack and spill lines of the last build."""
        keep = ("registers", "spill", "stack frame", "Compiling entry")
        return [ln.strip() for ln in self.info["log"].splitlines()
                if any(k in ln for k in keep)]


def ptr(x: torch.Tensor):
    return ctypes.c_void_p(x.data_ptr())


def stream(dev):
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def count_ptrs(sizes, counts, seen):
    """The pointers of a counting launch: ``counts`` and one per segment
    of ``seen`` (``sizes`` marks each), None where unused."""
    if counts is None:
        return (None,) * (1 + len(sizes))
    if seen is None:
        return (ptr(counts),) + (None,) * len(sizes)
    out, start = [ptr(counts)], 0
    for n in sizes:
        out.append(ptr(seen[start:start + n]))
        start += n
    return tuple(out)


def check_counts(counts, seen, dev, sizes) -> None:
    """Raise unless ``counts`` is a (4,) int64 and ``seen`` a contiguous
    (sum(sizes),) uint8 tensor on ``dev`` (each may be None; ``seen`` only
    with ``counts``)."""
    if counts is not None:
        check_tensor("counts", counts, dev, torch.int64, shape=(4,))
    if seen is not None:
        if counts is None:
            raise ValueError("seen is filled only together with counts")
        check_tensor("seen", seen, dev, torch.uint8, shape=(sum(sizes),))


def grid(lib: Library, fn: str, mode: int, n: int):
    """(resident blocks per SM, blocks of a launch over ``n`` rays) that a
    traversal library's ``fn`` reports for the kernel of ``mode``."""
    out = (ctypes.c_int * 2)()
    raise_on(getattr(lib.load(), fn)(mode, n, out), fn)
    return out[0], out[1]


def raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {rc}")


def check_tensor(name, x, dev, dtype, shape=None, tail=None):
    """Raise unless ``x`` is a contiguous ``dtype`` tensor on ``dev`` of
    ``shape`` (or with trailing dimensions ``tail``)."""
    if x.device != dev:
        raise ValueError(f"{name} is on {x.device}, rays on {dev}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if shape is not None and tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(x.shape)}")
    if tail is not None and (x.ndim != len(tail) + 1
                             or tuple(x.shape[1:]) != tuple(tail)):
        raise ValueError(f"{name} must be (n, {', '.join(map(str, tail))})")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def reference_route(o, tri, plain_counts, query) -> bool:
    """The one branch that sends a traversal query to the float64
    reference route, chosen by the dtype of the rays ``o`` alone (never
    by a failure): True for a float64 query, which then takes the plain
    version in float64 over ``tri``, the scene's own (a, b, c) vertices,
    on the CPU and on the card alike, and adds one to
    ``plain_counts[query]``.  False for every other query, which goes on
    to the device rule: the plain version on a CPU tensor, the kernel on
    a CUDA tensor, where the kernel's entry points raise on any input
    that is not float32.  The kernels are float32 only, as the TPU's are;
    ``config.use_f64`` renders through this route.  The dense float64
    test is for reference-sized scenes: on the 327,692-triangle bench
    scene a plain float32 query of 262,144 rays takes about 38 s on an
    NVIDIA H100 80GB HBM3 at 700 W (``PERF.md``)."""
    if o.dtype != torch.float64:
        return False
    if tri is None or any(x.dtype != torch.float64 for x in tri):
        raise TypeError(f"a float64 {query} query needs the scene's float64 "
                        "(a, b, c) vertices")
    plain_counts[query] += 1
    return True


def check_no_grad(what, o, d, t_max) -> None:
    """Raise when a traversal query is handed rays that require grad: the
    walk is not differentiated, so the caller detaches ``o``, ``d`` and
    ``t_max`` first (``scene/trace.py`` does, and re-derives the hit
    distance differentiably from the prim id)."""
    for name, x in (("o", o), ("d", d), ("t_max", t_max)):
        if isinstance(x, torch.Tensor) and x.requires_grad:
            raise ValueError(
                f"{what}: {name} requires grad; traversal is not "
                f"differentiated, so pass {name}.detach()")
