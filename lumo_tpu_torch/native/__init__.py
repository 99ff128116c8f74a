"""Native (C++) host BVH builder, loaded with ctypes.

Counterpart of ``lumo_tpu/native/__init__.py`` (the BVH entry point
only).  ``bvh_builder.cpp`` is this package's own copy of the threaded
binned-SAH builder; it is compiled with g++ at first use into the
repository's ``build/`` directory.  A 327k-triangle build in numpy takes
minutes, so a scene that large needs this library: a failed compile
raises.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "bvh_builder.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build")
_SO = os.path.join(BUILD_DIR, "liblumo_bvh_builder.so")
_lock = threading.Lock()
_lib = None


def _compile():
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
           "-pthread", _SRC, "-o", tmp]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed to build {_SRC}:\n{res.stderr}")
    os.replace(tmp, _SO)


def load():
    """The ctypes library, compiled first if missing or stale."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if (not os.path.exists(_SO)
                or os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
            _compile()
        lib = ctypes.CDLL(_SO)
        lib.lumo_build_bvh.restype = ctypes.c_int
        lib.lumo_build_bvh.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32),
        ]
        _lib = lib
        return _lib


def build_bvh(prim_lo: np.ndarray, prim_hi: np.ndarray):
    """Native binned-SAH build over per-primitive AABBs (P, 3).  Returns
    (node_lo, node_hi, node_right, node_first, node_count, node_axis,
    order, max_depth), the layout of ``accel.build.BVH``."""
    lib = load()
    P = len(prim_lo)
    lo = np.ascontiguousarray(prim_lo, np.float32)
    hi = np.ascontiguousarray(prim_hi, np.float32)
    M = max(2 * P - 1, 1)
    node_lo = np.empty((M, 3), np.float32)
    node_hi = np.empty((M, 3), np.float32)
    node_right = np.empty(M, np.int32)
    node_first = np.empty(M, np.int32)
    node_count = np.empty(M, np.int32)
    node_axis = np.empty(M, np.int32)
    order = np.empty(P, np.int32)
    n_nodes = ctypes.c_int64(0)
    max_depth = ctypes.c_int32(0)
    fp = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    ip = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    rc = lib.lumo_build_bvh(
        fp(lo), fp(hi), ctypes.c_int64(P),
        fp(node_lo), fp(node_hi), ip(node_right), ip(node_first),
        ip(node_count), ip(node_axis), ip(order),
        ctypes.byref(n_nodes), ctypes.byref(max_depth))
    if rc != 0:
        raise RuntimeError(f"native BVH build failed ({rc}) for {P} prims")
    M = n_nodes.value
    return (node_lo[:M], node_hi[:M], node_right[:M], node_first[:M],
            node_count[:M], node_axis[:M], order, int(max_depth.value))
