"""Native (C++) host code, loaded with ctypes: the tree builders and the
JPEG decoder.

Counterpart of ``lumo_tpu/native/__init__.py``.  ``bvh_builder.cpp`` and
``kdtree_builder.cpp`` are this package's own copies of the threaded
binned-SAH BVH builder and the Wald-Havran SAH kd-tree builder;
``jpeg_decoder.cpp`` decodes JPEG as libjpeg does (the JAX package reads
it through PIL; ``io/image.py``).  Each is compiled with g++ at first use
into its own library in the repository's ``build/`` directory.  A
327k-triangle build in numpy takes minutes and a bit-serial Huffman
decode in Python as long, so these libraries are needed: a failed
compile raises.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build")
_libs: dict = {}

_F = ctypes.POINTER(ctypes.c_float)
_I = ctypes.POINTER(ctypes.c_int32)
_L = ctypes.POINTER(ctypes.c_int64)
_B = ctypes.POINTER(ctypes.c_uint8)
_SOURCES = {"bvh": "bvh_builder", "kdtree": "kdtree_builder",
            "jpeg": "jpeg_decoder"}
# each library's functions and their argtypes (every one returns an int)
_ARGTYPES = {
    "bvh": {"lumo_build_bvh":
            [_F, _F, ctypes.c_int64, _F, _F, _I, _I, _I, _I, _I, _L, _I]},
    "kdtree": {"lumo_build_kdtree":
               [_F, _F, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                _F, _I, _I, _I, _I, _I, _F, _F, _L, _L, _I]},
    "jpeg": {"lumo_jpeg_header": [ctypes.c_char_p, ctypes.c_int64, _I,
                                  ctypes.c_char_p, ctypes.c_int64],
             "lumo_jpeg_decode": [ctypes.c_char_p, ctypes.c_int64, _B,
                                  ctypes.c_char_p, ctypes.c_int64]},
}
_locks = {which: threading.Lock() for which in _SOURCES}


def _paths(which: str):
    name = _SOURCES[which]
    return (os.path.join(_DIR, f"{name}.cpp"),
            os.path.join(BUILD_DIR, f"liblumo_{name}.so"))


def _compile(src: str, so: str):
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
           "-pthread", src, "-o", tmp]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed to build {src}:\n{res.stderr}")
    os.replace(tmp, so)


def load(which: str = "bvh"):
    """The ctypes library ``which`` ("bvh", "kdtree" or "jpeg"),
    compiled first if missing or stale."""
    with _locks[which]:
        if which in _libs:
            return _libs[which]
        src, so = _paths(which)
        if not os.path.exists(so) or os.path.getmtime(so) < os.path.getmtime(src):
            _compile(src, so)
        lib = ctypes.CDLL(so)
        for name, argtypes in _ARGTYPES[which].items():
            getattr(lib, name).restype = ctypes.c_int
            getattr(lib, name).argtypes = argtypes
        _libs[which] = lib
        return lib


def _fp(a):
    return a.ctypes.data_as(_F)


def _ip(a):
    return a.ctypes.data_as(_I)


def build_bvh(prim_lo: np.ndarray, prim_hi: np.ndarray):
    """Native binned-SAH build over per-primitive AABBs (P, 3).  Returns
    (node_lo, node_hi, node_right, node_first, node_count, node_axis,
    order, max_depth), the layout of ``accel.build.BVH``."""
    lib = load("bvh")
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
    rc = lib.lumo_build_bvh(
        _fp(lo), _fp(hi), ctypes.c_int64(P),
        _fp(node_lo), _fp(node_hi), _ip(node_right), _ip(node_first),
        _ip(node_count), _ip(node_axis), _ip(order),
        ctypes.byref(n_nodes), ctypes.byref(max_depth))
    if rc != 0:
        raise RuntimeError(f"native BVH build failed ({rc}) for {P} prims")
    M = n_nodes.value
    return (node_lo[:M], node_hi[:M], node_right[:M], node_first[:M],
            node_count[:M], node_axis[:M], order, int(max_depth.value))


def build_kdtree(prim_lo: np.ndarray, prim_hi: np.ndarray):
    """Native Wald-Havran SAH kd-tree build over per-primitive AABBs
    (P, 3).  Returns (split, axis, right, first, count, prims, root_lo,
    root_hi, max_depth), the fields of ``accel.kdtree.KdTree``.  The
    output buffers grow fourfold (twice at most) when the library reports
    them too small."""
    lib = load("kdtree")
    P = len(prim_lo)
    lo = np.ascontiguousarray(prim_lo, np.float32)
    hi = np.ascontiguousarray(prim_hi, np.float32)
    node_cap = max(8 * P, 64)
    ref_cap = max(16 * P, 1024)
    for _ in range(3):
        split = np.empty(node_cap, np.float32)
        axis = np.empty(node_cap, np.int32)
        right = np.empty(node_cap, np.int32)
        first = np.empty(node_cap, np.int32)
        count = np.empty(node_cap, np.int32)
        prims = np.empty(ref_cap, np.int32)
        root_lo = np.empty(3, np.float32)
        root_hi = np.empty(3, np.float32)
        n_nodes = ctypes.c_int64(0)
        n_refs = ctypes.c_int64(0)
        max_depth = ctypes.c_int32(0)
        rc = lib.lumo_build_kdtree(
            _fp(lo), _fp(hi), ctypes.c_int64(P),
            ctypes.c_int64(node_cap), ctypes.c_int64(ref_cap),
            _fp(split), _ip(axis), _ip(right), _ip(first), _ip(count),
            _ip(prims), _fp(root_lo), _fp(root_hi),
            ctypes.byref(n_nodes), ctypes.byref(n_refs),
            ctypes.byref(max_depth))
        if rc == 0:
            M, R = n_nodes.value, n_refs.value
            return (split[:M], axis[:M], right[:M], first[:M], count[:M],
                    prims[:R], root_lo, root_hi, int(max_depth.value))
        if rc != 2:       # 2: node_cap or ref_cap exceeded
            break
        node_cap *= 4
        ref_cap *= 4
    raise RuntimeError(f"native kd-tree build failed ({rc}) for {P} prims")


def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG bytes -> (H, W, C) uint8 samples as libjpeg gives them: C = 1
    (grey) or 3 (RGB).  A format the decoder does not take raises a
    ``ValueError`` naming it."""
    lib = load("jpeg")
    data = bytes(data)
    err = ctypes.create_string_buffer(256)
    info = np.zeros(3, np.int32)
    if lib.lumo_jpeg_header(data, len(data), _ip(info), err, len(err)):
        raise ValueError(err.value.decode())
    w, h, c = (int(x) for x in info)
    out = np.empty((h, w, c), np.uint8)
    if lib.lumo_jpeg_decode(data, len(data), out.ctypes.data_as(_B), err,
                            len(err)):
        raise ValueError(err.value.decode())
    return out
