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

``closest_hit_stats`` is the counterpart of ``pallas_bvh.closest_hit_stats``
(the TPU kernel's ``stats=True`` mode): the closest hit plus traversal
counters.  Its plain version, ``closest_hit_stats_plain``, is a per-lane
PyTorch walk over the same packed ``nodes`` and ``tris`` the kernel reads,
in the kernel's order, so it must return the kernel's ``t``, ``prim`` and
counters exactly.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from lumo_tpu_torch.accel import cuda_build
from lumo_tpu_torch.accel.cuda_build import (check_counts, check_tensor,
                                              count_ptrs, ptr, raise_on,
                                              stream)
from lumo_tpu_torch.accel.walk import (INFLATE, keep_better, leaf_best, rows,
                                        slab_reciprocals, stack_put,
                                        stack_take)
from lumo_tpu_torch.config import INF
from lumo_tpu_torch.geometry.intersect import ray_setup, triangle_t

STACK = 64  # per-thread traversal stack of the kernel
WARP = 32   # lanes that share a program counter on the card

# Launches of the kernel's entry points since the last reset; the wrappers
# add one per launch and nothing else touches them.
LAUNCHES = {"closest": 0, "any": 0, "stats": 0}

_VP, _CI = ctypes.c_void_p, ctypes.c_int
LIB = cuda_build.Library("bvh_traverse", {
    "lumo_bvh_closest": [_VP] * 5 + [_CI] + [_VP] * 6,
    "lumo_bvh_any": [_VP] * 5 + [_CI] + [_VP] * 5,
    "lumo_bvh_closest_stats": [_VP] * 5 + [_CI] + [_VP] * 4,
}, headers=("woop.cuh",))


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


def _check_inputs(bvh, o, d, t_max, counts, seen):
    dev = o.device
    if bvh["depth"] > STACK:
        raise ValueError(f"BVH depth {bvh['depth']} exceeds the kernel's "
                         f"{STACK}-entry stack")
    N = o.shape[0]
    check_tensor("o", o, dev, torch.float32, shape=(N, 3))
    check_tensor("d", d, dev, torch.float32, shape=(N, 3))
    check_tensor("t_max", t_max, dev, torch.float32, shape=(N,))
    check_tensor("nodes", bvh["nodes"], dev, torch.float32, tail=(2, 4))
    check_tensor("tris", bvh["tris"], dev, torch.float32, tail=(3, 4))
    if N >= 1 << 31:
        raise ValueError("too many rays for one launch")
    check_counts(counts, seen, dev,
                 bvh["nodes"].shape[0] + bvh["tris"].shape[0])


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
    lib = LIB.load()
    N = o.shape[0]
    t = torch.empty(N, dtype=torch.float32, device=o.device)
    prim = torch.empty(N, dtype=torch.int64, device=o.device)
    rc = lib.lumo_bvh_closest(
        ptr(bvh["nodes"]), ptr(bvh["tris"]), ptr(o), ptr(d), ptr(t_max),
        N, ptr(t), ptr(prim), *count_ptrs(bvh["nodes"].shape[0], counts, seen),
        stream(o.device))
    raise_on(rc, "BVH closest-hit")
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
    lib = LIB.load()
    N = o.shape[0]
    occ = torch.empty(N, dtype=torch.bool, device=o.device)
    rc = lib.lumo_bvh_any(
        ptr(bvh["nodes"]), ptr(bvh["tris"]), ptr(o), ptr(d), ptr(t_max),
        N, ptr(occ), *count_ptrs(bvh["nodes"].shape[0], counts, seen), stream(o.device))
    raise_on(rc, "BVH any-hit")
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


# ---------------------------------------------------------------------------
# the stats variant

def warp_stats(per_ray):
    """Per-ray counters (N, K) -> (ceil(N / 32), 2, K) int32: per warp of
    32 consecutive rays the sum and the maximum over its lanes.  SIMT
    efficiency of a counter is ``sum / (32 * max)``."""
    N, K = per_ray.shape
    W = (N + WARP - 1) // WARP
    padded = torch.zeros((W * WARP, K), dtype=per_ray.dtype,
                         device=per_ray.device)
    padded[:N] = per_ray
    lanes = padded.view(W, WARP, K)
    return torch.stack([lanes.sum(1), lanes.amax(1)], dim=1).to(torch.int32)


def closest_hit_stats(bvh, tri, o, d, t_max=INF):
    """:func:`closest_hit` plus traversal counters -> (t, prim, stats).
    ``stats`` is (ceil(N / 32), 2, 3) int32: for each warp of 32
    consecutive rays the sum and the maximum over its lanes of (interior
    nodes fetched, leaves fetched, triangles tested)."""
    t_max = rows(t_max, o)
    if o.device.type == "cpu":
        return closest_hit_stats_plain(bvh, tri, o, d, t_max)
    if o.device.type != "cuda":
        raise ValueError(f"unsupported device {o.device}")
    _check_inputs(bvh, o, d, t_max, None, None)
    lib = LIB.load()
    N = o.shape[0]
    t = torch.empty(N, dtype=torch.float32, device=o.device)
    prim = torch.empty(N, dtype=torch.int64, device=o.device)
    stats = torch.empty(((N + WARP - 1) // WARP, 2, 3), dtype=torch.int32,
                        device=o.device)
    rc = lib.lumo_bvh_closest_stats(
        ptr(bvh["nodes"]), ptr(bvh["tris"]), ptr(o), ptr(d), ptr(t_max),
        N, ptr(t), ptr(prim), ptr(stats), stream(o.device))
    raise_on(rc, "BVH closest-hit stats")
    LAUNCHES["stats"] += 1
    return t, prim, stats


def unpack_nodes(nodes):
    """The kernel's (M, 2, 4) nodes -> (lo (M, 3), hi (M, 3), right, axis,
    first, count (M,) int64)."""
    words = nodes[:, :, 3].contiguous().view(torch.int32).to(torch.int64)
    words = words & 0xFFFFFFFF
    w0, w1 = words[:, 0], words[:, 1]
    return (nodes[:, 0, :3], nodes[:, 1, :3], w0 >> 2, w0 & 3, w1 >> 3,
            w1 & 7)


def closest_hit_stats_plain(bvh, tri, o, d, t_max=INF):
    """Plain PyTorch version of :func:`closest_hit_stats`: every lane
    walks the packed ``bvh["nodes"]`` and ``bvh["tris"]`` as a thread of
    the kernel does (near child first by the ray's sign on the split
    axis, nodes pruned against the best hit inflated by 1.00000024) and
    counts the same three things (``tri`` unused)."""
    t_max = rows(t_max, o)
    N, dev = o.shape[0], o.device
    if bvh["depth"] > STACK:
        raise ValueError(f"BVH depth {bvh['depth']} exceeds the "
                         f"{STACK}-entry stack")
    lo, hi, n_right, n_axis, n_first, n_count = unpack_nodes(bvh["nodes"])
    kz, shear = ray_setup(d)
    inv = slab_reciprocals(d)
    offs = torch.arange(7, device=dev)
    active = t_max > 0.0
    node = torch.zeros(N, dtype=torch.int64, device=dev)
    sp = torch.zeros(N, dtype=torch.int64, device=dev)
    stack = torch.zeros((N, STACK), dtype=torch.int64, device=dev)
    best_t = torch.full((N,), INF, dtype=o.dtype, device=dev)
    best_p = torch.full((N,), -1, dtype=torch.int64, device=dev)
    stats = torch.zeros((N, 3), dtype=torch.int64, device=dev)
    while bool(active.any()):
        cnt = n_count[node]
        is_leaf = cnt > 0
        stats[:, 0] += active & ~is_leaf
        stats[:, 1] += active & is_leaf
        t0 = (lo[node] - o) * inv
        t1 = (hi[node] - o) * inv
        tn = torch.minimum(t0, t1).amax(dim=1)
        tf = torch.maximum(t0, t1).amin(dim=1) * INFLATE
        bound = torch.minimum(best_t, t_max)
        hit = active & (tn <= tf) & (tf > 0.0) & (tn < bound * INFLATE)
        inner = hit & ~is_leaf
        in_leaf = hit & is_leaf
        # interior: descend the near child, stack the far
        left_first = ~(d.gather(1, n_axis[node][:, None])[:, 0] < 0.0)
        left, right = node + 1, n_right[node]
        stack_put(stack, sp.clamp(max=STACK - 1),
                  torch.where(left_first, right, left), inner)
        sp = sp + inner.to(torch.int64)
        # leaf: test its triangles
        if bool(in_leaf.any()):
            valid = in_leaf[:, None] & (offs[None, :] < cnt[:, None])
            ref = torch.where(valid, n_first[node][:, None] + offs[None, :], 0)
            tb, pb = leaf_best(o, kz, shear, bvh["tris"], ref, valid, t_max)
            best_t, best_p = keep_better(best_t, best_p, tb, pb, in_leaf)
            stats[:, 2] += torch.where(in_leaf, cnt, 0)
        # next node: the near child, or the top of the stack
        can_pop = active & ~inner & (sp > 0)
        sp = sp - can_pop.to(torch.int64)
        popped = stack_take(stack, sp.clamp(0, STACK - 1))
        node = torch.where(inner, torch.where(left_first, left, right),
                           torch.where(can_pop, popped, node))
        active = active & (inner | can_pop)
    return best_t, best_p, warp_stats(stats)
