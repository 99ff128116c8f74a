"""kd-tree closest-hit and any-hit queries: the CUDA kernel, its packer and
its plain PyTorch version.

Counterpart of ``lumo_tpu/accel/pallas_kd.py`` (``closest_hit``,
``any_hit``) and of the kd half of ``lumo_tpu/accel/traverse.py``
(``_kd_walk``).  ``csrc/kd_traverse.cu`` is the hand-written Hopper kernel
that replaces the TPU kernel ``pallas_kd._kd_kernel``; it is compiled with
nvcc for sm_90a at first use into the repository's ``build/`` directory
and bound with ctypes.  The TPU's block packing (``pack_kd_blocks``) has
no counterpart: :func:`pack_kd` lays the flat Wald-Havran tree of
``accel/kdtree.py`` out as 8-byte nodes and per-reference triangles (see
the kernel's source note).

Dispatch is by device, never by failure: a CPU tensor takes the plain
version, a CUDA tensor launches the kernel or raises.  The plain versions
(``closest_hit_plain``, ``any_hit_plain``) are a per-lane PyTorch walk,
the counterpart of ``traverse._kd_walk``, over the same packed tables the
kernel reads, so the CPU tests cover the packer; the dense test of
``bvh_kernel.closest_hit_plain`` stays the second yardstick.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from lumo_tpu_torch.accel import cuda_build
from lumo_tpu_torch.accel.walk import (INFLATE, keep_better, leaf_best, rows,
                                        slab_reciprocals, stack_put,
                                        stack_take)
from lumo_tpu_torch.accel.cuda_build import (check_counts, check_tensor,
                                              count_ptrs, ptr, raise_on,
                                              stream)
from lumo_tpu_torch.config import INF
from lumo_tpu_torch.geometry.intersect import ray_setup

STACK = 64      # per-thread stack of (node, t0, t1) entries of the kernel
LEAF_CHUNK = 8  # references the plain walk tests per step
LEAF = 3        # the axis tag of a leaf

# Launches of the kernel's two entry points since the last reset; the
# wrappers add one per launch and nothing else touches them.
LAUNCHES = {"closest": 0, "any": 0}

_VP, _CI = ctypes.c_void_p, ctypes.c_int
LIB = cuda_build.Library("kd_traverse", {
    "lumo_kd_closest": [_VP] * 6 + [_CI] + [_VP] * 6,
    "lumo_kd_any": [_VP] * 6 + [_CI] + [_VP] * 5,
}, headers=("woop.cuh",))


def pack_kd(kd: dict, a, b, c) -> dict:
    """Flat kd tables -> the kernel's layout, as numpy arrays.

    ``kd`` holds ``split`` (M,) float32, ``axis`` (0/1/2, 3 for a leaf),
    ``right``, ``first``, ``count`` (M,) and ``prims`` (R,) integers, and
    the root bounds ``lo``, ``hi`` (3,); ``a, b, c`` (T, 3) are the
    triangles' vertices in prim order.  Returns

    - ``nodes`` (M, 2) int32: word 0 the bits of ``split`` (interior) or
      ``first`` (leaf), word 1 ``right << 2 | axis`` (interior) or
      ``count << 2 | 3`` (leaf);
    - ``tris`` (R, 3, 4) float32: the vertices of ``prims[r]`` per leaf
      reference r, with the bits of the prim id in lane ``[r, 0, 3]``;
    - ``root`` (6,) float32: lo.xyz, hi.xyz.

    Raises beyond the layout's limits: ``right`` and ``count`` below
    2**30, 3 R below 2**31, prim ids below 2**31."""
    split = np.asarray(kd["split"], np.float32)
    axis = np.asarray(kd["axis"], np.int64)
    right = np.asarray(kd["right"], np.int64)
    first = np.asarray(kd["first"], np.int64)
    count = np.asarray(kd["count"], np.int64)
    prims = np.asarray(kd["prims"], np.int64)
    M, R, T = len(axis), len(prims), len(a)
    if not (len(split) == len(right) == len(first) == len(count) == M) or M == 0:
        raise ValueError("kd tables must be non-empty and of one length")
    if axis.min() < 0 or axis.max() > LEAF:
        raise ValueError("kd axis out of range")
    leaf = axis == LEAF
    if 3 * R >= 1 << 31 or M >= 1 << 30:
        raise ValueError("kd-tree too large for the 32-bit node packing")
    if prims.min(initial=0) < 0 or prims.max(initial=0) >= min(T, 1 << 31):
        raise ValueError("kd prims index outside the triangles")
    if np.any(right[~leaf] <= np.nonzero(~leaf)[0]) or np.any(right[~leaf] >= M):
        raise ValueError("kd right child out of range")
    if (count[leaf].min(initial=0) < 0 or first[leaf].min(initial=0) < 0
            or np.any(first[leaf] + count[leaf] > R)):
        raise ValueError("kd leaf references out of range")
    nodes = np.empty((M, 2), np.int32)
    nodes[:, 0] = np.where(leaf, first.astype(np.int32),
                           split.view(np.int32))
    arg = np.where(leaf, count, right)
    nodes[:, 1] = ((arg << 2) | axis).astype(np.uint32).view(np.int32)
    tris = np.zeros((R, 3, 4), np.float32)
    for j, v in enumerate((a, b, c)):
        tris[:, j, :3] = np.asarray(v, np.float32)[prims]
    tris[:, 0, 3] = prims.astype(np.int32).view(np.float32)
    root = np.concatenate([np.asarray(kd["lo"], np.float32),
                           np.asarray(kd["hi"], np.float32)])
    return {"nodes": nodes, "tris": tris, "root": root}


def kd_depth(axis: np.ndarray, right: np.ndarray) -> int:
    """Levels of a DFS-preorder kd-tree (left child = i + 1), one
    vectorized step per level."""
    frontier = np.zeros(1, np.int64)
    depth = 0
    while len(frontier):
        depth += 1
        inner = frontier[axis[frontier] != LEAF]
        frontier = np.concatenate([inner + 1, right[inner].astype(np.int64)])
    return depth


def _check_inputs(kd, o, d, t_max, counts, seen):
    dev = o.device
    if kd["depth"] > STACK:
        raise ValueError(f"kd-tree depth {kd['depth']} exceeds the kernel's "
                         f"{STACK}-entry stack")
    N = o.shape[0]
    check_tensor("o", o, dev, torch.float32, shape=(N, 3))
    check_tensor("d", d, dev, torch.float32, shape=(N, 3))
    check_tensor("t_max", t_max, dev, torch.float32, shape=(N,))
    check_tensor("nodes", kd["nodes"], dev, torch.int32, tail=(2,))
    check_tensor("tris", kd["tris"], dev, torch.float32, tail=(3, 4))
    check_tensor("root", kd["root"], dev, torch.float32, shape=(6,))
    if N >= 1 << 31:
        raise ValueError("too many rays for one launch")
    check_counts(counts, seen, dev,
                 kd["nodes"].shape[0] + kd["tris"].shape[0])


def closest_hit(kd, o, d, t_max=INF, counts=None, seen=None):
    """Nearest triangle hit in (0, t_max) per ray -> (t (N,), prim (N,)
    int64), prim = -1 and t = INF on a miss.  ``kd`` is a scene's packed
    kd-tree (``nodes``, ``tris``, ``root`` tensors and ``depth``).
    ``counts``, a zeroed (2,) int64 CUDA tensor, receives the kernel's
    node visits and triangle tests; ``seen``, a zeroed (M + R,) uint8 CUDA
    tensor given with ``counts``, receives a 1 for each of the M nodes and
    R leaf references the launch read."""
    t_max = rows(t_max, o)
    if o.device.type == "cpu":
        return closest_hit_plain(kd, o, d, t_max)
    if o.device.type != "cuda":
        raise ValueError(f"unsupported device {o.device}")
    _check_inputs(kd, o, d, t_max, counts, seen)
    lib = LIB.load()
    N = o.shape[0]
    t = torch.empty(N, dtype=torch.float32, device=o.device)
    prim = torch.empty(N, dtype=torch.int64, device=o.device)
    rc = lib.lumo_kd_closest(
        ptr(kd["nodes"]), ptr(kd["tris"]), ptr(kd["root"]), ptr(o), ptr(d),
        ptr(t_max), N, ptr(t), ptr(prim), *count_ptrs(kd["nodes"].shape[0], counts, seen),
        stream(o.device))
    raise_on(rc, "kd closest-hit")
    LAUNCHES["closest"] += 1
    return t, prim


def any_hit(kd, o, d, t_max=INF, counts=None, seen=None):
    """True where any triangle lies in (0, t_max); see :func:`closest_hit`."""
    t_max = rows(t_max, o)
    if o.device.type == "cpu":
        return any_hit_plain(kd, o, d, t_max)
    if o.device.type != "cuda":
        raise ValueError(f"unsupported device {o.device}")
    _check_inputs(kd, o, d, t_max, counts, seen)
    lib = LIB.load()
    N = o.shape[0]
    occ = torch.empty(N, dtype=torch.bool, device=o.device)
    rc = lib.lumo_kd_any(
        ptr(kd["nodes"]), ptr(kd["tris"]), ptr(kd["root"]), ptr(o), ptr(d),
        ptr(t_max), N, ptr(occ), *count_ptrs(kd["nodes"].shape[0], counts, seen),
        stream(o.device))
    raise_on(rc, "kd any-hit")
    LAUNCHES["any"] += 1
    return occ


def _walk(kd, o, d, t_max, any_mode):
    """Every lane walks the packed kd-tree as a thread of the kernel does
    (``traverse._kd_walk``): a per-lane (node, t0, t1) stack, near child
    first, leaves consumed ``LEAF_CHUNK`` references per step.  Returns
    (t, prim, occluded)."""
    if kd["depth"] > STACK:
        raise ValueError(f"kd-tree depth {kd['depth']} exceeds the "
                         f"{STACK}-entry stack")
    nodes, tris, root = kd["nodes"], kd["tris"], kd["root"]
    N, dev = o.shape[0], o.device
    word0 = nodes[:, 0].contiguous()
    n_split = word0.view(torch.float32)
    n_first = word0.to(torch.int64)
    word1 = nodes[:, 1].to(torch.int64) & 0xFFFFFFFF
    n_axis, n_arg = word1 & 3, word1 >> 2
    prim_id = tris[:, 0, 3].contiguous().view(torch.int32).to(torch.int64)
    kz, shear = ray_setup(d)
    inv = slab_reciprocals(d)
    offs = torch.arange(LEAF_CHUNK, device=dev)

    # root entry interval: slab against the root bounds, far side
    # inflated, clipped to [0, t_max]
    s0 = (root[None, :3] - o) * inv
    s1 = (root[None, 3:] - o) * inv
    e0 = torch.minimum(s0, s1).amax(dim=1).clamp(min=0.0)
    e1 = torch.minimum(torch.maximum(s0, s1).amin(dim=1) * INFLATE, t_max)
    live = (t_max > 0.0) & (e0 <= e1)

    stack_n = torch.zeros((N, STACK), dtype=torch.int64, device=dev)
    stack_t0 = torch.zeros((N, STACK), dtype=o.dtype, device=dev)
    stack_t1 = torch.zeros((N, STACK), dtype=o.dtype, device=dev)
    stack_t0[:, 0] = e0
    stack_t1[:, 0] = e1
    sp = live.to(torch.int64)
    best_t = torch.full((N,), INF, dtype=o.dtype, device=dev)
    best_p = torch.full((N,), -1, dtype=torch.int64, device=dev)
    lfirst = torch.zeros(N, dtype=torch.int64, device=dev)
    lcount = torch.zeros(N, dtype=torch.int64, device=dev)
    while True:
        if any_mode:
            live = live & (best_p < 0)
        in_leaf = live & (lcount > 0)
        can_pop = live & ~in_leaf & (sp > 0)
        if not bool((in_leaf | can_pop).any()):
            break
        # leaf lanes: one chunk of references
        if bool(in_leaf.any()):
            valid = in_leaf[:, None] & (offs[None, :] < lcount[:, None])
            ref = torch.where(valid, lfirst[:, None] + offs[None, :], 0)
            tb, pb = leaf_best(o, kz, shear, tris, ref, valid, t_max,
                               prim_ids=prim_id[ref])
            best_t, best_p = keep_better(best_t, best_p, tb, pb, in_leaf)
            lfirst = torch.where(in_leaf, lfirst + LEAF_CHUNK, lfirst)
            lcount = torch.where(in_leaf,
                                 (lcount - LEAF_CHUNK).clamp(min=0), lcount)
        # pop lanes
        sp = sp - can_pop.to(torch.int64)
        slot = sp.clamp(0, STACK - 1)
        node = torch.where(can_pop, stack_take(stack_n, slot), 0)
        t0 = stack_take(stack_t0, slot)
        t1 = stack_take(stack_t1, slot)
        # a cell that starts beyond the best hit holds nothing closer
        active = can_pop if any_mode else can_pop & (t0 <= best_t)
        ax = n_axis[node]
        is_leaf = active & (ax == LEAF)
        lfirst = torch.where(is_leaf, n_first[node], lfirst)
        lcount = torch.where(is_leaf, n_arg[node], lcount)

        interior = active & (ax != LEAF)
        axc = ax.clamp(max=2)[:, None]
        o_a = o.gather(1, axc)[:, 0]
        d_a = d.gather(1, axc)[:, 0]
        split = n_split[node]
        tplane = (split - o_a) * inv.gather(1, axc)[:, 0]
        below = (o_a < split) | ((o_a == split) & (d_a <= 0.0))
        left, right = node + 1, n_arg[node]
        near = torch.where(below, left, right)
        far = torch.where(below, right, left)
        # a ray lying in the split plane visits both children over the
        # whole interval; inv is clamped, so tplane itself is never NaN
        in_plane = (d_a == 0.0) & (o_a == split)
        only_near = (tplane > t1) | (tplane <= 0.0)
        only_far = ~only_near & (tplane < t0)
        both = (~only_near & ~only_far) | in_plane
        # the popped slot takes the far child (or the only child); when
        # both are visited the near child goes on top of it
        push2 = interior & both
        first_n = torch.where(both | only_far, far, near)
        first_t0 = torch.where(both & ~in_plane, tplane, t0)
        stack_put(stack_n, slot, first_n, interior)
        stack_put(stack_t0, slot, first_t0, interior)
        stack_put(stack_t1, slot, t1, interior)
        slot2 = (slot + 1).clamp(max=STACK - 1)
        stack_put(stack_n, slot2, near, push2)
        stack_put(stack_t0, slot2, t0, push2)
        stack_put(stack_t1, slot2, torch.where(in_plane, t1, tplane), push2)
        sp = sp + interior.to(torch.int64) + push2.to(torch.int64)
    hit = best_p >= 0
    return best_t, best_p, hit


def closest_hit_plain(kd, o, d, t_max=INF):
    """Plain PyTorch version of :func:`closest_hit`."""
    t, prim, _ = _walk(kd, o, d, rows(t_max, o), any_mode=False)
    return t, prim


def any_hit_plain(kd, o, d, t_max=INF):
    """Plain PyTorch version of :func:`any_hit`."""
    return _walk(kd, o, d, rows(t_max, o), any_mode=True)[2]
