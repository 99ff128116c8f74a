"""kd-tree closest-hit and any-hit queries: the CUDA kernel, its packer and
its plain PyTorch version.

Counterpart of ``lumo_tpu/accel/pallas_kd.py`` (``closest_hit``,
``any_hit``) and of the kd half of ``lumo_tpu/accel/traverse.py``
(``_kd_walk``).  ``csrc/kd_traverse.cu`` is the hand-written Hopper kernel
that replaces the TPU kernel ``pallas_kd._kd_kernel``; it is compiled with
nvcc for sm_90a at first use into the repository's ``build/`` directory
and bound with ctypes.  The TPU's block packing (``pack_kd_blocks``) has
no counterpart: :func:`pack_kd` lays the flat Wald-Havran tree of
``accel/kdtree.py`` out as 8-byte nodes, 4-byte leaf references and one
48-byte record per triangle (see the kernel's source note).

Dispatch is by dtype and device, never by failure: a float64 query (the
reference mode) takes ``bvh_kernel``'s dense plain test over the scene's
float64 vertices on any device (``cuda_build.reference_route``, counted
in ``PLAIN_F64``: the packed tables are float32); otherwise a CPU tensor
takes the plain version, a CUDA tensor launches the kernel or raises.
The plain versions (``closest_hit_plain``, ``any_hit_plain``) are a
per-lane PyTorch walk, the counterpart of ``traverse._kd_walk``, over the
same packed tables the kernel reads, so the CPU tests cover the packer;
the dense test of ``bvh_kernel.closest_hit_plain`` stays the second
yardstick.
``closest_query`` and ``any_query`` call ``closest_hit`` and ``any_hit``
through registered operators (``torch.ops.lumo_tpu_torch.kd_closest`` /
``kd_any``), the route ``scene/trace.py`` takes.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from lumo_tpu_torch.accel import bvh_kernel, cuda_build
from lumo_tpu_torch.accel.walk import (INFLATE, keep_better, leaf_best, rows,
                                        slab_reciprocals, stack_put,
                                        stack_take)
from lumo_tpu_torch.accel.cuda_build import (check_counts, check_no_grad,
                                              check_tensor, count_ptrs, ptr,
                                              raise_on, reference_route,
                                              stream)
from lumo_tpu_torch.config import INF
from lumo_tpu_torch.geometry.intersect import ray_setup

STACK = 64      # per-thread stack of (node, t1) entries of the kernel
LEAF_CHUNK = 8  # references the plain walk tests per step
LEAF = 3        # the axis tag of a leaf
IN_PLANE = 1 << 31  # flag of a stack entry that pops with t0 = 0

# Launches of the kernel's two entry points since the last reset; the
# wrappers add one per launch and nothing else touches them.
LAUNCHES = {"closest": 0, "any": 0}
# float64 queries sent to the dense plain test since the last reset
# (``cuda_build.reference_route``); they launch nothing
PLAIN_F64 = {"closest": 0, "any": 0}

_VP, _CI = ctypes.c_void_p, ctypes.c_int
LIB = cuda_build.Library("kd_traverse", {
    "lumo_kd_closest": [_VP] * 7 + [_CI] + [_VP] * 7,
    "lumo_kd_any": [_VP] * 7 + [_CI] + [_VP] * 6,
    "lumo_kd_grid": [_CI, _CI, _VP],
}, headers=("woop.cuh",))
# the kernel of each query in lumo_kd_grid
GRID_MODES = {"closest": 0, "any": 1}


def pack_kd(kd: dict, a, b, c) -> dict:
    """Flat kd tables -> the kernel's layout, as numpy arrays.

    ``kd`` holds ``split`` (M,) float32, ``axis`` (0/1/2, 3 for a leaf),
    ``right``, ``first``, ``count`` (M,) and ``prims`` (R,) integers, and
    the root bounds ``lo``, ``hi`` (3,); ``a, b, c`` (T, 3) are the
    triangles' vertices in prim order.  Returns

    - ``nodes`` (M, 2) int32: word 0 the bits of ``split`` (inner) or
      ``first`` (leaf), word 1 ``right << 2 | axis`` (inner) or
      ``count << 2 | 3`` (leaf);
    - ``refs`` (R,) int32: ``prims``, the prim id of each leaf reference;
    - ``tris`` (T, 3, 4) float32: each triangle's vertices once, in prim
      order (w = 0);
    - ``root`` (6,) float32: lo.xyz, hi.xyz.

    Raises beyond the layout's limits: ``right`` and ``count`` below
    2**30, R below 2**31, 3 T below 2**31."""
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
    if R >= 1 << 31 or 3 * T >= 1 << 31 or M >= 1 << 30:
        raise ValueError("kd-tree too large for the 32-bit node packing")
    if prims.min(initial=0) < 0 or prims.max(initial=0) >= T:
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
    tris = np.zeros((T, 3, 4), np.float32)
    for j, v in enumerate((a, b, c)):
        tris[:, j, :3] = v
    root = np.concatenate([np.asarray(kd["lo"], np.float32),
                           np.asarray(kd["hi"], np.float32)])
    return {"nodes": nodes, "refs": prims.astype(np.int32), "tris": tris,
            "root": root}


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
    check_tensor("refs", kd["refs"], dev, torch.int32,
                 shape=(kd["refs"].shape[0],))
    check_tensor("tris", kd["tris"], dev, torch.float32, tail=(3, 4))
    check_tensor("root", kd["root"], dev, torch.float32, shape=(6,))
    if N >= 1 << 31:
        raise ValueError("too many rays for one launch")
    check_counts(counts, seen, dev, _marks(kd))


def _marks(kd):
    """The segments of a counting launch's ``seen``: nodes, leaf
    references, triangles."""
    return (kd["nodes"].shape[0], kd["refs"].shape[0], kd["tris"].shape[0])


def _launch(fn, what, kd, o, d, t_max, outs, counts, seen):
    _check_inputs(kd, o, d, t_max, counts, seen)
    rc = getattr(LIB.load(), fn)(
        ptr(kd["nodes"]), ptr(kd["refs"]), ptr(kd["tris"]), ptr(kd["root"]),
        ptr(o), ptr(d), ptr(t_max), o.shape[0], *map(ptr, outs),
        *count_ptrs(_marks(kd), counts, seen), stream(o.device))
    raise_on(rc, what)


def closest_hit(kd, o, d, t_max=INF, counts=None, seen=None):
    """Nearest triangle hit in (0, t_max) per ray -> (t (N,), prim (N,)
    int64), prim = -1 and t = INF on a miss.  ``kd`` is a scene's packed
    kd-tree (``nodes``, ``refs``, ``tris``, ``root`` tensors and
    ``depth``) and, for a float64 query, ``tri``: the scene's (a, b, c)
    vertices in prim order, which it tests.  ``counts``, a zeroed (4,)
    int64 CUDA tensor, receives the kernel's node visits and triangle
    tests and, for each, the sum over warps of the warp's largest lane
    count; ``seen``, a zeroed (M + R + T,) uint8 CUDA tensor given with
    ``counts``, receives a 1 for each of the M nodes, R leaf references
    and T triangles the launch read.  Raises when ``o``,
    ``d`` or ``t_max`` requires grad: the walk is not differentiated."""
    t_max = rows(t_max, o)
    check_no_grad("kd closest-hit", o, d, t_max)
    if reference_route(o, kd.get("tri"), PLAIN_F64, "closest"):
        return bvh_kernel.closest_hit_plain(None, kd["tri"], o, d, t_max)
    if o.device.type == "cpu":
        return closest_hit_plain(kd, o, d, t_max)
    if o.device.type != "cuda":
        raise ValueError(f"unsupported device {o.device}")
    N = o.shape[0]
    t = torch.empty(N, dtype=torch.float32, device=o.device)
    prim = torch.empty(N, dtype=torch.int64, device=o.device)
    _launch("lumo_kd_closest", "kd closest-hit", kd, o, d, t_max,
            (t, prim), counts, seen)
    LAUNCHES["closest"] += 1
    return t, prim


def any_hit(kd, o, d, t_max=INF, counts=None, seen=None):
    """True where any triangle lies in (0, t_max); see :func:`closest_hit`."""
    t_max = rows(t_max, o)
    check_no_grad("kd any-hit", o, d, t_max)
    if reference_route(o, kd.get("tri"), PLAIN_F64, "any"):
        return bvh_kernel.any_hit_plain(None, kd["tri"], o, d, t_max)
    if o.device.type == "cpu":
        return any_hit_plain(kd, o, d, t_max)
    if o.device.type != "cuda":
        raise ValueError(f"unsupported device {o.device}")
    occ = torch.empty(o.shape[0], dtype=torch.bool, device=o.device)
    _launch("lumo_kd_any", "kd any-hit", kd, o, d, t_max, (occ,), counts,
            seen)
    LAUNCHES["any"] += 1
    return occ


# the queries as registered operators, for the selective checkpoint of the
# fixed-depth integrator (see the same section of ``bvh_kernel``)
_KD_ARGS = ("Tensor nodes, Tensor refs, Tensor tris, Tensor root, "
            "Tensor? a, Tensor? b, Tensor? c, int depth, Tensor o, Tensor d, "
            "Tensor t_max")


def _tree(nodes, refs, tris, root, a, b, c, depth):
    tree = {"nodes": nodes, "refs": refs, "tris": tris, "root": root,
            "depth": depth}
    if a is not None:
        tree["tri"] = (a, b, c)
    return tree


def _closest_op(nodes, refs, tris, root, a, b, c, depth, o, d, t_max):
    return closest_hit(_tree(nodes, refs, tris, root, a, b, c, depth), o, d,
                       t_max)


def _any_op(nodes, refs, tris, root, a, b, c, depth, o, d, t_max):
    return any_hit(_tree(nodes, refs, tris, root, a, b, c, depth), o, d,
                   t_max)


# held here: torch keeps operator definitions only weakly
_DEFS = (
    torch.library.custom_op("lumo_tpu_torch::kd_closest", _closest_op,
                            mutates_args=(),
                            schema=f"({_KD_ARGS}) -> (Tensor, Tensor)"),
    torch.library.custom_op("lumo_tpu_torch::kd_any", _any_op,
                            mutates_args=(), schema=f"({_KD_ARGS}) -> Tensor"))


# the operators whose outputs a checkpointed bounce saves
OPS = (torch.ops.lumo_tpu_torch.kd_closest.default,
       torch.ops.lumo_tpu_torch.kd_any.default)


def _tables(kd, tri):
    return (kd["nodes"], kd["refs"], kd["tris"], kd["root"],
            *(tri if tri is not None else (None,) * 3), kd["depth"])


def closest_query(kd, o, d, t_max, tri=None):
    """:func:`closest_hit` through its registered operator; ``tri``, the
    scene's (a, b, c) vertices, are what a float64 query tests."""
    t_max = rows(t_max, o)
    check_no_grad("kd closest-hit", o, d, t_max, tangent=True)
    return torch.ops.lumo_tpu_torch.kd_closest(*_tables(kd, tri), o, d, t_max)


def any_query(kd, o, d, t_max, tri=None):
    """:func:`any_hit` through its registered operator; ``tri`` as in
    :func:`closest_query`."""
    t_max = rows(t_max, o)
    check_no_grad("kd any-hit", o, d, t_max, tangent=True)
    return torch.ops.lumo_tpu_torch.kd_any(*_tables(kd, tri), o, d, t_max)


def grid(query: str, n: int):
    """(resident blocks per SM, blocks of a launch over ``n`` rays) of a
    query's kernel (``GRID_MODES``) on the current card: one thread per
    ray, so ``ceil(n / 128)`` blocks."""
    return cuda_build.grid(LIB, "lumo_kd_grid", GRID_MODES[query], n)


def _walk(kd, o, d, t_max, any_mode):
    """Every lane walks the packed kd-tree as a thread of the kernel does
    (``traverse._kd_walk``): a per-lane (node, t1) stack whose t0 is
    rebuilt on the pop (``IN_PLANE`` entries pop with t0 = 0), near child
    first, leaves consumed ``LEAF_CHUNK`` references per step.  Returns
    (t, prim, occluded)."""
    if kd["depth"] > STACK:
        raise ValueError(f"kd-tree depth {kd['depth']} exceeds the "
                         f"{STACK}-entry stack")
    nodes, refs, tris, root = kd["nodes"], kd["refs"], kd["tris"], kd["root"]
    N, dev = o.shape[0], o.device
    word0 = nodes[:, 0].contiguous()
    n_split = word0.view(torch.float32)
    n_first = word0.to(torch.int64)
    word1 = nodes[:, 1].to(torch.int64) & 0xFFFFFFFF
    n_axis, n_arg = word1 & 3, word1 >> 2
    prim_of = refs.to(torch.int64)
    kz, shear = ray_setup(d)
    inv = slab_reciprocals(d)
    offs = torch.arange(LEAF_CHUNK, device=dev)

    # root entry interval: slab against the root bounds, far side
    # inflated, clipped to [0, t_max]
    s0 = (root[None, :3] - o) * inv
    s1 = (root[None, 3:] - o) * inv
    t0 = torch.minimum(s0, s1).amax(dim=1).clamp(min=0.0)
    t1 = torch.minimum(torch.maximum(s0, s1).amin(dim=1) * INFLATE, t_max)
    live = (t_max > 0.0) & (t0 <= t1)

    # the current cell: node (-1 in a leaf or when the walk is over) and
    # [t0, t1]; stack entries (node | IN_PLANE flag, t1)
    node = torch.where(live, 0, -1)
    stack_n = torch.zeros((N, STACK), dtype=torch.int64, device=dev)
    stack_t1 = torch.zeros((N, STACK), dtype=o.dtype, device=dev)
    sp = torch.zeros(N, dtype=torch.int64, device=dev)
    best_t = torch.full((N,), INF, dtype=o.dtype, device=dev)
    best_p = torch.full((N,), -1, dtype=torch.int64, device=dev)
    lfirst = torch.zeros(N, dtype=torch.int64, device=dev)
    lcount = torch.zeros(N, dtype=torch.int64, device=dev)
    while True:
        if any_mode:
            live = live & (best_p < 0)
        inner = live & (node >= 0)
        in_leaf = live & (node < 0) & (lcount > 0)
        # a leaf with no references left pops
        need_pop = live & (node < 0) & (lcount <= 0)
        if not bool((inner | in_leaf | need_pop).any()):
            break
        # leaf lanes: one chunk of references
        if bool(in_leaf.any()):
            valid = in_leaf[:, None] & (offs[None, :] < lcount[:, None])
            ref = torch.where(valid, lfirst[:, None] + offs[None, :], 0)
            p = prim_of[ref]
            tb, pb = leaf_best(o, kz, shear, tris, p, valid, t_max)
            best_t, best_p = keep_better(best_t, best_p, tb, pb, in_leaf)
            lfirst = torch.where(in_leaf, lfirst + LEAF_CHUNK, lfirst)
            lcount = torch.where(in_leaf,
                                 (lcount - LEAF_CHUNK).clamp(min=0), lcount)

        # pop lanes: the next cell whose start is not beyond the best hit
        popping = need_pop.clone()
        while bool(popping.any()):
            empty = popping & (sp == 0)
            live = live & ~empty
            popping = popping & ~empty
            sp = sp - popping.to(torch.int64)
            slot = sp.clamp(0, STACK - 1)
            e = stack_take(stack_n, slot)
            flag = (e & IN_PLANE) != 0
            t0 = torch.where(popping, torch.where(flag, 0.0, t1), t0)
            t1 = torch.where(popping, stack_take(stack_t1, slot), t1)
            keep = popping if any_mode else popping & (t0 <= best_t)
            node = torch.where(keep, e & (IN_PLANE - 1), node)
            popping = popping & ~keep

        # inner lanes: one node
        nd = node.clamp(min=0)
        ax = n_axis[nd]
        is_leaf = inner & (ax == LEAF)
        lfirst = torch.where(is_leaf, n_first[nd], lfirst)
        lcount = torch.where(is_leaf, n_arg[nd], lcount)
        interior = inner & (ax != LEAF)
        axc = ax.clamp(max=2)[:, None]
        o_a = o.gather(1, axc)[:, 0]
        d_a = d.gather(1, axc)[:, 0]
        split = n_split[nd]
        tplane = (split - o_a) * inv.gather(1, axc)[:, 0]
        below = (o_a < split) | ((o_a == split) & (d_a <= 0.0))
        left, right = nd + 1, n_arg[nd]
        near = torch.where(below, left, right)
        far = torch.where(below, right, left)
        # a ray lying in the split plane visits both children; inv is
        # clamped, so tplane itself is never NaN
        in_plane = (d_a == 0.0) & (o_a == split)
        only_near = (tplane > t1) | (tplane <= 0.0)
        only_far = ~only_near & (tplane < t0)
        both = interior & ((~only_near & ~only_far) | in_plane)
        slot = sp.clamp(max=STACK - 1)
        stack_put(stack_n, slot, torch.where(in_plane, far | IN_PLANE, far),
                  both)
        stack_put(stack_t1, slot, t1, both)
        sp = sp + both.to(torch.int64)
        t1 = torch.where(both & ~in_plane, tplane, t1)
        nxt = torch.where(both | ~only_far, near, far)
        node = torch.where(interior, nxt, torch.where(is_leaf, -1, node))
    hit = best_p >= 0
    return best_t, best_p, hit


def closest_hit_plain(kd, o, d, t_max=INF):
    """Plain PyTorch version of :func:`closest_hit`."""
    t, prim, _ = _walk(kd, o, d, rows(t_max, o), any_mode=False)
    return t, prim


def any_hit_plain(kd, o, d, t_max=INF):
    """Plain PyTorch version of :func:`any_hit`."""
    return _walk(kd, o, d, rows(t_max, o), any_mode=True)[2]
