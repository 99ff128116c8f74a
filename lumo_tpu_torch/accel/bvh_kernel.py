"""BVH closest-hit and any-hit queries: the CUDA kernel and its plain
PyTorch version.

Counterpart of ``lumo_tpu/accel/pallas_bvh.py`` (``closest_hit``,
``any_hit``).  ``csrc/bvh_traverse.cu`` is the hand-written Hopper kernel
that replaces the TPU kernel ``pallas_bvh._traverse_kernel``; it is
compiled with nvcc for sm_90a at first use into the repository's
``build/`` directory and bound with ctypes.

Dispatch is by dtype and device, never by failure: a float64 query (the
reference mode) takes the plain version in float64 on any device
(``cuda_build.reference_route``, counted in ``PLAIN_F64``); otherwise a
CPU tensor takes the plain version, a CUDA tensor launches the kernel or
raises.  The plain versions (``closest_hit_plain``, ``any_hit_plain``)
are a chunked dense Woop test over the BVH's triangles with
``geometry.intersect.triangle_t`` and an argmin (lowest index on ties, as
the kernel breaks them); the CPU tests use them, and ``chip_smoke.py``
holds the kernel against them on the card.
``closest_query`` and ``any_query`` call ``closest_hit`` and ``any_hit``
through registered operators (``torch.ops.lumo_tpu_torch.bvh_closest`` /
``bvh_any``), the route ``scene/trace.py`` takes, so that a checkpointed
bounce can save their outputs.

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
from lumo_tpu_torch.accel.cuda_build import (check_counts, check_no_grad,
                                              check_tensor, count_ptrs, ptr,
                                              raise_on, reference_route,
                                              stream)
from lumo_tpu_torch.accel.walk import (INFLATE, keep_better, leaf_best, rows,
                                        slab_reciprocals, stack_put,
                                        stack_take)
from lumo_tpu_torch.config import INF
from lumo_tpu_torch.geometry.intersect import ray_setup, triangle_t

STACK = 64  # per-thread traversal stack of the kernel
WARP = 32   # lanes that share a program counter on the card
LEAF_MAX = 7  # triangles a leaf may hold in the link packing
LEAF, DONE = -1, -2  # walk states of the plain walk besides a record
LEAF_LINK = 1 << 30  # links from here on are leaves
# rays of one launch: the work counter of the persistent kernel is an int32
# that may run past the count by a warp per resident warp
MAX_RAYS = 1 << 30

# Launches of the kernel's entry points since the last reset; the wrappers
# add one per launch and nothing else touches them.
LAUNCHES = {"closest": 0, "any": 0, "stats": 0}
# float64 queries sent to the plain version since the last reset
# (``cuda_build.reference_route``); they launch nothing
PLAIN_F64 = {"closest": 0, "any": 0, "stats": 0}

_VP, _CI = ctypes.c_void_p, ctypes.c_int
LIB = cuda_build.Library("bvh_traverse", {
    "lumo_bvh_closest": [_VP] * 5 + [_CI] + [_VP] * 7,
    "lumo_bvh_any": [_VP] * 5 + [_CI] + [_VP] * 6,
    "lumo_bvh_closest_stats": [_VP] * 5 + [_CI] + [_VP] * 5,
    "lumo_bvh_grid": [_CI, _CI, _VP],
}, headers=("woop.cuh", "persistent.cuh"))
# the kernel of each query in lumo_bvh_grid
GRID_MODES = {"closest": 0, "any": 1, "stats": 4}


def pack_nodes(bvh: dict) -> np.ndarray:
    """Binary DFS tables (``lo``, ``hi``, ``right``, ``first``, ``count``,
    ``axis``; left child = i + 1) -> (K, 4, 4) float32 child-pair records
    for the kernel, one per inner node in DFS order: (lo.xyz of child 0,
    bits(link 0)), (hi.xyz of child 0, bits(link 1)), (lo.xyz of child 1,
    0), (hi.xyz of child 1, 0).  A link below ``LEAF_LINK`` is an inner
    child's record, one from it on a leaf with link - LEAF_LINK = first << 3
    | count (first < 2**26, so no link word is a NaN pattern).  A tree that
    is one leaf gets one record whose second child is an empty leaf."""
    lo = np.asarray(bvh["lo"], np.float32)
    hi = np.asarray(bvh["hi"], np.float32)
    right = np.asarray(bvh["right"], np.int64)
    axis = np.asarray(bvh["axis"], np.int64)
    first = np.asarray(bvh["first"], np.int64)
    count = np.asarray(bvh["count"], np.int64)
    if count.max(initial=0) > LEAF_MAX or count.min(initial=0) < 0:
        raise ValueError(f"leaf counts must lie in [0, {LEAF_MAX}] for the "
                         "link packing")
    if first.max(initial=0) >= 1 << 26 or len(right) >= LEAF_LINK:
        raise ValueError("BVH too large for the 32-bit link packing")
    if axis.min(initial=0) < 0 or axis.max(initial=0) > 2:
        raise ValueError("split axis out of range")
    M = len(right)
    inner = count == 0
    inner_ids = np.nonzero(inner)[0]
    if np.any(right[inner_ids] <= inner_ids + 1) or np.any(right[inner_ids] >= M):
        raise ValueError("BVH right child out of range")
    record = np.cumsum(inner) - 1
    link = np.where(inner, record,
                    LEAF_LINK + ((first << 3) | count)).astype(np.int32)
    if not inner[0]:                     # the whole tree is one leaf
        out = np.zeros((1, 4, 4), np.float32)
        out[0, 0, :3], out[0, 2, :3] = lo[0], lo[0]
        out[0, 1, :3], out[0, 3, :3] = hi[0], hi[0]
        out[0, :2, 3] = np.array([link[0], LEAF_LINK],
                                 np.int32).view(np.float32)
        return out
    left, rgt = inner_ids + 1, right[inner_ids]
    out = np.zeros((len(inner_ids), 4, 4), np.float32)
    out[:, 0, :3], out[:, 1, :3] = lo[left], hi[left]
    out[:, 2, :3], out[:, 3, :3] = lo[rgt], hi[rgt]
    out[:, 0, 3] = link[left].view(np.float32)
    out[:, 1, 3] = link[rgt].view(np.float32)
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
    check_tensor("nodes", bvh["nodes"], dev, torch.float32, tail=(4, 4))
    check_tensor("tris", bvh["tris"], dev, torch.float32, tail=(3, 4))
    if N >= MAX_RAYS:
        raise ValueError("too many rays for one launch")
    check_counts(counts, seen, dev, _marks(bvh))


def _marks(bvh):
    """The segments of a counting launch's ``seen``: records, triangles."""
    return (bvh["nodes"].shape[0], bvh["tris"].shape[0])


def _launch(fn, what, bvh, o, d, t_max, outs, counts, seen):
    _check_inputs(bvh, o, d, t_max, counts, seen)
    lib = LIB.load()
    work = torch.zeros(1, dtype=torch.int32, device=o.device)
    extra = () if fn == "lumo_bvh_closest_stats" else count_ptrs(
        _marks(bvh), counts, seen)
    rc = getattr(lib, fn)(
        ptr(bvh["nodes"]), ptr(bvh["tris"]), ptr(o), ptr(d), ptr(t_max),
        o.shape[0], *map(ptr, outs), *extra, ptr(work), stream(o.device))
    raise_on(rc, what)


def grid(query: str, n: int):
    """(resident blocks per SM, blocks of a launch over ``n`` rays) of a
    query's kernel (``GRID_MODES``) on the current card: the resident grid
    (that many blocks on every SM), or fewer when ``n`` rays fill fewer."""
    return cuda_build.grid(LIB, "lumo_bvh_grid", GRID_MODES[query], n)


def closest_hit(bvh, tri, o, d, t_max=INF, counts=None, seen=None):
    """Nearest triangle hit in (0, t_max) per ray -> (t (N,), prim (N,)
    int64), prim = -1 and t = INF on a miss.  ``bvh`` is a scene's BVH
    dict; ``tri`` its (a, b, c) leaf-order vertices, read by the plain
    version.  ``counts``, a zeroed (4,) int64 CUDA tensor, receives the
    kernel's record fetches, triangle tests and the warp trips of its
    interior and leaf phases; ``seen``, a zeroed (K + T,) uint8 CUDA
    tensor given with ``counts``, receives a 1 for each of the K records
    and T triangles the launch read.  Raises when ``o``, ``d`` or
    ``t_max`` requires grad: the walk is not differentiated."""
    t_max = rows(t_max, o)
    check_no_grad("BVH closest-hit", o, d, t_max)
    if (reference_route(o, tri, PLAIN_F64, "closest")
            or o.device.type == "cpu"):
        return closest_hit_plain(bvh, tri, o, d, t_max)
    if o.device.type != "cuda":
        raise ValueError(f"unsupported device {o.device}")
    N = o.shape[0]
    t = torch.empty(N, dtype=torch.float32, device=o.device)
    prim = torch.empty(N, dtype=torch.int64, device=o.device)
    _launch("lumo_bvh_closest", "BVH closest-hit", bvh, o, d, t_max,
            (t, prim), counts, seen)
    LAUNCHES["closest"] += 1
    return t, prim


def any_hit(bvh, tri, o, d, t_max=INF, counts=None, seen=None):
    """True where any triangle lies in (0, t_max); see :func:`closest_hit`."""
    t_max = rows(t_max, o)
    check_no_grad("BVH any-hit", o, d, t_max)
    if reference_route(o, tri, PLAIN_F64, "any") or o.device.type == "cpu":
        return any_hit_plain(bvh, tri, o, d, t_max)
    if o.device.type != "cuda":
        raise ValueError(f"unsupported device {o.device}")
    occ = torch.empty(o.shape[0], dtype=torch.bool, device=o.device)
    _launch("lumo_bvh_any", "BVH any-hit", bvh, o, d, t_max, (occ,), counts,
            seen)
    LAUNCHES["any"] += 1
    return occ


# ---------------------------------------------------------------------------
# the queries as registered operators

# ``scene/trace.py`` calls the queries through these two operators, so that
# the fixed-depth integrator's selective checkpoint (which sees operators,
# not Python functions) can save their outputs and never run a walk again
# in the backward.  Each calls the module's ``closest_hit`` / ``any_hit`` as
# looked up at call time: the kernel on a CUDA tensor, the plain version on
# a CPU one, or whatever a caller patched in.
_BVH_ARGS = ("Tensor nodes, Tensor tris, Tensor a, Tensor b, Tensor c, "
             "int depth, Tensor o, Tensor d, Tensor t_max")


def _closest_op(nodes, tris, a, b, c, depth, o, d, t_max):
    return closest_hit({"nodes": nodes, "tris": tris, "depth": depth},
                       (a, b, c), o, d, t_max)


def _any_op(nodes, tris, a, b, c, depth, o, d, t_max):
    return any_hit({"nodes": nodes, "tris": tris, "depth": depth}, (a, b, c),
                   o, d, t_max)


# held here: torch keeps operator definitions only weakly
_DEFS = (
    torch.library.custom_op("lumo_tpu_torch::bvh_closest", _closest_op,
                            mutates_args=(),
                            schema=f"({_BVH_ARGS}) -> (Tensor, Tensor)"),
    torch.library.custom_op("lumo_tpu_torch::bvh_any", _any_op,
                            mutates_args=(), schema=f"({_BVH_ARGS}) -> Tensor"))


# the operators whose outputs a checkpointed bounce saves
OPS = (torch.ops.lumo_tpu_torch.bvh_closest.default,
       torch.ops.lumo_tpu_torch.bvh_any.default)


def closest_query(bvh, tri, o, d, t_max):
    """:func:`closest_hit` through its registered operator."""
    t_max = rows(t_max, o)
    check_no_grad("BVH closest-hit", o, d, t_max, tangent=True)
    return torch.ops.lumo_tpu_torch.bvh_closest(
        bvh["nodes"], bvh["tris"], *tri, bvh["depth"], o, d, t_max)


def any_query(bvh, tri, o, d, t_max):
    """:func:`any_hit` through its registered operator."""
    t_max = rows(t_max, o)
    check_no_grad("BVH any-hit", o, d, t_max, tangent=True)
    return torch.ops.lumo_tpu_torch.bvh_any(
        bvh["nodes"], bvh["tris"], *tri, bvh["depth"], o, d, t_max)


def _chunks(o, T):
    """(ray chunk, triangle chunk) sizes bounding the (R, C) candidate
    tensors at ~2**24 elements on the card, 2**18 on the CPU; the
    triangle chunk widens (up to all T) as the live rays ``o`` thin out,
    so a wavefront's tail takes few passes."""
    budget = 1 << (24 if o.device.type == "cuda" else 18)
    C = max(1, min(T, max(4096, budget // max(o.shape[0], 1))))
    return max(1, budget // C), C


def _dense_rows(tri, o, d, t_max):
    """Yield (ray indices, tri offset, t (R, C)) over the chunked dense
    test of the live lanes; a dead lane (t_max <= 0, or NaN) misses, as in
    the kernel, and is left out."""
    a, b, c = tri
    T = a.shape[0]
    live = torch.nonzero(t_max > 0.0)[:, 0]
    o, t_max = o[live], t_max[live]
    kz, shear = ray_setup(d[live])
    R, C = _chunks(o, T)
    for r0 in range(0, live.shape[0], R):
        rs = slice(r0, r0 + R)
        for c0 in range(0, T, C):
            cs = slice(c0, min(T, c0 + C))
            t, _, _ = triangle_t(o[rs], kz[rs], shear[rs], a[None, cs],
                                 b[None, cs], c[None, cs], 0.0,
                                 t_max[rs, None])
            yield live[rs], c0, t


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
    """Per-ray counters (N, K) -> (ceil(N / 32), 2, K) int32: per group
    of 32 consecutive rays the sum and the maximum over its rays.  SIMT
    efficiency of a counter, had each group run as one warp from start to
    end, is ``sum / (32 * max)``."""
    N, K = per_ray.shape
    W = (N + WARP - 1) // WARP
    padded = torch.zeros((W * WARP, K), dtype=per_ray.dtype,
                         device=per_ray.device)
    padded[:N] = per_ray
    lanes = padded.view(W, WARP, K)
    return torch.stack([lanes.sum(1), lanes.amax(1)], dim=1).to(torch.int32)


def closest_hit_stats(bvh, tri, o, d, t_max=INF):
    """:func:`closest_hit` plus traversal counters -> (t, prim, stats).
    ``stats`` is (ceil(N / 32), 2, 3) int32: for each group of 32
    consecutive rays the sum and the maximum over its rays of (inner
    records fetched, leaves entered, triangles tested)."""
    t_max = rows(t_max, o)
    if reference_route(o, tri, PLAIN_F64, "stats"):
        # the same walk over the float64 leaf-order vertices (the packed
        # ``tris`` are float32)
        return closest_hit_stats_plain(dict(bvh, tris=torch.stack(tri, 1)),
                                       tri, o, d, t_max)
    if o.device.type == "cpu":
        return closest_hit_stats_plain(bvh, tri, o, d, t_max)
    if o.device.type != "cuda":
        raise ValueError(f"unsupported device {o.device}")
    N = o.shape[0]
    t = torch.empty(N, dtype=torch.float32, device=o.device)
    prim = torch.empty(N, dtype=torch.int64, device=o.device)
    stats = torch.zeros(((N + WARP - 1) // WARP, 2, 3), dtype=torch.int32,
                        device=o.device)
    _launch("lumo_bvh_closest_stats", "BVH closest-hit stats", bvh, o, d,
            t_max, (t, prim, stats), None, None)
    LAUNCHES["stats"] += 1
    return t, prim, stats


def unpack_nodes(nodes):
    """The kernel's (K, 4, 4) records -> (lo0, hi0, lo1, hi1 (K, 3),
    link0, link1 (K,) int64): the two children's boxes and links."""
    links = nodes[:, :2, 3].contiguous().view(torch.int32).to(torch.int64)
    return (nodes[:, 0, :3], nodes[:, 1, :3], nodes[:, 2, :3],
            nodes[:, 3, :3], links[:, 0], links[:, 1])


def _slab(lo, hi, o, inv, bound):
    """The kernel's conservative slab test against (0, bound) -> (hit,
    entry distance)."""
    t0 = (lo - o) * inv
    t1 = (hi - o) * inv
    tn = torch.minimum(t0, t1).amax(dim=1)
    tf = torch.maximum(t0, t1).amin(dim=1) * INFLATE
    return (tn <= tf) & (tf > 0.0) & (tn < bound * INFLATE), tn


def closest_hit_stats_plain(bvh, tri, o, d, t_max=INF):
    """Plain PyTorch version of :func:`closest_hit_stats`: every lane
    walks the packed ``bvh["nodes"]`` and ``bvh["tris"]`` as a thread of
    the kernel does (both children of a record tested, the nearer hit one
    by entry distance first, the other stacked with its entry distance; a
    popped entry skipped unless it starts below the best hit inflated by
    1.00000024) and counts the same three things (``tri`` unused)."""
    t_max = rows(t_max, o)
    N, dev = o.shape[0], o.device
    if bvh["depth"] > STACK:
        raise ValueError(f"BVH depth {bvh['depth']} exceeds the "
                         f"{STACK}-entry stack")
    lo0, hi0, lo1, hi1, link0, link1 = unpack_nodes(bvh["nodes"])
    kz, shear = ray_setup(d)
    inv = slab_reciprocals(d)
    offs = torch.arange(LEAF_MAX, device=dev)
    active = t_max > 0.0
    cur = torch.where(active, 0, DONE)
    tri0 = torch.zeros(N, dtype=torch.int64, device=dev)
    tri_end = torch.zeros(N, dtype=torch.int64, device=dev)
    sp = torch.zeros(N, dtype=torch.int64, device=dev)
    stack_l = torch.zeros((N, STACK), dtype=torch.int64, device=dev)
    stack_t = torch.zeros((N, STACK), dtype=o.dtype, device=dev)
    best_t = torch.full((N,), INF, dtype=o.dtype, device=dev)
    best_p = torch.full((N,), -1, dtype=torch.int64, device=dev)
    stats = torch.zeros((N, 3), dtype=torch.int64, device=dev)
    while bool(active.any()):
        inner = active & (cur >= 0)
        leaf = active & (cur == LEAF)
        # inner lanes: one record, both children
        r = cur.clamp(min=0)
        bound = torch.minimum(best_t, t_max)
        h0, tn0 = _slab(lo0[r], hi0[r], o, inv, bound)
        h1, tn1 = _slab(lo1[r], hi1[r], o, inv, bound)
        h0, h1 = h0 & inner, h1 & inner
        stats[:, 0] += inner
        both = h0 & h1
        first0 = tn0 <= tn1
        l0, l1 = link0[r], link1[r]
        stack_put(stack_l, sp.clamp(max=STACK - 1),
                  torch.where(first0, l1, l0), both)
        stack_put(stack_t, sp.clamp(max=STACK - 1),
                  torch.where(first0, tn1, tn0), both)
        sp = sp + both.to(torch.int64)
        nxt = torch.where(both, torch.where(first0, l0, l1),
                          torch.where(h0, l0, l1))
        # leaf lanes: all their triangles
        if bool(leaf.any()):
            n_t = tri_end - tri0
            valid = leaf[:, None] & (offs[None, :] < n_t[:, None])
            ref = torch.where(valid, tri0[:, None] + offs[None, :], 0)
            tb, pb = leaf_best(o, kz, shear, bvh["tris"], ref, valid, t_max)
            best_t, best_p = keep_better(best_t, best_p, tb, pb, leaf)
            stats[:, 2] += torch.where(leaf, n_t, 0)
        # lanes with no hit child and leaf lanes pop
        popping = (inner & ~(h0 | h1)) | leaf
        nxt = torch.where(popping, -1, nxt)
        done = torch.zeros_like(active)
        pop_bound = torch.minimum(best_t, t_max) * INFLATE
        while bool(popping.any()):
            empty = popping & (sp == 0)
            done = done | empty
            popping = popping & ~empty
            sp = sp - popping.to(torch.int64)
            slot = sp.clamp(0, STACK - 1)
            keep = popping & (stack_take(stack_t, slot) < pop_bound)
            nxt = torch.where(keep, stack_take(stack_l, slot), nxt)
            popping = popping & ~keep
        # go to the next link: a record, or a leaf's triangles
        moving = (inner | leaf) & ~done
        enter = moving & (nxt >= LEAF_LINK)
        code = nxt - LEAF_LINK
        tri0 = torch.where(enter, code >> 3, tri0)
        tri_end = torch.where(enter, (code >> 3) + (code & 7), tri_end)
        stats[:, 1] += enter
        cur = torch.where(done, DONE, torch.where(
            enter, LEAF, torch.where(moving, nxt, cur)))
        active = active & ~done
    return best_t, best_p, warp_stats(stats)
