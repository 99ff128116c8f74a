"""Host-side BVH construction over triangle soups (numpy).

Counterpart of ``lumo_tpu/accel/build.py``, itself a counterpart of the
reference's two-phase builder
(``src/tracer/object/bvh.rs:232-313`` + ``bvh/node.rs``): the reference
Morton-sorts then splits top-down with full-sweep SAH above depth 15 and
Morton-bit splits below.  Here we build top-down with binned SAH (16 bins,
the standard Wald 2007 formulation — same quality class as the reference's
sweep at a fraction of the host cost), leaf size <= 4
(``bvh.rs:10``), COST_INTERSECT/COST_TRAVERSE ratio preserved
(``bvh/node.rs:4-6``).

Output is a flattened DFS array — left child = self+1, explicit ``right``
index (``bvh/node.rs:8-14``) — plus the primitive permutation that makes
every leaf's triangles contiguous, so device traversal needs no extra
indirection gather.

Below 4096 primitives the builder is this numpy code; above it the C++
builder of ``lumo_tpu_torch/native`` runs.  That one orders leaves by
thread completion, so its prim order need not match another build's.
"""
from __future__ import annotations

import dataclasses

import numpy as np

LEAF_SIZE = 4          # reference ``bvh.rs:10``
N_BINS = 16
COST_INTERSECT = 15.0  # reference ``bvh/node.rs:4-6``
COST_TRAVERSE = 20.0


@dataclasses.dataclass
class BVH:
    """Flattened BVH. M nodes; leaves have count > 0 and ``first`` indexing
    the permuted primitive array."""
    node_lo: np.ndarray     # (M, 3) float32
    node_hi: np.ndarray     # (M, 3)
    node_right: np.ndarray  # (M,) int32 — right child (interior) / unused
    node_first: np.ndarray  # (M,) int32 — first prim (leaf) / unused
    node_count: np.ndarray  # (M,) int32 — prim count (leaf) / 0 (interior)
    node_axis: np.ndarray   # (M,) int32 — split axis (interior)
    order: np.ndarray       # (P,) int32 — permutation old->new prim order
    depth: int              # max stack depth needed


def _sah_binned_split(lo, hi, cent, idx, node_lo, node_hi):
    """Binned SAH over 3 axes.  Returns (axis, left_ids, right_ids) or None
    when no split beats the leaf cost."""
    n = len(idx)
    best = (None, np.inf)
    ext = node_hi - node_lo
    area_parent = _area(node_lo, node_hi)
    if area_parent <= 0.0:
        return None
    c = cent[idx]
    for axis in range(3):
        if ext[axis] <= 1e-12:
            continue
        t = (c[:, axis] - node_lo[axis]) / ext[axis]
        b = np.clip((t * N_BINS).astype(np.int32), 0, N_BINS - 1)
        counts = np.bincount(b, minlength=N_BINS)
        if counts.max() == n:
            continue
        # per-bin bounds via reduceat-style accumulation
        bin_lo = np.full((N_BINS, 3), np.inf)
        bin_hi = np.full((N_BINS, 3), -np.inf)
        np.minimum.at(bin_lo, b, lo[idx])
        np.maximum.at(bin_hi, b, hi[idx])
        # prefix/suffix sweeps
        lcnt = np.cumsum(counts)[:-1]
        rcnt = n - lcnt
        llo = np.minimum.accumulate(bin_lo, axis=0)[:-1]
        lhi = np.maximum.accumulate(bin_hi, axis=0)[:-1]
        rlo = np.minimum.accumulate(bin_lo[::-1], axis=0)[::-1][1:]
        rhi = np.maximum.accumulate(bin_hi[::-1], axis=0)[::-1][1:]
        la = _area_v(llo, lhi)
        ra = _area_v(rlo, rhi)
        cost = COST_TRAVERSE + COST_INTERSECT * (la * lcnt + ra * rcnt) / area_parent
        cost = np.where((lcnt == 0) | (rcnt == 0), np.inf, cost)
        cut = int(np.argmin(cost))
        if cost[cut] < best[1]:
            best = ((axis, cut, b.copy()), cost[cut])
    # only called with n > LEAF_SIZE: any usable SAH split beats an
    # oversized leaf, so there is no leaf-cost test
    if best[0] is None:
        return None
    axis, cut, b = best[0]
    left_mask = b <= cut
    return axis, idx[left_mask], idx[~left_mask]


def _area(lo, hi):
    e = np.maximum(hi - lo, 0.0)
    return 2.0 * (e[0] * e[1] + e[1] * e[2] + e[2] * e[0])


def _area_v(lo, hi):
    e = np.maximum(hi - lo, 0.0)
    return 2.0 * (e[:, 0] * e[:, 1] + e[:, 1] * e[:, 2] + e[:, 2] * e[:, 0])


MEDIAN_DEPTH = 32  # force balanced median splits below this depth — bounds
                   # total depth by MEDIAN_DEPTH + log2(P) (device stack size)


def build(prim_lo: np.ndarray, prim_hi: np.ndarray) -> BVH:
    """Build from per-primitive AABBs (P, 3) each, with the native C++
    builder (``lumo_tpu_torch/native``) from 4096 primitives on."""
    P = len(prim_lo)
    if P == 0:
        raise ValueError("cannot build a BVH over no primitives")
    if P >= 4096:
        from lumo_tpu_torch import native
        (node_lo, node_hi, node_right, node_first, node_count,
         node_axis, order, depth) = native.build_bvh(np.asarray(prim_lo),
                                                     np.asarray(prim_hi))
        return BVH(node_lo=node_lo, node_hi=node_hi,
                   node_right=node_right, node_first=node_first,
                   node_count=node_count, node_axis=node_axis,
                   order=order, depth=depth)
    prim_lo = np.asarray(prim_lo, np.float64)
    prim_hi = np.asarray(prim_hi, np.float64)
    cent = 0.5 * (prim_lo + prim_hi)

    nodes = []  # [lo(3), hi(3), right, first, count, axis]
    order = np.empty(P, np.int64)
    state = {"placed": 0, "max_depth": 1}

    import sys
    sys.setrecursionlimit(max(10000, sys.getrecursionlimit()))

    def build_node(idx, depth):
        """Append this subtree in DFS preorder; return its slot."""
        slot = len(nodes)
        nodes.append(None)
        state["max_depth"] = max(state["max_depth"], depth)
        nlo = prim_lo[idx].min(axis=0)
        nhi = prim_hi[idx].max(axis=0)
        split = None
        if len(idx) > LEAF_SIZE:
            if depth < MEDIAN_DEPTH:
                split = _sah_binned_split(prim_lo, prim_hi, cent, idx, nlo, nhi)
            if split is None:
                # median split — guarantees progress and bounded depth
                axis = int(np.argmax(nhi - nlo))
                srt = idx[np.argsort(cent[idx, axis], kind="stable")]
                half = len(idx) // 2
                split = (axis, srt[:half], srt[half:])
        if split is None:
            first = state["placed"]
            order[first:first + len(idx)] = idx
            state["placed"] += len(idx)
            nodes[slot] = [nlo, nhi, 0, first, len(idx), 0]
        else:
            axis, lidx, ridx = split
            build_node(lidx, depth + 1)          # left = slot + 1
            right_slot = build_node(ridx, depth + 1)
            nodes[slot] = [nlo, nhi, right_slot, 0, 0, axis]
        return slot

    build_node(np.arange(P), 1)
    assert state["placed"] == P
    arr = lambda i, dt: np.asarray([nd[i] for nd in nodes], dt)
    return BVH(
        node_lo=arr(0, np.float32), node_hi=arr(1, np.float32),
        node_right=arr(2, np.int32), node_first=arr(3, np.int32),
        node_count=arr(4, np.int32), node_axis=arr(5, np.int32),
        order=order.astype(np.int32), depth=state["max_depth"],
    )


def triangle_bounds(a, b, c):
    """Per-triangle AABBs from vertex arrays (T, 3)."""
    lo = np.minimum(np.minimum(a, b), c)
    hi = np.maximum(np.maximum(a, b), c)
    # pad degenerate (axis-aligned flat) boxes
    pad = 1e-8 + 1e-6 * np.abs(hi - lo).max(axis=-1, keepdims=True)
    flat = (hi - lo) < 1e-12
    return np.where(flat, lo - pad, lo), np.where(flat, hi + pad, hi)
