"""Host-side kd-tree construction (SAH event sweep) -> flat arrays.

Counterpart of ``lumo_tpu/accel/kdtree.py``, itself a counterpart of the
reference's ``Mesh = KdTree<Triangle>`` accelerator
(``src/tracer/object/kdtree.rs``): the Wald-Havran O(n log n) SAH build
(``kdtree/node.rs:124-195``, termination ``:245-256``) runs on the host
and emits flattened node arrays (left child = self + 1, explicit right
index).  ``accel/kd_kernel.py`` packs them for the CUDA traversal kernel.

Unlike the BVH, kd-tree leaves cannot permute the triangle buffers (one
triangle may fall in several leaves), so leaves index through a ``prims``
indirection list, and leaf size is unbounded.

Below 1024 primitives the builder is this numpy code (its Python event
sweep takes seconds per thousand primitives); above it the C++
builder of ``lumo_tpu_torch/native`` runs (thread-forked subtrees like
``kdtree/node.rs:298-320``).
"""
from __future__ import annotations

import dataclasses

import numpy as np

COST_TRAVERSE = 15.0    # reference kdtree/node.rs:7-9
COST_INTERSECT = 20.0
EMPTY_BONUS = 0.2
MAX_DEPTH = 48          # the traversal stack is 64 deep
NATIVE_FROM = 1024      # primitives from which the C++ builder runs


@dataclasses.dataclass
class KdTree:
    split: np.ndarray    # (M,) float32 plane position (interior)
    axis: np.ndarray     # (M,) int32 0/1/2 interior, 3 leaf
    right: np.ndarray    # (M,) int32 right child (left = self + 1)
    first: np.ndarray    # (M,) int32 leaf start into prims
    count: np.ndarray    # (M,) int32 leaf prim count
    prims: np.ndarray    # (R,) int32 leaf -> primitive indirection
    root_lo: np.ndarray  # (3,) scene bounds (traversal entry clip)
    root_hi: np.ndarray
    max_depth: int


def _area(lo, hi):
    e = np.maximum(hi - lo, 0.0)
    return 2.0 * (e[0] * e[1] + e[1] * e[2] + e[2] * e[0])


def _numpy_build(plo, phi):
    """Reference-faithful event-sweep SAH (python recursion; small meshes
    and tests only)."""
    P = len(plo)
    split_l, axis_l, right_l, first_l, count_l = [], [], [], [], []
    prims_l = []
    max_depth = [1]

    def emit(node):
        i = len(axis_l)
        split_l.append(node[0]); axis_l.append(node[1])
        right_l.append(node[2]); first_l.append(node[3]); count_l.append(node[4])
        return i

    def build(ids, nlo, nhi, depth):
        max_depth[0] = max(max_depth[0], depth)
        n = len(ids)
        sa = _area(nlo, nhi)
        best = None  # (cost, ax, pos, planar_left)
        if n > 1 and depth < MAX_DEPTH and sa > 0.0:
            for ax in range(3):
                if nhi[ax] - nlo[ax] <= 1e-12:
                    continue
                s0 = plo[ids, ax]
                e0 = phi[ids, ax]
                planar = s0 == e0
                # events: (pos, type) with END=0 < PLANAR=1 < START=2
                pos = np.concatenate([e0[~planar], s0[planar], s0[~planar]])
                typ = np.concatenate([
                    np.zeros((~planar).sum(), np.int8),
                    np.ones(planar.sum(), np.int8),
                    np.full((~planar).sum(), 2, np.int8)])
                order = np.lexsort((typ, pos))
                pos, typ = pos[order], typ[order]
                # per distinct position: counts of each type
                upos, start_idx = np.unique(pos, return_index=True)
                bounds = np.append(start_idx, len(pos))
                nl, nr = 0, n
                for k, p in enumerate(upos):
                    seg = typ[bounds[k]:bounds[k + 1]]
                    pe = int((seg == 0).sum())
                    pp = int((seg == 1).sum())
                    ps = int((seg == 2).sum())
                    nr -= pp + pe
                    if nlo[ax] < p < nhi[ax]:
                        lhi = nhi.copy(); lhi[ax] = p
                        rlo = nlo.copy(); rlo[ax] = p
                        al, ar = _area(nlo, lhi), _area(rlo, nhi)
                        for nl2, nr2, pl in ((nl + pp, nr, True),
                                             (nl, nr + pp, False)):
                            c = (al * nl2 + ar * nr2) / sa
                            if nl2 == 0 or nr2 == 0:
                                c *= 1.0 - EMPTY_BONUS
                            c = COST_TRAVERSE + COST_INTERSECT * c
                            if best is None or c < best[0]:
                                best = (c, ax, p, pl)
                    nl += ps + pp
        if best is None or best[0] >= COST_INTERSECT * n:
            first = len(prims_l)
            prims_l.extend(ids.tolist())
            return emit((0.0, 3, 0, first, n))
        _, ax, p, planar_left = best
        s0 = plo[ids, ax]
        e0 = phi[ids, ax]
        onplane = (s0 == p) & (e0 == p)
        lmask = (s0 < p) | (onplane if planar_left else False)
        rmask = (e0 > p) | (onplane if not planar_left else False)
        lhi = nhi.copy(); lhi[ax] = p
        rlo = nlo.copy(); rlo[ax] = p
        me = emit((p, ax, 0, 0, 0))
        build(ids[lmask], nlo, lhi, depth + 1)
        right_l[me] = build(ids[rmask], rlo, nhi, depth + 1)
        return me

    rlo = plo.min(axis=0).astype(np.float64)
    rhi = phi.max(axis=0).astype(np.float64)
    build(np.arange(P, dtype=np.int32), rlo.copy(), rhi.copy(), 1)
    return (np.asarray(split_l, np.float32), np.asarray(axis_l, np.int32),
            np.asarray(right_l, np.int32), np.asarray(first_l, np.int32),
            np.asarray(count_l, np.int32), np.asarray(prims_l, np.int32),
            rlo.astype(np.float32), rhi.astype(np.float32), max_depth[0])


def build(prim_lo: np.ndarray, prim_hi: np.ndarray) -> KdTree:
    """Build a kd-tree over per-primitive AABBs (P, 3) each, with the
    native C++ builder (``lumo_tpu_torch/native``) from ``NATIVE_FROM``
    primitives on."""
    if len(prim_lo) == 0:
        raise ValueError("cannot build a kd-tree over no primitives")
    if len(prim_lo) >= NATIVE_FROM:
        from lumo_tpu_torch import native
        return KdTree(*native.build_kdtree(np.asarray(prim_lo),
                                           np.asarray(prim_hi)))
    return KdTree(*_numpy_build(np.asarray(prim_lo, np.float64),
                                np.asarray(prim_hi, np.float64)))
