"""Per-lane steps shared by the plain PyTorch walks of the BVH
(``bvh_kernel.closest_hit_stats_plain``) and the kd-tree
(``kd_kernel``'s plain versions): every ray is a lane of (N,) tensors, as
a thread of the CUDA kernels is, with a per-lane stack and the kernels'
leaf test and update rule.
"""
from __future__ import annotations

import torch

from lumo_tpu_torch.config import INF
from lumo_tpu_torch.geometry.intersect import triangle_t

INFLATE = 1.00000024  # conservative slab inflation of the kernels


def rows(t_max, o):
    """A scalar ``t_max`` as one value per ray of ``o``."""
    if isinstance(t_max, (int, float)):
        return torch.full(o.shape[:1], float(t_max), dtype=o.dtype,
                          device=o.device)
    return t_max


def slab_reciprocals(d):
    """1 / d with |d| < 1e-30 clamped to +-1e-30 (the kernels'
    ``inv_clamped``)."""
    tiny = torch.where(d < 0, -1e-30, 1e-30).to(d.dtype)
    return 1.0 / torch.where(d.abs() < 1e-30, tiny, d)


def stack_put(stack, pos, val, mask):
    """Write ``val`` (N,) at per-lane slot ``pos`` of ``stack`` (N, S)
    where ``mask``, in place."""
    idx = pos[:, None]
    cur = stack.gather(1, idx)
    stack.scatter_(1, idx, torch.where(mask[:, None],
                                       val[:, None].to(stack.dtype), cur))


def stack_take(stack, pos):
    """``stack`` (N, S) -> (N,) value at per-lane slot ``pos``."""
    return stack.gather(1, pos[:, None])[:, 0]


def leaf_best(o, kz, shear, tris, ref, valid, t_max, prim_ids=None):
    """Woop-test the packed triangles ``tris[ref]`` (ref (N, C), masked by
    ``valid``) -> per lane the least t and, among equal t, the least prim
    id (``prim_ids`` (N, C), or ``ref`` itself)."""
    v = tris[ref]                                        # (N, C, 3, 4)
    t, _, _ = triangle_t(o, kz, shear, v[:, :, 0, :3], v[:, :, 1, :3],
                         v[:, :, 2, :3], 0.0, t_max[:, None])
    t = torch.where(valid, t, INF)
    ids = ref if prim_ids is None else prim_ids
    tb = t.amin(dim=1)
    big = torch.iinfo(torch.int64).max
    pb = torch.where(t == tb[:, None], ids, big).amin(dim=1)
    return tb, pb


def keep_better(best_t, best_p, tb, pb, mask):
    """The kernels' update rule: a smaller t wins, equal finite t keeps
    the smaller prim id."""
    better = mask & ((tb < best_t) | ((tb == best_t) & torch.isfinite(tb)
                                      & (pb < best_p)))
    return torch.where(better, tb, best_t), torch.where(better, pb, best_p)
