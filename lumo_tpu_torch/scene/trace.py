"""Device-side scene queries over ray wavefronts: intersection, occlusion,
light sampling, emission.

Counterpart of the triangle parts of ``lumo_tpu/scene/trace.py``
(reference ``scene.rs`` hit / hit_light / transmittance and the
Sampleable light methods, ``triangle.rs:215-241``).  Small scenes are
tested densely; BVH scenes go through ``accel.bvh_kernel`` (the CUDA
kernel on the card), with the split-out walls tested densely first so
that every walk starts pruned; kd-tree scenes go through
``accel.kd_kernel`` and keep their walls in the tree.  Plain indexing replaces the JAX package's
one-hot gathers.

The traversal is not differentiated: the walks get detached rays and
``t_max`` (``lumo_tpu/scene/trace.py:111-112,128,481-482``), and the hit
distance they return is re-derived differentiably from the prim id by
:class:`_HitT` (``_hit_t``, ``lumo_tpu/scene/trace.py:59-94``).  The dense
path (small scenes, and the split-out walls of a BVH scene) stays plain
differentiable ``triangle_t``.
"""
from __future__ import annotations

import torch

from lumo_tpu_torch.accel import bvh_kernel, kd_kernel
from lumo_tpu_torch.accel.walk import rows
from lumo_tpu_torch.color import dense, uplift
from lumo_tpu_torch.config import INF
from lumo_tpu_torch.geometry import intersect as geo
from lumo_tpu_torch.geometry.onb import cross, dot, norm, normalize
from lumo_tpu_torch.scene.materials import LIGHT
from lumo_tpu_torch.scene.scene import SceneData


# the registered traversal operators, whose outputs a checkpointed bounce
# saves (``integrators/path_trace.py``)
QUERY_OPS = frozenset(bvh_kernel.OPS + kd_kernel.OPS)


def _bvh_tris(scene: SceneData):
    """The BVH's triangles, as its plain version reads them (detached:
    the walk is not differentiated)."""
    n = scene.n_bvh_tris
    return tuple(x[:n].detach() for x in (scene.tri_a, scene.tri_b,
                                          scene.tri_c))


def _wall_t(scene: SceneData, o, d, t_max):
    """(N, W) hit distances against the split-out walls
    [n_bvh_tris, n_tris)."""
    n = scene.n_bvh_tris
    kz, shear = geo.ray_setup(d)
    t, _, _ = geo.triangle_t(o, kz, shear, scene.tri_a[None, n:],
                             scene.tri_b[None, n:], scene.tri_c[None, n:],
                             0.0, t_max[..., None])
    return t


class _HitT(torch.autograd.Function):
    """Differentiable hit distance of a traversal query.  Forward: the
    kernel's own ``t_k`` where ``hit``, INF elsewhere, with no triangle
    gather.  Backward: gathers each lane's triangle by ``prim`` (its row
    of the vertex tables ``a``, ``b``, ``c``) and pulls the cotangent
    through the Woop recompute of ``t``, gated by ``hit`` and a finite
    recomputed ``t``; the walk itself stays opaque."""

    @staticmethod
    def forward(ctx, o, d, a, b, c, prim, t_k, hit):
        ctx.save_for_backward(o, d, a, b, c, prim, hit)
        return torch.where(hit, t_k, INF)

    @staticmethod
    def backward(ctx, g):
        o, d, a, b, c, prim, hit = ctx.saved_tensors
        need = ctx.needs_input_grad[:5]
        with torch.enable_grad():
            leaves = [o.detach(), d.detach(),
                      *(x.detach()[prim] for x in (a, b, c))]
            for x, n in zip(leaves, need):
                x.requires_grad_(n)
            kz, shear = geo.ray_setup(leaves[1])
            t_re, _, _ = geo.triangle_t(leaves[0], kz, shear,
                                        *(x[:, None] for x in leaves[2:]),
                                        0.0, INF)
            t_re = t_re[:, 0]
            gate = hit & torch.isfinite(t_re)
            wanted = [x for x, n in zip(leaves, need) if n]
            grads = iter(torch.autograd.grad(
                t_re, wanted, torch.where(gate, g, 0.0)) if wanted else ())
        out = [next(grads) if n else None for n in need]
        for i, table in ((2, a), (3, b), (4, c)):
            if out[i] is not None:      # rows back into the vertex table
                out[i] = torch.zeros_like(table).index_add_(0, prim, out[i])
        return (*out, None, None, None)


def _hit_t(scene: SceneData, o, d, t_k, p):
    """The traversal's (t_k, prim p, -1 on a miss) as a differentiable hit
    distance over the scene's global triangle tables."""
    p_safe = torch.clamp(p, 0, max(scene.n_tris - 1, 0))
    return _HitT.apply(o, d, scene.tri_a, scene.tri_b, scene.tri_c, p_safe,
                       t_k, p >= 0)


def _closest(scene: SceneData, o, d, t_max):
    """(t, global prim id) closest hit: kd-tree or BVH traversal when
    built, dense otherwise (prim 0 with t = INF on a miss)."""
    t_max = rows(t_max, o)
    if scene.kdtree is not None:
        t_k, p = kd_kernel.closest_query(scene.kdtree, o.detach(), d.detach(),
                                         t_max.detach())
        return _hit_t(scene, o, d, t_k, p), torch.where(p < 0, 0, p)
    if scene.bvh is None:
        kz, shear = geo.ray_setup(d)
        ts, _, _ = geo.triangle_t(o, kz, shear, scene.tri_a[None],
                                  scene.tri_b[None], scene.tri_c[None], 0.0,
                                  t_max[..., None])
        prim = torch.argmin(ts, dim=-1)
        return torch.gather(ts, -1, prim[..., None])[..., 0], prim
    # split-out walls: dense test whose hit distance seeds the walk's
    # t_max, so most bounce rays (which end on a wall) start pruned
    t_huge = p_huge = None
    tm = t_max.detach()
    if scene.n_bvh_tris < scene.n_tris:
        th_all = _wall_t(scene, o, d, t_max)
        p_huge = torch.argmin(th_all, dim=-1)
        t_huge = torch.gather(th_all, -1, p_huge[..., None])[..., 0]
        tm = torch.minimum(tm, torch.where(torch.isfinite(t_huge),
                                           t_huge.detach() * 1.0001, tm))
    t_k, p = bvh_kernel.closest_query(scene.bvh, _bvh_tris(scene), o.detach(),
                                      d.detach(), tm)
    t = _hit_t(scene, o, d, t_k, p)
    prim = torch.where(p < 0, 0, p)
    if t_huge is not None:
        better = t_huge < t
        t = torch.where(better, t_huge, t)
        prim = torch.where(better, scene.n_bvh_tris + p_huge, prim)
    return t, prim


def intersect(scene: SceneData, o, d, t_max=None, alive=None):
    """Closest hit for a wavefront; o, d (N, 3).  Dead lanes (``alive``
    false) get t_max 0 and return a miss.  Returns a hit dict."""
    N = o.shape[0]
    t_max = rows(INF if t_max is None else t_max, o)
    if alive is not None:
        t_max = torch.where(alive, t_max, 0.0)
    t, prim = _closest(scene, o, d, t_max)
    valid = torch.isfinite(t)
    T = scene.n_tris
    tidx = torch.clamp(prim, 0, max(T - 1, 0))
    det = geo.triangle_detail(
        o, d, scene.tri_a[tidx], scene.tri_b[tidx], scene.tri_c[tidx],
        scene.tri_na[tidx], scene.tri_nb[tidx], scene.tri_nc[tidx],
        scene.tri_uva[tidx], scene.tri_uvb[tidx], scene.tri_uvc[tidx])
    n_pl = scene.prim_light.shape[0]
    return {
        "valid": valid, "t": torch.where(valid, t, INF), "prim": prim,
        "mat": scene.tri_mat[tidx],
        "p": det["p"], "ng": det["ng"], "ns": det["ns"], "uv": det["uv"],
        "err": det["err"], "backface": dot(d, det["ng"]) > 0.0,
        "light": torch.where(prim < n_pl,
                             scene.prim_light[torch.clamp(prim, 0, n_pl - 1)],
                             -1),
        "is_medium": torch.zeros(N, dtype=torch.bool, device=o.device),
    }


def occluded(scene: SceneData, o, d, t_max):
    """Any hit within (0, t_max); t_max (N,).  Rays the split-out walls
    already block enter the walk dead (t_max 0)."""
    t_max = rows(t_max, o)
    if scene.kdtree is not None:
        return kd_kernel.any_query(scene.kdtree, o.detach(), d.detach(),
                                   t_max.detach())
    if scene.bvh is None:
        kz, shear = geo.ray_setup(d)
        ts, _, _ = geo.triangle_t(o, kz, shear, scene.tri_a[None],
                                  scene.tri_b[None], scene.tri_c[None], 0.0,
                                  t_max[..., None])
        return torch.isfinite(ts).any(dim=-1)
    o, d, tm = o.detach(), d.detach(), t_max.detach()
    occ_huge = None
    if scene.n_bvh_tris < scene.n_tris:
        occ_huge = torch.isfinite(_wall_t(scene, o, d, tm)).any(dim=-1)
        tm = torch.where(occ_huge, 0.0, tm)
    occ = bvh_kernel.any_query(scene.bvh, _bvh_tris(scene), o, d, tm)
    return occ if occ_huge is None else occ | occ_huge


def emitted(scene: SceneData, mat, lam, uv, backface):
    """Emitted radiance (N, 4) of material ids ``mat`` at wavelengths
    ``lam`` (reference ``material.rs:223-234``)."""
    m = scene.materials
    ke = uplift.sample(m["ke"][mat][..., None, :], lam)
    illum = dense.sample_rows(m["illum"], mat, lam)
    scale = m["emit_scale"][mat][..., None]
    is_light = (m["kind"][mat] == LIGHT)[..., None]
    visible = (m["two_sided"][mat] | ~backface)[..., None]
    return torch.where(is_light & visible, scale * ke * illum, 0.0)


def sample_light(scene: SceneData, u):
    """O(1) alias-table lookup: uniform u (N,) -> (light index, pdf)
    (reference ``bvh.rs:67-77``)."""
    L = scene.n_lights
    x = u * L
    idx = torch.clamp(x.to(torch.int64), 0, L - 1)
    frac = x - idx.to(x.dtype)
    accept = frac < scene.alias_p[idx]
    light = torch.where(accept, idx, scene.alias_idx[idx])
    return light, scene.light_pdf[light]


def _light_geom(scene: SceneData, light):
    """The chosen light triangles' vertices and material."""
    prim = scene.light_prim[light]
    return {"prim": prim, "a": scene.tri_a[prim], "b": scene.tri_b[prim],
            "c": scene.tri_c[prim], "mat": scene.tri_mat[prim]}


def sample_towards(scene: SceneData, light, xo, u):
    """Direction from xo (N, 3) towards a sqrt-warp area sample of light
    ``light`` (N,), u (N, 2) (reference ``triangle.rs:219-241``)."""
    g = _light_geom(scene, light)
    gamma = 1.0 - torch.sqrt(torch.clamp(1.0 - u[..., 0], min=0.0))
    beta = u[..., 1] * (1.0 - gamma)
    xi = (g["a"] + beta[..., None] * (g["b"] - g["a"])
          + gamma[..., None] * (g["c"] - g["a"]))
    return normalize(xi - xo)


def light_hit(scene: SceneData, light, o, d):
    """Intersect each ray with its chosen light triangle only
    (``light.hit(r)`` inside reference ``scene.hit_light``,
    ``scene.rs:165-189``)."""
    g = _light_geom(scene, light)
    kz, shear = geo.ray_setup(d)
    t, _, _ = geo.triangle_t(o, kz, shear, g["a"][:, None], g["b"][:, None],
                             g["c"][:, None], 0.0, INF)
    t = t[:, 0]
    z3 = torch.zeros_like(g["a"])
    z2 = torch.zeros(g["a"].shape[:-1] + (2,), dtype=o.dtype, device=o.device)
    det = geo.triangle_detail(o, d, g["a"], g["b"], g["c"], z3, z3, z3,
                              z2, z2, z2)
    return {"valid": torch.isfinite(t), "t": t, "p": det["p"],
            "ng": det["ng"], "uv": det["uv"], "mat": g["mat"],
            "backface": dot(d, det["ng"]) > 0.0}


def sample_towards_pdf(scene: SceneData, light, o, d, xi, ng):
    """Solid-angle pdf of :func:`sample_towards` for the ray (o, d)
    reaching xi with light normal ng (reference ``object.rs:141-157``)."""
    g = _light_geom(scene, light)
    rel = xi - o
    dist2 = dot(rel, rel)
    cos_l = torch.abs(dot(ng, d))
    # edge-on lights: zero the pdf so the MIS mask drops the sample
    cos_ok = cos_l > 1e-7
    area = 0.5 * norm(cross(g["b"] - g["a"], g["c"] - g["a"]))
    den = torch.where(cos_ok, area * cos_l, 1.0)
    return torch.where(cos_ok, dist2 / torch.clamp(den, min=1e-30), 0.0)


def transmittance(scene: SceneData, lam, t):
    """Medium transmittance over distance t: all ones, as no medium is
    ported yet (``SceneBuilder.set_medium`` raises)."""
    return torch.ones_like(lam)
