"""Device-side scene queries over ray wavefronts: intersection, occlusion,
light sampling, emission, medium transmittance.

Counterpart of ``lumo_tpu/scene/trace.py`` (reference ``scene.rs`` hit /
hit_light / transmittance, ``medium.rs``, ``instance.rs`` and the
Sampleable light methods, ``triangle.rs:215-241``, ``sphere.rs:135-207``,
``disk.rs:131-160``).  Small scenes are tested densely; BVH scenes go
through ``accel.bvh_kernel`` (the CUDA kernel on the card), with the
split-out walls tested densely first so that every walk starts pruned;
kd-tree scenes go through ``accel.kd_kernel`` and keep their walls in the
tree.  Spheres and analytic shapes are few and always tested densely,
and join the closest hit after the walk.  Plain indexing replaces the
JAX package's one-hot gathers.

Runtime-instanced groups join last (reference ``instance.rs:81-105``):
the rays go into each instance's local space without renormalising the
direction, so a local hit distance is the world one, and each group's
BVH (``accel.bvh_kernel``, whatever the scene's ``accel``; dense below
``BVH_THRESHOLD`` triangles) is walked once per instance where a group
has at most ``FLAT_MIN - 1`` instances, else once over all N * I
instance rays of the wavefront.  The two forms of the local rays are the
JAX package's own, which round differently: a matrix product per
instance, and einsums, here fused multiply-add chains (``_matvec``), as
XLA computes them on the CPU.  Unlike the JAX package, the group walks
of ``intersect`` honour the query's ``t_max`` (ROADMAP.md section 3): a
dead lane misses every group too.

The traversal is not differentiated: the walks get detached rays and
``t_max`` (``lumo_tpu/scene/trace.py:111-112,128,481-482``), and the hit
distance they return is re-derived differentiably from the prim id, in
reverse and in forward mode, by :class:`_HitT` (``_hit_t`` and its
``_hit_t_jvp``, ``lumo_tpu/scene/trace.py:59-94``).  The dense
tests (small scenes, the split-out walls of a BVH scene, spheres and
analytic shapes) stay plain differentiable torch.

A scene with a medium needs the per-ray counter state ``rng`` and a salt
in ``intersect`` and ``occluded``: the free-flight draws are counter
hashes of them, as every other draw is.
"""
from __future__ import annotations

import math

import torch

from lumo_tpu_torch import telemetry
from lumo_tpu_torch import texture as texture_mod
from lumo_tpu_torch.accel import bvh_kernel, kd_kernel
from lumo_tpu_torch.accel.walk import rows
from lumo_tpu_torch.color import dense, uplift
from lumo_tpu_torch.config import INF, LAMBDA_MAX, LAMBDA_MIN, gamma_bound
from lumo_tpu_torch.geometry import analytic
from lumo_tpu_torch.geometry import intersect as geo
from lumo_tpu_torch.geometry import onb
from lumo_tpu_torch.geometry.onb import cross, dot, norm, normalize, onb_frame
from lumo_tpu_torch.sampling import maps
from lumo_tpu_torch.sampling.samplers import _randfloat
from lumo_tpu_torch.scene.materials import LIGHT
from lumo_tpu_torch.scene.scene import TRI_KEYS, SceneData

PI = math.pi
# groups of this many instances or more take one flattened N * I query
FLAT_MIN = 5


# the registered traversal operators, whose outputs a checkpointed bounce
# saves (``integrators/path_trace.py``)
QUERY_OPS = frozenset(bvh_kernel.OPS + kd_kernel.OPS)
# the query wrappers (one registered operator each) called in this process
_CALLED = set()


def _query(fn, *args):
    """``fn(*args)`` for a query wrapper of ``bvh_kernel`` or
    ``kd_kernel``; the first call of each in the process is the
    ``setup.first_query`` span (an operator's first dispatch loads torch's
    compiler stack, and the first kernel launch loads its library)."""
    if fn in _CALLED:
        return fn(*args)
    with telemetry.span("setup.first_query"):
        out = fn(*args)
    _CALLED.add(fn)
    return out


def _bvh_tris(scene: SceneData):
    """The triangles under the BVH (all of them under a kd-tree), in the
    scene's dtype, as the plain versions read them (detached: the walk is
    not differentiated)."""
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
    gather.  Backward and forward-mode tangent: gather each lane's
    triangle by ``prim`` (its row of the vertex tables ``a``, ``b``,
    ``c``) and carry the derivative through the Woop recompute of ``t``,
    gated by the primal-only condition ``hit`` and a finite recomputed
    ``t``; the walk itself stays opaque."""

    @staticmethod
    def forward(ctx, o, d, a, b, c, prim, t_k, hit):
        ctx.save_for_backward(o, d, a, b, c, prim, hit)
        ctx.save_for_forward(o, d, a, b, c, prim, hit)
        return torch.where(hit, t_k, INF)

    @staticmethod
    def _rows_grad(ctx, need, g):
        """(t_re, per-lane gradients of ``sum(g * t_re)`` over the leaves
        (o, d, a[prim], b[prim], c[prim]), None where not ``need``)."""
        o, d, a, b, c, prim, hit = ctx.saved_tensors
        # the recompute's own graph keeps its saved tensors: a checkpointed
        # bounce's hooks must not pack them (they would recompute the
        # bounce from inside its own forward)
        with torch.enable_grad(), torch.autograd.graph.saved_tensors_hooks(
                lambda x: x, lambda x: x):
            leaves = [o.detach(), d.detach(),
                      *(x.detach()[prim] for x in (a, b, c))]
            for x, n in zip(leaves, need):
                x.requires_grad_(n)
            kz, shear = geo.ray_setup(leaves[1])
            t_re = geo.triangle_t(leaves[0], kz, shear,
                                  *(x[:, None] for x in leaves[2:]), 0.0,
                                  INF)[0][:, 0]
            gate = hit & torch.isfinite(t_re)
            wanted = [x for x, n in zip(leaves, need) if n]
            grads = iter(torch.autograd.grad(
                t_re, wanted, torch.where(gate, g, 0.0)) if wanted else ())
        return t_re.detach(), [next(grads) if n else None for n in need]

    @staticmethod
    def backward(ctx, g):
        _, out = _HitT._rows_grad(ctx, ctx.needs_input_grad[:5], g)
        _, _, a, b, c, prim, _ = ctx.saved_tensors
        for i, table in ((2, a), (3, b), (4, c)):
            if out[i] is not None:      # rows back into the vertex table
                out[i] = torch.zeros_like(table).index_add_(0, prim, out[i])
        return (*out, None, None, None)

    @staticmethod
    def jvp(ctx, do, dd, da, db, dc, *_):
        # lane i's t reads only row i of each leaf, so the per-lane
        # gradient of sum(t) dotted with the tangents is the exact
        # tangent; absent tangents are zeros (JAX's SymbolicZero)
        prim, hit = ctx.saved_tensors[5:]
        tans = [do, dd, *(None if x is None else x[prim]
                          for x in (da, db, dc))]
        need = [x is not None for x in tans]
        g = torch.ones(prim.shape, dtype=ctx.saved_tensors[0].dtype,
                       device=prim.device)
        if not any(need):
            return torch.zeros_like(g)
        t_re, grads = _HitT._rows_grad(ctx, need, g)
        dt = sum((r * x).sum(-1) for r, x in zip(grads, tans) if r is not None)
        return torch.where(hit & torch.isfinite(t_re), dt, 0.0)


def _hit_t(scene: SceneData, o, d, t_k, p):
    """The traversal's (t_k, prim p, -1 on a miss) as a differentiable hit
    distance over the scene's global triangle tables."""
    p_safe = torch.clamp(p, 0, max(scene.n_tris - 1, 0))
    return _HitT.apply(o, d, scene.tri_a, scene.tri_b, scene.tri_c, p_safe,
                       t_k, p >= 0)


def _sphere_t(scene: SceneData, o, d, t_max):
    """(N, S) hit distances against the spheres; t_max (N,)."""
    return geo.sphere_t(o, d, scene.sph_center[None], scene.sph_radius[None],
                        0.0, t_max[..., None])


def _analytic_t(scene: SceneData, o, d, t_max):
    """(N, A) hit distances against the analytic shapes; t_max (N,)."""
    return analytic.analytic_t(o, d, scene.ana_kind, scene.ana_rot,
                               scene.ana_trans, scene.ana_radius,
                               scene.ana_height, 0.0, t_max[..., None])


def _all_t(scene: SceneData, o, d, t_max):
    """(N, P) candidate hit distances over every primitive, in global prim
    order; t_max (N,)."""
    parts = []
    if scene.n_tris:
        kz, shear = geo.ray_setup(d)
        parts.append(geo.triangle_t(o, kz, shear, scene.tri_a[None],
                                    scene.tri_b[None], scene.tri_c[None],
                                    0.0, t_max[..., None])[0])
    if scene.n_spheres:
        parts.append(_sphere_t(scene, o, d, t_max))
    if scene.n_analytic:
        parts.append(_analytic_t(scene, o, d, t_max))
    if not parts:
        return torch.full(o.shape[:-1] + (1,), INF, dtype=o.dtype,
                          device=o.device)
    return torch.cat(parts, dim=-1)


def _argmin_t(ts):
    """(t, index) of the nearest candidate per row (the first on ties)."""
    j = torch.argmin(ts, dim=-1)
    return torch.gather(ts, -1, j[..., None])[..., 0], j


def _closest(scene: SceneData, o, d, t_max):
    """(t, global prim id) closest hit (prim 0 with t = INF on a miss):
    the kd-tree or BVH walk over triangles when built, then the spheres
    and analytic shapes densely; everything densely otherwise; then the
    instanced groups."""
    t_max = rows(t_max, o)
    if scene.kdtree is None and scene.bvh is None:
        t, prim = _argmin_t(_all_t(scene, o, d, t_max))
    else:
        t, prim = _tree_closest(scene, o, d, t_max)
    return _instanced_closest(scene, o, d, t_max, t, prim)


def _tree_closest(scene: SceneData, o, d, t_max):
    """:func:`_closest` of a scene with a tree, before the groups."""
    if scene.kdtree is not None:
        t_k, p = _query(kd_kernel.closest_query, scene.kdtree, o.detach(),
                        d.detach(), t_max.detach(), _bvh_tris(scene))
        t, prim = _hit_t(scene, o, d, t_k, p), torch.where(p < 0, 0, p)
    else:
        # split-out walls: dense test whose hit distance seeds the walk's
        # t_max, so most bounce rays (which end on a wall) start pruned
        t_huge = p_huge = None
        tm = t_max.detach()
        if scene.n_bvh_tris < scene.n_tris:
            t_huge, p_huge = _argmin_t(_wall_t(scene, o, d, t_max))
            tm = torch.minimum(tm, torch.where(torch.isfinite(t_huge),
                                               t_huge.detach() * 1.0001, tm))
        t_k, p = _query(bvh_kernel.closest_query, scene.bvh,
                        _bvh_tris(scene), o.detach(), d.detach(), tm)
        t, prim = _hit_t(scene, o, d, t_k, p), torch.where(p < 0, 0, p)
        if t_huge is not None:
            better = t_huge < t
            t = torch.where(better, t_huge, t)
            prim = torch.where(better, scene.n_bvh_tris + p_huge, prim)
    base = scene.n_tris
    for n, fam_t in ((scene.n_spheres, _sphere_t),
                     (scene.n_analytic, _analytic_t)):
        if n:
            tf, j = _argmin_t(fam_t(scene, o, d, t_max))
            prim = torch.where(tf < t, base + j, prim)
            t = torch.minimum(t, tf)
        base += n
    return t, prim


def _matvec(m, v):
    """m @ v over the last axes, (..., 3, 3) x (..., 3) -> (..., 3), as the
    fused multiply-add chain over j = 0, 1, 2 that the JAX package's
    einsums round as on the CPU."""
    out = m[..., 0] * v[..., None, 0]
    out = torch.addcmul(out, m[..., 1], v[..., None, 1])
    return torch.addcmul(out, m[..., 2], v[..., None, 2])


def _local_rays(grp, i, o, d):
    """Rays (N, 3) in the local space of instance ``i`` of a group."""
    minv = grp["minv"][i]
    return (o - grp["trans"][i]) @ minv.T, d @ minv.T


def _flat_rays(grp, o, d):
    """The rays of every instance of a group in local space, (N * I, 3)
    each with instance i of ray n at row n * I + i."""
    minv = grp["minv"]
    ol = _matvec(minv, o[:, None]) - _matvec(minv, grp["trans"])
    dl = _matvec(minv, d[:, None])
    return ol.reshape(-1, 3).contiguous(), dl.reshape(-1, 3).contiguous()


def _group_tris(grp):
    return tuple(grp[k].detach() for k in "abc")


def _group_t(grp, o, d, t_max):
    """(M, Tg) dense hit distances against a group's triangles."""
    kz, shear = geo.ray_setup(d)
    return geo.triangle_t(o, kz, shear, *(x[None] for x in _group_tris(grp)),
                          0.0, t_max[..., None])[0]


def _group_hit(grp, o, d, t_max):
    """(t, p) closest hit of local rays o, d (M, 3) against one group,
    p = -1 on a miss: K2 through its registered operator where the group
    has a BVH, the dense test otherwise, on detached rays; t is
    differentiable in o, d and the group's vertices (:class:`_HitT`)."""
    o_s, d_s, tm = o.detach(), d.detach(), t_max.detach()
    if grp["bvh"] is not None:
        t_k, p = _query(bvh_kernel.closest_query, grp["bvh"],
                        _group_tris(grp), o_s, d_s, tm)
    else:
        t_k, p = _argmin_t(_group_t(grp, o_s, d_s, tm))
        p = torch.where(torch.isfinite(t_k), p, -1)
    p_safe = torch.clamp(p, 0, grp["a"].shape[0] - 1)
    return _HitT.apply(o, d, grp["a"], grp["b"], grp["c"], p_safe, t_k,
                       p >= 0), p


def _group_any(grp, o, d, t_max):
    """Any hit of detached local rays against one group."""
    if grp["bvh"] is not None:
        return _query(bvh_kernel.any_query, grp["bvh"], _group_tris(grp), o,
                      d, t_max)
    return torch.isfinite(_group_t(grp, o, d, t_max)).any(dim=-1)


def _instanced_closest(scene: SceneData, o, d, t_max, t, prim):
    """Fold the instanced groups into the closest hit (t, prim); a group
    walk starts pruned at the best hit so far (and at ``t_max``).  Prim
    ids: T + S + A, then per group instance-major."""
    base = scene.n_tris + scene.n_spheres + scene.n_analytic
    for grp in scene.inst:
        Tg, I = grp["a"].shape[0], grp["minv"].shape[0]
        if I < FLAT_MIN:
            for i in range(I):
                tg, pg = _group_hit(grp, *_local_rays(grp, i, o, d),
                                    torch.minimum(t, t_max))
                better = tg < t
                t = torch.where(better, tg, t)
                prim = torch.where(better, base + i * Tg + pg, prim)
        else:
            tm = torch.minimum(t, t_max).repeat_interleave(I)
            tg, pg = _group_hit(grp, *_flat_rays(grp, o, d), tm)
            tb, ii = _argmin_t(tg.view(-1, I))
            pb = torch.gather(pg.view(-1, I), 1, ii[:, None])[:, 0]
            better = tb < t
            t = torch.where(better, tb, t)
            prim = torch.where(better, base + ii * Tg + pb, prim)
        base += I * Tg
    return t, prim


def _instanced_occluded(scene: SceneData, o, d, t_max, occ):
    """Any hit against the instanced groups, or'ed into ``occ``; a lane
    already occluded enters each further walk with t_max 0."""
    o_s, d_s = o.detach(), d.detach()
    for grp in scene.inst:
        I = grp["minv"].shape[0]
        if I < FLAT_MIN:
            for i in range(I):
                tm = torch.where(occ, 0.0, t_max.detach())
                occ = occ | _group_any(grp, *_local_rays(grp, i, o_s, d_s),
                                       tm)
        else:
            tm = torch.where(occ, 0.0, t_max.detach()).repeat_interleave(I)
            occ = occ | _group_any(grp, *_flat_rays(grp, o_s, d_s),
                                   tm).view(-1, I).any(dim=1)
    return occ


def _instanced_detail(scene: SceneData, o, d, t_det, prim, det, mat):
    """Shading data of the lanes whose prim is instanced: the local
    triangle's details under the instance's forward map, normals by the
    inverse transpose (reference ``instance.rs:81-127``), the instance's
    material; ``det`` and ``mat`` elsewhere."""
    basep = scene.n_tris + scene.n_spheres + scene.n_analytic
    for grp in scene.inst:
        Tg, I = grp["a"].shape[0], grp["minv"].shape[0]
        in_g = (prim >= basep) & (prim < basep + I * Tg)
        li = torch.clamp(prim - basep, 0, I * Tg - 1)
        ii, ti = li // Tg, li % Tg
        minv, mfwd, tr = grp["minv"][ii], grp["mfwd"][ii], grp["trans"][ii]
        dg = geo.triangle_detail(_matvec(minv, o - tr), _matvec(minv, d),
                                 *(grp[k][ti] for k in TRI_KEYS))
        minv_t = minv.transpose(1, 2)
        ng = normalize(_matvec(minv_t, dg["ng"]), eps=1e-30)
        has_ns = (dg["ns"] * dg["ns"]).sum(-1, keepdim=True) > 1e-12
        ns = torch.where(has_ns, normalize(_matvec(minv_t, dg["ns"]),
                                           eps=1e-30), ng)
        p = _matvec(mfwd, dg["p"]) + tr
        # t_det, not raw t: 0 * INF on a miss lane would poison gradients
        err = gamma_bound(9) * (torch.abs(p) + torch.abs(tr)
                                + torch.abs(t_det[..., None] * d))
        dd = {"p": p, "ng": ng, "ns": ns, "uv": dg["uv"], "err": err}
        det = {k: _pick(in_g, dd[k], det[k]) for k in det}
        mat = torch.where(in_g, grp["mat"][ii], mat)
        basep += I * Tg
    return det, mat


def _medium_free_flight(scene: SceneData, rng, salt):
    """A free-flight distance (world units) per lane through the medium
    (reference ``medium.rs:99-127``): the density at one uniformly drawn
    wavelength, an exponential flight, scaled by t_scale.  The two draws
    are counter hashes of the per-ray state ``rng`` and ``salt``.
    Returns (t_med, has_density)."""
    med = scene.medium
    u0 = _randfloat(rng, salt ^ 0x94D049BB)
    u1 = _randfloat(rng, salt ^ 0xBF58476D)
    lam_u = LAMBDA_MIN + u0 * (LAMBDA_MAX - LAMBDA_MIN)
    density = uplift.sample(med["sigma_t"][None, :], lam_u[..., None])[..., 0]
    inside_t = -torch.log(torch.clamp(1.0 - u1, min=1e-30)) \
        / torch.clamp(density, min=1e-30)
    return inside_t / med["t_scale"], density > 0.0


def _need_rng(scene, rng, what):
    if scene.medium is not None and rng is None:
        raise ValueError(f"the scene has a medium: {what} needs the per-ray "
                         "counter state rng")


def _pick(mask, a, b):
    return torch.where(mask[..., None] if a.ndim > mask.ndim else mask, a, b)


def intersect(scene: SceneData, o, d, t_max=None, rng=None, salt=0,
              alive=None):
    """Closest hit for a wavefront; o, d (N, 3).  Dead lanes (``alive``
    false) get t_max 0 and return a miss.  ``rng`` and ``salt`` drive the
    medium's free flight (reference ``scene.rs:118-147``).  Returns a hit
    dict."""
    _need_rng(scene, rng, "intersect")
    N = o.shape[0]
    t_max = rows(INF if t_max is None else t_max, o)
    if alive is not None:
        t_max = torch.where(alive, t_max, 0.0)
    t, prim = _closest(scene, o, d, t_max)
    valid = torch.isfinite(t)
    T, S, A = scene.n_tris, scene.n_spheres, scene.n_analytic
    # miss lanes must not feed INF into the detail math (o + t d)
    t_det = _finite(t) if S or A or scene.inst else None

    fams = []                   # (first prim id, end prim id, detail, mat)
    if T:
        tidx = torch.clamp(prim, 0, T - 1)
        det = geo.triangle_detail(
            o, d, scene.tri_a[tidx], scene.tri_b[tidx], scene.tri_c[tidx],
            scene.tri_na[tidx], scene.tri_nb[tidx], scene.tri_nc[tidx],
            scene.tri_uva[tidx], scene.tri_uvb[tidx], scene.tri_uvc[tidx])
        fams.append((0, T, det, scene.tri_mat[tidx]))
    if S:
        sidx = torch.clamp(prim - T, 0, S - 1)
        det = geo.sphere_detail(o, d, t_det, scene.sph_center[sidx],
                                scene.sph_radius[sidx])
        fams.append((T, T + S, det, scene.sph_mat[sidx]))
    if A:
        aidx = torch.clamp(prim - T - S, 0, A - 1)
        det = analytic.analytic_detail(
            o, d, t_det, scene.ana_kind[aidx], scene.ana_rot[aidx],
            scene.ana_trans[aidx], scene.ana_radius[aidx],
            scene.ana_height[aidx])
        fams.append((T + S, T + S + A, det, scene.ana_mat[aidx]))
    if not fams:                      # an empty scene: every lane misses
        z3 = torch.zeros_like(o)
        fams.append((0, 0, {"p": z3, "ng": z3, "ns": z3, "err": z3,
                            "uv": torch.zeros_like(o[..., :2])},
                     torch.zeros_like(prim)))
    *_, det, mat = fams[-1]
    for first, end, dd, mm in reversed(fams[:-1]):
        mask = (prim >= first) & (prim < end) if first else prim < end
        det = {k: _pick(mask, dd[k], det[k]) for k in det}
        mat = torch.where(mask, mm, mat)
    det, mat = _instanced_detail(scene, o, d, t_det, prim, det, mat)

    backface = dot(d, det["ng"]) > 0.0
    # normal mapping: perturb ns in its per-hit frame
    # (reference ``material.rs:324-331``)
    ns = det["ns"]
    if scene.n_normal_maps:
        nm = telemetry.gather(scene.materials["nm_tex"], mat)
        n_tan = texture_mod.normal_at(scene.textures, nm, det["uv"])
        ns = torch.where((nm >= 0)[..., None],
                         normalize(onb.to_world(ns, n_tan)), ns)
    # instanced prims (ids past the prim_light table) are never lights
    n_pl = scene.prim_light.shape[0]
    out = {
        "valid": valid, "t": torch.where(valid, t, INF), "prim": prim,
        "mat": mat, "p": det["p"], "ng": det["ng"], "ns": ns,
        "uv": det["uv"], "err": det["err"], "backface": backface,
        "light": torch.where(prim < n_pl,
                             scene.prim_light[torch.clamp(prim, 0, n_pl - 1)],
                             -1),
        "is_medium": torch.zeros(N, dtype=torch.bool, device=o.device),
    }
    if scene.medium is not None:
        t_med, has_density = _medium_free_flight(scene, rng, salt)
        p_med = o + t_med[..., None] * d
        in_bounds = ((p_med >= scene.bounds[0])
                     & (p_med <= scene.bounds[1])).all(dim=-1)
        m = has_density & (t_med > 0.0) & (t_med < out["t"]) & in_bounds
        # a pseudo-hit with +z normals; shading_cosine cancels the dot
        # (reference ``medium.rs:75-96``)
        z = torch.zeros_like(o)
        z[..., 2] = 1.0
        m3 = m[..., None]
        out.update(
            valid=out["valid"] | m, t=torch.where(m, t_med, out["t"]),
            mat=torch.where(m, scene.medium["mat"], out["mat"]),
            p=torch.where(m3, p_med, out["p"]),
            ng=torch.where(m3, z, out["ng"]), ns=torch.where(m3, z, out["ns"]),
            uv=torch.where(m3, 0.0, out["uv"]),
            err=torch.where(m3, 0.0, out["err"]),
            backface=out["backface"] & ~m,
            light=torch.where(m, -1, out["light"]), is_medium=m)
    return out


def occluded(scene: SceneData, o, d, t_max, rng=None, salt=0):
    """Any hit within (0, t_max); t_max (N,).  Rays the split-out walls
    already block enter the walk dead (t_max 0).  A medium blocks shadow
    rays stochastically by a free flight (reference
    ``scene.rs:171-177``)."""
    _need_rng(scene, rng, "occluded")
    t_max = rows(t_max, o)
    if scene.kdtree is None and scene.bvh is None:
        occ = torch.isfinite(_all_t(scene, o, d, t_max)).any(dim=-1)
    else:
        o_s, d_s, tm = o.detach(), d.detach(), t_max.detach()
        occ_huge = None
        if scene.kdtree is not None:
            occ = _query(kd_kernel.any_query, scene.kdtree, o_s, d_s, tm,
                         _bvh_tris(scene))
        else:
            if scene.n_bvh_tris < scene.n_tris:
                occ_huge = torch.isfinite(_wall_t(scene, o_s, d_s,
                                                  tm)).any(dim=-1)
                tm = torch.where(occ_huge, 0.0, tm)
            occ = _query(bvh_kernel.any_query, scene.bvh, _bvh_tris(scene),
                         o_s, d_s, tm)
            if occ_huge is not None:
                occ = occ | occ_huge
        if scene.n_spheres:
            occ = occ | torch.isfinite(_sphere_t(scene, o, d,
                                                 t_max)).any(dim=-1)
        if scene.n_analytic:
            occ = occ | torch.isfinite(_analytic_t(scene, o, d,
                                                   t_max)).any(dim=-1)
    occ = _instanced_occluded(scene, o, d, t_max, occ)
    if scene.medium is not None:
        t_med, has_density = _medium_free_flight(scene, rng, salt)
        occ = occ | (has_density & (t_med > 0.0) & (t_med < t_max))
    return occ


def emitted(scene: SceneData, mat, lam, uv, backface):
    """Emitted radiance (N, 4) of material ids ``mat`` at wavelengths
    ``lam``, a texture's where ``ke_tex`` names one (reference
    ``material.rs:223-234``)."""
    m = scene.materials
    ke = uplift.sample(telemetry.gather(m["ke"], mat)[..., None, :], lam)
    if scene.textures is not None:
        tid = telemetry.gather(m["ke_tex"], mat)
        val = texture_mod.albedo(scene.textures, tid, lam, uv,
                                 kinds=scene.tex_kinds)
        ke = torch.where((tid >= 0)[..., None], val, ke)
    illum = dense.sample_rows(m["illum"], mat, lam)
    scale = telemetry.gather(m["emit_scale"], mat)[..., None]
    is_light = (telemetry.gather(m["kind"], mat) == LIGHT)[..., None]
    visible = (telemetry.gather(m["two_sided"], mat) | ~backface)[..., None]
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


def _light_geom(scene: SceneData, light, normals=False):
    """The chosen lights' primitive data: each present family's gathered
    rows (with ``normals`` also the triangles' vertex normals) and, where
    more than one family is present, the family masks ``is_tri``,
    ``is_sph``, ``is_ana`` that :func:`_merge_fams` selects by."""
    prim = scene.light_prim[light]
    T, S, A = scene.n_tris, scene.n_spheres, scene.n_ana_lights
    g = {"prim": prim}
    several = (T > 0) + (S > 0) + (A > 0) > 1
    if several:
        false = torch.zeros_like(prim, dtype=torch.bool)
        is_tri = prim < T if T else false
        is_ana = prim >= T + S if A else false
        g.update(is_tri=is_tri, is_ana=is_ana, is_sph=~is_tri & ~is_ana)
    # a family's row of every lane (clamped where another family's lanes
    # would index out of its table)
    rows = lambda first, n: (torch.clamp(prim - first, 0, n - 1) if several
                             else prim - first if first else prim)
    if T:
        tidx = rows(0, T)
        g.update(a=scene.tri_a[tidx], b=scene.tri_b[tidx],
                 c=scene.tri_c[tidx], mat_tri=scene.tri_mat[tidx])
        if normals:
            g.update(na=scene.tri_na[tidx], nb=scene.tri_nb[tidx],
                     nc=scene.tri_nc[tidx])
    if S:
        sidx = rows(T, S)
        g.update(center=scene.sph_center[sidx], radius=scene.sph_radius[sidx],
                 mat_sph=scene.sph_mat[sidx])
    if A:
        aidx = torch.clamp(prim - T - S, 0, scene.n_analytic - 1)
        g.update(ana_rot=scene.ana_rot[aidx], ana_trans=scene.ana_trans[aidx],
                 ana_radius=scene.ana_radius[aidx],
                 mat_ana=scene.ana_mat[aidx])
    return g


def _merge_fams(g, vt, vs, va):
    """Per-lane family values (None for an absent family)."""
    have = [(m, v) for m, v in (("is_tri", vt), ("is_sph", vs),
                                ("is_ana", va)) if v is not None]
    out = have[-1][1]
    for name, v in reversed(have[:-1]):
        out = _pick(g[name], v, out)
    return out


def _families(scene):
    return bool(scene.n_tris), bool(scene.n_spheres), bool(scene.n_ana_lights)


def _disk_point(g, u):
    """Uniform points on the gathered disk lights (Shirley-Chiu concentric
    map, reference ``disk.rs:140-156``)."""
    dsk = maps.square_to_disk(u)
    r = g["ana_radius"]
    local = torch.stack([dsk[..., 0] * r, dsk[..., 1] * r,
                         torch.zeros_like(r)], dim=-1)
    return analytic._mtv(g["ana_rot"], local) + g["ana_trans"]


def sample_towards(scene: SceneData, light, xo, u):
    """Direction from xo (N, 3) towards a sample of light ``light`` (N,),
    u (N, 2): the sqrt-warp area sample of a triangle
    (``triangle.rs:219-241``), the visible cone of a sphere
    (``sphere.rs:135-186``), a uniform point on a disk
    (``object.rs:137-141``)."""
    g = _light_geom(scene, light)
    ht, hs, ha = _families(scene)
    wi_tri = wi_sph = wi_ana = None
    if ht:
        gamma = 1.0 - torch.sqrt(torch.clamp(1.0 - u[..., 0], min=0.0))
        beta = u[..., 1] * (1.0 - gamma)
        xi = (g["a"] + beta[..., None] * (g["b"] - g["a"])
              + gamma[..., None] * (g["c"] - g["a"]))
        wi_tri = normalize(xi - xo)
    if hs:
        rel = xo - g["center"]
        dist2 = dot(rel, rel)
        r2 = g["radius"] ** 2
        inside = dist2 < r2
        # outside: a cone sample
        w = normalize(-rel)
        ub, vb = onb_frame(w)
        dist = torch.sqrt(dist2)
        cos_max = torch.sqrt(torch.clamp(
            1.0 - r2 / torch.clamp(dist2, min=1e-30), min=0.0))
        cos_t = (1.0 - u[..., 0]) + u[..., 0] * cos_max
        sin_t = torch.sqrt(torch.clamp(1.0 - cos_t ** 2, min=0.0))
        phi = 2.0 * PI * u[..., 1]
        ds_ = dist * cos_t - torch.sqrt(torch.clamp(r2 - dist2 * sin_t ** 2,
                                                    min=0.0))
        cos_a = (dist2 + r2 - ds_ ** 2) / (2.0 * dist * g["radius"] + 1e-30)
        sin_a = torch.sqrt(torch.clamp(1.0 - cos_a ** 2, min=0.0))
        ngl = (torch.cos(phi) * sin_a)[..., None] * ub \
            + (torch.sin(phi) * sin_a)[..., None] * vb \
            + cos_a[..., None] * w
        xi_out = g["center"] - normalize(ngl) * g["radius"][..., None]
        # inside: a uniform surface sample
        z = 1.0 - 2.0 * u[..., 0]
        rr = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
        sph = torch.stack([rr * torch.cos(2 * PI * u[..., 1]),
                           rr * torch.sin(2 * PI * u[..., 1]), z], dim=-1)
        xi_in = g["center"] + sph * g["radius"][..., None]
        wi_sph = normalize(torch.where(inside[..., None], xi_in, xi_out) - xo)
    if ha:
        wi_ana = normalize(_disk_point(g, u) - xo)
    return _merge_fams(g, wi_tri, wi_sph, wi_ana)


def light_area(scene: SceneData, light):
    """Surface area of light ``light`` (reference ``object.rs:99-100``)."""
    g = _light_geom(scene, light)
    ht, hs, ha = _families(scene)
    return _merge_fams(
        g, 0.5 * norm(cross(g["b"] - g["a"], g["c"] - g["a"])) if ht else None,
        4.0 * PI * g["radius"] ** 2 if hs else None,
        PI * g["ana_radius"] ** 2 if ha else None)


def sample_on(scene: SceneData, light, u):
    """Uniform points on light ``light`` from u (N, 2): sqrt-warped
    barycentrics on a triangle with its interpolated shading normal
    (reference ``triangle.rs:48-60,215-241``), a uniform point on a sphere
    (``sphere.rs:111-130``) or a disk (``disk.rs:140-156``).  Returns
    (p, ng, ns, err, mat)."""
    g = _light_geom(scene, light, normals=True)
    ht, hs, ha = _families(scene)
    fam = {}
    if ht:
        gamma = 1.0 - torch.sqrt(torch.clamp(1.0 - u[..., 0], min=0.0))
        beta = u[..., 1] * (1.0 - gamma)
        e1 = g["b"] - g["a"]
        e2 = g["c"] - g["a"]
        p = g["a"] + beta[..., None] * e1 + gamma[..., None] * e2
        ng = normalize(cross(e1, e2))
        alpha = 1.0 - beta - gamma
        ns_raw = (alpha[..., None] * g["na"] + beta[..., None] * g["nb"]
                  + gamma[..., None] * g["nc"])
        has_ns = dot(ns_raw, ns_raw) > 1e-12
        ns = torch.where(has_ns[..., None], normalize(ns_raw, eps=1e-30), ng)
        err = gamma_bound(6) * (torch.abs(g["a"])
                                + torch.abs(beta[..., None] * e1)
                                + torch.abs(gamma[..., None] * e2))
        fam["tri"] = (p, ng, ns, err, g["mat_tri"])
    if hs:
        sph = maps.square_to_sphere(u)
        p = g["center"] + sph * g["radius"][..., None]
        fam["sph"] = (p, sph, sph, gamma_bound(5) * torch.abs(p),
                      g["mat_sph"])
    if ha:
        p = _disk_point(g, u)
        ng = g["ana_rot"][..., 2, :]     # rot^T e_z: the disk's normal
        fam["ana"] = (p, ng, ng, gamma_bound(5) * torch.abs(p), g["mat_ana"])
    return tuple(_merge_fams(g, *(fam[k][i] if k in fam else None
                                  for k in ("tri", "sph", "ana")))
                 for i in range(5))


def sample_leaving(scene: SceneData, light, u0, u1):
    """A ray leaving light ``light``: a uniform point (:func:`sample_on`,
    uniforms u0) and a cosine-weighted direction about its shading normal
    (u1) (reference ``object.rs:104-117``).  Returns (p, d, ng, ns, err,
    mat)."""
    p, ng, ns, err, mat = sample_on(scene, light, u0)
    d = onb.to_world(ns, maps.square_to_cos_hemisphere(u1))
    return p, normalize(d), ng, ns, err, mat


def sample_leaving_pdf(scene: SceneData, light, d, ng):
    """(pdf_origin, pdf_dir) of :func:`sample_leaving`: 1 / area and
    cos / pi, unclamped (reference ``object.rs:119-127``)."""
    pdf_origin = 1.0 / torch.clamp(light_area(scene, light), min=1e-30)
    return pdf_origin, dot(ng, d) / PI


def _finite(t):
    return torch.where(torch.isfinite(t), t, 0.0)


def light_hit(scene: SceneData, light, o, d):
    """Intersect each ray with its chosen light primitive only
    (``light.hit(r)`` inside reference ``scene.hit_light``,
    ``scene.rs:165-189``).  A sphere or disk a ray misses gets its
    shading data at t = 0, not at t = INF: the JAX package's INF there
    makes p infinite, and the light pdf's division by it turns a masked
    lane's zero cotangent into NaN camera gradients (ROADMAP.md section
    3).  Only lanes that miss, whose values nothing reads, change."""
    g = _light_geom(scene, light)
    ht, hs, ha = _families(scene)
    fam = {}
    if ht:
        kz, shear = geo.ray_setup(d)
        t = geo.triangle_t(o, kz, shear, g["a"][:, None], g["b"][:, None],
                           g["c"][:, None], 0.0, INF)[0][:, 0]
        z3 = torch.zeros_like(g["a"])
        z2 = torch.zeros_like(g["a"][..., :2])
        fam["tri"] = (t, geo.triangle_detail(o, d, g["a"], g["b"], g["c"],
                                             z3, z3, z3, z2, z2, z2))
    if hs:
        t = geo.sphere_t(o, d, g["center"][:, None], g["radius"][:, None],
                         0.0, INF)[:, 0]
        fam["sph"] = (t, geo.sphere_detail(o, d, _finite(t), g["center"],
                                           g["radius"]))
    if ha:
        # one disk per lane: the plane equation directly
        rot, r = g["ana_rot"], g["ana_radius"]
        ol = analytic._mv(rot, o - g["ana_trans"])
        dl = analytic._mv(rot, d)
        coplanar = torch.abs(dl[..., 2]) < 1e-12
        tp = -ol[..., 2] / torch.where(coplanar, 1.0, dl[..., 2])
        hp = ol + tp[..., None] * dl
        ok = ~coplanar & (hp[..., 0] ** 2 + hp[..., 1] ** 2 <= r ** 2) \
            & (tp > 0.0)
        t = torch.where(ok, tp, INF)
        kind = torch.full_like(light, analytic.DISK)
        fam["ana"] = (t, analytic.analytic_detail(
            o, d, _finite(t), kind, rot, g["ana_trans"], r,
            torch.zeros_like(r)))
    pick = lambda f: [fam[k][f] if k in fam else None
                      for k in ("tri", "sph", "ana")]
    t = _merge_fams(g, *pick(0))
    det = {k: _merge_fams(g, *(x[k] if x is not None else None
                               for x in pick(1))) for k in ("p", "ng", "uv")}
    mat = _merge_fams(g, g.get("mat_tri"), g.get("mat_sph"), g.get("mat_ana"))
    return {"valid": torch.isfinite(t), "t": t, "p": det["p"],
            "ng": det["ng"], "uv": det["uv"], "mat": mat,
            "backface": dot(d, det["ng"]) > 0.0}


def sample_towards_pdf(scene: SceneData, light, o, d, xi, ng):
    """Solid-angle pdf of :func:`sample_towards` for the ray (o, d)
    reaching xi with light normal ng (reference ``object.rs:141-157``,
    ``sphere.rs:190-207``)."""
    g = _light_geom(scene, light)
    ht, hs, ha = _families(scene)
    rel = xi - o
    dist2 = dot(rel, rel)
    cos_l = torch.abs(dot(ng, d))
    # edge-on lights: zero the pdf so the MIS mask drops the sample; the
    # masked lanes divide by 1, not by a tiny floor (finite gradients)
    cos_ok = cos_l > 1e-7

    def by_area(area):
        den = torch.where(cos_ok, area * cos_l, 1.0)
        return torch.where(cos_ok, dist2 / torch.clamp(den, min=1e-30), 0.0)

    pdf_tri = pdf_sph = pdf_ana = None
    if ht:
        pdf_tri = by_area(0.5 * norm(cross(g["b"] - g["a"], g["c"] - g["a"])))
    if hs:
        rel_c = o - g["center"]
        do2 = dot(rel_c, rel_c)
        r2 = g["radius"] ** 2
        # the sine^2 of the cone; 0 inside, where sqrt' would be INF (the
        # JAX package clamps before the sqrt, which gives a masked
        # lane's zero cotangent a NaN)
        c2 = 1.0 - r2 / torch.clamp(do2, min=1e-30)
        cos_max = torch.where(c2 > 0.0,
                              torch.sqrt(torch.where(c2 > 0.0, c2, 1.0)), 0.0)
        pdf_out = 1.0 / torch.clamp(2.0 * PI * (1.0 - cos_max), min=1e-30)
        pdf_sph = torch.where(do2 < r2, by_area(4.0 * PI * r2), pdf_out)
    if ha:
        pdf_ana = by_area(PI * g["ana_radius"] ** 2)
    return _merge_fams(g, pdf_tri, pdf_sph, pdf_ana)


def transmittance(scene: SceneData, lam, t):
    """Medium transmittance over distance t, normalized by its mean over
    the wavelengths (the distance-sampling pdf estimate, reference
    ``medium.rs:59-73``, ``scene.rs:111-116``); ones without a medium."""
    if scene.medium is None:
        return torch.ones_like(lam)
    med = scene.medium
    td = torch.where(torch.isfinite(t), t, 0.0) * med["t_scale"]
    tr = torch.exp(-uplift.sample(med["sigma_t"][None, :], lam)
                   * td[..., None])
    p = tr.mean(-1, keepdim=True)
    return torch.where(p > 0.0, tr / torch.clamp(p, min=1e-30), 1.0)
