"""The benchmark's plain reference of the bidirectional path tracer: the
progressive pass of ``Renderer(scene, camera).samples(spp).seed(seed)
.integrator("bdpt").bdpt_depth(depth).render()`` worked out again, in
plain PyTorch and NumPy, float32, for triangle scenes of microfacet
diffuse, mirror, glass and light materials.

It follows lumo's BDPT (``src/tracer/integrator/bd_path_trace*``,
``path_gen.rs``, ``vertex.rs``, ``mis.rs``) as ``lumo_tpu_torch/
integrators/bdpt.py`` ports it, of which it is a frozen copy: per camera
sample a light subpath and a camera subpath of up to ``bdpt_depth``
vertices (the light's walk carries importance: no eta^2 scale across a
refraction, and the shading-normal correction), every (s, t) strategy,
each weighted by the power heuristic over the joined path's pdfs, the
s = 1 and general strategies each through one any-hit query, and the
t = 1 strategies as splats at raster coordinates of their own.  The
renderer's batch steps (2 spp at 512 x 512) run each under the per-pixel
adaptive Russian-roulette threshold that the steps before it left in the
pixel statistics, and the film is the Gaussian one with its splat buffer.
Every draw is the program's counter hash of the per-ray key.

A pixel receives splats from lanes of any pixel, and each lane's walks
use its own pixel's threshold, so the whole pass is traced (in blocks of
``BLOCK`` lanes) to give the checked pixels their values.

Departures from lumo, all the port's own: the hero wavelengths (four a
sample, the trailing three terminated at the dispersive glass); the
pdf 0 -> 1 mapping of ``mis.rs`` kept for every position; a lens of
radius 0 (a pinhole); no media, textures or shading-normal maps; the
Russian roulette from depth 5 against the adaptive threshold; the
general strategies of one s as one batch (elementwise, so each lane has
the bits it would have alone).  Scene queries are the path reference's
exact cluster queries (``scene.py``).

``precision="bf16"`` is the control: the scene tables, the camera rays
and the walks' state between vertices are held in bfloat16.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import spectra
from .bdpt_bsdf import (IMPORTANCE, RADIANCE, dispersive_mask, f,
                        gather_params, pdf, sample, shading_cosine, terminate)
from .bdpt_scene import (Camera, Scene, light_area, sample_leaving,
                         sample_leaving_pdf)
from .geometry import EPSILON, dot, norm, normalize, offset_ray_origin
from .render import _delta, _gauss_scalar, camera_samples, filter_weight
from .rng import MASK32, hash_u32, randfloat
from .scene import (emitted, intersect, light_hit, sample_light,
                    sample_towards, sample_towards_pdf)

INTEGRATORS = frozenset({"bdpt"})
MATERIALS = frozenset({"diffuse", "mirror", "glass", "light"})
TRAFFIC = frozenset({"render"})
__all__ = ["Camera", "Scene", "render_pixels", "INTEGRATORS", "MATERIALS",
           "TRAFFIC"]

PI = math.pi
_TINY = 1e-30
RR_DEPTH = 5
BLOCK = 1 << 18                 # lanes traced at once
LANE_VERTICES = 6 * 2 ** 20     # the renderer's automatic BDPT step
FILTER_RADIUS = 1.5
FILTER_SIGMA = 1.5 / 4.0
R_DISC = 1
_SHRINK = 1.0 - 8.0 * float(np.finfo(np.float32).eps)

_C_LIGHT = 0x9E3779B9
_C_CAMERA = 0x3C6EF372
_C_CONNECT = 0xDAA66D2B
_S_LOBE = 0xC2B2AE35
_S_SQ0 = 0x85EBCA6B
_S_SQ1 = 0x27D4EB2F
_S_RR = 0x165667B1
_S_PICK = 0x2545F491
_S_ON0 = 0x94D049BB
_S_ON1 = 0xBF58476D
_S_DIR0 = 0xFD7046C5
_S_DIR1 = 0xD3A2646C


def _held(scene, x):
    """A walk's state as held between vertices: bfloat16 in the
    control."""
    if scene.precision != "bf16":
        return x
    return x.to(torch.bfloat16).to(x.dtype)


def _sa_to_area(pdf_sa, xo, xi, wi, ngi):
    r = xo - xi
    return pdf_sa * torch.abs(dot(wi, ngi)) / torch.clamp(dot(r, r),
                                                          min=_TINY)


def _map0(p):
    return torch.where(p == 0.0, 1.0, p)


def _mp(scene, v, lam):
    return gather_params(scene.materials, scene.kinds,
                         torch.clamp(v["mat"], min=0), lam)


def _shading_correction(v, wi):
    num = shading_cosine(wi, v["ng"]) * shading_cosine(v["wo"], v["ns"])
    den = shading_cosine(v["wo"], v["ng"]) * shading_cosine(wi, v["ns"])
    return num / torch.clamp(den, min=_TINY)


# ---------------------------------------------------------------------------
# subpaths (``path_gen.rs``)

def _walk(scene, o, d, lam, rng, gathered, pdf_sa, mode, delta_rr, prev_p,
          prev_ng, prev_delta, prev_surface, n_steps):
    """Random-walk ``n_steps`` vertices from the rays (o, d): (vertices,
    the root's backward pdf, the wavelengths after the walk)."""
    N, dev = o.shape[0], o.device
    alive = torch.ones(N, dtype=torch.bool, device=dev)
    surface = alive             # every hit is a surface point
    verts, pdf_bck_prev = [], []
    for depth in range(1, n_steps + 1):
        rng = hash_u32(rng + 0x9E3779B9)
        hit = intersect(scene, o, d, alive)
        alive = alive & hit["valid"]
        wo = -d
        lam2 = terminate(lam, dispersive_mask(scene.materials, hit["mat"]))
        mp = gather_params(scene.materials, scene.kinds, hit["mat"], lam2)
        pdf_fwd = torch.where(mp["is_delta"], 0.0,
                              _sa_to_area(pdf_sa, prev_p, hit["p"], d,
                                          hit["ng"]))
        u_sq = torch.stack([randfloat(rng, _S_SQ0), randfloat(rng, _S_SQ1)],
                           -1)
        wi, ok, _ = sample(mp, wo, hit["ns"], hit["backface"], lam2,
                           randfloat(rng, _S_LOBE), u_sq)
        v_valid = alive & ok if mode == IMPORTANCE else alive
        v_light = torch.where(alive & ~ok, hit["light"], -1)
        p_next = pdf(mp, wo, wi, hit["ng"], hit["ns"])
        cont = alive & ok & (p_next > 0.0) & torch.isfinite(p_next)
        p_safe = torch.where(cont, p_next, 1.0)
        f_val = f(mp, wo, wi, hit["ng"], hit["ns"], hit["backface"], mode)
        f_val = torch.where(cont[..., None], f_val, 0.0)
        cosw = shading_cosine(wi, hit["ns"])
        if mode == IMPORTANCE:
            cosw = cosw * _shading_correction(
                {"wo": wo, "ng": hit["ng"], "ns": hit["ns"]}, wi)
        g_next = gathered * f_val * (cosw / p_safe)[..., None]
        p_swap = pdf(mp, wi, wo, hit["ng"], hit["ns"])
        ngp = torch.where(prev_surface[..., None], prev_ng, wo)
        pdf_bck_prev.append(torch.where(
            mp["is_delta"] | prev_delta | ~cont, 0.0,
            _sa_to_area(p_swap, hit["p"], prev_p, wo, ngp)))
        if depth >= RR_DEPTH:
            rr_prob = torch.clamp(spectra.luminance(g_next, lam2) / delta_rr,
                                  max=1.0)
            cont = cont & ~(randfloat(rng, _S_RR) > rr_prob)
            rr_div = torch.where(cont, torch.clamp(rr_prob, min=_TINY), 1.0)
            g_next = g_next / rr_div[..., None]
        pdf_sa = torch.where(mp["is_delta"], 0.0, p_next)
        ro = offset_ray_origin(hit["p"], hit["err"], hit["ng"], wi)
        verts.append({
            "p": hit["p"], "ng": hit["ng"], "ns": hit["ns"], "wo": wo,
            "err": hit["err"], "gathered": gathered, "pdf_fwd": pdf_fwd,
            "mat": hit["mat"], "light": v_light, "valid": v_valid,
            "delta": mp["is_delta"] & v_valid, "surface": surface,
            "backface": hit["backface"]})
        c3 = cont[..., None]
        o = _held(scene, torch.where(c3, ro, o))
        d = _held(scene, torch.where(c3, wi, d))
        lam = torch.where(alive[..., None], lam2, lam)
        gathered = _held(scene, torch.where(c3, g_next, gathered))
        prev_p = _held(scene, torch.where(c3, hit["p"], prev_p))
        prev_ng = torch.where(c3, hit["ng"], prev_ng)
        prev_delta = torch.where(cont, mp["is_delta"], prev_delta)
        prev_surface = torch.where(cont, surface, prev_surface)
        alive = cont
    for v, pb in zip(verts, pdf_bck_prev[1:] + [torch.zeros_like(lam[:, 0])]):
        v["pdf_bck"] = pb
    return verts, pdf_bck_prev[0], lam


def _root(p, ng, ns, err, gathered, pdf_fwd, mat, light, surface):
    N, dev = p.shape[0], p.device
    false = torch.zeros(N, dtype=torch.bool, device=dev)
    return {"p": p, "ng": ng, "ns": ns, "wo": torch.zeros_like(p),
            "err": err, "gathered": gathered, "pdf_fwd": pdf_fwd,
            "pdf_bck": torch.zeros(N, dtype=p.dtype, device=dev),
            "mat": mat, "light": light,
            "valid": torch.ones(N, dtype=torch.bool, device=dev),
            "delta": false, "surface": surface, "backface": false}


def _camera_path(scene, camera, o, d, lam, rng0, delta_rr, n_verts):
    N, dev = o.shape[0], o.device
    zeros3 = torch.zeros_like(o)
    no_light = torch.full((N,), -1, dtype=torch.int64, device=dev)
    false = torch.zeros(N, dtype=torch.bool, device=dev)
    root = _root(o, zeros3, zeros3, zeros3, torch.ones_like(lam),
                 camera.pdf_xo(o), no_light, no_light, false)
    verts, root["pdf_bck"], lam_out = _walk(
        scene, o, d, lam, rng0, torch.ones_like(lam), camera.pdf_wi(o, d),
        RADIANCE, delta_rr, o, zeros3, false, false, n_verts - 1)
    return [root] + verts, lam_out


def _light_path(scene, lam, rng0, delta_rr, n_verts):
    N = lam.shape[0]
    light, pdf_light = sample_light(scene, randfloat(rng0, _S_PICK))
    u0 = torch.stack([randfloat(rng0, _S_ON0), randfloat(rng0, _S_ON1)], -1)
    u1 = torch.stack([randfloat(rng0, _S_DIR0), randfloat(rng0, _S_DIR1)],
                     -1)
    p, d, ng, ns, err, mat = sample_leaving(scene, light, u0, u1)
    pdf_origin, pdf_dir = sample_leaving_pdf(scene, light, d, ng)
    false = torch.zeros(N, dtype=torch.bool, device=lam.device)
    emit = emitted(scene, mat, lam, false)
    root = _root(p, ng, ns, err, emit, pdf_origin * pdf_light, mat, light,
                 ~false)
    denom = torch.clamp(pdf_light * pdf_origin * pdf_dir, min=_TINY)
    gathered = torch.where((pdf_dir > 0.0)[..., None],
                           emit * (torch.abs(dot(d, ns)) / denom)[..., None],
                           0.0)
    verts, root["pdf_bck"], lam_out = _walk(
        scene, offset_ray_origin(p, err, ng, d), d, lam,
        hash_u32(rng0 ^ 0x51633E2D), gathered, pdf_dir, IMPORTANCE,
        delta_rr, p, ng, false, ~false, n_verts - 1)
    path = [root] + verts
    for prev, v in zip(path, path[1:]):
        v["valid"] = v["valid"] & prev["valid"]
    return path, lam_out


# ---------------------------------------------------------------------------
# MIS (``mis.rs``)

_CKEYS = ("p", "ng", "ns", "wo", "err", "gathered", "pdf_fwd", "pdf_bck",
          "light", "valid", "delta", "surface", "backface")


def _fields(v):
    return {k: v[k] for k in _CKEYS if k in v}


def _batch(dicts):
    if len(dicts) == 1:
        return dicts[0]
    return {k: (torch.cat([x[k] for x in dicts]) if isinstance(v, torch.Tensor)
                else v) for k, v in dicts[0].items()}


def _ngi(vn, wi):
    """The normal of vn in a pdf's area conversion: its own, or the
    direction at the lens point."""
    return torch.where(vn["surface"][..., None], vn["ng"], wi)


def _pdf_light_origin(scene, v):
    light = torch.clamp(v["light"], min=0)
    p = scene.light_pdf[light] / torch.clamp(light_area(scene, light),
                                             min=_TINY)
    return torch.where(v["light"] >= 0, p, 0.0)


def _pdf_light_leaving(vc, vn):
    wi = normalize(vn["p"] - vc["p"], eps=_TINY)
    pdf_dir = dot(vc["ng"], wi) / PI
    out = _sa_to_area(pdf_dir, vc["p"], vn["p"], wi, _ngi(vn, wi))
    return torch.where((vc["light"] >= 0) & ~vn["delta"], out, 0.0)


def _pdf_camera_leaving(camera, vc, vn):
    wi = normalize(vn["p"] - vc["p"], eps=_TINY)
    out = _sa_to_area(camera.pdf_wi(vc["p"], wi), vc["p"], vn["p"], wi,
                      _ngi(vn, wi))
    return torch.where(vn["delta"], 0.0, out)


def _pdf_connection(vc, vn, mp_c, vp=None):
    if vp is None:
        wi = normalize(vn["p"] - vc["p"], eps=_TINY)
        pdf_sa = pdf(mp_c, vc["wo"], wi, vc["ng"], vc["ns"])
    else:
        wi = vc["wo"]
        pdf_sa = pdf(mp_c, normalize(vp["p"] - vc["p"], eps=_TINY), wi,
                     vc["ng"], vc["ns"])
    out = _sa_to_area(pdf_sa, vc["p"], vn["p"], wi, _ngi(vn, wi))
    return torch.where(vn["delta"], 0.0, out)


def _mis_weight(scene, camera, lp, cp, s, t, mp_ls1=None, mp_ct1=None):
    """Power-heuristic weight of strategy (s, t); ``t`` may be a sequence
    of lengths, the strategies (s, t) as one batch of len(t) N lanes."""
    ts = [t] if isinstance(t, int) else list(t)
    B, T = len(ts), max(ts)
    if B == 1 and s + T == 2:
        return torch.ones_like(cp[0]["pdf_fwd"])
    rep = lambda x: x if B == 1 else torch.cat([x] * B)

    def cam(k, key):
        parts = [cp[t - 1 - k][key] if t - 1 - k >= 0 else
                 torch.zeros_like(cp[0][key]) for t in ts]
        return parts[0] if B == 1 else torch.cat(parts)

    pdf_rad = [rep(lp[i]["pdf_bck"]) for i in range(s)] \
        + [cam(k, "pdf_fwd") for k in range(T)]
    pdf_imp = [rep(lp[i]["pdf_fwd"]) for i in range(s)] \
        + [cam(k, "pdf_bck") for k in range(T)]
    delta = [rep(lp[i]["delta"]) for i in range(s)] \
        + [cam(k, "delta") for k in range(T)]
    ct1 = _batch([_fields(cp[t - 1]) for t in ts])
    ls1 = {k: rep(v) for k, v in _fields(lp[s - 1]).items()} if s else None
    if s > 1:
        ls2 = {k: rep(v) for k, v in _fields(lp[s - 2]).items()}
        pdf_rad[s - 2] = _pdf_connection(ls1, ls2, mp_ls1, vp=ct1)
    if s > 0:
        pdf_rad[s - 1] = (_pdf_camera_leaving(camera, ct1, ls1) if T == 1
                          else _pdf_connection(ct1, ls1, mp_ct1))
        delta[s - 1] = None
    if s == 0:
        pdf_imp[s] = _pdf_light_origin(scene, ct1)
    elif s == 1:
        pdf_imp[s] = _pdf_light_leaving(ls1, ct1)
    else:
        pdf_imp[s] = _pdf_connection(ls1, ct1, mp_ls1)
    delta[s] = None
    if T > 1:
        ct2 = _batch([_fields(cp[t - 2]) for t in ts])
        pdf_imp[s + 1] = (_pdf_light_leaving(ct1, ct2) if s == 0 else
                          _pdf_connection(ct1, ct2, mp_ct1, vp=ls1))
    active = None
    if B > 1:
        t_lane = torch.cat([torch.full_like(cp[0]["light"], t) for t in ts])
        active = lambda k: None if k + 1 < min(ts) else t_lane > k + 1
    return _sweep(pdf_rad, pdf_imp, delta, s, T - 1, active)


def _sweep(pdf_rad, pdf_imp, delta, s, n_cam, active=None):
    def not_delta(*flags):
        out = None
        for fl in flags:
            if fl is not None:
                out = ~fl if out is None else out & ~fl
        return out

    def add(total, ri, use):
        sq = ri * ri if use is None else torch.where(use, ri * ri, 0.0)
        return sq if total is None else total + sq

    total = None
    ri = None
    for i in reversed(range(s)):
        r = _map0(pdf_rad[i]) / _map0(pdf_imp[i])
        ri = r if ri is None else ri * r
        total = add(total, ri, not_delta(delta[i],
                                         delta[i - 1] if i > 0 else None))
    total = torch.ones_like(pdf_imp[0]) if total is None else total + 1.0
    ri = None
    for k in range(n_cam):
        i = s + k
        on = None if active is None else active(k)
        r = _map0(pdf_imp[i]) / _map0(pdf_rad[i])
        if ri is None:
            ri = r
        elif on is None:
            ri = ri * r
        else:
            ri = torch.where(on, ri * r, ri)
        use = not_delta(delta[i], delta[i + 1])
        if on is not None:
            use = on if use is None else on & use
        total = add(total, ri, use)
    w = 1.0 / total
    return torch.where(torch.isfinite(w) & (w > 0.0), w, 0.0)


# ---------------------------------------------------------------------------
# the strategies

def _salted(rng, k, c):
    return hash_u32(rng + ((k * c) & MASK32))


def _strategy_s0(scene, camera, lam, cp, t):
    cl = cp[t - 1]
    emit = emitted(scene, cl["mat"], lam, cl["backface"])
    w = _mis_weight(scene, camera, None, cp, 0, t)
    return torch.where((cl["valid"] & (cl["light"] >= 0))[..., None],
                       cl["gathered"] * emit * w[..., None], 0.0)


def _strategy_s1(scene, camera, lam, cp, mp_c, rng_con, t):
    cl, mp_cl = cp[t - 1], mp_c[t - 1]
    N = lam.shape[0]
    rng_t = _salted(rng_con, t, 0x9E3779B9)
    light, pdf_light = sample_light(scene, randfloat(rng_t, _S_PICK))
    u_sq = torch.stack([randfloat(rng_t, _S_SQ0), randfloat(rng_t, _S_SQ1)],
                       -1)
    wi = sample_towards(scene, light, cl["p"], u_sq)
    ro = offset_ray_origin(cl["p"], cl["err"], cl["ng"], wi)
    lh = light_hit(scene, light, ro, wi)
    mask = cl["valid"] & ~cl["delta"] & (cl["light"] < 0) & lh["valid"]
    t_max = torch.where(mask, (lh["t"] - EPSILON) * _SHRINK, 0.0)
    occ = scene.occluded(ro, wi, t_max)
    p_sct = pdf(mp_cl, cl["wo"], wi, cl["ng"], cl["ns"])
    p_lig = sample_towards_pdf(scene, light, ro, wi, lh["p"],
                               lh["ng"]) * pdf_light
    mask = mask & ~occ & (p_sct > 0.0) & (p_lig > 0.0)
    emit = emitted(scene, lh["mat"], lam, lh["backface"])
    false = torch.zeros(N, dtype=torch.bool, device=lam.device)
    lvert = {"p": lh["p"], "ng": lh["ng"], "ns": lh["ng"],
             "wo": torch.zeros_like(wi),
             "pdf_fwd": _sa_to_area(p_lig, cl["p"], lh["p"], wi, lh["ng"]),
             "pdf_bck": torch.zeros_like(p_lig), "light": light,
             "valid": mask, "delta": false, "surface": ~false}
    f_val = f(mp_cl, cl["wo"], wi, cl["ng"], cl["ns"], cl["backface"],
              RADIANCE)
    cos_wi = shading_cosine(wi, cl["ns"])
    p_safe = torch.where(mask, torch.clamp(p_lig, min=_TINY), 1.0)
    contrib = cl["gathered"] * f_val * emit * (cos_wi / p_safe)[..., None]
    w = _mis_weight(scene, camera, [lvert], cp, 1, t, mp_ct1=mp_cl)
    return torch.where(mask[..., None], contrib * w[..., None], 0.0)


def _strategy_t1(scene, camera, lam, lp, mp_l, rng_con, s):
    """The splat of strategy (s, 1): (raster (N, 2), colour (N, 4),
    mask (N,))."""
    ll, mp_ll = lp[s - 1], mp_l[s - 1]
    N = lam.shape[0]
    rng_s = _salted(rng_con, s + 64, 0x85EBCA6B)
    u_sq = torch.stack([randfloat(rng_s, _S_SQ0), randfloat(rng_s, _S_SQ1)],
                       -1)
    co, cd, cam_ok = camera.sample_towards(ll["p"], u_sq)
    dist = norm(ll["p"] - co)
    mask = ll["valid"] & ~ll["delta"] & cam_ok
    occ = scene.occluded(co, cd, torch.where(mask, dist * _SHRINK, 0.0))
    p_sct = pdf(mp_ll, ll["wo"], -cd, ll["ng"], ll["ns"])
    p_imp = camera.pdf_importance(co, cd, ll["p"])
    imp, raster, imp_ok = camera.sample_importance(co, cd)
    mask = (mask & ~occ & (p_sct > 0.0) & (p_imp > 0.0) & imp_ok
            & (imp > 0.0))
    p_imp_safe = torch.where(mask, torch.clamp(p_imp, min=_TINY), 1.0)
    color = (imp / p_imp_safe)[..., None] * torch.ones_like(lam)
    false = torch.zeros(N, dtype=torch.bool, device=lam.device)
    cvert = {"p": co, "ng": torch.zeros_like(co), "pdf_fwd": camera.pdf_xo(co),
             "pdf_bck": torch.zeros_like(dist), "valid": mask,
             "delta": false, "surface": false}
    f_val = f(mp_ll, ll["wo"], -cd, ll["ng"], ll["ns"], ll["backface"],
              IMPORTANCE)
    cos_l = shading_cosine(-cd, ll["ns"])
    corr = _shading_correction(ll, -cd)
    w = _mis_weight(scene, camera, lp, [cvert], s, 1, mp_ls1=mp_ll)
    out = color * ll["gathered"] * f_val * (cos_l * corr * w)[..., None]
    return raster, torch.where(mask[..., None], out, 0.0), mask


def _connect(scene, lam, lp, cp, mp_l, mp_c, rng_con, s, ts):
    """The strategies (s, t), t in ``ts``, as one batch: (len(ts), N, 4)."""
    B, N = len(ts), lam.shape[0]
    ll = _batch([_fields(lp[s - 1])] * B)
    mp_ll = _batch([mp_l[s - 1]] * B)
    cl = _batch([_fields(cp[t - 1]) for t in ts])
    mp_cl = _batch([mp_c[t - 1] for t in ts])
    lam = torch.cat([lam] * B)
    wi_lc = normalize(cl["p"] - ll["p"], eps=_TINY)
    wi = -wi_lc
    ro = offset_ray_origin(ll["p"], ll["err"], ll["ng"], wi_lc)
    dist = norm(cl["p"] - ro)
    mask = (ll["valid"] & ~ll["delta"] & cl["valid"] & ~cl["delta"]
            & (cl["light"] < 0) & (dot(wi_lc, ll["ng"]) >= EPSILON))
    occ = scene.occluded(ro, wi_lc, torch.where(mask, dist * _SHRINK, 0.0))
    p_sct = (pdf(mp_cl, cl["wo"], wi, cl["ng"], cl["ns"])
             * pdf(mp_ll, ll["wo"], -wi, ll["ng"], ll["ns"]))
    mask = mask & ~occ & (p_sct > 0.0)
    light_f = f(mp_ll, ll["wo"], -wi, ll["ng"], ll["ns"], ll["backface"],
                IMPORTANCE)
    cam_f = f(mp_cl, cl["wo"], wi, cl["ng"], cl["ns"], cl["backface"],
              RADIANCE)
    cos_l = shading_cosine(-wi, ll["ns"])
    cos_c = shading_cosine(wi, cl["ns"])
    r = cl["p"] - ll["p"]
    dist2 = torch.clamp(dot(r, r), min=_TINY)
    contrib = (ll["gathered"] * light_f * cl["gathered"] * cam_f
               * (cos_l * cos_c / dist2)[..., None])
    w = _mis_weight(scene, None, lp, cp, s, ts, mp_ls1=mp_ll, mp_ct1=mp_cl)
    return torch.where(mask[..., None], contrib * w[..., None],
                       0.0).view(B, N, 4)


def integrate(scene, camera, o, d, lam, ray_key, delta, max_verts):
    """A light and a camera subpath for each camera ray, every strategy
    joined: (radiance (N, 4), lam_out (N, 4), splat raster (S-1, N, 2),
    splat colour (S-1, N, 4), splat mask (S-1, N), depth (N,))."""
    S = T = int(max_verts)
    rng_con = hash_u32(ray_key ^ _C_CONNECT)
    lp, lam = _light_path(scene, lam, hash_u32(ray_key ^ _C_LIGHT), delta, S)
    cp, lam = _camera_path(scene, camera, _held(scene, o), _held(scene, d),
                           lam, hash_u32(ray_key ^ _C_CAMERA), delta, T)
    mp_l = [None] + [_mp(scene, v, lam) for v in lp[1:]]
    mp_c = [None] + [_mp(scene, v, lam) for v in cp[1:]]
    radiance = torch.zeros_like(lam)
    for t in range(2, T + 1):
        radiance = radiance + _strategy_s0(scene, camera, lam, cp, t)
    for t in range(2, T + 1):
        radiance = radiance + _strategy_s1(scene, camera, lam, cp, mp_c,
                                           rng_con, t)
    splats = [_strategy_t1(scene, camera, lam, lp, mp_l, rng_con, s)
              for s in range(2, S + 1)]
    sr, sc, sm = (torch.stack(x) for x in zip(*splats))
    for s in range(2, S + 1):
        for c in _connect(scene, lam, lp, cp, mp_l, mp_c, rng_con, s,
                          range(2, T + 1)):
            radiance = radiance + c
    radiance = torch.where(torch.isfinite(radiance), radiance, 0.0)
    sc = torch.where(torch.isfinite(sc), sc, 0.0)
    depth = sum(v["valid"].to(torch.int32) for v in cp + lp)
    return radiance, lam, sr, sc, sm, depth


# ---------------------------------------------------------------------------
# the renderer's pass and the film (``renderer.py``, ``film.py``)

def auto_batch(res, spp, depth):
    """Samples a step of the renderer's BDPT batch mode."""
    w, h = res
    target = min(2_000_000, LANE_VERTICES // depth)
    return max(1, min(max(1, int(target / max(w * h, 1))), spp))


def filter_integral() -> float:
    """The Gaussian filter's integral (``film.filter_integral``)."""
    r, s = float(np.float32(FILTER_RADIUS)), float(np.float32(FILTER_SIGMA))
    denom = s * math.sqrt(2.0)
    ig = 0.5 * (math.erf(r / denom) - math.erf(-r / denom))
    return (ig - 2.0 * r * _gauss_scalar(r)) ** 2


def add_samples(buf, weight, raster, rgb, res, mask=None):
    """Scatter samples through the filter into ``buf`` (and ``weight``),
    in place (``film.add_samples``)."""
    w, h = res
    px = torch.floor(raster).to(torch.int64)
    if mask is None:
        mask = torch.ones(raster.shape[:-1], dtype=torch.bool,
                          device=raster.device)
    for dy in range(-R_DISC, R_DISC + 1):
        for dx in range(-R_DISC, R_DISC + 1):
            fx = px[..., 0] + dx
            fy = px[..., 1] + dy
            mid = torch.stack([fx.to(raster.dtype) + 0.5,
                               fy.to(raster.dtype) + 0.5], dim=-1)
            wgt = filter_weight(raster - mid)
            inb = (fx >= 0) & (fx < w) & (fy >= 0) & (fy < h) & mask
            wgt = torch.where(inb, wgt, 0.0)
            flat = (fy.clamp(0, h - 1) * w + fx.clamp(0, w - 1)).reshape(-1)
            buf.view(-1, 3).index_add_(0, flat,
                                       (wgt[..., None] * rgb).reshape(-1, 3))
            if weight is not None:
                weight.view(-1).index_add_(0, flat, wgt.reshape(-1))


def _step(scene, camera, seed, spp, base, batch, stats, depth_b, m_wb):
    """One batch step of samples [base, base + batch) at every pixel:
    (film (colour, weight, splat), stats), each a sum over the step."""
    dev = scene.device
    w, h = camera.resolution
    n_pix = w * h
    n = batch * n_pix
    delta = _delta(stats)
    parts = []
    for lo in range(0, n, BLOCK):
        ids = base * n_pix + torch.arange(lo, min(n, lo + BLOCK), device=dev)
        o, d, lam, key, raster, pix = camera_samples(camera, ids, seed, spp)
        radiance, lam_out, sr, sc, sm, depth = integrate(
            scene, camera, o, d, lam, key, delta[pix], depth_b)
        lam_s = lam_out.expand((sr.shape[0],) + lam_out.shape)
        parts.append({
            "raster": raster, "pix": pix,
            "rgb": spectra.to_rgb(radiance, lam_out, m_wb),
            "f": spectra.luminance(radiance, lam_out),
            "cost": depth.to(torch.float32) * 2.0 + 1.0,
            "sr": sr, "sm": sm,
            "s_rgb": spectra.to_rgb(sc.reshape(-1, 4), lam_s.reshape(-1, 4),
                                    m_wb).view(sr.shape[0], -1, 3)})
        del radiance, lam_out, sr, sc, sm, depth
    cat = lambda k, dim=0: torch.cat([p[k] for p in parts], dim)
    color = torch.zeros((h, w, 3), device=dev)
    weight = torch.zeros((h, w), device=dev)
    splat = torch.zeros((h, w, 3), device=dev)
    add_samples(color, weight, cat("raster"), cat("rgb"), (w, h))
    add_samples(splat, None, cat("sr", 1).reshape(-1, 2),
                cat("s_rgb", 1).reshape(-1, 3), (w, h),
                mask=cat("sm", 1).reshape(-1))
    pix, f_lum, cost = cat("pix"), cat("f"), cat("cost")
    zeros = torch.zeros(n_pix, device=dev)
    step_stats = {"f": zeros.index_add(0, pix, f_lum),
                  "f2": zeros.index_add(0, pix, f_lum * f_lum),
                  "cost": zeros.index_add(0, pix, cost),
                  "n": zeros.index_add(0, pix, torch.ones_like(f_lum))}
    return (color, weight, splat), step_stats


def render_pixels(scene, camera, spp, seed, pixels, integrator="bdpt",
                  bdpt_depth=12, batch=None):
    """The linear-RGB values (P, 3) that the pass of ``spp`` samples under
    ``seed`` gives at the flat pixel ids ``pixels``: the whole pass traced
    step by step, each step under the adaptive threshold of the steps
    before it.  ``batch``: samples a step, by default the renderer's."""
    if integrator != "bdpt":
        raise ValueError(f"the BDPT reference has no integrator "
                         f"{integrator!r}")
    dev = scene.device
    w, h = camera.resolution
    pixels = torch.as_tensor(pixels, dtype=torch.int64, device=dev)
    m_wb = spectra.wb_matrix("DCI-P3", "D65")
    batch = auto_batch((w, h), spp, bdpt_depth) if batch is None else batch
    film = tuple(torch.zeros(s, device=dev) for s in
                 ((h, w, 3), (h, w), (h, w, 3)))
    stats = {k: torch.zeros(w * h, device=dev)
             for k in ("f", "f2", "cost", "n")}
    with torch.no_grad():
        for base in range(0, spp, batch):
            film_p, stats_p = _step(scene, camera, seed, spp, base, batch,
                                    stats, bdpt_depth, m_wb)
            film = tuple(a + b for a, b in zip(film, film_p))
            stats = {k: stats[k] + stats_p[k] for k in stats}
    color, weight, splat = film
    img = color / torch.clamp(weight[..., None], min=_TINY) \
        + splat * ((1.0 / spp) / filter_integral())
    return img.reshape(-1, 3)[pixels]
