"""The path tracer with next-event estimation, power-2 MIS and Russian
roulette (frozen copy of ``lumo_tpu_torch/integrators/{path_trace,
common}.py``, for triangle scenes without media).  Every draw is a
counter hash of the per-ray key, salted per purpose, so a lane's path
does not depend on the lanes beside it."""
from __future__ import annotations

import torch

from . import bsdf
from .geometry import EPSILON, offset_ray_origin
from .rng import MASK32, hash_u32, randfloat
from .scene import (Scene, emitted, intersect, light_hit, sample_light,
                    sample_towards, sample_towards_pdf)
from .spectra import luminance

_TINY = 1e-30
RR_DEPTH = 5
MAX_DEPTH = 64

_S_LOBE = 0x632BE59B
_S_SQ0 = 0x85297A4D
_S_SQ1 = 0xD6E8FEB8
_S_RR = 0xA0761D64
_S_MED = 0xE7037ED1
S_LIGHT = 0x2545F491
S_SQ0 = 0x9E3779B9
S_SQ1 = 0x85EBCA6B
S_OCC = 0xD3A2646C
_SHRINK = 1.0 - 8.0 * torch.finfo(torch.float32).eps


def _fold(rng, i):
    return hash_u32(rng ^ ((i * 0x6C62272E + 0xB5297A4D) & MASK32))


def _nee_light(scene: Scene, mp, wo, hit, lam, rng):
    """One light-sampled NEE estimate over the light-choice pdf."""
    light, pdf_light = sample_light(scene, randfloat(rng, S_LIGHT))
    u_sq = torch.stack([randfloat(rng, S_SQ0), randfloat(rng, S_SQ1)], -1)
    wi = sample_towards(scene, light, hit["p"], u_sq).detach()
    o = offset_ray_origin(hit["p"], hit["err"], hit["ng"], wi)
    lh = light_hit(scene, light, o, wi)
    t_max = ((torch.where(lh["valid"] & hit["valid"], lh["t"], 0.0)
              - EPSILON) * _SHRINK).detach()
    with torch.no_grad():
        occ = scene.occluded(o.detach(), wi, t_max)
    visible = lh["valid"] & ~occ
    p_lig = sample_towards_pdf(scene, light, o, wi, lh["p"], lh["ng"])
    f_val, p_sct = bsdf.f_pdf(mp, wo, wi, hit["ng"], hit["ns"],
                              hit["backface"])
    ok = (p_lig > 0.0) & (p_sct > 0.0) & torch.isfinite(p_lig) \
        & torch.isfinite(p_sct)
    p_lig = torch.where(ok, p_lig, 1.0)
    p_sct = torch.where(ok, p_sct, 1.0)
    f_val = torch.where(ok[..., None], f_val, 0.0)
    emit = emitted(scene, lh["mat"], lam, lh["backface"])
    cos = bsdf.shading_cosine(wi, hit["ns"])
    p_sel = torch.clamp(p_lig, 0.0, 1e18)
    p_oth = torch.clamp(p_sct, 0.0, 1e18)
    w_over_p = p_sel / torch.clamp(p_sel * p_sel + p_oth * p_oth, min=1e-20)
    contrib = f_val * torch.ones_like(lam) * emit * (cos * w_over_p)[..., None]
    contrib = torch.where(ok[..., None], contrib, 0.0)
    contrib = torch.where(visible[..., None] & torch.isfinite(contrib),
                          contrib, 0.0)
    return contrib / torch.clamp(pdf_light[..., None], min=_TINY)


def _nee(scene: Scene, mp, wo, gathered, hit, lam, rng):
    n = scene.n_shadow_rays
    acc = 0.0
    for i in range(n):
        acc = acc + _nee_light(scene, mp, wo, hit, lam, _fold(rng, i))
    return gathered * acc / n


def _emitter_mis_weight(scene: Scene, o, d, hit, p_sct, did_nee):
    light = hit["light"]
    is_light = light >= 0
    lsafe = torch.clamp(light, 0, max(scene.n_lights - 1, 0))
    p_lig = sample_towards_pdf(scene, lsafe, o, d, hit["p"], hit["ng"])
    ok = is_light & (p_sct > 0.0) & torch.isfinite(p_sct) & (p_lig > 0.0) \
        & torch.isfinite(p_lig)
    ratio = torch.clamp(torch.where(ok, p_lig, 0.0)
                        / torch.where(p_sct > 0.0, p_sct, 1.0), 0.0, 1e18)
    w = 1.0 / (1.0 + ratio * ratio)
    return torch.where(did_nee, torch.where(ok, w, 1.0), 1.0)


def bounce(scene: Scene, s, delta):
    """One wavefront bounce of the path state ``s``."""
    rng = hash_u32((s["rng"] + 0x9E3779B9) & MASK32)
    hit = intersect(scene, s["o"], s["d"], s["alive"])
    alive = s["alive"] & hit["valid"]
    wo = -s["d"]
    lam = s["lam"]
    gathered0 = s["gathered"] * torch.where(alive[..., None],
                                            torch.ones_like(lam), 1.0)
    mp = bsdf.gather_params(scene.materials, scene.kinds, hit["mat"], lam)
    u_lobe = randfloat(rng, _S_LOBE)
    u_sq = torch.stack([randfloat(rng, _S_SQ0), randfloat(rng, _S_SQ1)],
                       dim=-1)
    wi, sample_ok = bsdf.sample(mp, wo, hit["ns"], hit["backface"], u_lobe,
                                u_sq)
    emit = emitted(scene, hit["mat"], lam, hit["backface"])
    w_mis = _emitter_mis_weight(scene, s["o"], s["d"], hit, s["p_sct"],
                                s["did_nee"])
    add_emit = alive & ~sample_ok
    radiance = s["radiance"] + torch.where(add_emit[..., None],
                                           gathered0 * emit
                                           * w_mis[..., None], 0.0)
    alive = alive & sample_ok
    nee = _nee(scene, mp, wo, gathered0, hit, lam, rng)
    do_nee = alive & ~mp["is_delta"]
    radiance = radiance + torch.where(do_nee[..., None], nee, 0.0)
    ro = offset_ray_origin(hit["p"], hit["err"], hit["ng"], wi)
    f_val, p_sct = bsdf.f_pdf(mp, wo, wi, hit["ng"], hit["ns"],
                              hit["backface"])
    alive = alive & (p_sct > 1e-12) & torch.isfinite(p_sct)
    p_safe = torch.where(alive, p_sct, 1.0)
    f_val = torch.where(alive[..., None], f_val, 0.0)
    cosine = bsdf.shading_cosine(wi, hit["ns"])
    gathered = gathered0 * f_val * (cosine / p_safe)[..., None]
    lum = luminance(gathered, lam)
    rr_prob = torch.clamp(lum / delta, max=1.0)
    u_rr = randfloat(rng, _S_RR)
    do_rr = s["depth"] >= RR_DEPTH
    alive = alive & ~(do_rr & (u_rr > rr_prob))
    rr_div = torch.where(do_rr & alive, torch.clamp(rr_prob, min=_TINY), 1.0)
    gathered = gathered / rr_div.detach()[..., None]
    a3 = alive[..., None]
    return {
        "o": torch.where(a3, ro, s["o"]),
        "d": torch.where(a3, wi, s["d"]),
        "lam": torch.where(a3, lam, lam),
        "radiance": radiance,
        "gathered": torch.where(a3, gathered, s["gathered"]),
        "alive": alive,
        "did_nee": torch.where(alive, do_nee, s["did_nee"]),
        "p_sct": torch.where(alive, p_sct, s["p_sct"]),
        "depth": s["depth"] + alive.to(s["depth"].dtype),
        "rng": rng,
    }


_STATE_FLOATS = ("o", "d", "radiance", "gathered", "p_sct")


def _held(scene: Scene, s):
    """The path state as held between bounces: bfloat16 in the control."""
    if scene.precision != "bf16":
        return s
    return {k: (v.to(torch.bfloat16).to(v.dtype) if k in _STATE_FLOATS
                else v) for k, v in s.items()}


def integrate(scene: Scene, o, d, lam, ray_key, delta=1.0, fixed_depth=None):
    """Trace N camera rays: (radiance (N, 4), lam (N, 4), depth (N,)).
    Without ``fixed_depth`` until no lane is alive or ``MAX_DEPTH``
    bounces have run; with it exactly that many bounces."""
    N, dev = o.shape[0], o.device
    s = _held(scene, {
        "o": o, "d": d, "lam": lam,
        "radiance": torch.zeros((N, 4), dtype=o.dtype, device=dev),
        "gathered": torch.ones((N, 4), dtype=o.dtype, device=dev),
        "alive": torch.ones(N, dtype=torch.bool, device=dev),
        "did_nee": torch.zeros(N, dtype=torch.bool, device=dev),
        "p_sct": torch.ones(N, dtype=o.dtype, device=dev),
        "depth": torch.zeros(N, dtype=torch.int32, device=dev),
        "rng": torch.as_tensor(ray_key, dtype=torch.int64, device=dev),
    })
    steps = MAX_DEPTH if fixed_depth is None else fixed_depth
    for _ in range(steps):
        if fixed_depth is None and not bool(s["alive"].any()):
            break
        s = _held(scene, bounce(scene, s, delta))
    return s["radiance"], s["lam"], s["depth"]
