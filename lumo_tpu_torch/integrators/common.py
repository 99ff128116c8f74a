"""Shared integrator machinery: next-event estimation with power-2 MIS.

Counterpart of ``lumo_tpu/integrators/common.py`` (reference
``integrator.rs:74-184``): each lane samples a light by the alias table
and shoots a shadow ray towards it.  The path tracer MIS-weights it
against the BSDF strategy, whose sample rides the extension ray
(:func:`nee_rays`); the direct-light integrator ends its path at the
vertex and so shoots a second, BSDF-sampled shadow ray
(:func:`shadow_rays`).  All draws are counter hashes of the per-ray
state, salted per purpose, as in the JAX package.
"""
from __future__ import annotations

import torch

from lumo_tpu_torch.bsdf import eval as bsdf
from lumo_tpu_torch.config import RADIANCE, epsilon
from lumo_tpu_torch.geometry import intersect as geo
from lumo_tpu_torch.sampling.samplers import MASK32, _hash_u32, _randfloat
from lumo_tpu_torch.scene import trace

_TINY = 1e-30

# per-purpose draw salts (``lumo_tpu/integrators/common.py:29-36``)
S_LIGHT = 0x2545F491
S_SQ0 = 0x9E3779B9
S_SQ1 = 0x85EBCA6B
S_LOBE = 0xC2B2AE35
S_SQ2 = 0x27D4EB2F
S_SQ3 = 0x165667B1
# salt the medium's free flight on the light- and BSDF-sampled shadow rays
S_OCC = 0xD3A2646C
S_OCCB = 0xFD7046C5


def shrink(dtype) -> float:
    """1 - 8 ulp(1) of ``dtype`` (the rays' own precision): shrinks a
    shadow or connection ray so that it stops short of its far end."""
    return 1.0 - 8.0 * torch.finfo(dtype).eps


def _fold(rng, i):
    """An independent per-estimate stream from a per-ray state."""
    return _hash_u32(rng ^ ((i * 0x6C62272E + 0xB5297A4D) & MASK32))


def mis_weight_and_contrib(scene, mp, wi, hit, light_hit, lam, p_lig, p_sct,
                           f_val, light_sampled=True):
    """f Tr Le |cos| w / p of a light-sampled (or, with ``light_sampled``
    False, BSDF-sampled) direction with the power-2 heuristic folded into
    the estimator division (reference ``integrator.rs:139-184``)."""
    ok = (p_lig > 0.0) & (p_sct > 0.0) & torch.isfinite(p_lig) \
        & torch.isfinite(p_sct)
    p_lig = torch.where(ok, p_lig, 1.0)
    p_sct = torch.where(ok, p_sct, 1.0)
    f_val = torch.where(ok[..., None], f_val, 0.0)
    tr = trace.transmittance(scene, lam, light_hit["t"])
    emit = trace.emitted(scene, light_hit["mat"], lam, light_hit["uv"],
                         light_hit["backface"])
    cos = bsdf.shading_cosine(mp, wi, hit["ns"])
    p_sel = torch.clamp(p_lig if light_sampled else p_sct, 0.0, 1e18)
    p_oth = torch.clamp(p_sct if light_sampled else p_lig, 0.0, 1e18)
    w_over_p = p_sel / torch.clamp(p_sel * p_sel + p_oth * p_oth, min=1e-20)
    contrib = f_val * tr * emit * (cos * w_over_p)[..., None]
    return torch.where(ok[..., None], contrib, 0.0)


def _shadow_branch(scene, mp, wo, wi, hit, light, lam, light_sampled, rng,
                   salt):
    """The common tail of both NEE strategies: the shadow ray towards
    ``light`` along wi, its occlusion, both pdfs and the MIS-weighted
    contribution (``lumo_tpu/integrators/common.py:75-104``)."""
    o = geo.offset_ray_origin(hit["p"], hit["err"], hit["ng"], wi)
    lh = trace.light_hit(scene, light, o, wi)
    # visibility is a discrete decision: its t range is detached
    # (``lumo_tpu/integrators/common.py:88-90``)
    t_max = ((torch.where(lh["valid"] & hit["valid"], lh["t"], 0.0)
              - epsilon()) * shrink(o.dtype)).detach()
    occ = trace.occluded(scene, o, wi, t_max, rng=rng, salt=salt)
    visible = lh["valid"] & ~occ
    p_lig = trace.sample_towards_pdf(scene, light, o, wi, lh["p"], lh["ng"])
    f_val, p_sct = bsdf.f_pdf(mp, wo, wi, hit["ng"], hit["ns"],
                              hit["backface"], lam, RADIANCE)
    contrib = mis_weight_and_contrib(scene, mp, wi, hit, lh, lam, p_lig,
                                     p_sct, f_val, light_sampled)
    return torch.where(visible[..., None] & torch.isfinite(contrib),
                       contrib, 0.0)


def _light_strategy(scene, mp, wo, hit, lam, rng):
    """The light-sampled NEE strategy (reference ``integrator.rs:96-112``):
    (its MIS-weighted contribution, the light, the light-choice pdf)."""
    light, pdf_light = trace.sample_light(scene, _randfloat(rng, S_LIGHT))
    u_sq = torch.stack([_randfloat(rng, S_SQ0), _randfloat(rng, S_SQ1)], -1)
    # the light-sampled direction is a draw: detached
    # (``lumo_tpu/integrators/common.py:147``)
    wi = trace.sample_towards(scene, light, hit["p"], u_sq).detach()
    contrib = _shadow_branch(scene, mp, wo, wi, hit, light, lam, True, rng,
                             S_OCC)
    return contrib, light, pdf_light


def nee_light_branch(scene, mp, wo, hit, lam, rng):
    """One light-sampled NEE estimate divided by the light-choice pdf; the
    BSDF-sampled companion is the extension ray
    (:func:`emitter_mis_weight`)."""
    contrib, _, pdf_light = _light_strategy(scene, mp, wo, hit, lam, rng)
    return contrib / torch.clamp(pdf_light[..., None], min=_TINY)


def single_shadow_ray(scene, mp, wo, hit, lam, rng):
    """One NEE estimate with both strategies, the light sample and the
    BSDF sample, MIS-combined and divided by the light-choice pdf
    (reference ``integrator.rs:87-137``).  For a path that ends at the
    vertex (the direct-light integrator), where no extension ray carries
    the BSDF strategy."""
    contrib_a, light, pdf_light = _light_strategy(scene, mp, wo, hit, lam,
                                                  rng)
    u_sq = torch.stack([_randfloat(rng, S_SQ2), _randfloat(rng, S_SQ3)], -1)
    wi_b, ok_b, _ = bsdf.sample(mp, wo, hit["ns"], hit["backface"], lam,
                                _randfloat(rng, S_LOBE), u_sq)
    contrib_b = _shadow_branch(scene, mp, wo, wi_b, hit, light, lam, False,
                               rng, S_OCCB)
    contrib_b = torch.where(ok_b[..., None], contrib_b, 0.0)
    return (contrib_a + contrib_b) / torch.clamp(pdf_light[..., None],
                                                 min=_TINY)


def emitter_mis_weight(scene, o, d, hit, p_sct, did_nee):
    """Power-2 MIS weight for emission picked up by an extension ray
    (o, d) sampled with BSDF pdf ``p_sct`` at a vertex that ran NEE
    (``did_nee``); full weight otherwise (reference
    ``path_trace.rs:24-28``, ``integrator.rs:139-184``)."""
    light = hit["light"]
    is_light = light >= 0
    lsafe = torch.clamp(light, 0, max(scene.n_lights - 1, 0))
    p_lig = trace.sample_towards_pdf(scene, lsafe, o, d, hit["p"], hit["ng"])
    ok = is_light & (p_sct > 0.0) & torch.isfinite(p_sct) & (p_lig > 0.0) \
        & torch.isfinite(p_lig)
    ratio = torch.clamp(torch.where(ok, p_lig, 0.0)
                        / torch.where(p_sct > 0.0, p_sct, 1.0), 0.0, 1e18)
    w = 1.0 / (1.0 + ratio * ratio)
    return torch.where(did_nee, torch.where(ok, w, 1.0), 1.0)


def nee_rays(scene, mp, wo, gathered, hit, lam, rng):
    """Average ``n_shadow_rays`` light-branch NEE estimates, scaled by the
    path throughput (reference ``integrator.rs:74-85``)."""
    n = scene.n_shadow_rays
    acc = 0.0
    for i in range(n):
        acc = acc + nee_light_branch(scene, mp, wo, hit, lam, _fold(rng, i))
    return gathered * acc / n


def shadow_rays(scene, mp, wo, gathered, hit, lam, rng):
    """Average ``n_shadow_rays`` two-strategy NEE estimates, scaled by the
    path throughput (reference ``integrator.rs:74-85``)."""
    n = scene.n_shadow_rays
    acc = 0.0
    for i in range(n):
        acc = acc + single_shadow_ray(scene, mp, wo, hit, lam, _fold(rng, i))
    return gathered * acc / n
