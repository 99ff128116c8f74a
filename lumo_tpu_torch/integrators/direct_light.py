"""Direct-light integrator: follow specular chains, one NEE at the first
non-specular hit.

Counterpart of ``lumo_tpu/integrators/direct_light.py`` (reference
``direct_light.rs``): up to ``MAX_RECURSION`` specular bounces of a
wavefront under an alive mask, a Python loop with one host ``any()`` per
bounce as in ``path_trace.integrate``, then a single NEE with both
strategies MIS-combined (``common.shadow_rays``).
"""
from __future__ import annotations

import torch

from lumo_tpu_torch.bsdf import eval as bsdf
from lumo_tpu_torch.config import RADIANCE
from lumo_tpu_torch.geometry import intersect as geo
from lumo_tpu_torch.integrators import common, path_trace
from lumo_tpu_torch.sampling.samplers import MASK32, _hash_u32, _randfloat
from lumo_tpu_torch.scene import trace

MAX_RECURSION = 50    # reference ``direct_light.rs:3``

_S_LOBE = 0x632BE59B
_S_SQ0 = 0x85297A4D
_S_SQ1 = 0xD6E8FEB8
_S_MED = 0xE7037ED1


def integrate(scene, o, d, lam, ray_key=None, generator=None,
              max_depth=MAX_RECURSION):
    """Trace a wavefront of N camera rays (o, d (N, 3), hero wavelengths
    lam (N, 4)); ``ray_key`` as in ``path_trace.integrate``.  Runs until
    no lane is alive or ``max_depth + 1`` bounces have run.  Returns
    (radiance (N, 4), lam_out (N, 4), depth (N,))."""
    N, dev = o.shape[0], o.device
    if ray_key is None:
        ray_key = path_trace.ray_keys(generator, N, device=dev)
    radiance = torch.zeros((N, 4), dtype=o.dtype, device=dev)
    gathered = torch.ones((N, 4), dtype=o.dtype, device=dev)
    alive = torch.ones(N, dtype=torch.bool, device=dev)
    depth = torch.zeros(N, dtype=torch.int32, device=dev)
    rng = torch.as_tensor(ray_key, dtype=torch.int64, device=dev)
    gather = lambda mat, lam_, hit: bsdf.gather_params(
        scene.materials, mat, lam_, hit["uv"], scene.textures,
        scene.tex_kinds, t=hit["t"], kinds=scene.kinds_present,
        beck=scene.beckmann)
    for _ in range(max_depth + 1):
        if not bool(alive.any()):
            break
        rng = _hash_u32((rng + 0x9E3779B9) & MASK32)
        hit = trace.intersect(scene, o, d, rng=rng, salt=_S_MED, alive=alive)
        live = alive & hit["valid"]
        wo = -d
        # per-segment medium transmittance (reference ``direct_light.rs:17``)
        tr_seg = trace.transmittance(scene, lam, hit["t"])
        gathered0 = gathered * torch.where(live[..., None], tr_seg, 1.0)

        mp = gather(hit["mat"], lam, hit)
        u_sq = torch.stack([_randfloat(rng, _S_SQ0), _randfloat(rng, _S_SQ1)],
                           dim=-1)
        wi, sample_ok, lam2 = bsdf.sample(mp, wo, hit["ns"], hit["backface"],
                                          lam, _randfloat(rng, _S_LOBE), u_sq)
        mp2 = gather(hit["mat"], lam2, hit)

        # lights end the path with their emission (reference
        # ``direct_light.rs:22-25``)
        emit = trace.emitted(scene, hit["mat"], lam, hit["uv"],
                             hit["backface"])
        radiance = radiance + torch.where((live & ~sample_ok)[..., None],
                                          gathered0 * emit, 0.0)
        live = live & sample_ok

        # non-specular: one NEE, then stop (``direct_light.rs:27-36``)
        nee = common.shadow_rays(scene, mp2, wo, gathered0, hit, lam2, rng)
        radiance = radiance + torch.where(
            (live & ~mp["is_specular"])[..., None], nee, 0.0)
        live = live & mp["is_specular"]

        # the specular chain goes on
        ro = geo.offset_ray_origin(hit["p"], hit["err"], hit["ng"], wi)
        p_sct = bsdf.pdf(mp2, wo, wi, hit["ng"], hit["ns"], lam2)
        live = live & (p_sct > 0.0) & torch.isfinite(p_sct)
        # the divisor is sanitised before the mask: a dead lane's f / 0
        # would give NaN gradients through the select
        p_safe = torch.where(live, p_sct, 1.0)
        f_val = bsdf.f(mp2, wo, wi, hit["ng"], hit["ns"], hit["backface"],
                       lam2, RADIANCE)
        # a medium's phase sample cancels its pdf (``direct_light.rs:54-60``)
        f_val = torch.where(hit["is_medium"][..., None],
                            f_val * p_safe[..., None], f_val)
        f_val = torch.where(live[..., None], f_val, 0.0)
        cosine = bsdf.shading_cosine(mp2, wi, hit["ns"])
        g_next = gathered0 * f_val * (cosine / p_safe)[..., None]

        l3 = live[..., None]
        o = torch.where(l3, ro, o)
        d = torch.where(l3, wi, d)
        lam = torch.where(l3, lam2, lam)
        gathered = torch.where(l3, g_next, gathered)
        alive = live
        depth = depth + live.to(depth.dtype)
    return radiance, lam, depth + 1
