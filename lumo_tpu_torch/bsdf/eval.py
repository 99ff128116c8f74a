"""BSDF evaluate / sample over material-tagged ray wavefronts.

Counterpart of ``lumo_tpu/bsdf/eval.py`` (reference ``bsdf.rs``,
``bxdf.rs``) for the Lambertian, microfacet-diffuse, conductor and light
kinds; dielectrics and media come with a later slice and
``SceneBuilder.build`` raises on them.  Every lane gathers its material
row and the families present are evaluated masked; results select by
kind tag.  Which families are built is decided on the host from the
scene's set of kinds (``kinds_present``), as the JAX package decides it
at trace time.

Differentiability, as in the JAX package: sampled directions and discrete
choices are detached; f and pdf stay differentiable in every float leaf
of the material table.
"""
from __future__ import annotations

import math

import torch

from lumo_tpu_torch.bsdf import microfacet as mf
from lumo_tpu_torch.color import dense, uplift
from lumo_tpu_torch.config import RADIANCE
from lumo_tpu_torch.geometry import onb
from lumo_tpu_torch.geometry.onb import dot, normalize
from lumo_tpu_torch.sampling import maps
from lumo_tpu_torch.scene.materials import (BLANK, LAMBERTIAN, LIGHT,
                                            MF_CONDUCTOR, MF_DIELECTRIC,
                                            MF_DIFFUSE, VOLUMETRIC)

PI = math.pi
_TINY = 1e-30
_EPS_COS = 1e-7
DELTA_EPS = 1e-5      # 1 - cos(theta_h) tolerance for delta pdf checks

_PORTED = frozenset((BLANK, LAMBERTIAN, MF_DIFFUSE, MF_CONDUCTOR, LIGHT))


def kinds_present(kind_tbl) -> frozenset:
    """The set of material kinds in a kind table (host copy)."""
    kinds = frozenset(int(k) for k in torch.unique(kind_tbl.cpu()).tolist())
    if not kinds <= _PORTED:
        raise NotImplementedError(
            "dielectric and volumetric materials are not ported to "
            "lumo_tpu_torch yet (ROADMAP.md, module queue item 7)")
    return kinds


def dispersive_mask(materials: dict, mat):
    """Lanes whose material terminates hero wavelengths on sampling
    (non-constant-eta dielectric)."""
    return (materials["kind"][mat] == MF_DIELECTRIC) & ~materials["eta_const"][mat]


def gather_params(materials: dict, mat, lam, uv, kinds=None):
    """Gather per-ray material parameters at wavelengths ``lam`` (N, 4).
    ``kinds``: the scene's ``kinds_present`` (read from the table when
    not given)."""
    m = materials
    kp = kinds
    if kp is None:  # a scene's table was checked when it was built
        kp = kinds_present(m["kind"])
        if torch.any(m["mf_beck"]).item():
            raise NotImplementedError(
                "the Beckmann distribution is not ported to lumo_tpu_torch "
                "yet (ROADMAP.md, module queue item 7)")
    need_mf = bool(kp & {MF_CONDUCTOR, MF_DIFFUSE})
    kind = m["kind"][mat]
    rough = m["roughness"][mat]
    rough_y = m["roughness_y"][mat]
    zero4 = torch.zeros(kind.shape + (4,), dtype=lam.dtype, device=lam.device)
    if need_mf:
        eta4 = dense.sample_rows(m["eta"], mat, lam)
        k4 = dense.sample_rows(m["k"], mat, lam)
    else:
        eta4 = torch.ones_like(zero4)
        k4 = zero4
    # delta classification (reference ``microfacet.rs:79-83``)
    mf_delta = (rough + rough_y) / 2.0 < 1e-3
    is_delta = (kind == MF_CONDUCTOR) & mf_delta
    return {
        "kind": kind,
        "kinds_present": kp,
        "alpha": torch.stack([rough, rough_y], dim=-1),
        "mf_delta": mf_delta,
        "is_delta": is_delta,
        "is_specular": m["is_specular"][mat],
        "eta4": eta4,
        "k4": k4,
        "eta_const": m["eta_const"][mat],
        "kd": uplift.sample(m["kd"][mat][..., None, :], lam),
        "ks": uplift.sample(m["ks"][mat][..., None, :], lam) if need_mf
        else zero4,
    }


def _have(mp, *kinds):
    return any(k in mp["kinds_present"] for k in kinds)


def _reflect(wo, wh):
    """Mirror wo about wh; valid if the result is in wo's hemisphere
    (reference ``bxdf/microfacet.rs:7-17``)."""
    wi = 2.0 * dot(wo, wh)[..., None] * wh - wo
    return wi, onb.same_hemisphere(wi, wo)


def _half(v):
    """Normalized half-vector; a zero input (wi == -wo) becomes +z."""
    n2 = dot(v, v)[..., None]
    z = torch.zeros_like(v)
    z[..., 2] = 1.0
    v2 = torch.where(n2 < 1e-12, z, v)
    return v2 / torch.sqrt(dot(v2, v2))[..., None]


def f_pdf(mp, wo_w, wi_w, ng, ns, backface, lam, mode=RADIANCE):
    """(BSDF value (N, 4), pdf (N,)) for the direction pair (wo_w, wi_w)
    (reference ``bxdf.rs:69-103,135-151``); only the families present
    are built."""
    reflection = dot(ng, wi_w) * dot(ng, wo_w) >= 0.0
    wo = onb.to_local(ns, wo_w)
    wi = onb.to_local(ns, wi_w)
    kind = mp["kind"]
    cos_o = onb.cos_theta(wo)
    cos_i = onb.cos_theta(wi)
    abs_ci = torch.clamp(torch.abs(cos_i), min=_EPS_COS)
    same_hemi = cos_o * cos_i > 0.0
    refl_ok = reflection & ~backface
    out = torch.zeros(wo.shape[:-1] + (4,), dtype=wo.dtype, device=wo.device)
    p_out = torch.zeros(wo.shape[:-1], dtype=wo.dtype, device=wo.device)
    z_axis = torch.zeros_like(wo)
    z_axis[..., 2] = 1.0

    if _have(mp, LAMBERTIAN, MF_DIFFUSE):
        f_lam = mp["kd"] / PI
        p_cos = torch.where(same_hemi & (cos_i > 0.0), cos_i / PI, 0.0)

    if _have(mp, MF_CONDUCTOR, MF_DIFFUSE):
        wh_r = _half(wo + wi)
        d_r = mf.d_ggx(wh_r, mp["alpha"])
        g_r = mf.g_smith(wo, wi, wh_r, mp["alpha"])
        cos_wh_dot = dot(wo, wh_r)
        fr4 = mf.fresnel(cos_wh_dot[..., None], mp["eta4"], mp["k4"])
        denom_r = 4.0 * torch.clamp(torch.abs(cos_o), min=_EPS_COS) * abs_ci
        refl_coeff = (d_r * g_r / denom_r)[..., None] * fr4
        # pdf side: upper-hemisphere half-vector + VNDF
        wh_ru = torch.where(onb.cos_theta(wh_r)[..., None] < 0.0, -wh_r, wh_r)
        whdo_r = torch.abs(cos_wh_dot)
        p_vndf_r = mf.vndf_pdf(wh_ru, wo, mp["alpha"])
        p_refl_rough = p_vndf_r / torch.clamp(4.0 * whdo_r, min=_EPS_COS)
        p_refl_delta = torch.where(1.0 - onb.cos_theta(wh_ru) < DELTA_EPS,
                                   1.0, 0.0)

    # conductor (reference ``bxdf/microfacet.rs:516-530``)
    if _have(mp, MF_CONDUCTOR):
        fr_z = mf.fresnel(dot(wo, z_axis)[..., None], mp["eta4"], mp["k4"])
        f_cond = torch.where(mp["mf_delta"][..., None],
                             mp["ks"] * fr_z / abs_ci[..., None],
                             mp["ks"] * refl_coeff)
        p_cond = torch.where(mp["mf_delta"], p_refl_delta, p_refl_rough)
        p_cond = torch.where(same_hemi, p_cond, 0.0)
        sel = kind == MF_CONDUCTOR
        out = torch.where(sel[..., None] & refl_ok[..., None], f_cond, out)
        p_out = torch.where(sel & reflection, p_cond, p_out)

    # microfacet diffuse (reference ``bxdf/microfacet.rs:576-601``)
    if _have(mp, MF_DIFFUSE):
        fd = mf.disney_diffuse(mp["alpha"][..., 0], cos_o, cos_i,
                               onb.cos_theta(wh_r))
        f_diff = refl_coeff * mp["ks"] \
            + mp["kd"] * (1.0 - fr4) * (fd / PI)[..., None]
        pr_d = mf.f_schlick(0.04, 1.0, cos_o)
        p_spec = torch.where(mp["mf_delta"], p_refl_delta, p_refl_rough)
        p_diff = pr_d * p_spec + (1.0 - pr_d) * p_cos
        p_diff = torch.where(same_hemi, p_diff, 0.0)
        sel = kind == MF_DIFFUSE
        out = torch.where(sel[..., None] & refl_ok[..., None], f_diff, out)
        p_out = torch.where(sel & reflection, p_diff, p_out)

    # lambertian last (reference ``bxdf.rs:78-84``)
    if _have(mp, LAMBERTIAN):
        sel = kind == LAMBERTIAN
        out = torch.where(sel[..., None] & refl_ok[..., None], f_lam, out)
        p_out = torch.where(sel & reflection, p_cos, p_out)

    out = torch.where(torch.isfinite(out), out, 0.0)
    p_out = torch.where(torch.isfinite(p_out), p_out, 0.0)
    return out, p_out


def sample(mp, wo_w, ns, backface, lam, u_lobe, u_sq):
    """Sample a scattering direction (reference ``bxdf.rs:105-133``).
    Returns (wi_world, valid, lam_out); no ported kind terminates hero
    wavelengths, so lam_out is lam."""
    wo = onb.to_local(ns, wo_w)
    kind = mp["kind"]
    z_axis = torch.zeros_like(wo)
    z_axis[..., 2] = 1.0

    # lambertian / diffuse cosine lobe (also the fallthrough default)
    wi_cos = maps.square_to_cos_hemisphere(u_sq)
    wi = wi_cos
    ok = kind == LAMBERTIAN

    if _have(mp, MF_CONDUCTOR, MF_DIFFUSE):
        wh = mf.sample_vndf(wo, mp["alpha"], u_sq)

    if _have(mp, MF_CONDUCTOR):
        wi_refl, refl_ok = _reflect(wo, wh)
        wi_cond = torch.where(mp["mf_delta"][..., None], onb.reflect_z(wo),
                              wi_refl)
        cond_ok = torch.where(mp["mf_delta"], True, refl_ok)
        sel = kind == MF_CONDUCTOR
        wi = torch.where(sel[..., None], wi_cond, wi)
        ok = torch.where(sel, cond_ok, ok)

    # microfacet diffuse: Fresnel-Schlick lobe pick (reference
    # ``diffuse::sample``)
    if _have(mp, MF_DIFFUSE):
        pr_d = mf.f_schlick(0.04, 1.0, onb.cos_theta(wo))
        pick_spec = u_lobe < pr_d
        wh_d = torch.where(mp["mf_delta"][..., None], z_axis, wh)
        wi_dspec, dspec_ok = _reflect(wo, wh_d)
        wi_diff = torch.where(pick_spec[..., None], wi_dspec, wi_cos)
        diff_ok = torch.where(pick_spec, dspec_ok, True)
        sel = kind == MF_DIFFUSE
        wi = torch.where(sel[..., None], wi_diff, wi)
        ok = torch.where(sel, diff_ok, ok)

    # reflection-only BxDFs cannot sample from the backface
    # (reference ``bxdf.rs:44-55,109-112``)
    ok = ok & ~backface
    ok = ok & (kind != LIGHT) & (kind != BLANK)
    # the sampled direction is a discrete draw: detached, as in the JAX
    # package; f and pdf stay differentiable in the material table
    wi_w = normalize(onb.to_world(ns, wi).detach(), eps=_TINY)
    return wi_w, ok, lam


def shading_cosine(mp, wi_w, ns):
    """|ns . wi| for surface materials (reference ``material.rs:316-321``)."""
    return torch.abs(dot(ns, wi_w))
