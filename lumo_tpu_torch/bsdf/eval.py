"""BSDF evaluate / sample / pdf over material-tagged ray wavefronts.

Counterpart of ``lumo_tpu/bsdf/eval.py`` (reference ``bsdf.rs``,
``bxdf.rs``, ``bxdf/{microfacet,scatter,volumetric}.rs``): Lambertian,
microfacet diffuse, conductors, dielectrics (smooth, rough, dispersive),
the Henyey-Greenstein medium and lights, with GGX or Beckmann normals and
textured kd/ks/tf.  Every lane gathers its material row and the families
present are evaluated masked; results select by kind tag.  Which
families are built is decided on the host from the scene's set of kinds
(``kinds_present``), as the JAX package decides it at trace time.

Transport mode: RADIANCE, or IMPORTANCE for the light subpaths of the
bidirectional integrator; they differ only in the refraction's
eta_ratio^2 scale, which radiance alone carries.

Differentiability, as in the JAX package: sampled directions and discrete
choices are detached; f and pdf stay differentiable in every float leaf
of the material table.
"""
from __future__ import annotations

import math

import torch

from lumo_tpu_torch import texture as texture_mod
from lumo_tpu_torch.bsdf import microfacet as mf
from lumo_tpu_torch.color import dense, uplift, wavelength
from lumo_tpu_torch.config import RADIANCE
from lumo_tpu_torch.geometry import onb
from lumo_tpu_torch.geometry.onb import dot, normalize, safe_sqrt
from lumo_tpu_torch.sampling import maps
from lumo_tpu_torch.scene.materials import (BLANK, LAMBERTIAN, LIGHT,
                                            MF_CONDUCTOR, MF_DIELECTRIC,
                                            MF_DIFFUSE, VOLUMETRIC)

PI = math.pi
_TINY = 1e-30
# geometric-denominator floors (``lumo_tpu/bsdf/eval.py:25-32``)
_EPS_COS = 1e-7
_EPS_COS2 = 1e-10
DELTA_EPS = 1e-5      # 1 - cos(theta_h) tolerance for delta pdf checks


def kinds_present(kind_tbl) -> frozenset:
    """The set of material kinds in a kind table (host copy)."""
    return frozenset(int(k) for k in torch.unique(kind_tbl.cpu()).tolist())


def dispersive_mask(materials: dict, mat):
    """Lanes whose material terminates hero wavelengths on sampling
    (non-constant-eta dielectric)."""
    return (materials["kind"][mat] == MF_DIELECTRIC) & ~materials["eta_const"][mat]


def gather_params(materials: dict, mat, lam, uv, textures=None, tex_kinds=(),
                  t=None, kinds=None, beck=None):
    """Gather per-ray material parameters at wavelengths ``lam`` (N, 4).

    With a texture table, kd/ks/tf of texture id >= 0 are the texture's
    albedo at ``uv``.  ``t`` is the hit distance that volumetric lanes
    need (the medium's transmittance-pdf cancel, ``bxdf.rs:96-98``).
    ``kinds``: the scene's ``kinds_present``; ``beck``: whether the table
    has Beckmann rows (both read from the table when not given)."""
    m = materials
    kp = kinds_present(m["kind"]) if kinds is None else kinds
    if beck is None:
        beck = bool(torch.any(m["mf_beck"]).item())
    have = lambda *ks: any(k in kp for k in ks)
    need_mf = have(MF_CONDUCTOR, MF_DIFFUSE, MF_DIELECTRIC)
    need_tf = have(MF_DIELECTRIC)
    need_vol = have(VOLUMETRIC)
    kind = m["kind"][mat]
    rough = m["roughness"][mat]
    rough_y = m["roughness_y"][mat]
    zero4 = torch.zeros(kind.shape + (4,), dtype=lam.dtype, device=lam.device)
    spectrum = lambda key: uplift.sample(m[key][mat][..., None, :], lam)
    if need_mf:
        eta4 = dense.sample_rows(m["eta"], mat, lam)
        k4 = dense.sample_rows(m["k"], mat, lam)
    else:
        eta4 = torch.ones_like(zero4)
        k4 = zero4
    # delta classification (reference ``microfacet.rs:79-83``,
    # ``bxdf.rs:57-66``)
    mf_delta = (rough + rough_y) / 2.0 < 1e-3
    is_delta = (kind == MF_CONDUCTOR) & mf_delta
    if need_tf:
        is_delta = is_delta | ((kind == MF_DIELECTRIC)
                               & (mf_delta | (eta4[..., 0] == 1.0)))
    out = {
        "kind": kind,
        "kinds_present": kp,
        "alpha": torch.stack([rough, rough_y], dim=-1),
        "mf_beck": m["mf_beck"][mat] if beck else False,
        "mf_delta": mf_delta,
        "is_delta": is_delta,
        "is_specular": m["is_specular"][mat],
        "eta4": eta4,
        "k4": k4,
        "eta_const": m["eta_const"][mat],
        "kd": spectrum("kd"),
        "ks": spectrum("ks") if need_mf else zero4,
        "tf": spectrum("tf") if need_tf else zero4,
        "hg_g": m["hg_g"][mat] if need_vol else torch.zeros_like(rough),
        "sigma_t4": spectrum("sigma_t") if need_vol else zero4,
        "sigma_s4": spectrum("sigma_s") if need_vol else zero4,
    }
    if t is None or not need_vol:
        out["t_scaled"] = torch.zeros_like(rough)
    else:
        out["t_scaled"] = torch.where(torch.isfinite(t), t, 0.0) \
            * m["t_scale"][mat]
    if textures is not None and uv is not None:
        slots = ("kd",) + (("ks",) if need_mf else ()) \
            + (("tf",) if need_tf else ())
        for slot in slots:
            tid = m[slot + "_tex"][mat]
            val = texture_mod.albedo(textures, tid, lam, uv, kinds=tex_kinds)
            out[slot] = torch.where((tid >= 0)[..., None], val, out[slot])
    return out


def _have(mp, *kinds):
    return any(k in mp["kinds_present"] for k in kinds)


def _z_axis(like):
    z = torch.zeros_like(like)
    z[..., 2] = 1.0
    return z


def _reflect(wo, wh):
    """Mirror wo about wh; valid if the result is in wo's hemisphere
    (reference ``bxdf/microfacet.rs:7-17``)."""
    wi = 2.0 * dot(wo, wh)[..., None] * wh - wo
    return wi, onb.same_hemisphere(wi, wo)


def _refract(eta, wo, no):
    """Snell refraction (reference ``bxdf/microfacet.rs:19-42``); eta is
    the material IOR, the orientation flip is handled here.  TIR lanes
    come back invalid."""
    cos = dot(no, wo)
    inside = cos < 0.0
    cos_to = torch.abs(cos)
    eta_ratio = torch.where(inside, 1.0 / eta, eta)
    n = torch.where(inside[..., None], -no, no)
    sin2_ti = (1.0 - cos_to * cos_to) / eta_ratio ** 2
    cos_ti = safe_sqrt(1.0 - torch.clamp(sin2_ti, max=1.0))
    wi = -wo / eta_ratio[..., None] \
        + (cos_to / eta_ratio - cos_ti)[..., None] * n
    valid = ~onb.same_hemisphere(wi, wo) & (sin2_ti < 1.0)
    return wi, valid


def _half(v):
    """Normalized half vector; a zero input (wi == -wo) becomes +z."""
    n2 = dot(v, v)[..., None]
    v2 = torch.where(n2 < 1e-12, _z_axis(v), v)
    return v2 / torch.sqrt(dot(v2, v2))[..., None]


def _dielectric_pdf(p_vndf, reflection, die_delta, wh_is_z, whdo, whdi,
                    eta_ratio, pr, pt):
    """The dielectric's lobe pdf (reference ``bxdf/microfacet.rs:753-821``):
    delta lanes test the z axis, rough lanes the normal pdf with the
    reflect or refract Jacobian."""
    return torch.where(
        reflection & die_delta, torch.where(wh_is_z, pr, 0.0),
        torch.where(
            reflection,
            p_vndf / torch.clamp(4.0 * torch.abs(whdo), min=_EPS_COS) * pr,
            torch.where(die_delta, torch.where(wh_is_z, pt, 0.0),
                        p_vndf * torch.abs(whdi)
                        / torch.clamp((whdi + whdo / eta_ratio) ** 2,
                                      min=_EPS_COS2) * pt)))


def _hg_pdf(mp, wo_w, wi_w):
    """Henyey-Greenstein phase pdf (reference
    ``bxdf/volumetric.rs:48-63``)."""
    g = mp["hg_g"]
    g2 = g * g
    ct = dot(normalize(wo_w, eps=_TINY), normalize(wi_w, eps=_TINY))
    den = 1.0 + g2 + 2.0 * g * ct
    return (1.0 - g2) / torch.clamp(4.0 * PI * den * safe_sqrt(den),
                                    min=_EPS_COS)


def f_pdf(mp, wo_w, wi_w, ng, ns, backface, lam, mode=RADIANCE):
    """(BSDF value (N, 4), pdf (N,)) for the direction pair (wo_w, wi_w)
    (reference ``bxdf.rs:69-103,135-151``); only the families present
    are built.  ``mode`` is RADIANCE or IMPORTANCE (a Python int)."""
    reflection = dot(ng, wi_w) * dot(ng, wo_w) >= 0.0
    wo = onb.to_local(ns, wo_w)
    wi = onb.to_local(ns, wi_w)
    kind = mp["kind"]
    beck = mp["mf_beck"]
    cos_o = onb.cos_theta(wo)
    cos_i = onb.cos_theta(wi)
    abs_ci = torch.clamp(torch.abs(cos_i), min=_EPS_COS)
    same_hemi = cos_o * cos_i > 0.0
    refl_ok = reflection & ~backface
    out = torch.zeros(wo.shape[:-1] + (4,), dtype=wo.dtype, device=wo.device)
    p_out = torch.zeros(wo.shape[:-1], dtype=wo.dtype, device=wo.device)
    z_axis = _z_axis(wo)

    if _have(mp, LAMBERTIAN, MF_DIFFUSE):
        f_lam = mp["kd"] / PI
        p_cos = torch.where(same_hemi & (cos_i > 0.0), cos_i / PI, 0.0)

    if _have(mp, MF_CONDUCTOR, MF_DIFFUSE, MF_DIELECTRIC):
        wh_r = _half(wo + wi)
        d_r = mf.d_dist(wh_r, mp["alpha"], beck)
        g_r = mf.g_smith_dist(wo, wi, wh_r, mp["alpha"], beck)
        cos_wh_dot = dot(wo, wh_r)
        fr4 = mf.fresnel(cos_wh_dot[..., None], mp["eta4"], mp["k4"])
        denom_r = 4.0 * torch.clamp(torch.abs(cos_o), min=_EPS_COS) * abs_ci
        refl_coeff = (d_r * g_r / denom_r)[..., None] * fr4
        # pdf side: upper-hemisphere half vector and the normal pdf
        wh_ru = torch.where(onb.cos_theta(wh_r)[..., None] < 0.0, -wh_r, wh_r)
        p_refl_rough = mf.normal_pdf(wh_ru, wo, mp["alpha"], beck) \
            / torch.clamp(4.0 * torch.abs(cos_wh_dot), min=_EPS_COS)
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

    # dielectric (reference ``bxdf/microfacet.rs:658-721,753-821``)
    if _have(mp, MF_DIELECTRIC):
        eta = torch.clamp(mp["eta4"][..., 0], min=_TINY)  # leading lambda
        eta_ratio = torch.where(reflection, 1.0,
                                torch.where(cos_o < 0.0, 1.0 / eta, eta))
        die_delta = (mp["eta4"][..., 0] == 1.0) | mp["mf_delta"]
        wh_t = torch.where(die_delta[..., None], z_axis,
                           _half(wi * eta_ratio[..., None] + wo))
        fr_t = mf.fresnel(dot(wo, wh_t)[..., None], mp["eta4"], mp["k4"])
        wh_tp = torch.where(onb.cos_theta(wh_t)[..., None] < 0.0, -wh_t,
                            wh_t)
        # radiance is scaled by eta_ratio^2 across the interface,
        # importance is not (``lumo_tpu/bsdf/eval.py:296``)
        scale = eta_ratio ** 2 if mode == RADIANCE \
            else torch.ones_like(eta_ratio)
        f_die_refl = torch.where(die_delta[..., None],
                                 mp["ks"] * fr_t / abs_ci[..., None],
                                 mp["ks"] * refl_coeff)
        d_t = mf.d_dist(wh_tp, mp["alpha"], beck)
        g_t = mf.g_smith_dist(wo, wi, wh_tp, mp["alpha"], beck)
        whdo = dot(wh_tp, wo)
        whdi = dot(wh_tp, wi)
        denom_t = torch.clamp((eta_ratio * whdi + whdo) ** 2, min=_EPS_COS2)
        jac = torch.abs(whdi * whdo / torch.clamp(torch.abs(cos_i * cos_o),
                                                  min=_EPS_COS))
        f_die_tran = torch.where(
            die_delta[..., None],
            mp["tf"] * (1.0 - fr_t) / (scale * abs_ci)[..., None],
            mp["tf"] * (1.0 - fr_t)
            * (d_t * g_t * jac / (scale * denom_t))[..., None])
        f_die = torch.where(reflection[..., None], f_die_refl, f_die_tran)
        degenerate = (whdo == 0.0) | (whdi == 0.0)
        backfacing_wh = (whdo * cos_o < 0.0) | (whdi * cos_i < 0.0)
        pr = mf.fresnel(whdo, eta, mp["k4"][..., 0])
        p_die = _dielectric_pdf(
            mf.normal_pdf(wh_tp, wo, mp["alpha"], beck), reflection,
            die_delta, 1.0 - onb.cos_theta(wh_tp) < DELTA_EPS, whdo, whdi,
            eta_ratio, pr, 1.0 - pr)
        p_die = torch.where(degenerate | backfacing_wh, 0.0, p_die)
        sel = kind == MF_DIELECTRIC
        out = torch.where(sel[..., None], f_die, out)
        p_out = torch.where(sel, p_die, p_out)

    # volumetric: sigma_s over the transmittance-sampling pdf that the
    # scene's transmittance estimate cancels (``bxdf/volumetric.rs:3-18``)
    if _have(mp, VOLUMETRIC):
        tr_v = torch.exp(-mp["sigma_t4"] * mp["t_scaled"][..., None])
        mean_tr = torch.clamp(tr_v.mean(-1), min=_TINY)
        pdf_cancel = (tr_v * mp["sigma_t4"]).mean(-1) / mean_tr
        pc_ok = pdf_cancel > 0.0
        pc_safe = torch.where(pc_ok, pdf_cancel, 1.0)
        f_vol = torch.where(pc_ok[..., None],
                            mp["sigma_s4"] / pc_safe[..., None],
                            torch.ones_like(out))
        sel = kind == VOLUMETRIC
        out = torch.where(sel[..., None], f_vol, out)
        p_out = torch.where(sel, _hg_pdf(mp, wo_w, wi_w), p_out)

    # lambertian last (reference ``bxdf.rs:78-84``)
    if _have(mp, LAMBERTIAN):
        sel = kind == LAMBERTIAN
        out = torch.where(sel[..., None] & refl_ok[..., None], f_lam, out)
        p_out = torch.where(sel & reflection, p_cos, p_out)

    out = torch.where(torch.isfinite(out), out, 0.0)
    p_out = torch.where(torch.isfinite(p_out), p_out, 0.0)
    return out, p_out


def f(mp, wo_w, wi_w, ng, ns, backface, lam, mode=RADIANCE):
    """BSDF value (N, 4); wo_w points away from the surface, towards the
    viewer."""
    return f_pdf(mp, wo_w, wi_w, ng, ns, backface, lam, mode)[0]


def sample(mp, wo_w, ns, backface, lam, u_lobe, u_sq):
    """Sample a scattering direction (reference ``bxdf.rs:105-133``).
    Returns (wi_world, valid, lam_out); lam_out has its trailing hero
    samples terminated where a dispersive dielectric was sampled
    (reference ``bxdf/microfacet.rs:723-751``)."""
    wo = onb.to_local(ns, wo_w)
    kind = mp["kind"]
    z_axis = _z_axis(wo)

    # lambertian / diffuse cosine lobe (also the fallthrough default)
    wi_cos = maps.square_to_cos_hemisphere(u_sq)
    wi = wi_cos
    ok = kind == LAMBERTIAN

    if _have(mp, MF_CONDUCTOR, MF_DIFFUSE, MF_DIELECTRIC):
        wh = mf.sample_normal_dist(wo, mp["alpha"], u_sq, mp["mf_beck"])

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

    # dielectric: terminate the wavelengths of dispersive lanes, then a
    # Fresnel lobe pick
    lam_out = lam
    if _have(mp, MF_DIELECTRIC):
        dispersive = (kind == MF_DIELECTRIC) & ~mp["eta_const"]
        lam_out = wavelength.terminate(lam, dispersive)
        eta_lead = torch.clamp(mp["eta4"][..., 0], min=_TINY)
        die_delta = (mp["eta4"][..., 0] == 1.0) | mp["mf_delta"]
        wh_t = torch.where(die_delta[..., None], z_axis, wh)
        pr = mf.fresnel(dot(wo, wh_t), eta_lead, mp["k4"][..., 0])
        pick_refl = u_lobe < pr                # pt = 1 - pr
        wi_die_r, die_r_ok = _reflect(wo, wh_t)
        wi_die_t, die_t_ok = _refract(eta_lead, wo, wh_t)
        sel = kind == MF_DIELECTRIC
        wi = torch.where(sel[..., None],
                         torch.where(pick_refl[..., None], wi_die_r,
                                     wi_die_t), wi)
        ok = torch.where(sel, torch.where(pick_refl, die_r_ok, die_t_ok), ok)

    # volumetric: Henyey-Greenstein sampling about world-space wo
    # (reference ``bxdf/volumetric.rs:20-46``, with cos(theta) negated so
    # the samples follow the declared pdf, as ``lumo_tpu`` does)
    if _have(mp, VOLUMETRIC):
        g = mp["hg_g"]
        g2 = g * g
        iso = torch.abs(g) < 1e-3
        g_safe = torch.where(iso, 1.0, g)
        fract = (1.0 - g2) / torch.clamp(1.0 - g + 2.0 * g * u_sq[..., 0],
                                         min=1e-6)
        ct_hg = torch.where(iso, 1.0 - 2.0 * u_sq[..., 0],
                            -(1.0 + g2 - fract * fract) / (2.0 * g_safe))
        st_hg = safe_sqrt(1.0 - ct_hg ** 2)
        phi_hg = 2.0 * PI * u_sq[..., 1]
        wi_vol_local = torch.stack([st_hg * torch.cos(phi_hg),
                                    st_hg * torch.sin(phi_hg), ct_hg], dim=-1)
        wi_vol = onb.to_world(normalize(wo_w, eps=_TINY), wi_vol_local)
        ok = torch.where(kind == VOLUMETRIC, True, ok)

    # reflection-only BxDFs cannot sample from the backface
    # (reference ``bxdf.rs:44-55,109-112``)
    transmissive = (kind == MF_DIELECTRIC) | (kind == VOLUMETRIC)
    ok = ok & (transmissive | ~backface)
    ok = ok & (kind != LIGHT) & (kind != BLANK)
    wi_w = onb.to_world(ns, wi)
    if _have(mp, VOLUMETRIC):
        wi_w = torch.where((kind == VOLUMETRIC)[..., None], wi_vol, wi_w)
    # the sampled direction is a discrete draw: detached, as in the JAX
    # package; f and pdf stay differentiable in the material table
    return normalize(wi_w.detach(), eps=_TINY), ok, lam_out


def pdf(mp, wo_w, wi_w, ng, ns, lam):
    """Solid-angle pdf of :func:`sample` (reference ``bxdf.rs:135-151``)."""
    reflection = dot(ng, wi_w) * dot(ng, wo_w) >= 0.0
    wo = onb.to_local(ns, wo_w)
    wi = onb.to_local(ns, wi_w)
    kind = mp["kind"]
    beck = mp["mf_beck"]
    same_hemi = onb.same_hemisphere(wo, wi)
    out = torch.zeros(wo.shape[:-1], dtype=wo.dtype, device=wo.device)

    if _have(mp, LAMBERTIAN, MF_DIFFUSE):
        cos_i = onb.cos_theta(wi)
        p_cos = torch.where(same_hemi & (cos_i > 0.0), cos_i / PI, 0.0)

    if _have(mp, MF_CONDUCTOR, MF_DIFFUSE):
        wh_r = _half(wo + wi)
        wh_r = torch.where(onb.cos_theta(wh_r)[..., None] < 0.0, -wh_r, wh_r)
        p_refl_rough = mf.normal_pdf(wh_r, wo, mp["alpha"], beck) \
            / torch.clamp(4.0 * torch.abs(dot(wo, wh_r)), min=_EPS_COS)
        p_refl_delta = torch.where(1.0 - onb.cos_theta(wh_r) < DELTA_EPS,
                                   1.0, 0.0)
        p_spec = torch.where(mp["mf_delta"], p_refl_delta, p_refl_rough)

    if _have(mp, MF_CONDUCTOR):
        p_cond = torch.where(same_hemi, p_spec, 0.0)
        out = torch.where((kind == MF_CONDUCTOR) & reflection, p_cond, out)

    if _have(mp, MF_DIFFUSE):
        pr_d = mf.f_schlick(0.04, 1.0, onb.cos_theta(wo))
        p_diff = torch.where(same_hemi, pr_d * p_spec + (1.0 - pr_d) * p_cos,
                             0.0)
        out = torch.where((kind == MF_DIFFUSE) & reflection, p_diff, out)

    if _have(mp, MF_DIELECTRIC):
        eta = mp["eta4"][..., 0]
        cos_o = onb.cos_theta(wo)
        eta_ratio = torch.where(
            reflection, 1.0,
            torch.where(cos_o < 0.0, 1.0 / torch.clamp(eta, min=_TINY), eta))
        eta_one = eta == 1.0
        die_delta = eta_one | mp["mf_delta"]
        wh = torch.where(eta_one[..., None], _z_axis(wo),
                         _half(wo + wi * eta_ratio[..., None]))
        wh = torch.where(onb.cos_theta(wh)[..., None] < 0.0, -wh, wh)
        whdo = dot(wo, wh)
        whdi = dot(wi, wh)
        degenerate = (whdo == 0.0) | (whdi == 0.0)
        backfacing_wh = (whdo * cos_o < 0.0) \
            | (whdi * onb.cos_theta(wi) < 0.0)
        pr = mf.fresnel(whdo, torch.clamp(eta, min=_TINY), mp["k4"][..., 0])
        p_die = _dielectric_pdf(
            mf.normal_pdf(wh, wo, mp["alpha"], beck), reflection, die_delta,
            1.0 - onb.cos_theta(wh) < DELTA_EPS, whdo, whdi, eta_ratio, pr,
            1.0 - pr)
        p_die = torch.where(degenerate | backfacing_wh, 0.0, p_die)
        out = torch.where(kind == MF_DIELECTRIC, p_die, out)

    if _have(mp, VOLUMETRIC):
        out = torch.where(kind == VOLUMETRIC, _hg_pdf(mp, wo_w, wi_w), out)

    if _have(mp, LAMBERTIAN):
        out = torch.where((kind == LAMBERTIAN) & reflection, p_cos, out)

    return torch.where(torch.isfinite(out), out, 0.0)


def shading_cosine(mp, wi_w, ns):
    """|ns . wi| for surface materials, 1 for volumetric (reference
    ``material.rs:316-321``)."""
    c = torch.abs(dot(ns, wi_w))
    if _have(mp, VOLUMETRIC):
        c = torch.where(mp["kind"] == VOLUMETRIC, 1.0, c)
    return c
