"""The BDPT reference's materials and BSDFs: microfacet diffuse, mirror
(a smooth GGX conductor with measured spectral eta and k), smooth
dispersive glass (a GGX dielectric with the measured glass IOR) and
lights.  A frozen copy of ``lumo_tpu_torch/scene/materials.py``'s
constructors and ``lumo_tpu_torch/bsdf/eval.py``'s ``gather_params``,
``f_pdf``, ``pdf`` and ``sample`` cut to these kinds, with both transport
modes (radiance, and importance for the light subpaths: no eta^2 scale
across a refraction).  The GGX, Smith and Fresnel terms are the path
reference's (``bsdf.py``), itself a frozen copy of ``microfacet.py``."""
from __future__ import annotations

import numpy as np
import torch

from . import spectra
from .bsdf import (DELTA_EPS, LIGHT, MF_CONDUCTOR, MF_DIELECTRIC, MF_DIFFUSE,
                   _half, _reflect, _z_axis, d_ggx, disney_diffuse, f_schlick,
                   fresnel, g_smith, sample_vndf, vndf_pdf)
from .geometry import (PI, dot, normalize, reflect_z, safe_sqrt,
                       same_hemisphere, square_to_cos_hemisphere, to_local,
                       to_world)
from .spectra import dense_rows, uplift_sample

RADIANCE, IMPORTANCE = 0, 1
KINDS = {"diffuse": MF_DIFFUSE, "mirror": MF_CONDUCTOR,
         "glass": MF_DIELECTRIC, "light": LIGHT}
_TINY = 1e-30
_EPS_COS = 1e-7
_EPS_COS2 = 1e-10
# the float tables of a material row, and its other fields
FLOAT_KEYS = ("kd", "ks", "tf", "roughness", "roughness_y", "eta", "k", "ke",
              "illum", "emit_scale")


# ---------------------------------------------------------------------------
# materials (``materials.py``: ``Material.diffuse``, ``mirror``, ``glass``,
# ``light`` and ``pack_materials``)

def _coeffs(spec) -> np.ndarray:
    """A spectrum spec: ``{"srgb8": [r, g, b]}``, an RGB triple or a
    scalar reflectance -> uplift coefficients (4,)."""
    if isinstance(spec, dict):
        return spectra.from_srgb8(*spec["srgb8"])
    return spectra.spectrum(spec)


def material_row(spec: dict) -> dict:
    """One material table row (numpy, float64) of a material spec."""
    kind = spec["kind"]
    if kind not in KINDS:
        raise ValueError(f"material kind {kind!r} is not in the BDPT "
                         "reference")
    full = lambda x: np.full(spectra.DENSE_SAMPLES, float(x))
    row = {"kind": KINDS[kind], "kd": np.zeros(4), "ks": np.zeros(4),
           "tf": np.zeros(4), "roughness": 1.0, "roughness_y": 1.0,
           "eta": np.ones(spectra.DENSE_SAMPLES),
           "k": np.zeros(spectra.DENSE_SAMPLES), "ke": np.zeros(4),
           "illum": np.zeros(spectra.DENSE_SAMPLES), "emit_scale": 1.0,
           "two_sided": False}
    if kind == "diffuse":
        row.update(kd=_coeffs(spec["kd"]), ks=_coeffs([1, 1, 1]),
                   tf=_coeffs([0, 0, 0]), eta=full(1.5), k=full(0.0))
    elif kind == "mirror":
        row.update(kd=_coeffs([0, 0, 0]), ks=_coeffs([1, 1, 1]),
                   tf=_coeffs([0, 0, 0]), roughness=1e-5, roughness_y=1e-5,
                   eta=spectra.table("mirror_eta").copy(),
                   k=spectra.table("mirror_k").copy())
    elif kind == "glass":
        row.update(kd=_coeffs([0, 0, 0]), ks=_coeffs([1, 1, 1]),
                   tf=_coeffs([1, 1, 1]), roughness=1e-5, roughness_y=1e-5,
                   eta=spectra.table("glass_eta").copy(), k=full(0.0))
    else:
        row.update(ke=_coeffs(spec["ke"]),
                   illum=spectra.table(spec.get("illuminant", "D65")),
                   emit_scale=float(spec.get("scale", 1.0)),
                   two_sided=bool(spec.get("two_sided", False)))
    row["eta_const"] = bool(np.all(row["eta"] == row["eta"][0]))
    return row


def tables(rows, device, store) -> dict:
    """The material table of the rows: ``store`` rounds each float table
    as the scene holds it."""
    fl = lambda k: store(torch.as_tensor(np.stack(
        [np.asarray(r[k], np.float64) for r in rows]).astype(np.float32),
        device=device))
    flags = lambda k: torch.as_tensor([r[k] for r in rows], device=device)
    return {"kind": torch.as_tensor([r["kind"] for r in rows],
                                    dtype=torch.int64, device=device),
            "two_sided": flags("two_sided"), "eta_const": flags("eta_const"),
            **{k: fl(k) for k in FLOAT_KEYS}}


# ---------------------------------------------------------------------------
# BSDFs (``eval.py``)

def terminate(lam, do):
    """Zero the trailing hero wavelengths where ``do`` holds."""
    keep = torch.cat([torch.ones_like(lam[..., :1], dtype=torch.bool),
                      (~do[..., None]).expand(lam[..., 1:].shape)], dim=-1)
    return torch.where(keep, lam, 0.0)


def dispersive_mask(m: dict, mat):
    return (m["kind"][mat] == MF_DIELECTRIC) & ~m["eta_const"][mat]


def gather_params(m: dict, kinds: frozenset, mat, lam):
    """Per-ray material parameters at wavelengths ``lam`` (N, 4)."""
    have = lambda *ks: any(k in kinds for k in ks)
    need_mf = have(MF_CONDUCTOR, MF_DIFFUSE, MF_DIELECTRIC)
    need_tf = have(MF_DIELECTRIC)
    kind = m["kind"][mat]
    rough = m["roughness"][mat]
    rough_y = m["roughness_y"][mat]
    zero4 = torch.zeros(kind.shape + (4,), dtype=lam.dtype, device=lam.device)
    spectrum = lambda key: uplift_sample(m[key][mat][..., None, :], lam)
    if need_mf:
        eta4 = dense_rows(m["eta"], mat, lam)
        k4 = dense_rows(m["k"], mat, lam)
    else:
        eta4 = torch.ones_like(zero4)
        k4 = zero4
    mf_delta = (rough + rough_y) / 2.0 < 1e-3
    is_delta = (kind == MF_CONDUCTOR) & mf_delta
    if need_tf:
        is_delta = is_delta | ((kind == MF_DIELECTRIC)
                               & (mf_delta | (eta4[..., 0] == 1.0)))
    return {"kind": kind, "kinds": kinds,
            "alpha": torch.stack([rough, rough_y], dim=-1),
            "mf_delta": mf_delta, "is_delta": is_delta,
            "eta4": eta4, "k4": k4, "eta_const": m["eta_const"][mat],
            "kd": spectrum("kd"),
            "ks": spectrum("ks") if need_mf else zero4,
            "tf": spectrum("tf") if need_tf else zero4}


def _have(mp, *kinds):
    return any(k in mp["kinds"] for k in kinds)


def _refract(eta, wo, no):
    cos = dot(no, wo)
    inside = cos < 0.0
    cos_to = torch.abs(cos)
    eta_ratio = torch.where(inside, 1.0 / eta, eta)
    n = torch.where(inside[..., None], -no, no)
    sin2_ti = (1.0 - cos_to * cos_to) / eta_ratio ** 2
    cos_ti = safe_sqrt(1.0 - torch.clamp(sin2_ti, max=1.0))
    wi = -wo / eta_ratio[..., None] \
        + (cos_to / eta_ratio - cos_ti)[..., None] * n
    valid = ~same_hemisphere(wi, wo) & (sin2_ti < 1.0)
    return wi, valid


def _dielectric_pdf(p_vndf, reflection, die_delta, wh_is_z, whdo, whdi,
                    eta_ratio, pr, pt):
    return torch.where(
        reflection & die_delta, torch.where(wh_is_z, pr, 0.0),
        torch.where(
            reflection,
            p_vndf / torch.clamp(4.0 * torch.abs(whdo), min=_EPS_COS) * pr,
            torch.where(die_delta, torch.where(wh_is_z, pt, 0.0),
                        p_vndf * torch.abs(whdi)
                        / torch.clamp((whdi + whdo / eta_ratio) ** 2,
                                      min=_EPS_COS2) * pt)))


def f(mp, wo_w, wi_w, ng, ns, backface, mode=RADIANCE):
    """BSDF value (N, 4) of the direction pair (``eval.f_pdf``'s)."""
    reflection = dot(ng, wi_w) * dot(ng, wo_w) >= 0.0
    wo = to_local(ns, wo_w)
    wi = to_local(ns, wi_w)
    kind = mp["kind"]
    cos_o = wo[..., 2]
    cos_i = wi[..., 2]
    abs_ci = torch.clamp(torch.abs(cos_i), min=_EPS_COS)
    refl_ok = reflection & ~backface
    out = torch.zeros(wo.shape[:-1] + (4,), dtype=wo.dtype, device=wo.device)
    z_axis = _z_axis(wo)

    if _have(mp, MF_CONDUCTOR, MF_DIFFUSE, MF_DIELECTRIC):
        wh_r = _half(wo + wi)
        d_r = d_ggx(wh_r, mp["alpha"])
        g_r = g_smith(wo, wi, wh_r, mp["alpha"])
        cos_wh_dot = dot(wo, wh_r)
        fr4 = fresnel(cos_wh_dot[..., None], mp["eta4"], mp["k4"])
        denom_r = 4.0 * torch.clamp(torch.abs(cos_o), min=_EPS_COS) * abs_ci
        refl_coeff = (d_r * g_r / denom_r)[..., None] * fr4

    if _have(mp, MF_CONDUCTOR):
        fr_z = fresnel(dot(wo, z_axis)[..., None], mp["eta4"], mp["k4"])
        f_cond = torch.where(mp["mf_delta"][..., None],
                             mp["ks"] * fr_z / abs_ci[..., None],
                             mp["ks"] * refl_coeff)
        sel = kind == MF_CONDUCTOR
        out = torch.where(sel[..., None] & refl_ok[..., None], f_cond, out)

    if _have(mp, MF_DIFFUSE):
        fd = disney_diffuse(mp["alpha"][..., 0], cos_o, cos_i, wh_r[..., 2])
        f_diff = refl_coeff * mp["ks"] \
            + mp["kd"] * (1.0 - fr4) * (fd / PI)[..., None]
        sel = kind == MF_DIFFUSE
        out = torch.where(sel[..., None] & refl_ok[..., None], f_diff, out)

    if _have(mp, MF_DIELECTRIC):
        eta = torch.clamp(mp["eta4"][..., 0], min=_TINY)
        eta_ratio = torch.where(reflection, 1.0,
                                torch.where(cos_o < 0.0, 1.0 / eta, eta))
        die_delta = (mp["eta4"][..., 0] == 1.0) | mp["mf_delta"]
        wh_t = torch.where(die_delta[..., None], z_axis,
                           _half(wi * eta_ratio[..., None] + wo))
        fr_t = fresnel(dot(wo, wh_t)[..., None], mp["eta4"], mp["k4"])
        wh_tp = torch.where(wh_t[..., 2:3] < 0.0, -wh_t, wh_t)
        scale = eta_ratio ** 2 if mode == RADIANCE \
            else torch.ones_like(eta_ratio)
        f_die_refl = torch.where(die_delta[..., None],
                                 mp["ks"] * fr_t / abs_ci[..., None],
                                 mp["ks"] * refl_coeff)
        d_t = d_ggx(wh_tp, mp["alpha"])
        g_t = g_smith(wo, wi, wh_tp, mp["alpha"])
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
        out = torch.where((kind == MF_DIELECTRIC)[..., None], f_die, out)

    return torch.where(torch.isfinite(out), out, 0.0)


def pdf(mp, wo_w, wi_w, ng, ns):
    """Solid-angle pdf of :func:`sample` (``eval.pdf``)."""
    reflection = dot(ng, wi_w) * dot(ng, wo_w) >= 0.0
    wo = to_local(ns, wo_w)
    wi = to_local(ns, wi_w)
    kind = mp["kind"]
    same_hemi = same_hemisphere(wo, wi)
    out = torch.zeros(wo.shape[:-1], dtype=wo.dtype, device=wo.device)

    if _have(mp, MF_DIFFUSE):
        cos_i = wi[..., 2]
        p_cos = torch.where(same_hemi & (cos_i > 0.0), cos_i / PI, 0.0)

    if _have(mp, MF_CONDUCTOR, MF_DIFFUSE):
        wh_r = _half(wo + wi)
        wh_r = torch.where(wh_r[..., 2:3] < 0.0, -wh_r, wh_r)
        p_refl_rough = vndf_pdf(wh_r, wo, mp["alpha"]) \
            / torch.clamp(4.0 * torch.abs(dot(wo, wh_r)), min=_EPS_COS)
        p_refl_delta = torch.where(1.0 - wh_r[..., 2] < DELTA_EPS, 1.0, 0.0)
        p_spec = torch.where(mp["mf_delta"], p_refl_delta, p_refl_rough)

    if _have(mp, MF_CONDUCTOR):
        p_cond = torch.where(same_hemi, p_spec, 0.0)
        out = torch.where((kind == MF_CONDUCTOR) & reflection, p_cond, out)

    if _have(mp, MF_DIFFUSE):
        pr_d = f_schlick(0.04, 1.0, wo[..., 2])
        p_diff = torch.where(same_hemi, pr_d * p_spec + (1.0 - pr_d) * p_cos,
                             0.0)
        out = torch.where((kind == MF_DIFFUSE) & reflection, p_diff, out)

    if _have(mp, MF_DIELECTRIC):
        eta = mp["eta4"][..., 0]
        cos_o = wo[..., 2]
        eta_ratio = torch.where(
            reflection, 1.0,
            torch.where(cos_o < 0.0, 1.0 / torch.clamp(eta, min=_TINY), eta))
        eta_one = eta == 1.0
        die_delta = eta_one | mp["mf_delta"]
        wh = torch.where(eta_one[..., None], _z_axis(wo),
                         _half(wo + wi * eta_ratio[..., None]))
        wh = torch.where(wh[..., 2:3] < 0.0, -wh, wh)
        whdo = dot(wo, wh)
        whdi = dot(wi, wh)
        degenerate = (whdo == 0.0) | (whdi == 0.0)
        backfacing_wh = (whdo * cos_o < 0.0) | (whdi * wi[..., 2] < 0.0)
        pr = fresnel(whdo, torch.clamp(eta, min=_TINY), mp["k4"][..., 0])
        p_die = _dielectric_pdf(
            vndf_pdf(wh, wo, mp["alpha"]), reflection, die_delta,
            1.0 - wh[..., 2] < DELTA_EPS, whdo, whdi, eta_ratio, pr, 1.0 - pr)
        p_die = torch.where(degenerate | backfacing_wh, 0.0, p_die)
        out = torch.where(kind == MF_DIELECTRIC, p_die, out)

    return torch.where(torch.isfinite(out), out, 0.0)


def sample(mp, wo_w, ns, backface, lam, u_lobe, u_sq):
    """A scattering direction: (wi_world, valid, lam_out); ``lam_out``
    has its trailing wavelengths terminated where the dispersive glass
    was sampled."""
    wo = to_local(ns, wo_w)
    kind = mp["kind"]
    z_axis = _z_axis(wo)
    wi_cos = square_to_cos_hemisphere(u_sq)
    wi = wi_cos
    ok = torch.zeros_like(kind, dtype=torch.bool)

    if _have(mp, MF_CONDUCTOR, MF_DIFFUSE, MF_DIELECTRIC):
        wh = sample_vndf(wo, mp["alpha"], u_sq)

    if _have(mp, MF_CONDUCTOR):
        wi_refl, refl_ok = _reflect(wo, wh)
        wi_cond = torch.where(mp["mf_delta"][..., None], reflect_z(wo),
                              wi_refl)
        cond_ok = torch.where(mp["mf_delta"], True, refl_ok)
        sel = kind == MF_CONDUCTOR
        wi = torch.where(sel[..., None], wi_cond, wi)
        ok = torch.where(sel, cond_ok, ok)

    if _have(mp, MF_DIFFUSE):
        pr_d = f_schlick(0.04, 1.0, wo[..., 2])
        pick_spec = u_lobe < pr_d
        wh_d = torch.where(mp["mf_delta"][..., None], z_axis, wh)
        wi_dspec, dspec_ok = _reflect(wo, wh_d)
        wi_diff = torch.where(pick_spec[..., None], wi_dspec, wi_cos)
        diff_ok = torch.where(pick_spec, dspec_ok, True)
        sel = kind == MF_DIFFUSE
        wi = torch.where(sel[..., None], wi_diff, wi)
        ok = torch.where(sel, diff_ok, ok)

    lam_out = lam
    if _have(mp, MF_DIELECTRIC):
        dispersive = (kind == MF_DIELECTRIC) & ~mp["eta_const"]
        lam_out = terminate(lam, dispersive)
        eta_lead = torch.clamp(mp["eta4"][..., 0], min=_TINY)
        die_delta = (mp["eta4"][..., 0] == 1.0) | mp["mf_delta"]
        wh_t = torch.where(die_delta[..., None], z_axis, wh)
        pr = fresnel(dot(wo, wh_t), eta_lead, mp["k4"][..., 0])
        pick_refl = u_lobe < pr
        wi_die_r, die_r_ok = _reflect(wo, wh_t)
        wi_die_t, die_t_ok = _refract(eta_lead, wo, wh_t)
        sel = kind == MF_DIELECTRIC
        wi = torch.where(sel[..., None],
                         torch.where(pick_refl[..., None], wi_die_r,
                                     wi_die_t), wi)
        ok = torch.where(sel, torch.where(pick_refl, die_r_ok, die_t_ok), ok)

    # reflection-only BxDFs cannot sample from the backface; lights end
    ok = ok & ((kind == MF_DIELECTRIC) | ~backface)
    ok = ok & (kind != LIGHT)
    wi_w = to_world(ns, wi)
    return normalize(wi_w, eps=_TINY), ok, lam_out


def shading_cosine(wi_w, ns):
    return torch.abs(dot(ns, wi_w))
