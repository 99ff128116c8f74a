"""BSDF evaluation and sampling for the benchmark's material kinds
(frozen copy of ``lumo_tpu_torch/bsdf/{eval,microfacet}.py``, cut to
Lambertian, microfacet diffuse, GGX conductors and lights).  Every lane
gathers its material row; the families present are evaluated masked and
selected by kind, in the program's order.  Sampled directions are
detached; f and pdf stay differentiable in the float material tables."""
from __future__ import annotations

import torch

from .geometry import (PI, cross, dot, normalize, reflect_z,
                       safe_sqrt, same_hemisphere, square_to_cos_hemisphere,
                       to_local, to_world)
from .spectra import dense_rows, uplift_sample

BLANK, LAMBERTIAN, MF_DIFFUSE, MF_CONDUCTOR, MF_DIELECTRIC, LIGHT = range(6)
SUPPORTED = frozenset((LAMBERTIAN, MF_DIFFUSE, MF_CONDUCTOR, LIGHT))

_TINY = 1e-30
_EPS_COS = 1e-7
DELTA_EPS = 1e-5


# ---------------------------------------------------------------------------
# GGX (``microfacet.py``)

def d_ggx(wh, alpha):
    x, y, z = wh[..., 0], wh[..., 1], wh[..., 2]
    c2 = z * z
    ok = c2 > 1e-12
    c2s = torch.where(ok, c2, 1.0)
    ax = torch.clamp(alpha[..., 0], min=1e-4)
    ay = torch.clamp(alpha[..., 1], min=1e-4)
    u = (x / ax) ** 2 + (y / ay) ** 2
    inv_a = 1.0 / (PI * ax * ay)
    inv_v = 1.0 / (c2s + u)
    return torch.where(ok, inv_a * inv_v * inv_v, 0.0)


def _lambda_ggx(w, alpha):
    x, y, z = w[..., 0], w[..., 1], w[..., 2]
    c2 = z * z
    ok = c2 > 1e-12
    c2s = torch.where(ok, c2, 1.0)
    u = (alpha[..., 0] * x) ** 2 + (alpha[..., 1] * y) ** 2
    zs = safe_sqrt(c2s)
    lam = (safe_sqrt(c2s + u) - zs) / (2.0 * zs)
    return torch.where(ok, lam, 0.0)


def _chi_pass(wo, wh, eps):
    chi = torch.sign(wh[..., 2]) * dot(wo, wh) * wo[..., 2]
    return chi > eps


def g1_smith(wo, wh, alpha, eps=1e-7):
    g = 1.0 / (1.0 + _lambda_ggx(wo, alpha))
    return torch.where(_chi_pass(wo, wh, eps), g, 0.0)


def g_smith(wo, wi, wh, alpha, eps=1e-7):
    g = 1.0 / (1.0 + _lambda_ggx(wo, alpha) + _lambda_ggx(wi, alpha))
    return torch.where(_chi_pass(wo, wh, eps), g, 0.0)


def sample_vndf(wo, alpha, u):
    w_st = normalize(torch.stack([wo[..., 0] * alpha[..., 0],
                                  wo[..., 1] * alpha[..., 1],
                                  wo[..., 2]], dim=-1))
    w_st = torch.where(w_st[..., 2:3] < 0.0, -w_st, w_st)
    degenerate = (1.0 - w_st[..., 2]) < 1e-7
    zaxis = torch.zeros_like(w_st)
    zaxis[..., 2] = 1.0
    xaxis = torch.zeros_like(w_st)
    xaxis[..., 0] = 1.0
    u_b = torch.where(degenerate[..., None], xaxis,
                      normalize(cross(w_st, zaxis), eps=_TINY))
    v_b = cross(u_b, w_st)
    r = safe_sqrt(u[..., 0])
    theta = 2.0 * PI * u[..., 1]
    x = r * torch.cos(theta)
    h = safe_sqrt(1.0 - x * x)
    lerp = (1.0 + w_st[..., 2]) / 2.0
    y = (1.0 - lerp) * h + lerp * r * torch.sin(theta)
    z = safe_sqrt(1.0 - x * x - y * y)
    wm = x[..., None] * u_b + y[..., None] * v_b + z[..., None] * w_st
    wh = torch.stack([alpha[..., 0] * wm[..., 0], alpha[..., 1] * wm[..., 1],
                      torch.clamp(wm[..., 2], min=1e-7)], dim=-1)
    return normalize(wh)


def vndf_pdf(wh, wo, alpha):
    pdf = (g1_smith(wo, wh, alpha) * d_ggx(wh, alpha)
           * torch.abs(dot(wh, wo))
           / torch.clamp(torch.abs(wo[..., 2]), min=_TINY))
    return torch.clamp(pdf, min=0.0)


def fr_real(cos_o_signed, eta):
    inside = cos_o_signed < 0.0
    eta_r = torch.where(inside, 1.0 / eta, eta)
    cos_o = torch.abs(cos_o_signed)
    sin2_o = 1.0 - cos_o * cos_o
    sin2_i = sin2_o / (eta_r * eta_r)
    tir = sin2_i >= 1.0
    cos_i = safe_sqrt(1.0 - torch.clamp(sin2_i, max=1.0))
    r_par = (eta_r * cos_o - cos_i) / torch.clamp(eta_r * cos_o + cos_i,
                                                  min=_TINY)
    r_per = (cos_o - eta_r * cos_i) / torch.clamp(cos_o + eta_r * cos_i,
                                                  min=_TINY)
    return torch.where(tir, 1.0, (r_par ** 2 + r_per ** 2) / 2.0)


def _csqrt(re, im):
    r = safe_sqrt(re * re + im * im)
    a = safe_sqrt((r + re) / 2.0)
    b = torch.sign(im) * safe_sqrt((r - re) / 2.0)
    b = torch.where((im == 0.0) & (re < 0.0), safe_sqrt(-re), b)
    return a, b


def fr_complex(cos_o, eta, k):
    c = torch.clamp(cos_o, 0.0, 1.0)
    sin2_o = 1.0 - c * c
    e2_re = eta * eta - k * k
    e2_im = 2.0 * eta * k
    denom = e2_re * e2_re + e2_im * e2_im
    s_re = sin2_o * e2_re / torch.clamp(denom, min=_TINY)
    s_im = -sin2_o * e2_im / torch.clamp(denom, min=_TINY)
    ci_re, ci_im = _csqrt(1.0 - s_re, -s_im)
    ec_re, ec_im = eta * c, k * c
    num_re, num_im = ec_re - ci_re, ec_im - ci_im
    den_re, den_im = ec_re + ci_re, ec_im + ci_im
    dd = torch.clamp(den_re ** 2 + den_im ** 2, min=_TINY)
    rp_re = (num_re * den_re + num_im * den_im) / dd
    rp_im = (num_im * den_re - num_re * den_im) / dd
    eci_re = eta * ci_re - k * ci_im
    eci_im = eta * ci_im + k * ci_re
    num_re, num_im = c - eci_re, -eci_im
    den_re, den_im = c + eci_re, eci_im
    dd = torch.clamp(den_re ** 2 + den_im ** 2, min=_TINY)
    rs_re = (num_re * den_re + num_im * den_im) / dd
    rs_im = (num_im * den_re - num_re * den_im) / dd
    return ((rp_re ** 2 + rp_im ** 2) + (rs_re ** 2 + rs_im ** 2)) / 2.0


def fresnel(cos_o_signed, eta, k):
    is_cond = k > 0.0
    eta_d = torch.where(is_cond | (eta == 0.0), 1.5, eta)
    f_d = fr_real(cos_o_signed, eta_d)
    eta_c = torch.where(is_cond, eta, 1.0)
    k_c = torch.where(is_cond, k, 1.0)
    f_c = fr_complex(cos_o_signed, eta_c, k_c)
    return torch.where(is_cond, f_c, torch.where(eta == 0.0, 0.0, f_d))


def f_schlick(f0, f90, cos_theta):
    return f0 + (f90 - f0) * (1.0 - cos_theta) ** 5


def disney_diffuse(alpha_x, cos_wo, cos_wi, cos_wh):
    r2 = alpha_x ** 2
    fd90 = 0.5 * r2 + 2.0 * cos_wh ** 2 * r2
    view = f_schlick(1.0, fd90, cos_wo)
    light = f_schlick(1.0, fd90, cos_wi)
    return view * light * (1.0 + r2 * (1.0 / 1.51 - 1.0))


# ---------------------------------------------------------------------------
# the material table's BSDFs (``eval.py``)

def gather_params(m: dict, kinds: frozenset, mat, lam):
    """Per-ray material parameters at wavelengths ``lam`` (N, 4)."""
    need_mf = bool(kinds & {MF_CONDUCTOR, MF_DIFFUSE})
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
    return {
        "kind": kind, "kinds": kinds,
        "alpha": torch.stack([rough, rough_y], dim=-1),
        "mf_delta": mf_delta,
        "is_delta": (kind == MF_CONDUCTOR) & mf_delta,
        "eta4": eta4, "k4": k4,
        "kd": spectrum("kd"),
        "ks": spectrum("ks") if need_mf else zero4,
    }


def _have(mp, *kinds):
    return any(k in mp["kinds"] for k in kinds)


def _z_axis(like):
    z = torch.zeros_like(like)
    z[..., 2] = 1.0
    return z


def _reflect(wo, wh):
    wi = 2.0 * dot(wo, wh)[..., None] * wh - wo
    return wi, same_hemisphere(wi, wo)


def _half(v):
    n2 = dot(v, v)[..., None]
    v2 = torch.where(n2 < 1e-12, _z_axis(v), v)
    return v2 / torch.sqrt(dot(v2, v2))[..., None]


def f_pdf(mp, wo_w, wi_w, ng, ns, backface):
    """(BSDF value (N, 4), pdf (N,)) of the direction pair, radiance
    transport."""
    reflection = dot(ng, wi_w) * dot(ng, wo_w) >= 0.0
    wo = to_local(ns, wo_w)
    wi = to_local(ns, wi_w)
    kind = mp["kind"]
    cos_o = wo[..., 2]
    cos_i = wi[..., 2]
    abs_ci = torch.clamp(torch.abs(cos_i), min=_EPS_COS)
    same_hemi = cos_o * cos_i > 0.0
    refl_ok = reflection & ~backface
    out = torch.zeros(wo.shape[:-1] + (4,), dtype=wo.dtype, device=wo.device)
    p_out = torch.zeros(wo.shape[:-1], dtype=wo.dtype, device=wo.device)
    z_axis = _z_axis(wo)

    if _have(mp, LAMBERTIAN, MF_DIFFUSE):
        f_lam = mp["kd"] / PI
        p_cos = torch.where(same_hemi & (cos_i > 0.0), cos_i / PI, 0.0)

    if _have(mp, MF_CONDUCTOR, MF_DIFFUSE):
        wh_r = _half(wo + wi)
        d_r = d_ggx(wh_r, mp["alpha"])
        g_r = g_smith(wo, wi, wh_r, mp["alpha"])
        cos_wh_dot = dot(wo, wh_r)
        fr4 = fresnel(cos_wh_dot[..., None], mp["eta4"], mp["k4"])
        denom_r = 4.0 * torch.clamp(torch.abs(cos_o), min=_EPS_COS) * abs_ci
        refl_coeff = (d_r * g_r / denom_r)[..., None] * fr4
        wh_ru = torch.where(wh_r[..., 2:3] < 0.0, -wh_r, wh_r)
        p_refl_rough = vndf_pdf(wh_ru, wo, mp["alpha"]) \
            / torch.clamp(4.0 * torch.abs(cos_wh_dot), min=_EPS_COS)
        p_refl_delta = torch.where(1.0 - wh_ru[..., 2] < DELTA_EPS, 1.0, 0.0)

    if _have(mp, MF_CONDUCTOR):
        fr_z = fresnel(dot(wo, z_axis)[..., None], mp["eta4"], mp["k4"])
        f_cond = torch.where(mp["mf_delta"][..., None],
                             mp["ks"] * fr_z / abs_ci[..., None],
                             mp["ks"] * refl_coeff)
        p_cond = torch.where(mp["mf_delta"], p_refl_delta, p_refl_rough)
        p_cond = torch.where(same_hemi, p_cond, 0.0)
        sel = kind == MF_CONDUCTOR
        out = torch.where(sel[..., None] & refl_ok[..., None], f_cond, out)
        p_out = torch.where(sel & reflection, p_cond, p_out)

    if _have(mp, MF_DIFFUSE):
        fd = disney_diffuse(mp["alpha"][..., 0], cos_o, cos_i, wh_r[..., 2])
        f_diff = refl_coeff * mp["ks"] \
            + mp["kd"] * (1.0 - fr4) * (fd / PI)[..., None]
        pr_d = f_schlick(0.04, 1.0, cos_o)
        p_spec = torch.where(mp["mf_delta"], p_refl_delta, p_refl_rough)
        p_diff = pr_d * p_spec + (1.0 - pr_d) * p_cos
        p_diff = torch.where(same_hemi, p_diff, 0.0)
        sel = kind == MF_DIFFUSE
        out = torch.where(sel[..., None] & refl_ok[..., None], f_diff, out)
        p_out = torch.where(sel & reflection, p_diff, p_out)

    if _have(mp, LAMBERTIAN):
        sel = kind == LAMBERTIAN
        out = torch.where(sel[..., None] & refl_ok[..., None], f_lam, out)
        p_out = torch.where(sel & reflection, p_cos, p_out)

    out = torch.where(torch.isfinite(out), out, 0.0)
    p_out = torch.where(torch.isfinite(p_out), p_out, 0.0)
    return out, p_out


def sample(mp, wo_w, ns, backface, u_lobe, u_sq):
    """A scattering direction: (wi_world (detached), valid)."""
    wo = to_local(ns, wo_w)
    kind = mp["kind"]
    z_axis = _z_axis(wo)
    wi_cos = square_to_cos_hemisphere(u_sq)
    wi = wi_cos
    ok = kind == LAMBERTIAN

    if _have(mp, MF_CONDUCTOR, MF_DIFFUSE):
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

    ok = ok & ~backface
    ok = ok & (kind != LIGHT) & (kind != BLANK)
    wi_w = to_world(ns, wi)
    return normalize(wi_w.detach(), eps=_TINY), ok


def shading_cosine(wi_w, ns):
    return torch.abs(dot(ns, wi_w))

