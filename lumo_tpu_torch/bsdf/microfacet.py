"""Microfacet distributions (GGX and Beckmann): NDF, Smith
shadow-masking, normal sampling, exact dielectric and complex-conductor
Fresnel, Disney diffuse.

Counterpart of ``lumo_tpu/bsdf/microfacet.py`` (reference
``microfacet.rs``).  All functions map (N, ...) wavefronts in shading
space (z-up); complex arithmetic is explicit real/imaginary pairs.  The
distribution dispatchers take ``beck``: a per-lane bool tensor (both
families evaluated, selected by ``torch.where``) or a Python bool when
the material table holds one family only.
"""
from __future__ import annotations

import math

import torch

from lumo_tpu_torch.geometry import onb
from lumo_tpu_torch.geometry.onb import cross, dot, normalize, safe_sqrt

PI = math.pi
_TINY = 1e-30


def d_ggx(wh, alpha):
    """Anisotropic GGX NDF in the fully reduced form
    D = 1/(pi ax ay (cos^2 + x^2/ax^2 + y^2/ay^2)^2)
    (reference ``microfacet.rs:173-196``)."""
    x, y, z = wh[..., 0], wh[..., 1], wh[..., 2]
    c2 = z * z
    ok = c2 > 1e-12
    c2s = torch.where(ok, c2, 1.0)
    ax = torch.clamp(alpha[..., 0], min=1e-4)
    ay = torch.clamp(alpha[..., 1], min=1e-4)
    u = (x / ax) ** 2 + (y / ay) ** 2
    inv_a = 1.0 / (PI * ax * ay)
    inv_v = 1.0 / (c2s + u)
    d = inv_a * inv_v * inv_v
    return torch.where(ok, d, 0.0)


def _lambda_ggx(w, alpha):
    """Smith Lambda for GGX in the cap-free reduced form
    (reference ``microfacet.rs:324-340``)."""
    x, y, z = w[..., 0], w[..., 1], w[..., 2]
    c2 = z * z
    ok = c2 > 1e-12
    c2s = torch.where(ok, c2, 1.0)
    u = (alpha[..., 0] * x) ** 2 + (alpha[..., 1] * y) ** 2
    zs = safe_sqrt(c2s)
    lam = (safe_sqrt(c2s + u) - zs) / (2.0 * zs)
    return torch.where(ok, lam, 0.0)


def _chi_pass(wo, wh, eps):
    """chi+ visibility test (reference ``microfacet.rs:285-291``)."""
    chi = torch.sign(onb.cos_theta(wh)) * dot(wo, wh) * onb.cos_theta(wo)
    return chi > eps


def g1_smith(wo, wh, alpha, eps=1e-7):
    g = 1.0 / (1.0 + _lambda_ggx(wo, alpha))
    return torch.where(_chi_pass(wo, wh, eps), g, 0.0)


def g_smith(wo, wi, wh, alpha, eps=1e-7):
    g = 1.0 / (1.0 + _lambda_ggx(wo, alpha) + _lambda_ggx(wi, alpha))
    return torch.where(_chi_pass(wo, wh, eps), g, 0.0)


def sample_vndf(wo, alpha, u):
    """Heitz 2018 visible-NDF sampling of GGX normals
    (reference ``microfacet.rs:384-433``).  wo (N, 3); u (N, 2)."""
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
    wh = torch.stack([alpha[..., 0] * wm[..., 0],
                      alpha[..., 1] * wm[..., 1],
                      torch.clamp(wm[..., 2], min=1e-7)], dim=-1)
    return normalize(wh)


def vndf_pdf(wh, wo, alpha):
    """PDF of :func:`sample_vndf` (reference ``microfacet.rs:361-380``)."""
    pdf = (g1_smith(wo, wh, alpha) * d_ggx(wh, alpha)
           * torch.abs(dot(wh, wo))
           / torch.clamp(torch.abs(onb.cos_theta(wo)), min=_TINY))
    return torch.clamp(pdf, min=0.0)


# ---------------------------------------------------------------------------
# Beckmann (reference ``microfacet.rs:48-49,198-211,341-357,434-445``)

def d_beckmann(wh, alpha):
    """Anisotropic Beckmann NDF (PBR 8.4.2):
    exp(-tan^2 (cos^2 phi/ax^2 + sin^2 phi/ay^2)) / (pi ax ay cos^4)."""
    x, y, z = wh[..., 0], wh[..., 1], wh[..., 2]
    c2 = z * z
    ok = c2 > 1e-12
    c2s = torch.where(ok, c2, 1.0)
    u = (x / alpha[..., 0]) ** 2 + (y / alpha[..., 1]) ** 2
    big = u > 80.0 * c2s           # exp(-80) is 0 in float32 anyway
    e = torch.where(big, 80.0, u / torch.where(big, 1.0, c2s))
    inv_a = 1.0 / (PI * alpha[..., 0] * alpha[..., 1])
    inv_c = 1.0 / c2s
    d = torch.exp(-e) * inv_a * inv_c * inv_c
    return torch.where(ok, d, 0.0)


def _lambda_beckmann(w, alpha):
    """Smith Lambda for Beckmann, PBR's rational approximation with
    a = 1/(alpha_eff tan), as ``lumo_tpu`` computes it (tan, where the
    reference's ``microfacet.rs:347`` has tan^2)."""
    x, y, z = w[..., 0], w[..., 1], w[..., 2]
    c2 = z * z
    okz = c2 > 1e-12
    c2s = torch.where(okz, c2, 1.0)
    u_at = (alpha[..., 0] * x) ** 2 + (alpha[..., 1] * y) ** 2
    big_at = u_at > 1e12 * c2s
    at = safe_sqrt(torch.where(big_at, 1e12,
                               u_at / torch.where(big_at, 1.0, c2s)))
    abs_tan = safe_sqrt(torch.clamp((x * x + y * y) / c2s, max=1e12))
    a = 1.0 / torch.clamp(at, min=_TINY)
    # the masked a >= 1.6 branch must not evaluate the rational at a ~ 1e30
    big = a >= 1.6
    a_s = torch.where(big, 1.0, a)
    lam = torch.where(big, 0.0,
                      (1.0 - 1.259 * a_s + 0.396 * a_s * a_s)
                      / torch.clamp(3.535 * a_s + 2.181 * a_s * a_s,
                                    min=_TINY))
    return torch.where(okz & (abs_tan > 0.0), lam, 0.0)


def sample_beckmann(alpha, u):
    """A Beckmann-distributed normal (full-NDF sampling, anisotropic per
    PBR 8.4.3); its pdf is D(wh) cos(theta_h)."""
    phi_iso = 2.0 * PI * u[..., 1]
    phi = torch.atan(alpha[..., 1] / alpha[..., 0]
                     * torch.tan(phi_iso + 0.5 * PI))
    phi = phi + torch.where(u[..., 1] > 0.5, PI, 0.0)
    cp, sp = torch.cos(phi), torch.sin(phi)
    log_u = torch.log(torch.clamp(1.0 - u[..., 0], min=1e-30))
    tan2 = -log_u / torch.clamp((cp / alpha[..., 0]) ** 2
                                + (sp / alpha[..., 1]) ** 2, min=_TINY)
    cos_t = 1.0 / safe_sqrt(1.0 + tan2)
    sin_t = safe_sqrt(1.0 - cos_t * cos_t)
    return torch.stack([sin_t * cp, sin_t * sp, cos_t], dim=-1)


def beckmann_pdf(wh, alpha):
    """PDF of :func:`sample_beckmann` (``microfacet.rs:367-370``)."""
    return torch.clamp(d_beckmann(wh, alpha) * onb.cos_theta(wh), min=0.0)


# ---------------------------------------------------------------------------
# distribution dispatch over {GGX, Beckmann} (``microfacet.rs:140``)

def d_dist(wh, alpha, beck):
    if isinstance(beck, bool):
        return d_beckmann(wh, alpha) if beck else d_ggx(wh, alpha)
    return torch.where(beck, d_beckmann(wh, alpha), d_ggx(wh, alpha))


def g_smith_dist(wo, wi, wh, alpha, beck, eps=1e-7):
    if isinstance(beck, bool):
        lam_f = _lambda_beckmann if beck else _lambda_ggx
        lam_o, lam_i = lam_f(wo, alpha), lam_f(wi, alpha)
    else:
        lam_o = torch.where(beck, _lambda_beckmann(wo, alpha),
                            _lambda_ggx(wo, alpha))
        lam_i = torch.where(beck, _lambda_beckmann(wi, alpha),
                            _lambda_ggx(wi, alpha))
    g = 1.0 / (1.0 + lam_o + lam_i)
    return torch.where(_chi_pass(wo, wh, eps), g, 0.0)


def normal_pdf(wh, wo, alpha, beck):
    """PDF of :func:`sample_normal_dist` over half vectors: the VNDF for
    GGX, D cos(theta) for Beckmann (``microfacet.rs:361-380``)."""
    if isinstance(beck, bool):
        return beckmann_pdf(wh, alpha) if beck else vndf_pdf(wh, wo, alpha)
    return torch.where(beck, beckmann_pdf(wh, alpha),
                       vndf_pdf(wh, wo, alpha))


def sample_normal_dist(wo, alpha, u, beck):
    if isinstance(beck, bool):
        return sample_beckmann(alpha, u) if beck else sample_vndf(wo, alpha,
                                                                  u)
    return torch.where(beck[..., None], sample_beckmann(alpha, u),
                       sample_vndf(wo, alpha, u))


# ---------------------------------------------------------------------------
# Fresnel

def fr_real(cos_o_signed, eta):
    """Exact real dielectric Fresnel with TIR (reference
    ``microfacet.rs:262-282``)."""
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
    f = (r_par ** 2 + r_per ** 2) / 2.0
    return torch.where(tir, 1.0, f)


def _csqrt(re, im):
    """Principal complex sqrt from real/imaginary parts."""
    r = safe_sqrt(re * re + im * im)
    a = safe_sqrt((r + re) / 2.0)
    b = torch.sign(im) * safe_sqrt((r - re) / 2.0)
    b = torch.where((im == 0.0) & (re < 0.0), safe_sqrt(-re), b)
    return a, b


def fr_complex(cos_o, eta, k):
    """Exact conductor Fresnel with complex IOR eta + i k
    (reference ``microfacet.rs:246-259``)."""
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
    """Conductor when k > 0, dielectric otherwise, 0 when eta == 0
    (reference ``microfacet.rs:231-243``); args (..., 4)."""
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
    """Burley 2012 diffuse with Frostbite renormalization
    (reference ``microfacet.rs:147-163``)."""
    r2 = alpha_x ** 2
    energy_bias = 0.5 * r2
    fd90 = energy_bias + 2.0 * cos_wh ** 2 * r2
    view = f_schlick(1.0, fd90, cos_wo)
    light = f_schlick(1.0, fd90, cos_wi)
    energy_factor = 1.0 + r2 * (1.0 / 1.51 - 1.0)
    return view * light * energy_factor
