"""Statistical validation of the port's BSDFs (``lumo_tpu_torch.bsdf``),
the counterpart of ``tests/test_bsdf_stats.py`` with its cases, sample
counts and thresholds, on the CPU:

1. chi^2 goodness of fit of ``bsdf.sample`` against ``bsdf.pdf``
   (reference ``src/tracer/bxdf/chi2_tests.rs``): 200,000 sampled
   directions binned 10 x 20 in (theta, phi), expected frequencies by
   composite 2-D Simpson integration of the pdf, low-frequency pooling,
   Pearson chi^2 with the Sidak correction over the whole family;
2. white furnace (``src/tracer/material/white_furnace_tests.rs``): the
   Monte Carlo estimate of the integral of f cos / pdf stays below 1.01
   for every material family, in radiance and importance transport;
3. 1/pdf bin convergence (``src/tracer/bxdf/sampling_tests.rs``).

The draws come from ``torch.Generator``s seeded per case and run (the
JAX suite's ``jax.random`` keys have no counterpart), so the samples are
other ones than the JAX suite's: the same statistics on other draws.
Marked ``slow``, as the JAX suite is (minutes a case).
"""
import zlib

import numpy as np
import pytest
import torch
from scipy.stats import chi2 as chi2_dist

from lumo_tpu_torch.bsdf import eval as bsdf
from lumo_tpu_torch.color import wavelength
from lumo_tpu_torch.config import IMPORTANCE, RADIANCE
from lumo_tpu_torch.sampling import maps
from lumo_tpu_torch.scene.materials import Material, pack_materials

pytestmark = pytest.mark.slow  # statistical, over 60 s a case

THETA_BINS = 10
PHI_BINS = 20
N_SAMPLES = THETA_BINS * PHI_BINS * 1000
CHI2_RUNS = 5
CHI2_SLEVEL = 0.01
CHI2_MIN_FREQ = 5.0
CHI2_TOLERANCE = N_SAMPLES * 1e-5

Z = torch.tensor([0.0, 0.0, 1.0])


def _table(mat):
    return {k: torch.as_tensor(v.astype(np.int64) if v.dtype == np.int32
                               else v)
            for k, v in pack_materials([mat]).items()}


def _generator(*args):
    """A generator seeded by the case and run (``hash()`` is salted per
    process)."""
    return torch.Generator().manual_seed(zlib.crc32(repr(args).encode()))


def _mp(table, lam):
    n = lam.shape[0]
    return bsdf.gather_params(table, torch.zeros(n, dtype=torch.int64), lam,
                              None)


def _lam(g, n):
    return wavelength.sample(torch.rand((), generator=g)).expand(n, 4)


def _sample_dirs(table, wo, g, n):
    lam = _lam(g, n)
    u_lobe = torch.rand(n, generator=g)
    u_sq = torch.rand((n, 2), generator=g)
    wi, ok, _ = bsdf.sample(_mp(table, lam), wo.expand(n, 3), Z.expand(n, 3),
                            torch.zeros(n, dtype=torch.bool), lam, u_lobe,
                            u_sq)
    return wi, ok, lam[0]


def _pdf_grid(table, wo, lam1, nodes_theta, nodes_phi):
    """pdf sin(theta) on a (T, P) grid of directions, float64."""
    th, ph = torch.meshgrid(torch.as_tensor(nodes_theta, dtype=torch.float32),
                            torch.as_tensor(nodes_phi, dtype=torch.float32),
                            indexing="ij")
    th, ph = th.reshape(-1), ph.reshape(-1)
    wi = torch.stack([torch.sin(th) * torch.cos(ph),
                      torch.sin(th) * torch.sin(ph), torch.cos(th)], -1)
    n = wi.shape[0]
    lam = lam1.expand(n, 4)
    ns = Z.expand(n, 3)
    p = bsdf.pdf(_mp(table, lam), wo.expand(n, 3), wi, ns, ns, lam)
    return (p * torch.sin(th)).reshape(len(nodes_theta),
                                       len(nodes_phi)).double().numpy()


def _expected_frequencies(table, wo, lam1):
    """Composite Simpson a bin, all bins at once (192 intervals a bin and
    axis: grazing reflection ridges need about 200 nodes a bin for 5e-4
    absolute accuracy); edge nodes nudged into the bin, so that a
    discontinuity on a bin edge is taken as its one-sided limit."""
    NS = 192
    t_edges = np.linspace(0.0, np.pi, THETA_BINS + 1)
    p_edges = np.linspace(0.0, 2 * np.pi, PHI_BINS + 1)
    ht = (t_edges[1] - t_edges[0]) / NS
    hp = (p_edges[1] - p_edges[0]) / NS
    offs_t = ht * np.arange(NS + 1)
    offs_t[0] += 1e-3 * ht
    offs_t[-1] -= 1e-3 * ht
    offs_p = hp * np.arange(NS + 1)
    offs_p[0] += 1e-3 * hp
    offs_p[-1] -= 1e-3 * hp
    nodes_p = (p_edges[:-1, None] + offs_p[None, :]).ravel()
    w1 = np.ones(NS + 1)
    w1[1:-1:2] = 4.0
    w1[2:-1:2] = 2.0
    wt = w1 * ht / 3.0
    wp = w1 * hp / 3.0
    ig = np.zeros((THETA_BINS, PHI_BINS))
    for t in range(THETA_BINS):     # a theta bin at a time bounds memory
        vals = _pdf_grid(table, wo, lam1, t_edges[t] + offs_t, nodes_p)
        v = vals.reshape(NS + 1, PHI_BINS, NS + 1)
        ig[t] = np.einsum("ipj,i,j->p", v, wt, wp)
    return ig * N_SAMPLES


def _chi2_pass(mat, g) -> bool:
    table = _table(mat)
    wo = maps.square_to_hemisphere(torch.rand((1, 2), generator=g))[0]
    wi, ok, lam1 = _sample_dirs(table, wo, g, N_SAMPLES)
    wi = wi.double().numpy()
    ok = ok.numpy()
    theta = np.arccos(np.clip(wi[:, 2], -1, 1))
    phi = np.arctan2(wi[:, 1], wi[:, 0]) % (2 * np.pi)
    tb = np.clip((theta * THETA_BINS / np.pi).astype(int), 0, THETA_BINS - 1)
    pb = np.clip((phi * PHI_BINS / (2 * np.pi)).astype(int), 0, PHI_BINS - 1)
    actual = np.bincount((tb * PHI_BINS + pb)[ok],
                         minlength=THETA_BINS * PHI_BINS).astype(np.float64)
    expected = _expected_frequencies(table, wo, lam1).ravel()

    # pooling and Pearson's statistic (reference ``chi2_tests.rs:97-172``)
    stat, dof = 0.0, 0
    pooled_a, pooled_e = 0.0, 0.0
    for a, e in zip(actual, expected):
        if e == 0.0:
            if a > CHI2_TOLERANCE:
                return False
        elif e < CHI2_MIN_FREQ or pooled_e < CHI2_MIN_FREQ:
            pooled_a += a
            pooled_e += e
        else:
            stat += (a - e) ** 2 / e
            dof += 1
    if pooled_a + pooled_e > 0:
        stat += (pooled_a - pooled_e) ** 2 / max(pooled_e, 1e-9)
        dof += 1
    dof -= 1
    if dof <= 0:
        return False
    pval = 1.0 - chi2_dist.cdf(stat, dof)
    # Sidak over the whole family (runs x cases), as the JAX suite does
    n_tests = CHI2_RUNS * len(CHI2_CASES)
    alpha = 1.0 - (1.0 - CHI2_SLEVEL) ** (1.0 / n_tests)
    return pval >= alpha


def _mfd(kind, roughness, eta):
    """A microfacet material: ``-beck`` the Beckmann distribution,
    ``-aniso`` anisotropic GGX with alpha_y = 0.35 alpha_x."""
    beck = kind.endswith("-beck")
    aniso = kind.endswith("-aniso")
    base = kind.split("-")[0]
    kw = dict(beckmann=beck,
              roughness_y=(roughness * 0.35 if aniso else None))
    one = (1, 1, 1)
    if base == "diffuse":
        return Material.microfacet(roughness, eta, 0.0, False, False,
                                   one, one, one, **kw)
    if base == "conductor":
        return Material.microfacet(roughness, eta, 0.0, False, True,
                                   one, one, one, **kw)
    return Material.microfacet(roughness, eta, 0.0, True, True, one, one,
                               one, **kw)


CHI2_CASES = [("lambertian", None, None)] + [
    (kind, r, eta)
    for kind in ("diffuse", "conductor")
    for r in (0.75, 0.5, 0.25, 0.1)
    for eta in (1.5,)
] + [
    ("dielectric", r, eta)
    for r in (0.75, 0.5, 0.25, 0.1)
    for eta in (1.5, 2.5)
] + [
    ("conductor-beck", r, 1.5) for r in (0.75, 0.5, 0.25, 0.1)
] + [
    ("diffuse-beck", 0.5, 1.5),
    ("conductor-aniso", 0.5, 1.5),
    ("conductor-aniso", 0.25, 1.5),
]


def _material(kind, rough, eta):
    return (Material.lambertian((1.0, 1.0, 1.0)) if kind == "lambertian"
            else _mfd(kind, rough, eta))


@pytest.mark.parametrize("kind,rough,eta", CHI2_CASES)
def test_chi2(kind, rough, eta):
    mat = _material(kind, rough, eta)
    for run in range(CHI2_RUNS):
        assert _chi2_pass(mat, _generator(kind, rough, eta, run)), \
            f"chi2 failed: {kind} r={rough} eta={eta} run={run}"


# ---------------------------------------------------------------------------
# white furnace

F_RUNS = 8
F_SAMPLES = 16384
MAX_RADIANCE = 1.01


def _furnace(mat, mode, g) -> float:
    n = F_SAMPLES
    table = _table(mat)
    wo = maps.square_to_hemisphere(torch.rand((1, 2), generator=g))[0]
    lam = _lam(g, n)
    ns = ng = Z.expand(n, 3)
    wo_b = wo.expand(n, 3)
    backface = torch.zeros(n, dtype=torch.bool)
    u_lobe = torch.rand(n, generator=g)
    u_sq = torch.rand((n, 2), generator=g)
    wi, ok, lam2 = bsdf.sample(_mp(table, lam), wo_b, ns, backface, lam,
                               u_lobe, u_sq)
    mp2 = _mp(table, lam2)
    f = bsdf.f(mp2, wo_b, wi, ng, ns, backface, lam2, mode)
    p = bsdf.pdf(mp2, wo_b, wi, ng, ns, lam2)
    cos = bsdf.shading_cosine(mp2, wi, ns)
    good = ok & (p > 0.0)
    contrib = torch.where(good[:, None],
                          f * (cos / torch.where(good, p, 1.0))[:, None], 0.0)
    radiance = contrib.sum(0) / torch.clamp(good.sum(), min=1)
    return float(radiance.max())


FURNACE_CASES = (
    [("lambertian", None, None, RADIANCE), ("diffuse", 1.0, 1.5, RADIANCE)]
    + [("conductor", r, 1.5, RADIANCE) for r in (0.75, 0.5, 0.25, 0.1, 0.0)]
    + [("conductor", r, 2.5, RADIANCE) for r in (0.75, 0.25, 0.0)]
    + [("dielectric", r, eta, mode)
       for r in (0.75, 0.5, 0.25, 0.1, 0.0)
       for eta in (1.5, 2.5)
       for mode in (RADIANCE, IMPORTANCE)]
    + [("conductor-beck", r, 1.5, RADIANCE) for r in (0.75, 0.25)]
    + [("conductor-aniso", 0.5, 1.5, RADIANCE)]
)


@pytest.mark.parametrize("kind,rough,eta,mode", FURNACE_CASES)
def test_white_furnace(kind, rough, eta, mode):
    mat = _material(kind, rough, eta)
    for run in range(F_RUNS):
        r = _furnace(mat, mode, _generator(kind, rough, eta, mode, run))
        assert r < MAX_RADIANCE, \
            f"furnace leak: {kind} r={rough} eta={eta} mode={mode}: {r}"


# ---------------------------------------------------------------------------
# 1/pdf bin convergence (reference ``sampling_tests.rs:80-133``)

@pytest.mark.parametrize("kind", ["lambertian", "conductor"])
def test_inv_pdf_bins(kind):
    mat = _material(kind, 0.5, 1.5)
    table = _table(mat)
    n = 400_000
    g = _generator("inv_pdf", kind)
    wo = torch.tensor([0.3, -0.2, 0.93])
    wo = wo / torch.linalg.norm(wo)
    wi, ok, lam1 = _sample_dirs(table, wo, g, n)
    lam = lam1.expand(n, 4)
    ns = Z.expand(n, 3)
    p = bsdf.pdf(_mp(table, lam), wo.expand(n, 3), wi, ns, ns, lam)
    wi = wi.double().numpy()
    p = p.double().numpy()
    ok = ok.numpy() & (p > 0)
    CT_BINS, PH_BINS = 5, 8
    ct = np.clip((wi[:, 2] * CT_BINS).astype(int), 0, CT_BINS - 1)
    phi = np.arctan2(wi[:, 1], wi[:, 0]) % (2 * np.pi)
    pb = np.clip((phi * PH_BINS / (2 * np.pi)).astype(int), 0, PH_BINS - 1)
    acc = np.zeros(CT_BINS * PH_BINS)
    np.add.at(acc, (ct * PH_BINS + pb)[ok], 1.0 / p[ok])
    acc /= n
    bin_area = (1.0 / CT_BINS) * (2 * np.pi / PH_BINS)
    # these BSDFs cover every bin of the upper hemisphere
    np.testing.assert_allclose(acc, bin_area, rtol=0.15)
