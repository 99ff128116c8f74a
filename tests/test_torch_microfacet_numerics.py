"""The GGX numerics of ``tests/test_microfacet_numerics.py`` on the port's
BSDF (``lumo_tpu_torch.bsdf``), with that file's bounds.

A cap on the exponent ``e = tan^2(theta) ...`` in ``d_ggx`` once
inflated D about 300 times for horizon-grazing half-vectors, so the
declared transmission pdf of rough dispersive glass spiked just below the
horizon while the sampler's density stayed right.  Measured on the port
(CPU): ``d_ggx`` within rtol 2e-3 of the float64 textbook formula for all
four alpha pairs; Lambda's worst relative error 5.1e-5 at z = 1e-2 (bound
1e-3); the pdf at the spiking node 2.33 (bound 10); the whole-sphere
integral of the pdf 0.980 (bounds 0.5 to 1.02).
"""
import math

import numpy as np
import torch

from lumo_tpu_torch.bsdf import eval as bsdf
from lumo_tpu_torch.bsdf import microfacet as mf
from lumo_tpu_torch.scene.materials import Material, pack_materials


def _d_ggx_reference(wh, ax, ay):
    """Textbook anisotropic GGX in float64 (no reductions)."""
    x, y, z = wh
    c2 = z * z
    if c2 <= 1e-12:
        return 0.0
    t2 = (x * x + y * y) / c2
    if t2 == 0.0:
        return 1.0 / (math.pi * ax * ay * c2 * c2)
    phi_cos2 = x * x / (x * x + y * y)
    phi_sin2 = y * y / (x * x + y * y)
    e = t2 * (phi_cos2 / (ax * ax) + phi_sin2 / (ay * ay))
    return 1.0 / (math.pi * ax * ay * c2 * c2 * (1.0 + e) ** 2)


def _table(mat):
    return {k: torch.as_tensor(v.astype(np.int64) if v.dtype == np.int32
                               else v)
            for k, v in pack_materials([mat]).items()}


def test_d_ggx_matches_reference_incl_horizon():
    rng = np.random.default_rng(0)
    # horizon-grazing normals (the failure lived at wh_z ~ 1e-5) and
    # near-pole ones
    zs = np.concatenate([rng.uniform(-1, 1, 200),
                         rng.uniform(1e-6, 1e-4, 50),
                         1.0 - rng.uniform(0, 1e-6, 20)])
    phi = rng.uniform(0, 2 * np.pi, zs.shape[0])
    s = np.sqrt(np.maximum(1 - zs ** 2, 0))
    wh = np.stack([s * np.cos(phi), s * np.sin(phi), zs], -1)
    for ax, ay in [(0.5, 0.5), (0.1, 0.1), (0.5, 0.175), (1.0, 1.0)]:
        alpha = torch.tensor([ax, ay], dtype=torch.float32).expand(
            wh.shape[0], 2)
        got = mf.d_ggx(torch.as_tensor(wh, dtype=torch.float32),
                       alpha).numpy()
        want = np.array([_d_ggx_reference(w, ax, ay) for w in wh])
        np.testing.assert_allclose(got, want, rtol=2e-3, atol=1e-8)


def test_lambda_ggx_grazing_not_capped():
    # Lambda keeps growing as tan(theta) at super-grazing angles (below
    # z = 1e-6 the deliberate c^2 > 1e-12 in-plane cutoff applies, so the
    # probes stay above it)
    for z in (1e-5, 1e-4, 1e-2):
        w = torch.tensor([[math.sqrt(1 - z * z), 0.0, z]], dtype=torch.float32)
        alpha = torch.tensor([[0.5, 0.5]], dtype=torch.float32)
        lam = float(mf._lambda_ggx(w, alpha)[0])
        expect = (math.sqrt(1 + (0.5 / z) ** 2) - 1) / 2
        assert abs(lam - expect) / expect < 1e-3, (z, lam, expect)


def test_dielectric_pdf_no_horizon_spike():
    """The configuration of the failing chi^2 run: the pdf at the spiking
    Simpson node is O(1), and the pdf integrates over the sphere to about
    1 or less (it reached 2.9 with the capped D)."""
    table = _table(Material.microfacet(0.5, 1.5, 0.0, True, True,
                                       (1, 1, 1), (1, 1, 1), (1, 1, 1)))
    wo = np.array([-0.74211484, 0.6563626, 0.13584471], np.float32)
    wo /= np.linalg.norm(wo)
    wo = torch.as_tensor(wo)
    lam1 = torch.tensor([580.66595, 674.65533, 438.23383, 515.72894])
    Z = torch.tensor([0.0, 0.0, 1.0])

    th = math.radians(95.34375)
    ph = 5.558328252210691
    wi = torch.tensor([math.sin(th) * math.cos(ph),
                       math.sin(th) * math.sin(ph), math.cos(th)])
    mp = bsdf.gather_params(table, torch.zeros(1, dtype=torch.int64),
                            lam1[None], None)
    p = float(bsdf.pdf(mp, wo[None], wi[None], Z[None], Z[None],
                       lam1[None])[0])
    assert p < 10.0, f"horizon spike back: pdf={p}"

    # whole-sphere integral by the midpoint rule on a uniform grid
    M = 256
    ths = (np.arange(M) + 0.5) * math.pi / M
    phs = (np.arange(2 * M) + 0.5) * 2 * math.pi / (2 * M)
    T, P = np.meshgrid(ths, phs, indexing="ij")
    wis = np.stack([np.sin(T) * np.cos(P), np.sin(T) * np.sin(P),
                    np.cos(T)], -1).reshape(-1, 3).astype(np.float32)
    n = wis.shape[0]
    lam = lam1.expand(n, 4)
    mp_n = bsdf.gather_params(table, torch.zeros(n, dtype=torch.int64), lam,
                              None)
    ns = Z.expand(n, 3)
    pv = bsdf.pdf(mp_n, wo.expand(n, 3), torch.as_tensor(wis), ns, ns,
                  lam).numpy()
    integral = float((pv.reshape(M, 2 * M) * np.sin(ths)[:, None]).sum()
                     * (math.pi / M) * (2 * math.pi / (2 * M)))
    assert integral < 1.02, f"pdf integrates to {integral}"
    assert integral > 0.5, f"pdf integrates to {integral}"
