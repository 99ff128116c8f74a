"""The port's BSDF parameter gather, sampling and evaluation against the
JAX package's for the kinds of the slice: Lambertian, microfacet diffuse,
rough and delta conductors, and lights (rtol 1e-5).

The delta conductor uses the scene's metal (eta 2.5, k 3.0), not
``Material.mirror``'s measured silver: with k/eta near 160 the complex
square root in ``fr_complex`` cancels ``r - re`` down to the last ulp, so
XLA's and PyTorch's float32 sqrt and multiply-add roundings, each within
an ulp, give Fresnel values 1e-4 apart on a few lanes."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lumo_tpu.bsdf import eval as jbsdf
from lumo_tpu.scene import materials as jmat
from lumo_tpu_torch.bsdf import eval as tbsdf
from lumo_tpu_torch.scene import materials as tmat

RTOL = 1e-5
N = 4096


def _materials(mod):
    M = mod.Material
    return mod.pack_materials([
        M.lambertian((0.7, 0.3, 0.2)),
        M.diffuse((0.2, 0.5, 0.8)),
        M.metal((0.9, 0.7, 0.1), 0.1, 2.5, 3.0),
        M.metal((0.8, 0.8, 0.8), 0.0, 2.5, 3.0),
        M.light((1.0, 0.9, 0.8), scale=4.0),
    ])


def _unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(0)
    mats_j = {k: jnp.asarray(v) for k, v in _materials(jmat).items()}
    mats_t = {k: torch.as_tensor(v.astype(np.int64) if v.dtype == np.int32
                                 else v)
              for k, v in _materials(tmat).items()}
    mat = rng.integers(0, 5, N)
    from lumo_tpu.color import wavelength
    lam = np.array(wavelength.sample(jnp.asarray(
        rng.uniform(0, 1, N).astype(np.float32))))
    ng = _unit(rng.normal(size=(N, 3))).astype(np.float32)
    ns = _unit(ng + 0.2 * rng.normal(size=(N, 3))).astype(np.float32)
    wo = _unit(rng.normal(size=(N, 3))).astype(np.float32)
    wi = _unit(rng.normal(size=(N, 3))).astype(np.float32)
    backface = np.sum(wo * ng, -1) < 0.0
    u_lobe = rng.uniform(0, 1, N).astype(np.float32)
    u_sq = rng.uniform(0, 1, (N, 2)).astype(np.float32)
    uv = np.zeros((N, 2), np.float32)
    mp_j = jbsdf.gather_params(mats_j, jnp.asarray(mat), jnp.asarray(lam),
                               jnp.asarray(uv))
    mp_t = tbsdf.gather_params(mats_t, torch.as_tensor(mat),
                               torch.as_tensor(lam), torch.as_tensor(uv))
    host = dict(mat=mat, lam=lam, ng=ng, ns=ns, wo=wo, wi=wi,
                backface=backface, u_lobe=u_lobe, u_sq=u_sq)
    return mp_j, mp_t, host


def test_gather_params(case):
    mp_j, mp_t, _ = case
    assert mp_t["kinds_present"] == mp_j["kinds_present"]
    for k in ("kind", "mf_delta", "is_delta", "is_specular", "eta_const"):
        np.testing.assert_array_equal(mp_t[k].numpy(), np.asarray(mp_j[k]),
                                      err_msg=k)
    for k in ("alpha", "eta4", "k4", "kd", "ks"):
        np.testing.assert_allclose(mp_t[k].numpy(), np.asarray(mp_j[k]),
                                   rtol=RTOL, atol=1e-7, err_msg=k)


def test_sample(case):
    mp_j, mp_t, h = case
    args = ("wo", "ns", "backface", "lam", "u_lobe", "u_sq")
    wi_j, ok_j, lam_j = jbsdf.sample(mp_j, *(jnp.asarray(h[k]) for k in args))
    wi_t, ok_t, lam_t = tbsdf.sample(mp_t, *(torch.as_tensor(h[k])
                                             for k in args))
    ok_j = np.asarray(ok_j)
    np.testing.assert_array_equal(ok_t.numpy(), ok_j)
    assert ok_j.sum() > N // 4
    np.testing.assert_allclose(wi_t.numpy()[ok_j], np.asarray(wi_j)[ok_j],
                               rtol=RTOL, atol=1e-6)
    np.testing.assert_array_equal(lam_t.numpy(), np.asarray(lam_j))
    # lights scatter nothing
    assert not ok_t.numpy()[h["mat"] == 4].any()


@pytest.mark.parametrize("which", ["random", "sampled"])
def test_f_pdf(case, which):
    mp_j, mp_t, h = case
    if which == "sampled":
        args = ("wo", "ns", "backface", "lam", "u_lobe", "u_sq")
        wi = np.array(jbsdf.sample(mp_j, *(jnp.asarray(h[k])
                                             for k in args))[0])
    else:
        wi = h["wi"]
    f_j, p_j = jbsdf.f_pdf(mp_j, *(jnp.asarray(x) for x in (
        h["wo"], wi, h["ng"], h["ns"], h["backface"], h["lam"])))
    f_t, p_t = tbsdf.f_pdf(mp_t, *(torch.as_tensor(x) for x in (
        h["wo"], wi, h["ng"], h["ns"], h["backface"], h["lam"])))
    f_j, p_j = np.asarray(f_j), np.asarray(p_j)
    assert (p_j > 0).sum() > N // 8
    np.testing.assert_allclose(p_t.numpy(), p_j, rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(f_t.numpy(), f_j, rtol=RTOL, atol=1e-6)
    cos_j = np.asarray(jbsdf.shading_cosine(mp_j, jnp.asarray(wi),
                                            jnp.asarray(h["ns"])))
    cos_t = tbsdf.shading_cosine(mp_t, torch.as_tensor(wi),
                                 torch.as_tensor(h["ns"])).numpy()
    np.testing.assert_allclose(cos_t, cos_j, rtol=RTOL, atol=1e-7)


def test_dispersive_mask_is_empty_for_ported_kinds(case):
    """No kind of this table (slice 1's) is a dispersive dielectric."""
    _, mp_t, h = case
    mats_t = {k: torch.as_tensor(v) for k, v in _materials(tmat).items()}
    mask = tbsdf.dispersive_mask(mats_t, torch.as_tensor(h["mat"]))
    assert not bool(mask.any())


def test_unported_kinds_raise():
    """Glass gathers (slice 5) and matches the JAX package; IMPORTANCE
    transport, which waits for the bidirectional integrator, raises with
    its ROADMAP item."""
    from lumo_tpu_torch.config import IMPORTANCE
    mats = {k: torch.as_tensor(v) for k, v in tmat.pack_materials(
        [tmat.Material.glass()]).items()}
    mats_j = {k: jnp.asarray(v) for k, v in jmat.pack_materials(
        [jmat.Material.glass()]).items()}
    lam = np.linspace(380.0, 700.0, 16, dtype=np.float32).reshape(4, 4)
    mp = tbsdf.gather_params(mats, torch.zeros(4, dtype=torch.int64),
                             torch.as_tensor(lam), None)
    mp_j = jbsdf.gather_params(mats_j, jnp.zeros(4, jnp.int32),
                               jnp.asarray(lam), None)
    assert mp["kinds_present"] == mp_j["kinds_present"]
    for k in ("kind", "is_delta", "eta_const"):
        np.testing.assert_array_equal(mp[k].numpy(), np.asarray(mp_j[k]))
    for k in ("eta4", "ks", "tf"):
        np.testing.assert_allclose(mp[k].numpy(), np.asarray(mp_j[k]),
                                   rtol=RTOL, err_msg=k)
    assert bool(mp["is_delta"].all()) and not bool(mp["eta_const"].any())
    w = torch.tensor([[0.0, 0.6, 0.8]] * 4)
    n = torch.tensor([[0.0, 0.0, 1.0]] * 4)
    with pytest.raises(NotImplementedError, match="item 8\\)"):
        tbsdf.f_pdf(mp, w, -w, n, n, torch.zeros(4, dtype=torch.bool),
                    torch.as_tensor(lam), mode=IMPORTANCE)
