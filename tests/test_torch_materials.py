"""The port's BSDF for the kinds of slice 5 against the JAX package's:
smooth and rough dielectrics (the dispersive glass table and a constant
eta), eta 1 (a delta pass-through), rough dielectrics and conductors and
an anisotropic microfacet diffuse on the Beckmann distribution, two
Henyey-Greenstein media, and kd/tf from textures, through
``gather_params``, ``sample``, ``f_pdf``, ``pdf`` and ``shading_cosine``
(rtol 1e-5, atol 1e-6 on every lane; 1e-4 for the BSDF values of the
marble-textured glass, whose (0.5 + 0.5 sin(60 u + 20 turb))^6 turns an
ulp of the sine's argument into some 1e-5 of the value), under RADIANCE
and IMPORTANCE transport; the BDPT's shading correction of importance
transport too."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import t
from lumo_tpu import texture as jtex
from lumo_tpu.bsdf import eval as jbsdf
from lumo_tpu.color import wavelength as jwl
from lumo_tpu.scene import materials as jmat
from lumo_tpu_torch import texture as ttex
from lumo_tpu_torch.bsdf import eval as tbsdf
from lumo_tpu_torch.config import IMPORTANCE, RADIANCE
from lumo_tpu_torch.integrators import bdpt as tbdpt
from lumo_tpu_torch.scene import materials as tmat

RTOL, ATOL = 1e-5, 1e-6
N = 4096


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tables(mod, texmod):
    M = mod.Material
    tex = texmod.Textures()
    checker = tex.checkerboard((0.9, 0.2, 0.1), (0.1, 0.3, 0.9), 5.0)
    marble = tex.marble((0.8, 0.9, 1.0))
    mats = [
        M.glass(),                                            # 0 dispersive
        M.transparent((0.9, 0.6, 0.9), 0.3, 1.5),             # 1 rough disp.
        M.transparent((0.8, 0.9, 1.0), 0.2, 1.33),            # 2 const eta
        M.microfacet(0.3, 2.5, 3.0, False, True, [1, 1, 1],
                     [0.9, 0.7, 0.2], [0, 0, 0], beckmann=True),   # 3
        M.microfacet(0.25, 1.4, 0.0, True, True, [0, 0, 0], [1, 1, 1],
                     [0.9, 0.9, 0.9], beckmann=True),         # 4
        M.volumetric(0.7, 0.5, (0.3, 0.35, 0.4), (0.2, 0.2, 0.25)),  # 5
        M.volumetric(0.0, 0.8, (0.5, 0.5, 0.5), (0.4, 0.4, 0.4)),    # 6
        M.diffuse((1.0, 1.0, 1.0), kd_tex=checker),           # 7
        M.transparent((1.0, 1.0, 1.0), 0.1, 1.33, tf_tex=marble),    # 8
        M.transparent((0.9, 0.9, 0.9), 0.2, 1.0),             # 9 eta 1
        M.microfacet(0.3, 1.5, 0.0, False, False, [0.6, 0.5, 0.4],
                     [1, 1, 1], [0, 0, 0], roughness_y=0.1,
                     beckmann=True),                          # 10
        M.lambertian((0.7, 0.3, 0.2)),                        # 11
    ]
    return mod.pack_materials(mats), tex.pack()


def _unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(4)
    mats_np, tex_np = _tables(jmat, jtex)
    mats_t_np, tex_t_np = _tables(tmat, ttex)
    mats_j = {k: jnp.asarray(v) for k, v in mats_np.items()}
    tex_j = {k: jnp.asarray(v) for k, v in tex_np.items()}
    conv = lambda v: t(v.astype(np.int64) if v.dtype == np.int32 else v)
    mats_t = {k: conv(v) for k, v in mats_t_np.items()}
    tex_t = {k: conv(v) for k, v in tex_t_np.items()}
    for k in mats_np:
        np.testing.assert_array_equal(mats_t_np[k], mats_np[k], err_msg=k)
    mat = rng.integers(0, len(mats_np["kind"]), N)
    lam = np.asarray(jwl.sample(jnp.asarray(
        rng.uniform(0, 1, N).astype(np.float32))))
    ng = _unit(rng.normal(size=(N, 3))).astype(np.float32)
    ns = _unit(ng + 0.2 * rng.normal(size=(N, 3))).astype(np.float32)
    wo = _unit(rng.normal(size=(N, 3))).astype(np.float32)
    wi = _unit(rng.normal(size=(N, 3))).astype(np.float32)
    host = dict(mat=mat, lam=lam, ng=ng, ns=ns, wo=wo, wi=wi,
                backface=np.sum(wo * ng, -1) < 0.0,
                u_lobe=rng.uniform(0, 1, N).astype(np.float32),
                u_sq=rng.uniform(0, 1, (N, 2)).astype(np.float32),
                uv=rng.uniform(0, 1, (N, 2)).astype(np.float32),
                t=rng.uniform(0.01, 3.0, N).astype(np.float32))
    kinds = tuple(sorted(set(tex_np["kind"].tolist())))
    mp_j = jbsdf.gather_params(mats_j, jnp.asarray(mat), jnp.asarray(lam),
                               jnp.asarray(host["uv"]), tex_j, kinds,
                               t=jnp.asarray(host["t"]))
    mp_t = tbsdf.gather_params(mats_t, t(mat), t(lam), t(host["uv"]),
                               tex_t, kinds, t=t(host["t"]))
    return mp_j, mp_t, host


def _args(h, keys):
    return ([jnp.asarray(h[k]) for k in keys], [t(h[k]) for k in keys])


def _sampled_wi(mp_j, h):
    a_j, _ = _args(h, ("wo", "ns", "backface", "lam", "u_lobe", "u_sq"))
    return np.array(jbsdf.sample(mp_j, *a_j)[0])


def test_gather_params(case):
    mp_j, mp_t, _ = case
    assert mp_t["kinds_present"] == mp_j["kinds_present"]
    assert isinstance(mp_t["mf_beck"], torch.Tensor)
    for k in ("kind", "mf_beck", "mf_delta", "is_delta", "is_specular",
              "eta_const"):
        np.testing.assert_array_equal(mp_t[k].numpy(), np.asarray(mp_j[k]),
                                      err_msg=k)
    for k in ("alpha", "eta4", "k4", "kd", "ks", "tf", "hg_g", "sigma_t4",
              "sigma_s4", "t_scaled"):
        np.testing.assert_allclose(mp_t[k].numpy(), np.asarray(mp_j[k]),
                                   rtol=RTOL, atol=1e-7, err_msg=k)


def test_sample(case):
    mp_j, mp_t, h = case
    a_j, a_t = _args(h, ("wo", "ns", "backface", "lam", "u_lobe", "u_sq"))
    wi_j, ok_j, lam_j = jbsdf.sample(mp_j, *a_j)
    wi_t, ok_t, lam_t = tbsdf.sample(mp_t, *a_t)
    ok_j = np.asarray(ok_j)
    np.testing.assert_array_equal(ok_t.numpy(), ok_j)
    assert ok_j.sum() > N // 2
    np.testing.assert_allclose(wi_t.numpy()[ok_j], np.asarray(wi_j)[ok_j],
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(lam_t.numpy(), np.asarray(lam_j))
    # the dispersive glass terminates its lanes' trailing wavelengths
    disp = np.isin(h["mat"], (0, 1))
    assert (lam_t.numpy()[disp][:, 1:] == 0.0).all()
    assert (lam_t.numpy()[~disp] == h["lam"][~disp]).all()
    # transmission happens: some sampled directions cross the surface
    die = np.isin(h["mat"], (0, 1, 2, 4)) & ok_j
    crossed = (np.sum(wi_t.numpy() * h["ng"], -1)
               * np.sum(h["wo"] * h["ng"], -1)) < 0
    assert crossed[die].mean() > 0.2


@pytest.mark.parametrize("which,mode", [
    ("random", RADIANCE), ("sampled", RADIANCE), ("random", IMPORTANCE),
    ("sampled", IMPORTANCE)],
    ids=["random", "sampled", "random-importance", "sampled-importance"])
def test_f_pdf_and_pdf(case, which, mode):
    mp_j, mp_t, h = case
    wi = h["wi"] if which == "random" else _sampled_wi(mp_j, h)
    hh = dict(h, wi=wi)
    a_j, a_t = _args(hh, ("wo", "wi", "ng", "ns", "backface", "lam"))
    f_j, p_j = (np.asarray(x) for x in jbsdf.f_pdf(mp_j, *a_j, mode))
    f_t, p_t = tbsdf.f_pdf(mp_t, *a_t, mode)
    assert (p_j > 0).sum() > N // 4
    np.testing.assert_allclose(p_t.numpy(), p_j, rtol=RTOL, atol=ATOL)
    marble = h["mat"] == 8
    for sel, rtol in ((~marble, RTOL), (marble, 1e-4)):
        np.testing.assert_allclose(f_t.numpy()[sel], f_j[sel], rtol=rtol,
                                   atol=ATOL)
    assert torch.equal(tbsdf.f(mp_t, *a_t, mode), f_t)
    b_j, b_t = _args(hh, ("wo", "wi", "ng", "ns", "lam"))
    pdf_j = np.asarray(jbsdf.pdf(mp_j, *b_j))
    np.testing.assert_allclose(tbsdf.pdf(mp_t, *b_t).numpy(), pdf_j,
                               rtol=RTOL, atol=ATOL)
    cos_j = np.asarray(jbsdf.shading_cosine(mp_j, jnp.asarray(wi),
                                            jnp.asarray(h["ns"])))
    cos_t = tbsdf.shading_cosine(mp_t, t(wi), t(h["ns"])).numpy()
    np.testing.assert_allclose(cos_t, cos_j, rtol=RTOL, atol=1e-7)
    assert (cos_t[np.isin(h["mat"], (5, 6))] == 1.0).all()


def test_importance_transport_raises(case):
    """IMPORTANCE transport, once a raise, differs from RADIANCE exactly
    where a dielectric refracts: radiance carries the eta_ratio^2 scale,
    importance does not (``lumo_tpu/bsdf/eval.py:296``); the pdfs are the
    same.  The BDPT's shading correction (``bdpt._shading_correction``)
    matches the JAX package's."""
    from lumo_tpu.integrators import bdpt as jbdpt
    mp_j, mp_t, h = case
    wi = _sampled_wi(mp_j, h)
    _, a_t = _args(dict(h, wi=wi), ("wo", "wi", "ng", "ns", "backface",
                                    "lam"))
    f_r, p_r = tbsdf.f_pdf(mp_t, *a_t, mode=RADIANCE)
    f_i, p_i = tbsdf.f_pdf(mp_t, *a_t, mode=IMPORTANCE)
    assert torch.equal(p_r, p_i)
    refract = (np.sum(wi * h["ng"], -1) * np.sum(h["wo"] * h["ng"], -1)) < 0
    die = np.isin(h["mat"], (0, 1, 2, 4, 8))
    differs = (f_r != f_i).any(-1).numpy()
    assert not differs[~(refract & die)].any()
    assert differs[refract & die].mean() > 0.5
    v_j = {k: jnp.asarray(h[k]) for k in ("wo", "ng", "ns")}
    v_t = {k: t(h[k]) for k in ("wo", "ng", "ns")}
    c_j = np.asarray(jbdpt._shading_correction(mp_j, v_j, jnp.asarray(wi)))
    c_t = tbdpt._shading_correction(mp_t, v_t, t(wi)).numpy()
    np.testing.assert_allclose(c_t, c_j, rtol=RTOL, atol=ATOL)
    assert (np.abs(c_j - 1.0) > 1e-3).mean() > 0.1
