"""The bidirectional integrator's parts against the JAX package's: light
sampling for the subpath roots (``trace.sample_on``, ``sample_leaving``,
``sample_leaving_pdf`` on triangle, sphere and disk lights), both
subpaths on the Cornell box, the MIS weights summing to one over every
strategy of a path (the reference's six variants, ``mis_tests.rs``), the
renderer's automatic depth, and the gradient of the emission through the
whole estimator.

Subpaths: the same numpy-seeded camera rays, wavelengths and counter
states go through both packages, the JAX package op by op
(``jax.disable_jit``): jitted, XLA's fused rounding moves a few vertices
across an edge.  ``valid``, ``delta``, ``light`` and ``mat`` are equal;
positions, throughputs and pdfs agree within rtol 1e-4 (atol 1e-3 on
positions in the Cornell box's millimetres, 1e-6 elsewhere) on valid
vertices.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import port_scene_from_jax, t
from lumo_tpu import camera as jcam
from lumo_tpu.color import wavelength as jwl
from lumo_tpu.integrators import bdpt as jbdpt
from lumo_tpu.sampling.samplers import _hash_u32 as jhash
from lumo_tpu.scene import trace as jtrace
from lumo_tpu.scene.cornell import cornell_box
from lumo_tpu_torch import camera as tcam
from lumo_tpu_torch.color import wavelength as twl
from lumo_tpu_torch.geometry.onb import normalize
from lumo_tpu_torch.integrators import bdpt as tbdpt
from lumo_tpu_torch.scene import trace as ttrace

N = 256
RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stack(path, k):
    return torch.stack([v[k] for v in path], 1).numpy()


def _light_families(pkg):
    """A triangle mesh light with vertex normals, a sphere light and a
    disk light in an empty box."""
    import importlib
    mod = lambda m: importlib.import_module(f"{pkg}.{m}")
    M = mod("scene.materials").Material
    sb = mod("scene.cornell").empty_box((0.8, 0.8, 0.8),
                                        M.diffuse((0.8, 0.2, 0.2)),
                                        M.diffuse((0.2, 0.8, 0.2)))
    v, f, vn = mod("scene.shapes").blob(subdiv=1, seed=3, amp=0.1)
    (mod("scene.instance").Mesh(v, f, normals=vn).to_unit_size()
     .scale_uniform(0.3).translate(-0.4, 0.3, -1.4)
     .add_to(sb, M.light(3.0)))
    sb.add_sphere((0.4, 0.4, -1.5), 0.15, M.light(4.0))
    sb.add_disk((0.0, 0.95, -1.0), (0.0, -1.0, 0.0), 0.3, M.light(5.0))
    return sb


def test_light_leaving_samples_match_jax():
    js = _light_families("lumo_tpu").build()
    ts = port_scene_from_jax(js)
    assert js.n_spheres == 1 and js.n_ana_lights == 1 and js.n_tris > 40
    rng = np.random.default_rng(1)
    n = 2048
    light = rng.integers(0, js.n_lights, n)
    u0, u1 = (rng.uniform(0, 1, (n, 2)).astype(np.float32) for _ in "ab")
    out_j = jtrace.sample_leaving(js, jnp.asarray(light, jnp.int32),
                                  jnp.asarray(u0), jnp.asarray(u1))
    out_t = ttrace.sample_leaving(ts, t(light), t(u0), t(u1))
    names = ("p", "d", "ng", "ns", "err", "mat")
    for k, a_j, a_t in zip(names, out_j, out_t):
        if k == "mat":
            np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_j))
        else:
            np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
    on_j = jtrace.sample_on(js, jnp.asarray(light, jnp.int32),
                            jnp.asarray(u0))
    on_t = ttrace.sample_on(ts, t(light), t(u0))
    for k, a_j, a_t in zip(("p", "ng", "ns", "err", "mat"), on_j, on_t):
        np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    # the mesh light's shading normals are interpolated, not its ng
    prim = np.asarray(js.light_prim)[light]
    tri = prim < js.n_tris
    ns, ng = on_t[2].numpy(), on_t[1].numpy()
    assert (np.abs(ns - ng).max(-1)[tri] > 1e-3).mean() > 0.5
    # all three families were drawn, and the directions leave the surface
    assert tri.any() and (prim == js.n_tris).any() and (prim > js.n_tris).any()
    assert ((out_t[1] * out_t[3]).sum(-1) >= 0).all()
    pdf_j = jtrace.sample_leaving_pdf(js, jnp.asarray(light, jnp.int32),
                                      out_j[1], out_j[2])
    pdf_t = ttrace.sample_leaving_pdf(ts, t(light), out_t[1], out_t[2])
    for a_j, a_t in zip(pdf_j, pdf_t):
        np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), rtol=1e-5,
                                   atol=1e-6)


@pytest.fixture(scope="module")
def cornell_paths():
    """Both packages' light and camera subpaths of N camera rays in the
    Cornell box (the JAX package op by op)."""
    js = cornell_box().build()
    ts = port_scene_from_jax(js)
    cj = jcam.cornell_camera(resolution=(16, 16))
    ct = tcam.cornell_camera(resolution=(16, 16), device="cpu")
    rng = np.random.default_rng(5)
    raster = rng.uniform(0, 16, (N, 2)).astype(np.float32)
    o, d = (np.asarray(x) for x in cj.generate_ray(jnp.asarray(raster),
                                                    jnp.full((N, 2), 0.5)))
    lam = np.asarray(jwl.sample(jnp.asarray(
        rng.uniform(0, 1, N).astype(np.float32))))
    key = rng.integers(0, 1 << 32, N, dtype=np.uint32)
    k_l = jhash(jnp.asarray(key) ^ jnp.uint32(tbdpt._C_LIGHT))
    k_c = jhash(jnp.asarray(key) ^ jnp.uint32(tbdpt._C_CAMERA))
    with jax.disable_jit():
        lp_j, lam1 = jbdpt._light_path(js, jnp.asarray(lam), k_l, 1.0, 6,
                                       jnp.float32)
        cp_j, _ = jbdpt._camera_path(js, cj, jnp.asarray(o), jnp.asarray(d),
                                     lam1, k_c, 1.0, 6)
    lp_t, lam1_t = tbdpt._light_path(ts, t(lam), t(np.asarray(k_l)), 1.0, 6)
    cp_t, _ = tbdpt._camera_path(ts, ct, t(o), t(d), lam1_t,
                                 t(np.asarray(k_c)), 1.0, 6)
    np.testing.assert_array_equal(lam1_t.numpy(), np.asarray(lam1))
    return {"light": ({k: np.asarray(v) for k, v in lp_j.items()}, lp_t),
            "camera": ({k: np.asarray(v) for k, v in cp_j.items()}, cp_t)}


@pytest.mark.parametrize("which", ["light", "camera"])
def test_subpath_matches_jax(cornell_paths, which):
    p_j, p_t = cornell_paths[which]
    assert len(p_t) == 6
    for k in ("valid", "delta", "light", "mat", "surface", "medium"):
        np.testing.assert_array_equal(_stack(p_t, k), p_j[k], err_msg=k)
    valid = p_j["valid"]
    assert valid[:, 2].mean() > 0.5 and not valid.all()
    if which == "light":      # a run of valid vertices from the root
        assert (np.diff(valid.astype(int), axis=1) <= 0).all()
        assert (p_j["light"][:, 0] >= 0).all()
    else:                     # camera paths end on the light
        assert (p_j["light"] >= 0).any()
    for k, atol in (("p", 1e-3), ("ng", 1e-6), ("ns", 1e-6), ("wo", 1e-6),
                    ("gathered", 1e-6), ("pdf_fwd", 1e-6),
                    ("pdf_bck", 1e-6)):
        np.testing.assert_allclose(_stack(p_t, k)[valid], p_j[k][valid],
                                   rtol=RTOL, atol=atol, err_msg=k)


# ---------------------------------------------------------------------------
# MIS weights sum to one (``tests/test_bdpt.py::test_mis_weights_sum_to_one``)

def _mis_variant(name):
    """The reference's six scene variants (``mis_tests.rs:21-99``), built
    by the port."""
    from lumo_tpu_torch.camera import build_camera, cornell_camera
    from lumo_tpu_torch.scene.cornell import cornell_box as tcornell
    from lumo_tpu_torch.scene.cornell import empty_box
    from lumo_tpu_torch.scene.materials import Material
    box = lambda: empty_box((0.9, 0.9, 0.9), Material.diffuse((0.8, 0.1, 0.1)),
                            Material.lambertian((0.1, 0.8, 0.1)))
    cam = lambda **kw: build_camera(resolution=(32, 32), device="cpu", **kw)
    if name == "big_scale":
        return (tcornell().build(device="cpu"),
                cornell_camera(resolution=(512, 512), device="cpu"))
    sb = box()
    if name == "medium":
        sb.set_medium((0.002, 0.003, 0.0001), (0.175, 0.125, 0.11), 0.9)
    if name == "specular_delta":
        sb.add_sphere((-0.45, -0.5, -1.5), 0.25, Material.mirror())
        sb.add_sphere((0.45, -0.5, -1.3), 0.25, Material.glass())
    if name == "specular_rough":
        sb.add_sphere((-0.45, -0.5, -1.5), 0.25,
                      Material.metal((0.9, 0.9, 0.9), 0.5, 1.5, 1.5))
        sb.add_sphere((0.45, -0.5, -1.3), 0.25,
                      Material.transparent((0.9, 0.9, 0.9), 0.5, 1.5))
    kw = {"kind": tcam.ORTHOGRAPHIC} if name == "orthographic" else {}
    return sb.build(device="cpu"), cam(**kw)


def _mis_sum(scene, camera, n, K, seed):
    """Sum of the MIS weights of every (s, t) decomposition of the camera
    paths of K vertices that end on a light (the port's counterpart of
    ``tests/test_bdpt.py::_mis_sum_check``): (total (n,), mask (n,),
    lanes crossing a delta vertex, lanes scattering in the medium)."""
    rng = np.random.default_rng(seed)
    w, h = camera.resolution
    raster = torch.as_tensor((rng.uniform(0, 1, (n, 2)) * [w, h])
                             .astype(np.float32))
    lam = twl.sample(torch.as_tensor(
        rng.uniform(0, 1, n).astype(np.float32)))
    o, d = camera.generate_ray(raster, torch.full((n, 2), 0.5))
    key = torch.as_tensor(rng.integers(0, 1 << 32, n))
    cp, lam = tbdpt._camera_path(scene, camera, o, d, lam, key, 1.0, K + 1)
    cp = cp[:K]
    mask = (sum(v["valid"].to(torch.int32) for v in cp) == K) \
        & (cp[K - 1]["light"] >= 0)
    # the same path in light order: reversed, pdf roles swapped, wo
    # recomputed, the two light-end pdfs re-derived
    lpv = [dict(v) for v in reversed(cp)]
    for i, v in enumerate(lpv):
        v["pdf_fwd"], v["pdf_bck"] = v["pdf_bck"], v["pdf_fwd"]
        v["wo"] = (torch.zeros_like(v["p"]) if i == 0 else normalize(
            lpv[i - 1]["p"] - v["p"], eps=1e-30))
    lpv[0]["pdf_fwd"] = tbdpt._pdf_light_origin(scene, lpv[0])
    lpv[1]["pdf_fwd"] = tbdpt._pdf_light_leaving(lpv[0], lpv[1])
    mp = lambda v: tbdpt._mp(scene, v, lam)
    total = torch.zeros(n)
    for s in range(K):
        t_ = K - s
        if t_ == 1 and s < 2:
            continue
        if s == 0:
            w_ = tbdpt._mis_weight(scene, camera, lam, None, cp, 0, t_)
        elif s == 1:
            w_ = tbdpt._mis_weight(scene, camera, lam, lpv[:1], cp, 1, t_,
                                   mp_ct1=mp(cp[t_ - 1]))
        elif t_ == 1:
            w_ = tbdpt._mis_weight(scene, camera, lam, lpv, cp[:1], s, 1,
                                   mp_ls1=mp(lpv[s - 1]))
        else:
            w_ = tbdpt._mis_weight(scene, camera, lam, lpv, cp, s, t_,
                                   mp_ls1=mp(lpv[s - 1]),
                                   mp_ct1=mp(cp[t_ - 1]))
        # strategies whose connection vertex is delta cannot be sampled
        adm = ~lpv[s]["delta"]
        if s > 0:
            adm = adm & ~lpv[s - 1]["delta"]
        total = total + torch.where(adm, w_, 0.0)
    inner = range(1, K - 1)
    crosses = lambda k: mask & torch.stack(
        [cp[i][k] & cp[i]["valid"] for i in inner]).any(0)
    return total, mask, int(crosses("delta").sum()), \
        int(crosses("medium").sum())


@pytest.mark.parametrize("variant", ["diffuse", "orthographic", "medium",
                                     "specular_delta", "specular_rough",
                                     "big_scale"])
def test_mis_weights_sum_to_one(variant):
    """For each camera path of 4 vertices that ends on a light, the MIS
    weights of its (s, t) decompositions sum to one, by the JAX test's
    rule (median error under 0.01, under 5% of the paths beyond it) with
    14,336 lanes instead of 16,384."""
    scene, camera = _mis_variant(variant)
    total, mask, n_delta, n_medium = _mis_sum(scene, camera, 14336, 4, 3)
    assert int(mask.sum()) > 10, int(mask.sum())
    if variant == "specular_delta":
        assert n_delta > 0, "no path crossed a delta vertex"
    if variant == "medium":
        assert n_medium > 0, "no path scattered in the medium"
    err = torch.abs(torch.where(mask, total, 1.0) - 1.0)
    frac_bad = float((err > 0.01).float().mean()) \
        / max(float(mask.float().mean()), 1e-9)
    assert float(torch.where(mask, err, 0.0).median()) < 0.01
    assert frac_bad < 0.05, (frac_bad, float(err.max()))


def test_bdpt_depth_auto():
    """The renderer's BDPT depth: 12 with a specular dielectric (smooth
    or rough glass: both are flagged specular), ``MAX_VERTS`` without, and
    what ``bdpt_depth`` sets."""
    from lumo_tpu_torch.renderer import Renderer
    variants = {k: _mis_variant(k) for k in ("diffuse", "specular_delta",
                                             "specular_rough")}
    depth = {k: Renderer(s, c).integrator("bdpt")._resolved_bdpt_depth()
             for k, (s, c) in variants.items()}
    assert depth == {"diffuse": tbdpt.MAX_VERTS, "specular_delta": 12,
                     "specular_rough": 12}
    s, c = variants["diffuse"]
    assert Renderer(s, c).bdpt_depth(9)._resolved_bdpt_depth() == 9


def test_emission_gradient_matches_jax():
    """d(loss)/d(emit_scale, kd) through the whole estimator (both
    subpaths, MIS, splats) at ``max_verts=4``, below ``RR_DEPTH``, against
    ``jax.grad`` of ``tests/test_bdpt.py``'s loss on the same 64 rays.
    Lanes whose forward radiance or splats differ beyond rtol 1e-4 (the
    jitted JAX package's fused rounding) are weighted out of both losses
    (at most 2 of 64); the gradients then agree within rtol 1e-3 of the
    largest entry."""
    n = 64
    js = cornell_box().build()
    ts = port_scene_from_jax(js)
    cj = jcam.cornell_camera(resolution=(8, 8))
    ct = tcam.cornell_camera(resolution=(8, 8), device="cpu")
    rng = np.random.default_rng(13)
    raster = rng.uniform(0, 8, (n, 2)).astype(np.float32)
    o, d = (np.asarray(x) for x in cj.generate_ray(jnp.asarray(raster),
                                                    jnp.full((n, 2), 0.5)))
    lam = np.asarray(jwl.sample(jnp.asarray(
        rng.uniform(0, 1, n).astype(np.float32))))
    key = rng.integers(0, 1 << 32, n, dtype=np.uint32)
    leaves = ("emit_scale", "kd")

    def per_lane_j(mf):
        s2 = dataclasses.replace(js, materials=dict(js.materials, **mf))
        r, _, _, sc, sm, _ = jbdpt.integrate(
            s2, cj, jnp.asarray(o), jnp.asarray(d), jnp.asarray(lam),
            ray_key=jnp.asarray(key), max_verts=4)
        return (jnp.where(jnp.isfinite(r), r, 0.0).sum(-1)
                + jnp.where(sm[..., None], sc, 0.0).sum((0, 2)))

    def per_lane_t(mf):
        s2 = dataclasses.replace(ts, materials=dict(ts.materials, **mf))
        r, _, _, sc, sm, _ = tbdpt.integrate(s2, ct, t(o), t(d), t(lam),
                                             ray_key=t(key), max_verts=4)
        return r.sum(-1) + torch.where(sm[..., None], sc, 0.0).sum((0, 2))

    mf_j = {k: js.materials[k] for k in leaves}
    mf_t = {k: ts.materials[k].clone().requires_grad_(True) for k in leaves}
    lane_j = jax.jit(per_lane_j)
    f_j = np.asarray(lane_j(mf_j))
    f_t = per_lane_t(mf_t)
    keep = np.isclose(f_t.detach().numpy(), f_j, rtol=1e-4, atol=1e-6)
    assert (~keep).sum() <= 2, int((~keep).sum())
    assert f_j[keep].sum() > 0.0
    wgt = keep.astype(np.float32)
    g_j = jax.grad(lambda mf: jnp.sum(lane_j(mf) * wgt))(mf_j)
    (f_t * t(wgt)).sum().backward()
    for k in leaves:
        want = np.asarray(g_j[k])
        got = mf_t[k].grad.numpy()
        assert np.isfinite(got).all() and np.abs(want).max() > 0.0, k
        np.testing.assert_allclose(got, want, rtol=1e-3,
                                   atol=1e-3 * np.abs(want).max(), err_msg=k)


def test_batched_strategies_equal_single():
    """The general strategies of one s run as one batch (``_connect``);
    each lane's contribution has the bits of its strategy run alone, on
    ``examples/box.py``'s scene (mirror, glass) at depth 8."""
    from _torch_port import example_scene
    from lumo_tpu_torch.sampling.samplers import _hash_u32
    scene, cam, _ = example_scene("lumo_tpu_torch", "box", 16)
    rng = np.random.default_rng(2)
    n, depth = 256, 8
    raster = torch.as_tensor(rng.uniform(0, 16, (n, 2)).astype(np.float32))
    o, d = cam.generate_ray(raster, torch.full((n, 2), 0.5))
    lam = twl.sample(torch.as_tensor(rng.uniform(0, 1, n).astype(np.float32)))
    key = torch.as_tensor(rng.integers(0, 1 << 32, n))
    lp, lam = tbdpt._light_path(scene, lam, _hash_u32(key ^ tbdpt._C_LIGHT),
                                1.0, depth)
    cp, lam = tbdpt._camera_path(scene, cam, o, d, lam,
                                 _hash_u32(key ^ tbdpt._C_CAMERA), 1.0, depth)
    mp_l = [None] + [tbdpt._mp(scene, v, lam) for v in lp[1:]]
    mp_c = [None] + [tbdpt._mp(scene, v, lam) for v in cp[1:]]
    rng_con = _hash_u32(key ^ tbdpt._C_CONNECT)
    lit = 0
    for s in range(2, depth + 1):
        batch = tbdpt._connect(scene, lam, lp, cp, mp_l, mp_c, rng_con, s,
                               range(2, depth + 1))
        for t_ in range(2, depth + 1):
            one = tbdpt._connect(scene, lam, lp, cp, mp_l, mp_c, rng_con, s,
                                 [t_])[0]
            assert torch.equal(batch[t_ - 2], one), (s, t_)
            lit += int((one.sum(-1) > 0).sum())
    assert lit > 500
