"""The port's float64 reference mode and its quality harness against the
JAX package's, on the CPU.

The switch's constants equal the JAX package's.  Then the same scenes
render in float64 through both packages, fed the harness's sample
streams (``tools/quality.py``): the Cornell box by direct light and by
the fixed-depth path tracer (depth 2, per-bounce prims traced), the
instanced, textured blob scene (fixed depth 3, its groups through the
port's float64 plain route and JAX's XLA walk), and a kd scene's queries.
Rays whose per-bounce prims differ (or, for direct light, whose radiance
jumps by more than 0.5, the harness's flip) are counted, at most 1%, and
left out.

The JAX package runs op by op (``jax.disable_jit``).  Its jitted float64
render is not its own op-by-op one: XLA fuses the cross product of a
wall's shading normal, so a z of exactly 0 comes out as -1.78e-19 and
the branchless ONB takes its other sign branch (``ROADMAP.md`` section
3); the port equals the op-by-op run.

Two draw streams.  ``harness``: the counter hash emits float32 and the
integrators transform it in float32 (square_to_disk's cos and sin, ...)
before it meets float64 data, in both packages and in both precisions,
as the harness needs.  XLA's CPU float32 transcendentals and torch's
differ by an ulp on some inputs, so the float64 radiance agrees to
rtol 1e-5, atol 1e-9 there (measured: 7.1e-7 relative, 1.0e-7 absolute
at worst, on the blob scene).  ``float64``: every module of both
packages that draws gets the hash's float32 value cast to float64 first
(``mock.patch`` of ``_randfloat``), so the whole path is float64
arithmetic; there the port equals JAX within rtol 1e-9, atol 1e-12
(measured: 3.8e-14 relative at worst) and the float64 gradient within
rtol 1e-8.  Float32 epsilons in the float64 mode miss these by up to
6.1e-4 relative (``ROADMAP.md`` section 3).

A float64 build holds every float table in float64 but the kernels'
packed tables.  Last, the port's harness at (16, 1) (tier 1) and (24, 2)
(``slow``) against every threshold of ``tests/test_quality_f64.py``.
"""
import contextlib
import dataclasses
import importlib
import json
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import blob_box, jax_kd_arrays, jax_scene_arrays, t
from lumo_tpu import config as jcfg
from lumo_tpu import film as jfilm
from lumo_tpu.accel import traverse
from lumo_tpu.camera import build_camera as jbuild_camera
from lumo_tpu.camera import cornell_camera as jcornell_camera
from lumo_tpu.color import wavelength as jwl
from lumo_tpu.integrators import direct_light as jdl
from lumo_tpu.integrators import path_trace as jpt
from lumo_tpu.sampling import samplers as jsamplers
from lumo_tpu.scene.cornell import cornell_box as jcornell_box
from lumo_tpu_torch import config as tcfg
from lumo_tpu_torch.accel import bvh_kernel, kd_kernel
from lumo_tpu_torch.integrators import direct_light as tdl
from lumo_tpu_torch.integrators import path_trace as tpt
from lumo_tpu_torch.sampling import samplers as tsamplers
from lumo_tpu_torch.scene import scene as tscene
from lumo_tpu_torch.scene import shapes as tshapes
from lumo_tpu_torch.scene.instance import Mesh as TMesh
from lumo_tpu_torch.scene.instance import translation
from lumo_tpu_torch.scene.materials import Material as TMaterial
from lumo_tpu_torch.tools import quality

RES = 16
# (rtol, atol) of the float64 radiance per draw stream (module docstring)
TOL = {"harness": (1e-5, 1e-9), "float64": (1e-9, 1e-12)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small wavefronts: intra-op threads gain nothing and contend under
    parallel test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _switch_off_after():
    """No test leaves either package's float64 switch on."""
    yield
    assert tcfg.float_dtype() == torch.float32
    assert jcfg.float_dtype() == jnp.float32


@contextlib.contextmanager
def f64():
    """Both packages in their float64 mode (JAX with x64), restored after."""
    with jax.enable_x64(True):
        jcfg.use_f64(True)
        tcfg.use_f64(True)
        try:
            yield
        finally:
            jcfg.use_f64(False)
            tcfg.use_f64(False)


@contextlib.contextmanager
def draws(kind):
    """``harness``: the packages as they are.  ``float64``: every module
    of both packages that holds the counter hash ``_randfloat`` gets its
    float32 value cast to float64."""
    jr, tr = jsamplers._randfloat, tsamplers._randfloat
    wide = {jr: lambda i, p: jr(i, p).astype(jnp.float64),
            tr: lambda i, p: tr(i, p).to(torch.float64)}
    with contextlib.ExitStack() as stack:
        if kind == "float64":
            for name, mod in list(sys.modules.items()):
                if (name.split(".")[0] in ("lumo_tpu", "lumo_tpu_torch")
                        and getattr(mod, "_randfloat", None) in wide):
                    stack.enter_context(mock.patch.object(
                        mod, "_randfloat", wide[mod._randfloat]))
        yield


def _jax_streams(cam, res):
    """``tools/quality.py``'s rays and draws of its first sample."""
    n = res * res
    pix = jnp.arange(n, dtype=jnp.uint32)
    sp = jnp.uint32(0x9E3779B9)
    rnd = lambda salt: jsamplers._randfloat(
        pix, sp ^ jnp.uint32(salt)).astype(jnp.float64)
    raster = jnp.stack([(pix % res).astype(jnp.float64) + rnd(0x51633E2D),
                        (pix // res).astype(jnp.float64) + rnd(0x68BC21EB)],
                       -1)
    o, d = cam.generate_ray(raster, jnp.full((n, 2), 0.5, jnp.float64))
    lam = jwl.sample(rnd(0x02E5BE93))
    return o, d, lam, (pix * jnp.uint32(2654435761)) ^ sp


def _jax_blob_scene():
    """``tools/quality.py::_bvh_scene`` with the JAX package's calls (the
    tool itself turns x64 on for the whole process when imported)."""
    mod = lambda m: importlib.import_module(f"lumo_tpu.{m}")
    Material = mod("scene.materials").Material
    inst = mod("scene.instance")
    sb = mod("scene.cornell").empty_box((0.95, 0.95, 0.95),
                                        Material.diffuse((0.9, 0.1, 0.1)),
                                        Material.diffuse((0.1, 0.9, 0.1)))
    checker = sb.textures.checkerboard((0.1, 0.1, 0.1), (0.9, 0.9, 0.9),
                                       8.0)
    sb.add_rectangle((-0.99, -0.795, -1.99), (0.99, -0.795, -1.99),
                     (-0.99, -0.795, -0.01),
                     Material.diffuse((1.0, 1.0, 1.0), kd_tex=checker))
    v, f, vn = mod("scene.shapes").blob(subdiv=5, seed=11, amp=0.22)
    mesh = inst.Mesh(v, f, normals=vn)
    mesh.to_unit_size().to_origin()
    mats = [Material.diffuse((0.8, 0.6, 0.2)),
            Material.diffuse((0.2, 0.5, 0.8))]
    ts = [inst.translation(-0.45, -0.45, -1.5) @ inst.rotate_y(0.7)
          @ inst.scale(0.6, 0.6, 0.6),
          inst.translation(0.45, -0.5, -1.2) @ inst.scale(0.5, 0.5, 0.5)]
    mesh.add_instances_to(sb, ts, mats)
    return sb.build(dtype=np.float64)


def _scenes(which):
    """(JAX scene, JAX camera, port scene, port camera) in float64; call
    under :func:`f64`."""
    if which == "cornell":
        js = jcornell_box().build(dtype=np.float64)
        jc = jcornell_camera(resolution=(RES, RES), dtype=np.float64)
        ts, tc = quality.cornell_setup(torch.float64, RES, "cpu")
    else:
        js = _jax_blob_scene()
        jc = jbuild_camera(resolution=(RES, RES), dtype=np.float64)
        ts, tc = quality.bvh_setup(torch.float64, RES, "cpu")
    return js, jc, ts, tc


def _render_both(which, integrator):
    """Both packages' float64 radiance of one sample, and per-bounce prims
    of the fixed-depth integrator (None for direct light); the JAX
    package op by op."""
    js, jc, ts, tc = _scenes(which)
    o, d, lam, key = quality.sample_rays(tc, RES, 0, torch.float64)
    with jax.disable_jit():
        jo, jd, jlam, jkey = _jax_streams(jc, RES)
        for a, b in ((jo, o), (jd, d), (jlam, lam)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-12)
        np.testing.assert_array_equal(key.numpy(), np.asarray(jkey))
        if integrator == "direct":
            rj = jdl.integrate(js, jo, jd, jlam, ray_key=jkey)[0]
            pj = None
        else:
            rj, _, _, pj = jpt.integrate(js, jo, jd, jlam, ray_key=jkey,
                                         fixed_depth=integrator,
                                         trace_prims=True)
    if integrator == "direct":
        rt, pt = tdl.integrate(ts, o, d, lam, ray_key=key)[0], None
    else:
        rt, _, _, pt = tpt.integrate(ts, o, d, lam, ray_key=key,
                                     fixed_depth=integrator, trace_prims=True)
        pt, pj = pt.numpy(), np.asarray(pj)
    return np.asarray(rj), rt.numpy(), pj, pt


def _hold(rj, rt, pj, pt, kind):
    """Flips at most 1% of rays; radiance within ``TOL[kind]`` on the
    rest."""
    stable = np.abs(rj - rt).max(axis=1) < quality.FLIP
    if pj is not None:
        stable &= (pj == pt).all(axis=0)
    assert (~stable).sum() <= rj.shape[0] // 100
    rtol, atol = TOL[kind]
    np.testing.assert_allclose(rt[stable], rj[stable], rtol=rtol, atol=atol)


@pytest.mark.parametrize("switch", [False, True])
def test_switch_constants_match_jax(switch):
    try:
        jcfg.use_f64(switch)
        tcfg.use_f64(switch)
        assert tcfg.epsilon() == jcfg.epsilon()
        assert tcfg.machine_eps_half() == jcfg.machine_eps_half()
        for n in range(2, 10):
            assert tcfg.gamma_bound(n) == jcfg.gamma_bound(n)
        assert tcfg.np_float_dtype() == jcfg.np_float_dtype()
        want = torch.float64 if switch else torch.float32
        assert tcfg.float_dtype() == want
    finally:
        jcfg.use_f64(False)
        tcfg.use_f64(False)


def _float_tensors(obj, path=""):
    """(path, tensor) of every floating tensor in a scene or camera, its
    dicts and its groups."""
    if isinstance(obj, torch.Tensor):
        return [(path, obj)] if obj.is_floating_point() else []
    if dataclasses.is_dataclass(obj):
        obj = {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return [x for k, v in obj.items()
                for x in _float_tensors(v, f"{path}.{k}")]
    if isinstance(obj, (tuple, list)):
        return [x for i, v in enumerate(obj)
                for x in _float_tensors(v, f"{path}[{i}]")]
    return []


@pytest.mark.parametrize("accel", ["bvh", "kdtree"])
def test_float64_build_has_float64_tables(accel):
    """A float64 build holds every float table in float64 (materials,
    textures, the split-out walls, lights and alias, the instanced groups'
    maps and vertices, the camera) but the kernels' packed tables, which
    stay float32."""
    with quality.precision(torch.float64):
        tc = quality.bvh_setup(torch.float64, 8, "cpu")[1]
        sb = blob_box("lumo_tpu_torch", 2)
        sb.textures.checkerboard((0.1, 0.1, 0.1), (0.9, 0.9, 0.9), 8.0)
        v, f, vn = tshapes.blob(subdiv=2, seed=3, amp=0.2)
        TMesh(v, f, normals=vn).add_instances_to(
            sb, [translation(0.3, -0.5, -1.2)],
            [TMaterial.diffuse((0.5, 0.5, 0.5))])
        ts = sb.build(accel=accel, dtype=np.float64, device="cpu")
    packed = (".bvh.", ".kdtree.", "].bvh.")
    tables = _float_tensors(ts) + _float_tensors(tc, "camera")
    kernel = [p for p, x in tables if any(k in p for k in packed)]
    assert kernel and ts.inst and ts.textures is not None
    assert accel == "kdtree" or ts.n_bvh_tris < ts.n_tris
    for p, x in tables:
        want = torch.float32 if p in kernel else torch.float64
        assert x.dtype == want, p


@pytest.mark.parametrize("kind", ["harness", "float64"])
@pytest.mark.parametrize("integrator", ["direct", 2])
def test_cornell_f64_matches_jax(integrator, kind):
    with f64(), draws(kind):
        _hold(*_render_both("cornell", integrator), kind)


@pytest.mark.parametrize("kind", ["harness", "float64"])
def test_instanced_blob_f64_matches_jax(kind):
    n0 = dict(bvh_kernel.PLAIN_F64)
    with f64(), draws(kind):
        rj, rt, pj, pt = _render_both("bvh", quality.BVH_DEPTH)
    # the two groups' walks went through the float64 plain route: one
    # closest query an instance and bounce
    assert bvh_kernel.PLAIN_F64["closest"] - n0["closest"] \
        == 2 * quality.BVH_DEPTH
    _hold(rj, rt, pj, pt, kind)


def test_kd_queries_f64_match_jax():
    """A float64 kd scene's queries take the dense float64 test over the
    scene's vertices (the packed tables are float32) and equal JAX's XLA
    kd walk over its float64 tree."""
    rng = np.random.default_rng(8)
    n = 256
    o = np.array([0.0, 0.0, 0.5]) + rng.uniform(-0.1, 0.1, (n, 3))
    d = rng.normal(size=(n, 3))
    d[:, 2] = -np.abs(d[:, 2]) - 0.3
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = np.where(rng.uniform(size=n) < 0.5, rng.uniform(0.2, 2.0, n),
                     np.inf)
    with f64():
        js = blob_box("lumo_tpu", 2).build(accel="kdtree", dtype=np.float64)
        fields, bvh = jax_scene_arrays(js)
        ts = tscene.from_numpy(fields, bvh, "cpu", dtype=np.float64,
                               kd=jax_kd_arrays(js))
        tri = (js.tri_a, js.tri_b, js.tri_c)
        t_j, p_j = traverse.kd_closest_hit(js.kdtree, tri, jnp.asarray(o),
                                           jnp.asarray(d))
        occ_j = traverse.kd_any_hit(js.kdtree, tri, jnp.asarray(o),
                                    jnp.asarray(d), t_max=jnp.asarray(t_max))
        assert ts.kdtree["tris"].dtype == torch.float32
        assert ts.tri_a.dtype == torch.float64
        vt = (ts.tri_a, ts.tri_b, ts.tri_c)
        n0 = dict(kd_kernel.PLAIN_F64)
        t_t, p_t = kd_kernel.closest_query(ts.kdtree, t(o), t(d), np.inf, vt)
        occ_t = kd_kernel.any_query(ts.kdtree, t(o), t(d), t(t_max), vt)
        assert kd_kernel.PLAIN_F64 == {"closest": n0["closest"] + 1,
                                       "any": n0["any"] + 1}
        with pytest.raises(TypeError, match="float64"):
            kd_kernel.closest_query(ts.kdtree, t(o), t(d), np.inf)
    assert t_t.dtype == torch.float64
    np.testing.assert_array_equal(p_t.numpy(), np.asarray(p_j))
    np.testing.assert_allclose(t_t.numpy(), np.asarray(t_j), rtol=1e-12)
    np.testing.assert_array_equal(occ_t.numpy(), np.asarray(occ_j))
    assert 0 < occ_t.sum() < n


def test_bvh_stats_f64_walks_float64_vertices():
    """A float64 stats query walks the tree over the float64 vertices and
    finds the dense test's hits."""
    with f64():
        ts = blob_box("lumo_tpu_torch", 2).build(dtype=np.float64,
                                                  device="cpu")
        rng = np.random.default_rng(3)
        o = np.array([0.0, 0.0, 0.5]) + rng.uniform(-0.1, 0.1, (128, 3))
        d = rng.normal(size=(128, 3))
        d[:, 2] = -np.abs(d[:, 2]) - 0.3
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        tri = tuple(x[:ts.n_bvh_tris] for x in (ts.tri_a, ts.tri_b,
                                                ts.tri_c))
        n0 = bvh_kernel.PLAIN_F64["stats"]
        t_s, p_s, stats = bvh_kernel.closest_hit_stats(ts.bvh, tri, t(o), t(d))
        t_d, p_d = bvh_kernel.closest_hit_plain(ts.bvh, tri, t(o), t(d))
        assert bvh_kernel.PLAIN_F64["stats"] == n0 + 1
    assert t_s.dtype == torch.float64 and (p_d >= 0).any()
    np.testing.assert_array_equal(p_s.numpy(), p_d.numpy())
    np.testing.assert_array_equal(t_s.numpy(), t_d.numpy())
    assert stats.shape == (4, 2, 3) and (stats[:, 0, 0] > 0).all()


@pytest.mark.parametrize("kind", ["harness", "float64"])
def test_cornell_f64_gradient_matches_jax(kind):
    """d mean(rgb^2) / d theta, theta scaling ``kd``, of the fixed-depth
    render (depth 2): the port's ``torch.autograd.grad`` against
    ``jax.grad``, both in float64, within rtol 1e-8."""
    wbm = jfilm.wb_matrix("DCI-P3", "CORNELL")
    with f64(), draws(kind):
        js, jc, ts, tc = _scenes("cornell")

        def jloss(th):
            mats = dict(js.materials)
            mats["kd"] = mats["kd"] * th
            sc = dataclasses.replace(js, materials=mats)
            o, d, lam, key = _jax_streams(jc, RES)
            r, lam_out, _ = jpt.integrate(sc, o, d, lam, ray_key=key,
                                          fixed_depth=quality.CORNELL_DEPTH)
            return jnp.mean(jfilm.spectral_to_rgb(r, lam_out,
                                                  jnp.asarray(wbm)) ** 2)

        with jax.disable_jit():
            g_j = float(jax.grad(jloss)(jnp.float64(1.0)))
        theta = torch.ones((), dtype=torch.float64, requires_grad=True)
        _, loss = quality.render_cornell(ts, tc, RES, 1, theta,
                                         grad_mode=True)
        (g_t,) = torch.autograd.grad(loss, theta)
    assert np.isfinite(g_j) and g_j != 0.0
    np.testing.assert_allclose(float(g_t), g_j, rtol=1e-8)


def _thresholds(out):
    """Every threshold of ``tests/test_quality_f64.py``."""
    assert out["bin_rel_err_mean"] < 1e-3
    assert out["bin_rel_err_p999"] < 5e-2
    assert out["flipped_rays"] <= max(2, out["rays"] // 100)
    assert out["grad_flipped_rays"] <= out["rays"] // 5
    assert out["grad_ad_vs_fd_rel_err"] < 1e-6
    assert out["grad_f32_vs_ref_rel_err"] < 1e-2
    bvh = out["bvh"]
    assert bvh["bin_rel_err_mean"] < 1e-3
    assert bvh["bin_rel_err_p999"] < 5e-2
    assert bvh["flipped_rays"] <= max(2, bvh["rays"] // 100)
    assert bvh["grad_ad_vs_fd_rel_err"] < 1e-6
    assert bvh["grad_f32_vs_ref_rel_err"] < 1e-2


@pytest.mark.parametrize("res,spp,bvh", [
    (16, 1, (16, 1)),
    # the JAX test's configuration: run(24, 2) with run_bvh()'s (32, 2)
    pytest.param(24, 2, (32, 2), marks=pytest.mark.slow),
])
def test_harness_meets_thresholds(res, spp, bvh):
    out = quality.run(res, spp, device="cpu")
    out["bvh"] = quality.run_bvh(*bvh, device="cpu")
    assert out["rays"] == res * res and out["bvh"]["rays"] == bvh[0] ** 2
    _thresholds(out)


def test_harness_defaults_to_the_card_and_prints_one_line(capsys):
    """Without a device the harness asks for the card, and raises here;
    the command line prints one JSON line with the blob block nested."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        quality.run(8, 1)
    with mock.patch.object(quality, "run", lambda res, spp, device: {
            "res": res, "spp": spp, "device": device}), \
            mock.patch.object(quality, "run_bvh",
                              lambda device: {"device": device}):
        quality.main(["12", "3", "--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out == {"res": 12, "spp": 3, "device": "cpu",
                   "bvh": {"device": "cpu"}}
