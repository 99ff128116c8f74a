"""The port's differentiable path against the JAX package's, on the CPU.

Gradients of a fixed-depth render with respect to every float leaf of the
material table and the camera's ``c2w_t`` are compared with ``jax.grad``
on three scenes: the Cornell box (32 triangles, the dense path), and the
subdiv-2 blob box of ``bench.py::bench_bvh_scene`` through the plain BVH
walk and through the plain kd walk.  Both sides take the same rays and
``ray_key`` (numpy seeds), so ``jax.random`` stays out.  A first forward
pass gives each side's per-bounce prims; lanes whose prim sequences differ
are counted (under 1%) and weighted out of the loss, so the gradients
compare the same paths.  Tolerances: each leaf's gradient within rtol
1e-4 plus 1e-5 of its largest entry (float32 sums in another order;
measured agreement ~3e-6 of the largest entry).

Also: the vector-Jacobian product of the traversal's hit distance
(``trace._HitT`` against JAX's ``_hit_t``), camera gradients in float64
against central finite differences (rtol 1e-5) and JAX, camera gradients
through a render, finite differences of the port's own render, the
checkpoint on and off (bit-equal gradients, each traversal query run
exactly once per bounce), and fixed depth against the while loop.
"""
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (blob_box, glass_medium_scene, jax_nan_guards,
                         port_scene_from_jax, rays_into_box, t)
from lumo_tpu import film as jfilm
from lumo_tpu.camera import build_camera as jbuild_camera
from lumo_tpu.camera import cornell_camera as jcornell_camera
from lumo_tpu.color import wavelength as jwl
from lumo_tpu.integrators import path_trace as jpt
from lumo_tpu.scene import trace as jtrace
from lumo_tpu.scene.cornell import cornell_box as jcornell_box
from lumo_tpu_torch import film as tfilm
from lumo_tpu_torch.accel import bvh_kernel, kd_kernel
from lumo_tpu_torch.camera import build_camera as tbuild_camera
from lumo_tpu_torch.camera import cornell_camera as tcornell_camera
from lumo_tpu_torch.integrators import path_trace as tpt
from lumo_tpu_torch.scene import trace as ttrace
from lumo_tpu_torch.scene.cornell import cornell_box as tcornell_box

RTOL, ATOL_REL = 1e-4, 1e-5
DEPTH = 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The wavefronts here are small: intra-op threads gain nothing, and
    under parallel test workers every process's threads contend for the
    cores (a tenfold slowdown seen under ``-n 6``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, what):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL_REL * max(scale, 1e-30),
                               err_msg=what)


def _case(which):
    """(JAX scene, port scene, JAX camera, port camera, resolution)."""
    if which == "cornell":
        js, res = jcornell_box().build(), 8
        jc = jcornell_camera(resolution=(res, res))
        tc = tcornell_camera(resolution=(res, res), device="cpu")
    else:
        accel = "kdtree" if which == "kd" else "bvh"
        js, res = blob_box("lumo_tpu", 2).build(accel=accel), 16
        jc = jbuild_camera(resolution=(res, res))
        tc = tbuild_camera(resolution=(res, res), device="cpu")
    return js, port_scene_from_jax(js), jc, tc, res


def _inputs(res, seed):
    n = res * res
    rng = np.random.default_rng(seed)
    raster = rng.uniform(0, res, (n, 2)).astype(np.float32)
    lam = np.asarray(jwl.sample(jnp.asarray(
        rng.uniform(0, 1, n).astype(np.float32))))
    key = rng.integers(0, 1 << 32, n, dtype=np.uint32)
    return raster, lam, key


def _jax_render(js, jc, raster, lam, key, weight, mats, c2w_t):
    materials = {k: mats.get(k, v) for k, v in js.materials.items()}
    scene = dataclasses.replace(js, materials=materials)
    cam = dataclasses.replace(jc, c2w_t=c2w_t)
    n = raster.shape[0]
    o, d = cam.generate_ray(jnp.asarray(raster), jnp.full((n, 2), 0.5))
    r, _, _, prims = jpt.integrate(scene, o, d, jnp.asarray(lam),
                                   ray_key=jnp.asarray(key),
                                   fixed_depth=DEPTH, trace_prims=True)
    return jnp.sum(jnp.asarray(weight)[:, None] * r), prims


def _port_render(ts, tc, raster, lam, key, weight, mats, c2w_t,
                 checkpoint=False):
    scene = dataclasses.replace(ts, materials={**ts.materials, **mats})
    cam = dataclasses.replace(tc, c2w_t=c2w_t)
    n = raster.shape[0]
    o, d = cam.generate_ray(t(raster), torch.full((n, 2), 0.5))
    r, _, _, prims = tpt.integrate(scene, o, d, t(lam), ray_key=t(key),
                                   fixed_depth=DEPTH, trace_prims=True,
                                   checkpoint=checkpoint)
    return (t(weight)[:, None] * r).sum(), prims


def _port_leaves(ts, tc):
    mats = {k: v.clone().requires_grad_(True)
            for k, v in ts.materials.items() if v.is_floating_point()}
    return mats, tc.c2w_t.clone().requires_grad_(True)


@pytest.fixture(scope="module", params=["cornell", "bvh", "kd"])
def grads(request):
    """Both packages' gradients of one weighted render, the port's with the
    checkpoint on and off, and how often each plain query ran."""
    which = request.param
    js, ts, jc, tc, res = _case(which)
    raster, lam, key = _inputs(res, 5)
    ones = np.ones(res * res, np.float32)
    mats_j = {k: v for k, v in js.materials.items()
              if jnp.issubdtype(v.dtype, jnp.floating)}
    _, prims_j = _jax_render(js, jc, raster, lam, key, ones, mats_j,
                             jc.c2w_t)
    with torch.no_grad():
        _, prims_t = _port_render(ts, tc, raster, lam, key, ones, {},
                                  tc.c2w_t)
    same = (prims_t.numpy() == np.asarray(prims_j)).all(axis=0)
    weight = same.astype(np.float32)
    g_j = jax.grad(lambda m, c: _jax_render(js, jc, raster, lam, key, weight,
                                            m, c)[0],
                   argnums=(0, 1))(mats_j, jc.c2w_t)
    out = {"which": which, "flips": int((~same).sum()), "lanes": same.size,
           "jax": g_j, "prims": prims_t}
    mod = kd_kernel if which == "kd" else bvh_kernel
    for ckpt in (True, False):
        calls = {"closest": 0, "any": 0}

        def counted(kind, fn):
            def call(*args, **kwargs):
                calls[kind] += 1
                return fn(*args, **kwargs)
            return call

        mats, c2w_t = _port_leaves(ts, tc)
        with mock.patch.object(mod, "closest_hit",
                               counted("closest", mod.closest_hit)), \
                mock.patch.object(mod, "any_hit", counted("any", mod.any_hit)):
            loss, _ = _port_render(ts, tc, raster, lam, key, weight, mats,
                                   c2w_t, checkpoint=ckpt)
            loss.backward()
        out[ckpt] = ({k: v.grad for k, v in mats.items()}, c2w_t.grad,
                     dict(calls))
    return out


def test_material_and_camera_grads_match_jax(grads):
    assert grads["flips"] <= grads["lanes"] // 100, grads["flips"]
    (g_mats_j, g_cam_j), (g_mats_t, g_cam_t, _) = grads["jax"], grads[True]
    assert set(g_mats_t) == set(g_mats_j)
    for k, g in g_mats_j.items():
        # None: the render never reads the leaf (Cornell's eta and k: no
        # microfacet material), where JAX returns zeros
        got = (np.zeros(g.shape, np.float32) if g_mats_t[k] is None
               else g_mats_t[k].numpy())
        assert np.isfinite(got).all(), k
        _close(got, np.asarray(g), k)
    _close(g_cam_t.numpy(), np.asarray(g_cam_j), "c2w_t")
    # light arrives, so emission and the lit surfaces' reflectance carry
    # gradient
    for k in ("kd", "emit_scale"):
        assert float(np.abs(np.asarray(g_mats_j[k])).sum()) > 0.0, k


def test_checkpoint_is_bit_equal_and_walks_once_per_bounce(grads):
    (m_on, c_on, calls_on), (m_off, c_off, calls_off) = grads[True], grads[False]
    for k in m_on:
        assert (m_on[k] is None and m_off[k] is None) or torch.equal(
            m_on[k], m_off[k]), k
    assert torch.equal(c_on, c_off)
    if grads["which"] == "cornell":   # 32 triangles: the dense test, no walk
        assert calls_on == calls_off == {"closest": 0, "any": 0}
    else:
        assert calls_on == calls_off == {"closest": DEPTH, "any": DEPTH}


def test_material_grads_match_finite_differences():
    """``tests/test_render.py``'s check on the port alone: Cornell 8x8,
    fixed depth 4, central differences (eps 1e-3) of the float32 render on
    the largest ``emit_scale`` and ``kd`` gradients, within 5% and 8%."""
    _, ts, _, tc, res = _case("cornell")
    raster, lam, key = _inputs(res, 7)
    ones = np.ones(res * res, np.float32)
    mats, _ = _port_leaves(ts, tc)
    loss, _ = _port_render(ts, tc, raster, lam, key, ones, mats, tc.c2w_t)
    loss.backward()

    def at(leaf, idx, eps):
        m = {k: v.detach() for k, v in mats.items()}
        m[leaf] = m[leaf].clone()
        m[leaf][idx] += eps
        with torch.no_grad():
            return float(_port_render(ts, tc, raster, lam, key, ones, m,
                                      tc.c2w_t)[0])

    for leaf, rel in (("emit_scale", 0.05), ("kd", 0.08)):
        g = mats[leaf].grad
        assert torch.isfinite(g).all()
        idx = np.unravel_index(int(g.abs().argmax()), tuple(g.shape))
        fd = (at(leaf, idx, 1e-3) - at(leaf, idx, -1e-3)) / 2e-3
        assert fd == pytest.approx(float(g[idx]), rel=rel), (leaf, fd)


# ---------------------------------------------------------------------------
# the hit distance of a traversal

@pytest.mark.parametrize("accel", ["bvh", "kdtree"])
def test_hit_t_vjp_matches_jax(accel):
    """VJP of sum(w * t) for the rays and the three vertex tables, through
    ``intersect`` (walk plus ``_hit_t``; on the BVH scene also the dense
    wall test) on the subdiv-2 blob box."""
    js = blob_box("lumo_tpu", 2).build(accel=accel)
    ts = port_scene_from_jax(js)
    o, d = rays_into_box(512, seed=11)
    w = np.random.default_rng(12).uniform(0.5, 1.5, 512).astype(np.float32)

    def jloss(o, d, a, b, c):
        s = dataclasses.replace(js, tri_a=a, tri_b=b, tri_c=c)
        h = jtrace.intersect(s, o, d)
        return jnp.sum(jnp.asarray(w) * jnp.where(h["valid"], h["t"], 0.0))

    g_j = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(
        jnp.asarray(o), jnp.asarray(d), js.tri_a, js.tri_b, js.tri_c)
    leaves = [t(o), t(d), ts.tri_a.clone(), ts.tri_b.clone(),
              ts.tri_c.clone()]
    for x in leaves:
        x.requires_grad_(True)
    s = dataclasses.replace(ts, tri_a=leaves[2], tri_b=leaves[3],
                            tri_c=leaves[4])
    h = ttrace.intersect(s, leaves[0], leaves[1])
    assert int(h["valid"].sum()) > 256
    (t(w) * torch.where(h["valid"], h["t"], 0.0)).sum().backward()
    for name, x, g in zip(("o", "d", "a", "b", "c"), leaves, g_j):
        assert torch.isfinite(x.grad).all(), name
        _close(x.grad.numpy(), np.asarray(g), name)
    # the vertex tables get gradient through the walk's hits, not only
    # through the walls' dense test
    n = ts.n_bvh_tris if accel == "bvh" else ts.n_tris
    assert float(leaves[2].grad[:n].abs().sum()) > 0.0


@pytest.mark.parametrize("accel", ["bvh", "kdtree"])
def test_queries_reject_rays_that_require_grad(accel):
    ts = port_scene_from_jax(blob_box("lumo_tpu", 2).build(accel=accel))
    o, d = (t(x) for x in rays_into_box(16, seed=1))
    o.requires_grad_(True)
    t_max = torch.full((16,), float("inf"))
    if accel == "bvh":
        tri = ttrace._bvh_tris(ts)
        calls = (lambda: bvh_kernel.closest_hit(ts.bvh, tri, o, d, t_max),
                 lambda: bvh_kernel.any_query(ts.bvh, tri, o, d, t_max))
    else:
        calls = (lambda: kd_kernel.closest_hit(ts.kdtree, o, d, t_max),
                 lambda: kd_kernel.any_query(ts.kdtree, o, d, t_max))
    for call in calls:
        with pytest.raises(ValueError, match=r"o requires grad.*o\.detach"):
            call()


# ---------------------------------------------------------------------------
# the camera

N_CAM = 64


def _rays_loss(cam, lib):
    """``tests/test_camera_grad.py``'s smooth functional of the generated
    rays (a fixed plane hit analytically), in float64, written once for
    ``lib`` = jnp or torch."""
    rng = np.random.default_rng(0)
    raster = rng.uniform(0, 48, (N_CAM, 2))
    u_dof = rng.uniform(0.05, 0.95, (N_CAM, 2))
    arr = (jnp.asarray if lib is jnp
           else lambda x: torch.as_tensor(x, dtype=torch.float64))
    o, d = cam.generate_ray(arr(raster), arr(u_dof))
    n = arr(np.array([0.2, 0.3, 0.93]))
    tt = -(o @ n + 5.0) / (d @ n)
    p = o + tt[:, None] * d
    return lib.mean(lib.sin(0.37 * p)) + lib.mean(d * n)


_CAM_ARGS = dict(origin=(0.3, -0.2, 0.1), towards=(0.0, 0.1, -1.0),
                 lens_radius=0.02, focal_length=2.5, resolution=(64, 64))


@pytest.mark.parametrize("leaf", ["lens_radius", "focal_length", "c2w_t"])
def test_camera_grads_match_fd_and_jax(leaf):
    cam = tbuild_camera(**_CAM_ARGS, dtype=torch.float64, device="cpu")
    v0 = getattr(cam, leaf).clone().requires_grad_(True)
    loss_of = lambda v: _rays_loss(dataclasses.replace(cam, **{leaf: v}),
                                   torch)
    g, = torch.autograd.grad(loss_of(v0), v0)
    g = g.reshape(-1).numpy()
    h = 1e-6
    base = v0.detach().reshape(-1)
    for i in range(base.numel()):
        e = torch.zeros_like(base)
        e[i] = h
        with torch.no_grad():
            fd = (float(loss_of((base + e).reshape(v0.shape)))
                  - float(loss_of((base - e).reshape(v0.shape)))) / (2 * h)
        np.testing.assert_allclose(g[i], fd, rtol=1e-5, atol=1e-9)
    with jax.enable_x64(True):
        jcam = jbuild_camera(**_CAM_ARGS, dtype=np.float64)
        g_j = jax.grad(lambda v: _rays_loss(
            dataclasses.replace(jcam, **{leaf: v}), jnp))(getattr(jcam, leaf))
        g_j = np.atleast_1d(np.asarray(g_j, np.float64))
    np.testing.assert_allclose(g, g_j, rtol=1e-10, atol=1e-14)


def test_pinhole_rays_unchanged_by_the_lens_branch():
    """With lens_radius 0 the selected rays are the pinhole's, bit for bit
    the JAX camera's float32 rays within an ulp-level tolerance, and the
    lens leaves still receive (zero) gradients."""
    cam = tbuild_camera(resolution=(16, 16), device="cpu")
    lr = cam.lens_radius.clone().requires_grad_(True)
    fl = cam.focal_length.clone().requires_grad_(True)
    cam2 = dataclasses.replace(cam, lens_radius=lr, focal_length=fl)
    raster = torch.rand(64, 2, generator=torch.Generator().manual_seed(0)) * 16
    o, d = cam2.generate_ray(raster, torch.full((64, 2), 0.5))
    o0, d0 = cam.generate_ray(raster, torch.full((64, 2), 0.5))
    assert torch.equal(o, o0) and torch.equal(d, d0)
    (o.sum() + d.sum()).backward()
    assert float(lr.grad) == 0.0 and float(fl.grad) == 0.0
    jo, jd = jbuild_camera(resolution=(16, 16)).generate_ray(
        jnp.asarray(raster.numpy()), jnp.full((64, 2), 0.5))
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo), atol=1e-6)
    np.testing.assert_allclose(d.detach().numpy(), np.asarray(jd), rtol=1e-6,
                               atol=1e-6)


def test_camera_grads_through_render():
    """``tests/test_camera_grad.py:66-99`` on both packages: Cornell 16x16,
    fixed depth 2, a thin lens focused in the box; d mean(r) / d (c2w_t,
    lens_radius) finite, the origin's nonzero, and equal to JAX's within
    rtol 1e-3 plus 1e-5 of the largest entry."""
    res, n = 16, 256
    pix = np.arange(n, dtype=np.uint32)
    raster = np.stack([pix % 16, pix // 16], -1).astype(np.float32) + 0.5
    lam = np.asarray(jwl.sample(jnp.linspace(0.03, 0.97, n)))
    rk = (pix * np.uint32(2654435761)).astype(np.uint32)
    js = jcornell_box().build()
    ts = port_scene_from_jax(js)
    jc = jcornell_camera(resolution=(res, res))
    tc = tcornell_camera(resolution=(res, res), device="cpu")

    def jloss(c2w_t, lens_radius):
        cam = dataclasses.replace(jc, c2w_t=c2w_t, lens_radius=lens_radius,
                                  focal_length=jnp.float32(1000.0))
        o, d = cam.generate_ray(jnp.asarray(raster), jnp.full((n, 2), 0.3))
        r, _, _ = jpt.integrate(js, o, d, jnp.asarray(lam),
                                ray_key=jnp.asarray(rk), fixed_depth=2)
        return jnp.mean(r)

    g_j = jax.grad(jloss, argnums=(0, 1))(jc.c2w_t, jnp.float32(5.0))
    c2w_t = tc.c2w_t.clone().requires_grad_(True)
    lens_radius = torch.tensor(5.0, requires_grad=True)
    cam = dataclasses.replace(tc, c2w_t=c2w_t, lens_radius=lens_radius,
                              focal_length=torch.tensor(1000.0))
    o, d = cam.generate_ray(t(raster), torch.full((n, 2), 0.3))
    r, _, _ = tpt.integrate(ts, o, d, t(lam), ray_key=t(rk), fixed_depth=2)
    r.mean().backward()
    assert torch.isfinite(c2w_t.grad).all()
    assert torch.isfinite(lens_radius.grad)
    assert float(c2w_t.grad.abs().sum()) > 0.0
    for got, want in ((c2w_t.grad, g_j[0]), (lens_radius.grad, g_j[1])):
        want = np.asarray(want)
        np.testing.assert_allclose(
            got.numpy(), want, rtol=1e-3,
            atol=1e-5 * max(float(np.abs(want).max()), 1e-30))


def test_cornell_camera_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcornell_camera(resolution=(8, 8))
    cam = tcornell_camera(resolution=(8, 8), device="cpu")
    assert cam.c2w_t.device.type == "cpu" and cam.resolution == (8, 8)


# ---------------------------------------------------------------------------
# the Cornell box and the film

def test_cornell_box_and_film_match_jax():
    """``cornell_box`` builds the JAX package's arrays (32 triangles, the
    dense path); the ``"CORNELL"`` white balance equals JAX's; and
    ``spectral_to_rgb`` carries the same gradient to the radiance."""
    from _torch_port import SCENE_FIELDS
    js = jcornell_box().build()
    ts = tcornell_box().build(device="cpu")
    assert ts.n_tris == js.n_tris == 32 and ts.bvh is None
    for k in SCENE_FIELDS:
        np.testing.assert_array_equal(getattr(ts, k).numpy(),
                                      np.asarray(getattr(js, k)), err_msg=k)
    for k, v in js.materials.items():
        np.testing.assert_array_equal(ts.materials[k].numpy(), np.asarray(v),
                                      err_msg=k)
    wb_j = jfilm.wb_matrix("DCI-P3", "CORNELL")
    wb_t = tfilm.wb_matrix("DCI-P3", "CORNELL")
    np.testing.assert_allclose(wb_t, wb_j, rtol=1e-12)
    rng = np.random.default_rng(3)
    color = rng.uniform(0, 2, (512, 4)).astype(np.float32)
    lam = np.asarray(jwl.sample(jnp.asarray(
        rng.uniform(0, 1, 512).astype(np.float32))))
    wbm = jnp.asarray(wb_j, jnp.float32)
    g_j = jax.grad(lambda c: jnp.mean(jfilm.spectral_to_rgb(
        c, jnp.asarray(lam), wbm) ** 2))(jnp.asarray(color))
    c = t(color).requires_grad_(True)
    (tfilm.spectral_to_rgb(c, t(lam), wb_t) ** 2).mean().backward()
    _close(c.grad.numpy(), np.asarray(g_j), "d loss / d radiance")


# ---------------------------------------------------------------------------
# the two loop modes

@pytest.mark.parametrize("which", ["cornell", "bvh"])
def test_fixed_depth_matches_the_loop(which):
    """``fixed_depth = MAX_DEPTH`` gives the while loop's forward bit for
    bit: dead lanes stay unchanged through the extra bounces."""
    _, ts, _, tc, res = _case(which)
    raster, lam, key = _inputs(res, 9)
    o, d = tc.generate_ray(t(raster), torch.full((res * res, 2), 0.5))
    with torch.no_grad():
        loop = tpt.integrate(ts, o, d, t(lam), ray_key=t(key),
                             trace_prims=True)
        fixed = tpt.integrate(ts, o, d, t(lam), ray_key=t(key),
                              fixed_depth=tpt.MAX_DEPTH, trace_prims=True)
    for a, b in zip(loop[:3], fixed[:3]):
        assert torch.equal(a, b)
    k = loop[3].shape[0]
    assert k > tpt.RR_DEPTH
    assert torch.equal(fixed[3][:k], loop[3])
    assert bool((fixed[3][k:] == -1).all())


# ---------------------------------------------------------------------------
# the branches of slice 5 on the differentiable path

def test_slice5_scene_grads_match_jax():
    """Fixed depth 4 on a 12x12 image of the glass-sphere, checker-floor,
    disk-light, medium scene: d loss / d every float material leaf and
    ``c2w_t`` within rtol 1e-4 plus 1e-5 of the largest entry of
    ``jax.grad``'s, lanes whose bounce prims differ weighted out (at most
    2%).  The JAX package's camera gradient is NaN on this scene (masked
    lanes of its sphere and disk code, ROADMAP.md section 3), so the
    reference runs under ``jax_nan_guards``, which guards those lanes as
    the port does without changing a forward value.  The new branches keep
    the differentiation boundary: every gradient is finite."""
    res = 12
    js = glass_medium_scene("lumo_tpu").build()
    ts = port_scene_from_jax(js)
    cam = dict(origin=(0.0, 0.1, 0.6), towards=(0.0, -0.4, -2.0),
               resolution=(res, res))
    jc = jbuild_camera(**cam)
    tc = tbuild_camera(**cam, device="cpu")
    raster, lam, key = _inputs(res, 9)
    ones = np.ones(res * res, np.float32)
    mats_j = {k: v for k, v in js.materials.items()
              if jnp.issubdtype(v.dtype, jnp.floating)}
    with jax_nan_guards():
        _, prims_j = _jax_render(js, jc, raster, lam, key, ones, mats_j,
                                 jc.c2w_t)
    with torch.no_grad():
        _, prims_t = _port_render(ts, tc, raster, lam, key, ones, {},
                                  tc.c2w_t)
    prims_j = np.asarray(prims_j)
    same = (prims_t.numpy() == prims_j).all(axis=0)
    assert (~same).sum() <= same.size // 50, int((~same).sum())
    # every new family is on some path: sphere, disk light, medium
    T, S = js.n_tris, js.n_spheres
    seen = prims_j[prims_j >= 0]
    assert ((seen >= T) & (seen < T + S)).any() and (seen >= T + S).any()
    weight = same.astype(np.float32)
    with jax_nan_guards():
        g_j = jax.grad(lambda m, c: _jax_render(js, jc, raster, lam, key,
                                                weight, m, c)[0],
                       argnums=(0, 1))(mats_j, jc.c2w_t)
    mats, c2w_t = _port_leaves(ts, tc)
    loss, _ = _port_render(ts, tc, raster, lam, key, weight, mats, c2w_t)
    loss.backward()
    assert float(loss.detach()) > 0.0
    for k, g in g_j[0].items():
        got = (np.zeros(g.shape, np.float32) if mats[k].grad is None
               else mats[k].grad.numpy())
        assert np.isfinite(got).all(), k
        _close(got, np.asarray(g), k)
    # the medium's phase and the disk light carry gradient
    for k in ("sigma_s", "t_scale", "hg_g", "emit_scale"):
        assert float(np.abs(np.asarray(g_j[0][k])).sum()) > 0.0, k
    g_cam = c2w_t.grad.numpy()
    assert np.isfinite(g_cam).all() and np.abs(g_cam).max() > 0.0
    _close(g_cam, np.asarray(g_j[1]), "c2w_t")
