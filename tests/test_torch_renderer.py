"""The port's pixel samplers, film and Renderer against the JAX package's.

``pixel_offsets`` is bit-exact for all four samplers (both packages hash
the same uint32 counters).  Filters, tone mapping, ``add_samples`` and
``finalize`` agree within 1e-6 (float32 ``exp`` and sums in another
order).  ``Renderer`` images at 16x16, 4 samples per pixel in two batches,
with the fixed and the adaptive Russian-roulette threshold, on a kd-tree
scene and on a dense scene, agree with the JAX ``Renderer`` on one device:
at least 99% of the pixels within rtol 1e-3 (atol 1e-6) and the image mean
within 1e-3; the rest are paths whose topology flips by an ulp.  So do
the direct-light and bidirectional integrators, by the rule of
``test_not_ported_modes_raise``; rendering over several devices raises
with its ROADMAP item (stream mode is held against batch mode in
``test_torch_stream.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import blob_box, image_agreement, port_scene_from_jax, t
from lumo_tpu import film as jfilm
from lumo_tpu.camera import build_camera as jcamera
from lumo_tpu.color import wavelength as jwl
from lumo_tpu.renderer import Renderer as JRenderer
from lumo_tpu.sampling import samplers as jsamp
from lumo_tpu.scene.cornell import empty_box as jempty_box
from lumo_tpu.scene.materials import Material as JMaterial
from lumo_tpu_torch import film as tfilm
from lumo_tpu_torch import renderer as trenderer
from lumo_tpu_torch.camera import build_camera as tcamera
from lumo_tpu_torch.renderer import Renderer as TRenderer
from lumo_tpu_torch.sampling import samplers as tsamp

RES = (16, 16)
SPP = 4


@pytest.mark.parametrize("kind", [tsamp.UNIFORM, tsamp.JITTERED,
                                  tsamp.MULTI_JITTERED, tsamp.SOBOL])
@pytest.mark.parametrize("n_samples", [1, 4, 50])
def test_pixel_offsets_bit_exact(kind, n_samples):
    assert (tsamp.UNIFORM, tsamp.JITTERED, tsamp.MULTI_JITTERED,
            tsamp.SOBOL) == (jsamp.UNIFORM, jsamp.JITTERED,
                             jsamp.MULTI_JITTERED, jsamp.SOBOL)
    rng = np.random.default_rng(kind * 100 + n_samples)
    pix = rng.integers(0, 1 << 32, 2000, dtype=np.uint32)
    sidx = rng.integers(0, 64, 2000).astype(np.uint32)
    sidx[:4] = (1 << 32) - 1, (1 << 31), 0, 63   # wrap-around of s * 2
    ref = np.asarray(jsamp.pixel_offsets(kind, jnp.asarray(sidx), n_samples,
                                         jnp.asarray(pix), 12345))
    got = tsamp.pixel_offsets(kind, t(sidx), n_samples, t(pix), 12345)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  ref.view(np.int32))
    assert 0.0 <= ref.min() and ref.max() <= 1.0


def test_permute_is_a_permutation():
    for l in (1, 2, 7, 16, 50):
        i = torch.arange(l, dtype=torch.int64)
        out = tsamp._permute(i, l, 0xDEADBEEF)
        assert sorted(out.tolist()) == list(range(l))
        ref = np.asarray(jsamp._permute(jnp.arange(l, dtype=jnp.uint32), l,
                                        jnp.uint32(0xDEADBEEF)))
        np.testing.assert_array_equal(out.numpy(), ref)


FILTERS = [("square", ()), ("triangle", ()), ("gaussian", ()),
           ("gaussian", (2.0, 0.7)), ("mitchell", ())]


@pytest.mark.parametrize("name,args", FILTERS)
def test_filters_match_jax(name, args):
    fj = getattr(jfilm.PixelFilter, name)(*args)
    ft = getattr(tfilm.PixelFilter, name)(*args)
    assert (ft.kind, ft.r_disc) == (fj.kind, fj.r_disc)
    v = np.random.default_rng(0).uniform(-2.5, 2.5, (4000, 2)).astype(
        np.float32)
    np.testing.assert_allclose(tfilm.filter_eval(ft, t(v)).numpy(),
                               np.asarray(jfilm.filter_eval(fj,
                                                            jnp.asarray(v))),
                               rtol=1e-6, atol=1e-6)
    assert tfilm.filter_integral(ft) == pytest.approx(
        jfilm.filter_integral(fj), rel=1e-6)


@pytest.mark.parametrize("kind", ["nomap", "clamp", "reinhard"])
@pytest.mark.parametrize("debug", [False, True])
def test_tone_map_matches_jax(kind, debug):
    rng = np.random.default_rng(1)
    lam = np.asarray(jwl.sample(jnp.asarray(
        rng.uniform(0, 1, 300).astype(np.float32))))
    color = rng.uniform(0, 3, (300, 4)).astype(np.float32)
    color[:10, 0] = np.nan
    color[10:20, 1] = -1.0
    color[20:30, 2] = 5000.0
    ref = np.asarray(jfilm.tone_map(kind, jnp.asarray(color),
                                    jnp.asarray(lam), 1.5, debug=debug))
    got = tfilm.tone_map(kind, t(color), t(lam), 1.5, debug=debug).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    assert tfilm.tone_map_kind("Reinhard") == jfilm.tone_map_kind("Reinhard")
    with pytest.raises(ValueError):
        tfilm.tone_map_kind(7)


@pytest.mark.parametrize("splat", [False, True])
def test_add_samples_and_finalize_match_jax(splat):
    rng = np.random.default_rng(2)
    w, h = 12, 9
    raster = rng.uniform(-1.0, 13.0, (3000, 2)).astype(np.float32)
    raster[:, 1] = rng.uniform(-1.0, 10.0, 3000)
    rgb = rng.uniform(0, 2, (3000, 3)).astype(np.float32)
    mask = rng.uniform(0, 1, 3000) > 0.2
    fj, ft = jfilm.PixelFilter.gaussian(), tfilm.PixelFilter.gaussian()
    film_j = jfilm.add_samples(jfilm.new_film((w, h)), fj,
                               jnp.asarray(raster), jnp.asarray(rgb), (w, h),
                               splat=splat, mask=jnp.asarray(mask))
    film_t = tfilm.new_film((w, h))
    out = tfilm.add_samples(film_t, ft, t(raster), t(rgb), (w, h),
                            splat=splat, mask=t(mask))
    assert out is film_t                        # accumulated in place
    if splat:                                   # a weight for finalize
        film_j = jfilm.add_samples(film_j, fj, jnp.asarray(raster),
                                   jnp.asarray(rgb), (w, h))
        tfilm.add_samples(film_t, ft, t(raster), t(rgb), (w, h))
    for a, b in zip(film_t, film_j):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_allclose(
        tfilm.finalize(film_t, ft, 0.25).numpy(),
        np.asarray(jfilm.finalize(film_j, fj, 0.25)), rtol=1e-5, atol=1e-6)


def _dense_box(pkg_box, material):
    """The empty Cornell box: 12 triangles, below BVH_THRESHOLD, so every
    query is the dense test."""
    return pkg_box((0.9, 0.9, 0.9), material.diffuse((0.8, 0.2, 0.2)),
                   material.diffuse((0.2, 0.8, 0.2)))


@pytest.fixture(scope="module")
def scenes():
    kd_j = blob_box("lumo_tpu", 2).build(accel="kdtree")
    dense_j = _dense_box(jempty_box, JMaterial).build()
    assert kd_j.kdtree is not None and dense_j.bvh is None
    return {"kd": (kd_j, port_scene_from_jax(kd_j)),
            "dense": (dense_j, port_scene_from_jax(dense_j))}


@pytest.mark.parametrize("which", ["kd", "dense"])
@pytest.mark.parametrize("delta", [1.0, None], ids=["fixed", "adaptive"])
def test_renderer_matches_jax(scenes, which, delta):
    js, ts = scenes[which]
    jr = (JRenderer(js, jcamera(resolution=RES)).samples(SPP).devices(1)
          .batch_samples(2).seed(7))
    tr = (TRenderer(ts, tcamera(resolution=RES, device="cpu")).samples(SPP)
          .batch_samples(2).seed(7))
    if delta is not None:
        jr.fixed_rr_delta(delta)
        tr.fixed_rr_delta(delta)
    img_j = jr.render(verbose=False)
    img_t = tr.render(verbose=False)
    assert img_t.shape == (RES[1], RES[0], 3) and img_t.dtype == np.float32
    assert np.isfinite(img_t).all() and img_t.mean() > 0.01
    close = np.isclose(img_t, img_j, rtol=1e-3, atol=1e-6).all(axis=-1)
    assert close.mean() >= 0.99, f"{(~close).sum()} pixels differ"
    assert abs(float(img_t.mean()) - float(img_j.mean())) <= 1e-3


def test_renderer_options_and_progress(scenes, capsys, tmp_path):
    """Sampler, filter, tone map, colour space and debug painting go
    through; ``render`` prints its batch lines; ``save_png`` writes."""
    js, ts = scenes["dense"]
    cam_j, cam_t = jcamera(resolution=RES), tcamera(resolution=RES,
                                                    device="cpu")
    jr = (JRenderer(js, cam_j).samples(2).devices(1).fixed_rr_delta(1.0)
          .sampler(jsamp.SOBOL).pixel_filter(jfilm.PixelFilter.mitchell())
          .tone_map("reinhard").colorspace("sRGB").debug_sanitize())
    tr = (TRenderer(ts, cam_t).samples(2).fixed_rr_delta(1.0)
          .sampler(tsamp.SOBOL).pixel_filter(tfilm.PixelFilter.mitchell())
          .tone_map("reinhard").colorspace("sRGB").debug_sanitize()
          .integrator("path").stream(False).devices(1))
    assert tr._auto_batch() == jr._auto_batch() == 2
    img_t = tr.render()
    assert "batch 1/1" in capsys.readouterr().out
    img_j = jr.render(verbose=False)
    close = np.isclose(img_t, img_j, rtol=1e-3, atol=1e-6).all(axis=-1)
    assert close.mean() >= 0.99
    path = tmp_path / "img.png"
    tr.save_png(img_t, str(path))
    assert path.stat().st_size > 0


def test_bdpt_auto_batch_caps_lanes(scenes):
    """The automatic step holds about 2M lanes, as the JAX Renderer's
    does; a BDPT step holds lanes x subpath depth under
    ``BDPT_LANE_VERTICES`` instead (its buffers grow with the depth)."""
    js, ts = scenes["dense"]
    jr = JRenderer(js, jcamera(resolution=(512, 512))).samples(2048)
    r = TRenderer(ts, tcamera(resolution=(512, 512), device="cpu"))
    assert r.samples(2048)._auto_batch() == jr._auto_batch() == 7
    r.integrator("bdpt")
    assert r._resolved_bdpt_depth() == 6 and r._auto_batch() == 4
    assert r.bdpt_depth(12)._auto_batch() == 2
    assert r.bdpt_depth(2)._auto_batch() == 7
    assert r.samples(1)._auto_batch() == 1
    assert trenderer.BDPT_LANE_VERTICES // 12 >= 512 * 512


@pytest.mark.parametrize("call,item", [
    (lambda r: r.devices(2), 11),
    (lambda r: r.integrator("direct"), 8), (lambda r: r.integrator("bdpt"), 8),
    (lambda r: r.integrator("bdpt").bdpt_depth(4), 8)])
def test_not_ported_modes_raise(scenes, call, item):
    """Rendering over several devices raises with its ROADMAP item.  The
    modes of item 8, raises until the direct-light and bidirectional
    integrators were ported, render the dense scene as the JAX Renderer
    does (one sample per pixel, square filter, fixed Russian-roulette
    threshold; the JAX Renderer jit-compiled): pixels that differ by more
    than 1% are topology flips (at most 4%, a BDPT pixel gathers the
    splats of other pixels' light paths), 95% of the rest within rtol
    1e-3 and their mean within 1e-3.  Stream mode takes the path
    integrator only."""
    js, ts = scenes["dense"]
    r = TRenderer(ts, tcamera(resolution=RES, device="cpu"))
    with pytest.raises(ValueError, match="unknown integrator"):
        r.integrator("photon")
    assert trenderer.PATH_TRACE == "path"
    if item == 11:
        with pytest.raises(NotImplementedError, match=f"item {item}\\)"):
            call(r)
        return
    jr = JRenderer(js, jcamera(resolution=RES)).devices(1)
    for x, film in ((jr, jfilm), (r, tfilm)):
        call(x.samples(1).seed(3).fixed_rr_delta(1.0)
             .pixel_filter(film.PixelFilter.square()))
    img_t = r.render(verbose=False)
    img_j = jr.render(verbose=False)
    assert np.isfinite(img_t).all() and img_t.mean() > 0.01
    flips, close, rel = image_agreement(img_t, img_j)
    assert flips <= img_t.shape[0] * img_t.shape[1] // 25, flips
    assert close >= 0.95, close
    assert rel <= 1e-3, rel
    with pytest.raises(ValueError, match="stream mode supports the path"):
        r.stream().render(verbose=False)
