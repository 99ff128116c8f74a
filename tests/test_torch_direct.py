"""The direct-light integrator against the JAX package's: the two-strategy
NEE (``common.shadow_rays``), ``direct_light.integrate`` on the Cornell
box and on a glass sphere in a medium (``glass_medium_scene``), the
light-alias refresh, and the ``Renderer`` with ``integrator("direct")``
(``tests/test_render.py::test_direct_light_render_smoke``'s frame and
``examples/cornell.py --integrator direct``'s scene).

The same numpy-seeded rays go through both packages with ``ray_key``
given, so both draw the same random numbers.  Hero wavelengths and
depths are equal on every lane; radiance lies within rtol 1e-4, atol
1e-6, but on lanes that differ by more than 1% (a flip: a ray the JAX
package's fused rounding sends past the edge of the light where the port
hits it, or the reverse), which are counted and stay under 1%.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (glass_medium_scene, image_agreement,
                         port_scene_from_jax, render_example, t)
from lumo_tpu import camera as jcam
from lumo_tpu.bsdf import eval as jbsdf
from lumo_tpu.color import wavelength as jwl
from lumo_tpu.integrators import common as jcommon
from lumo_tpu.integrators import direct_light as jdl
from lumo_tpu.sampling.samplers import _hash_u32 as jhash
from lumo_tpu.scene import trace as jtrace
from lumo_tpu.scene.cornell import cornell_box
from lumo_tpu_torch.bsdf import eval as tbsdf
from lumo_tpu_torch.integrators import common as tcommon
from lumo_tpu_torch.integrators import direct_light as tdl
from lumo_tpu_torch.scene import trace as ttrace

N = 256
RES = 16
RTOL, ATOL = 1e-4, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(name):
    if name == "cornell":
        return cornell_box().build(), jcam.cornell_camera(
            resolution=(RES, RES))
    return (glass_medium_scene("lumo_tpu").build(),
            jcam.build_camera(resolution=(RES, RES)))


@pytest.fixture(scope="module", params=["cornell", "glass"])
def case(request):
    js, cam = _scene(request.param)
    rng = np.random.default_rng(5)
    raster = rng.uniform(0, RES, (N, 2)).astype(np.float32)
    o, d = (np.asarray(x) for x in cam.generate_ray(jnp.asarray(raster),
                                                     jnp.full((N, 2), 0.5)))
    lam = np.asarray(jwl.sample(jnp.asarray(
        rng.uniform(0, 1, N).astype(np.float32))))
    key = rng.integers(0, 1 << 32, N, dtype=np.uint32)
    return js, port_scene_from_jax(js), dict(o=o, d=d, lam=lam, key=key)


def _flips(r_t, r_j):
    """(lanes beyond 1% of each other, lanes within rtol 1e-4 of the
    rest)."""
    flip = ~np.isclose(r_t, r_j, rtol=1e-2, atol=ATOL).all(-1)
    close = np.isclose(r_t, r_j, rtol=RTOL, atol=ATOL).all(-1)
    return flip, close


def test_shadow_rays_match_jax(case):
    """NEE with both strategies at the camera rays' first hits."""
    js, ts, h = case
    salt = 0xE7037ED1
    rng_j = jhash(jnp.asarray(h["key"]) + jnp.uint32(0x9E3779B9))
    hit_j = jtrace.intersect(js, jnp.asarray(h["o"]), jnp.asarray(h["d"]),
                             rng=rng_j, salt=jnp.uint32(salt))
    rng_t = t(np.asarray(rng_j))
    hit_t = ttrace.intersect(ts, t(h["o"]), t(h["d"]), rng=rng_t, salt=salt)
    np.testing.assert_array_equal(hit_t["prim"].numpy(),
                                  np.asarray(hit_j["prim"]))
    mp_j = jbsdf.gather_params(js.materials, hit_j["mat"],
                               jnp.asarray(h["lam"]), hit_j["uv"],
                               js.textures, js.tex_kinds, t=hit_j["t"])
    mp_t = tbsdf.gather_params(ts.materials, hit_t["mat"], t(h["lam"]),
                               hit_t["uv"], ts.textures, ts.tex_kinds,
                               t=hit_t["t"], kinds=ts.kinds_present,
                               beck=ts.beckmann)
    g = np.ones((N, 4), np.float32)
    nee_j = np.asarray(jcommon.shadow_rays(
        js, mp_j, -jnp.asarray(h["d"]), jnp.asarray(g), hit_j,
        jnp.asarray(h["lam"]), rng_j))
    nee_t = tcommon.shadow_rays(ts, mp_t, -t(h["d"]), t(g), hit_t,
                                t(h["lam"]), rng_t).numpy()
    flip, close = _flips(nee_t, nee_j)
    assert flip.sum() <= N // 100, int(flip.sum())
    assert close[~flip].all()
    assert (nee_j.sum(-1) > 0).mean() > 0.2


def test_integrate_matches_jax(case):
    js, ts, h = case
    r_j, lam_j, dep_j = (np.asarray(x) for x in jdl.integrate(
        js, jnp.asarray(h["o"]), jnp.asarray(h["d"]), jnp.asarray(h["lam"]),
        ray_key=jnp.asarray(h["key"])))
    r_t, lam_t, dep_t = tdl.integrate(ts, t(h["o"]), t(h["d"]), t(h["lam"]),
                                      ray_key=t(h["key"]))
    np.testing.assert_array_equal(dep_t.numpy(), dep_j)
    np.testing.assert_array_equal(lam_t.numpy(), lam_j)
    flip, close = _flips(r_t.numpy(), r_j)
    assert flip.sum() <= N // 100, int(flip.sum())
    assert close[~flip].all()
    assert (r_j.sum(-1) > 0).mean() > 0.2
    if js.medium is not None:
        # the glass sphere's specular chains run several bounces
        assert dep_j.max() >= 3


def test_rebuild_light_alias_matches_jax():
    """Mirrors ``tests/test_render.py::test_rebuild_light_alias``:
    unchanged materials give the baked pdf back; a light whose emission
    rises 4x draws a larger share; both equal the JAX package's."""
    js = cornell_box().build()
    ts = port_scene_from_jax(js)
    s2 = ts.rebuild_light_alias()
    np.testing.assert_allclose(s2.light_pdf.numpy(), ts.light_pdf.numpy(),
                               rtol=1e-5)
    assert s2.light_pdf.device == ts.light_pdf.device
    lm = int(ts.tri_mat[ts.light_prim[0]])
    es = ts.materials["emit_scale"].clone()
    es[lm] *= 4.0
    s3 = dataclasses.replace(
        ts, materials=dict(ts.materials, emit_scale=es)).rebuild_light_alias()
    es_j = np.asarray(js.materials["emit_scale"]).copy()
    es_j[lm] *= 4.0
    j3 = dataclasses.replace(js, materials=dict(
        js.materials, emit_scale=jnp.asarray(es_j))).rebuild_light_alias()
    for k in ("light_pdf", "alias_p", "alias_idx"):
        np.testing.assert_allclose(getattr(s3, k).numpy(),
                                   np.asarray(getattr(j3, k)), rtol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(s3.light_pdf.sum().item(), 1.0, rtol=1e-5)


def test_direct_light_render_matches_jax():
    """``tests/test_render.py::test_direct_light_render_smoke``'s frame
    (16x16, 4 samples, seed 2, the Gaussian filter) through both
    Renderers: finite and lit.  A flipped sample at the light's edge
    carries a hundred times a wall's radiance into the 5x5 pixels of its
    filter footprint, so flips (pixels beyond 1%) may reach a tenth of
    the frame; 99% of the rest lie within rtol 1e-3, their mean within
    1e-4."""
    from lumo_tpu.renderer import Renderer as JRenderer
    from lumo_tpu_torch import camera as tcam
    from lumo_tpu_torch.renderer import Renderer as TRenderer
    js = cornell_box().build()
    ts = port_scene_from_jax(js)
    img_j = (JRenderer(js, jcam.cornell_camera(resolution=(RES, RES)))
             .samples(4).integrator("direct").illuminant("CORNELL").seed(2)
             .devices(1).render(verbose=False))
    img_t = (TRenderer(ts, tcam.cornell_camera(resolution=(RES, RES),
                                               device="cpu"))
             .samples(4).integrator("direct").illuminant("CORNELL").seed(2)
             .render(verbose=False))
    assert np.isfinite(img_t).all() and img_t.mean() > 0.001
    flips, close, rel = image_agreement(img_t, img_j)
    assert flips <= RES * RES // 10, flips
    assert close >= 0.99, close
    assert rel <= 1e-4, rel


def test_cornell_example_direct_matches_jax():
    """``examples/cornell.py --integrator direct``'s scene, built by each
    package's own calls, at 16x16 and one sample per pixel: flips (pixels
    beyond 1%) at most 1%, 99% of the rest within rtol 1e-3, their mean
    within 1e-4."""
    js, ts, img_j, img_t = render_example("cornell", "bvh", RES,
                                          integrator="direct")
    assert ts.n_tris == js.n_tris and ts.bvh is None
    assert np.isfinite(img_t).all() and img_t.mean() > 0.0
    flips, close, rel = image_agreement(img_t, img_j)
    assert flips <= RES * RES // 100, flips
    assert close >= 0.99, close
    assert rel <= 1e-4, rel
