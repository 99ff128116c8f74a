"""Slice 5 as a whole, the example scene with a tree of its own:
``dragon`` (rough dispersive glass on a 20,480-triangle mesh in the empty
box) through the plain version of K2 and of K3, and ``bunny`` (the one
rough conductor of the programs, ``Material.metal(..., 0.1, 2.5, 3.0)``)
through K2's, as the JAX program and the port's program build it,
rendered through both packages' ``Renderer`` as in
``test_torch_examples.py`` (16x16, one sample per pixel, square filter;
the JAX package jit-compiled), by that file's rule: 99% of the
non-flipped pixels within rtol 1e-3, atol 1e-6, the mean within 1e-4
relative, at most 1% flips.  The textured mesh scenes are in
``test_torch_examples_tex.py``.

The Renderer's defaults hold with media and glass too: adaptive Russian
roulette (delta from the first batch's per-pixel stats), the Gaussian
filter and ``.illuminant("CORNELL")`` on a glass sphere in a medium
under a disk light, two batches of one sample, against the jit-compiled
JAX ``Renderer`` by the same rule (99% within rtol 1e-3, mean within
1e-4)."""
import numpy as np
import pytest
import torch

from _torch_port import (glass_medium_scene, image_agreement,
                         port_scene_from_jax, render_example)

RES = 16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name,accel,min_close", [
    ("dragon", "bvh", 0.99), ("dragon", "kdtree", 0.99),
    ("bunny", "bvh", 0.99)])
def test_example_matches_jax(name, accel, min_close):
    js, ts, img_j, img_t = render_example(name, accel, RES)
    tree = ts.kdtree if accel == "kdtree" else ts.bvh
    assert tree is not None and ts.n_tris == js.n_tris > 15000
    assert img_t.shape == (RES, RES, 3) and np.isfinite(img_t).all()
    assert img_t.mean() > 0.0
    flips, close, rel = image_agreement(img_t, img_j)
    assert flips <= RES * RES // 100, flips
    assert close >= min_close, close
    assert rel <= 1e-4, rel


def test_renderer_defaults_with_media_and_glass():
    from lumo_tpu.camera import build_camera as jcamera
    from lumo_tpu.renderer import Renderer as JRenderer
    from lumo_tpu_torch.camera import build_camera as tcamera
    from lumo_tpu_torch.renderer import Renderer as TRenderer
    js = glass_medium_scene("lumo_tpu").build()
    ts = glass_medium_scene("lumo_tpu_torch").build(device="cpu")
    np.testing.assert_array_equal(port_scene_from_jax(js).tri_a.numpy(),
                                  ts.tri_a.numpy())
    cam = dict(origin=(0.0, 0.1, 0.6), towards=(0.0, -0.4, -2.0),
               resolution=(RES, RES))
    img_j = (JRenderer(js, jcamera(**cam)).samples(2).batch_samples(1)
             .devices(1).seed(5).illuminant("CORNELL").render(verbose=False))
    tr = (TRenderer(ts, tcamera(**cam, device="cpu")).integrator("path")
          .samples(2).batch_samples(1).seed(5).illuminant("CORNELL"))
    assert tr._delta is None                 # adaptive
    img_t = tr.render(verbose=False)
    assert np.isfinite(img_t).all() and img_t.mean() > 0.0
    close = np.isclose(img_t, img_j, rtol=1e-3, atol=1e-6).all(-1)
    assert close.mean() >= 0.99, close.mean()
    assert abs(img_t.mean() - img_j.mean()) <= 1e-4 * img_j.mean()
