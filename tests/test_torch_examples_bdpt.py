"""The BDPT example programs as a whole: ``examples/box.py`` (a mirror and
a glass sphere in an empty box, its wide Gaussian filter) and
``examples/caustics.py`` (a mirror and a glass mesh, the stand-in blob
for suzanne, through the BVH and the kd-tree), each scene as the JAX
program and the port's program build it, rendered through both packages'
``Renderer(...).integrator("bdpt")`` at 16x16, one sample per pixel,
fixed Russian-roulette threshold 1 and ``bdpt_depth`` left automatic
(12: both scenes hold glass); the JAX package jit-compiled.

A pixel of the bidirectional integrator also gathers the splats of other
pixels' light subpaths, so one subpath that XLA's fused rounding sends
another way moves several pixels.  Caustics, square filter: pixels
beyond 1% of each other are flips (at most 4%), 95% of the rest within
rtol 1e-3, atol 1e-6, their mean within 1e-4.  Box: its Gaussian filter
(radius 2.5) spreads each sample over 25 pixels, so flips may reach 8%;
the mean of the other pixels agrees within 1e-4, the image mean (a
flipped caustic path included) within 1e-3.
"""
import numpy as np
import pytest
import torch

from _torch_port import image_agreement, render_example

RES = 16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _box_filter(renderer, film):
    renderer.pixel_filter(film.PixelFilter.gaussian(2.5, 2.5 / 4.0))


def test_box_matches_jax():
    js, ts, img_j, img_t = render_example("box", "bvh", RES,
                                          integrator="bdpt",
                                          configure=_box_filter)
    assert ts.n_spheres == js.n_spheres == 2 and ts.bvh is None
    assert img_t.shape == (RES, RES, 3) and np.isfinite(img_t).all()
    assert img_t.mean() > 0.0
    flips, _, rel = image_agreement(img_t, img_j)
    assert flips <= RES * RES * 8 // 100, flips
    assert rel <= 1e-4, rel
    assert abs(img_t.mean() - img_j.mean()) <= 1e-3 * img_j.mean()


@pytest.mark.parametrize("accel", ["bvh", "kdtree"])
def test_caustics_matches_jax(accel):
    js, ts, img_j, img_t = render_example("caustics", accel, RES,
                                          integrator="bdpt")
    tree = ts.kdtree if accel == "kdtree" else ts.bvh
    assert tree is not None and ts.n_tris == js.n_tris > 10000
    assert img_t.shape == (RES, RES, 3) and np.isfinite(img_t).all()
    assert img_t.mean() > 0.0
    flips, close, rel = image_agreement(img_t, img_j)
    assert flips <= RES * RES // 25, flips
    assert close >= 0.95, close
    assert rel <= 1e-4, rel
