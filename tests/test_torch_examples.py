"""Slice 5 as a whole: the example programs of ``examples/`` rebuilt in
the port with the same calls, rendered through the port's ``Renderer``
and the JAX ``Renderer`` at 16x16, one sample per pixel (fixed Russian
roulette threshold, square pixel filter: each pixel is one sample), on
the CPU.  This file holds the dense scenes (``medium``, ``circle``,
``conference``); ``test_torch_examples_mesh.py`` the BVH and kd ones.

The rule is the renderer test's: at least 99% of the pixels within rtol
1e-3, atol 1e-6, and the image mean within 1e-4 relative, over the
pixels that did not flip; a pixel flips when it differs by more than 1%,
a discrete change of its path (``tools/quality.py`` counts such rays
apart), and flips are counted (at most 1%).

``medium`` and ``conference`` hold the port against the JAX package run
op by op (``jax.disable_jit``): their shadow rays end a float32
cancellation away from a light (conference's sphere lights of radius 10
lie 400 to 1,500 units from the walls, where the sphere quadratic's error
of about 0.1 exceeds the shadow ray's 1e-4 shortening; the medium's
fireflies run along the light's edge), so whether a light hides itself
depends on rounding, which XLA's fusion changes between the light query
and the occlusion query.  Op by op, both packages round those queries
alike and the images agree on every pixel.  The Renderer's defaults
with media and glass are held in ``test_torch_examples_mesh.py``."""
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


@pytest.mark.parametrize("name,eager,counts", [
    ("medium", True, (32, 0, 0)),
    ("circle", False, (0, 9, 1)),
    ("conference", True, (52, 2, 0)),
])
def test_example_matches_jax(name, eager, counts):
    js, ts, img_j, img_t = render_example(name, "bvh", RES, jax_eager=eager)
    assert (ts.n_tris, ts.n_spheres, ts.n_analytic) == counts
    assert (js.n_tris, js.n_spheres, js.n_analytic) == counts
    assert ts.bvh is None and ts.kdtree is None      # dense: under 64
    if name == "medium":
        assert ts.medium is not None
    assert img_t.shape == (RES, RES, 3) and np.isfinite(img_t).all()
    assert img_t.mean() > 0.0
    flips, close, rel = image_agreement(img_t, img_j)
    assert flips <= RES * RES // 100, flips
    assert close >= 0.99, close
    assert rel <= 1e-4, rel

