"""Slice 5 as a whole, the textured example scenes with a BVH:
``nefertiti`` (marble texture, analytic disks, quad light) and ``dof``
(checker and marble textures, orthographic thin-lens camera), as the
JAX programs and the port's programs build them, rendered through both
packages' ``Renderer`` as in ``test_torch_examples.py`` (16x16, one sample per
pixel, square filter; the JAX package jit-compiled), by that file's rule
(99% of the non-flipped pixels within rtol 1e-3, atol 1e-6, mean within
1e-4 relative, at most 1% flips), except for ``dof``: at least 95%
within rtol 1e-3.  The orthographic camera's ray origins differ from the
JAX package's by an ulp (1.2e-7), and the marble texture, (0.5 + 0.5
sin(60 u + 20 turbulence))^6 on triangles 0.02 wide, turns that into up
to 1% of a pixel; 3% of dof's pixels land between 1e-3 and 1e-2 (the
JAX package run op by op gives the same share).

The ulp was traced to the camera's (N, 3) @ (3, 3) products
(``to_world_pt``, ``to_world_dir``), and no evaluation order of the port
reproduces the JAX package's: XLA's CPU dot for this shape sums column 0
of dof's rays as rounded products (no fused multiply-add) and column 2
as a fused multiply-add chain, while torch's CPU matmul (and an explicit
three-term sum in either form) takes one rule for every column; and the
JAX package's jitted ``generate_ray`` disagrees with its own op-by-op one
on 3.2% of the origins and 17% of the directions of 4,096 dof rays,
because the rounding follows XLA's fusion.  So 95% stays the rule for
dof.

``nefertiti`` stops in the JAX package: its tree branch of
``trace._closest`` hands ``analytic_t`` a 1-D t_max, a shape error
(ROADMAP.md section 3); ``render_example`` passes it as a column for the
reference run."""
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


@pytest.mark.parametrize("name,accel,min_close", [
    ("nefertiti", "bvh", 0.99), ("dof", "bvh", 0.95)])
def test_example_matches_jax(name, accel, min_close):
    js, ts, img_j, img_t = render_example(name, accel, RES)
    tree = ts.kdtree if accel == "kdtree" else ts.bvh
    assert tree is not None and ts.n_tris == js.n_tris > 15000
    if name == "nefertiti":
        assert ts.n_analytic == 3
    assert img_t.shape == (RES, RES, 3) and np.isfinite(img_t).all()
    assert img_t.mean() > 0.0
    flips, close, rel = image_agreement(img_t, img_j)
    assert flips <= RES * RES // 100, flips
    assert close >= min_close, close
    assert rel <= 1e-4, rel
