"""Statistical checks of the port's BDPT estimator (marked ``slow``: they
render thousands of samples per pixel), the counterparts of
``tests/test_bdpt.py::test_bdpt_converges_to_path_trace`` and
``tests/test_bdpt_caustics.py``: BDPT agrees with the path tracer within
Monte Carlo noise on the Cornell box, and on a glass sphere's caustic the
12-vertex cap has converged (16 moves nothing) and truncation only loses
energy.  Port only, on the CPU, with the JAX tests' sizes and bounds."""
import numpy as np
import pytest

from lumo_tpu_torch.camera import build_camera, cornell_camera
from lumo_tpu_torch.renderer import Renderer
from lumo_tpu_torch.scene.cornell import cornell_box
from lumo_tpu_torch.scene.materials import Material
from lumo_tpu_torch.scene.scene import SceneBuilder

pytestmark = pytest.mark.slow


def _mean(img):
    return float(np.asarray(img, np.float64).mean())


def test_bdpt_converges_to_path_trace():
    scene = cornell_box().build(device="cpu")
    cam = cornell_camera(resolution=(8, 8), device="cpu")
    pt = (Renderer(scene, cam).samples(1024).integrator("path")
          .illuminant("CORNELL").seed(1).render(verbose=False))
    bd = (Renderer(scene, cam).samples(1024).integrator("bdpt")
          .illuminant("CORNELL").seed(2).render(verbose=False))
    assert np.isfinite(bd).all()
    m = pt.max(axis=2) < 5.0          # wall pixels (the light is noisy in PT)
    rel = np.abs(bd[m] - pt[m]).mean() / pt[m].mean()
    assert rel < 0.15, rel
    assert abs(bd.mean() - pt.mean()) / pt.mean() < 0.2


def test_bdpt_caustic_truncation_bias():
    sb = SceneBuilder()
    sb.add_rectangle((-2, -0.8, -3.0), (2, -0.8, -3.0), (-2, -0.8, 0.5),
                     Material.diffuse((0.75, 0.75, 0.75)))
    sb.add_sphere((0.0, -0.35, -1.4), 0.3, Material.glass())
    sb.add_sphere((0.9, 0.72, -1.2), 0.12,
                  Material.light((1, 1, 1), scale=40.0))
    scene = sb.build(device="cpu")
    cam = build_camera(resolution=(8, 8), device="cpu")
    r = Renderer(scene, cam).integrator("bdpt")
    assert r._resolved_bdpt_depth() == 12
    ref = _mean(Renderer(scene, cam).samples(2048).seed(5)
                .integrator("path").render(verbose=False))
    means = {mv: _mean(Renderer(scene, cam).samples(512).seed(9)
                       .integrator("bdpt").bdpt_depth(mv)
                       .render(verbose=False)) for mv in (6, 12, 16)}
    assert means[16] == pytest.approx(means[12], rel=0.03), means
    assert means[12] == pytest.approx(ref, rel=0.15), (means, ref)
    assert means[6] <= means[12] * 1.05, means
