"""``bdpt.integrate`` as a whole against the JAX package's: radiance,
splat raster, splat colour, splat mask and depth on the Cornell box
(diffuse), ``examples/box.py``'s scene (a mirror and a glass sphere), an
empty box in a medium and an empty box seen by an orthographic camera,
256 camera rays each with the same ``ray_key``.

The JAX package runs op by op (``jax.disable_jit``): jitted, XLA's fused
rounding moves a few subpath vertices across an edge (about 2% of the
lanes on the Cornell box), op by op the two packages walk the same
subpaths.  Depth, hero wavelengths and the splat masks are then equal on
every lane.  A lane's radiance sums up to 35 strategies, each with a MIS
weight whose ratios amplify an ulp where two vertices lie in one plane
(a connection direction whose cosine is 2e-7 on one side and 0 on the
other): lanes beyond 1% of each other count as flips and stay under 1%;
98% of the rest lie within rtol 1e-4, atol 1e-6 (all within 1%), their
mean within 1e-5.  Splat colours agree within rtol 1e-4, atol 1e-6 and
raster coordinates within 1e-3 where the mask is set.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import example_scene, port_scene_from_jax, t
from lumo_tpu import camera as jcam
from lumo_tpu.color import wavelength as jwl
from lumo_tpu.integrators import bdpt as jbdpt
from lumo_tpu.scene.cornell import cornell_box, empty_box
from lumo_tpu.scene.materials import Material
from lumo_tpu_torch import camera as tcam
from lumo_tpu_torch.integrators import bdpt as tbdpt

N = 256
RES = 16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(name):
    """(JAX scene, JAX camera, port camera)."""
    if name == "box":
        js, cj, _ = example_scene("lumo_tpu", "box", RES)
        return js, cj, example_scene("lumo_tpu_torch", "box", RES)[1]
    if name == "cornell":
        js, fn, kw = cornell_box().build(), "cornell_camera", {}
    else:
        sb = empty_box((0.9, 0.9, 0.9), Material.diffuse((0.8, 0.1, 0.1)),
                       Material.lambertian((0.1, 0.8, 0.1)))
        fn, kw = "build_camera", {}
        if name == "medium":
            sb.set_medium((0.02, 0.03, 0.001), (0.175, 0.125, 0.11), 0.9)
        else:
            kw = {"kind": jcam.ORTHOGRAPHIC}
        js = sb.build()
    return (js, getattr(jcam, fn)(resolution=(RES, RES), **kw),
            getattr(tcam, fn)(resolution=(RES, RES), device="cpu", **kw))


@pytest.fixture(scope="module", params=["cornell", "box", "medium",
                                        "orthographic"])
def outputs(request):
    js, cj, ct = _case(request.param)
    rng = np.random.default_rng(5)
    raster = rng.uniform(0, RES, (N, 2)).astype(np.float32)
    o, d = (np.asarray(x) for x in cj.generate_ray(jnp.asarray(raster),
                                                    jnp.full((N, 2), 0.5)))
    lam = np.asarray(jwl.sample(jnp.asarray(
        rng.uniform(0, 1, N).astype(np.float32))))
    key = rng.integers(0, 1 << 32, N, dtype=np.uint32)
    with jax.disable_jit():
        out_j = jbdpt.integrate(js, cj, jnp.asarray(o), jnp.asarray(d),
                                jnp.asarray(lam), ray_key=jnp.asarray(key))
    out_t = tbdpt.integrate(port_scene_from_jax(js), ct, t(o), t(d), t(lam),
                            ray_key=t(key))
    return ([np.asarray(x) for x in out_j], [x.numpy() for x in out_t],
            request.param)


def test_integrate_shapes_and_depth(outputs):
    out_j, out_t, _ = outputs
    S = tbdpt.MAX_VERTS
    shapes = [(N, 4), (N, 4), (S - 1, N, 2), (S - 1, N, 4), (S - 1, N), (N,)]
    assert [x.shape for x in out_t] == shapes
    rad, lam, sr, sc, sm, depth = out_t
    np.testing.assert_array_equal(depth, out_j[5])
    np.testing.assert_array_equal(lam, out_j[1])
    np.testing.assert_array_equal(sm, out_j[4])
    assert np.isfinite(rad).all() and np.isfinite(sc).all()
    assert depth.max() > 6 and (rad.sum(-1) > 0).mean() > 0.5


def test_integrate_radiance_matches_jax(outputs):
    out_j, out_t, _ = outputs
    r_j, r_t = out_j[0], out_t[0]
    flip = ~np.isclose(r_t, r_j, rtol=1e-2, atol=1e-6).all(-1)
    close = np.isclose(r_t, r_j, rtol=1e-4, atol=1e-6).all(-1)
    assert flip.sum() <= N // 100, int(flip.sum())
    assert close[~flip].mean() >= 0.98, close[~flip].mean()
    mean_j = r_j[~flip].mean()
    assert abs(r_t[~flip].mean() - mean_j) <= 1e-5 * abs(mean_j)


def test_integrate_splats_match_jax(outputs):
    out_j, out_t, name = outputs
    sm = out_j[4]
    assert sm.mean() > 0.05, sm.mean()
    np.testing.assert_allclose(out_t[3][sm], out_j[3][sm], rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(out_t[2][sm], out_j[2][sm], rtol=1e-4,
                               atol=1e-3)
    assert (out_t[3][~sm] == 0.0).all()
    w, h = RES, RES
    r = out_t[2][sm]
    assert ((r >= 0) & (r < [w, h])).all()
