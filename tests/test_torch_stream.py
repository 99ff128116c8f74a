"""The port's persistent-wavefront stream mode against its batch mode and
against the JAX package's ``integrate_stream`` (``tests/test_stream.py``,
one device).

Every draw of the bounce is a counter hash of the sample's ``ray_key``,
and PyTorch's CPU kernels compute each lane the same way in either mode,
so a sample's stream radiance equals its batch radiance bit for bit.
Against JAX (XLA contracts multiply-adds, PyTorch rounds each operation)
samples agree within rtol 1e-4, atol 1e-5, except samples whose path
flips on an ulp, counted and held under 1%.  The stream ``Renderer``
image equals the batch image within rtol 1e-5, atol 1e-6 (the same
samples, summed into the film in another order); with adaptive Russian
roulette it agrees with a fixed-threshold render within Monte Carlo noise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import blob_box, port_scene_from_jax
from lumo_tpu.camera import cornell_camera as jcornell_camera
from lumo_tpu.color import wavelength as jwl
from lumo_tpu.integrators import path_trace as jpt
from lumo_tpu.sampling import samplers as jsamp
from lumo_tpu.scene.cornell import cornell_box as jcornell_box
from lumo_tpu_torch.camera import build_camera as tbuild_camera
from lumo_tpu_torch.camera import cornell_camera as tcornell_camera
from lumo_tpu_torch.color import wavelength as twl
from lumo_tpu_torch.integrators import path_trace as tpt
from lumo_tpu_torch.renderer import Renderer
from lumo_tpu_torch.sampling import samplers as tsamp

RES = 16
N_PIX = RES * RES
SPP = 8
N_SAMPLES = N_PIX * SPP


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The wavefronts here are small: intra-op threads gain nothing, and
    under parallel test workers every process's threads contend for the
    cores (a tenfold slowdown seen under ``-n 6``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_inputs(camera, idx):
    """``tests/test_stream.py::_sample_inputs`` in the port (idx int64)."""
    pix, spp = idx % N_PIX, idx // N_PIX
    px, py = (pix % RES).float(), (pix // RES).float()
    jx = tsamp._randfloat(pix, spp ^ 0x51633E2D)
    jy = tsamp._randfloat(pix, spp ^ 0x68BC21EB)
    raster = torch.stack([px + jx, py + jy], -1)
    o, d = camera.generate_ray(raster, torch.full_like(raster, 0.5))
    lam = twl.sample(tsamp._randfloat(pix, spp ^ 0x02E5BE93))
    rng = tsamp._hash_u32(pix ^ tsamp._hash_u32(spp ^ 0x9E3779B9))
    return {"o": o, "d": d, "lam": lam, "rng": rng, "samp": idx, "pix": pix}


def _jax_inputs(camera, idx):
    pix = (idx % N_PIX).astype(jnp.uint32)
    spp = (idx // N_PIX).astype(jnp.uint32)
    px, py = (pix % RES).astype(jnp.float32), (pix // RES).astype(jnp.float32)
    jx = jsamp._randfloat(pix, spp ^ jnp.uint32(0x51633E2D))
    jy = jsamp._randfloat(pix, spp ^ jnp.uint32(0x68BC21EB))
    raster = jnp.stack([px + jx, py + jy], -1)
    o, d = camera.generate_ray(raster, jnp.full(raster.shape, 0.5))
    lam = jwl.sample(jsamp._randfloat(pix, spp ^ jnp.uint32(0x02E5BE93)))
    rng = jsamp._hash_u32(pix ^ jsamp._hash_u32(spp ^ jnp.uint32(0x9E3779B9)))
    return {"o": o, "d": d, "lam": lam, "rng": rng, "samp": idx}


def _per_sample_fold(acc, term, st):
    """Scatter each terminated sample's radiance, depth and a count to its
    sample id."""
    rad, depth, cnt = acc
    samp = st["samp"]
    rad = rad.index_add(0, samp, torch.where(term[:, None], st["radiance"],
                                             0.0))
    depth = depth.index_add(0, samp, torch.where(term, st["depth"], 0))
    cnt = cnt.index_add(0, samp, term.to(torch.int32))
    return rad, depth, cnt


def _port_case(which):
    if which == "cornell":
        scene = port_scene_from_jax(jcornell_box().build())
        return scene, tcornell_camera(resolution=(RES, RES), device="cpu")
    scene = port_scene_from_jax(blob_box("lumo_tpu", 2).build())
    return scene, tbuild_camera(resolution=(RES, RES), device="cpu")


def _port_stream(scene, camera, lanes):
    acc0 = (torch.zeros((N_SAMPLES, 4)),
            torch.zeros(N_SAMPLES, dtype=torch.int32),
            torch.zeros(N_SAMPLES, dtype=torch.int32))
    return tpt.integrate_stream(scene, lambda i: _port_inputs(camera, i),
                                _per_sample_fold, acc0, lanes, N_SAMPLES)


@pytest.mark.parametrize("which", ["cornell", "bvh"])
def test_stream_matches_batch_bitexact(which):
    scene, camera = _port_case(which)
    rad, depth, cnt = _port_stream(scene, camera, 512)
    assert bool((cnt == 1).all())         # every sample traced and folded once
    for s in range(SPP):
        smp = _port_inputs(camera, torch.arange(N_PIX) + s * N_PIX)
        r, _, dep = tpt.integrate(scene, smp["o"], smp["d"], smp["lam"],
                                  ray_key=smp["rng"])
        rows = slice(s * N_PIX, (s + 1) * N_PIX)
        assert torch.equal(rad[rows], r), s
        assert torch.equal(depth[rows], dep), s
    assert int(depth.max()) >= tpt.RR_DEPTH   # Russian roulette ran


def test_stream_counts_all_samples():
    scene, camera = _port_case("cornell")
    iterations = []

    def fold(acc, term, st):
        iterations.append(1)
        return acc + term.sum()

    n = tpt.integrate_stream(scene, lambda i: _port_inputs(camera, i), fold,
                             torch.zeros((), dtype=torch.int64), 300,
                             N_SAMPLES)
    assert int(n) == N_SAMPLES
    # far fewer wavefront iterations than one batch of 300 lanes per
    # bounce loop would take
    assert len(iterations) < N_SAMPLES // 300 * 8


def test_stream_matches_jax():
    """Per sample against JAX's ``integrate_stream`` on the Cornell box
    with 512 lanes: depth equal and radiance within (1e-4, 1e-5) on all
    but under 1% of the samples."""
    js = jcornell_box().build()
    jc = jcornell_camera(resolution=(RES, RES))

    def jfold(acc, term, st):
        samp = jnp.where(term, st["samp"], jnp.uint32(N_SAMPLES))
        rad, dep = acc
        rad = rad.at[samp].add(jnp.where(term[:, None], st["radiance"], 0.0),
                               mode="drop")
        dep = dep.at[samp].add(jnp.where(term, st["depth"], 0), mode="drop")
        return rad, dep

    acc0 = (jnp.zeros((N_SAMPLES, 4), jnp.float32),
            jnp.zeros((N_SAMPLES,), jnp.int32))
    rad_j, dep_j = jax.jit(lambda a: jpt.integrate_stream(
        js, lambda i: _jax_inputs(jc, i), jfold, a, 512, N_SAMPLES))(acc0)
    rad_j, dep_j = np.asarray(rad_j), np.asarray(dep_j)
    scene, camera = _port_case("cornell")
    rad, depth, _ = _port_stream(scene, camera, 512)
    close = (np.isclose(rad.numpy(), rad_j, rtol=1e-4, atol=1e-5).all(axis=1)
             & (depth.numpy() == dep_j))
    assert (~close).sum() <= N_SAMPLES // 100, (~close).sum()
    assert (rad_j.sum(axis=1) > 0).mean() > 0.25


def test_renderer_stream_matches_batch():
    scene, camera = _port_case("cornell")
    r = lambda: Renderer(scene, camera).samples(8).seed(3).fixed_rr_delta(0.25)
    img_b = r().render(verbose=False)
    img_s = r().stream().render(verbose=False)
    assert img_s.shape == (RES, RES, 3) and np.isfinite(img_s).all()
    assert img_s.mean() > 0.01
    np.testing.assert_allclose(img_s, img_b, rtol=1e-5, atol=1e-6)
    # stream(False) goes back to batch mode
    np.testing.assert_array_equal(r().stream().stream(False).render(
        verbose=False), img_b)


def test_renderer_stream_adaptive_rr(capsys):
    """Adaptive Russian roulette rides the stream (the per-pixel delta from
    the running stats, every iteration): unbiased, so the image agrees
    with a fixed-threshold stream render within Monte Carlo noise, as
    ``tests/test_stream.py::test_renderer_stream_adaptive_rr`` checks."""
    js = jcornell_box().build()
    scene = port_scene_from_jax(js)
    cam = tcornell_camera(resolution=(8, 8), device="cpu")
    spp = 256
    img_a = Renderer(scene, cam).samples(spp).seed(5).stream().render()
    assert "(stream)" in capsys.readouterr().out
    img_f = (Renderer(scene, cam).samples(spp).seed(6).fixed_rr_delta(0.25)
             .stream().render(verbose=False))
    assert np.isfinite(img_a).all()
    m = img_f.max(axis=2) < 5.0          # leave out the light's pixels
    rel = np.abs(img_a[m] - img_f[m]).mean() / img_f[m].mean()
    assert rel < 0.15, rel
