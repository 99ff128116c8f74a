"""The port's homogeneous medium against the JAX package's, on
``examples/medium.py``'s scene (the Cornell box filled with a medium):
the free-flight draws are counter hashes of the same per-ray state and
salt (equal bit for bit; the distances differ by the last ulp of two
``log`` implementations, rtol 5e-7), and
``intersect`` (the medium pseudo-hit), ``occluded`` (shadow rays stopped
in the medium) and ``transmittance`` agree (masks and prims exactly,
floats within rtol 1e-5).  A scene with a medium refuses queries without
the per-ray state."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import example_scene, port_scene_from_jax, t
from lumo_tpu.color import wavelength as jwl
from lumo_tpu.scene import trace as jtrace
from lumo_tpu_torch.scene import trace as ttrace

N = 4096
SALT = 0xE7037ED1


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scenes():
    js = example_scene("lumo_tpu", "medium", 16)[0]
    ts = example_scene("lumo_tpu_torch", "medium", 16)[0]
    return js, ts


def _rays(seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform([60, 60, 60], [490, 490, 490], (N, 3)).astype(np.float32)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    key = rng.integers(0, 1 << 32, N, dtype=np.uint32)
    return o, d, key


def test_build_matches_jax(scenes):
    js, ts = scenes
    carried = port_scene_from_jax(js)
    for s in (ts, carried):
        assert set(s.medium) == set(js.medium)
        for k, v in js.medium.items():
            np.testing.assert_allclose(s.medium[k].numpy(), np.asarray(v),
                                       rtol=1e-7, err_msg=k)
        # the phase function is one more material row
        assert int(s.medium["mat"]) == len(js.materials["kind"]) - 1
        np.testing.assert_array_equal(s.materials["kind"].numpy(),
                                      np.asarray(js.materials["kind"]))
        np.testing.assert_allclose(s.materials["t_scale"].numpy(),
                                   np.asarray(js.materials["t_scale"]))


def test_free_flight_bit_exact(scenes):
    from lumo_tpu.sampling.samplers import _randfloat as jrand
    from lumo_tpu_torch.sampling.samplers import _randfloat as trand
    js, ts = scenes
    _, _, key = _rays(1)
    for mix in (0x94D049BB, 0xBF58476D):     # the two draws' salts
        np.testing.assert_array_equal(
            trand(t(key), SALT ^ mix).numpy(),
            np.asarray(jrand(jnp.asarray(key), jnp.uint32(SALT ^ mix))))
    t_j, has_j = jtrace._medium_free_flight(js, None, (N,),
                                            rng=jnp.asarray(key), salt=SALT)
    t_t, has_t = ttrace._medium_free_flight(ts, t(key), SALT)
    np.testing.assert_array_equal(has_t.numpy(), np.asarray(has_j))
    np.testing.assert_allclose(t_t.numpy(), np.asarray(t_j), rtol=5e-7,
                               atol=0.0)
    assert np.asarray(has_j).all() and 0 < float(np.median(t_j)) < np.inf


def test_intersect_and_occluded_with_medium(scenes):
    js, ts = scenes
    o, d, key = _rays(2)
    hj = jtrace.intersect(js, jnp.asarray(o), jnp.asarray(d),
                          rng=jnp.asarray(key), salt=SALT)
    ht = ttrace.intersect(ts, t(o), t(d), rng=t(key), salt=SALT)
    med = np.asarray(hj["is_medium"])
    assert 0.1 < med.mean() < 0.9          # some rays scatter in the medium
    for k in ("valid", "prim", "mat", "is_medium", "backface", "light"):
        np.testing.assert_array_equal(ht[k].numpy(), np.asarray(hj[k]),
                                      err_msg=k)
    ok = np.asarray(hj["valid"])
    for k in ("t", "p", "ng", "ns", "uv", "err"):
        np.testing.assert_allclose(ht[k].numpy()[ok], np.asarray(hj[k])[ok],
                                   rtol=1e-5, atol=1e-4, err_msg=k)
    assert (ht["ns"].numpy()[med] == [0.0, 0.0, 1.0]).all()
    t_max = np.random.default_rng(3).uniform(1.0, 600.0, N).astype(
        np.float32)
    occ_j = np.asarray(jtrace.occluded(js, jnp.asarray(o), jnp.asarray(d),
                                       jnp.asarray(t_max),
                                       rng=jnp.asarray(key), salt=7))
    occ_t = ttrace.occluded(ts, t(o), t(d), t(t_max), rng=t(key),
                            salt=7).numpy()
    np.testing.assert_array_equal(occ_t, occ_j)
    assert 0.05 < occ_j.mean() < 0.95


def test_transmittance(scenes):
    js, ts = scenes
    rng = np.random.default_rng(4)
    lam = np.array(jwl.sample(jnp.asarray(
        rng.uniform(0, 1, N).astype(np.float32))))
    lam[: N // 8, 1:] = 0.0                   # terminated wavelengths
    tt = rng.uniform(0.0, 2000.0, N).astype(np.float32)
    tt[: N // 16] = np.inf                    # misses
    ref = np.asarray(jtrace.transmittance(js, jnp.asarray(lam),
                                          jnp.asarray(tt)))
    got = ttrace.transmittance(ts, t(lam), t(tt)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-7)
    assert (ref != 1.0).any()
    # without a medium: ones
    from _torch_port import blob_box
    plain = blob_box("lumo_tpu_torch", 1).build(device="cpu")
    assert (ttrace.transmittance(plain, t(lam), t(tt)) == 1.0).all()


def test_queries_need_the_ray_state(scenes):
    _, ts = scenes
    o, d, _ = _rays(5)
    with pytest.raises(ValueError, match="medium"):
        ttrace.intersect(ts, t(o), t(d))
    with pytest.raises(ValueError, match="medium"):
        ttrace.occluded(ts, t(o), t(d), torch.full((N,), 10.0))


def test_stream_equals_batch_with_glass_and_medium():
    """The three drivers share ``bounce``: on the glass-sphere, disk-light
    medium scene, each sample's stream radiance equals its batch radiance
    bit for bit (4x4 pixels, 8 samples each, through 32 lanes)."""
    from _torch_port import glass_medium_scene
    from lumo_tpu_torch.camera import build_camera
    from lumo_tpu_torch.color import wavelength
    from lumo_tpu_torch.integrators import path_trace
    from lumo_tpu_torch.sampling.samplers import _hash_u32, _randfloat
    scene = glass_medium_scene("lumo_tpu_torch").build(device="cpu")
    cam = build_camera(origin=(0.0, 0.1, 0.6), towards=(0.0, -0.4, -2.0),
                       resolution=(4, 4), device="cpu")
    n = 4 * 4 * 8

    def gen(idx):
        pix = idx % 16
        raster = torch.stack([(pix % 4).float() + 0.5,
                              (pix // 4).float() + 0.5], -1)
        o, d = cam.generate_ray(raster, torch.full_like(raster, 0.5))
        return {"o": o, "d": d, "lam": wavelength.sample(_randfloat(idx, 7)),
                "rng": _hash_u32(idx), "samp": idx}

    def fold(acc, term, st):
        return acc.index_add(0, st["samp"], torch.where(
            term[:, None], st["radiance"], 0.0))

    idx = torch.arange(n)
    batch = gen(idx)
    r_b, _, _ = path_trace.integrate(scene, batch["o"], batch["d"],
                                     batch["lam"], ray_key=batch["rng"])
    r_s = path_trace.integrate_stream(scene, gen, fold,
                                      torch.zeros((n, 4)), 32, n)
    assert torch.equal(r_s, r_b)
    assert float(r_b.sum()) > 0.0
