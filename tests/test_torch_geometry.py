"""The port's ray-triangle arithmetic, ONB and warps against the JAX
package's on the same inputs (rtol 1e-6; hit/miss decisions exact)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lumo_tpu.geometry import intersect as jgeo
from lumo_tpu.geometry import onb as jonb
from lumo_tpu.sampling import maps as jmaps
from lumo_tpu_torch.geometry import intersect as tgeo
from lumo_tpu_torch.geometry import onb as tonb
from lumo_tpu_torch.sampling import maps as tmaps

RTOL = 1e-6


def _rays(N, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-2, 2, (N, 3)).astype(np.float32)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    # axis-aligned and exactly-zero components exercise the kz choice
    d[0] = [0.0, 0.0, -1.0]
    d[1] = [1.0, 0.0, 0.0]
    d[2] = [0.0, -1.0, 0.0]
    return o, d


def _tris(T, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1, 1, (T, 3)).astype(np.float32)
    b = a + rng.uniform(-0.5, 0.5, (T, 3)).astype(np.float32)
    c = a + rng.uniform(-0.5, 0.5, (T, 3)).astype(np.float32)
    return a, b, c


def test_ray_setup():
    _, d = _rays(4096, 0)
    kz_j, sh_j = jgeo.ray_setup(jnp.asarray(d))
    kz_t, sh_t = tgeo.ray_setup(torch.as_tensor(d))
    np.testing.assert_array_equal(kz_t.numpy(), np.asarray(kz_j))
    np.testing.assert_allclose(sh_t.numpy(), np.asarray(sh_j), rtol=RTOL)


@pytest.mark.parametrize("t_max", [np.inf, 1.5, "rows"])
def test_triangle_t(t_max):
    o, d = _rays(512, 1)
    a, b, c = _tris(300, 2)
    if t_max == "rows":
        tm = np.random.default_rng(3).uniform(0.0, 3.0, (512, 1))
        tm = tm.astype(np.float32)
        tm[:64] = 0.0                      # dead lanes
        tm_j, tm_t = jnp.asarray(tm), torch.as_tensor(tm)
    else:
        tm_j = tm_t = float(t_max)
    kz, sh = jgeo.ray_setup(jnp.asarray(d))
    tj, detj, ej = jgeo.triangle_t(jnp.asarray(o), kz, sh, a[None], b[None],
                                   c[None], 0.0, tm_j)
    kz2, sh2 = tgeo.ray_setup(torch.as_tensor(d))
    tt, dett, et = tgeo.triangle_t(torch.as_tensor(o), kz2, sh2,
                                   torch.as_tensor(a)[None],
                                   torch.as_tensor(b)[None],
                                   torch.as_tensor(c)[None], 0.0, tm_t)
    tj, tt = np.asarray(tj), tt.numpy()
    hit_j, hit_t = np.isfinite(tj), np.isfinite(tt)
    np.testing.assert_array_equal(hit_t, hit_j)
    assert hit_j.sum() > 100
    np.testing.assert_allclose(tt[hit_t], tj[hit_j], rtol=RTOL)
    np.testing.assert_allclose(dett.numpy(), np.asarray(detj), rtol=RTOL,
                               atol=1e-7)
    for x, y in zip(et, ej):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=RTOL,
                                   atol=1e-7)


def _detail_inputs(N, seed):
    """Rays aimed at points inside their own triangle."""
    rng = np.random.default_rng(seed)
    a, b, c = _tris(N, seed)
    w = rng.dirichlet([1.0, 1.0, 1.0], N).astype(np.float32)
    target = w[:, :1] * a + w[:, 1:2] * b + w[:, 2:3] * c
    o = target + rng.normal(size=(N, 3)).astype(np.float32)
    d = target - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    nrm = rng.normal(size=(3, N, 3)).astype(np.float32)
    nrm[:, : N // 4] = 0.0                  # no shading normals: ng
    uv = rng.uniform(0, 1, (3, N, 2)).astype(np.float32)
    return o, d, (a, b, c), nrm, uv


def test_triangle_detail():
    o, d, abc, nrm, uv = _detail_inputs(2048, 4)
    args = (o, d, *abc, *nrm, *uv)
    dj = jgeo.triangle_detail(*map(jnp.asarray, args))
    dt = tgeo.triangle_detail(*map(torch.as_tensor, args))
    for k in ("p", "ng", "ns", "uv", "err"):
        np.testing.assert_allclose(dt[k].numpy(), np.asarray(dj[k]),
                                   rtol=RTOL, atol=1e-6, err_msg=k)


def test_offset_ray_origin():
    o, d, abc, nrm, uv = _detail_inputs(2048, 5)
    det = jgeo.triangle_detail(*map(jnp.asarray, (o, d, *abc, *nrm, *uv)))
    p, err, ng = (np.array(det[k]) for k in ("p", "err", "ng"))
    wi = np.random.default_rng(6).normal(size=(2048, 3)).astype(np.float32)
    wi /= np.linalg.norm(wi, axis=-1, keepdims=True)
    xj = np.asarray(jgeo.offset_ray_origin(*map(jnp.asarray,
                                                (p, err, ng, wi))))
    xt = tgeo.offset_ray_origin(*map(torch.as_tensor, (p, err, ng, wi)))
    np.testing.assert_allclose(xt.numpy(), xj, rtol=RTOL, atol=1e-7)
    # the origin leaves the surface on wi's side
    side = np.sign(np.sum(wi * ng, -1))
    moved = np.sum((xt.numpy() - p) * ng, -1) * side
    assert np.all(moved >= 0.0)


def test_onb_roundtrip_and_frame():
    rng = np.random.default_rng(7)
    w = rng.normal(size=(1024, 3)).astype(np.float32)
    w /= np.linalg.norm(w, axis=-1, keepdims=True)
    v = rng.normal(size=(1024, 3)).astype(np.float32)
    uj, vj = jonb.onb_frame(jnp.asarray(w))
    ut, vt = tonb.onb_frame(torch.as_tensor(w))
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj), rtol=RTOL,
                               atol=1e-7)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=RTOL,
                               atol=1e-7)
    loc_j = jonb.to_local(jnp.asarray(w), jnp.asarray(v))
    loc_t = tonb.to_local(torch.as_tensor(w), torch.as_tensor(v))
    np.testing.assert_allclose(loc_t.numpy(), np.asarray(loc_j), rtol=1e-5,
                               atol=1e-6)
    back = tonb.to_world(torch.as_tensor(w), loc_t)
    np.testing.assert_allclose(back.numpy(), v, rtol=1e-5, atol=1e-5)


def test_square_to_cos_hemisphere():
    u = np.random.default_rng(8).uniform(0, 1, (4096, 2)).astype(np.float32)
    u[0] = [0.5, 0.5]                     # the disk centre
    hj = np.asarray(jmaps.square_to_cos_hemisphere(jnp.asarray(u)))
    ht = tmaps.square_to_cos_hemisphere(torch.as_tensor(u)).numpy()
    # the disk point's cos/sin come from two libraries and may differ by
    # an ulp; z = sqrt(1 - r^2) near the rim magnifies that to ~1e-6
    np.testing.assert_allclose(ht[:, :2], hj[:, :2], rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(ht[:, 2], hj[:, 2], rtol=RTOL, atol=1e-5)
    assert np.all(ht[:, 2] > 0.0)
