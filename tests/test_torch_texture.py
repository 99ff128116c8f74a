"""The port's textures against the JAX package's: the packed tables are
equal (the Perlin lattice comes from the same numpy seed), and
``albedo`` of every kind (solid, checkerboard nested two deep, marble,
image, Mandelbrot, an invalid id) and ``normal_at`` agree at the same
uv and wavelengths, within rtol 1e-5 and atol 1e-6 (float32 ``sin``,
``exp`` and sums in another order).  Mandelbrot's inside/outside test
may flip on the set's boundary: at most 1 lane in 1000 may differ."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import t
from lumo_tpu import texture as jtex
from lumo_tpu.color import wavelength as jwl
from lumo_tpu_torch import texture as ttex

N = 3000


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small wavefronts: intra-op threads only contend under parallel
    test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _registry(mod):
    rng = np.random.default_rng(3)
    reg = mod.Textures()
    ids = {"solid": reg.solid((0.2, 0.5, 0.7))}
    inner = reg.checkerboard((0.9, 0.1, 0.1), (0.1, 0.9, 0.1), 3.0)
    ids["checker"] = reg.checkerboard(inner, (0.1, 0.1, 0.9), 7.0)
    ids["marble"] = reg.marble((0.9, 0.85, 0.8))
    ids["image"] = reg.image(rng.uniform(0, 1, (7, 5, 3)))
    ids["mandelbrot"] = reg.mandelbrot()
    normals = rng.normal(size=(6, 4, 3))
    normals[..., 2] = np.abs(normals[..., 2]) + 1.0
    nm = reg.normal_map(normals / np.linalg.norm(normals, axis=-1,
                                                 keepdims=True))
    return reg, ids, nm


@pytest.fixture(scope="module")
def tables():
    reg_j, ids, nm = _registry(jtex)
    reg_t, ids_t, nm_t = _registry(ttex)
    assert ids == ids_t and nm == nm_t
    tex_j = reg_j.pack()
    host = reg_t.pack()
    tex_t = {k: t(v).to(torch.int64 if v.dtype == np.int32 else None)
             for k, v in host.items()}
    return tex_j, tex_t, host, ids, nm


def _inputs(seed):
    rng = np.random.default_rng(seed)
    uv = rng.uniform(-2.0, 3.0, (N, 2)).astype(np.float32)
    lam = np.asarray(jwl.sample(jnp.asarray(
        rng.uniform(0, 1, N).astype(np.float32))))
    return uv, lam


def test_pack_matches_jax(tables):
    tex_j, _, host, _, _ = tables
    assert set(host) == set(tex_j)
    for k, v in tex_j.items():
        np.testing.assert_array_equal(host[k], np.asarray(v), err_msg=k)


@pytest.mark.parametrize("kind", ["solid", "checker", "marble", "image",
                                  "mandelbrot", "invalid", "mixed"])
def test_albedo_matches_jax(tables, kind):
    tex_j, tex_t, _, ids, _ = tables
    uv, lam = _inputs(7)
    if kind == "mixed":
        tid = np.random.default_rng(1).choice(
            [-1] + list(ids.values()), N).astype(np.int32)
    else:
        tid = np.full(N, -1 if kind == "invalid" else ids[kind], np.int32)
    kinds = tuple(sorted(set(np.asarray(tex_j["kind"]).tolist())))
    ref = np.asarray(jtex.albedo(tex_j, jnp.asarray(tid), jnp.asarray(lam),
                                 jnp.asarray(uv), kinds=kinds))
    got = ttex.albedo(tex_t, t(tid), t(lam), t(uv), kinds=kinds).numpy()
    assert got.shape == (N, 4) and np.isfinite(got).all()
    close = np.isclose(got, ref, rtol=1e-5, atol=1e-6).all(-1)
    allowed = N // 1000 if kind in ("mandelbrot", "mixed") else 0
    assert (~close).sum() <= allowed, np.nonzero(~close)[0][:10]
    if kind == "invalid":
        assert (got == 1.0).all()
    if kind in ("checker", "marble", "mandelbrot"):
        assert got.std() > 0.01          # the texture varies over uv


def test_normal_at_matches_jax(tables):
    tex_j, tex_t, _, _, nm = tables
    uv, _ = _inputs(8)
    ids = np.where(np.arange(N) % 3 == 0, -1, nm).astype(np.int32)
    ref = np.asarray(jtex.normal_at(tex_j, jnp.asarray(ids), jnp.asarray(uv)))
    got = ttex.normal_at(tex_t, t(ids), t(uv)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, rtol=1e-5)
    assert (got[ids < 0] == [0.0, 0.0, 1.0]).all()


def test_normal_mapped_hits_match_jax():
    """``intersect`` perturbs the shading normal of a normal-mapped
    material in its per-hit frame, as the JAX package does (a quad with a
    normal map, rays from above; rtol 1e-5).  The port's table also holds
    normal maps without an albedo texture, which the JAX package's does
    not (``Textures.pack`` returns None)."""
    import importlib

    from _torch_port import port_scene_from_jax
    from lumo_tpu.scene import trace as jtrace
    from lumo_tpu_torch.scene import trace as ttrace

    def quad(pkg, solid=True):
        M = importlib.import_module(f"{pkg}.scene.materials").Material
        sb = importlib.import_module(f"{pkg}.scene.scene").SceneBuilder()
        if solid:   # the JAX package packs no texture table without one
            sb.textures.solid(0.5)
        rng = np.random.default_rng(9)
        normals = rng.normal(size=(5, 7, 3))
        normals[..., 2] = np.abs(normals[..., 2]) + 0.5
        nm = sb.textures.normal_map(
            normals / np.linalg.norm(normals, axis=-1, keepdims=True))
        m = M.diffuse((0.5, 0.5, 0.5))
        m.nm_tex = nm
        sb.add_rectangle([-1.0, 0.0, -1.0], [-1.0, 0.0, 1.0],
                         [1.0, 0.0, 1.0], m)
        sb.add_rectangle([-1.0, 0.5, -3.0], [-1.0, 0.5, -2.0],
                         [1.0, 0.5, -2.0], M.diffuse((0.5, 0.5, 0.5)))
        return sb

    js = quad("lumo_tpu").build()
    ts = port_scene_from_jax(js)
    assert ts.n_normal_maps == js.n_normal_maps == 1
    own = quad("lumo_tpu_torch", solid=False).build(device="cpu")
    assert own.n_normal_maps == 1 and own.textures["kind"].shape == (1,)
    rng = np.random.default_rng(10)
    o = np.stack([rng.uniform(-1, 1, N), np.full(N, 1.0),
                  rng.uniform(-3, 1, N)], -1).astype(np.float32)
    d = np.tile(np.array([[0.0, -1.0, 0.0]], np.float32), (N, 1))
    hj = jtrace.intersect(js, jnp.asarray(o), jnp.asarray(d))
    ht = ttrace.intersect(ts, t(o), t(d))
    assert torch.equal(ttrace.intersect(own, t(o), t(d))["ns"], ht["ns"])
    ok = np.asarray(hj["valid"])
    np.testing.assert_array_equal(ht["prim"].numpy(), np.asarray(hj["prim"]))
    np.testing.assert_allclose(ht["ns"].numpy()[ok], np.asarray(hj["ns"])[ok],
                               rtol=1e-5, atol=1e-6)
    mapped = ok & (np.asarray(hj["prim"]) < 2)
    assert mapped.sum() > N // 4
    # the mapped normals are perturbed, the plain quad's are not
    bent = np.abs(ht["ns"].numpy()[mapped] - ht["ng"].numpy()[mapped])
    assert bent.max() > 0.1
    plain = ok & ~mapped
    np.testing.assert_allclose(ht["ns"].numpy()[plain],
                               ht["ng"].numpy()[plain], atol=1e-6)
