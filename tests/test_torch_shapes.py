"""The port's spheres, analytic shapes (plane, disk, cone, cylinder,
ellipsoid) and their lights against the JAX package's.

One scene holds all of them, with a sphere light, a disk light, a
triangle light and an environment light (the emissive sphere around the
scene).  Both builders give the same arrays; ``intersect`` and
``occluded`` agree on random rays (prims and masks exactly, floats
within rtol 1e-5, atol 1e-5 of the scene's unit scale), and so do the
light families: ``sample_towards``, ``light_hit``, ``sample_towards_pdf``
and ``light_area`` (rtol 1e-4: the sphere quadratic cancels at the far
side).  The geometry kernels are also held one by one: ``sphere_t``,
``sphere_detail``, ``analytic_t`` and ``analytic_detail`` per kind
(rtol 1e-4 for the analytic kinds, whose world-to-local rotation is a
cancelling sum for grazing rays), and the host frame helpers."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import SHAPE_FIELDS, SCENE_FIELDS, port_scene_from_jax, t
from lumo_tpu.geometry import analytic as jan
from lumo_tpu.geometry import intersect as jgeo
from lumo_tpu.scene import trace as jtrace
from lumo_tpu_torch.geometry import analytic as tan
from lumo_tpu_torch.geometry import intersect as tgeo
from lumo_tpu_torch.scene import instance as tinst
from lumo_tpu_torch.scene import trace as ttrace

N = 2048


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _builder(pkg):
    import importlib
    mod = lambda m: importlib.import_module(f"{pkg}.{m}")
    M = mod("scene.materials").Material
    inst = mod("scene.instance")
    sb = mod("scene.scene").SceneBuilder()
    grey = M.diffuse((0.6, 0.6, 0.6))
    sb.add_plane((0.0, -1.0, 0.0), (0.0, 1.0, 0.0), grey)
    sb.add_disk((0.0, 0.9, -1.0), (0.0, -1.0, 0.2), 0.3, M.light(4.0))
    sb.add_disk((1.5, 0.0, -2.0), (-1.0, 0.0, 0.0), 0.5, M.mirror())
    sb.add_cone(0.8, 0.3, M.metal((0.9, 0.6, 0.3), 0.2, 2.0, 3.0),
                transform=inst.translation(-1.0, -1.0, -2.0)
                @ inst.rotate_y(0.3))
    sb.add_cylinder(0.6, 0.25, M.diffuse((0.2, 0.7, 0.3)),
                    transform=inst.translation(0.8, -1.0, -1.5)
                    @ inst.scale(1.5, 1.5, 1.5))
    # a non-uniform scale: an ellipsoid
    sb.add_sphere((0.0, 0.0, 0.0), 0.3, M.glass(),
                  transform=inst.translation(-0.4, -0.5, -1.2)
                  @ inst.scale(1.0, 0.5, 1.5))
    # a uniform scale bakes into a sphere
    sb.add_sphere((0.0, 0.0, 0.0), 0.2, M.diffuse((0.8, 0.2, 0.2)),
                  transform=inst.translation(0.4, -0.6, -1.0)
                  @ inst.scale(2.0, 2.0, 2.0))
    sb.add_sphere((0.6, 0.6, -1.8), 0.15, M.light(2.0))
    sb.add_rectangle([-0.2, 0.99, -0.4], [-0.2, 0.99, -0.2],
                     [0.2, 0.99, -0.2], M.light(3.0))
    sb.set_environment_map(M.light(0.2))
    return sb


@pytest.fixture(scope="module")
def scenes():
    js = _builder("lumo_tpu").build()
    ts = _builder("lumo_tpu_torch").build(device="cpu")
    return js, ts, port_scene_from_jax(js)


def test_build_matches_jax(scenes):
    js, ts, carried = scenes
    assert (ts.n_tris, ts.n_spheres, ts.n_analytic, ts.n_ana_lights,
            ts.n_lights) == (js.n_tris, js.n_spheres, js.n_analytic,
                             js.n_ana_lights, js.n_lights) == (2, 3, 6, 1, 5)
    for k in SCENE_FIELDS + SHAPE_FIELDS:
        want = np.asarray(getattr(js, k))
        got = getattr(ts, k).numpy()
        if want.dtype.kind == "f":
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(got, want, err_msg=k)
        assert torch.equal(getattr(carried, k), getattr(ts, k)) or \
            want.dtype.kind == "f", k
    assert ts.kinds_present == carried.kinds_present


def _rays(js, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-1.5, 1.5, (N, 3)).astype(np.float32)
    o[:, 2] = rng.uniform(-0.5, 0.5, N)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d[:, 2] = -np.abs(d[:, 2])
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _close(got, want, what, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


def test_intersect_and_occluded_match_jax(scenes):
    js, _, ts = scenes
    o, d = _rays(js, 1)
    hj = jtrace.intersect(js, jnp.asarray(o), jnp.asarray(d))
    ht = ttrace.intersect(ts, t(o), t(d))
    prim = np.asarray(hj["prim"])
    np.testing.assert_array_equal(ht["prim"].numpy(), prim)
    # every family is hit: triangles, spheres and analytic shapes
    T, S = js.n_tris, js.n_spheres
    assert (prim < T).any() and ((prim >= T) & (prim < T + S)).any()
    assert len(np.unique(prim[prim >= T + S])) >= 5
    for k in ("valid", "mat", "backface", "light", "is_medium"):
        np.testing.assert_array_equal(ht[k].numpy(), np.asarray(hj[k]),
                                      err_msg=k)
    ok = np.asarray(hj["valid"])
    for k in ("t", "p", "ng", "ns", "uv", "err"):
        _close(ht[k].numpy()[ok], np.asarray(hj[k])[ok], k)
    t_max = np.where(np.arange(N) % 2 == 0, np.inf,
                     np.random.default_rng(2).uniform(0.1, 2.0, N)
                     ).astype(np.float32)
    occ_j = np.asarray(jtrace.occluded(js, jnp.asarray(o), jnp.asarray(d),
                                       jnp.asarray(t_max)))
    occ_t = ttrace.occluded(ts, t(o), t(d), t(t_max)).numpy()
    np.testing.assert_array_equal(occ_t, occ_j)
    assert 0 < occ_j.mean() < 1


def test_light_families_match_jax(scenes):
    js, _, ts = scenes
    rng = np.random.default_rng(3)
    xo = rng.uniform(-0.8, 0.8, (N, 3)).astype(np.float32)
    xo[:, 1] = rng.uniform(-0.9, 0.5, N)
    u = rng.uniform(0, 1, (N, 2)).astype(np.float32)
    light = rng.integers(0, js.n_lights, N)
    # each family is drawn: triangle, sphere (outside and the inside of
    # the environment sphere) and disk
    fam = np.asarray(js.light_prim)[light]
    assert len(np.unique(fam)) == js.n_lights
    args_j = (jnp.asarray(light), jnp.asarray(xo), jnp.asarray(u))
    args_t = (t(light), t(xo), t(u))
    wi_j = np.asarray(jtrace.sample_towards(js, *args_j))
    wi_t = ttrace.sample_towards(ts, *args_t)
    _close(wi_t.numpy(), wi_j, "sample_towards", rtol=1e-4, atol=1e-5)
    lh_j = jtrace.light_hit(js, jnp.asarray(light), jnp.asarray(xo),
                            jnp.asarray(wi_j))
    lh_t = ttrace.light_hit(ts, t(light), t(xo), t(wi_j))
    for k in ("valid", "mat", "backface"):
        np.testing.assert_array_equal(lh_t[k].numpy(), np.asarray(lh_j[k]),
                                      err_msg=k)
    ok = np.asarray(lh_j["valid"])
    assert ok.mean() > 0.9
    for k in ("t", "p", "ng", "uv"):
        _close(lh_t[k].numpy()[ok], np.asarray(lh_j[k])[ok], k, rtol=1e-4)
    pdf_j = np.asarray(jtrace.sample_towards_pdf(
        js, jnp.asarray(light), jnp.asarray(xo), jnp.asarray(wi_j),
        lh_j["p"], lh_j["ng"]))
    pdf_t = ttrace.sample_towards_pdf(ts, t(light), t(xo), t(wi_j),
                                      t(np.asarray(lh_j["p"])),
                                      t(np.asarray(lh_j["ng"]))).numpy()
    _close(pdf_t[ok], pdf_j[ok], "sample_towards_pdf", rtol=1e-4, atol=0.0)
    _close(ttrace.light_area(ts, t(light)).numpy(),
           np.asarray(jtrace.light_area(js, jnp.asarray(light))),
           "light_area", rtol=1e-6, atol=0.0)


# ---------------------------------------------------------------------------
# the geometry kernels one by one

def test_sphere_t_and_detail():
    rng = np.random.default_rng(5)
    center = rng.uniform(-1, 1, (7, 3)).astype(np.float32)
    radius = rng.uniform(0.1, 0.6, 7).astype(np.float32)
    o = rng.uniform(-2, 2, (N, 3)).astype(np.float32)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = rng.uniform(0.5, 4.0, (N, 1)).astype(np.float32)
    ref = np.asarray(jgeo.sphere_t(jnp.asarray(o), jnp.asarray(d),
                                   jnp.asarray(center)[None],
                                   jnp.asarray(radius)[None], 0.0,
                                   jnp.asarray(t_max)))
    got = tgeo.sphere_t(t(o), t(d), t(center)[None], t(radius)[None], 0.0,
                        t(t_max)).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref))
    assert np.isfinite(ref).any()
    _close(got[np.isfinite(ref)], ref[np.isfinite(ref)], "t")
    j = np.argmin(ref, axis=-1)
    tt = np.where(np.isfinite(ref.min(-1)), ref.min(-1), 1.0).astype(
        np.float32)
    dj = jgeo.sphere_detail(jnp.asarray(o), jnp.asarray(d), jnp.asarray(tt),
                            jnp.asarray(center[j]), jnp.asarray(radius[j]))
    dt = tgeo.sphere_detail(t(o), t(d), t(tt), t(center[j]), t(radius[j]))
    for k in dj:
        _close(dt[k].numpy(), np.asarray(dj[k]), k)


KINDS = {"plane": tan.PLANE, "disk": tan.DISK, "cone": tan.CONE,
         "cylinder": tan.CYLINDER, "ellipsoid": tan.SPHERE}


@pytest.mark.parametrize("name", list(KINDS))
def test_analytic_t_and_detail(name):
    kind = KINDS[name]
    rng = np.random.default_rng(kind)
    A = 4
    rots, trans = [], []
    for i in range(A):
        if kind == tan.SPHERE:
            m = np.diag(np.append(rng.uniform(0.5, 1.5, 3), 1.0))
            m[:3, 3] = rng.uniform(-1, 1, 3)
            c = rng.uniform(-0.2, 0.2, 3)
            rj, tj = jan.affine_frame(m, c, 0.4)
            for a, b in zip(tan.affine_frame(m, c, 0.4), (rj, tj)):
                np.testing.assert_array_equal(a, b)
        elif kind in (tan.PLANE, tan.DISK):
            n = rng.normal(size=3)
            rj = jan.frame_from_normal(n)
            np.testing.assert_array_equal(tan.frame_from_normal(n), rj)
            tj = rng.uniform(-1, 1, 3)
        else:
            m = tinst.rotate_x(rng.uniform(0, 3)) @ tinst.rotate_y(
                rng.uniform(0, 3))
            m[:3, 3] = rng.uniform(-1, 1, 3)
            rj, tj, s = jan.frame_from_transform(m)
            got = tan.frame_from_transform(m)
            np.testing.assert_array_equal(got[0], rj)
            assert got[2] == s
        rots.append(rj)
        trans.append(tj)
    rot = np.stack(rots).astype(np.float32)
    trn = np.stack(trans).astype(np.float32)
    radius = rng.uniform(0.3, 0.8, A).astype(np.float32)
    if kind == tan.SPHERE:
        radius[:] = 1.0
    height = rng.uniform(0.3, 1.0, A).astype(np.float32)
    kinds = np.full(A, kind, np.int32)
    o = rng.uniform(-2, 2, (N, 3)).astype(np.float32)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = np.full((N, 1), np.inf, np.float32)
    jargs = [jnp.asarray(x) for x in (kinds, rot, trn, radius, height)]
    targs = [t(x) for x in (kinds.astype(np.int64), rot, trn, radius, height)]
    ref = np.asarray(jan.analytic_t(jnp.asarray(o), jnp.asarray(d), *jargs,
                                    0.0, jnp.asarray(t_max)))
    got = tan.analytic_t(t(o), t(d), *targs, 0.0, t(t_max)).numpy()
    fin = np.isfinite(ref)
    assert fin.mean() > 0.02
    np.testing.assert_array_equal(np.isfinite(got), fin)
    # rtol 1e-4: a direction nearly parallel to a plane has a local z
    # that is a cancelling sum, whose rounding the far t magnifies
    _close(got[fin], ref[fin], "t", rtol=1e-4)
    j = np.argmin(ref, axis=-1)
    hit = fin.any(-1)
    tt = np.where(hit, ref.min(-1), 1.0).astype(np.float32)
    per = lambda x: x[j]
    dj = jan.analytic_detail(jnp.asarray(o), jnp.asarray(d), jnp.asarray(tt),
                             *(jnp.asarray(per(x)) for x in
                               (kinds, rot, trn, radius, height)))
    dt = tan.analytic_detail(t(o), t(d), t(tt),
                             *(t(per(x)) for x in (kinds.astype(np.int64),
                                                   rot, trn, radius, height)))
    for k in dj:
        a, b = dt[k].numpy()[hit], np.asarray(dj[k])[hit]
        atol = 1e-5
        if k == "uv" and kind == tan.PLANE:
            # fract of world coordinates up to ~1e3 (an ulp is 6e-5 there),
            # wrapping at 0 and 1
            a, b = np.minimum(np.abs(a - b), 1 - np.abs(a - b)), 0 * b
            atol = 1e-4
        _close(a, b, k, rtol=1e-4, atol=atol)


def test_inv3_matches_numpy():
    m = np.random.default_rng(0).normal(size=(64, 3, 3)).astype(np.float32)
    np.testing.assert_allclose(tan._inv3(t(m)).numpy(), np.linalg.inv(m),
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(tan._inv3(t(m)).numpy(),
                               np.asarray(jan._inv3(jnp.asarray(m))),
                               rtol=1e-6, atol=1e-6)


def test_sphere_instance_and_bad_transforms():
    m = tinst.translation(1.0, 2.0, 3.0) @ tinst.scale(2.0, 2.0, 2.0)
    c, r = tinst.sphere_instance((1.0, 0.0, 0.0), 0.5, m)
    np.testing.assert_allclose(c, [3.0, 2.0, 3.0])
    assert r == pytest.approx(1.0)
    with pytest.raises(ValueError):
        tinst.sphere_instance((0, 0, 0), 1.0, tinst.scale(1.0, 2.0, 1.0))
    with pytest.raises(ValueError, match="rigid"):
        tan.frame_from_transform(tinst.scale(1.0, 2.0, 1.0))
    from lumo_tpu_torch.scene.materials import Material
    from lumo_tpu_torch.scene.scene import SceneBuilder
    with pytest.raises(ValueError, match="only disks"):
        SceneBuilder().add_cone(1.0, 0.5, Material.light(1.0))
