"""Runtime instancing in the port against the JAX package, on the CPU.

Mirrors ``tests/test_instance.py`` on the same inputs: the subdiv-3 blob
instanced under ``TRANSFORMS`` (two instances: one query per instance),
4,096 seeded rays, 16^2 renders, and six instances for the flattened
N * I query.  Builder arrays must equal the JAX package's (integers
exactly, floats to rtol 1e-6); hits keep the prim exactly and t, p, ng,
ns, uv within rtol 1e-5, atol 1e-6, lanes beyond counted as flips (at
most 0.5%); occlusion is bit for bit.  The JAX group walk recomputes the
winner's t from its triangle where the port keeps the walk's own, hence
a tolerance on t.  The groups' BVHs go through the plain version of K2
here (``accel/bvh_kernel.py``), as every walk of the CPU tests does.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import INST_FIELDS, port_scene_from_jax, t
from lumo_tpu.scene import trace as jtrace
from lumo_tpu.scene.instance import rotate_y, scale, translation
from lumo_tpu_torch.camera import build_camera as tbuild_camera
from lumo_tpu_torch.integrators import path_trace as tpt
from lumo_tpu_torch.renderer import Renderer as TRenderer
from lumo_tpu_torch.scene import trace as ttrace

TRANSFORMS = [
    translation(1.5, 0.0, 0.0) @ rotate_y(0.8),
    translation(-1.2, 0.4, -0.6) @ scale(0.7, 1.3, 0.9),
]
# tests/test_instance.py::test_many_instances_flattened_path's six
FLAT = [translation(-1.2 + 0.45 * i, -0.3 + 0.1 * (i % 3), -1.6)
        @ rotate_y(0.5 * i) @ scale(0.35, 0.45, 0.35) for i in range(6)]
FLIP_SHARE = 200           # at most 1 / FLIP_SHARE of the lanes may flip


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small wavefronts: intra-op threads only contend under -n 6."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _mats(pkg):
    M = _mod(pkg, "scene.materials").Material
    return [M.diffuse((0.8, 0.2, 0.2)), M.metal((0.9, 0.8, 0.3), 0.2, 2.5,
                                                3.0)]


def _blob(pkg, subdiv=3, seed=2, amp=0.2):
    v, f, vn = _mod(pkg, "scene.shapes").blob(subdiv=subdiv, seed=seed,
                                              amp=amp)
    return _mod(pkg, "scene.instance").Mesh(v, f, normals=vn)


def instanced_builder(pkg, transforms=TRANSFORMS):
    """``tests/test_instance.py::_instanced_scene``'s builder in ``pkg``
    (materials cycling diffuse, metal)."""
    mats = _mats(pkg)
    sb = _mod(pkg, "scene.scene").SceneBuilder()
    _blob(pkg).add_instances_to(sb, transforms,
                                [mats[i % 2] for i in range(len(transforms))])
    M = _mod(pkg, "scene.materials").Material
    sb.add_sphere((0.0, 50.0, 0.0), 1.0, M.light((1, 1, 1)))
    return sb


def baked_builder(pkg, transforms=TRANSFORMS):
    """The same instances baked with ``Mesh.add_to``."""
    mats = _mats(pkg)
    sb = _mod(pkg, "scene.scene").SceneBuilder()
    for i, m in enumerate(transforms):
        _blob(pkg).apply(m).add_to(sb, mats[i % 2])
    M = _mod(pkg, "scene.materials").Material
    sb.add_sphere((0.0, 50.0, 0.0), 1.0, M.light((1, 1, 1)))
    return sb


def _rays(targets, n=4096, seed=0):
    """``tests/test_instance.py::_rays``: n rays from the box [-4, 4]^3
    towards the instances' centres with Gaussian spread."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-4, 4, (n, 3)).astype(np.float32)
    target = np.asarray(targets)[rng.integers(0, len(targets), n)]
    d = target + rng.normal(size=(n, 3)) * 0.6 - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d.astype(np.float32)


def _centres(transforms):
    return [np.asarray(m)[:3, 3] for m in transforms]


@pytest.fixture(scope="module", params=["per_instance", "flattened"])
def pair(request):
    """(JAX scene, port scene built by the port, rays) of two instances
    (one query per instance) or six (one flattened query)."""
    tr = TRANSFORMS if request.param == "per_instance" else FLAT
    js = instanced_builder("lumo_tpu", tr).build()
    ts = instanced_builder("lumo_tpu_torch", tr).build(device="cpu")
    return js, ts, _rays(_centres(tr))


def _group_arrays(g):
    out = {k: g[k] for k in INST_FIELDS}
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in out.items()}


def test_builder_matches_jax_and_shares_geometry(pair):
    """One copy of the blob per group, the same tables as the JAX
    builder's (and as carried by ``from_numpy``)."""
    js, ts, _ = pair
    carried = port_scene_from_jax(js)
    I = js.inst[0]["minv"].shape[0]
    assert len(ts.inst) == len(js.inst) == 1
    assert ts.n_tris == js.n_tris == 0          # nothing baked
    Tg = ts.inst[0]["a"].shape[0]
    assert ts.n_inst_prims == js.n_inst_prims == carried.n_inst_prims \
        == I * Tg
    for port in (ts, carried):
        got, want = _group_arrays(port.inst[0]), _group_arrays(js.inst[0])
        for k in INST_FIELDS:
            if want[k].dtype.kind in "iu":
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            else:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-6,
                                           err_msg=k)
        np.testing.assert_allclose(port.bounds.numpy(), np.asarray(js.bounds),
                                   rtol=1e-6)
    # the group BVH in the kernel's layout, from the same tables
    assert torch.equal(carried.inst[0]["bvh"]["nodes"],
                       ts.inst[0]["bvh"]["nodes"])
    assert carried.inst[0]["bvh"]["depth"] == ts.inst[0]["bvh"]["depth"]
    moved = ts.to("cpu")
    assert torch.equal(moved.inst[0]["bvh"]["tris"], ts.inst[0]["bvh"]["tris"])


def _flips(got, want, valid, rtol=1e-5, atol=1e-6):
    bad = ~np.isclose(got[valid], want[valid], rtol=rtol, atol=atol)
    return int(bad.reshape(bad.shape[0], -1).any(axis=1).sum())


def test_intersect_matches_jax(pair):
    js, ts, (o, d) = pair
    n = o.shape[0]
    hj = jtrace.intersect(js, jnp.asarray(o), jnp.asarray(d),
                          rng=jnp.arange(n, dtype=jnp.uint32))
    ht = ttrace.intersect(ts, t(o), t(d), rng=torch.arange(n))
    valid = np.asarray(hj["valid"])
    np.testing.assert_array_equal(ht["valid"].numpy(), valid)
    assert valid.sum() > 300
    np.testing.assert_array_equal(ht["prim"].numpy(), np.asarray(hj["prim"]))
    np.testing.assert_array_equal(ht["mat"].numpy()[valid],
                                  np.asarray(hj["mat"])[valid])
    np.testing.assert_array_equal(ht["light"].numpy(), np.asarray(hj["light"]))
    for k in ("t", "p", "ng", "ns", "uv"):
        flips = _flips(ht[k].numpy(), np.asarray(hj[k]), valid)
        assert flips <= n // FLIP_SHARE, (k, flips)


def test_group_walks_honour_t_max(pair):
    """Unlike the JAX package's (ROADMAP.md section 3), the port's group
    walks honour ``t_max``: dead lanes miss, and with t_max = 2 a lane
    hits only below it, where it equals the JAX hit."""
    js, ts, (o, d) = pair
    n = o.shape[0]
    dead = ttrace.intersect(ts, t(o), t(d), rng=torch.arange(n),
                            alive=torch.zeros(n, dtype=torch.bool))
    assert not bool(dead["valid"].any())
    ht = ttrace.intersect(ts, t(o), t(d), t_max=torch.full((n,), 2.0),
                          rng=torch.arange(n))
    hj = jtrace.intersect(js, jnp.asarray(o), jnp.asarray(d),
                          rng=jnp.arange(n, dtype=jnp.uint32))
    near = np.asarray(hj["t"]) < 2.0
    assert near.sum() > 50
    np.testing.assert_array_equal(ht["valid"].numpy(), near)
    np.testing.assert_array_equal(ht["prim"].numpy()[near],
                                  np.asarray(hj["prim"])[near])


def test_occluded_matches_jax(pair):
    """Bit for bit, with finite and infinite t_max."""
    js, ts, (o, d) = pair
    n = o.shape[0]
    t_max = np.where(np.arange(n) % 3 == 0, np.inf,
                     np.linspace(0.5, 6.0, n)).astype(np.float32)
    occ_j = np.asarray(jtrace.occluded(js, jnp.asarray(o), jnp.asarray(d),
                                       jnp.asarray(t_max)))
    occ_t = ttrace.occluded(ts, t(o), t(d), t(t_max)).numpy()
    np.testing.assert_array_equal(occ_t, occ_j)
    assert 0.05 < occ_t.mean() < 0.95


def test_instanced_occlusion():
    """``tests/test_instance.py::test_instanced_occlusion`` on the port:
    the first instance blocks shadow rays; rays past it do not."""
    ts = instanced_builder("lumo_tpu_torch").build(device="cpu")
    n = 512
    rng = np.random.default_rng(5)
    o = np.tile(np.array([1.5, 0.0, -5.0], np.float32), (n, 1))
    o[:, :2] += rng.normal(size=(n, 2)).astype(np.float32) * 0.2
    d = np.tile(np.array([0.0, 0.0, 1.0], np.float32), (n, 1))
    tm = torch.full((n,), 10.0)
    assert float(ttrace.occluded(ts, t(o), t(d), tm).float().mean()) > 0.6
    o2 = o + np.array([50.0, 0.0, 0.0], np.float32)
    assert not bool(ttrace.occluded(ts, t(o2), t(d), tm).any())


@pytest.mark.parametrize("transforms", ["per_instance", "flattened"])
def test_instanced_matches_baked(transforms):
    """The port's instanced hits against its own baked scene
    (``tests/test_instance.py::test_instanced_matches_baked``'s bounds)."""
    tr = TRANSFORMS if transforms == "per_instance" else FLAT
    si = instanced_builder("lumo_tpu_torch", tr).build(device="cpu")
    sb = baked_builder("lumo_tpu_torch", tr).build(accel="none",
                                                   device="cpu")
    o, d = (t(x) for x in _rays(_centres(tr)))
    rng = torch.arange(o.shape[0])
    hi = ttrace.intersect(si, o, d, rng=rng)
    hb = ttrace.intersect(sb, o, d, rng=rng)
    vi, vb = hi["valid"].numpy(), hb["valid"].numpy()
    assert (vi == vb).mean() > 0.999
    sel = vi & vb
    assert sel.sum() > 300
    np.testing.assert_allclose(hi["t"].numpy()[sel], hb["t"].numpy()[sel],
                               rtol=5e-4, atol=5e-4)
    assert (hi["mat"].numpy()[sel] == hb["mat"].numpy()[sel]).mean() > 0.999
    np.testing.assert_allclose(hi["p"].numpy()[sel], hb["p"].numpy()[sel],
                               rtol=1e-3, atol=2e-3)
    dots = (hi["ng"].numpy()[sel] * hb["ng"].numpy()[sel]).sum(-1)
    assert np.quantile(dots, 0.001) > 0.99


# ---------------------------------------------------------------------------
# gradients

DEPTH = 3
RES = 8


def _grad_builder(pkg, transforms):
    """The instanced blobs on a floor under a rectangle light (triangle
    lights: no sphere, whose masked lanes give the JAX package NaN camera
    gradients, ROADMAP.md section 3)."""
    M = _mod(pkg, "scene.materials").Material
    sb = _mod(pkg, "scene.scene").SceneBuilder()
    mats = _mats(pkg)
    _blob(pkg).add_instances_to(sb, transforms,
                                [mats[i % 2] for i in range(len(transforms))])
    sb.add_rectangle((-4, -1.2, -4), (4, -1.2, -4), (-4, -1.2, 3),
                     M.diffuse((0.6, 0.6, 0.6)))
    sb.add_rectangle((-1, 3, -2), (1, 3, -2), (1, 3, 0),
                     M.light((1, 1, 1), scale=8.0))
    return sb


def _grad_inputs(seed):
    n = RES * RES
    rng = np.random.default_rng(seed)
    raster = rng.uniform(0, RES, (n, 2)).astype(np.float32)
    u_lam = rng.uniform(0, 1, n).astype(np.float32)
    key = rng.integers(0, 1 << 32, n, dtype=np.uint32)
    return raster, u_lam, key


@pytest.mark.parametrize("transforms", ["per_instance", "flattened"])
def test_material_and_camera_grads_match_jax(transforms):
    """Gradients of a fixed-depth render (depth 3, 8^2) with respect to
    every float material leaf and ``c2w_t`` equal ``jax.grad``'s within
    rtol 1e-4 plus 1e-5 of the largest entry; lanes whose prim sequences
    differ are counted (at most 1%) and, if any, weighted out of a second
    JAX gradient."""
    from lumo_tpu.camera import build_camera as jbuild_camera
    from lumo_tpu.color import wavelength as jwl
    from lumo_tpu.integrators import path_trace as jpt
    tr = TRANSFORMS if transforms == "per_instance" else FLAT
    js = _grad_builder("lumo_tpu", tr).build()
    ts = _grad_builder("lumo_tpu_torch", tr).build(device="cpu")
    cam = dict(origin=(0.0, 0.5, -5.5), towards=(0.0, 0.0, 0.0),
               resolution=(RES, RES))
    jc, tc = jbuild_camera(**cam), tbuild_camera(device="cpu", **cam)
    raster, u_lam, key = _grad_inputs(3)
    lam = np.asarray(jwl.sample(jnp.asarray(u_lam)))
    n = RES * RES

    def jax_render(weight, mats, c2w_t):
        scene = dataclasses.replace(js, materials={**js.materials, **mats})
        o, d = dataclasses.replace(jc, c2w_t=c2w_t).generate_ray(
            jnp.asarray(raster), jnp.full((n, 2), 0.5))
        r, _, _, prims = jpt.integrate(scene, o, d, jnp.asarray(lam),
                                       ray_key=jnp.asarray(key),
                                       fixed_depth=DEPTH, trace_prims=True)
        return jnp.sum(jnp.asarray(weight)[:, None] * r), prims

    def port_render(weight, mats, c2w_t):
        scene = dataclasses.replace(ts, materials={**ts.materials, **mats})
        o, d = dataclasses.replace(tc, c2w_t=c2w_t).generate_ray(
            t(raster), torch.full((n, 2), 0.5))
        r, _, _, prims = tpt.integrate(scene, o, d, t(lam), ray_key=t(key),
                                       fixed_depth=DEPTH, trace_prims=True)
        return (t(weight)[:, None] * r).sum(), prims

    mats_j = {k: v for k, v in js.materials.items()
              if jnp.issubdtype(v.dtype, jnp.floating)}

    def jax_grads(weight):
        return jax.grad(lambda m, c: jax_render(weight, m, c), argnums=(0, 1),
                        has_aux=True)(mats_j, jc.c2w_t)

    weight = np.ones(n, np.float32)
    (g_mats_j, g_cam_j), prims_j = jax_grads(weight)
    with torch.no_grad():
        _, prims_t = port_render(weight, {}, tc.c2w_t)
    same = (prims_t.numpy() == np.asarray(prims_j)).all(axis=0)
    assert (~same).sum() <= n // 100
    # the instances are on the paths
    assert (prims_t.numpy() >= ts.n_tris).any()
    if not same.all():
        weight = same.astype(np.float32)
        (g_mats_j, g_cam_j), _ = jax_grads(weight)
    mats = {k: v.clone().requires_grad_(True)
            for k, v in ts.materials.items() if v.is_floating_point()}
    c2w_t = tc.c2w_t.clone().requires_grad_(True)
    port_render(weight, mats, c2w_t)[0].backward()

    def close(got, want, what):
        want = np.asarray(want)
        scale_ = float(np.abs(want).max())
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-5 * max(scale_, 1e-30),
                                   err_msg=what)

    for k, g in g_mats_j.items():
        got = (np.zeros(g.shape, np.float32) if mats[k].grad is None
               else mats[k].grad.numpy())
        assert np.isfinite(got).all(), k
        close(got, g, k)
    close(c2w_t.grad.numpy(), g_cam_j, "c2w_t")
    assert float(np.abs(np.asarray(g_mats_j["kd"])).sum()) > 0.0
    assert float(np.abs(np.asarray(g_cam_j)).sum()) > 0.0


# ---------------------------------------------------------------------------
# instanced lights

QUAD_V = np.asarray([[-0.5, 0.0, -0.5], [0.5, 0.0, -0.5], [0.5, 0.0, 0.5],
                     [-0.5, 0.0, 0.5]])
QUAD_F = np.asarray([[0, 1, 2], [0, 2, 3]])


def test_light_instances_bake():
    """LIGHT-material instances are baked as world-space light triangles:
    light tables, no instanced group; as in the JAX package."""
    for pkg, kw in (("lumo_tpu", {}), ("lumo_tpu_torch", {"device": "cpu"})):
        sb = _mod(pkg, "scene.scene").SceneBuilder()
        M = _mod(pkg, "scene.materials").Material
        _blob(pkg).add_instances_to(sb, [np.eye(4)], [M.light((1, 1, 1))])
        s = sb.build(**kw)
        assert s.n_lights > 0 and not s.inst, pkg
    with pytest.raises(ValueError, match="singular instance transform"):
        instanced_builder("lumo_tpu_torch", [np.diag([1.0, 0.0, 1.0, 1.0])])


def _light_scenes(pkg, T, light_scale, floor_y, **kw):
    """(instanced, baked) scenes of one quad light under ``T`` above a
    floor."""
    M = _mod(pkg, "scene.materials").Material
    SB = _mod(pkg, "scene.scene").SceneBuilder
    light = M.light((1.0, 0.9, 0.8), scale=light_scale)
    floor = M.diffuse((0.7, 0.7, 0.7))
    out = []
    for instanced in (True, False):
        sb = SB()
        sb.add_rectangle((-3, floor_y, -4), (3, floor_y, -4),
                         (-3, floor_y, 2), floor)
        if instanced:
            sb.add_instanced_triangles(QUAD_V, QUAD_F, [T], [light])
        else:
            vw = QUAD_V @ np.asarray(T)[:3, :3].T + np.asarray(T)[:3, 3]
            sb.add_triangles(vw, QUAD_F, light)
        out.append(sb.build(**kw))
    return out


def test_instanced_light_matches_baked():
    """An instanced light's tables, sampled directions and pdfs equal the
    baked light's in the port, and the JAX package's."""
    from lumo_tpu.scene import trace as jt
    T = translation(0.2, 1.9, -1.1) @ rotate_y(0.6) @ scale(1.7, 1.0, 0.8)
    s_inst, s_bake = _light_scenes("lumo_tpu_torch", T, 5.0, -1,
                                   device="cpu")
    j_inst, _ = _light_scenes("lumo_tpu", T, 5.0, -1)
    assert s_inst.n_lights == s_bake.n_lights == 2
    np.testing.assert_allclose(s_inst.light_pdf.numpy(),
                               s_bake.light_pdf.numpy(), rtol=1e-6)
    np.testing.assert_array_equal(s_inst.tri_a.numpy(),
                                  np.asarray(j_inst.tri_a))
    np.testing.assert_allclose(s_inst.tri_a.numpy(), s_bake.tri_a.numpy(),
                               rtol=1e-6)
    xo = torch.tensor([[0.0, -0.5, -1.0]] * 64)
    u = torch.as_tensor(np.random.default_rng(0).uniform(
        0, 1, (64, 2)).astype(np.float32))
    li = torch.zeros(64, dtype=torch.int64)
    pdfs = []
    for s in (s_inst, s_bake):
        wi = ttrace.sample_towards(s, li, xo, u)
        lh = ttrace.light_hit(s, li, xo, wi)
        pdfs.append((wi, ttrace.sample_towards_pdf(s, li, xo, wi, lh["p"],
                                                   lh["ng"])))
    np.testing.assert_allclose(pdfs[0][0].numpy(), pdfs[1][0].numpy(),
                               atol=1e-6)
    np.testing.assert_allclose(pdfs[0][1].numpy(), pdfs[1][1].numpy(),
                               rtol=1e-5)
    wi_j = jt.sample_towards(j_inst, jnp.zeros(64, jnp.int32),
                             jnp.asarray(xo.numpy()), jnp.asarray(u.numpy()))
    np.testing.assert_allclose(pdfs[0][0].numpy(), np.asarray(wi_j),
                               atol=1e-6)


def test_instanced_light_renders():
    """A scene lit only by an instanced light renders non-black and equals
    the baked-light render (rtol 1e-5, atol 1e-6)."""
    T = translation(0.0, 0.75, -1.5) @ scale(0.8, 1.0, 0.8)
    cam = tbuild_camera(resolution=(16, 16), device="cpu")
    imgs = [TRenderer(s, cam).samples(16).seed(3).render(verbose=False)
            for s in _light_scenes("lumo_tpu_torch", T, 8.0, -0.79,
                                   device="cpu")]
    assert imgs[0].mean() > 1e-3
    np.testing.assert_allclose(imgs[0], imgs[1], rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# renders: the flattened route, the kd twin, the three integrators

def _flat_scene(instanced, accel="bvh"):
    """``tests/test_instance.py::test_many_instances_flattened_path``'s
    scene: six subdiv-2 blobs under a sphere light, instanced or baked."""
    from lumo_tpu_torch.scene.instance import Mesh
    from lumo_tpu_torch.scene.materials import Material
    from lumo_tpu_torch.scene.scene import SceneBuilder
    from lumo_tpu_torch.scene.shapes import blob
    rng = np.random.default_rng(4)
    ms = [Material.diffuse(tuple(rng.uniform(0.2, 0.9, 3))) for _ in FLAT]
    v, f, vn = blob(subdiv=2, seed=3, amp=0.15)
    sb = SceneBuilder()
    sb.add_sphere((0.0, 40.0, -1.0), 3.0, Material.light((1, 1, 1),
                                                         scale=60.0))
    if instanced:
        Mesh(v, f, normals=vn).add_instances_to(sb, FLAT, ms)
    else:
        for tr, m in zip(FLAT, ms):
            sb.add_triangles(v, f, m, normals=vn, vertex_normal_idx=f,
                             transform=tr)
    return sb.build(accel=accel, device="cpu")


def test_many_instances_flattened_path():
    """Six instances take the flattened query; the 16^2, 4-spp image
    equals the baked scene's within rtol 2e-2, atol 2e-3."""
    s_inst = _flat_scene(True)
    assert s_inst.inst and s_inst.inst[0]["minv"].shape[0] == 6
    assert s_inst.inst[0]["minv"].shape[0] >= ttrace.FLAT_MIN
    cam = tbuild_camera(resolution=(16, 16), device="cpu")
    img_i = TRenderer(s_inst, cam).samples(4).seed(2).render(verbose=False)
    img_b = TRenderer(_flat_scene(False), cam).samples(4).seed(2).render(
        verbose=False)
    assert np.isfinite(img_i).all()
    np.testing.assert_allclose(img_i, img_b, rtol=2e-2, atol=2e-3)


def test_kd_scene_groups_equal_bvh_twin():
    """A kd-tree scene's groups keep their own BVH (through K2's plain
    version here): its image equals the BVH-built scene's."""
    from lumo_tpu_torch.scene.cornell import empty_box
    from lumo_tpu_torch.scene.materials import Material
    scenes = {}
    for accel in ("kdtree", "bvh"):
        sb = empty_box((0.9, 0.9, 0.9), Material.diffuse((0.8, 0.2, 0.2)),
                       Material.diffuse((0.2, 0.8, 0.2)))
        (_blob("lumo_tpu_torch", 2).to_unit_size().scale_uniform(0.5)
         .to_origin().translate(0.0, 0.3, -1.4)
         .add_to(sb, Material.diffuse((0.5, 0.5, 0.5))))  # the scene's tree
        _blob("lumo_tpu_torch", 2).to_unit_size().scale_uniform(0.4) \
            .add_instances_to(sb, [translation(0.5, -0.5, -1.5),
                                   translation(-0.5, -0.5, -1.2)],
                              [Material.metal((0.9, 0.7, 0.1), 0.1, 2.5, 3.0),
                               Material.diffuse((0.2, 0.3, 0.8))])
        scenes[accel] = sb.build(accel=accel, device="cpu")
    assert scenes["kdtree"].kdtree is not None
    assert scenes["kdtree"].inst[0]["bvh"] is not None
    cam = tbuild_camera(resolution=(16, 16), device="cpu")
    imgs = {a: TRenderer(s, cam).samples(2).seed(1).fixed_rr_delta(1.0)
            .render(verbose=False) for a, s in scenes.items()}
    assert imgs["bvh"].mean() > 1e-3
    np.testing.assert_allclose(imgs["kdtree"], imgs["bvh"], rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("integrator", ["path", "direct", "bdpt"])
def test_integrators_render_instanced_scene(integrator):
    """The three integrators reach the groups through ``intersect`` and
    ``occluded`` only: each renders an instanced Cornell scene (both
    routes: two and six instances) finitely, and the instances show."""
    from lumo_tpu_torch.scene.cornell import empty_box
    from lumo_tpu_torch.scene.materials import Material
    sb = empty_box((0.9, 0.9, 0.9), Material.diffuse((0.8, 0.2, 0.2)),
                   Material.diffuse((0.2, 0.8, 0.2)))
    blob = _blob("lumo_tpu_torch", 2).to_unit_size().scale_uniform(0.3)
    blob.add_instances_to(sb, [translation(0.4, -0.6, -1.4),
                               translation(-0.4, -0.6, -1.6)],
                          [Material.glass(),
                           Material.diffuse((0.9, 0.9, 0.2))])
    blob.add_instances_to(sb, [translation(-0.75 + 0.3 * i, 0.2, -1.8)
                               for i in range(6)],
                          [Material.metal((0.9, 0.7, 0.1), 0.1, 2.5, 3.0)] * 6)
    scene = sb.build(device="cpu")
    assert [g["minv"].shape[0] for g in scene.inst] == [2, 6]
    cam = tbuild_camera(resolution=(16, 16), device="cpu")
    r = TRenderer(scene, cam).integrator(integrator).samples(2).seed(1)
    if integrator == "bdpt":
        r.bdpt_depth(4)
    img = r.render(verbose=False)
    assert img.shape == (16, 16, 3) and np.isfinite(img).all()
    assert img.mean() > 1e-3
