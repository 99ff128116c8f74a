"""The port's scene builder against the JAX package's: a subdiv-2 blob in
``empty_box`` (332 triangles, so the BVH branch and the split-out walls
both run) must give the same arrays, and a JAX scene carried over with
``from_numpy`` must come out unchanged."""
import numpy as np
import pytest
import torch

from _torch_port import (BVH_KEYS, INST_FIELDS, SCENE_FIELDS, SHAPE_FIELDS,
                         blob_box, jax_scene_arrays, port_scene_from_jax)
from lumo_tpu_torch.accel import bvh_kernel
from lumo_tpu_torch.scene import scene as tscene
from lumo_tpu_torch.scene.materials import Material


@pytest.fixture(scope="module")
def scenes():
    js = blob_box("lumo_tpu", 2).build()
    ts = blob_box("lumo_tpu_torch", 2).build(device="cpu")
    return js, ts


def test_build_matches_jax(scenes):
    js, ts = scenes
    assert ts.n_tris == js.n_tris == 332
    assert ts.n_bvh_tris == js.n_bvh_tris < ts.n_tris
    assert ts.n_lights == js.n_lights and ts.n_shadow_rays == js.n_shadow_rays
    for k in SCENE_FIELDS:
        np.testing.assert_array_equal(getattr(ts, k).numpy(),
                                      np.asarray(getattr(js, k)), err_msg=k)
    assert set(ts.materials) == set(js.materials)
    for k, v in js.materials.items():
        np.testing.assert_array_equal(ts.materials[k].numpy(), np.asarray(v),
                                      err_msg=k)
    # the port keeps the BVH only in the kernel's layout: it must be the
    # JAX tables and leaf-order triangles, packed
    _, bvh = jax_scene_arrays(js)
    np.testing.assert_array_equal(ts.bvh["nodes"].numpy(),
                                  bvh_kernel.pack_nodes(bvh))
    np.testing.assert_array_equal(ts.bvh["tris"].numpy(), bvh_kernel.pack_tris(
        *(np.asarray(getattr(js, f"tri_{k}"))[:js.n_bvh_tris] for k in "abc")))
    assert set(ts.bvh) == {"nodes", "tris", "depth"}


def test_from_numpy_roundtrip(scenes):
    js, ts = scenes
    fields, bvh = jax_scene_arrays(js)
    carried = port_scene_from_jax(js)
    for k in SCENE_FIELDS:
        np.testing.assert_array_equal(getattr(carried, k).numpy(), fields[k],
                                      err_msg=k)
    np.testing.assert_array_equal(carried.bvh["nodes"].numpy(),
                                  bvh_kernel.pack_nodes(bvh))
    assert set(bvh) == set(BVH_KEYS)
    # the BVH depth is recovered from the tables, and the kernel layout
    # equals the one the builder made
    assert carried.bvh["depth"] == ts.bvh["depth"]
    assert torch.equal(carried.bvh["nodes"], ts.bvh["nodes"])
    assert torch.equal(carried.bvh["tris"], ts.bvh["tris"])
    assert carried.kinds_present == ts.kinds_present
    # index tables widen to int64; float tables stay float32
    assert carried.tri_mat.dtype == torch.int64
    assert carried.tri_a.dtype == torch.float32


def test_scene_to_device(scenes):
    _, ts = scenes
    moved = ts.to("cpu")
    assert moved.device.type == "cpu"
    assert moved.bvh["depth"] == ts.bvh["depth"]
    assert torch.equal(moved.bvh["nodes"], ts.bvh["nodes"])


def test_small_scene_stays_dense():
    from lumo_tpu_torch.scene.cornell import empty_box
    sb = empty_box((0.9, 0.9, 0.9), Material.diffuse((0.8, 0.2, 0.2)),
                   Material.diffuse((0.2, 0.8, 0.2)))
    ts = sb.build(device="cpu")
    assert ts.bvh is None and ts.n_bvh_tris == ts.n_tris < 64


def test_kdtree_scene_builds():
    scene = blob_box("lumo_tpu_torch", 1).build(accel="kdtree", device="cpu")
    assert scene.kdtree is not None and scene.bvh is None
    with pytest.raises(ValueError, match="unknown accel"):
        blob_box("lumo_tpu_torch", 1).build(accel="octree", device="cpu")


def _part_scene(pkg, what):
    """The subdiv-1 blob box with one part of slice 5 or 7 added."""
    import importlib
    M = importlib.import_module(f"{pkg}.scene.materials").Material
    sb = blob_box(pkg, 1)
    if what == "sphere":
        sb.add_sphere((0.2, -0.5, -1.0), 0.3, M.diffuse((0.5, 0.5, 0.5)))
        sb.add_sphere((-0.4, 0.6, -1.2), 0.1, M.light(3.0))
    elif what == "glass":
        sb.add_box(M.glass())
    elif what == "medium":
        sb.set_medium((0.1, 0.1, 0.1), (0.1, 0.1, 0.1), 0.0)
    elif what == "instancing":
        inst = importlib.import_module(f"{pkg}.scene.instance")
        v, f, vn = importlib.import_module(f"{pkg}.scene.shapes").blob(
            subdiv=2, seed=3, amp=0.15)
        inst.Mesh(v, f, normals=vn).scale_uniform(0.2).add_instances_to(
            sb, [inst.translation(0.3 * i - 0.5, 0.4, -1.2) for i in range(3)],
            [M.diffuse((0.2, 0.3, 0.9)), M.glass(), M.light(2.0)])
    return sb


@pytest.mark.parametrize("what", ["sphere", "glass", "medium",
                                  "instancing"])
def test_unported_parts_raise(what):
    """Spheres, glass, the medium (slice 5) and runtime instancing (slice
    7: two instances in a group, a third, a light, baked) build, and their
    arrays equal the JAX package's, carried through ``from_numpy``."""
    js = _part_scene("lumo_tpu", what).build()
    ts = _part_scene("lumo_tpu_torch", what).build(device="cpu")
    carried = port_scene_from_jax(js)
    for k in SCENE_FIELDS + SHAPE_FIELDS:
        want = np.asarray(getattr(js, k))
        np.testing.assert_array_equal(getattr(ts, k).numpy(), want, err_msg=k)
        np.testing.assert_array_equal(getattr(carried, k).numpy(), want,
                                      err_msg=k)
    for k, v in js.materials.items():
        np.testing.assert_array_equal(ts.materials[k].numpy(), np.asarray(v),
                                      err_msg=k)
    assert ts.kinds_present == carried.kinds_present
    assert (ts.n_spheres, ts.medium is None) == (js.n_spheres,
                                                 js.medium is None)
    if what == "sphere":
        assert ts.n_spheres == 2 and ts.n_lights == js.n_lights == 3
    if what == "instancing":
        assert [g["minv"].shape[0] for g in ts.inst] == [2]
        assert ts.n_inst_prims == js.n_inst_prims == carried.n_inst_prims > 0
        assert ts.n_lights == js.n_lights > 0
        for port in (ts, carried):
            for k in INST_FIELDS:
                np.testing.assert_allclose(port.inst[0][k].numpy(),
                                           np.asarray(js.inst[0][k]),
                                           rtol=1e-6, err_msg=k)
            np.testing.assert_array_equal(
                port.inst[0]["bvh"]["nodes"].numpy(), bvh_kernel.pack_nodes(
                    {k: np.asarray(js.inst[0]["bvh"][k]) for k in BVH_KEYS}))
    if what == "medium":
        for k, v in js.medium.items():
            np.testing.assert_allclose(ts.medium[k].numpy(), np.asarray(v),
                                       rtol=1e-7, err_msg=k)
