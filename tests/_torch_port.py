"""Shared inputs for the tests that hold lumo_tpu_torch against lumo_tpu.

Both packages build the same scene from the same host inputs; the JAX
scene's arrays, converted with ``np.asarray``, are carried into the port
with ``lumo_tpu_torch.scene.scene.from_numpy``.  Everything runs on the
CPU.
"""
import numpy as np
import torch

SCENE_FIELDS = ("tri_a", "tri_b", "tri_c", "tri_na", "tri_nb", "tri_nc",
                "tri_uva", "tri_uvb", "tri_uvc", "tri_mat", "light_prim",
                "light_pdf", "alias_p", "alias_idx", "prim_light", "bounds")
BVH_KEYS = ("lo", "hi", "right", "first", "count", "axis")

BLOB_SEED = 11


def blob_box(pkg, subdiv):
    """``bench.py::bench_bvh_scene``'s scene (a displaced icosphere with a
    metal material in ``empty_box``) as a SceneBuilder of ``pkg``, either
    ``"lumo_tpu"`` or ``"lumo_tpu_torch"``."""
    import importlib
    cornell = importlib.import_module(f"{pkg}.scene.cornell")
    shapes = importlib.import_module(f"{pkg}.scene.shapes")
    Mesh = importlib.import_module(f"{pkg}.scene.instance").Mesh
    Material = importlib.import_module(f"{pkg}.scene.materials").Material
    sb = cornell.empty_box((0.95, 0.95, 0.95),
                           Material.diffuse((0.9, 0.1, 0.1)),
                           Material.diffuse((0.1, 0.9, 0.1)))
    v, f, vn = shapes.blob(subdiv=subdiv, seed=BLOB_SEED, amp=0.22)
    (Mesh(v, f, normals=vn).to_unit_size().to_origin().set_y(-0.799)
     .translate(0.0, 0.0, -1.5)
     .add_to(sb, Material.metal((0.9, 0.7, 0.1), 0.1, 2.5, 3.0)))
    return sb


def jax_scene_arrays(js):
    """(fields, bvh) host dicts of a JAX SceneData, as ``from_numpy``
    takes them."""
    fields = {k: np.asarray(getattr(js, k)) for k in SCENE_FIELDS}
    fields["n_bvh_tris"] = js.n_bvh_tris
    fields["materials"] = {k: np.asarray(v) for k, v in js.materials.items()}
    bvh = None
    if js.bvh is not None:
        bvh = {k: np.asarray(js.bvh[k]) for k in BVH_KEYS}
    return fields, bvh


def port_scene_from_jax(js):
    from lumo_tpu_torch.scene import scene as tscene
    fields, bvh = jax_scene_arrays(js)
    return tscene.from_numpy(fields, bvh, "cpu")


def rays_into_box(N, seed):
    """Rays from near the camera into the box: o, d (N, 3) float32."""
    rng = np.random.default_rng(seed)
    o = (np.array([0.0, 0.0, 0.5], np.float32)
         + rng.uniform(-0.1, 0.1, (N, 3)).astype(np.float32))
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d[:, 2] = -np.abs(d[:, 2]) - 0.3
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def t(x):
    """A numpy array as a CPU tensor (uint32 widened to int64)."""
    x = np.array(x)                     # a writable, contiguous copy
    if x.dtype == np.uint32:
        x = x.astype(np.int64)
    return torch.as_tensor(x)
