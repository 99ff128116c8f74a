"""Scene building: host-side accumulation -> flat SoA tensors.

Counterpart of ``lumo_tpu/scene/scene.py`` (reference ``scene.rs``) for
triangle scenes.  Scenes of ``BVH_THRESHOLD`` triangles or more get a
binned-SAH BVH whose leaf order the triangle arrays are permuted into;
dominant-area triangles (room walls) are split out of the BVH and kept at
the tail ``[n_bvh_tris, n_tris)``, where ``trace`` tests them densely.
Lights get a Walker alias table (reference ``bvh.rs:104-191``) built on
the host.

The BVH is kept twice on the device: as the builder's binary DFS tables
(``lo, hi, right, first, count, axis``, identical to the JAX package's)
and repacked for the CUDA traversal kernel (``nodes``, ``tris``; see
``accel/bvh_kernel.py``).  The TPU's block layout (``pack_blocks``) has no
counterpart here.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from lumo_tpu_torch.config import resolve_device
from lumo_tpu_torch.scene.materials import (LIGHT, MF_DIELECTRIC, VOLUMETRIC,
                                            Material, pack_materials)

BVH_THRESHOLD = 64  # brute-force below this many triangles

TRI_KEYS = ("a", "b", "c", "na", "nb", "nc", "uva", "uvb", "uvc")
BVH_KEYS = ("lo", "hi", "right", "first", "count", "axis")


def _not_ported(what: str, item: int):
    return NotImplementedError(
        f"{what} is not ported to lumo_tpu_torch yet (ROADMAP.md, module "
        f"queue item {item})")


@dataclasses.dataclass(frozen=True)
class SceneData:
    """Device scene.  Primitive ids are global triangle indices [0, T);
    index tables are int64, float tables float32."""
    tri_a: torch.Tensor
    tri_b: torch.Tensor
    tri_c: torch.Tensor
    tri_na: torch.Tensor
    tri_nb: torch.Tensor
    tri_nc: torch.Tensor
    tri_uva: torch.Tensor
    tri_uvb: torch.Tensor
    tri_uvc: torch.Tensor
    tri_mat: torch.Tensor
    light_prim: torch.Tensor   # (L,) prim id of each light
    light_pdf: torch.Tensor    # (L,) selection probability
    alias_p: torch.Tensor      # (L,) alias acceptance threshold
    alias_idx: torch.Tensor    # (L,) alias target
    prim_light: torch.Tensor   # (P,) light index per prim, -1 if none
    materials: dict            # name -> (M, ...) tensor
    bvh: Optional[dict]        # "nodes", "tris" (kernel layout), "depth"
    bounds: torch.Tensor       # (2, 3)
    n_tris: int
    n_bvh_tris: int            # [0, n_bvh_tris) are under the BVH
    n_lights: int
    n_shadow_rays: int
    kinds_present: frozenset   # material kinds in the table (host-side)

    @property
    def device(self) -> torch.device:
        return self.tri_a.device

    def to(self, device=None) -> "SceneData":
        """The same scene with every tensor on ``device`` (the card when
        ``None``)."""
        device = resolve_device(device)
        mv = lambda v: v.to(device) if isinstance(v, torch.Tensor) else v
        repl = {f.name: mv(getattr(self, f.name))
                for f in dataclasses.fields(self)}
        repl["materials"] = {k: mv(v) for k, v in self.materials.items()}
        if self.bvh is not None:
            repl["bvh"] = {k: mv(v) for k, v in self.bvh.items()}
        return SceneData(**repl)


def _empty_tri_chunk():
    return {
        "a": np.zeros((0, 3)), "b": np.zeros((0, 3)), "c": np.zeros((0, 3)),
        "na": np.zeros((0, 3)), "nb": np.zeros((0, 3)), "nc": np.zeros((0, 3)),
        "uva": np.zeros((0, 2)), "uvb": np.zeros((0, 2)), "uvc": np.zeros((0, 2)),
    }


class SceneBuilder:
    """Accumulates triangles and materials on the host; ``build()`` packs
    the device scene (reference ``Scene::{add, add_light, build}``,
    ``scene.rs:33-77``)."""

    def __init__(self):
        self._tri_chunks = []  # list of (geom dict, mat_idx, is_light)
        self._materials: list[Material] = []

    def material(self, mat: Material) -> int:
        self._materials.append(mat)
        return len(self._materials) - 1

    def add_triangles(self, vertices, faces, mat: Material | int,
                      normals=None, vertex_normal_idx=None,
                      uvs=None, uv_idx=None, transform=None):
        """Add a triangle soup/mesh. vertices (V, 3); faces (F, 3) int.
        normals/uvs optionally indexed per face corner."""
        mid = mat if isinstance(mat, int) else self.material(mat)
        is_light = self._materials[mid].kind == LIGHT
        v = np.asarray(vertices, np.float64)
        if transform is not None:
            m = np.asarray(transform, np.float64)
            v = v @ m[:3, :3].T + m[:3, 3]
        f = np.asarray(faces, np.int64)
        a, b, c = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
        zero3 = np.zeros_like(a)
        if normals is not None and vertex_normal_idx is not None:
            n = np.asarray(normals, np.float64)
            if transform is not None:
                m = np.asarray(transform, np.float64)
                nm = np.linalg.inv(m[:3, :3]).T
                n = n @ nm.T
                norms = np.linalg.norm(n, axis=-1, keepdims=True)
                n = n / np.maximum(norms, 1e-30)
            ni = np.asarray(vertex_normal_idx, np.int64)
            na, nb, nc = n[ni[:, 0]], n[ni[:, 1]], n[ni[:, 2]]
        else:
            na = nb = nc = zero3
        if uvs is not None and uv_idx is not None:
            t = np.asarray(uvs, np.float64)
            ti = np.asarray(uv_idx, np.int64)
            uva, uvb, uvc = t[ti[:, 0]], t[ti[:, 1]], t[ti[:, 2]]
        else:
            # reference default: (0,0), (1,0), (1,1) (``triangle.rs:160-166``)
            uva = np.tile([0.0, 0.0], (len(a), 1))
            uvb = np.tile([1.0, 0.0], (len(a), 1))
            uvc = np.tile([1.0, 1.0], (len(a), 1))
        # cull degenerates (reference ``triangle_mesh.rs:57-97``)
        area2 = np.linalg.norm(np.cross(b - a, c - a), axis=-1)
        keep = area2 > 1e-20
        geom = {"a": a[keep], "b": b[keep], "c": c[keep],
                "na": na[keep], "nb": nb[keep], "nc": nc[keep],
                "uva": uva[keep], "uvb": uvb[keep], "uvc": uvc[keep]}
        self._tri_chunks.append((geom, mid, is_light))
        return mid

    def add_rectangle(self, p0, p1, p2, mat: Material | int):
        """Rectangle from three corners (reference ``rectangle.rs:43-69``:
        d = p0 + (p2 - p1)); two triangles with basis uvs."""
        p0, p1, p2 = [np.asarray(p, np.float64) for p in (p0, p1, p2)]
        p3 = p0 + (p2 - p1)
        verts = np.stack([p0, p1, p2, p3])
        faces = np.array([[0, 1, 2], [0, 2, 3]])
        uvs = np.array([[0.0, 0.0], [0.0, 1.0], [1.0, 1.0], [1.0, 0.0]])
        return self.add_triangles(verts, faces, mat, uvs=uvs, uv_idx=faces)

    def add_box(self, mat: Material | int, transform=None):
        """Unit cube [0,1]^3 as 12 triangles (reference ``cube.rs:9-57``)."""
        corners = np.array([[x, y, z] for x in (0, 1) for y in (0, 1)
                            for z in (0, 1)], dtype=np.float64)
        quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6),
                 (0, 2, 6, 4), (1, 5, 7, 3)]
        faces = []
        for q in quads:
            faces.append([q[0], q[1], q[2]])
            faces.append([q[0], q[2], q[3]])
        return self.add_triangles(corners, np.array(faces), mat,
                                  transform=transform)

    def add_sphere(self, *args, **kwargs):
        raise _not_ported("spheres", 7)

    def add_instanced_triangles(self, *args, **kwargs):
        raise _not_ported("runtime instancing", 9)

    def set_medium(self, *args, **kwargs):
        raise _not_ported("participating media", 7)

    def set_environment_map(self, *args, **kwargs):
        raise _not_ported("environment lights (spheres)", 7)

    def _check_materials(self):
        for m in self._materials:
            if m.kind in (MF_DIELECTRIC, VOLUMETRIC):
                raise _not_ported("glass, dispersion and volumetric "
                                  "materials", 7)
            if m.beckmann:
                raise _not_ported("the Beckmann distribution", 7)
            if max(m.kd_tex, m.ks_tex, m.tf_tex, m.ke_tex, m.nm_tex) >= 0:
                raise _not_ported("textures and normal maps", 6)

    def build(self, dtype=np.float32, accel: str = "bvh",
              device=None) -> SceneData:
        """Pack the device scene on ``device`` (the card when ``None``).
        ``accel``: "bvh" (default) or "none" (brute force)."""
        device = resolve_device(device)
        if accel == "kdtree":
            raise _not_ported("the kd-tree accelerator", 10)
        if accel not in ("bvh", "none"):
            raise ValueError(f"unknown accel {accel!r}")
        self._check_materials()

        if self._tri_chunks:
            tri = {k: np.concatenate([g[k] for g, _, _ in self._tri_chunks])
                   for k in TRI_KEYS}
            tri_mat = np.concatenate([np.full(len(g["a"]), m, np.int32)
                                      for g, m, _ in self._tri_chunks])
            tri_is_light = np.concatenate([np.full(len(g["a"]), il, bool)
                                           for g, _, il in self._tri_chunks])
        else:
            tri = _empty_tri_chunk()
            tri_mat = np.zeros(0, np.int32)
            tri_is_light = np.zeros(0, bool)
        T = len(tri["a"])

        bvh = None
        T_bvh = T
        if T >= BVH_THRESHOLD and accel == "bvh":
            from lumo_tpu_torch.accel import build as accel_build
            t0 = time.perf_counter()
            # Split dominant-area triangles (room walls/floors) out of the
            # BVH: their huge boxes pass nearly every slab test.  They are
            # dense-tested in ``trace`` instead, as the reference keeps
            # walls as objects outside the mesh's tree (``scene.rs``).
            area = 0.5 * np.linalg.norm(
                np.cross(tri["b"] - tri["a"], tri["c"] - tri["a"]), axis=1)
            huge = np.nonzero(area >= float(area.sum()) * 8.0 / T)[0]
            if len(huge) > 64:
                huge = huge[np.argsort(area[huge])[::-1][:64]]
            if len(huge) == 0 or T - len(huge) < BVH_THRESHOLD:
                huge = np.zeros(0, np.int64)
            rest = np.setdiff1d(np.arange(T), huge)
            T_bvh = len(rest)
            lo_t, hi_t = accel_build.triangle_bounds(
                tri["a"][rest], tri["b"][rest], tri["c"][rest])
            bvh = accel_build.build(lo_t, hi_t)
            el = time.perf_counter() - t0
            if el > 0.05:
                # build-phase timing (reference ``bvh.rs:234,312``)
                print(f"BVH: {T_bvh} tris, {len(bvh.node_right)} nodes "
                      f"(+{len(huge)} split-out) in {el:.2f}s", flush=True)
            # BVH tris in leaf order, then the split-out tris at the tail
            order = np.concatenate([rest[bvh.order], huge])
            tri = {k: v[order] for k, v in tri.items()}
            tri_mat = tri_mat[order]
            tri_is_light = tri_is_light[order]

        # lights + alias table (power = area x material power,
        # reference ``bvh.rs:104-191``)
        prim_light = np.full(max(T, 1), -1, np.int32)
        mat_power = np.array([m.mean_power() for m in self._materials])
        light_prims = np.nonzero(tri_is_light)[0]
        tri_area = 0.5 * np.linalg.norm(
            np.cross(tri["b"] - tri["a"], tri["c"] - tri["a"]), axis=-1)
        powers = tri_area[light_prims] * mat_power[tri_mat[light_prims]]
        prim_light[light_prims] = np.arange(len(light_prims))
        L = len(light_prims)
        if L > 0:
            pdf, alias_p, alias_idx = _build_alias(np.asarray(powers, np.float64))
        else:
            pdf = alias_p = np.zeros(0)
            alias_idx = np.zeros(0, np.int64)

        fields = {f"tri_{k}": v for k, v in tri.items()}
        fields.update(
            tri_mat=tri_mat, light_prim=light_prims.astype(np.int32),
            light_pdf=pdf, alias_p=alias_p, alias_idx=alias_idx,
            prim_light=prim_light, bounds=np.stack(self._host_bounds()),
            materials=pack_materials(self._materials), n_bvh_tris=T_bvh)
        bvh_np = None
        if bvh is not None:
            bvh_np = {"lo": bvh.node_lo, "hi": bvh.node_hi,
                      "right": bvh.node_right, "first": bvh.node_first,
                      "count": bvh.node_count, "axis": bvh.node_axis,
                      "depth": bvh.depth}
        return from_numpy(fields, bvh_np, device, dtype=dtype)

    def _host_bounds(self):
        lo = np.full(3, np.inf)
        hi = np.full(3, -np.inf)
        for g, _, _ in self._tri_chunks:
            for k in ("a", "b", "c"):
                if len(g[k]):
                    lo = np.minimum(lo, g[k].min(axis=0))
                    hi = np.maximum(hi, g[k].max(axis=0))
        if not np.isfinite(lo).all():
            lo, hi = -np.ones(3), np.ones(3)
        return lo, hi


def _bvh_depth(right: np.ndarray, count: np.ndarray) -> int:
    """Levels of a DFS-preorder binary tree (left child = i + 1), one
    vectorized step per level."""
    frontier = np.zeros(1, np.int64)
    depth = 0
    while len(frontier):
        depth += 1
        inner = frontier[count[frontier] == 0]
        frontier = np.concatenate([inner + 1, right[inner].astype(np.int64)])
    return depth


def from_numpy(fields: dict, bvh: Optional[dict], device=None,
               dtype=np.float32) -> SceneData:
    """Build a :class:`SceneData` on ``device`` (the card when ``None``)
    from host arrays, e.g. those of a JAX-built scene converted with
    ``np.asarray``: ``fields`` holds ``tri_{a,b,c,na,nb,nc,uva,uvb,uvc}``,
    ``tri_mat``, ``light_prim``, ``light_pdf``, ``alias_p``, ``alias_idx``,
    ``prim_light``, ``bounds``, ``n_bvh_tris`` and ``materials`` (a dict of
    the packed material table); ``bvh`` holds the binary tables
    ``lo, hi, right, first, count, axis`` (and optionally ``depth``) or is
    ``None`` for a brute-force scene, and is kept only in the kernel's
    layout (``bvh_kernel.pack_nodes``/``pack_tris``).  The values go
    through unchanged; index tables widen to int64."""
    from lumo_tpu_torch.accel import bvh_kernel
    device = resolve_device(device)

    def tens(x):
        x = np.asarray(x)
        if x.dtype == bool:
            return torch.as_tensor(x.copy(), device=device)
        if np.issubdtype(x.dtype, np.integer):
            return torch.as_tensor(x.astype(np.int64), device=device)
        return torch.as_tensor(x.astype(dtype), device=device)

    kinds = frozenset(int(k) for k in np.unique(np.asarray(
        fields["materials"]["kind"])))
    if kinds & {MF_DIELECTRIC, VOLUMETRIC}:
        raise _not_ported("glass, dispersion and volumetric materials", 7)
    if np.any(np.asarray(fields["materials"]["mf_beck"])):
        raise _not_ported("the Beckmann distribution", 7)
    T = int(np.asarray(fields["tri_a"]).shape[0])
    T_bvh = int(fields.get("n_bvh_tris", T))
    L = int(np.asarray(fields["light_prim"]).shape[0])
    bvh_dev = None
    if bvh is not None:
        b = {k: np.asarray(bvh[k]) for k in BVH_KEYS}
        depth = int(bvh["depth"]) if "depth" in bvh else _bvh_depth(
            b["right"], b["count"])
        bvh_dev = {
            "nodes": tens(bvh_kernel.pack_nodes(b)),
            "tris": tens(bvh_kernel.pack_tris(
                *(np.asarray(fields[f"tri_{k}"], np.float32)[:T_bvh]
                  for k in "abc"))),
            "depth": depth}
    return SceneData(
        **{f"tri_{k}": tens(fields[f"tri_{k}"]) for k in TRI_KEYS},
        tri_mat=tens(fields["tri_mat"]),
        light_prim=tens(fields["light_prim"]),
        light_pdf=tens(fields["light_pdf"]),
        alias_p=tens(fields["alias_p"]),
        alias_idx=tens(fields["alias_idx"]),
        prim_light=tens(fields["prim_light"]),
        materials={k: tens(v) for k, v in fields["materials"].items()},
        bvh=bvh_dev,
        bounds=tens(fields["bounds"]),
        n_tris=T, n_bvh_tris=T_bvh if bvh is not None else T,
        n_lights=L,
        n_shadow_rays=max(1, int(np.log2(max(L, 1))) if L > 1 else 1),
        kinds_present=kinds,
    )


def _build_alias(powers: np.ndarray):
    """Walker alias table (host, numpy). Returns (pdf, accept_p, alias)."""
    n = len(powers)
    total = powers.sum()
    if total <= 0.0:
        pdf = np.full(n, 1.0 / n)
    else:
        pdf = powers / total
    accept = np.ones(n)
    alias = np.arange(n)
    scaled = pdf * n
    small = [i for i in range(n) if scaled[i] < 1.0]
    large = [i for i in range(n) if scaled[i] >= 1.0]
    scaled = scaled.copy()
    while small and large:
        s = small.pop()
        l = large.pop()
        accept[s] = scaled[s]
        alias[s] = l
        scaled[l] = scaled[l] + scaled[s] - 1.0
        (large if scaled[l] >= 1.0 else small).append(l)
    for i in small + large:
        accept[i] = 1.0
    return pdf, accept, alias
