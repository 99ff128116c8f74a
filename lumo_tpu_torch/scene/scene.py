"""Scene building: host-side accumulation -> flat SoA tensors.

Counterpart of ``lumo_tpu/scene/scene.py`` (reference ``scene.rs``).
Primitives are three families with global ids: triangles ``[0, T)``,
spheres ``[T, T+S)`` and analytic shapes (plane, disk, cone, cylinder,
ellipsoid) after them, then the runtime-instanced groups' triangles (a
group of I instances of Tg triangles takes I * Tg ids, instance by
instance); a scene may hold a texture table, an environment light (an
emissive sphere around it) and a homogeneous medium.  Scenes
of ``BVH_THRESHOLD`` triangles or more get a
binned-SAH BVH whose leaf order the triangle arrays are permuted into;
dominant-area triangles (room walls) are split out of the BVH and kept at
the tail ``[n_bvh_tris, n_tris)``, where ``trace`` tests them densely.
With ``accel="kdtree"`` they get a Wald-Havran SAH kd-tree instead
(reference ``Mesh = KdTree``): the triangle order is untouched, the walls
stay inside the tree, and the tree is kept on the device only in the CUDA
kernel's layout (``accel/kd_kernel.py``).  Spheres and analytic shapes
are few and always tested densely.  Lights (triangles, spheres, disks)
get a Walker alias table (reference ``bvh.rs:104-191``) built on the
host.

An instanced group keeps one copy of its local-space triangles and, from
``BVH_THRESHOLD`` triangles on, its own BVH whatever ``accel`` is (the JAX
package's group BVH, walls not split out), which ``trace`` walks with
inverse-transformed rays; instances with a LIGHT material are baked into
world-space triangles instead, so the light tables stay exact.

The BVH is kept on the device only as repacked for the CUDA traversal
kernel (``nodes``, ``tris``; see ``accel/bvh_kernel.py``): the builder's
binary DFS tables (``lo, hi, right, first, count, axis``, identical to the
JAX package's) stay on the host and go through ``pack_nodes``.  The TPU's
block layout (``pack_blocks``) has no counterpart here.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from lumo_tpu_torch import telemetry
from lumo_tpu_torch.config import resolve_device
from lumo_tpu_torch.geometry import analytic
from lumo_tpu_torch.scene.materials import LIGHT, Material, pack_materials

BVH_THRESHOLD = 64  # brute-force below this many triangles

TRI_KEYS = ("a", "b", "c", "na", "nb", "nc", "uva", "uvb", "uvc")
BVH_KEYS = ("lo", "hi", "right", "first", "count", "axis")
KD_KEYS = ("split", "axis", "right", "first", "count", "prims", "lo", "hi")
# the sphere and analytic tables: row shape and host dtype of each column,
# in the order of the builder's ``_spheres`` and ``_analytic`` records
SPH_COLS = {"sph_center": ((3,), np.float64), "sph_radius": ((), np.float64),
            "sph_mat": ((), np.int32)}
ANA_COLS = {"ana_kind": ((), np.int32), "ana_rot": ((3, 3), np.float64),
            "ana_trans": ((3,), np.float64), "ana_radius": ((), np.float64),
            "ana_height": ((), np.float64), "ana_mat": ((), np.int32)}


# per-instance tables of an instanced group
INST_KEYS = ("minv", "mfwd", "trans", "mat")


def _not_ported(what: str, item: int):
    return NotImplementedError(
        f"{what} is not ported to lumo_tpu_torch yet (ROADMAP.md, module "
        f"queue item {item})")


@dataclasses.dataclass(frozen=True)
class SceneData:
    """Device scene.  Primitive ids are global: [0, T) triangles, [T, T+S)
    spheres, then the analytic shapes; index tables are int64, float
    tables in the build's dtype (float32, or float64 in the reference
    mode), the kernels' packed tables float32."""
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
    sph_center: torch.Tensor   # (S, 3)
    sph_radius: torch.Tensor   # (S,)
    sph_mat: torch.Tensor      # (S,)
    # analytic shapes (A, ...): kind tag, world->local rows, translation,
    # radius, height (``geometry/analytic.py``)
    ana_kind: torch.Tensor
    ana_rot: torch.Tensor
    ana_trans: torch.Tensor
    ana_radius: torch.Tensor
    ana_height: torch.Tensor
    ana_mat: torch.Tensor
    light_prim: torch.Tensor   # (L,) prim id of each light
    light_pdf: torch.Tensor    # (L,) selection probability
    alias_p: torch.Tensor      # (L,) alias acceptance threshold
    alias_idx: torch.Tensor    # (L,) alias target
    prim_light: torch.Tensor   # (P,) light index per prim, -1 if none
    materials: dict            # name -> (M, ...) tensor
    textures: Optional[dict]   # the texture table (``texture.py``)
    medium: Optional[dict]     # sigma_t, sigma_s, g, t_scale, mat
    bvh: Optional[dict]        # "nodes", "tris" (kernel layout), "depth"
    kdtree: Optional[dict]     # "nodes", "refs", "tris", "root" (kernel layout), "depth"
    bounds: torch.Tensor       # (2, 3)
    n_tris: int
    n_bvh_tris: int            # [0, n_bvh_tris) are under the BVH
    n_spheres: int
    n_analytic: int
    n_ana_lights: int          # disk lights
    n_lights: int
    n_shadow_rays: int
    kinds_present: frozenset   # material kinds in the table (host-side)
    beckmann: bool             # the table has Beckmann rows
    tex_kinds: tuple           # texture kinds in the texture table
    n_normal_maps: int
    # runtime-instanced groups (reference ``Instance<T>``,
    # ``instance.rs:5-15``), each a dict: one copy of the local-space
    # triangles (``TRI_KEYS``), its BVH in the kernel's layout or None
    # (dense) under "bvh", and per instance the world->local map "minv"
    # (I, 3, 3), the forward map "mfwd", the translation "trans" (I, 3)
    # and the material "mat" (I,)
    inst: tuple = ()
    n_inst_prims: int = 0      # sum over groups of I * Tg

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
        for name in ("materials", "textures", "medium", "bvh", "kdtree"):
            if getattr(self, name) is not None:
                repl[name] = {k: mv(v) for k, v in getattr(self, name).items()}
        repl["inst"] = tuple(
            {k: ({kk: mv(vv) for kk, vv in v.items()} if k == "bvh" and v
                 else mv(v)) for k, v in g.items()} for g in self.inst)
        return SceneData(**repl)

    def rebuild_light_alias(self) -> "SceneData":
        """The same scene with the light-selection pdf and Walker alias
        table recomputed from the current material table (host-side,
        numpy; ``lumo_tpu/scene/scene.py:109-160``).  ``build`` bakes the
        selection from the initial emission; after ``ke``, ``emit_scale``
        or ``illum`` change (``dataclasses.replace``) the estimator stays
        unbiased, since ``sample_light`` returns the pdf it used, but its
        variance no longer follows the powers until this is called."""
        from lumo_tpu_torch.color import dense as dense_mod
        L = self.n_lights
        if L == 0:
            return self
        m = {k: self.materials[k].detach().cpu().numpy()
             for k in ("ke", "illum", "emit_scale", "two_sided", "kind")}
        lam = 360.0 + 5.0 * np.arange(m["illum"].shape[1])
        x = (lam[None, :] - 360.0) / 470.0
        t = m["ke"][:, 0:1] * x * x + m["ke"][:, 1:2] * x + m["ke"][:, 2:3]
        ke = m["ke"][:, 3:4] * (0.5 + t / (2.0 * np.sqrt(1.0 + t * t)))
        phi = (np.sum(ke * m["illum"] * dense_mod.table("Y")[None, :], axis=1)
               * dense_mod.STEP / dense_mod.Y_INTEGRAL)
        phi = phi * m["emit_scale"] * np.where(m["two_sided"], 2.0, 1.0)
        phi = np.where(m["kind"] == LIGHT, phi, 0.0)

        host = lambda v: v.detach().cpu().numpy()
        T, S = self.n_tris, self.n_spheres
        areas = np.zeros(L)
        mats = np.zeros(L, np.int64)
        for i, p in enumerate(host(self.light_prim)):
            if p < T:
                a, b, c = (host(v[p]) for v in (self.tri_a, self.tri_b,
                                                self.tri_c))
                areas[i] = 0.5 * np.linalg.norm(np.cross(b - a, c - a))
                mats[i] = int(self.tri_mat[p])
            elif p < T + S:
                r = float(self.sph_radius[p - T])
                areas[i] = 4.0 * np.pi * r * r
                mats[i] = int(self.sph_mat[p - T])
            else:
                r = float(self.ana_radius[p - T - S])
                areas[i] = np.pi * r * r
                mats[i] = int(self.ana_mat[p - T - S])
        pdf, accept, alias = _build_alias(areas * phi[mats])
        tens = lambda a, like: torch.as_tensor(a, dtype=like.dtype,
                                               device=like.device)
        return dataclasses.replace(
            self, light_pdf=tens(pdf, self.light_pdf),
            alias_p=tens(accept, self.alias_p),
            alias_idx=tens(alias, self.alias_idx))


def _mesh_geometry(v, faces, normals, normal_idx, uvs, uv_idx):
    """A mesh's per-corner tables (``TRI_KEYS``) from vertices ``v`` (V, 3)
    and faces (F, 3): normals and uvs gathered where both the table and its
    index are given, else zero normals and the reference's default uvs
    (0,0), (1,0), (1,1) (``triangle.rs:160-166``); degenerate triangles
    culled (reference ``triangle_mesh.rs:57-97``)."""
    f = np.asarray(faces, np.int64)
    a, b, c = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]

    def corners(table, idx, default):
        if table is None or idx is None:
            return [np.tile(x, (len(a), 1)) for x in default]
        t, i = np.asarray(table, np.float64), np.asarray(idx, np.int64)
        return [t[i[:, 0]], t[i[:, 1]], t[i[:, 2]]]

    na, nb, nc = corners(normals, normal_idx, [[0.0, 0.0, 0.0]] * 3)
    uva, uvb, uvc = corners(uvs, uv_idx, [[0.0, 0.0], [1.0, 0.0], [1.0, 1.0]])
    keep = np.linalg.norm(np.cross(b - a, c - a), axis=-1) > 1e-20
    return {k: x[keep] for k, x in zip(
        TRI_KEYS, (a, b, c, na, nb, nc, uva, uvb, uvc))}


def _empty_tri_chunk():
    return {
        "a": np.zeros((0, 3)), "b": np.zeros((0, 3)), "c": np.zeros((0, 3)),
        "na": np.zeros((0, 3)), "nb": np.zeros((0, 3)), "nc": np.zeros((0, 3)),
        "uva": np.zeros((0, 2)), "uvb": np.zeros((0, 2)), "uvc": np.zeros((0, 2)),
    }


class SceneBuilder:
    """Accumulates primitives and materials on the host; ``build()`` packs
    the device scene (reference ``Scene::{add, add_light, build}``,
    ``scene.rs:33-77``)."""

    def __init__(self):
        from lumo_tpu_torch.texture import Textures
        self.textures = Textures()
        self._tri_chunks = []  # list of (geom dict, mat_idx, is_light)
        self._spheres = []     # list of (center, radius, mat_idx, is_light)
        self._analytic = []    # (kind, rot, trans, r, h, mat, is_light)
        self._inst_groups = []  # (geom dict, [(4x4 transform, mat_idx)])
        self._materials: list[Material] = []
        self.environment: Optional[Material] = None
        self.medium = None

    def material(self, mat: Material) -> int:
        self._materials.append(mat)
        return len(self._materials) - 1

    def _mat_id(self, mat):
        mid = mat if isinstance(mat, int) else self.material(mat)
        return mid, self._materials[mid].kind == LIGHT

    def add_triangles(self, vertices, faces, mat: Material | int,
                      normals=None, vertex_normal_idx=None,
                      uvs=None, uv_idx=None, transform=None):
        """Add a triangle soup/mesh. vertices (V, 3); faces (F, 3) int.
        normals/uvs optionally indexed per face corner."""
        mid, is_light = self._mat_id(mat)
        v = np.asarray(vertices, np.float64)
        n = normals
        if transform is not None:
            m = np.asarray(transform, np.float64)
            v = v @ m[:3, :3].T + m[:3, 3]
            if n is not None:
                nm = np.linalg.inv(m[:3, :3]).T
                n = np.asarray(n, np.float64) @ nm.T
                norms = np.linalg.norm(n, axis=-1, keepdims=True)
                n = n / np.maximum(norms, 1e-30)
        self._tri_chunks.append((_mesh_geometry(v, faces, n,
                                                vertex_normal_idx, uvs,
                                                uv_idx), mid, is_light))
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

    def add_sphere(self, center, radius, mat: Material | int,
                   transform=None):
        """Sphere; ``transform`` (4x4 affine) instances it as the
        reference's ``Instance<Sphere>``: a rigid + uniform-scale transform
        bakes into (center', radius'), any other makes an ellipsoid, an
        analytic unit sphere under the affine frame
        (``instance.rs:81-105``), which cannot be a light."""
        if transform is not None:
            from lumo_tpu_torch.scene.instance import sphere_instance
            try:
                center, radius = sphere_instance(center, radius, transform)
            except ValueError:
                L, trans = analytic.affine_frame(transform, center, radius)
                return self._add_analytic(analytic.SPHERE, L, trans, 1.0, 0.0,
                                          mat)
        mid, is_light = self._mat_id(mat)
        self._spheres.append((np.asarray(center, np.float64), float(radius),
                              mid, is_light))
        return mid

    def _add_analytic(self, kind, rot, trans, radius, height, mat,
                      light_ok=False):
        mid, is_light = self._mat_id(mat)
        if is_light and not light_ok:
            raise ValueError("only disks can be analytic lights "
                             "(reference: Disk is the only Sampleable "
                             "analytic primitive, disk.rs:131-160)")
        self._analytic.append((int(kind), np.asarray(rot, np.float64),
                               np.asarray(trans, np.float64), float(radius),
                               float(height), mid, is_light))
        return mid

    def add_plane(self, p, n, mat: Material | int):
        """Infinite plane through p with normal n (reference
        ``plane.rs:20-38``)."""
        return self._add_analytic(analytic.PLANE,
                                  analytic.frame_from_normal(n), p, 0.0, 0.0,
                                  mat)

    def add_disk(self, origin, normal, radius, mat: Material | int):
        """Disk of ``radius`` at ``origin`` facing ``normal`` (reference
        ``disk.rs:21-45``); disks may be lights (``disk.rs:131-160``)."""
        assert radius > 0.0
        return self._add_analytic(analytic.DISK,
                                  analytic.frame_from_normal(normal), origin,
                                  radius, 0.0, mat, light_ok=True)

    def add_cone(self, height, radius, mat: Material | int, transform=None):
        """Cone: base circle of ``radius`` at y = 0, apex at y = ``height``
        (reference ``cone.rs:14-25``), under an optional rigid +
        uniform-scale transform."""
        assert height > 0.0 and radius > 0.0
        rot, trans, s = analytic.frame_from_transform(transform)
        return self._add_analytic(analytic.CONE, rot, trans, radius * s,
                                  height * s, mat)

    def add_cylinder(self, height, radius, mat: Material | int,
                     transform=None):
        """Cylinder: base at y = 0, top at y = ``height``, of ``radius``
        (reference ``cylinder.rs:14-25``)."""
        assert height > 0.0 and radius > 0.0
        rot, trans, s = analytic.frame_from_transform(transform)
        return self._add_analytic(analytic.CYLINDER, rot, trans, radius * s,
                                  height * s, mat)

    def add_instanced_triangles(self, vertices, faces, transforms, mats,
                                normals=None, vertex_normal_idx=None,
                                uvs=None, uv_idx=None):
        """Register a mesh once and instance it under each 4x4 affine of
        ``transforms`` with the material of the same place in ``mats``
        (reference ``instance.rs:5-15``); returns the material ids.  Rays
        are inverse-transformed at query time: the geometry is not
        duplicated.  An instance with a LIGHT material is baked into
        world-space light triangles instead (reference ``Instance<T>`` is
        Sampleable, ``instance.rs:169-199``), so its areas, sampling pdfs
        and alias-table rows are exact in the transformed frame."""
        geom = _mesh_geometry(
            np.asarray(vertices, np.float64), faces, normals,
            faces if vertex_normal_idx is None else vertex_normal_idx, uvs,
            faces if uv_idx is None else uv_idx)
        insts, mids = [], []
        for m, mt in zip(transforms, mats):
            mid, is_light = self._mat_id(mt)
            mm = np.asarray(m, np.float64)
            if abs(np.linalg.det(mm[:3, :3])) < 1e-30:
                raise ValueError("singular instance transform")
            if is_light:
                self.add_triangles(vertices, faces, mid, normals=normals,
                                   vertex_normal_idx=vertex_normal_idx,
                                   uvs=uvs, uv_idx=uv_idx, transform=mm)
            else:
                insts.append((mm, mid))
            mids.append(mid)
        if insts:
            self._inst_groups.append((geom, insts))
        return mids

    def set_environment_map(self, mat: Material):
        """Environment light: a giant emissive sphere around the scene,
        made at build (reference ``scene.rs:38-45``)."""
        self.environment = mat

    def set_medium(self, absorption, scattering, g: float):
        """Fill the scene with a homogeneous medium (reference
        ``Scene::set_medium``, ``medium.rs:32-57``): sigma_t =
        uplift(absorption + scattering), sigma_s = uplift(scattering), HG
        parameter g in (-1, 1); distances scale by 1 / the world's largest
        extent."""
        assert -1.0 < g < 1.0
        self.medium = (np.asarray(absorption, np.float64),
                       np.asarray(scattering, np.float64), float(g))

    @telemetry.spanned("setup.scene_build")
    def build(self, dtype=np.float32, accel: str = "bvh",
              device=None) -> SceneData:
        """Pack the device scene on ``device`` (the card when ``None``).
        ``accel``: "bvh" (default), "kdtree" (reference-style SAH
        kd-tree over the triangle soup) or "none" (brute force)."""
        device = resolve_device(device)
        if accel not in ("bvh", "kdtree", "none"):
            raise ValueError(f"unknown accel {accel!r}")
        if self.environment is not None:
            lo, hi = self._host_bounds()
            center = 0.5 * (lo + hi)
            radius = float(np.linalg.norm(center - lo))
            self.add_sphere(center, max(radius, 1e-3) * 1.01, self.environment)
            self.environment = None

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
        kdt = None
        T_bvh = T
        if T >= BVH_THRESHOLD and accel == "bvh":
            from lumo_tpu_torch.accel import build as accel_build
            with telemetry.span("setup.bvh_build") as built:
                # Split dominant-area triangles (room walls/floors) out of
                # the BVH: their huge boxes pass nearly every slab test.
                # They are dense-tested in ``trace`` instead, as the
                # reference keeps walls as objects outside the mesh's tree
                # (``scene.rs``).
                area = 0.5 * np.linalg.norm(
                    np.cross(tri["b"] - tri["a"], tri["c"] - tri["a"]),
                    axis=1)
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
            if built.seconds > 0.05:
                # build-phase timing (reference ``bvh.rs:234,312``)
                print(f"BVH: {T_bvh} tris, {len(bvh.node_right)} nodes "
                      f"(+{len(huge)} split-out) in {built.seconds:.2f}s",
                      flush=True)
            # BVH tris in leaf order, then the split-out tris at the tail
            order = np.concatenate([rest[bvh.order], huge])
            tri = {k: v[order] for k, v in tri.items()}
            tri_mat = tri_mat[order]
            tri_is_light = tri_is_light[order]
        elif T >= BVH_THRESHOLD and accel == "kdtree":
            from lumo_tpu_torch.accel import build as accel_build
            from lumo_tpu_torch.accel import kdtree as accel_kd
            with telemetry.span("setup.kd_build") as built:
                lo_t, hi_t = accel_build.triangle_bounds(
                    tri["a"], tri["b"], tri["c"])
                kdt = accel_kd.build(lo_t, hi_t)
            if built.seconds > 0.05:
                print(f"kd-tree: {T} tris, {len(kdt.axis)} nodes, "
                      f"{len(kdt.prims)} references in {built.seconds:.2f}s",
                      flush=True)

        # lights + alias table (power = area x material power,
        # reference ``bvh.rs:104-191``)
        S, A = len(self._spheres), len(self._analytic)
        prim_light = np.full(max(T + S + A, 1), -1, np.int32)
        mat_power = np.array([
            m.mean_power() * (self.textures.mean_rgb(m.ke_tex)
                              if m.ke_tex >= 0 else 1.0)
            for m in self._materials])
        light_prims_t = np.nonzero(tri_is_light)[0]
        tri_area = 0.5 * np.linalg.norm(
            np.cross(tri["b"] - tri["a"], tri["c"] - tri["a"]), axis=-1)
        powers = list(tri_area[light_prims_t]
                      * mat_power[tri_mat[light_prims_t]])
        light_prims = list(light_prims_t)
        prim_light[light_prims_t] = np.arange(len(light_prims_t))
        for j, (_, r, mid, is_light) in enumerate(self._spheres):
            if is_light:
                prim_light[T + j] = len(light_prims)
                light_prims.append(T + j)
                powers.append(4.0 * np.pi * r ** 2 * mat_power[mid])
        for j, a_ in enumerate(self._analytic):
            if a_[6]:                     # disk lights (``disk.rs:131-135``)
                prim_light[T + S + j] = len(light_prims)
                light_prims.append(T + S + j)
                powers.append(np.pi * a_[3] ** 2 * mat_power[a_[5]])
        L = len(light_prims)
        if L > 0:
            pdf, alias_p, alias_idx = _build_alias(np.asarray(powers,
                                                              np.float64))
        else:
            pdf = alias_p = np.zeros(0)
            alias_idx = np.zeros(0, np.int64)

        lo, hi = self._host_bounds()
        # the medium (reference ``medium.rs:32-57``): t_scale fits the world
        # into a unit cube; its phase material is one more table row
        mats = list(self._materials)
        medium = None
        if self.medium is not None:
            ab, sc, g = self.medium
            t_scale = 1.0 / float(np.maximum(hi - lo, 1e-12).max())
            med_mat = Material.volumetric(g, t_scale, sc + ab, sc)
            medium = {"sigma_t": med_mat.sigma_t, "sigma_s": med_mat.sigma_s,
                      "g": np.asarray(g), "t_scale": np.asarray(t_scale),
                      "mat": np.asarray(len(mats))}
            mats.append(med_mat)

        fields = {f"tri_{k}": v for k, v in tri.items()}
        fields.update(self._shape_tables())
        fields.update(
            tri_mat=tri_mat, light_prim=np.asarray(light_prims, np.int32),
            light_pdf=pdf, alias_p=alias_p, alias_idx=alias_idx,
            prim_light=prim_light, bounds=np.stack([lo, hi]),
            materials=pack_materials(mats), n_bvh_tris=T_bvh,
            textures=self.textures.pack(dtype), medium=medium,
            n_normal_maps=len(self.textures.normal_images),
            inst=self._group_tables())
        bvh_np = None
        if bvh is not None:
            bvh_np = {"lo": bvh.node_lo, "hi": bvh.node_hi,
                      "right": bvh.node_right, "first": bvh.node_first,
                      "count": bvh.node_count, "axis": bvh.node_axis,
                      "depth": bvh.depth}
        kd_np = None
        if kdt is not None:
            kd_np = {"split": kdt.split, "axis": kdt.axis, "right": kdt.right,
                     "first": kdt.first, "count": kdt.count,
                     "prims": kdt.prims, "lo": kdt.root_lo, "hi": kdt.root_hi,
                     "depth": kdt.max_depth}
        return from_numpy(fields, bvh_np, device, dtype=dtype, kd=kd_np)

    def _group_tables(self):
        """The instanced groups as host dicts: each group's triangles in
        its BVH's leaf order with the BVH's binary tables under "bvh"
        (None below ``BVH_THRESHOLD`` triangles), and the per-instance
        maps."""
        from lumo_tpu_torch.accel import build as accel_build
        out = []
        for geom, insts in self._inst_groups:
            g = dict(geom)
            g["bvh"] = None
            if len(g["a"]) >= BVH_THRESHOLD:
                bh = accel_build.build(*accel_build.triangle_bounds(
                    g["a"], g["b"], g["c"]))
                g = {k: v[bh.order] for k, v in geom.items()}
                g["bvh"] = {"lo": bh.node_lo, "hi": bh.node_hi,
                            "right": bh.node_right, "first": bh.node_first,
                            "count": bh.node_count, "axis": bh.node_axis,
                            "depth": bh.depth}
            g.update(minv=np.stack([np.linalg.inv(m[:3, :3])
                                    for m, _ in insts]),
                     mfwd=np.stack([m[:3, :3] for m, _ in insts]),
                     trans=np.stack([m[:3, 3] for m, _ in insts]),
                     mat=np.asarray([mid for _, mid in insts], np.int32))
            out.append(g)
        return tuple(out)

    def _shape_tables(self):
        """The sphere and analytic tables as host arrays."""
        out = {}
        for records, cols in ((self._spheres, SPH_COLS),
                              (self._analytic, ANA_COLS)):
            for i, (k, (shape, dt)) in enumerate(cols.items()):
                out[k] = np.array([r[i] for r in records], dt).reshape(
                    (len(records),) + shape)
        return out

    def _host_bounds(self):
        lo = np.full(3, np.inf)
        hi = np.full(3, -np.inf)
        for g, _, _ in self._tri_chunks:
            for k in ("a", "b", "c"):
                if len(g[k]):
                    lo = np.minimum(lo, g[k].min(axis=0))
                    hi = np.maximum(hi, g[k].max(axis=0))
        for center, r, _, _ in self._spheres:
            lo = np.minimum(lo, center - r)
            hi = np.maximum(hi, center + r)
        for kind, rot, trans, r, h, _, _ in self._analytic:
            if kind == analytic.PLANE:
                continue                  # infinite (``plane.rs:113-118``)
            # conservative: the local box's corners, to world by rot^-1
            if kind == analytic.DISK:
                cl = np.array([[-r, -r, 0.0], [r, r, 0.0]])
            elif kind == analytic.SPHERE:
                cl = np.array([[-r, -r, -r], [r, r, r]])
            else:
                cl = np.array([[-r, 0.0, -r], [r, h, r]])
            corners = np.array([[cl[i, 0], cl[j, 1], cl[k, 2]]
                                for i in (0, 1) for j in (0, 1)
                                for k in (0, 1)])
            world = corners @ np.linalg.inv(rot).T + trans
            lo = np.minimum(lo, world.min(axis=0))
            hi = np.maximum(hi, world.max(axis=0))
        for geom, insts in self._inst_groups:
            if not len(geom["a"]):
                continue
            box = [np.minimum.reduce([geom[k].min(axis=0) for k in "abc"]),
                   np.maximum.reduce([geom[k].max(axis=0) for k in "abc"])]
            corners = np.array([[box[i][0], box[j][1], box[k][2]]
                                for i in (0, 1) for j in (0, 1)
                                for k in (0, 1)])
            for m, _ in insts:
                world = corners @ m[:3, :3].T + m[:3, 3]
                lo = np.minimum(lo, world.min(axis=0))
                hi = np.maximum(hi, world.max(axis=0))
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
               dtype=np.float32, kd: Optional[dict] = None) -> SceneData:
    """Build a :class:`SceneData` on ``device`` (the card when ``None``)
    from host arrays, e.g. those of a JAX-built scene converted with
    ``np.asarray``: ``fields`` holds ``tri_{a,b,c,na,nb,nc,uva,uvb,uvc}``,
    ``tri_mat``, ``light_prim``, ``light_pdf``, ``alias_p``, ``alias_idx``,
    ``prim_light``, ``bounds``, ``n_bvh_tris`` and ``materials`` (a dict of
    the packed material table), and, where the scene has them, the sphere
    and analytic tables ``sph_*`` and ``ana_*``, ``textures`` (the texture
    table's dict), ``medium`` (sigma_t, sigma_s, g, t_scale, mat) and
    ``n_normal_maps``, and ``inst``, the instanced groups (a sequence of
    dicts of the local-space triangles ``a, b, c, na, nb, nc, uva, uvb,
    uvc`` in leaf order, ``minv``, ``mfwd``, ``trans``, ``mat`` and
    ``bvh``, the group's binary BVH tables or None); ``bvh`` holds the
    binary tables ``lo, hi, right, first, count, axis`` (and optionally
    ``depth``) or is ``None`` for a brute-force scene, and is kept only in
    the kernel's layout (``bvh_kernel.pack_nodes``/``pack_tris``), as is
    each group's; ``kd`` holds the
    flat kd-tree tables ``split, axis, right, first, count, prims, lo, hi``
    (and optionally ``depth``) of a scene built with ``accel="kdtree"``
    and is kept only in the kd kernel's layout (``kd_kernel.pack_kd``).
    The values go through unchanged; index tables widen to int64, float
    tables take ``dtype`` (a JAX float64 scene carries over with
    ``dtype=np.float64``), the kernels' packed tables stay float32."""
    from lumo_tpu_torch.accel import bvh_kernel, kd_kernel
    device = resolve_device(device)

    def tens(x):
        x = np.asarray(x)
        if x.dtype == bool:
            return torch.as_tensor(x.copy(), device=device)
        if np.issubdtype(x.dtype, np.integer):
            return torch.as_tensor(x.astype(np.int64), device=device)
        return torch.as_tensor(x.astype(dtype), device=device)

    # the kernels' packed tables stay float32 whatever ``dtype`` is: the
    # kernels are float32 only, and a float64 query never reads them
    packed = lambda x: torch.as_tensor(x, device=device)

    kinds = frozenset(int(k) for k in np.unique(np.asarray(
        fields["materials"]["kind"])))
    shapes = {k: fields.get(k, np.zeros((0,) + shape, dt))
              for k, (shape, dt) in {**SPH_COLS, **ANA_COLS}.items()}
    T = int(np.asarray(fields["tri_a"]).shape[0])
    S = int(np.asarray(shapes["sph_radius"]).shape[0])
    A = int(np.asarray(shapes["ana_kind"]).shape[0])
    tex = fields.get("textures")
    medium = fields.get("medium")
    T_bvh = int(fields.get("n_bvh_tris", T))
    L = int(np.asarray(fields["light_prim"]).shape[0])

    def packed_bvh(tables, a, b, c):
        """A BVH's binary tables and leaf-order triangles in the kernel's
        layout."""
        t = {k: np.asarray(tables[k]) for k in BVH_KEYS}
        return {"nodes": packed(bvh_kernel.pack_nodes(t)),
                "tris": packed(bvh_kernel.pack_tris(
                    *(np.asarray(x, np.float32) for x in (a, b, c)))),
                "depth": int(tables["depth"]) if "depth" in tables
                else _bvh_depth(t["right"], t["count"])}

    bvh_dev = None
    if bvh is not None:
        bvh_dev = packed_bvh(bvh, *(np.asarray(fields[f"tri_{k}"])[:T_bvh]
                                    for k in "abc"))
    inst = []
    for g in fields.get("inst", ()):
        grp = {k: tens(g[k]) for k in TRI_KEYS + INST_KEYS}
        grp["bvh"] = None if g["bvh"] is None else packed_bvh(
            g["bvh"], g["a"], g["b"], g["c"])
        inst.append(grp)
    kd_dev = None
    if kd is not None:
        if bvh is not None:
            raise ValueError("a scene has a BVH or a kd-tree, not both")
        k = {key: np.asarray(kd[key]) for key in KD_KEYS}
        kd_np = kd_kernel.pack_kd(
            k, *(np.asarray(fields[f"tri_{v}"], np.float32) for v in "abc"))
        kd_dev = {
            **{key: packed(kd_np[key])
               for key in ("nodes", "refs", "tris", "root")},
            "depth": int(kd["depth"]) if "depth" in kd else
            kd_kernel.kd_depth(k["axis"], k["right"])}
    return SceneData(
        **{f"tri_{k}": tens(fields[f"tri_{k}"]) for k in TRI_KEYS},
        tri_mat=tens(fields["tri_mat"]),
        **{k: tens(v) for k, v in shapes.items()},
        light_prim=tens(fields["light_prim"]),
        light_pdf=tens(fields["light_pdf"]),
        alias_p=tens(fields["alias_p"]),
        alias_idx=tens(fields["alias_idx"]),
        prim_light=tens(fields["prim_light"]),
        materials={k: tens(v) for k, v in fields["materials"].items()},
        textures=None if tex is None else {k: tens(v) for k, v in tex.items()},
        medium=None if medium is None else {k: tens(v)
                                            for k, v in medium.items()},
        bvh=bvh_dev,
        kdtree=kd_dev,
        bounds=tens(fields["bounds"]),
        n_tris=T, n_bvh_tris=T_bvh if bvh is not None else T,
        n_spheres=S, n_analytic=A,
        n_ana_lights=int((np.asarray(fields["light_prim"]) >= T + S).sum()),
        n_lights=L,
        n_shadow_rays=max(1, int(np.log2(max(L, 1))) if L > 1 else 1),
        kinds_present=kinds,
        beckmann=bool(np.any(np.asarray(fields["materials"]["mf_beck"]))),
        tex_kinds=() if tex is None else tuple(
            sorted(int(k) for k in np.unique(np.asarray(tex["kind"])))),
        n_normal_maps=int(fields.get("n_normal_maps", 0)),
        inst=tuple(inst),
        n_inst_prims=sum(g["minv"].shape[0] * g["a"].shape[0] for g in inst),
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
