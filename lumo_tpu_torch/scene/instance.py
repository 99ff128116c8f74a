"""Instancing: fluent affine transforms over host meshes.

Counterpart of the host-side half of ``lumo_tpu/scene/instance.py``:
``add_to`` bakes the transform into the triangle vertices (exact - a
triangle maps to a triangle) and the normal matrix into the shading
normals; ``add_instances_to`` registers the mesh once and instances it
under further transforms, inverse-transforming the rays at query time
(``scene/trace.py``).  The fluent API mirrors ``Instanceable``
(``instance.rs:202-299``) and the kd-tree helpers ``to_unit_size``,
``to_origin``, ``set_x/y/z`` (``kdtree.rs:93-99``).
"""
from __future__ import annotations

import numpy as np

from lumo_tpu_torch.scene.materials import Material
from lumo_tpu_torch.scene.scene import SceneBuilder


def translation(x, y, z):
    m = np.eye(4)
    m[:3, 3] = (x, y, z)
    return m


def scale(x, y, z):
    assert x * y * z != 0.0
    return np.diag([x, y, z, 1.0])


def _rot(axis, r):
    c, s = np.cos(r), np.sin(r)
    m = np.eye(4)
    i, j = [(1, 2), (2, 0), (0, 1)][axis]
    m[i, i] = c
    m[j, j] = c
    m[i, j] = -s
    m[j, i] = s
    return m


def rotate_x(r):
    return _rot(0, r)


def rotate_y(r):
    return _rot(1, r)


def rotate_z(r):
    return _rot(2, r)


class Mesh:
    """Host mesh + accumulated transform, fluent like the reference's
    ``Instance``; ``add_to`` bakes it into a SceneBuilder."""

    def __init__(self, vertices, faces, normals=None, normal_idx=None,
                 uvs=None, uv_idx=None):
        self.vertices = np.asarray(vertices, np.float64)
        self.faces = np.asarray(faces, np.int64)
        self.normals = None if normals is None else np.asarray(normals, np.float64)
        self.normal_idx = None if normal_idx is None else np.asarray(normal_idx, np.int64)
        self.uvs = None if uvs is None else np.asarray(uvs, np.float64)
        self.uv_idx = None if uv_idx is None else np.asarray(uv_idx, np.int64)
        self.m = np.eye(4)

    def clone(self) -> "Mesh":
        """Shared geometry, a private transform (reference
        ``Instance::clone``, ``instance.rs:5-15``)."""
        m = Mesh.__new__(Mesh)
        m.__dict__.update(self.__dict__)
        m.m = self.m.copy()
        return m

    # fluent transforms, each applied AFTER the current one
    def apply(self, t):
        self.m = np.asarray(t, np.float64) @ self.m
        return self

    def translate(self, x, y, z):
        return self.apply(translation(x, y, z))

    def scale(self, x, y, z):
        return self.apply(scale(x, y, z))

    def scale_uniform(self, s):
        return self.scale(s, s, s)

    def rotate_x(self, r):
        return self.apply(rotate_x(r))

    def rotate_y(self, r):
        return self.apply(rotate_y(r))

    def rotate_z(self, r):
        return self.apply(rotate_z(r))

    # ---- bounds-dependent helpers (reference ``kdtree.rs:93-99``) ----
    def _bounds(self):
        v = self.vertices @ self.m[:3, :3].T + self.m[:3, 3]
        return v.min(axis=0), v.max(axis=0)

    def to_unit_size(self):
        lo, hi = self._bounds()
        return self.scale_uniform(1.0 / max(hi - lo))

    def to_origin(self):
        lo, hi = self._bounds()
        c = 0.5 * (lo + hi)
        return self.translate(*(-c))

    def set_x(self, x):
        lo, hi = self._bounds()
        return self.translate(x - 0.5 * (lo[0] + hi[0]), 0, 0)

    def set_y(self, y):
        lo, hi = self._bounds()
        return self.translate(0, y - lo[1], 0)

    def set_z(self, z):
        lo, hi = self._bounds()
        return self.translate(0, 0, z - 0.5 * (lo[2] + hi[2]))

    # ---- bake ----
    def add_to(self, builder: SceneBuilder, material: Material | int):
        return builder.add_triangles(
            self.vertices, self.faces, material,
            normals=self.normals,
            vertex_normal_idx=(self.normal_idx if self.normal_idx is not None
                               else (self.faces if self.normals is not None else None)),
            uvs=self.uvs,
            uv_idx=(self.uv_idx if self.uv_idx is not None
                    else (self.faces if self.uvs is not None else None)),
            transform=self.m)

    def add_instances_to(self, builder: SceneBuilder, transforms,
                         materials):
        """Register the mesh once, in its current fluent frame, and
        instance it under each further 4x4 transform with a per-instance
        material (reference ``Instance``, ``instance.rs:5-15``); returns
        the material ids.  Unlike :meth:`add_to` the geometry is not
        duplicated: rays are inverse-transformed at render time."""
        v = self.vertices @ self.m[:3, :3].T + self.m[:3, 3]
        normals = self.normals
        if normals is not None:
            nm = np.linalg.inv(self.m[:3, :3]).T     # the normal matrix
            normals = normals @ nm.T
            normals = normals / np.maximum(
                np.linalg.norm(normals, axis=-1, keepdims=True), 1e-30)
        return builder.add_instanced_triangles(
            v, self.faces, transforms, materials, normals=normals,
            vertex_normal_idx=(self.normal_idx if self.normal_idx is not None
                               else (self.faces if normals is not None
                                     else None)),
            uvs=self.uvs,
            uv_idx=(self.uv_idx if self.uv_idx is not None
                    else (self.faces if self.uvs is not None else None)))


def sphere_instance(center, radius, t):
    """A rigid + uniform-scale transform of a sphere -> (center',
    radius'); raises ValueError on any other transform (the builder then
    makes an ellipsoid)."""
    m = np.asarray(t, np.float64)
    a = m[:3, :3]
    s2 = a.T @ a
    sc = np.sqrt(np.trace(s2) / 3.0)
    if not np.allclose(s2, np.eye(3) * sc * sc, rtol=1e-5, atol=1e-8):
        raise ValueError("sphere instances must be rigid + uniform scale")
    c = a @ np.asarray(center, np.float64) + m[:3, 3]
    return c, float(radius * sc)
