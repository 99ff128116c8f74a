"""Instancing: fluent affine transforms over host meshes.

Counterpart of the host-side half of ``lumo_tpu/scene/instance.py``: the
transform is baked into the triangle vertices (exact - a triangle maps to
a triangle) and the normal matrix into the shading normals when the mesh
is added to a scene.  Only the transforms of
``bench.py:207-210`` are ported: ``translate`` and the kd-tree helpers
``to_unit_size``, ``to_origin`` and ``set_y`` (``kdtree.rs:93-99``).
"""
from __future__ import annotations

import numpy as np

from lumo_tpu_torch.scene.materials import Material
from lumo_tpu_torch.scene.scene import SceneBuilder


def translation(x, y, z):
    m = np.eye(4)
    m[:3, 3] = (x, y, z)
    return m


class Mesh:
    """Host mesh + accumulated transform, with the fluent transforms
    ``bench.py::bench_bvh_scene`` uses; ``add_to`` bakes it into a
    SceneBuilder.  Rotations, ``clone`` and runtime instancing
    (``add_instances_to``) come with the instancing slice."""

    def __init__(self, vertices, faces, normals=None, normal_idx=None,
                 uvs=None, uv_idx=None):
        self.vertices = np.asarray(vertices, np.float64)
        self.faces = np.asarray(faces, np.int64)
        self.normals = None if normals is None else np.asarray(normals, np.float64)
        self.normal_idx = None if normal_idx is None else np.asarray(normal_idx, np.int64)
        self.uvs = None if uvs is None else np.asarray(uvs, np.float64)
        self.uv_idx = None if uv_idx is None else np.asarray(uv_idx, np.int64)
        self.m = np.eye(4)

    def _apply(self, t):
        """Compose ``t`` after the current transform (reference
        semantics)."""
        self.m = np.asarray(t, np.float64) @ self.m
        return self

    def translate(self, x, y, z):
        return self._apply(translation(x, y, z))

    # ---- bounds-dependent helpers (reference ``kdtree.rs:93-99``) ----
    def _bounds(self):
        v = self.vertices @ self.m[:3, :3].T + self.m[:3, 3]
        return v.min(axis=0), v.max(axis=0)

    def to_unit_size(self):
        lo, hi = self._bounds()
        s = 1.0 / max(hi - lo)
        return self._apply(np.diag([s, s, s, 1.0]))

    def to_origin(self):
        lo, hi = self._bounds()
        c = 0.5 * (lo + hi)
        return self.translate(*(-c))

    def set_y(self, y):
        lo, hi = self._bounds()
        return self.translate(0, y - lo[1], 0)

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
