"""Procedural mesh generators (host, numpy).

Counterpart of ``lumo_tpu/scene/shapes.py``: icosphere, blob, grid
plane, and tessellated disk, cylinder and cone.  Test and benchmark
scenes that need real triangle counts use a displaced icosphere, made
from a seed.
"""
from __future__ import annotations

import numpy as np


def icosphere(subdiv: int = 3):
    """Subdivided icosahedron on the unit sphere.
    Returns (vertices (V, 3), faces (F, 3)); 20·4^subdiv faces."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    v = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
    ], np.float64)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    f = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ], np.int64)
    for _ in range(subdiv):
        edge_mid = {}
        verts = list(v)

        def mid(i, j):
            key = (min(i, j), max(i, j))
            if key not in edge_mid:
                m = verts[i] + verts[j]
                m /= np.linalg.norm(m)
                edge_mid[key] = len(verts)
                verts.append(m)
            return edge_mid[key]

        nf = []
        for (i, j, k) in f:
            a, b, c = mid(i, j), mid(j, k), mid(k, i)
            nf += [[i, a, c], [j, b, a], [k, c, b], [a, b, c]]
        v = np.stack(verts)
        f = np.asarray(nf, np.int64)
    return v, f


def blob(subdiv: int = 4, seed: int = 0, amp: float = 0.25, waves: int = 6):
    """Bunny-class organic test mesh: icosphere displaced by a smooth
    random field (sum of `waves` random plane sinusoids).  Returns
    (vertices, faces, vertex_normals); 20·4^subdiv faces."""
    v, f = icosphere(subdiv)
    rng = np.random.default_rng(seed)
    dirs = rng.normal(size=(waves, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    freq = rng.uniform(1.0, 4.0, waves)
    phase = rng.uniform(0.0, 2 * np.pi, waves)
    w = rng.uniform(0.3, 1.0, waves)
    field = sum(w[i] * np.sin(freq[i] * (v @ dirs[i]) + phase[i])
                for i in range(waves))
    field = field / (np.abs(field).max() + 1e-12)
    r = 1.0 + amp * field
    v2 = v * r[:, None]
    # area-weighted vertex normals
    a, b, c = v2[f[:, 0]], v2[f[:, 1]], v2[f[:, 2]]
    fn = np.cross(b - a, c - a)
    vn = np.zeros_like(v2)
    for k in range(3):
        np.add.at(vn, f[:, k], fn)
    vn /= np.maximum(np.linalg.norm(vn, axis=-1, keepdims=True), 1e-30)
    return v2, f, vn


def grid_plane(n: int = 1, size: float = 1.0, y: float = 0.0):
    """A y = const square plane tessellated into 2 n^2 triangles."""
    xs = np.linspace(-size, size, n + 1)
    zs = np.linspace(-size, size, n + 1)
    vx, vz = np.meshgrid(xs, zs, indexing="ij")
    v = np.stack([vx.ravel(), np.full(vx.size, y), vz.ravel()], axis=-1)
    faces = []
    for i in range(n):
        for j in range(n):
            p0 = i * (n + 1) + j
            p1 = p0 + 1
            p2 = p0 + (n + 1)
            p3 = p2 + 1
            faces += [[p0, p1, p3], [p0, p3, p2]]
    return v, np.asarray(faces, np.int64)


def disk(n: int = 64, center=(0, 0, 0), normal=(0, 1, 0), radius: float = 1.0):
    """Tessellated disk (n fan triangles) with exact shading normals."""
    nrm = np.asarray(normal, np.float64)
    nrm /= np.linalg.norm(nrm)
    # build ONB
    h = np.array([1.0, 0, 0]) if abs(nrm[0]) < 0.9 else np.array([0, 1.0, 0])
    u = np.cross(nrm, h)
    u /= np.linalg.norm(u)
    w = np.cross(nrm, u)
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
    rim = (np.asarray(center) + radius * (np.outer(np.cos(ang), u)
                                          + np.outer(np.sin(ang), w)))
    v = np.concatenate([[np.asarray(center, np.float64)], rim])
    faces = [[0, 1 + i, 1 + (i + 1) % n] for i in range(n)]
    return v, np.asarray(faces, np.int64)


def cylinder(n: int = 64, radius: float = 1.0, height: float = 1.0):
    """Open cylinder (axis +y, base at y=0) with smooth vertex normals."""
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
    ring = np.stack([radius * np.cos(ang), np.zeros(n), radius * np.sin(ang)], -1)
    v = np.concatenate([ring, ring + [0, height, 0]])
    nrm = np.concatenate([ring / radius, ring / radius])
    faces = []
    for i in range(n):
        j = (i + 1) % n
        faces += [[i, n + i, n + j], [i, n + j, j]]
    f = np.asarray(faces, np.int64)
    return v, f, nrm


def cone(n: int = 64, radius: float = 1.0, height: float = 1.0):
    """Open cone (apex at (0, h, 0), base rim at y=0) with smooth normals."""
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
    rim = np.stack([radius * np.cos(ang), np.zeros(n), radius * np.sin(ang)], -1)
    apex = np.array([[0.0, height, 0.0]])
    v = np.concatenate([rim, apex])
    # smooth normal on the slant: (cos h, r, sin h) / length
    slant = np.stack([np.cos(ang) * height, np.full(n, radius),
                      np.sin(ang) * height], -1)
    slant /= np.linalg.norm(slant, axis=-1, keepdims=True)
    nrm = np.concatenate([slant, [[0.0, 1.0, 0.0]]])
    faces = [[i, n, (i + 1) % n] for i in range(n)]
    return v, np.asarray(faces, np.int64), nrm
