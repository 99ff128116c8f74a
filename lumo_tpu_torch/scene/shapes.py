"""Procedural mesh generators (host, numpy).

Counterpart of ``lumo_tpu/scene/shapes.py`` (icosphere and blob; the
other generators come with the scenes that use them).  Test and
benchmark scenes that need real triangle counts use a displaced
icosphere, made from a seed.
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
