"""A displaced icosphere in the empty box (frozen copy of
``lumo_tpu_torch/bench.py``'s ``bench_scene`` with
``lumo_tpu_torch/scene/{cornell.py::empty_box,shapes.py,instance.py}``,
reference ``empty_box.rs``): the blob of ``subdiv`` subdivisions
(20 * 4**subdiv triangles), GGX metal, on the floor of a 2 x 1.6 x 2
box lit by a small ceiling rectangle.  Parameters: ``subdiv``, ``seed``,
``amp``, ``metal`` (ks, roughness, eta, k).  The subdivision is
vectorised: the same faces in the same order, vertices within an ulp of
the port's ``shapes.icosphere`` (its per-vertex norms round otherwise),
in a tenth of a second where the dictionary walk takes seconds."""
from __future__ import annotations

import numpy as np


def icosphere(subdiv: int):
    """The subdivided icosahedron on the unit sphere: (V, 3), (F, 3)."""
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
        # edge midpoints numbered in the order the faces first meet them,
        # as a dictionary walk over (i, j), (j, k), (k, i) numbers them
        e = np.stack([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]],
                     axis=1).reshape(-1, 2)
        key = np.minimum(e[:, 0], e[:, 1]) * len(v) + np.maximum(e[:, 0],
                                                                 e[:, 1])
        uniq, first, inv = np.unique(key, return_index=True,
                                     return_inverse=True)
        rank = np.empty(len(uniq), np.int64)
        rank[np.argsort(first, kind="stable")] = np.arange(len(uniq))
        ends = e[np.sort(first)]
        m = v[ends[:, 0]] + v[ends[:, 1]]
        m /= np.linalg.norm(m, axis=-1, keepdims=True)
        mid = (len(v) + rank[inv]).reshape(-1, 3)
        a, b, c = mid[:, 0], mid[:, 1], mid[:, 2]
        i, j, k = f[:, 0], f[:, 1], f[:, 2]
        f = np.stack([np.stack([i, a, c], 1), np.stack([j, b, a], 1),
                      np.stack([k, c, b], 1), np.stack([a, b, c], 1)],
                     axis=1).reshape(-1, 3)
        v = np.concatenate([v, m])
    return v, f


def blob(subdiv: int, seed: int, amp: float, waves: int = 6):
    """The icosphere displaced by a sum of random plane sinusoids:
    (vertices, faces, area-weighted vertex normals)."""
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
    v2 = v * (1.0 + amp * field)[:, None]
    a, b, c = v2[f[:, 0]], v2[f[:, 1]], v2[f[:, 2]]
    fn = np.cross(b - a, c - a)
    vn = np.zeros_like(v2)
    for k in range(3):
        np.add.at(vn, f[:, k], fn)
    vn /= np.maximum(np.linalg.norm(vn, axis=-1, keepdims=True), 1e-30)
    return v2, f, vn


def _translation(x, y, z):
    m = np.eye(4)
    m[:3, 3] = (x, y, z)
    return m


def _placed(v, vn):
    """``Mesh(...).to_unit_size().to_origin().set_y(-0.799)
    .translate(0, 0, -1.5)`` baked into the vertices and normals."""
    m = np.eye(4)

    def bounds():
        w = v @ m[:3, :3].T + m[:3, 3]
        return w.min(axis=0), w.max(axis=0)

    lo, hi = bounds()
    s = 1.0 / max(hi - lo)
    m = np.diag([s, s, s, 1.0]) @ m
    lo, hi = bounds()
    m = _translation(*(-0.5 * (lo + hi))) @ m
    lo, hi = bounds()
    m = _translation(0, -0.799 - lo[1], 0) @ m
    m = _translation(0.0, 0.0, -1.5) @ m
    verts = v @ m[:3, :3].T + m[:3, 3]
    n = vn @ np.linalg.inv(m[:3, :3])
    n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-30)
    return verts, n


def _rectangle(p0, p1, p2):
    p0, p1, p2 = (np.asarray(p, np.float64) for p in (p0, p1, p2))
    return (np.stack([p0, p1, p2, p0 + (p2 - p1)]),
            np.array([[0, 1, 2], [0, 2, 3]], np.int64))


def groups(params: dict) -> list:
    """The light, the five walls, then the blob."""
    ground, ceiling, right, left, front, back = -0.8, 0.8, 1.0, -1.0, -2.0, 0.0
    l_dim, eps = 0.1, 0.001
    wall = {"kind": "diffuse", "kd": [0.95, 0.95, 0.95]}
    rects = [
        (([-l_dim, ceiling - eps, 0.6 * front + l_dim],
          [-l_dim, ceiling - eps, 0.6 * front - l_dim],
          [l_dim, ceiling - eps, 0.6 * front - l_dim]),
         {"kind": "light", "ke": {"srgb8": [252, 201, 138]}}),
        (([left, ground, back], [left, ground, front],
          [left, ceiling, front]), {"kind": "diffuse", "kd": [0.9, 0.1, 0.1]}),
        (([right, ground, front], [right, ground, back],
          [right, ceiling, back]), {"kind": "diffuse", "kd": [0.1, 0.9, 0.1]}),
        (([left, ground, back], [right, ground, back],
          [right, ground, front]), wall),
        (([left, ceiling, front], [right, ceiling, front],
          [right, ceiling, back]), wall),
        (([left, ground, front], [right, ground, front],
          [right, ceiling, front]), wall),
    ]
    out = []
    for corners, mat in rects:
        v, f = _rectangle(*corners)
        out.append({"v": v, "f": f, "n": None, "material": dict(mat)})
    v, f, vn = blob(int(params["subdiv"]), int(params["seed"]),
                    float(params["amp"]))
    v, vn = _placed(v, vn)
    ks, rough, eta, k = params["metal"]
    out.append({"v": v, "f": f, "n": vn,
                "material": {"kind": "metal", "ks": list(ks),
                             "roughness": rough, "eta": eta, "k": k}})
    return out
