"""A mirror and a glass copy of a mesh in the empty box: lumo's
``examples/caustics.rs`` (frozen copy of
``lumo_tpu_torch/examples/caustics.py``'s ``make`` with
``lumo_tpu_torch/scene/{cornell.py::empty_box,instance.py}``, reference
``empty_box.rs``).  The mesh is the port's stand-in for Suzanne: the
displaced icosphere of ``subdiv`` subdivisions (20 * 4**subdiv triangles a
copy; ``blob_box.py``'s vectorised subdivision), scaled to unit size,
then each copy centred, turned about y, z and x and moved to its place.
The box is 2 x 1.6 x 2: magenta and cyan microfacet-diffuse side walls,
the floor, ceiling and back wall diffuse in sRGB 242, and a 0.2 x 0.2
area light under the ceiling.  Parameters: ``subdiv``, ``seed``, ``amp``.
"""
from __future__ import annotations

import importlib.util
import math
import os

import numpy as np

PI = math.pi


def _blob_box():
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "blob_box.py")
    spec = importlib.util.spec_from_file_location("caustics_box_blob", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rot(axis, r):
    c, s = np.cos(r), np.sin(r)
    m = np.eye(4)
    i, j = [(1, 2), (2, 0), (0, 1)][axis]
    m[i, i] = c
    m[j, j] = c
    m[i, j] = -s
    m[j, i] = s
    return m


def _translation(x, y, z):
    m = np.eye(4)
    m[:3, 3] = (x, y, z)
    return m


def _bounds(v, m):
    w = v @ m[:3, :3].T + m[:3, 3]
    return w.min(axis=0), w.max(axis=0)


def _placed(v, vn, m_unit, turns, at):
    """``Mesh.clone().to_origin()``, the turns (axis, angle) in order and
    ``translate(*at)`` after ``to_unit_size``'s ``m_unit``, baked as
    ``SceneBuilder.add_triangles`` bakes a transform."""
    lo, hi = _bounds(v, m_unit)
    m = _translation(*(-(0.5 * (lo + hi)))) @ m_unit
    for axis, r in turns:
        m = _rot(axis, r) @ m
    m = _translation(*at) @ m
    verts = v @ m[:3, :3].T + m[:3, 3]
    nm = np.linalg.inv(m[:3, :3]).T
    n = vn @ nm.T
    n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-30)
    return verts, n


def _rectangle(p0, p1, p2):
    p0, p1, p2 = (np.asarray(p, np.float64) for p in (p0, p1, p2))
    return (np.stack([p0, p1, p2, p0 + (p2 - p1)]),
            np.array([[0, 1, 2], [0, 2, 3]], np.int64))


def groups(params: dict) -> list:
    """The light, the five walls, then the mirror and the glass copy."""
    ground, ceiling, right, left, front, back = -0.8, 0.8, 1.0, -1.0, -2.0, 0.0
    l_dim, eps = 0.1, 0.001
    wall = {"kind": "diffuse", "kd": {"srgb8": [242, 242, 242]}}
    rects = [
        (([-l_dim, ceiling - eps, 0.6 * front + l_dim],
          [-l_dim, ceiling - eps, 0.6 * front - l_dim],
          [l_dim, ceiling - eps, 0.6 * front - l_dim]),
         {"kind": "light", "ke": {"srgb8": [252, 201, 138]}}),
        (([left, ground, back], [left, ground, front],
          [left, ceiling, front]),
         {"kind": "diffuse", "kd": {"srgb8": [255, 0, 255]}}),
        (([right, ground, front], [right, ground, back],
          [right, ceiling, back]),
         {"kind": "diffuse", "kd": {"srgb8": [0, 255, 255]}}),
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
    v, f, vn = _blob_box().blob(int(params["subdiv"]), int(params["seed"]),
                                float(params["amp"]))
    lo, hi = _bounds(v, np.eye(4))
    m_unit = np.diag([1.0 / max(hi - lo)] * 3 + [1.0])    # to_unit_size
    for turns, at, kind in (
            (((1, -PI / 8), (2, PI / 8), (0, -PI / 8)), (0.5, -0.3, -1.0),
             "mirror"),
            (((1, PI / 8), (2, -PI / 8), (0, PI / 16)), (-0.35, 0.25, -1.25),
             "glass")):
        pv, pn = _placed(v, vn, m_unit, turns, at)
        out.append({"v": pv, "f": f, "n": pn, "material": {"kind": kind}})
    return out
