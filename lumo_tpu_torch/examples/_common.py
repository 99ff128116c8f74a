"""Shared command line of the example programs.

Counterpart of ``examples/_common.py``: the same flags and defaults, plus
``--accel`` (the acceleration structure ``SceneBuilder.build`` takes,
default ``bvh`` as there).  ``--cpu`` runs on the CPU; without it the
scene and the camera go on the card, and the entry points raise when
none is visible.  Meshes load from ``./scenes/<name>.obj`` when present,
else a procedural stand-in blob of the same triangle-count class is built.
"""
from __future__ import annotations

import argparse
import os


def example_args(default_spp, default_res=512, argv=None, **extra):
    """The program's arguments parsed from ``argv`` (``sys.argv[1:]`` when
    None); ``extra`` maps a flag name to ``add_argument``'s keywords."""
    p = argparse.ArgumentParser()
    p.add_argument("--spp", type=int, default=default_spp)
    p.add_argument("--res", type=int, default=default_res)
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--out", default=None)
    p.add_argument("--accel", default="bvh", choices=["bvh", "kdtree"])
    for name, kw in extra.items():
        p.add_argument(f"--{name}", **kw)
    return p.parse_args(argv)


def device(args):
    """``"cpu"`` with ``--cpu``, else None: the card, or an error."""
    return "cpu" if args.cpu else None


def build(sb, args):
    """The program's scene on its device with its acceleration."""
    return sb.build(accel=args.accel, device=device(args))


def render_and_save(make, args, default_out):
    """``make(args)``, render, write the PNG; returns its path."""
    r = make(args)
    img = r.render()
    out = args.out or default_out
    r.save_png(img, out)
    print(f"saved {out}")
    return out


def load_obj_mesh(path):
    """The first group of the .obj at ``path`` as a Mesh."""
    from lumo_tpu_torch.io import obj as obj_io
    from lumo_tpu_torch.scene.instance import Mesh
    verts, normals, uvs, groups = obj_io.parse_obj(obj_io._read(path))
    fv = groups[0][1]
    return Mesh(verts, fv,
                normals=normals if groups[0][2] is not None else None,
                normal_idx=groups[0][2])


def load_mesh_or_blob(name, subdiv=5, seed=3, amp=0.2):
    """Load ./scenes/<name>.obj if present, else a procedural blob."""
    from lumo_tpu_torch.scene import shapes
    from lumo_tpu_torch.scene.instance import Mesh
    path = os.path.join("scenes", f"{name}.obj")
    if os.path.exists(path):
        return load_obj_mesh(path)
    v, f, vn = shapes.blob(subdiv=subdiv, seed=seed, amp=amp)
    return Mesh(v, f, normals=vn)
