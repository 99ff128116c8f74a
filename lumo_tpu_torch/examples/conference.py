"""Conference room from ``./scenes/conference.obj`` (+ ``.mtl``) with two
sphere lights, or a furniture-like stand-in room when the file is absent
(counterpart of ``examples/conference.py``)."""
import os

import numpy as np

from lumo_tpu_torch.camera import build_camera
from lumo_tpu_torch.examples import _common
from lumo_tpu_torch.renderer import Renderer
from lumo_tpu_torch.scene import shapes
from lumo_tpu_torch.scene.instance import Mesh
from lumo_tpu_torch.scene.materials import Material
from lumo_tpu_torch.scene.scene import SceneBuilder

SPP, OUT = 1, "conference.png"


def parse(argv=None):
    return _common.example_args(SPP, 512, argv)


def camera(args):
    return build_camera(origin=(-50.0, 400.0, -350.0),
                        towards=(500.0, 0.0, 250.0),
                        resolution=(args.res, args.res),
                        device=_common.device(args))


def stand_in():
    sb = SceneBuilder()
    white = Material.diffuse((0.73, 0.71, 0.68))
    wood = Material.diffuse((0.44, 0.28, 0.16))
    # room shell 1000x500x800
    gv, gf = shapes.grid_plane(n=1, size=1000.0, y=0.0)
    Mesh(gv, gf).translate(450.0, 0.0, 0.0).add_to(sb, white)
    Mesh(gv, gf).rotate_z(np.pi).translate(450.0, 500.0, 0.0).add_to(sb, white)
    # table and chairs as boxes
    table = np.diag([400.0, 10.0, 150.0, 1.0])
    table[:3, 3] = (450.0, 90.0, 150.0)
    sb.add_box(wood, transform=table)
    for dx in (-120.0, 0.0, 120.0):
        t = np.eye(4)
        t[:3, 3] = (450.0 + dx, 40.0, 150.0)
        t[0, 0] = t[1, 1] = t[2, 2] = 45.0
        sb.add_box(white, transform=t)
    return sb


def make(args):
    if os.path.exists("scenes/conference.obj"):
        from lumo_tpu_torch.io.obj import scene_from_file
        sb = scene_from_file("scenes/conference.obj",
                             mtl_source="scenes/conference.mtl"
                             if os.path.exists("scenes/conference.mtl")
                             else None)
    else:
        sb = stand_in()
    sb.add_sphere((-200.0, 40.0, -400.0), 10.0, Material.light(np.ones(4)))
    sb.add_sphere((900.0, 300.0, -600.0), 10.0, Material.light(np.ones(4)))
    return (Renderer(_common.build(sb, args), camera(args))
            .integrator("path").samples(args.spp))


def main(argv=None):
    return _common.render_and_save(make, parse(argv), OUT)


if __name__ == "__main__":
    main()
