"""Three marble-textured teapots on a checkerboard under an orthographic
thin-lens camera: depth of field (counterpart of ``examples/dof.py``; a
stand-in blob unless ``./scenes/teapot.obj`` exists)."""
import math

import numpy as np

from lumo_tpu_torch.camera import ORTHOGRAPHIC, build_camera
from lumo_tpu_torch.examples import _common
from lumo_tpu_torch.renderer import Renderer
from lumo_tpu_torch.scene import shapes
from lumo_tpu_torch.scene.instance import Mesh
from lumo_tpu_torch.scene.materials import Material
from lumo_tpu_torch.scene.scene import SceneBuilder

PI = math.pi
SPP, OUT = 512, "dof.png"


def parse(argv=None):
    return _common.example_args(SPP, 512, argv)


def camera(args):
    o = np.array([-0.75, 0.25, 0.0])
    t = np.array([0.0, -0.75, -1.0])
    return build_camera(origin=tuple(o), towards=tuple(t), lens_radius=0.03,
                        focal_length=float(np.linalg.norm(o - t)),
                        kind=ORTHOGRAPHIC, resolution=(args.res, args.res),
                        device=_common.device(args))


def make(args):
    sb = SceneBuilder()
    checker = sb.textures.checkerboard((0.0, 0.0, 0.0), (1.0, 1.0, 1.0),
                                       100.0)
    gv, gf = shapes.grid_plane(n=1, size=10.0, y=0.0)
    Mesh(gv, gf).translate(0.0, -1.0, 0.0).add_to(
        sb, Material.diffuse((1.0, 1.0, 1.0), kd_tex=checker))
    lv, lf = shapes.grid_plane(n=1, size=3.0, y=0.0)
    Mesh(lv, lf).rotate_z(PI).translate(0.0, 8.0, -1.5).add_to(
        sb, Material.light(0.25 * np.ones(4), two_sided=True))
    teapot = _common.load_mesh_or_blob("teapot", subdiv=4, seed=5,
                                       amp=0.18).to_unit_size()
    for i in range(3):
        marble = sb.textures.marble((1.0, 245 / 255.0, 1.0))
        (teapot.clone().to_origin().rotate_y(-PI / 4)
         .translate(0.0, -0.75, -1.0 * i)
         .add_to(sb, Material.diffuse((1.0, 1.0, 1.0), kd_tex=marble)))
    return (Renderer(_common.build(sb, args), camera(args))
            .integrator("path").samples(args.spp))


def main(argv=None):
    return _common.render_and_save(make, parse(argv), OUT)


if __name__ == "__main__":
    main()
