"""Textured bust between black disks lit by a quad light (counterpart of
``examples/nefertiti.py``; a stand-in blob with a marble texture unless
``./scenes/nefertiti.obj`` exists)."""
import math

import numpy as np

from lumo_tpu_torch.camera import build_camera
from lumo_tpu_torch.examples import _common
from lumo_tpu_torch.renderer import Renderer
from lumo_tpu_torch.scene.materials import Material
from lumo_tpu_torch.scene.scene import SceneBuilder

PI = math.pi
SPP, OUT = 512, "nefertiti.png"


def parse(argv=None):
    return _common.example_args(SPP, 512, argv)


def camera(args):
    return build_camera(origin=(0.1, 0.2, 0.3), towards=(0.0, 0.1, -1.0),
                        resolution=(args.res, args.res),
                        device=_common.device(args))


def make(args):
    sb = SceneBuilder()
    r = 10.0
    black = Material.diffuse((0.0, 0.0, 0.0))
    sb.add_disk((0.0, -1.0, 0.0), (0.0, 1.0, 0.0), r, black)    # floor
    sb.add_disk((0.0, 1.0, 0.0), (0.0, -1.0, 0.0), r, black)    # roof
    sb.add_disk((1.0, 0.0, 0.0), (-1.0, 0.0, 0.0), r, black)    # right wall
    sb.add_rectangle([-0.4, 0.99, -1.4], [-0.4, 0.99, -0.6],
                     [0.4, 0.99, -0.6], Material.light(1.5 * np.ones(4)))
    bust = _common.load_mesh_or_blob("nefertiti", subdiv=5, seed=21,
                                     amp=0.18)
    marble = sb.textures.marble((0.9, 0.85, 0.8))
    (bust.to_unit_size().to_origin().rotate_x(-PI / 2).rotate_y(PI)
     .set_y(-0.99).translate(0.0, 0.0, -1.0)
     .add_to(sb, Material.diffuse((1.0, 1.0, 1.0), kd_tex=marble)))
    return (Renderer(_common.build(sb, args), camera(args))
            .integrator("path").samples(args.spp))


def main(argv=None):
    return _common.render_and_save(make, parse(argv), OUT)


if __name__ == "__main__":
    main()
