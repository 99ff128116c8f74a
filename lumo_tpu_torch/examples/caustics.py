"""Mirror and glass meshes in an empty box, BDPT caustics (counterpart of
``examples/caustics.py``; a stand-in blob unless ``./scenes/suzanne.obj``
exists)."""
import math

from lumo_tpu_torch.camera import build_camera
from lumo_tpu_torch.color import uplift
from lumo_tpu_torch.examples import _common
from lumo_tpu_torch.renderer import Renderer
from lumo_tpu_torch.scene.cornell import empty_box
from lumo_tpu_torch.scene.materials import Material

PI = math.pi
SPP, OUT = 2048, "caustics.png"
MAGENTA = uplift.from_srgb8(255, 0, 255).reshape(4)
CYAN = uplift.from_srgb8(0, 255, 255).reshape(4)


def parse(argv=None):
    return _common.example_args(SPP, 512, argv)


def camera(args):
    return build_camera(origin=(0.0, 0.0, 2.0), zoom=3.0,
                        resolution=(args.res, args.res),
                        device=_common.device(args))


def make(args):
    sb = empty_box(uplift.from_srgb8(242, 242, 242).reshape(4),
                   Material.diffuse(MAGENTA), Material.diffuse(CYAN))
    suzanne = _common.load_mesh_or_blob("suzanne", subdiv=4, seed=7,
                                        amp=0.15).to_unit_size()
    (suzanne.clone()
     .to_origin().rotate_y(-PI / 8).rotate_z(PI / 8).rotate_x(-PI / 8)
     .translate(0.5, -0.3, -1.0)
     .add_to(sb, Material.mirror()))
    (suzanne.clone()
     .to_origin().rotate_y(PI / 8).rotate_z(-PI / 8).rotate_x(PI / 16)
     .translate(-0.35, 0.25, -1.25)
     .add_to(sb, Material.glass()))
    # long specular chains through the glass
    return (Renderer(_common.build(sb, args), camera(args))
            .integrator("bdpt").samples(args.spp).bdpt_depth(12))


def main(argv=None):
    return _common.render_and_save(make, parse(argv), OUT)


if __name__ == "__main__":
    main()
