"""Rough-transparent dragon in an empty box (counterpart of
``examples/dragon.py``; a stand-in blob unless ``./scenes/dragon.obj``
exists)."""
import math

from lumo_tpu_torch.camera import build_camera
from lumo_tpu_torch.color import uplift
from lumo_tpu_torch.examples import _common
from lumo_tpu_torch.renderer import Renderer
from lumo_tpu_torch.scene.cornell import empty_box
from lumo_tpu_torch.scene.materials import Material

PI = math.pi
SPP, OUT = 512, "dragon.png"


def parse(argv=None):
    return _common.example_args(SPP, 512, argv)


def camera(args):
    return build_camera(resolution=(args.res, args.res),
                        device=_common.device(args))


def make(args):
    sb = empty_box(uplift.from_srgb8(242, 242, 242).reshape(4),
                   Material.diffuse(uplift.from_srgb8(255, 0, 0).reshape(4)),
                   Material.diffuse(uplift.from_srgb8(0, 255, 0).reshape(4)))
    dragon = _common.load_mesh_or_blob("dragon", subdiv=5, seed=13, amp=0.25)
    magenta = uplift.from_srgb8(255, 0, 255).reshape(4)
    (dragon.to_unit_size().to_origin().rotate_y(5.0 * PI / 8.0)
     .scale_uniform(1.3).set_y(-0.799).translate(0.0, 0.0, -1.4)
     .add_to(sb, Material.transparent(magenta, 0.03, 1.5)))
    return (Renderer(_common.build(sb, args), camera(args))
            .integrator("path").samples(args.spp))


def main(argv=None):
    return _common.render_and_save(make, parse(argv), OUT)


if __name__ == "__main__":
    main()
