"""Mirror and glass spheres in an empty box, BDPT with a wide Gaussian
filter (counterpart of ``examples/box.py``)."""
from lumo_tpu_torch.camera import build_camera
from lumo_tpu_torch.color import uplift
from lumo_tpu_torch.examples import _common
from lumo_tpu_torch.film import PixelFilter
from lumo_tpu_torch.renderer import Renderer
from lumo_tpu_torch.scene.cornell import empty_box
from lumo_tpu_torch.scene.materials import Material

SPP, OUT = 64, "box.png"
MAGENTA = uplift.from_srgb8(255, 0, 255).reshape(4)
CYAN = uplift.from_srgb8(0, 255, 255).reshape(4)


def parse(argv=None):
    return _common.example_args(SPP, 512, argv)


def camera(args):
    return build_camera(resolution=(args.res, args.res),
                        device=_common.device(args))


def make(args):
    sb = empty_box(uplift.from_srgb8(242, 242, 242).reshape(4),
                   Material.diffuse(MAGENTA), Material.diffuse(CYAN))
    sb.add_sphere((-0.45, -0.5, -1.5), 0.25, Material.mirror())
    sb.add_sphere((0.45, -0.5, -1.3), 0.25, Material.glass())
    return (Renderer(_common.build(sb, args), camera(args))
            .integrator("bdpt")
            .samples(args.spp)
            .pixel_filter(PixelFilter.gaussian(2.5, 2.5 / 4.0)))


def main(argv=None):
    return _common.render_and_save(make, parse(argv), OUT)


if __name__ == "__main__":
    main()
