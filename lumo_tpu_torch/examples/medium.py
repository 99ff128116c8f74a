"""Cornell box filled with a homogeneous scattering medium (counterpart
of ``examples/medium.py``)."""
from lumo_tpu_torch.camera import cornell_camera
from lumo_tpu_torch.examples import _common
from lumo_tpu_torch.renderer import Renderer
from lumo_tpu_torch.scene.cornell import cornell_box

SPP, OUT = 512, "cornell_medium.png"


def parse(argv=None):
    return _common.example_args(SPP, 512, argv)


def camera(args):
    return cornell_camera(resolution=(args.res, args.res),
                          device=_common.device(args))


def make(args):
    sb = cornell_box()
    sb.set_medium((0.5, 0.5, 0.5), (0.1, 0.1, 0.1), 0.9)
    return (Renderer(_common.build(sb, args), camera(args))
            .integrator("path")
            .samples(args.spp)
            .illuminant("CORNELL"))


def main(argv=None):
    return _common.render_and_save(make, parse(argv), OUT)


if __name__ == "__main__":
    main()
