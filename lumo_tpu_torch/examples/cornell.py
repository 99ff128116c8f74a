"""Render the Cornell box (counterpart of ``examples/cornell.py``)."""
from lumo_tpu_torch.camera import cornell_camera
from lumo_tpu_torch.examples import _common
from lumo_tpu_torch.renderer import Renderer
from lumo_tpu_torch.scene.cornell import cornell_box

SPP, OUT = 512, "cornell.png"


def parse(argv=None):
    return _common.example_args(
        SPP, 512, argv,
        integrator=dict(default="path", choices=["path", "direct", "bdpt"]))


def camera(args):
    return cornell_camera(resolution=(args.res, args.res),
                          device=_common.device(args))


def make(args):
    return (Renderer(_common.build(cornell_box(), args), camera(args))
            .samples(args.spp)
            .integrator(args.integrator)
            .illuminant("CORNELL"))


def main(argv=None):
    return _common.render_and_save(make, parse(argv), OUT)


if __name__ == "__main__":
    main()
