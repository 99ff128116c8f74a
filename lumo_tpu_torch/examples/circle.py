"""Ring of hue-swept diffuse spheres on a mirror disk around a small
spherical D65 light (counterpart of ``examples/circle.py``)."""
import math

import numpy as np

from lumo_tpu_torch.camera import build_camera
from lumo_tpu_torch.color import uplift
from lumo_tpu_torch.examples import _common
from lumo_tpu_torch.renderer import Renderer
from lumo_tpu_torch.scene.materials import Material
from lumo_tpu_torch.scene.scene import SceneBuilder

PI = math.pi
SPP, OUT = 512, "circle.png"


def parse(argv=None):
    return _common.example_args(SPP, 512, argv)


def hsv_to_rgb(h):
    """s = v = 1; h in radians (reference ``circle.rs:4-14``)."""
    def f(n):
        k = (n + h / (PI / 3.0)) % 6.0
        return 1.0 - np.clip(min(k, 4.0 - k), 0.0, 1.0)
    return uplift.from_srgb8(int(f(5.0) * 255), int(f(3.0) * 255),
                             int(f(1.0) * 255)).reshape(4)


def camera(args):
    return build_camera(origin=(0.0, 1.0, 1.5), towards=(0.0, -0.5, 0.0),
                        up=(0.0, 1.0, -1.0), resolution=(args.res, args.res),
                        device=_common.device(args))


def make(args):
    sb = SceneBuilder()
    ground, r = -0.2, 0.2
    sb.add_disk((0.0, ground, 0.0), (0.0, 1.0, 0.0), 100.0, Material.mirror())
    sb.add_sphere((0.0, ground + r + 0.1, 0.0), r,
                  Material.light(0.01 * np.ones(4), illuminant="D65"))
    circle_s = 8
    offset = PI / circle_s
    for i in range(circle_s):
        theta = (i / circle_s) * 2.0 * PI + offset
        sb.add_sphere((math.cos(theta), ground + r, math.sin(theta)), r,
                      Material.diffuse(hsv_to_rgb(theta - offset)))
    return (Renderer(_common.build(sb, args), camera(args))
            .integrator("path").samples(args.spp))


def main(argv=None):
    return _common.render_and_save(make, parse(argv), OUT)


if __name__ == "__main__":
    main()
