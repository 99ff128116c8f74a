"""Bistro exterior: .obj/.mtl scene, HDR environment map and Reinhard
tone map through BDPT (counterpart of ``examples/bistro.py``).  Without
``./scenes/exterior.obj`` a procedural street with an analytic sky
gradient as the environment map runs the same path (the environment as
a sphere light, Reinhard, BDPT)."""
import os

import numpy as np

from lumo_tpu_torch.camera import build_camera
from lumo_tpu_torch.examples import _common
from lumo_tpu_torch.renderer import Renderer
from lumo_tpu_torch.scene import shapes
from lumo_tpu_torch.scene.instance import Mesh
from lumo_tpu_torch.scene.materials import Material
from lumo_tpu_torch.scene.scene import SceneBuilder

SPP, OUT = 1024, "bistro_night.png"


def parse(argv=None):
    return _common.example_args(SPP, 512, argv)


def camera(args):
    return build_camera(origin=(-16.0, 5.0, -1.0), towards=(0.0, 0.0, 0.0),
                        resolution=(args.res, args.res),
                        device=_common.device(args))


def from_file():
    from lumo_tpu_torch.io.obj import scene_from_file
    sb = scene_from_file("scenes/exterior.obj",
                         mtl_source="scenes/exterior-night.mtl"
                         if os.path.exists("scenes/exterior-night.mtl")
                         else None)
    if os.path.exists("scenes/cobblestone_street_night_4k.hdr"):
        from lumo_tpu_torch.io.image import load_hdr
        hdr = load_hdr("scenes/cobblestone_street_night_4k.hdr") * 0.001
        env = sb.textures.image(hdr)
        sb.set_environment_map(Material.light((1.0, 1.0, 1.0), ke_tex=env))
    return sb


def stand_in():
    sb = SceneBuilder()
    street = Material.diffuse((0.3, 0.3, 0.32))
    gv, gf = shapes.grid_plane(n=1, size=60.0, y=0.0)
    Mesh(gv, gf).add_to(sb, street)
    rng = np.random.default_rng(4)
    for i in range(8):  # facades
        t = np.eye(4)
        t[0, 0], t[1, 1], t[2, 2] = 4.0, 4.0 + 3.0 * rng.uniform(), 4.0
        t[:3, 3] = (-12.0 + 4.0 * i, t[1, 1] / 2.0, 6.0 * (-1) ** i)
        sb.add_box(Material.diffuse(tuple(0.3 + 0.4 * rng.uniform(size=3))),
                   transform=t)
    # analytic night-sky gradient as the HDR environment image
    h, w = 64, 128
    v = np.linspace(0.0, 1.0, h)[:, None, None]
    sky = np.concatenate([0.02 + 0.05 * (1 - v), 0.03 + 0.06 * (1 - v),
                          0.08 + 0.12 * (1 - v)], axis=-1)
    sky = np.broadcast_to(sky, (h, w, 3)).copy()
    sky[10:14, 30:34] = (6.0, 5.5, 4.5)  # moon patch
    env = sb.textures.image(sky)
    sb.set_environment_map(Material.light((1.0, 1.0, 1.0), ke_tex=env))
    return sb


def make(args):
    sb = from_file() if os.path.exists("scenes/exterior.obj") else stand_in()
    return (Renderer(_common.build(sb, args), camera(args))
            .integrator("bdpt")
            .samples(args.spp)
            .tone_map("reinhard"))


def main(argv=None):
    return _common.render_and_save(make, parse(argv), OUT)


if __name__ == "__main__":
    main()
