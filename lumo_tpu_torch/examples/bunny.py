"""Metal bunny in an empty Cornell box, path traced over a BVH
(counterpart of ``examples/bunny.py``; a displaced icosphere of ~20k
triangles stands in unless ``./scenes/bunny.obj`` exists)."""
import os

from lumo_tpu_torch.camera import build_camera
from lumo_tpu_torch.examples import _common
from lumo_tpu_torch.renderer import Renderer
from lumo_tpu_torch.scene import shapes
from lumo_tpu_torch.scene.cornell import empty_box
from lumo_tpu_torch.scene.instance import Mesh
from lumo_tpu_torch.scene.materials import Material

SPP, OUT = 256, "bunny.png"


def parse(argv=None):
    return _common.example_args(SPP, 512, argv,
                                subdiv=dict(type=int, default=5))


def camera(args):
    return build_camera(resolution=(args.res, args.res),
                        device=_common.device(args))


def make(args):
    sb = empty_box((0.95, 0.95, 0.95),
                   Material.diffuse((0.9, 0.1, 0.1)),
                   Material.diffuse((0.1, 0.9, 0.1)))
    if os.path.exists("scenes/bunny.obj"):
        mesh = _common.load_obj_mesh("scenes/bunny.obj")
    else:
        v, f, vn = shapes.blob(subdiv=args.subdiv, seed=11, amp=0.22)
        mesh = Mesh(v, f, normals=vn)
    bunny = Material.metal((0.9, 0.7, 0.1), 0.1, 2.5, 3.0)
    (mesh.to_unit_size().to_origin().set_y(-0.799).translate(0.0, 0.0, -1.5)
     .add_to(sb, bunny))
    scene = _common.build(sb, args)
    tree = (f"{args.accel} on ({scene.n_tris} tris)"
            if scene.bvh is not None or scene.kdtree is not None else "off")
    print(f"scene: {scene.n_tris} tris, {tree}")
    return Renderer(scene, camera(args)).samples(args.spp)


def main(argv=None):
    return _common.render_and_save(make, parse(argv), OUT)


if __name__ == "__main__":
    main()
