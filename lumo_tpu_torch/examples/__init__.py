"""The example programs of the port, each the counterpart of the JAX
package's program of the same name in ``examples/``: build a scene and a
camera, configure a ``Renderer``, render, write a PNG.

Run one as ``python -m lumo_tpu_torch.examples.<name> [--spp N] [--res R]
[--cpu] [--out F] [--accel {bvh,kdtree}]``.  Without ``--cpu`` it runs on
the card and raises ``RuntimeError`` when none is visible.  Each module
gives ``camera(args)``, ``make(args)`` (the configured ``Renderer``, not
yet rendered) and ``main(argv=None)`` (parse, make, render, save; returns
the PNG's path); nothing runs at import.
"""
NAMES = ("cornell", "dragon", "bunny", "dof", "nefertiti", "circle",
         "medium", "box", "caustics", "conference", "bistro")
