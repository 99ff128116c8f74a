"""Scene fixtures: the measured-data Cornell box and the parameterized
empty box.

Counterpart of ``lumo_tpu/scene/cornell.py`` (reference
``src/tracer/scene/{cornell_box,empty_box}.rs``).
The wall reflectance spectra and geometry are the published Cornell-box
measurement data (Cornell University Program of Computer Graphics).
"""
from __future__ import annotations

import numpy as np

from lumo_tpu_torch.color import uplift
from lumo_tpu_torch.scene.materials import Material
from lumo_tpu_torch.scene.scene import SceneBuilder

# Published Cornell measurement data ("λ:v" pairs, 4nm steps 400-700nm)
_WHITE = ("400:0.343 404:0.445 408:0.551 412:0.624 416:0.665 420:0.687 424:0.708 "
          "428:0.723 432:0.715 436:0.71 440:0.745 444:0.758 448:0.739 452:0.767 "
          "456:0.777 460:0.765 464:0.751 468:0.745 472:0.748 476:0.729 480:0.745 "
          "484:0.757 488:0.753 492:0.75 496:0.746 500:0.747 504:0.735 508:0.732 "
          "512:0.739 516:0.734 520:0.725 524:0.721 528:0.733 532:0.725 536:0.732 "
          "540:0.743 544:0.744 548:0.748 552:0.728 556:0.716 560:0.733 564:0.726 "
          "568:0.713 572:0.74 576:0.754 580:0.764 584:0.752 588:0.736 592:0.734 "
          "596:0.741 600:0.74 604:0.732 608:0.745 612:0.755 616:0.751 620:0.744 "
          "624:0.731 628:0.733 632:0.744 636:0.731 640:0.712 644:0.708 648:0.729 "
          "652:0.73 656:0.727 660:0.707 664:0.703 668:0.729 672:0.75 676:0.76 "
          "680:0.751 684:0.739 688:0.724 692:0.73 696:0.74 700:0.737")
_GREEN = ("400:0.092 404:0.096 408:0.098 412:0.097 416:0.098 420:0.095 424:0.095 "
          "428:0.097 432:0.095 436:0.094 440:0.097 444:0.098 448:0.096 452:0.101 "
          "456:0.103 460:0.104 464:0.107 468:0.109 472:0.112 476:0.115 480:0.125 "
          "484:0.14 488:0.16 492:0.187 496:0.229 500:0.285 504:0.343 508:0.39 "
          "512:0.435 516:0.464 520:0.472 524:0.476 528:0.481 532:0.462 536:0.447 "
          "540:0.441 544:0.426 548:0.406 552:0.373 556:0.347 560:0.337 564:0.314 "
          "568:0.285 572:0.277 576:0.266 580:0.25 584:0.23 588:0.207 592:0.186 "
          "596:0.171 600:0.16 604:0.148 608:0.141 612:0.136 616:0.13 620:0.126 "
          "624:0.123 628:0.121 632:0.122 636:0.119 640:0.114 644:0.115 648:0.117 "
          "652:0.117 656:0.118 660:0.12 664:0.122 668:0.128 672:0.132 676:0.139 "
          "680:0.144 684:0.146 688:0.15 692:0.152 696:0.157 700:0.159")
_RED = ("400:0.04 404:0.046 408:0.048 412:0.053 416:0.049 420:0.05 424:0.053 "
        "428:0.055 432:0.057 436:0.056 440:0.059 444:0.057 448:0.061 452:0.061 "
        "456:0.06 460:0.062 464:0.062 468:0.062 472:0.061 476:0.062 480:0.06 "
        "484:0.059 488:0.057 492:0.058 496:0.058 500:0.058 504:0.056 508:0.055 "
        "512:0.056 516:0.059 520:0.057 524:0.055 528:0.059 532:0.059 536:0.058 "
        "540:0.059 544:0.061 548:0.061 552:0.063 556:0.063 560:0.067 564:0.068 "
        "568:0.072 572:0.08 576:0.09 580:0.099 584:0.124 588:0.154 592:0.192 "
        "596:0.255 600:0.287 604:0.349 608:0.402 612:0.443 616:0.487 620:0.513 "
        "624:0.558 628:0.584 632:0.62 636:0.606 640:0.609 644:0.651 648:0.612 "
        "652:0.61 656:0.65 660:0.638 664:0.627 668:0.62 672:0.63 676:0.628 "
        "680:0.642 684:0.639 688:0.657 692:0.639 696:0.635 700:0.642")
_LIGHT = "400:0 500:8 600:15.6 700:18.4"


def _quads_to_tris(sb: SceneBuilder, vertices, mat):
    """Fan-triangulate groups of 4 vertices (reference box_faces pattern)."""
    v = np.asarray(vertices, np.float64)
    faces = []
    for q in range(len(v) // 4):
        v0 = q * 4
        faces.append([v0, v0 + 1, v0 + 2])
        faces.append([v0, v0 + 2, v0 + 3])
    sb.add_triangles(v, np.array(faces), mat)


def cornell_box() -> SceneBuilder:
    """The original Cornell box (reference ``cornell_box.rs:8-200``)."""
    sb = SceneBuilder()
    white = Material.lambertian(_WHITE)
    red = Material.lambertian(_RED)
    green = Material.lambertian(_GREEN)
    box_m = Material.lambertian(_WHITE)
    light = Material.light(_LIGHT, illuminant="CORNELL")

    # light (one rectangle just below the ceiling)
    sb.add_rectangle([343.0, 548.8, 227.0], [343.0, 548.8, 332.0],
                     [213.0, 548.8, 332.0], light)
    # floor
    _quads_to_tris(sb, [[552.8, 0, 0], [0, 0, 0], [0, 0, 559.2], [549.6, 0, 559.2]],
                   white)
    # ceiling
    _quads_to_tris(sb, [[556, 548.8, 0], [556, 548.8, 559.2], [0, 548.8, 559.2],
                        [0, 548.8, 0]], white)
    # back wall
    _quads_to_tris(sb, [[549.6, 0, 559.2], [0, 0, 559.2], [0, 548.8, 559.2],
                        [556, 548.8, 559.2]], white)
    # right (green) wall
    _quads_to_tris(sb, [[0, 0, 559.2], [0, 0, 0], [0, 548.8, 0], [0, 548.8, 559.2]],
                   green)
    # left (red) wall
    _quads_to_tris(sb, [[552.8, 0, 0], [549.6, 0, 559.2], [556, 548.8, 559.2],
                        [556, 548.8, 0]], red)
    # small box
    _quads_to_tris(sb, [
        [130, 165, 65], [82, 165, 225], [240, 165, 272], [290, 165, 114],
        [290, 0, 114], [290, 165, 114], [240, 165, 272], [240, 0, 272],
        [130, 0, 65], [130, 165, 65], [290, 165, 114], [290, 0, 114],
        [82, 0, 225], [82, 165, 225], [130, 165, 65], [130, 0, 65],
        [240, 0, 272], [240, 165, 272], [82, 165, 225], [82, 0, 225],
    ], box_m)
    # big box
    _quads_to_tris(sb, [
        [423, 330, 247], [265, 330, 296], [314, 330, 456], [472, 330, 406],
        [423, 0, 247], [423, 330, 247], [472, 330, 406], [472, 0, 406],
        [472, 0, 406], [472, 330, 406], [314, 330, 456], [314, 0, 456],
        [314, 0, 456], [314, 330, 456], [265, 330, 296], [265, 0, 296],
        [265, 0, 296], [265, 330, 296], [423, 330, 247], [423, 0, 247],
    ], box_m)
    return sb


def empty_box(def_color, mat_left: Material, mat_right: Material,
              light_srgb=(252, 201, 138)) -> SceneBuilder:
    """Empty 2×1.6×2 box centered at (0,0,-1) for the default camera
    (reference ``empty_box.rs:16-98``)."""
    sb = SceneBuilder()
    ground, ceiling = -0.8, 0.8
    right, left = 1.0, -1.0
    front, back = -2.0, 0.0
    l_dim, eps = 0.1, 0.001

    light = Material.light(uplift.from_srgb8(*light_srgb).reshape(4))
    sb.add_rectangle([-l_dim, ceiling - eps, 0.6 * front + l_dim],
                     [-l_dim, ceiling - eps, 0.6 * front - l_dim],
                     [l_dim, ceiling - eps, 0.6 * front - l_dim], light)
    sb.add_rectangle([left, ground, back], [left, ground, front],
                     [left, ceiling, front], mat_left)
    sb.add_rectangle([right, ground, front], [right, ground, back],
                     [right, ceiling, back], mat_right)
    for tri in [
        ([left, ground, back], [right, ground, back], [right, ground, front]),
        ([left, ceiling, front], [right, ceiling, front], [right, ceiling, back]),
        ([left, ground, front], [right, ground, front], [right, ceiling, front]),
    ]:
        sb.add_rectangle(*tri, Material.diffuse(def_color))
    return sb
