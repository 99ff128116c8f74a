"""Whether ``[devices]``' waiting ranks slow the process that started them.

``chip_smoke.py`` starts ``[devices]``' two gloo ranks before
``[parity-kd]``: each joins the group, builds the 327,692-triangle scene on
the card and waits for a go file while the phases in between run.  This
tool times frames of that scene at 256^2 (direct light and the path
integrator at 4 spp, BDPT at depth 6 and 1 spp; a warm-up frame each)
and, with ``--phases``, the whole ``[materials]`` and ``[bdpt]`` phases
(which run while the ranks wait), in turns: no ranks, the ranks waiting,
the ranks waiting, no ranks (after they ran).  It prints one JSON line
with every frame's wall seconds, each turn's medians and phase seconds,
and the card's name and power limit.

    python -m lumo_tpu_torch.tools.ranks_idle [--phases]   # with a card
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
TURNS = ("none", "waiting", "waiting", "none")


def frames(cs, scene, camera, n):
    """{integrator: [wall seconds of n frames]} after a warm-up frame."""
    walls = {}
    for kind in ("direct", "path", "bdpt"):
        conf = (lambda r: r.bdpt_depth(cs.BDPT_BENCH_DEPTH)) \
            if kind == "bdpt" else None
        spp = 1 if kind == "bdpt" else cs.SPP
        cs.integrator_frame(scene, camera, kind, spp, configure=conf)
        walls[kind] = [cs.integrator_frame(scene, camera, kind, spp,
                                           configure=conf)[2]
                       for _ in range(n)]
    return walls


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--setup-s", type=float, default=25.0,
                    help="seconds the ranks get to set up before timing")
    ap.add_argument("--phases", action="store_true",
                    help="also time chip_smoke's [materials] and [bdpt]")
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("ranks_idle: no CUDA device is visible", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from lumo_tpu_torch.camera import build_camera
    from lumo_tpu_torch.parallel import distributed
    dev = torch.device("cuda")
    cs.phase_card()
    camera = build_camera(resolution=(cs.RES, cs.RES), device=dev)
    scene = cs.bench_scene(dev)
    turns, started = [], None
    try:
        for turn in TURNS:
            if turn == "waiting" and started is None:
                started = cs.start_devices_ranks(dev, cs.RES)
                time.sleep(args.setup_s)
            if turn == "none" and started is not None:
                with open(started["go"], "w") as f:
                    f.write("go")
                distributed.join_ranks(started["ctx"], cs.DEV_TIMEOUT_S)
                cs.stop_devices_ranks(started)
                started = None
            walls = frames(cs, scene, camera, args.frames)
            out = {"ranks": turn, "wall_s": walls, "median_s": {
                k: float(np.median(v)) for k, v in walls.items()}}
            if args.phases:
                for name, phase in (
                        ("materials", lambda: cs.phase_materials(dev)),
                        ("bdpt", lambda: cs.phase_bdpt(scene, camera, dev,
                                                       {}))):
                    t0 = time.perf_counter()
                    phase()
                    out[f"{name}_phase_s"] = time.perf_counter() - t0
            turns.append(out)
    finally:
        cs.stop_devices_ranks(started)
    print(json.dumps({"card": cs.card_line(), "res": cs.RES,
                      "frames": args.frames, "turns": turns}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
