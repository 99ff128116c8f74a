"""Single-device Renderer frames of two source trees, in turns, on one card.

Each entry of ``--order`` runs in a process of its own against one source
tree (this checkout, or another one such as an unpacked ``git archive`` of
a parent commit) and, with the tree's own code and kernels:

- builds the 327,692-triangle scene of ``chip_smoke.py`` with a BVH and
  with a kd-tree;
- renders each case of ``CASES`` through ``Renderer(scene, camera)`` at
  256^2 on one device (no ``.devices``, no process group): a warm-up
  frame, then ``--frames`` timed frames, each ending with the image on
  the host;
- saves the last image of each case and prints one JSON line of the
  frames' wall seconds.

The summary prints, for each case and run, the median wall and the
largest absolute difference of its image from the first run's, so that a
change to the Renderer's plumbing can be shown to leave the images and
the frame time as they were.

    python -m lumo_tpu_torch.tools.render_ab --tree old=out/parent \\
        --order old,new,new,old          # on a machine with a card

``new`` is this checkout.  The summary goes to standard output and, whole,
to ``--json`` (default ``out/render_ab.json``).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))

# (name, accelerator, integrator, samples, stream, BDPT depth)
CASES = (("path", "bvh", "path", 4, False, None),
         ("stream", "bvh", "path", 4, True, None),
         ("direct", "bvh", "direct", 4, False, None),
         ("bdpt", "bvh", "bdpt", 1, False, 6),
         ("path-kd", "kdtree", "path", 4, False, None),
         ("stream-kd", "kdtree", "path", 4, True, None))


def worker(root, frames, out):
    sys.path.insert(0, root)
    import numpy as np
    import torch
    from lumo_tpu_torch.camera import build_camera
    from lumo_tpu_torch.renderer import Renderer
    import chip_smoke as cs
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    camera = build_camera(resolution=(cs.RES, cs.RES), device=dev)
    scenes, walls, images = {}, {}, {}
    for name, accel, kind, spp, stream, depth in CASES:
        if accel not in scenes:
            scenes[accel] = cs.bench_scene(dev, accel)
        r = Renderer(scenes[accel], camera).integrator(kind).samples(spp)
        if stream:
            r.stream()
        if depth is not None:
            r.bdpt_depth(depth)
        r.render(verbose=False)                                 # warm-up
        walls[name] = []
        for _ in range(frames):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            images[name] = r.render(verbose=False)
            walls[name].append(time.perf_counter() - t0)
    np.savez(out, **images)
    print(json.dumps({"root": root, "wall_s": walls}), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", default=[],
                    help="NAME=PATH of another source tree")
    ap.add_argument("--order", default="new",
                    help="comma-separated names, run in this order")
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--json", default=os.path.join(ROOT, "out",
                                                   "render_ab.json"),
                    help="where the whole result goes")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--root", default=ROOT, help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        worker(args.root, args.frames, args.out)
        return 0
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("render_ab: no CUDA device is visible", file=sys.stderr)
        return 1
    runs = {"new": ROOT}
    for spec in args.tree:
        name, path = spec.split("=", 1)
        runs[name] = os.path.abspath(path)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"[ab] card={card!r}", flush=True)
    results, first = [], None
    with tempfile.TemporaryDirectory() as tmp:
        for i, name in enumerate(args.order.split(",")):
            root = runs[name]
            out = os.path.join(tmp, f"run{i}.npz")
            cmd = [sys.executable, os.path.abspath(__file__), "--worker",
                   "--root", root, "--frames", str(args.frames),
                   "--out", out]
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  cwd=root, timeout=900)
            if proc.returncode != 0:
                raise RuntimeError(f"{name} failed:\n{proc.stderr[-4000:]}")
            res = json.loads(proc.stdout.strip().splitlines()[-1])
            images = dict(np.load(out))
            first = first or images
            res["name"] = name
            res["max_abs_diff_vs_first_run"] = {
                k: float(np.abs(v - first[k]).max())
                for k, v in images.items()}
            results.append(res)
            print(f"[ab] run={name} " + " ".join(
                f"{k}_median_s={float(np.median(w))} "
                f"{k}_max_abs_diff={res['max_abs_diff_vs_first_run'][k]}"
                for k, w in res["wall_s"].items()), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
    with open(args.json, "w") as f:
        json.dump({"card": card, "runs": results}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
