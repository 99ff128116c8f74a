"""Peak device memory of one BDPT step against its lanes and its depth.

Builds ``examples/caustics.py``'s scene with the port (as ``chip_smoke.py``
does, BVH) and renders it at its 512^2 through
``Renderer(...).integrator("bdpt").samples(n).batch_samples(n)``: one step
of n samples per pixel.  For each (depth, n) it prints the lanes, the peak
``max_memory_allocated`` above what the scene holds, the bytes a lane and
a lane-vertex, and the step's wall seconds; a step that runs out of device
memory is recorded as such.  Then the samples per step that ``_auto_batch``
picks for the example's 2,048 spp, with the BDPT cap and without it.

    python -m lumo_tpu_torch.tools.bdpt_memory     # on a machine with a card

The summary goes to standard output and, whole, to ``--json`` (default
``out/bdpt_memory.json``).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
CASES = ((12, 1), (12, 2), (12, 4), (12, 7), (6, 1), (6, 4))


def step_peak(scene, camera, depth, spp):
    """(peak bytes above the scene's, wall seconds) of one BDPT step of
    ``spp`` samples per pixel at subpath depth ``depth``."""
    import torch
    from lumo_tpu_torch.renderer import Renderer
    r = (Renderer(scene, camera).integrator("bdpt").bdpt_depth(depth)
         .samples(spp).batch_samples(spp))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    r.render(verbose=False)
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base, time.perf_counter() - t0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--json", default=os.path.join(ROOT, "out",
                                                   "bdpt_memory.json"))
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("bdpt_memory: no CUDA device is visible", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from lumo_tpu_torch import renderer
    dev = torch.device("cuda")
    scene, make_camera, _ = cs.example_scene("caustics", dev, "bvh")
    camera = make_camera(args.res)
    step_peak(scene, camera, 12, 1)                         # warm-up
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    out = {"card": card.strip(), "res": args.res,
           "total_bytes": torch.cuda.get_device_properties(0).total_memory,
           "steps": []}
    for depth, spp in CASES:
        lanes = args.res * args.res * spp
        row = {"depth": depth, "spp": spp, "lanes": lanes}
        try:
            peak, wall = step_peak(scene, camera, depth, spp)
            row.update(peak_bytes=peak, bytes_per_lane=peak / lanes,
                       bytes_per_lane_vertex=peak / lanes / depth,
                       wall_s=wall)
        except torch.cuda.OutOfMemoryError:
            row["peak_bytes"] = "out of memory"
        torch.cuda.empty_cache()
        print(json.dumps(row), flush=True)
        out["steps"].append(row)
    r = renderer.Renderer(scene, camera).integrator("bdpt").samples(2048)
    out["auto_batch"] = r._auto_batch()
    with_cap = renderer.BDPT_LANE_VERTICES
    renderer.BDPT_LANE_VERTICES = 1 << 62
    out["auto_batch_uncapped"] = r._auto_batch()
    renderer.BDPT_LANE_VERTICES = with_cap
    summary = {k: v for k, v in out.items() if k != "steps"}
    print(json.dumps(summary))
    os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
    with open(args.json, "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
