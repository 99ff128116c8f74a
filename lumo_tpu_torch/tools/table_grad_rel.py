"""Where a gradient cell's ``grad_rel`` comes from, on one card.

``benchmark/lumobench/check.py`` holds the program's gradients against the
plain reference (``benchmark/reference/``), whose table reads take
autograd's ``index_put_(accumulate=True)`` backward.  The program's own
backward of those reads is the table-gradient kernel
(``bsdf/table_grad.py``), which sums in another order.  For each cell and
seed, this runs the cell's gradient steps 0 and 7 with the table reads'
backward as

- ``kernel``: the kernel (the program as it is);
- ``index_put``: the module's plain reduction, ``reduce_plain``, which is
  the reference's own;
- ``f64``: ``reduce_plain`` in float64, rounded to float32 once,

and prints one JSON line a step: ``grad_rel`` of each against the
reference (``<name>_vs_ref``) and against ``f64`` (``<name>_vs_f64``),
and the kernel's worst leaf against ``f64``.  Where ``kernel_vs_ref``
equals ``f64_vs_ref`` and ``kernel_vs_f64`` is far below both, the
reading is the reference's own float32 rounding, not the kernel's.

    python -m lumo_tpu_torch.tools.table_grad_rel \\
        --cells cornell.grad,blob327k.grad --seeds 1000000007,2147483647

Run from the root of a checkout, on a machine with a card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cells", default="cornell.grad,blob327k.grad")
    ap.add_argument("--seeds", default="1000000007,2147483647")
    ap.add_argument("--steps", default="0,7")
    args = ap.parse_args(argv)

    sys.path[:0] = [os.path.join(ROOT, "benchmark"), ROOT]
    import numpy as np
    import torch
    from lumobench import cells, check, program, traffic
    from lumobench.trace import Spans
    from reference import render

    from lumo_tpu_torch.bsdf import table_grad

    if not torch.cuda.is_available():
        print("table_grad_rel: no CUDA device is visible", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    kernel = table_grad.reduce
    variants = {
        "kernel": kernel,
        "index_put": table_grad.reduce_plain,
        "f64": lambda g, shape, i0, i1=None: table_grad.reduce_plain(
            g.double(), shape, i0, i1).to(g.dtype)}
    for name in args.cells.split(","):
        cell = cells.resolve(ROOT, name)
        groups = cells.scene_groups(cell.config)
        conf = cell.config["grad"]
        loss_ref = (render.loss_rgb(*conf["wb"]) if conf["loss"] == "rgb2"
                    else render.loss_r2)
        for seed in map(int, args.seeds.split(",")):
            work = traffic.workload(cell.config, cell.traffic, groups, seed,
                                    dev, Spans(dev))
            work.build()
            ref_scene = work.reference_scene()
            for step in map(int, args.steps.split(",")):
                rays = work.rays(step)
                got = {}
                try:
                    for v, fn in variants.items():
                        table_grad.reduce = fn
                        got[v] = program.grad_step(
                            work.scene, work.leaves, rays, work.depth,
                            work.loss)[1]
                finally:
                    table_grad.reduce = kernel
                _, ref = render.grad_step(ref_scene, *rays, work.depth,
                                          loss_ref)
                ref = {k: v.cpu().numpy() for k, v in ref.items()}
                row = {"cell": name, "seed": seed, "step": step}
                for v in variants:
                    row[f"{v}_vs_ref"] = check.grad_rel(got[v], ref)
                    row[f"{v}_vs_f64"] = check.grad_rel(got[v], got["f64"])
                row["kernel_worst_leaf_vs_f64"] = max(
                    (float(np.linalg.norm(np.asarray(got["kernel"][k],
                                                     np.float64) - r))
                     / max(float(np.linalg.norm(r)), 1e-30), k)
                    for k, r in ((k, np.asarray(v, np.float64))
                                 for k, v in got["f64"].items()))
                print(json.dumps(row), flush=True)
            del work
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
