"""A rehearsal of one cell on the CPU at a tiny size, for finding wrong
paths, shapes and control flow without a card: the whole run (scene,
warm-up, closed loop, the traced units with ``--trace 1``, the
comparison with the configuration's reference) with the resolution and
the blob's subdivisions cut.  It reports the compared numbers and the
work done, and no timing, rate or memory figure: those come from the
card only.

    python3 benchmark/rehearse.py --workload cornell.render [--res 16]
        [--subdiv 2] [--seconds 1] [--trace 0|1] [--seed 7]
"""
import copy
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [p for p in (HERE, ROOT) if p not in sys.path]


def tiny_cell(workload, res=16, subdiv=2):
    """A cell of BENCHMARK.json cut to a rehearsal's size: the resolution,
    the blob's subdivisions and the samples of a render."""
    from lumobench import cells
    cell = cells.resolve(ROOT, workload)
    cell.config = copy.deepcopy(cell.config)
    cell.config["resolution"] = res
    if "render_spp" in cell.config:
        cell.config["render_spp"] = min(cell.config["render_spp"], 14)
    if "subdiv" in cell.config["scene"]:
        cell.config["scene"]["subdiv"] = subdiv
    return cell


def rehearse(workload, seed=7, seconds=1.0, trace=False, res=16, subdiv=2):
    """The rehearsal's summary dict (no device figures)."""
    import torch
    from lumobench import window
    from lumo_tpu_torch.color import uplift
    torch.set_num_threads(4)
    uplift.table(device="cpu")
    out = window.run_cell(tiny_cell(workload, res, subdiv), seed, seconds,
                          trace, torch.device("cpu"), time.perf_counter())
    return {"correct": out["correct"], "attempted": out["attempted"],
            "failed": out["failed"], "metrics": sorted(out["metrics"]),
            "traced": "breakdown" in out, "check": out["check"]}


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--res", type=int, default=16)
    p.add_argument("--subdiv", type=int, default=2)
    a = p.parse_args(argv)
    print(json.dumps(rehearse(a.workload, a.seed, a.seconds, bool(a.trace),
                              a.res, a.subdiv)))


if __name__ == "__main__":
    main()
