"""The readings that the limits of ``correct`` are set from, for one cell
at its own size on the card, in one process: the program's numbers on
each of ``--seeds`` (the lower readings) and the control's on each of
``--control-seeds`` (the upper readings).  The control is the
configuration's reference (``cells.reference``) put in the program's
place with its scene tables, camera rays and path state held in
bfloat16 (the path tracer's: ``reference/__init__.py``).  Each seed runs as
many units as a run compares (``check_passes`` or ``check_steps``) and
compares them as a run does.  The benchmark's own runs never run this.

    python3 benchmark/control.py --workload blob327k.render \\
        --seeds 11,12,... --control-seeds 21,22,23

One JSON line a seed, then a summary line (the largest program reading
and the smallest control reading of each number)."""
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [p for p in (HERE, ROOT) if p not in sys.path]


def readings(cell, seeds, control_seeds, device, log=print):
    """{"program": {seed: numbers}, "control": {seed: numbers}}."""
    from lumobench import cells, traffic
    from lumobench.trace import Spans
    groups = cells.scene_groups(cell.config)
    work = traffic.workload(cell.config, cell.traffic, groups, 0, device,
                            Spans(device))
    work.build()
    n = int(cell.traffic.get("check_passes", cell.traffic.get("check_steps")))
    out = {"program": {}, "control": {}}
    for seed in list(seeds) + [s for s in control_seeds if s not in seeds]:
        work.seed, work.records = seed, []
        for k in range(n):
            work.run_unit(k)
        if seed in seeds:
            out["program"][seed] = work.compare()
            log(json.dumps({"seed": seed, "program": out["program"][seed]}))
        if seed in control_seeds:
            out["control"][seed] = work.compare(precision="bf16")
            log(json.dumps({"seed": seed, "control": out["control"][seed]}))
    return out


def summary(out):
    names = sorted({k for v in out["program"].values() for k in v})
    return {k: {"program_max": max(v[k] for v in out["program"].values()),
                "control_min": min(v[k] for v in out["control"].values())
                if out["control"] else None} for k in names}


def main(argv=None):
    import argparse
    import torch
    from lumobench import cells
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    cell = cells.resolve(ROOT, a.workload)
    seeds = [int(s) for s in a.seeds.split(",") if s]
    cseeds = [int(s) for s in a.control_seeds.split(",") if s]
    t0 = time.perf_counter()
    out = readings(cell, seeds, cseeds, torch.device("cuda", 0),
                   lambda line: print(line, flush=True))
    print(json.dumps({"workload": a.workload, "summary": summary(out),
                      "card": torch.cuda.get_device_name(0),
                      "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
