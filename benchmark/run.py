"""The benchmark of lumo_tpu_torch, the port on one NVIDIA card: one run
of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell (``BENCHMARK.json``'s
``workloads``) names a configuration (``configs/<name>.json``) and a
traffic mix (``traffic/<name>.json``); its metrics are read by
``metrics/<name>.py``.  The run builds the scene, warms up one unit,
measures a closed loop of units for ``--seconds``, compares what the
timed units produced with the plain reference (``reference/``), prints
each compared number beside its limit as the last lines of standard
error, and prints one JSON line last on standard output.  It needs a
CUDA card: without one (or with fewer than the cell asks for) it exits
2 and prints no result.  ``benchmark/README.md`` says how to add a cell.
"""
import os
import sys
import time

T_START = time.perf_counter()
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BUILD = os.path.join(ROOT, "build")
# compile caches at fixed places inside the checkout, before torch loads
os.environ["TRITON_CACHE_DIR"] = os.path.join(BUILD, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(BUILD, "torch_extensions")
# modules that must not be loaded (whole top-level names)
FORBIDDEN = frozenset(("jax", "jaxlib", "flax", "lumo_tpu"))


def forbidden_modules():
    """The forbidden top-level names that ``sys.modules`` holds."""
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)


def main(argv=None) -> int:
    import argparse
    import json
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    # Python's bytecode cache at a fixed place in the checkout too: where
    # bytecode is not written beside the sources, the modules that torch
    # loads at a custom operator's first call (its compiler stack, sympy)
    # are otherwise compiled from source in every run
    sys.pycache_prefix = os.path.join(BUILD, "pycache")
    sys.dont_write_bytecode = False
    for path in (HERE, ROOT):
        if path not in sys.path:
            sys.path.insert(0, path)

    import torch
    from lumobench import cells, window
    cell = cells.resolve(ROOT, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    # the configurations state float32 with TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    out = window.run_cell(cell, args.seed % (1 << 64), args.seconds,
                          bool(args.trace), dev, T_START)
    out["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                     "count": cell.chips, **out["device"]}
    loaded = forbidden_modules()
    if loaded:
        print(f"forbidden modules loaded: {', '.join(loaded)}",
              file=sys.stderr)
        return 3
    for name, t in out["check"].items():
        print(f"check {name} {t['value']!r} limit {t['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
