"""Two versions of the traversal kernels, in turns, in one run on one card.

Each entry of ``--order`` runs in a process of its own against one source
tree (this checkout, or another one such as an unpacked ``git archive`` of
a parent commit) and, for the tree's own kernels:

- builds the 327,692-triangle scene of ``chip_smoke.py`` with a BVH and
  with a kd-tree, and records the main path's first-bounce rays (closest
  hit) and first-bounce shadow rays (any hit) of each, as ``chip_smoke.py``
  does;
- times each query on them with CUDA events, ``--reps`` launches a
  measurement, three measurements, after a warm-up;
- traces one frame of each path with ``torch.profiler`` (the BVH path
  through ``path_trace.integrate``, the kd path through
  ``Renderer(...).samples(4).render()``, as ``chip_smoke.py``'s
  ``[profile]`` and ``[profile-kd]`` do) and sums the kernels' device time
  in it;
- prints one JSON line: the times, the ptxas report of the build, and a
  digest of every query's rays and output, so that runs given the same
  rays can be held equal bit for bit.

    python -m lumo_tpu_torch.tools.kernel_ab --tree old=out/parent \\
        --order old,new,new,old          # on a machine with a card

``new`` is this checkout.  To measure a change to the kernels, edit a copy
of the tree and give it with ``--tree``.
The summary goes to standard output and, whole, to ``--json`` (default
``out/kernel_ab.json``).
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))


def _digest(*tensors):
    h = hashlib.sha256()
    for x in tensors:
        h.update(x.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


# a kernel's name in a profiler trace ends in its template arguments:
# ``...::kd_traverse<false, true>(...)`` (mode any, counting) and the like;
# the first argument is the mode
_KERNEL = re.compile(r"\b(kd_traverse|traverse)<(true|false)\b")


def _frame_kernel_ms(frame, name):
    """Device ms of the kernel ``name`` (``traverse`` for the BVH,
    ``kd_traverse`` for the kd-tree), closest and any, in one frame traced
    with ``torch.profiler``, and its launches and the kernel names seen."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        frame()
        torch.cuda.synchronize()
    out = {"closest": 0.0, "any": 0.0, "launches": 0}
    for e in prof.events():
        if not str(e.device_type).endswith("CUDA"):
            continue
        m = _KERNEL.search(e.name)
        if m is None or m.group(1) != name:
            continue
        out["closest" if m.group(2) == "false" else "any"] += (
            e.time_range.elapsed_us() / 1e3)
        out["launches"] += 1
    if out["launches"] == 0:
        raise RuntimeError(f"no {name} kernel in the profiled frame")
    return out


def worker(root, reps, accels):
    sys.path.insert(0, root)
    import torch
    from lumo_tpu_torch.accel import bvh_kernel, kd_kernel
    from lumo_tpu_torch.camera import build_camera
    from lumo_tpu_torch.integrators.path_trace import initial_state
    import chip_smoke as cs
    libs = (bvh_kernel.LIB, kd_kernel.LIB)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    for lib in libs:
        lib.load()
    res = {"root": root, "ptxas": {
        lib.name: lib.ptxas_lines() for lib in libs},
        "build_s": time.perf_counter() - t0, "ms": {}, "digest": {},
        "frame_ms": {}}
    camera = build_camera(resolution=(cs.RES, cs.RES), device=dev)
    for accel in accels:
        scene = cs.bench_scene(dev, "bvh" if accel == "bvh" else "kdtree")
        o, d, lam, rk = cs.camera_wavefront(camera, cs.RES, cs.SPP, dev)
        calls = cs.capture_bounce_queries(
            scene, initial_state(o, d, lam, rk), 2)
        for kind, rays in (("closest", calls["closest"][1]),
                           ("any", calls["any"][0])):
            mod, args = cs.query_args(scene, *rays)
            fn = mod.closest_hit if kind == "closest" else mod.any_hit
            for _ in range(3):
                out = fn(*args)
            res["ms"][f"{accel}_{kind}"] = [cs.timed_ms(lambda: fn(*args),
                                                        reps)
                                            for _ in range(3)]
            if hasattr(mod, "grid"):
                # a tree with the persistent kernels: SIMT efficiency of the
                # two phases from the counting launch
                counts = torch.zeros(4, dtype=torch.int64, device=dev)
                fn(*args, counts=counts)
                n_nodes, n_tris, w_in, w_leaf = counts.tolist()
                res.setdefault("simt", {})[f"{accel}_{kind}"] = [
                    n_nodes / max(1, 32 * w_in), n_tris / max(1, 32 * w_leaf)]
            if kind == "closest" and accel == "bvh":
                # a BVH scene's prim ids follow its leaf order, which the
                # threaded native builder may change from run to run, and
                # so may a tie of equal t: digest t alone
                out = out[:1]
            elif kind == "any":
                out = (out,)
            res["digest"][f"{accel}_{kind}"] = {"rays": _digest(*rays),
                                                "out": _digest(*out)}
        if accel == "bvh":
            frame = lambda: cs.render(scene, camera, cs.RES, cs.SPP, dev)
        else:
            frame = lambda: cs.kd_frame(scene, camera, cs.SPP)
        frame()                                                 # warm-up
        res["frame_ms"][accel] = _frame_kernel_ms(
            frame, "traverse" if accel == "bvh" else "kd_traverse")
        del scene
        torch.cuda.empty_cache()
    print(json.dumps(res), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", default=[],
                    help="NAME=PATH of another source tree")
    ap.add_argument("--order", default="new",
                    help="comma-separated names, run in this order")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--json", default=os.path.join(ROOT, "out",
                                                   "kernel_ab.json"),
                    help="where the whole result goes")
    ap.add_argument("--accel", default="bvh,kd",
                    help="comma-separated accelerators to measure")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--root", default=ROOT, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        worker(args.root, args.reps, args.accel.split(","))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device is visible", file=sys.stderr)
        return 1
    runs = {"new": ROOT}
    for spec in args.tree:
        name, path = spec.split("=", 1)
        runs[name] = os.path.abspath(path)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"[ab] card={card!r}", flush=True)
    results = []
    for name in args.order.split(","):
        root = runs[name]
        cmd = [sys.executable, os.path.abspath(__file__), "--worker",
               "--root", root, "--reps", str(args.reps),
               "--accel", args.accel]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              cwd=root, timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"{name} failed:\n{proc.stderr[-4000:]}")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        res["name"] = name
        results.append(res)
        print(f"[ab] run={name} build_s={res['build_s']:.3f} "
              + " ".join(f"{q}_ms={json.dumps(v)}"
                         for q, v in res["ms"].items())
              + " frame_ms=" + json.dumps(res["frame_ms"]).replace(" ", "")
              + " simt=" + json.dumps(res.get("simt")).replace(" ", ""),
              flush=True)
        for lib, lines in res["ptxas"].items():
            for ln in lines:
                print(f"  ptxas {name} {lib}: {ln}", flush=True)
    # runs given the same rays must give the same output
    outs = {}
    for r in results:
        for q, v in r["digest"].items():
            outs.setdefault((q, v["rays"]), set()).add(v["out"])
    same = all(len(v) == 1 for v in outs.values())
    print(f"[ab] outputs_bit_equal_on_equal_rays={same} "
          f"ray_sets={len(outs)}", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
    with open(args.json, "w") as f:
        json.dump({"card": card, "runs": results}, f, indent=1)
    return 0 if same else 2


if __name__ == "__main__":
    if "--worker" in sys.argv:
        sys.path[0] = ROOT      # not this file's directory
    sys.exit(main())
