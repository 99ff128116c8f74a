"""On-card smoke gate of the port: trace the accelerated scenes through
the hand-written kernels (counterpart of ``tools/tpu_smoke.py``).

- ``smoke_bvh``: the 327,692-triangle blob through K2: closest hits,
  any hits below t = 3, and a fixed-depth-2 fwd+bwd of mean(r) over the
  float material leaves, with a finite, nonzero gradient norm;
- ``smoke_bvh_large``: the 5,242,880-triangle blob (two subdivisions
  more), closest hits through K2;
- ``smoke_kd``: the 327,692-triangle blob built with ``accel="kdtree"``,
  closest hits through K3.

Each keeps the JAX gate's assertion ``hits > n_rays // 2`` and holds the
kernel's answer to the closest-hit query that ``trace._closest`` made
against the plain per-lane walk of the same tree on an evenly spaced
subset of the rays, half of them among its hits
(``bvh_kernel.closest_hit_stats_plain``, ``kd_kernel.closest_hit_plain``;
a dense test of 5.2 M triangles would be too large): prims equal and t
bit-equal.  A scene that raises is recorded as ``{"error": ...}`` and
``ok`` becomes false.

    python -m lumo_tpu_torch.tools.smoke [--cpu] [--subdiv K]

prints one JSON line and exits 1 unless ``ok``; it runs on the card
(without one it raises "no CUDA device").  On the CPU the queries take
the plain dense versions, which the check then holds against the walk.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from lumo_tpu_torch.bench import bench_scene, launched_since, launches
from lumo_tpu_torch.config import resolve_device
from lumo_tpu_torch.graft_entry import _sync

N_RAYS = 8192
N_CHECK = 256       # rays of each query held against the plain walk
SUBDIV = 7          # 327,692 triangles with the box's
LARGE_EXTRA = 2     # the large scene's extra subdivisions: 5,242,880


def rays(n, seed, dev):
    """``tools/tpu_smoke.py::_rays``: n rays from (0, 0, 0.4), normal
    directions tilted towards -z, drawn with numpy's ``default_rng(seed)``
    so both packages trace the same rays."""
    rng = np.random.default_rng(seed)
    o = np.tile(np.array([0.0, 0.0, 0.4], np.float32), (n, 1))
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 2] -= 1.2
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return torch.as_tensor(o, device=dev), torch.as_tensor(d, device=dev)


@contextlib.contextmanager
def recording_closest(mod):
    """Within the block, record every ``closest_hit`` call of the kernel
    module ``mod`` (``bvh_kernel`` or ``kd_kernel``) as (args, output) in
    the list it yields: ``trace`` reaches the wrappers through the
    registered operators, which look them up at call time."""
    calls, real = [], mod.closest_hit

    def record(*args, **kwargs):
        out = real(*args, **kwargs)
        calls.append((args, out))
        return out
    mod.closest_hit = record
    try:
        yield calls
    finally:
        mod.closest_hit = real


def _spaced(idx, k):
    """``k`` evenly spaced entries of the index list ``idx`` (all when
    it is shorter)."""
    if idx.numel() <= k:
        return idx
    return idx[torch.linspace(0, idx.numel() - 1, k,
                              device=idx.device).long()]


def check_against_walk(mod, call):
    """Hold one recorded closest-hit call against the plain walk of the
    same tree on about ``N_CHECK`` rays, half evenly spaced over all and
    half over those the query hit: prims equal, t bit-equal.  Returns the
    record of the check."""
    from lumo_tpu_torch.accel import bvh_kernel
    args, (t_k, p_k) = call
    if mod is bvh_kernel:
        tree, tri, o, d, t_max = args
        walk = lambda s: bvh_kernel.closest_hit_stats_plain(
            tree, tri, o[s], d[s], t_max[s])[:2]
    else:
        tree, o, d, t_max = args
        walk = lambda s: mod.closest_hit_plain(tree, o[s], d[s], t_max[s])
    s = torch.unique(torch.cat([_spaced(torch.arange(o.shape[0],
                                                     device=o.device),
                                        N_CHECK // 2),
                                _spaced(torch.nonzero(p_k >= 0)[:, 0],
                                        N_CHECK - N_CHECK // 2)]))
    t_p, p_p = walk(s)
    prims = int((p_k[s] != p_p).sum())
    t_bits = int((t_k[s].view(torch.int32) != t_p.view(torch.int32)).sum())
    if prims or t_bits:
        raise AssertionError(f"kernel against the plain walk: {prims} prims "
                             f"and {t_bits} t differ of {s.numel()} rays")
    return {"rays": s.numel(), "hits": int((p_p >= 0).sum()),
            "prims": "equal", "t": "bit-equal"}


def _closest(scene, o, d, mod):
    """``trace._closest`` with no t_max bound, timed, its kernel call
    recorded: (t, prim, seconds, recorded calls)."""
    from lumo_tpu_torch.scene import trace
    t0 = time.perf_counter()
    with recording_closest(mod) as calls:
        t, prim = trace._closest(scene, o, d, torch.full(
            (o.shape[0],), 1e30, device=o.device))
    _sync(o.device)
    return t, prim, time.perf_counter() - t0, calls


def _blocks(mod, query, n, dev):
    """The grid of a launch over n rays on the card (resident blocks per
    SM, blocks), None on the CPU."""
    return list(mod.grid(query, n)) if dev.type == "cuda" else None


def _traced(scene, o, d, mod, kind):
    """The closest-hit part shared by the three scenes: hits, the JAX
    gate's assertion, the check against the walk."""
    n = o.shape[0]
    t, prim, seconds, calls = _closest(scene, o, d, mod)
    if len(calls) != 1:
        raise AssertionError(f"{len(calls)} closest-hit queries, not one")
    hit = (prim >= 0) & torch.isfinite(t)
    hits = int(hit.sum())
    if not hits > n // 2:
        raise AssertionError(f"too few {kind} hits: {hits}/{n}")
    return {"tris": int(scene.n_tris), "rays": n, "hits": hits,
            "closest_s": seconds, "blocks": _blocks(mod, "closest", n,
                                                   o.device),
            "vs_plain_walk": check_against_walk(mod, calls[0])}


def smoke_bvh(subdiv=SUBDIV, device=None):
    """K2 on the 327,692-triangle blob: closest, any below t = 3, and a
    fixed-depth-2 fwd+bwd of mean(r) over the float material leaves."""
    from lumo_tpu_torch.accel import bvh_kernel
    from lumo_tpu_torch.color import wavelength
    from lumo_tpu_torch.graft_entry import _generator, float_tables
    from lumo_tpu_torch.integrators import path_trace
    from lumo_tpu_torch.scene import trace
    dev = resolve_device(device)
    scene = bench_scene(dev, subdiv=subdiv)
    o, d = rays(N_RAYS, 0, dev)
    before = launches(bvh_kernel)
    out = _traced(scene, o, d, bvh_kernel, "BVH")

    t0 = time.perf_counter()
    occ = trace.occluded(scene, o, d, torch.full((N_RAYS,), 3.0, device=dev))
    _sync(dev)
    out["anyhit_s"] = time.perf_counter() - t0
    out["occluded"] = int(occ.sum())

    lam = wavelength.sample(torch.linspace(0.05, 0.95, N_RAYS, device=dev))
    mats = {k: v.detach().clone().requires_grad_(True)
            for k, v in float_tables(scene).items()}
    sc = dataclasses.replace(scene, materials={**scene.materials, **mats})
    rk = path_trace.ray_keys(_generator(0), N_RAYS, device=dev)
    t0 = time.perf_counter()
    r, _, _ = path_trace.integrate(sc, o, d, lam, ray_key=rk, fixed_depth=2)
    loss = r.mean()
    loss.backward()
    loss = float(loss.detach())
    gn = sum(float(v.grad.abs().sum()) for v in mats.values()
             if v.grad is not None)
    _sync(dev)
    out["fwd_bwd_s"] = time.perf_counter() - t0
    if not (np.isfinite(loss) and np.isfinite(gn) and gn > 0.0):
        raise AssertionError(f"fwd+bwd: loss {loss}, gnorm {gn}")
    out.update(loss=loss, gnorm=gn,
               launches=launched_since(bvh_kernel, before))
    return out


def smoke_bvh_large(subdiv=SUBDIV + LARGE_EXTRA, device=None):
    """K2 closest hits on the 5,242,880-triangle blob (a bistro-class
    scale; the JAX package's TPU walk once failed above about 2 M)."""
    from lumo_tpu_torch.accel import bvh_kernel
    dev = resolve_device(device)
    t0 = time.perf_counter()
    scene = bench_scene(dev, subdiv=subdiv)
    _sync(dev)
    build_s = time.perf_counter() - t0
    o, d = rays(N_RAYS, 2, dev)
    before = launches(bvh_kernel)
    out = _traced(scene, o, d, bvh_kernel, "BVH")
    out.update(scene_build_s=build_s, bvh_depth=scene.bvh["depth"],
               records=scene.bvh["nodes"].shape[0],
               launches=launched_since(bvh_kernel, before))
    return out


def smoke_kd(subdiv=SUBDIV, device=None):
    """K3 closest hits on the 327,692-triangle blob built as a kd-tree."""
    from lumo_tpu_torch.accel import kd_kernel
    dev = resolve_device(device)
    scene = bench_scene(dev, accel="kdtree", subdiv=subdiv)
    o, d = rays(N_RAYS, 1, dev)
    before = launches(kd_kernel)
    out = _traced(scene, o, d, kd_kernel, "kd")
    out.update(kd_depth=scene.kdtree["depth"],
               launches=launched_since(kd_kernel, before))
    return out


def run(subdiv=SUBDIV, device=None):
    """Every scene of the gate: {"ok", "backend", "bvh", "bvh_large",
    "kd"}, a scene that raises recorded as {"error": ...} with ok
    false."""
    dev = resolve_device(device)
    out = {"backend": torch.cuda.get_device_name(dev)
           if dev.type == "cuda" else "cpu", "ok": True}
    scenes = (("bvh", smoke_bvh, subdiv),
              ("bvh_large", smoke_bvh_large, subdiv + LARGE_EXTRA),
              ("kd", smoke_kd, subdiv))
    for name, fn, sub in scenes:
        t0 = time.perf_counter()
        try:
            out[name] = fn(subdiv=sub, device=dev)
        except Exception as e:  # noqa: BLE001 — the gate reports, not dies
            out[name] = {"error": f"{type(e).__name__}: {e}"[:300]}
            out["ok"] = False
        out[name]["total_s"] = time.perf_counter() - t0
    return out


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m lumo_tpu_torch.tools.smoke",
                                description=__doc__.splitlines()[0])
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of the card (tests)")
    p.add_argument("--subdiv", type=int, default=SUBDIV)
    args = p.parse_args(argv)
    res = run(args.subdiv, "cpu" if args.cpu else None)
    print(json.dumps(res))
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
