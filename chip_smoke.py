"""Smoke run of the PyTorch/CUDA port (lumo_tpu_torch) on one CUDA card.

Run from the root of a checkout:

    python3 chip_smoke.py

It builds the port's CUDA kernels (BVH traversal with its stats variant,
kd-tree traversal, the in-kernel loop microbenchmark, the material-table
gradient), both native tree
builders and the JPEG decoder from the sources in the checkout, all
compilers at once, holds every kernel against its plain PyTorch version
on the card, and drives the port's paths over ``bench.py``'s scenes at
256x256:

- the material-table gradient (``[table-grad]``): the backward of a
  per-lane table read at the gradient cells' 524,288 lanes into (8,),
  (8, 4) and the dense (8, 95) pair form, against autograd's
  ``index_put_``;
- forward: the 327,692-triangle scene of ``bench.py::bench_bvh_scene``
  through ``path_trace.integrate`` (4 samples per pixel, one wavefront of
  262,144 lanes), and the same scene built with ``accel="kdtree"``
  through ``Renderer(scene, camera).samples(4).render()``;
- gradients (fixed depth, checkpointed bounces): the Cornell box
  (``[grad-cornell]``, the dense path) and the BVH scene
  (``[grad-bvh]``), each material leaf and the camera origin, fwd+bwd and
  forward-only rays/s, peak memory with the checkpoint on and off, the
  material-table gradient's launches a sample (backward only); the
  gradients through K2 against the plain versions (``[grad-parity]``) and
  through K3 against K2's (``[grad-kd]``);
- the persistent wavefront: ``integrate_stream`` over 16 samples per
  pixel against batch mode (``[stream]``), and ``Renderer.stream()`` on
  the kd scene (``[render-kd-stream]``).
- the example programs' scenes (glass, textures, spheres, analytic
  shapes, a medium) at 512^2 through ``Renderer(...).integrator("path")``
  (``[materials]``);
- the direct-light integrator on the 327,692-triangle scene through K2
  and K3 (``[direct]``), and the bidirectional integrator on
  ``examples/caustics.py``'s scene through K2 and K3, ``examples/box.py``'s
  (dense) and the 327,692-triangle scene through K2 (``[bdpt]``): light
  subpaths, connection rays and dead lanes through the same kernels;
- runtime instancing (``[instance]``): the 327,692-triangle blob
  registered once and instanced 3 times (one K2 query per instance) and
  16 times (one flattened K2 query of 4,194,304 local-space rays with
  unnormalised directions) in the empty box, through the Renderer, and
  instance_3 against the same instances baked (983,076 triangles);
- host I/O (``[io]``): the committed ``scenes/demo.zip`` (.obj, .mtl,
  PNG textures, a bump map) through the port's loader and PNG decoder,
  rendered through K2;
- the user programs (``[examples]``): each of the 11 example programs
  (``lumo_tpu_torch.examples``) through its own ``main`` at 512^2 and 1
  spp, as a user runs it, and dragon once more with ``--accel kdtree``;
  every PNG read back, K2 (K3) launches per program; bunny's and the
  bistro stand-in's kernel-routed images and per-lane depths against
  the plain-routed ones, dragon's K3 image against its K2 image;
- the quality harness (``[quality]``, ``lumo_tpu_torch/tools/quality.py``
  at ``tools/quality.py 64 4``'s configurations): float32 against the
  float64 reference mode and float64 AD against finite differences on the
  Cornell box and an instanced, textured blob scene, whose float32 renders
  go through K2 and whose float64 renders through the plain float64
  route, held to every threshold of ``tests/test_quality_f64.py``;
- rendering over several devices (``[devices]``): two gloo ranks sharing
  the card (``parallel.distributed.initialize(..., backend="gloo")``,
  started with ``torch.multiprocessing``'s spawn method) render the
  327,692-triangle scene through ``Renderer(...).devices(2)`` (path in
  batch and stream mode, direct light, BDPT) and take a ``pmean``'d
  gradient, each launching K2 on half of every query, held against one
  device; one NCCL rank runs ``mesh.shard_step`` against the one-device
  step; NCCL's refusal of two ranks on one card is checked.  The two
  ranks start before ``[parity-kd]`` and set up while the phases before
  ``[devices]`` run, then wait for its go file;
- the driver's entry points (``[graft]``, ``lumo_tpu_torch.graft_entry``):
  the forward ``entry()`` step, ``dryrun_multichip(2)`` (two gloo ranks
  sharing the card take the rich scene's sharded training step through
  K2, its ``pmean``'d material gradients and SGD update, a ``psum``'d
  BDPT film and the scaling protocol), held against the same blocks on
  one device; the training step once more at 256^2; and the
  spectral-uplift table fitted on the card against the shipped one.
- forward-mode derivatives (``[jvp]``, ``torch.autograd.forward_ad``):
  a tangent on the camera origin through the 327,692-triangle scene at
  256^2 (65,536 lanes) at fixed depth and with Russian roulette, through
  K2 and through K3 on the kd-built scene, each held on 2,048 of its
  lanes against the plain route (K3's Russian-roulette frame against
  K2's), with K2's fixed-depth loss tangent
  against reverse mode's <grad L, v> and the peak bytes of both;
  ``tools/diag_grad.py``'s float32 against float64 diagnosis
  (``lumo_tpu_torch.tools.diag_grad``) at its own 64^2, 4 spp; and the
  checkpointed bounce against the plain one under forward mode.
- the benchmark entry (``[bench]``, ``python -m lumo_tpu_torch.bench
  --spp 2`` in a subprocess, as a user runs it): the Cornell headline's
  fwd+bwd, forward and stream, the bvh, bdpt and quality subs at
  ``bench.py``'s sizes but 2 samples per pixel, and the smoke gate whole
  (K2 on the 327,692- and 5,242,880-triangle blobs and K3 on the kd-built
  one, each query held against its plain walk); bench.py's keys, no
  failed sub, and K2 (K3) launched in every sub that uses it.

Each path is checked against a kernel-free run on a small image, the two
kernels are checked against each other on the same rays, and the kernels'
numbers are printed as one JSON line; beside each traversal query's ms per
call stand its resident blocks per SM and the grid it launches, the SIMT
efficiency of its two phases (counting launch) and its device ms per
frame (``case=per-frame``).  Any failure raises and exits
non-zero; the last line is the result ``{"ok": true, "device": {...}}``,
printed only when every phase passed.  It needs one card and exits
non-zero without one, or outside a checkout.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

# bench.py's scenes, rays and losses, shared with the port's benchmark
# entry (outside a checkout this import fails and the script exits 1)
from lumo_tpu_torch.bench import (bench_scene, card_line, gnorm, grad_rays,
                                  loss_r2, loss_rgb, sample_rays)

ROOT = os.path.dirname(os.path.abspath(__file__))

RES = 256            # bench.py's resolution
SPP = 4              # 4 spp x 256^2 = one wavefront of 262,144 lanes
PARITY_RES = 64
PARITY_KD_SPP = 1    # samples of [parity-kd]'s images (SPP until slice 8)
FRAMES = 1           # timed frames of the render (5 until slice 6, 2
                     # until slice 8)

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, float32 outside the
# tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# operations per node visit (6 sub, 6 mul, 6 min/max of the slab pairs,
# 4 reduce min/max, 2 inflate mul, 3 compares; a child-pair record is two
# such tests) and per triangle test (9 sub, 9 shear mul/add pairs = 18,
# 6 mul + 3 sub edges, 2 add det, 3 mul + 2 add t_scaled, 6 sign min/max,
# 4 range mul/cmp, 1 div, 24 for the error bound)
OPS_PER_NODE = 2 * 27
OPS_PER_TRI = 78
# a kd node visit: 1 sub and 1 mul for the plane distance, 6 compares
OPS_PER_KD_NODE = 8
# bytes a walk must read per distinct record, reference or triangle it
# touches: a BVH child-pair record is two boxes and two links (56 B of its
# 64), a BVH triangle three vertices (36 B); a kd node two words (8 B), a
# kd leaf reference one prim id (4 B), a kd triangle three vertices (36 B)
BVH_BYTES = (56, 36)
KD_BYTES = (8, 4, 36)
# exp_sync: float operations per element and trip of each variant (adds,
# multiplies, compares, the vote or the two-level sum)
SYNC_OPS = {"scalar": 0, "vec": 2, "reduce1": 4, "branch1": 4,
            "reduce4": 16, "packed2": 12}
SYNC_TRIPS = 100000


T_START = time.perf_counter()


def log(phase, **kv):
    """One ``[phase] k=v ...`` line, ending with the seconds since the
    script started (``at_s``)."""
    kv["at_s"] = round(time.perf_counter() - T_START, 1)
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def timed_ms(fn, reps):
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events)."""
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def camera_wavefront(camera, res, spp, dev):
    """The first ``spp`` samples of every pixel (:func:`sample_rays`)."""
    idx = torch.arange(res * res * spp, dtype=torch.int64, device=dev)
    return sample_rays(camera, res, idx)[:4]


NATIVE_LIBS = ("bvh", "kdtree", "jpeg")


def kernel_libraries():
    from lumo_tpu_torch.accel import bvh_kernel, kd_kernel
    from lumo_tpu_torch.bsdf import table_grad
    from lumo_tpu_torch.tools import exp_sync
    return [bvh_kernel.LIB, kd_kernel.LIB, exp_sync.LIB, table_grad.LIB]


def phase_card():
    """Build the native host libraries (the two tree builders and the
    JPEG decoder, g++) and every kernel library (nvcc) at once, one
    compiler process each, and print each kernel's ptxas lines."""
    from concurrent.futures import ThreadPoolExecutor
    from lumo_tpu_torch import native
    log("card", nvidia_smi=repr(card_line()),
        device=repr(torch.cuda.get_device_name(0)),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda)
    t0 = time.perf_counter()

    def timed(load):
        t = time.perf_counter()
        load()
        return round(time.perf_counter() - t, 3)

    libs = kernel_libraries()
    with ThreadPoolExecutor(max_workers=len(NATIVE_LIBS) + len(libs)) as pool:
        jobs = {**{w: pool.submit(timed, lambda w=w: native.load(w))
                   for w in NATIVE_LIBS},
                **{lib.name: pool.submit(timed, lib.load) for lib in libs}}
        seconds = {k: job.result() for k, job in jobs.items()}
    log("card", native_build_s=json.dumps(
        {w: seconds[w] for w in NATIVE_LIBS}).replace(" ", ""))
    for lib in libs:
        for line in lib.ptxas_lines():
            print(f"  ptxas {lib.name}: {line}", flush=True)
        log("card", library=lib.name,
            kernel_load_s=round(lib.load_span.seconds, 3),
            nvcc="built" if lib.info["log"] else "cached")
    log("card", all_builds_s=round(time.perf_counter() - t0, 3),
        parallel=True)


def _random_soup(T, N, seed):
    """A random triangle soup a, b, c (T, 3) and rays o, d (N, 3), t_max
    (N,) of which an eighth are dead (t_max 0) and three eighths have a
    finite t_max, as numpy arrays."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1, 1, (T, 3)).astype(np.float32)
    b = a + rng.uniform(-0.25, 0.25, (T, 3)).astype(np.float32)
    c = a + rng.uniform(-0.25, 0.25, (T, 3)).astype(np.float32)
    o = rng.uniform(-2, 2, (N, 3)).astype(np.float32)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = np.full(N, np.inf, np.float32)
    t_max[: N // 8] = 0.0
    t_max[N // 8: N // 2] = rng.uniform(0.05, 3.0, N // 2 - N // 8)
    rng.shuffle(t_max)
    return (a, b, c), (o, d, t_max)


def _on(dev, arrays):
    return tuple(torch.as_tensor(x, device=dev) for x in arrays)


def _soup(T, N, seed, dev):
    from lumo_tpu_torch.accel import build as accel_build
    from lumo_tpu_torch.accel import bvh_kernel
    (a, b, c), rays = _random_soup(T, N, seed)
    bvh = accel_build.build(*accel_build.triangle_bounds(a, b, c))
    a, b, c = a[bvh.order], b[bvh.order], c[bvh.order]
    tabs = {"lo": bvh.node_lo, "hi": bvh.node_hi, "right": bvh.node_right,
            "first": bvh.node_first, "count": bvh.node_count,
            "axis": bvh.node_axis}
    dev_bvh = {"nodes": torch.as_tensor(bvh_kernel.pack_nodes(tabs),
                                        device=dev),
               "tris": torch.as_tensor(bvh_kernel.pack_tris(a, b, c),
                                       device=dev),
               "depth": bvh.depth}
    return (dev_bvh, _on(dev, (a, b, c)), *_on(dev, rays))


def _kd_soup(T, N, seed, dev):
    """A random soup's packed kd-tree, its triangles, and rays of which
    the first 256 lie in a split plane with a zero direction component."""
    from lumo_tpu_torch.accel import build as accel_build
    from lumo_tpu_torch.accel import kd_kernel, kdtree
    (a, b, c), (o, d, t_max) = _random_soup(T, N, seed)
    kd = kdtree.build(*accel_build.triangle_bounds(a, b, c))
    tabs = {"split": kd.split, "axis": kd.axis, "right": kd.right,
            "first": kd.first, "count": kd.count, "prims": kd.prims,
            "lo": kd.root_lo, "hi": kd.root_hi}
    dev_kd = {k: torch.as_tensor(v, device=dev)
              for k, v in kd_kernel.pack_kd(tabs, a, b, c).items()}
    dev_kd["depth"] = kd.max_depth
    inner = np.nonzero(kd.axis != 3)[0]
    for i in range(256):
        node = inner[i % len(inner)]
        o[i, kd.axis[node]] = kd.split[node]
        d[i, kd.axis[node]] = 0.0
        t_max[i] = np.inf
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return (dev_kd, _on(dev, (a, b, c)), *_on(dev, (o, d, t_max)))


def compare_closest(kernel_out, plain_out, exact):
    """Kernel vs plain closest hit on the same rays.  Returns (prim
    differences on equal-t ties, which must be 0 when ``exact``; hits;
    max |t_k - t_p| over hits)."""
    (t_k, p_k), (t_p, p_p) = kernel_out, plain_out
    torch.cuda.synchronize()
    diff = p_k != p_p
    ties = int((diff & (t_k == t_p)).sum())
    bad = int((diff & (t_k != t_p)).sum())
    if bad or (exact and ties):
        raise AssertionError(f"closest hit: {bad} prim mismatches with "
                             f"different t, {ties} on ties")
    if not torch.equal(t_k.view(torch.int32), t_p.view(torch.int32)):
        raise AssertionError("closest hit: t not bit-equal")
    hit = torch.isfinite(t_k)
    err = float((t_k[hit] - t_p[hit]).abs().max()) if bool(hit.any()) else 0.0
    return ties, int(hit.sum()), err


def compare_any(occ_k, occ_p):
    """Kernel vs plain any hit.  Returns (occluded rays, max |flag_k -
    flag_p|), the flags must all be equal."""
    n_bad = int((occ_k != occ_p).sum())
    if n_bad:
        raise AssertionError(f"any hit: {n_bad} occlusion flags differ")
    err = float((occ_k.float() - occ_p.float()).abs().max())
    return int(occ_k.sum()), err


def phase_soup(dev):
    from lumo_tpu_torch.accel import bvh_kernel
    args = _soup(3000, 65536, 0, dev)
    _, hits, _ = compare_closest(bvh_kernel.closest_hit(*args),
                                 bvh_kernel.closest_hit_plain(*args),
                                 exact=True)
    occ, _ = compare_any(bvh_kernel.any_hit(*args),
                         bvh_kernel.any_hit_plain(*args))
    log("kernels", case="soup", tris=3000, rays=args[2].shape[0], hits=hits,
        occluded=occ, prims="exact", t="bit-equal", depth=args[0]["depth"])


def phase_soup_kd(dev):
    """K3 against the plain walk (prims exact, t bit-equal, flags equal)
    and against the dense test (t bit-equal, prim ties counted)."""
    from lumo_tpu_torch.accel import bvh_kernel, kd_kernel
    for T, N in ((500, 16384), (3000, 65536), (20000, 65536)):
        kd, tri, o, d, t_max = _kd_soup(T, N, T, dev)
        out_k = kd_kernel.closest_hit(kd, o, d, t_max)
        _, hits, _ = compare_closest(
            out_k, kd_kernel.closest_hit_plain(kd, o, d, t_max), exact=True)
        ties, _, _ = compare_closest(
            out_k, bvh_kernel.closest_hit_plain(None, tri, o, d, t_max),
            exact=False)
        occ_k = kd_kernel.any_hit(kd, o, d, t_max)
        occ, _ = compare_any(occ_k, kd_kernel.any_hit_plain(kd, o, d, t_max))
        compare_any(occ_k, bvh_kernel.any_hit_plain(None, tri, o, d, t_max))
        if bool((out_k[1][t_max <= 0] >= 0).any()) or int(
                (out_k[1][:256] >= 0).sum()) == 0:
            raise AssertionError("kd soup: dead lanes hit, or no in-plane "
                                 "ray did")
        log("soup-kd", tris=T, rays=N, refs=kd["refs"].shape[0],
            nodes=kd["nodes"].shape[0], depth=kd["depth"], hits=hits,
            occluded=occ, in_plane_hits=int((out_k[1][:256] >= 0).sum()),
            vs_plain_walk="prims exact, t bit-equal",
            vs_dense=f"t bit-equal, {ties} tie flips")


def capture_bounce_queries(scene, state, n_bounces):
    """Run ``n_bounces`` bounces of the main path and record the (o, d,
    t_max) each closest-hit and any-hit call received, whichever
    accelerator the scene has."""
    from lumo_tpu_torch.accel import bvh_kernel, kd_kernel
    from lumo_tpu_torch.integrators import path_trace
    calls = {"closest": [], "any": []}
    mod = kd_kernel if scene.kdtree is not None else bvh_kernel
    real = {"closest": mod.closest_hit, "any": mod.any_hit}

    def recorder(kind):
        def call(*args):
            calls[kind].append(tuple(x.clone() for x in args[-3:]))
            return real[kind](*args)
        return call

    with mock.patch.object(mod, "closest_hit", recorder("closest")), \
            mock.patch.object(mod, "any_hit", recorder("any")):
        for _ in range(n_bounces):
            state = path_trace.bounce(scene, state, 1.0)
    return calls


def bound(kind, sizes, o, t_max, counts, seen, seg_bytes=BVH_BYTES,
          ops_per_node=OPS_PER_NODE, extra_out_bytes=0):
    """The least time the card could take for one call on these rays: the
    larger of the bytes the call must move at the HBM rate and its float
    operations at the f32 peak.  Bytes: o, d and t_max of each live ray
    (t_max > 0; a dead lane reads only its t_max), each distinct record,
    reference or triangle the call read (the segments of ``seen``, of
    ``sizes`` marks, at ``seg_bytes`` each), and the outputs (closest: t
    f32 and a 32-bit prim per ray; any: one byte per ray; plus
    ``extra_out_bytes`` for the call).  Operations: the call's node visits
    and triangle tests.  Also the SIMT efficiency of the kernel's two
    phases from the counting launch: lane steps over 32 lanes times warp
    trips."""
    N = o.shape[0]
    nodes, tris, w_inner, w_leaf = (int(x) for x in counts.cpu())
    distinct, start = [], 0
    for n in sizes:
        distinct.append(int(seen[start:start + n].sum()))
        start += n
    live = int((t_max > 0).sum())
    out_bytes = N * (4 + 4 if kind == "closest" else 1) + extra_out_bytes
    needed = (live * 24 + N * 4 + out_bytes
              + sum(k * b for k, b in zip(distinct, seg_bytes)))
    t_bytes = needed / HBM_BYTES_PER_S * 1e3
    t_ops = (nodes * ops_per_node + tris * OPS_PER_TRI) / F32_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_needed": needed, "node_visits": nodes, "tri_tests": tris,
            "distinct": json.dumps(distinct).replace(" ", ""),
            "live_rays": live,
            "simt_inner": nodes / max(1, 32 * w_inner),
            "simt_leaf": tris / max(1, 32 * w_leaf)}


def query_args(scene, o, d, t_max):
    """(kernel module, its query arguments) for the scene's accelerator."""
    from lumo_tpu_torch.accel import bvh_kernel, kd_kernel
    from lumo_tpu_torch.scene.trace import _bvh_tris
    if scene.kdtree is not None:
        return kd_kernel, (scene.kdtree, o, d, t_max)
    return bvh_kernel, (scene.bvh, _bvh_tris(scene), o, d, t_max)


def kernel_numbers(scene, kind, o, d, t_max, reps=20):
    """One query family at the main path's shape, on the scene's own
    accelerator: the kernel's ms, the plain version's ms, the timed
    kernel's output held against the plain output of the same rays, and
    the bound."""
    mod, args = query_args(scene, o, d, t_max)
    acc, extra = args[0], {}
    if scene.kdtree is not None:
        extra = {"seg_bytes": KD_BYTES, "ops_per_node": OPS_PER_KD_NODE}
    fn = mod.closest_hit if kind == "closest" else mod.any_hit
    plain = mod.closest_hit_plain if kind == "closest" else mod.any_hit_plain
    for _ in range(3):
        out_k = fn(*args)
    ms = timed_ms(lambda: fn(*args), reps)
    out_p = []
    plain_ms = timed_ms(lambda: out_p.append(plain(*args)), 1)
    if kind == "closest":
        ties, hits, err = compare_closest(out_k, out_p[0], exact=False)
        check = {"hits": hits, "tie_flips": ties}
    else:
        occ, err = compare_any(out_k, out_p[0])
        check = {"occluded": occ}
    sizes = mod._marks(acc)
    counts = torch.zeros(4, dtype=torch.int64, device=o.device)
    seen = torch.zeros(sum(sizes), dtype=torch.uint8, device=o.device)
    fn(*args, counts=counts, seen=seen)
    per_sm, grid = mod.grid(kind, o.shape[0])
    return {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err,
            "rays": o.shape[0], **check, "blocks_per_sm": per_sm,
            "grid": grid, **bound(kind, sizes, o, t_max, counts, seen,
                                  **extra)}


def phase_scene_kernels(scene, camera, dev):
    """Kernel vs plain on the full scene at the main path's 262,144-ray
    shapes (camera rays, first-bounce rays, first-bounce shadow rays), on
    the scene's own accelerator, and the kernels' numbers.  Returns the
    numbers and the captured queries."""
    from lumo_tpu_torch.integrators.path_trace import initial_state
    o, d, lam, rk = camera_wavefront(camera, RES, SPP, dev)
    calls = capture_bounce_queries(scene, initial_state(o, d, lam, rk), 2)
    cam, bnc = calls["closest"][0], calls["closest"][1]
    shadow = calls["any"][0]
    mod, args = query_args(scene, *cam)
    accel = "kd" if scene.kdtree is not None else "bvh"
    ties, hits, err = compare_closest(mod.closest_hit(*args),
                                      mod.closest_hit_plain(*args),
                                      exact=False)
    log("kernels", case="scene", query=f"{accel}_closest", rays_from="camera",
        tris=scene.n_tris, rays=cam[0].shape[0], hits=hits, tie_flips=ties,
        prims="equal except ties", t="bit-equal", max_abs_err=err)
    nums = {"closest": kernel_numbers(scene, "closest", *bnc),
            "any": kernel_numbers(scene, "any", *shadow)}
    nums["closest"]["max_abs_err"] = max(err, nums["closest"]["max_abs_err"])
    for k, v in nums.items():
        log("kernels", case="scene", query=f"{accel}_{k}",
            rays_from="first bounce" if k == "closest" else
            "first-bounce shadow", **v)
    return nums, {"camera": cam, "bounce": bnc, "shadow": shadow}


def phase_cross_check(scene_kd, scene_bvh, queries):
    """Two independent kernels, one answer: ``trace.intersect`` and
    ``trace.occluded`` on the kd scene against the BVH scene's for the
    same rays.  Hit masks and occlusion flags equal, t bit-equal (prim ids
    differ: the BVH scene holds its triangles in leaf order)."""
    from lumo_tpu_torch.scene import trace
    for name in ("camera", "bounce"):
        o, d, t_max = queries[name]
        h_kd = trace.intersect(scene_kd, o, d, t_max)
        h_bvh = trace.intersect(scene_bvh, o, d, t_max)
        if not torch.equal(h_kd["valid"], h_bvh["valid"]):
            raise AssertionError(f"kd vs BVH ({name}): hit masks differ")
        if not torch.equal(h_kd["t"].view(torch.int32),
                           h_bvh["t"].view(torch.int32)):
            raise AssertionError(f"kd vs BVH ({name}): t not bit-equal")
        log("kernels", case="kd-vs-bvh", rays_from=name, rays=o.shape[0],
            hits=int(h_kd["valid"].sum()), hit_masks="equal", t="bit-equal")
    o, d, t_max = queries["shadow"]
    occ_kd = trace.occluded(scene_kd, o, d, t_max)
    occ, _ = compare_any(occ_kd, trace.occluded(scene_bvh, o, d, t_max))
    log("kernels", case="kd-vs-bvh", rays_from="shadow", rays=o.shape[0],
        occluded=occ, flags="equal")


def render(scene, camera, res, spp, dev):
    from lumo_tpu_torch import film
    from lumo_tpu_torch.integrators import path_trace
    o, d, lam, rk = camera_wavefront(camera, res, spp, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.profiler.record_function("integrate"):
        radiance, lam_out, depth = path_trace.integrate(scene, o, d, lam,
                                                        ray_key=rk)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rgb = film.spectral_to_rgb(radiance, lam_out,
                               film.wb_matrix("sRGB", "D65"))
    img = rgb.view(spp, res, res, 3).mean(0)
    return img, depth, wall


def write_ppm(img, path):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    x = img.clamp(0.0, 1.0).pow(1.0 / 2.2).mul(255.0).round().to(torch.uint8)
    with open(path, "wb") as f:
        f.write(f"P6 {x.shape[1]} {x.shape[0]} 255\n".encode())
        f.write(x.cpu().numpy().tobytes())


def phase_render(scene, camera, dev):
    """A warm-up frame, then FRAMES timed frames of the main path; the
    launch counts are reset just before each frame and read just after."""
    from lumo_tpu_torch.accel import bvh_kernel
    render(scene, camera, RES, SPP, dev)           # warm-up
    walls, rays, per_frame = [], [], []
    for _ in range(FRAMES):
        for k in bvh_kernel.LAUNCHES:
            bvh_kernel.LAUNCHES[k] = 0
        img, depth, wall = render(scene, camera, RES, SPP, dev)
        per_frame.append({k: bvh_kernel.LAUNCHES[k]
                          for k in ("closest", "any")})
        if not bool(torch.isfinite(img).all()):
            raise AssertionError("render produced non-finite pixels")
        walls.append(wall)
        rays.append(2.0 * float(depth.sum()))
    launches = per_frame[0]
    if min(launches.values()) <= 0 or any(f != launches for f in per_frame):
        raise AssertionError(f"main path launches per frame: {per_frame}")
    rate = sorted(r / w for r, w in zip(rays, walls))
    log("render", res=f"{RES}x{RES}", spp=SPP, lanes=RES * RES * SPP,
        frames=FRAMES, wall_s=json.dumps(walls).replace(" ", ""),
        rays=int(rays[-1]), rays_per_s_median=float(np.median(rate)),
        rays_per_s_min=rate[0], rays_per_s_max=rate[-1],
        mean_depth=float(depth.float().mean()),
        launches=json.dumps(launches).replace(" ", ""),
        image_mean=float(img.mean()), finite=True)
    write_ppm(img, os.path.join(ROOT, "out", "render_256.ppm"))
    return launches


def phase_profile(phase, frame, span, kernel_tag):
    """One more frame under torch.profiler: the traversal kernels' device
    time and the device's idle share over the frame's wall
    (:func:`traced_frame`; the profiler's annotation of the host range
    ``span`` is not device work)."""
    wall, on_card, read_s = traced_frame(frame, span)
    if not on_card:
        log(phase, device_events=0, device_time="not measured")
        return {}
    ms = lambda tag: sum(e.duration_ns() for e in on_card
                         if tag in e.name()) / 1e6
    per_frame = {"closest": ms(f"{kernel_tag}<false"),
                 "any": ms(f"{kernel_tag}<true")}
    busy = busy_ns(on_card)
    log(phase, wall_ms=wall * 1e3, device_events=len(on_card),
        device_busy_ms=busy / 1e6, idle_share=1.0 - busy / 1e9 / wall,
        closest_ms_total=per_frame["closest"], any_ms_total=per_frame["any"],
        kernel_launches=sum(f"{kernel_tag}<" in e.name() for e in on_card),
        read_s=read_s)
    return per_frame


def log_per_frame(accel, nums, per_frame, launches):
    """Each query's ms per call at 262,144 rays beside its device ms per
    frame from the profiled frame."""
    for k in ("closest", "any"):
        log("kernels", case="per-frame", query=f"{accel}_{k}",
            ms_per_call=nums[k]["ms"],
            device_ms_per_frame=per_frame.get(k, "not measured"),
            launches_per_frame=launches[k])


def phase_parity(scene, dev, rtol=1e-5, atol=1e-7):
    """The same scene at 64x64, 1 spp, with the kernel and with the plain
    versions on the card: per-lane radiance within (rtol, atol) on lanes
    whose bounce prims agree; lanes whose prims differ are counted."""
    from lumo_tpu_torch.accel import bvh_kernel
    from lumo_tpu_torch.camera import build_camera
    from lumo_tpu_torch.integrators import path_trace
    cam = build_camera(resolution=(PARITY_RES, PARITY_RES), device=dev)
    o, d, lam, rk = camera_wavefront(cam, PARITY_RES, 1, dev)
    r_k, _, dep_k, pr_k = path_trace.integrate(scene, o, d, lam, ray_key=rk,
                                               trace_prims=True)
    with mock.patch.object(bvh_kernel, "closest_hit",
                           bvh_kernel.closest_hit_plain), \
            mock.patch.object(bvh_kernel, "any_hit", bvh_kernel.any_hit_plain):
        r_p, _, dep_p, pr_p = path_trace.integrate(scene, o, d, lam,
                                                   ray_key=rk,
                                                   trace_prims=True)
    K = max(pr_k.shape[0], pr_p.shape[0])
    pad = lambda x: torch.cat([x, torch.full((K - x.shape[0], x.shape[1]), -1,
                                             dtype=x.dtype, device=dev)])
    same = (pad(pr_k) == pad(pr_p)).all(dim=0)
    flips = int((~same).sum())
    ok_r = torch.allclose(r_k[same], r_p[same], rtol=rtol, atol=atol)
    ok_d = torch.equal(dep_k[same], dep_p[same])
    max_err = float((r_k[same] - r_p[same]).abs().max())
    log("parity", res=f"{PARITY_RES}x{PARITY_RES}", spp=1, lanes=o.shape[0],
        topology_flips=flips, radiance_max_abs_err=max_err, rtol=rtol,
        atol=atol, depth_equal=ok_d)
    if not (ok_r and ok_d) or flips > o.shape[0] // 100:
        raise AssertionError("kernel and plain renders disagree")
    return max_err


def kd_frame(scene, camera, spp, delta=None):
    """One frame through the port's normal entry point,
    ``Renderer(scene, camera).samples(spp).render()``.  Returns (image
    (H, W, 3) numpy, sum of path depths, wall seconds of ``render``)."""
    from lumo_tpu_torch import renderer
    depths = []
    real = renderer.path_trace.integrate

    def integrate(*args, **kwargs):
        out = real(*args, **kwargs)
        depths.append(out[2].sum())
        return out

    r = renderer.Renderer(scene, camera).samples(spp)
    if delta is not None:
        r.fixed_rr_delta(delta)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with mock.patch.object(renderer.path_trace, "integrate", integrate), \
            torch.profiler.record_function("render"):
        img = r.render(verbose=False)    # ends with the image on the host
    wall = time.perf_counter() - t0
    return img, float(sum(depths)), wall


def phase_render_kd(scene, camera):
    """A warm-up frame, then FRAMES timed frames of the kd main path;
    the launch counts are reset just before each frame and read just
    after."""
    from lumo_tpu_torch.accel import kd_kernel
    kd_frame(scene, camera, SPP)                  # warm-up
    walls, rays, per_frame = [], [], []
    for _ in range(FRAMES):
        for k in kd_kernel.LAUNCHES:
            kd_kernel.LAUNCHES[k] = 0
        img, depth_sum, wall = kd_frame(scene, camera, SPP)
        per_frame.append(dict(kd_kernel.LAUNCHES))
        if img.shape != (RES, RES, 3) or not np.isfinite(img).all():
            raise AssertionError("kd render: wrong shape or non-finite pixels")
        walls.append(wall)
        rays.append(2.0 * depth_sum)
    launches = per_frame[0]
    if min(launches.values()) <= 0 or any(f != launches for f in per_frame):
        raise AssertionError(f"kd main path launches per frame: {per_frame}")
    rate = sorted(r / w for r, w in zip(rays, walls))
    log("render-kd", entry="Renderer.samples(4).render()", res=f"{RES}x{RES}",
        spp=SPP, lanes=RES * RES * SPP, frames=FRAMES, warmup_frames=1,
        wall_s=json.dumps(walls).replace(" ", ""), rays=int(rays[-1]),
        rays_per_s_median=float(np.median(rate)), rays_per_s_min=rate[0],
        rays_per_s_max=rate[-1],
        mean_depth=rays[-1] / 2.0 / (RES * RES * SPP),
        launches=json.dumps(launches).replace(" ", ""),
        image_mean=float(img.mean()), finite=True)
    write_ppm(torch.as_tensor(img), os.path.join(ROOT, "out",
                                                 "render_kd_256.ppm"))
    return launches


def phase_parity_kd(scene, dev, rtol=1e-5, atol=1e-6):
    """A 64x64 Renderer image (PARITY_KD_SPP spp, fixed Russian-roulette
    threshold 1) with the kernel against the same with the plain walk.
    The film's ``index_add_`` uses atomics on the card, so sums differ in
    order: pixels within (rtol, atol); pixels beyond it are counted as
    flips."""
    from lumo_tpu_torch.accel import kd_kernel
    from lumo_tpu_torch.camera import build_camera
    cam = build_camera(resolution=(PARITY_RES, PARITY_RES), device=dev)
    img_k, _, _ = kd_frame(scene, cam, PARITY_KD_SPP, delta=1.0)
    t0 = time.perf_counter()
    with mock.patch.object(kd_kernel, "closest_hit",
                           kd_kernel.closest_hit_plain), \
            mock.patch.object(kd_kernel, "any_hit", kd_kernel.any_hit_plain):
        img_p, _, _ = kd_frame(scene, cam, PARITY_KD_SPP, delta=1.0)
    close = np.isclose(img_k, img_p, rtol=rtol, atol=atol).all(axis=-1)
    flips = int((~close).sum())
    max_err = float(np.abs(img_k - img_p)[close].max())
    log("parity-kd", res=f"{PARITY_RES}x{PARITY_RES}", spp=PARITY_KD_SPP,
        pixels=close.size, flips=flips, image_max_abs_err=max_err, rtol=rtol,
        atol=atol, plain_render_s=round(time.perf_counter() - t0, 2))
    if flips > close.size // 100:
        raise AssertionError("kd kernel and plain-walk renders disagree")
    return max_err


def phase_stats(scene, queries, dev):
    """K2 stats on the BVH scene's 262,144 camera rays and 262,144
    first-bounce rays: t and prim equal to ``closest_hit``, the per-ray
    counters summing to the ``counts=`` totals, and everything equal to
    the plain walk.  Returns the first-bounce call's numbers, the shape
    ``bvh_closest_hit`` is timed at."""
    for name in ("camera", "bounce"):
        nums = _stats_on(scene, name, queries[name], dev)
    return nums


def _stats_on(scene, rays_from, rays, dev):
    from lumo_tpu_torch.accel import bvh_kernel
    from lumo_tpu_torch.scene.trace import _bvh_tris
    args = (scene.bvh, _bvh_tris(scene), *rays)
    o, _, t_max = rays
    out_p = []
    plain_ms = timed_ms(lambda: out_p.append(
        bvh_kernel.closest_hit_stats_plain(*args)), 1)
    for _ in range(3):
        bvh_kernel.closest_hit_stats(*args)
    ms = timed_ms(lambda: bvh_kernel.closest_hit_stats(*args), 20)
    # the one launch that counts: reset just before, read just after
    bvh_kernel.LAUNCHES["stats"] = 0
    t_s, p_s, stats = bvh_kernel.closest_hit_stats(*args)
    launches = bvh_kernel.LAUNCHES["stats"]
    t_c, p_c = bvh_kernel.closest_hit(*args)
    sizes = bvh_kernel._marks(scene.bvh)
    counts = torch.zeros(4, dtype=torch.int64, device=dev)
    seen = torch.zeros(sum(sizes), dtype=torch.uint8, device=dev)
    bvh_kernel.closest_hit(*args, counts=counts, seen=seen)
    torch.cuda.synchronize()
    if not (torch.equal(t_s.view(torch.int32), t_c.view(torch.int32))
            and torch.equal(p_s, p_c)):
        raise AssertionError("stats: t or prim differ from closest_hit")
    total = stats[:, 0].sum(0, dtype=torch.int64).tolist()
    if [total[0], total[2]] != counts[:2].tolist():
        raise AssertionError(f"stats: counters {total} do not sum to the "
                             f"counting launch's {counts.tolist()}")
    t_p, p_p, stats_p = out_p[0]
    if not (torch.equal(t_s.view(torch.int32), t_p.view(torch.int32))
            and torch.equal(p_s, p_p) and torch.equal(stats, stats_p)):
        raise AssertionError("stats: kernel and plain walk disagree")
    hit = torch.isfinite(t_s)
    err = max(float((t_s[hit] - t_p[hit]).abs().max()) if bool(hit.any())
              else 0.0, float((stats - stats_p).abs().max()))
    peak = stats[:, 1].double().clamp(min=1.0)
    busy = stats[:, 1].sum(1) > 0       # warps with at least one live lane
    simt = (stats[:, 0].double() / (32.0 * peak))[busy].mean(0).tolist()
    # the stats output: 6 int32 per group of 32 rays
    b = bound("closest", sizes, o, t_max, counts, seen,
              extra_out_bytes=stats.numel() * 4)
    per_sm, grid = bvh_kernel.grid("stats", o.shape[0])
    log("stats", rays_from=rays_from, rays=o.shape[0], warps=stats.shape[0],
        interior_visits=total[0], leaf_visits=total[1], tri_tests=total[2],
        simt_efficiency_interior=simt[0], simt_efficiency_leaf=simt[1],
        simt_efficiency_tests=simt[2],
        persistent_simt_inner=b["simt_inner"],
        persistent_simt_leaf=b["simt_leaf"], vs_closest_hit="t, prim equal",
        vs_plain_walk="t, prim, counters equal", ms=ms, plain_ms=plain_ms,
        max_abs_err=err, bound_ms=b["bound_ms"], bound_by=b["bound_by"],
        blocks_per_sm=per_sm, grid=grid, launches=launches)
    return {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err,
            "launches": launches, **b}


def phase_sync(dev):
    """K4: every variant against the plain loop at 1,000 trips (outputs
    bit-equal), then the time per trip at 100,000 trips, the plain loop's
    time for the vote-and-branch variant, and the host's
    ``tensor.any().item()`` round trip."""
    from lumo_tpu_torch.tools import exp_sync
    x = torch.full(exp_sync.TILE, 0.5, device=dev)
    err = 0.0
    for v in exp_sync.VARIANTS:
        out_k, out_p = exp_sync.run(v, x, 1000), exp_sync.run_plain(v, x, 1000)
        if not torch.equal(out_k.view(torch.int32), out_p.view(torch.int32)):
            raise AssertionError(f"exp_sync {v}: kernel and plain differ")
        err = max(err, float((out_k - out_p).abs().max()))
    exp_sync.LAUNCHES["exp_sync"] = 0
    res = exp_sync.measure(SYNC_TRIPS, dev)
    launches = exp_sync.LAUNCHES["exp_sync"]
    out_p = []
    plain_ms = timed_ms(lambda: out_p.append(
        exp_sync.run_plain("branch1", x, SYNC_TRIPS)), 1)
    out_k = exp_sync.run("branch1", x, SYNC_TRIPS)
    if not torch.equal(out_k.view(torch.int32), out_p[0].view(torch.int32)):
        raise AssertionError("exp_sync branch1: kernel and plain differ at "
                             f"{SYNC_TRIPS} trips")
    for v in exp_sync.VARIANTS:
        log("sync", variant=v, trips=SYNC_TRIPS, ms=res[v][0],
            ns_per_trip=res[v][1])
    log("sync", host_any_item_us=res["host_any_item_us"],
        branch1_ns_per_trip=res["branch1"][1],
        plain_branch1_ms=plain_ms, outputs="bit-equal", launches=launches)
    t_bytes = 2 * 8 * 128 * 4 / HBM_BYTES_PER_S * 1e3
    t_ops = (SYNC_OPS["branch1"] * 8 * 128 * SYNC_TRIPS) / F32_FLOPS * 1e3
    return {"ms": res["branch1"][0], "plain_ms": plain_ms, "max_abs_err": err,
            "launches": launches, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


# ---------------------------------------------------------------------------
# the backward of per-lane material-table reads (csrc/table_grad.cu)

TABLE_LANES = 524288   # the gradient cells' lanes a step
TABLE_REPS = 50        # timed kernel calls (the plain version: a fifth)


def table_grad_case(form, dev):
    """(table shape, index) at ``TABLE_LANES`` lanes whose rows come in
    runs of 64 lanes in half of the lanes and at random in the other
    half: a row index into (8,) or (8, 4), or ``sample_rows``' pair into
    (8, 95) with bins clamped at both edges."""
    gen = torch.Generator().manual_seed(17)
    lane = torch.arange(TABLE_LANES)
    rows = torch.where((lane // 4096) % 2 == 0, (lane // 64 * 7) % 8,
                       torch.randint(0, 8, (TABLE_LANES,), generator=gen))
    if form == "dense":
        bins = torch.randint(-3, 98, (TABLE_LANES, 4), generator=gen)
        return (8, 95), (rows[:, None].to(dev), bins.clamp(0, 94).to(dev))
    return ((8,) if form == "w1" else (8, 4)), rows.to(dev)


def phase_table_grad(dev):
    """The table-gradient kernel against its plain version (autograd's
    ``index_put_(accumulate=True)``, ``table_grad.reduce_plain``) for
    each form of :func:`table_grad_case`: integer cotangents (exact in
    float32 in any order) equal to the float64 sums, random ones within
    1024 ulps of each element's sum of |g|, two calls bit-identical; then
    ms a call of the kernel back to back (``ms``: the host's issue of a
    call may set it) and its two kernels' device time a call under the
    profiler (``device_ms``, the kernel table's figure), the plain
    version's ms (also the kernel table's library figure: ``index_put_``
    is PyTorch's own kernel for this function), and the bound by bytes
    (each index and cotangent read once, the table written once) at the
    HBM rate.  Returns each form's row of the kernel table but its
    launches, which the gradient phases count."""
    from lumo_tpu_torch.bsdf import table_grad
    eps = torch.finfo(torch.float32).eps
    out = {}
    for form in ("w1", "w4", "dense"):
        shape, index = table_grad_case(form, dev)
        pair = table_grad.index_pair(torch.empty(shape, device=dev), index)
        lead = torch.broadcast_shapes(*(x.shape for x in pair
                                        if x is not None))
        g_shape = tuple(lead) + tuple(shape[1 if pair[1] is None else 2:])
        gen = torch.Generator().manual_seed(3)
        g_int = torch.randint(-4, 5, g_shape, generator=gen).float().to(dev)
        g = torch.randn(g_shape, generator=gen).to(dev)
        k_int = table_grad.reduce(g_int, shape, *pair)
        if not torch.equal(k_int.double(), table_grad.reduce_plain(
                g_int.double(), shape, *pair)):
            raise AssertionError(f"table_grad {form}: integer sums differ")
        k1 = table_grad.reduce(g, shape, *pair)
        k2 = table_grad.reduce(g, shape, *pair)
        torch.cuda.synchronize()
        if not torch.equal(k1.view(torch.int32), k2.view(torch.int32)):
            raise AssertionError(f"table_grad {form}: two calls differ")
        want = table_grad.reduce_plain(g.double(), shape, *pair)
        mass = table_grad.reduce_plain(g.double().abs(), shape, *pair)
        err = float((k1.double() - want).abs().max())
        if not bool(((k1.double() - want).abs() <= 1024 * eps * mass).all()):
            raise AssertionError(f"table_grad {form}: error {err} beyond "
                                 "1024 ulps of the sum of |g|")
        plain_err = float((table_grad.reduce_plain(g, shape, *pair).double()
                           - want).abs().max())
        ms = timed_ms(lambda: table_grad.reduce(g, shape, *pair), TABLE_REPS)
        plain_ms = timed_ms(lambda: table_grad.reduce_plain(g, shape, *pair),
                            TABLE_REPS // 5)
        _, on_card, _ = traced_frame(lambda: timed_ms(
            lambda: table_grad.reduce(g, shape, *pair), TABLE_REPS))
        device_ms = sum(e.duration_ns() for e in on_card
                        if "_sums<" in e.name()) / 1e6 / TABLE_REPS
        needed = (sum(x.numel() * 8 for x in pair if x is not None)
                  + g.numel() * 4 + math.prod(shape) * 4)
        bound_ms = needed / HBM_BYTES_PER_S * 1e3
        log("table-grad", form=form, table=json.dumps(list(shape)).replace(
            " ", ""), lanes=TABLE_LANES, ms=ms, device_ms=device_ms,
            plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by="bytes", bytes_needed=needed,
            max_abs_err=err, plain_max_abs_err=plain_err,
            vs_float64="integer sums exact", repeat="bit-identical")
        out[form] = {"ms": device_ms, "plain_ms": plain_ms, "max_abs_err": err,
                     "bound_ms": bound_ms, "bound_by": "bytes",
                     "library_ms": plain_ms}
    return out


# ---------------------------------------------------------------------------
# the differentiable path (fixed depth, checkpointed bounces) and the stream

GRAD_CORNELL_SPP = 2   # bench.py:44's 64 spp, cut for the script's time
GRAD_CORNELL_DEPTH = 6  # bench.py:46
GRAD_SPP = 2           # bench.py:275-276
GRAD_DEPTH = 4
GRAD_RUNS = 1          # timed runs after a warm-up (3 until slice 6)
STREAM_RUNS = 1        # stream and batch runs in turns (3 until slice 6)
STREAM_SPP = 16        # bench.py:216-219's 32 spp, cut for the script's time
STREAM_LANES = 262144
KD_STREAM_FRAMES = 1   # 3 until slice 6
# gradient agreement of two routes on lanes whose prims agree: the card's
# scatter-adds sum in any order
GRAD_RTOL, GRAD_ATOL_REL = 1e-4, 1e-5


def grad_pass(scene, camera, res, samples, depth, loss_fn, backward=True,
              checkpoint=False, weight=None, kernels=None):
    """One fwd(+bwd) over the samples ``samples`` (each a whole image at
    fixed depth), accumulating the gradients of every float material leaf
    and of ``c2w_t`` over them.  Returns loss (summed), rays (2 x sum of
    depths), the gradients (None when ``backward`` is False), the prims of
    each sample, wall seconds (synchronised), for a kernel module
    ``kernels`` its launches during the forwards and the backwards, and
    the table-gradient kernel's launches by index form during each
    (``table_grad.LAUNCHES``, set to 0 here)."""
    import dataclasses
    from lumo_tpu_torch.bsdf import table_grad
    from lumo_tpu_torch.integrators import path_trace
    dev = scene.device
    mats = {k: v.detach().clone().requires_grad_(backward)
            for k, v in scene.materials.items() if v.is_floating_point()}
    c2w_t = camera.c2w_t.detach().clone().requires_grad_(backward)
    sc = dataclasses.replace(scene, materials={**scene.materials, **mats})
    cam = dataclasses.replace(camera, c2w_t=c2w_t)
    launches = {"fwd": {"closest": 0, "any": 0}, "bwd": {"closest": 0, "any": 0}}
    tables = {part: dict.fromkeys(table_grad.LAUNCHES, 0)
              for part in ("fwd", "bwd")}
    snap = lambda: ((dict(kernels.LAUNCHES) if kernels is not None else {}),
                    dict(table_grad.LAUNCHES))

    def add(part, before):
        now = snap()
        for k in launches[part]:
            launches[part][k] += now[0].get(k, 0) - before[0].get(k, 0)
        for k in tables[part]:
            tables[part][k] += now[1][k] - before[1][k]

    loss_sum = torch.zeros((), device=dev)
    rays = torch.zeros((), device=dev)
    prims = []
    for k in table_grad.LAUNCHES:
        table_grad.LAUNCHES[k] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.set_grad_enabled(backward):
        for sp in samples:
            before = snap()
            o, d, lam, rk = grad_rays(cam, res, sp, dev)
            r, lam_out, dep, pr = path_trace.integrate(
                sc, o, d, lam, ray_key=rk, fixed_depth=depth,
                trace_prims=True, checkpoint=checkpoint)
            loss = loss_fn(r, lam_out, weight)
            add("fwd", before)
            if backward:
                before = snap()
                loss.backward()
                add("bwd", before)
            loss_sum += loss.detach()
            rays += 2.0 * dep.sum()
            prims.append(pr)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    grads = None
    if backward:
        grads = {k: v.grad for k, v in mats.items()}
        grads["c2w_t"] = c2w_t.grad
    return {"loss": float(loss_sum), "rays": float(rays), "grads": grads,
            "prims": prims, "wall": wall, "launches": launches,
            "table_launches": tables}


def grads_finite(grads):
    return all(bool(torch.isfinite(g).all()) for g in grads.values()
               if g is not None)


def phase_grad(phase, scene, camera, res, spp, depth, loss_fn, kernels=None,
               kernel_tag="traverse"):
    """A gradient cell: fwd+bwd rays/s with the checkpoint off (the
    default) and on, and forward-only rays/s (median of GRAD_RUNS in turns
    after a warm-up, with the fastest and slowest), loss, gnorm
    and finiteness, peak device memory of one sample with the checkpoint on
    and off, the idle share of one profiled sample's fwd+bwd, and the
    kernel launches of one fwd+bwd (checkpoint on and off) beside those of
    the forward alone: once per bounce each.  The table-gradient kernel's
    launches a sample by index form, checkpoint on and off, must come
    from the backwards alone; returns those of the checkpoint-off run."""
    samples = list(range(1, spp + 1))
    for ckpt in (False, True):                                   # warm-up
        grad_pass(scene, camera, res, samples[:1], depth, loss_fn,
                  checkpoint=ckpt)
    runs, runs_ckpt, fwd = [], [], []
    for _ in range(GRAD_RUNS):                # the three modes in turns
        runs.append(grad_pass(scene, camera, res, samples, depth, loss_fn,
                              kernels=kernels))
        runs_ckpt.append(grad_pass(scene, camera, res, samples, depth,
                                   loss_fn, checkpoint=True, kernels=kernels))
        fwd.append(grad_pass(scene, camera, res, samples, depth, loss_fn,
                             backward=False, kernels=kernels))
    for run in runs + runs_ckpt:
        if not grads_finite(run["grads"]):
            raise AssertionError(f"{phase}: non-finite gradients")
    rate = sorted(r["rays"] / r["wall"] for r in runs)
    rate_ckpt = sorted(r["rays"] / r["wall"] for r in runs_ckpt)
    rate_f = sorted(r["rays"] / r["wall"] for r in fwd)
    peak = {}
    for ckpt in (True, False):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        grad_pass(scene, camera, res, samples[:1], depth, loss_fn,
                  checkpoint=ckpt)
        peak[ckpt] = (torch.cuda.max_memory_allocated(), base)
    per = phase_profile(f"{phase}-profile", lambda: _profiled_sample(
        scene, camera, res, depth, loss_fn), "grad_sample", kernel_tag)
    run, off = runs_ckpt[0], runs[0]["launches"]
    both = {k: run["launches"]["fwd"][k] + run["launches"]["bwd"][k]
            for k in ("closest", "any")}
    tables = {mode: {part: {k: int(v) if float(v).is_integer() else v
                            for k, v in ((k, n / spp) for k, n in
                                         r["table_launches"][part].items())}
                     for part in ("fwd", "bwd")}
              for mode, r in (("off", runs[0]), ("on", run), ("fwd", fwd[0]))}
    log(phase, res=f"{res}x{res}", spp=spp, depth=depth, lanes=res * res,
        runs=GRAD_RUNS, fwd_bwd_rays_per_s_median=float(np.median(rate)),
        fwd_bwd_rays_per_s_min=rate[0], fwd_bwd_rays_per_s_max=rate[-1],
        checkpoint_fwd_bwd_rays_per_s_median=float(np.median(rate_ckpt)),
        checkpoint_fwd_bwd_rays_per_s_min=rate_ckpt[0],
        checkpoint_fwd_bwd_rays_per_s_max=rate_ckpt[-1],
        fwd_rays_per_s_median=float(np.median(rate_f)),
        fwd_rays_per_s_min=rate_f[0], fwd_rays_per_s_max=rate_f[-1],
        wall_s=json.dumps([r["wall"] for r in runs]).replace(" ", ""),
        checkpoint_wall_s=json.dumps(
            [r["wall"] for r in runs_ckpt]).replace(" ", ""),
        fwd_wall_s=json.dumps([r["wall"] for r in fwd]).replace(" ", ""),
        rays=runs[0]["rays"], loss=runs[0]["loss"] / spp,
        gnorm=gnorm(runs[0]["grads"], spp), grads_finite=True,
        peak_bytes_checkpoint_on=peak[True][0],
        peak_bytes_checkpoint_off=peak[False][0],
        allocated_before_bytes=peak[True][1],
        checkpoint_launches_fwd_bwd=json.dumps(both).replace(" ", ""),
        checkpoint_launches_of_its_backward=json.dumps(
            run["launches"]["bwd"]).replace(" ", ""),
        launches_fwd_bwd=json.dumps(
            {k: off["fwd"][k] + off["bwd"][k] for k in off["fwd"]}).replace(
                " ", ""),
        launches_forward_only=json.dumps(fwd[0]["launches"]["fwd"]).replace(" ", ""),
        table_grad_launches_a_sample=json.dumps(
            tables["off"]["bwd"]).replace(" ", ""),
        checkpoint_table_grad_launches_a_sample=json.dumps(
            tables["on"]["bwd"]).replace(" ", ""),
        kernel_ms_per_profiled_sample=json.dumps(per).replace(" ", ""))
    if (any(tables[mode][part][k] for mode, part in (
            ("off", "fwd"), ("on", "fwd"), ("fwd", "fwd"), ("fwd", "bwd"))
            for k in tables["off"]["fwd"])
            or not all(sum(tables[mode]["bwd"].values())
                       for mode in ("off", "on"))):
        raise AssertionError(f"{phase}: the table-gradient kernel ran "
                             f"outside the backward or not in it: {tables}")
    once = {"closest": spp * depth, "any": spp * depth}
    if kernels is not None and not (
            both == fwd[0]["launches"]["fwd"] == off["fwd"] == once
            and sum(off["bwd"].values()) == 0):
        raise AssertionError(f"{phase}: the backward launched kernels: "
                             f"{both}, {off} against "
                             f"{fwd[0]['launches']['fwd']}")
    return tables["off"]["bwd"]


def _profiled_sample(scene, camera, res, depth, loss_fn):
    with torch.profiler.record_function("grad_sample"):
        return grad_pass(scene, camera, res, [1], depth, loss_fn)["wall"]


def _weighted_grads(scene, camera, weight, plain_mod=None):
    """[grad-parity]'s fwd+bwd at PARITY_RES, 1 sample, depth GRAD_DEPTH,
    loss mean(w r^2); routed to ``plain_mod``'s plain versions when
    given."""
    run = lambda: grad_pass(scene, camera, PARITY_RES, [1], GRAD_DEPTH,
                            loss_r2, backward=weight is not None,
                            weight=weight)
    if plain_mod is None:
        return run()
    with mock.patch.object(plain_mod, "closest_hit",
                           plain_mod.closest_hit_plain), \
            mock.patch.object(plain_mod, "any_hit", plain_mod.any_hit_plain):
        return run()


def compare_grads(phase, got, want):
    """Each gradient within (GRAD_RTOL, GRAD_ATOL_REL x its largest entry)
    of ``want``; returns the largest error relative to that entry."""
    worst = 0.0
    for k, w in want.items():
        g = got[k]
        if w is None or g is None:
            if (w is None) != (g is None):
                raise AssertionError(f"{phase}: {k} has a gradient on one "
                                     "route only")
            continue
        scale = max(float(w.abs().max()), 1e-30)
        if not torch.allclose(g, w, rtol=GRAD_RTOL,
                              atol=GRAD_ATOL_REL * scale):
            raise AssertionError(f"{phase}: {k} gradients disagree "
                                 f"(max |diff| {float((g - w).abs().max())},"
                                 f" scale {scale})")
        worst = max(worst, float((g - w).abs().max()) / scale)
    return worst


def phase_grad_parity(scene, dev):
    """Gradients of every float material leaf and c2w_t through K2 against
    the same routed to the plain versions, at PARITY_RES, 1 sample, depth
    4; lanes whose prims differ are counted and weighted out.  Returns the
    camera, the weight and K2's gradients for [grad-kd]."""
    from lumo_tpu_torch.accel import bvh_kernel
    from lumo_tpu_torch.camera import build_camera
    cam = build_camera(resolution=(PARITY_RES, PARITY_RES), device=dev)
    pr_k = _weighted_grads(scene, cam, None)["prims"][0]
    t0 = time.perf_counter()
    pr_p = _weighted_grads(scene, cam, None, bvh_kernel)["prims"][0]
    same = (pr_k == pr_p).all(dim=0)
    flips = int((~same).sum())
    weight = same.float()
    g_k = _weighted_grads(scene, cam, weight)
    g_p = _weighted_grads(scene, cam, weight, bvh_kernel)
    err = compare_grads("grad-parity", g_k["grads"], g_p["grads"])
    log("grad-parity", res=f"{PARITY_RES}x{PARITY_RES}", spp=1,
        depth=GRAD_DEPTH, lanes=same.numel(), topology_flips=flips,
        leaves=len(g_k["grads"]), max_rel_err=err, rtol=GRAD_RTOL,
        atol_rel=GRAD_ATOL_REL, loss_k2=g_k["loss"], loss_plain=g_p["loss"],
        grads_finite=grads_finite(g_k["grads"]),
        plain_s=round(time.perf_counter() - t0, 2))
    if flips > same.numel() // 100 or not grads_finite(g_k["grads"]):
        raise AssertionError("grad-parity: too many flips or non-finite")
    return cam, weight, g_k


def phase_grad_kd(scene_kd, scene_bvh, parity):
    """The same rays and loss through K3 on the kd-built scene against
    [grad-parity]'s K2 gradients.  K3 and K2 give bit-equal t on the same
    rays, so only the walls' route differs (the kd tree against the dense
    test); lanes whose per-bounce hit pattern differs are counted and
    weighted out of both."""
    cam, weight, _ = parity
    from lumo_tpu_torch.accel import kd_kernel
    f_kd = _weighted_grads(scene_kd, cam, None)
    f_bvh = _weighted_grads(scene_bvh, cam, None)
    agree = ((f_kd["prims"][0] >= 0) == (f_bvh["prims"][0] >= 0)).all(dim=0)
    flips = int((~agree).sum())
    w2 = weight * agree.float()
    before = dict(kd_kernel.LAUNCHES)
    g_kd = _weighted_grads(scene_kd, cam, w2)
    launches = {k: kd_kernel.LAUNCHES[k] - before[k] for k in before}
    g_bvh = _weighted_grads(scene_bvh, cam, w2)
    err = compare_grads("grad-kd", g_kd["grads"], g_bvh["grads"])
    log("grad-kd", res=f"{PARITY_RES}x{PARITY_RES}", spp=1, depth=GRAD_DEPTH,
        lanes=agree.numel(), flips_vs_k2=flips, max_rel_err=err,
        rtol=GRAD_RTOL, atol_rel=GRAD_ATOL_REL, loss_k3=g_kd["loss"],
        loss_k2=g_bvh["loss"], grads_finite=grads_finite(g_kd["grads"]),
        launches=json.dumps(launches).replace(" ", ""))
    if flips > agree.numel() // 100 or min(launches.values()) != GRAD_DEPTH:
        raise AssertionError(f"grad-kd: {flips} flips, launches {launches}")


def phase_stream(scene, camera, dev):
    """bench.py:222-265's forward on the BVH scene: ``integrate_stream``
    with 262,144 lanes over STREAM_SPP spp of 256^2 against batch
    ``integrate`` over the same samples (waves of 262,144), in turns.  Sum
    of depths equal, per-pixel radiance sums within rtol 1e-4, atol
    1e-5."""
    from lumo_tpu_torch.accel import bvh_kernel
    from lumo_tpu_torch.integrators import path_trace
    n = RES * RES
    n_samples = n * STREAM_SPP

    def gen(idx):
        o, d, lam, rk, p = sample_rays(camera, RES, idx)
        return {"o": o, "d": d, "lam": lam, "rng": rk, "pix": p}

    def fold(acc, term, st):
        depth, rad, iters = acc
        return (depth + torch.where(term, st["depth"], 0).sum(),
                rad.index_add(0, st["pix"], torch.where(
                    term[:, None], st["radiance"], 0.0)), iters + 1)

    def stream():
        acc0 = (torch.zeros((), dtype=torch.int64, device=dev),
                torch.zeros((n, 4), device=dev), 0)
        with torch.profiler.record_function("stream"):
            return path_trace.integrate_stream(scene, gen, fold, acc0,
                                               STREAM_LANES, n_samples)

    def batch():
        depth = torch.zeros((), dtype=torch.int64, device=dev)
        rad = torch.zeros((n, 4), device=dev)
        bounces = 0
        for w in range(n_samples // STREAM_LANES):
            idx = torch.arange(STREAM_LANES, device=dev) + w * STREAM_LANES
            o, d, lam, rk, p = sample_rays(camera, RES, idx)
            r, _, dep, pr = path_trace.integrate(scene, o, d, lam,
                                                 ray_key=rk, trace_prims=True)
            depth, rad = depth + dep.sum(), rad.index_add(0, p, r)
            bounces += pr.shape[0]
        return depth, rad, bounces

    def timed(fn):
        for k in bvh_kernel.LAUNCHES:
            bvh_kernel.LAUNCHES[k] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, {
            k: bvh_kernel.LAUNCHES[k] for k in ("closest", "any")}

    stream()                                        # warm-up
    walls = {"batch": [], "stream": []}
    for _ in range(STREAM_RUNS):
        b, wall_b, launch_b = timed(batch)
        s, wall_s, launch_s = timed(stream)
        walls["batch"].append(wall_b)
        walls["stream"].append(wall_s)
    depth_b, rad_b, bounces_b = b
    depth_s, rad_s, iters_s = s
    close = torch.isclose(rad_s, rad_b, rtol=1e-4, atol=1e-5).all(dim=1)
    rays = 2.0 * float(depth_s)
    med = lambda xs: float(np.median(xs))
    per = phase_profile("stream-profile", lambda: timed(stream)[1], "stream",
                        "traverse")
    log("stream", res=f"{RES}x{RES}", spp=STREAM_SPP, samples=n_samples,
        lanes=STREAM_LANES, rays=rays,
        stream_rays_per_s_median=rays / med(walls["stream"]),
        stream_rays_per_s_min=rays / max(walls["stream"]),
        stream_rays_per_s_max=rays / min(walls["stream"]),
        batch_rays_per_s_median=rays / med(walls["batch"]),
        batch_rays_per_s_min=rays / max(walls["batch"]),
        batch_rays_per_s_max=rays / min(walls["batch"]),
        stream_wall_s=json.dumps(walls["stream"]).replace(" ", ""),
        batch_wall_s=json.dumps(walls["batch"]).replace(" ", ""),
        stream_iterations=iters_s, batch_bounce_iterations=bounces_b,
        depth_sum_stream=int(depth_s), depth_sum_batch=int(depth_b),
        pixels_beyond_tolerance=int((~close).sum()),
        launches_stream=json.dumps(launch_s).replace(" ", ""),
        launches_batch=json.dumps(launch_b).replace(" ", ""),
        kernel_ms_per_stream_frame=json.dumps(per).replace(" ", ""))
    if int(depth_s) != int(depth_b) or not bool(close.all()):
        raise AssertionError("stream and batch disagree")
    return launch_s


def kd_stream_frame(scene, camera, spp, delta=None):
    """``Renderer(scene, camera).samples(spp).stream().render()``: (image,
    2 x sum of path depths, wall seconds)."""
    from lumo_tpu_torch import renderer
    accs = []
    real = renderer.path_trace.integrate_stream

    def integrate_stream(*args, **kwargs):
        accs.append(real(*args, **kwargs))
        return accs[-1]

    r = renderer.Renderer(scene, camera).samples(spp).stream()
    if delta is not None:
        r.fixed_rr_delta(delta)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with mock.patch.object(renderer.path_trace, "integrate_stream",
                           integrate_stream):
        img = r.render(verbose=False)
    wall = time.perf_counter() - t0
    w, h = camera.resolution
    # the renderer counts depth + 1 rays per sample
    return img, 2.0 * (float(accs[0][2]) - w * h * spp), wall


def phase_render_kd_stream(scene, camera):
    """``Renderer(scene_kd, camera).samples(4).stream().render()`` beside
    [render-kd]'s batch render: rays/s of the default (adaptive) render,
    and the image of both modes at the fixed threshold 1, which trace the
    same samples: pixels within rtol 1e-4, atol 1e-6 (sums in another
    order), those beyond counted (at most 1%)."""
    from lumo_tpu_torch.accel import kd_kernel
    kd_stream_frame(scene, camera, SPP)               # warm-up
    walls, rays, per_frame = [], [], []
    for _ in range(KD_STREAM_FRAMES):
        for k in kd_kernel.LAUNCHES:
            kd_kernel.LAUNCHES[k] = 0
        img, r, wall = kd_stream_frame(scene, camera, SPP)
        per_frame.append(dict(kd_kernel.LAUNCHES))
        if img.shape != (RES, RES, 3) or not np.isfinite(img).all():
            raise AssertionError("kd stream: wrong shape or non-finite")
        walls.append(wall)
        rays.append(r)
    rate = sorted(r / w for r, w in zip(rays, walls))
    img_s, _, _ = kd_stream_frame(scene, camera, SPP, delta=1.0)
    img_b, _, _ = kd_frame(scene, camera, SPP, delta=1.0)
    close = np.isclose(img_s, img_b, rtol=1e-4, atol=1e-6).all(axis=-1)
    flips = int((~close).sum())
    log("render-kd-stream", entry="Renderer.samples(4).stream().render()",
        res=f"{RES}x{RES}", spp=SPP, frames=KD_STREAM_FRAMES,
        wall_s=json.dumps(walls).replace(" ", ""), rays=int(rays[-1]),
        rays_per_s_median=float(np.median(rate)), rays_per_s_min=rate[0],
        rays_per_s_max=rate[-1],
        launches=json.dumps(per_frame[0]).replace(" ", ""),
        image_mean=float(img.mean()), fixed_delta_pixels=close.size,
        fixed_delta_flips=flips,
        fixed_delta_max_abs_err=float(np.abs(img_s - img_b)[close].max()),
        rtol=1e-4, atol=1e-6)
    if flips > close.size // 100 or min(per_frame[0].values()) <= 0:
        raise AssertionError("kd stream and batch images disagree")
    return per_frame[0]


# ---------------------------------------------------------------------------
# slice 5: the example programs' scenes (materials, textures, shapes, media)

MAT_RES = 512          # the examples' resolution
MAT_SPP = 2            # cut from the examples' 512 spp (4 until slice 6)
MAT_FRAMES = 1         # timed frames per scene (2 until slice 6)
MAT_PARITY_RES = 128
MAT_SCENES = (("dragon", "bvh"), ("dragon-kd", "kdtree"), ("dof", "bvh"),
              ("nefertiti", "bvh"), ("medium", "bvh"), ("circle", "bvh"))


def example_scene(name, dev, accel):
    """The scene of the port's example program ``name``
    (``lumo_tpu_torch.examples.<name>``, its stand-in meshes) as its
    ``make`` builds it at MAT_RES with ``accel`` on ``dev``: (scene,
    camera(res) giving the program's camera at res^2, the renderer's
    illuminant)."""
    import argparse
    import importlib
    mod = importlib.import_module(f"lumo_tpu_torch.examples.{name}")

    def args(res):
        return argparse.Namespace(**{**vars(mod.parse([])), "res": res,
                                     "accel": accel,
                                     "cpu": dev.type == "cpu"})

    r = mod.make(args(MAT_RES))
    return r.scene, lambda res: mod.camera(args(res)), r._illuminant


def integrator_frame(scene, camera, kind, spp, illuminant=None, delta=None,
                     square=False, configure=None, lanes=None):
    """One frame through ``Renderer(scene, camera).integrator(kind)``:
    (image (H, W, 3) numpy, 2 x sum of path depths, wall seconds of
    ``render``, bounce iterations of the path integrator, splats set).  A
    BDPT sample's depth counts the vertices of both its subpaths.  A list
    ``lanes`` gets each ``integrate`` call's per-lane depths."""
    from lumo_tpu_torch import film, renderer
    mod = {"path": renderer.path_trace, "direct": renderer.direct_light,
           "bdpt": renderer.bdpt}[kind]
    depths, splats, bounces = [], [], [0]
    real, real_bounce = mod.integrate, renderer.path_trace.bounce

    def integrate(*args, **kwargs):
        out = real(*args, **kwargs)
        depths.append(out[-1].sum())
        if lanes is not None:
            lanes.append(out[-1])
        if kind == "bdpt":
            splats.append(out[4].sum())
        return out

    def bounce(*args, **kwargs):
        bounces[0] += 1
        return real_bounce(*args, **kwargs)

    r = renderer.Renderer(scene, camera).integrator(kind).samples(spp)
    if illuminant:
        r.illuminant(illuminant)
    if delta is not None:
        r.fixed_rr_delta(delta)
    if square:
        r.pixel_filter(film.PixelFilter.square())
    if configure is not None:
        configure(r)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with mock.patch.object(mod, "integrate", integrate), \
            mock.patch.object(renderer.path_trace, "bounce", bounce), \
            torch.profiler.record_function("render"):
        img = r.render(verbose=False)    # ends with the image on the host
    wall = time.perf_counter() - t0
    return img, 2.0 * float(sum(depths)), wall, bounces[0], int(sum(splats))


def _launch_counts():
    from lumo_tpu_torch.accel import bvh_kernel, kd_kernel
    return {"k2_closest": bvh_kernel.LAUNCHES["closest"],
            "k2_any": bvh_kernel.LAUNCHES["any"],
            "k3_closest": kd_kernel.LAUNCHES["closest"],
            "k3_any": kd_kernel.LAUNCHES["any"]}


def _reset_launches():
    from lumo_tpu_torch.accel import bvh_kernel, kd_kernel
    for table in (bvh_kernel.LAUNCHES, kd_kernel.LAUNCHES):
        for k in table:
            table[k] = 0


def _plain_routed(accel):
    """Context routing the scene's traversal queries to the plain
    versions."""
    import contextlib
    from lumo_tpu_torch.accel import bvh_kernel, kd_kernel
    mod = kd_kernel if accel == "kdtree" else bvh_kernel
    stack = contextlib.ExitStack()
    stack.enter_context(mock.patch.object(mod, "closest_hit",
                                          mod.closest_hit_plain))
    stack.enter_context(mock.patch.object(mod, "any_hit", mod.any_hit_plain))
    return stack


def _image_parity(img_a, img_b, rtol, atol):
    close = np.isclose(img_a, img_b, rtol=rtol, atol=atol).all(axis=-1)
    err = np.abs(img_a - img_b)[close]
    return int((~close).sum()), float(err.max()) if err.size else 0.0


def traced_frame(frame, span=None):
    """(wall seconds, device events, seconds to read them) of one more
    frame under ``torch.profiler`` with device activity only, read from
    the raw Kineto events (building ``prof.events()`` for a frame of
    ~200,000 events takes half a minute; tracing the host's operations
    too adds 5 to 12 s a frame).  ``frame()`` renders it, ending
    synchronised, and returns its wall seconds; events named ``span`` (a
    host range's annotation) are left out."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        wall = frame()
    t0 = time.perf_counter()
    events = [e for e in prof.profiler.kineto_results.events()
              if str(e.device_type()).endswith("CUDA") and e.name() != span]
    return wall, events, round(time.perf_counter() - t0, 2)


def busy_ns(events):
    """Nanoseconds of the union of the events' device intervals."""
    spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in events)
    busy, end = 0, spans[0][0]
    for a, b in spans:
        a = max(a, end)
        if b > a:
            busy, end = busy + b - a, b
    return busy


def idle_share(phase, frame):
    """The device's idle share over one more frame: the union of the
    device intervals over the frame's wall (:func:`traced_frame`)."""
    wall, events, read_s = traced_frame(frame)
    if not events:
        log(phase, device_events=0, device_time="not measured")
        return
    busy = busy_ns(events)
    log(phase, wall_ms=wall * 1e3, device_events=len(events),
        device_busy_ms=busy / 1e6, idle_share=1.0 - busy / 1e9 / wall,
        read_s=read_s)


def phase_materials(dev):
    """Slice 5's paths: the scenes of ``examples/{dragon,dof,nefertiti,
    medium,circle}.py`` built with the port and rendered through
    ``Renderer(...).integrator("path")`` at the examples' 512^2 and MAT_SPP
    spp (cut from their 512 spp): per scene the build seconds, the primitive
    counts, rays/s (median, fastest and slowest of MAT_FRAMES frames; the
    earlier phases have warmed the card), bounces, and the K2/K3 launches
    per frame (reset just before each frame, read just after); the idle
    share of one profiled frame of dragon.  Then at 128^2, 1 spp,
    fixed Russian roulette threshold and the square filter (a pixel is
    one sample):
    dragon's and dof's kernel-routed image against the plain-routed one
    (rtol 1e-5, atol 1e-7) and dragon's K3 image against its K2 image
    (rtol 1e-5, atol 1e-6), pixels beyond counted as flips (at most
    1%)."""
    t_phase = time.perf_counter()
    scenes = {}
    kept = ("dragon", "dragon-kd", "dof")
    for name, accel in MAT_SCENES:
        t0 = time.perf_counter()
        scene, make_camera, illum = example_scene(name.replace("-kd", ""),
                                                  dev, accel)
        torch.cuda.synchronize()
        camera = make_camera(MAT_RES)
        build_s = time.perf_counter() - t0
        walls, rays, per_frame, bounces = [], [], [], []
        for _ in range(MAT_FRAMES):
            _reset_launches()
            img, r, wall, nb, _ = integrator_frame(scene, camera, "path",
                                                   MAT_SPP, illum)
            per_frame.append(_launch_counts())
            if img.shape != (MAT_RES, MAT_RES, 3) or not np.isfinite(
                    img).all():
                raise AssertionError(f"{name}: wrong shape or non-finite")
            walls.append(wall)
            rays.append(r)
            bounces.append(nb)
        launches = per_frame[0]
        k2 = launches["k2_closest"] + launches["k2_any"]
        k3 = launches["k3_closest"] + launches["k3_any"]
        tree = {"bvh": scene.bvh, "kdtree": scene.kdtree}[accel]
        want = {"bvh": (tree is not None, False),
                "kdtree": (False, True)}[accel]
        if (k2 > 0, k3 > 0) != want or any(f != launches for f in per_frame):
            raise AssertionError(f"{name}: launches per frame {per_frame}")
        rate = sorted(r / w for r, w in zip(rays, walls))
        median = float(np.median(rate))
        fields = dict(
            scene=name, accel=accel if tree is not None else "dense",
            build_s=round(build_s, 3), tris=scene.n_tris,
            spheres=scene.n_spheres, analytics=scene.n_analytic,
            medium=scene.medium is not None, res=f"{MAT_RES}x{MAT_RES}",
            spp=MAT_SPP, frames=MAT_FRAMES,
            wall_s=json.dumps(walls).replace(" ", ""), rays=int(rays[-1]),
            rays_per_s_median=median, rays_per_s_min=rate[0],
            rays_per_s_max=rate[-1], bounces=bounces[-1],
            launches=json.dumps(launches).replace(" ", ""),
            image_mean=float(img.mean()), finite=True)
        log("materials", **fields)
        if name == "dragon":
            idle_share(f"materials-profile-{name}",
                       lambda: integrator_frame(scene, camera, "path",
                                                MAT_SPP, illum)[2])
        if name in kept:
            scenes[name] = (scene, accel, illum, make_camera)
        del scene

    # kernel-routed against plain-routed, and K3 against K2
    images = {}
    for name in kept:
        scene, accel, illum, make_camera = scenes[name]
        cam = make_camera(MAT_PARITY_RES)
        images[name] = integrator_frame(scene, cam, "path", 1, illum,
                                        delta=1.0, square=True)[0]
        if name == "dragon-kd":
            continue
        t0 = time.perf_counter()
        with _plain_routed(accel):
            img_p = integrator_frame(scene, cam, "path", 1, illum,
                                     delta=1.0, square=True)[0]
        flips, err = _image_parity(images[name], img_p, 1e-5, 1e-7)
        log("materials-parity", scene=name, res=f"{MAT_PARITY_RES}x"
            f"{MAT_PARITY_RES}", spp=1, pixels=img_p.shape[0] ** 2,
            flips=flips, image_max_abs_err=err, rtol=1e-5, atol=1e-7,
            plain_render_s=round(time.perf_counter() - t0, 2))
        if flips > img_p.shape[0] ** 2 // 100:
            raise AssertionError(f"{name}: kernel and plain renders disagree")
    flips, err = _image_parity(images["dragon-kd"], images["dragon"], 1e-5,
                               1e-6)
    n_pix = MAT_PARITY_RES ** 2
    log("materials-parity", scene="dragon-kd-vs-dragon", spp=1,
        res=f"{MAT_PARITY_RES}x{MAT_PARITY_RES}", pixels=n_pix, flips=flips,
        image_max_abs_err=err, rtol=1e-5, atol=1e-6)
    if flips > n_pix // 100:
        raise AssertionError("dragon: K3 and K2 renders disagree")
    log("materials", phase_s=round(time.perf_counter() - t_phase, 1))


# ---------------------------------------------------------------------------
# slice 6: the direct-light and bidirectional integrators

DIRECT_FRAMES = 3      # timed frames of [direct] after a warm-up
BDPT_SPP = 1           # cut from caustics.py's 2,048 and box.py's 64 spp
BDPT_FRAMES = 1        # timed frames per scene after a warm-up (2 until
                       # slice 8)
BDPT_TWIN_FRAMES = 1   # box's (no kernel) and caustics-kd's (2 until slice 7)
BDPT_PROFILED = ("caustics", "bench")  # idle share (all four until slice 7)
BDPT_BENCH_DEPTH = 6


def _timed_frames(phase, name, accel, frame, n_frames, res, keep=None):
    """A warm-up frame, then ``n_frames`` timed ones with the launch
    counts reset just before and read just after each, and the peak
    device memory of the last: rays/s (median, fastest, slowest), launches
    a frame (equal in every frame, of the scene's kernel only), splats,
    finiteness.  With a dict ``keep``, the last frame's image, rays, wall
    seconds, launches and K2 query sizes go into it (``[devices]``'s
    one-device reference)."""
    frame()
    walls, rays, per_frame, splats = [], [], [], []
    for i in range(n_frames):
        _reset_launches()
        torch.cuda.reset_peak_memory_stats()
        # the query sizes' patch is entered at once: only on the kept frame
        stack, sizes = (_k2_query_sizes() if keep is not None
                        and i == n_frames - 1
                        else (contextlib.nullcontext(), None))
        with stack:
            img, r, wall, _, sp = frame()
        per_frame.append(_launch_counts())
        if img.shape != (res, res, 3) or not np.isfinite(img).all():
            raise AssertionError(f"{phase} {name}: wrong shape or non-finite")
        walls.append(wall)
        rays.append(r)
        splats.append(sp)
    launches = per_frame[0]
    k2 = launches["k2_closest"] + launches["k2_any"]
    k3 = launches["k3_closest"] + launches["k3_any"]
    want = {"bvh": (True, False), "kdtree": (False, True),
            "dense": (False, False)}[accel]
    if (k2 > 0, k3 > 0) != want or any(f != launches for f in per_frame):
        raise AssertionError(f"{phase} {name}: launches per frame "
                             f"{per_frame}")
    if keep is not None:
        keep.update(image=img, rays=rays[-1], wall=walls[-1],
                    launches=per_frame[-1], sizes=sizes)
    rate = sorted(r / w for r, w in zip(rays, walls))
    log(phase, scene=name, accel=accel, res=f"{res}x{res}",
        frames=n_frames, warmup_frames=1,
        wall_s=json.dumps(walls).replace(" ", ""), rays=int(rays[-1]),
        rays_per_s_median=float(np.median(rate)), rays_per_s_min=rate[0],
        rays_per_s_max=rate[-1],
        launches=json.dumps(launches).replace(" ", ""),
        splats=splats[-1], peak_bytes=torch.cuda.max_memory_allocated(),
        image_mean=float(img.mean()), finite=True)
    return launches


def _routed_parity(phase, name, accel, frame, rtol=1e-5, atol=1e-6):
    """The kernel-routed frame against the plain-routed one: pixels within
    (rtol, atol), the rest counted as flips (at most 1%).  Returns the
    kernel-routed image."""
    img_k = frame()[0]
    t0 = time.perf_counter()
    with _plain_routed(accel):
        img_p = frame()[0]
    flips, err = _image_parity(img_k, img_p, rtol, atol)
    n_pix = img_p.shape[0] * img_p.shape[1]
    log(phase, case="kernel-vs-plain", scene=name, accel=accel,
        res=f"{img_p.shape[1]}x{img_p.shape[0]}", pixels=n_pix, flips=flips,
        image_max_abs_err=err, rtol=rtol, atol=atol,
        plain_render_s=round(time.perf_counter() - t0, 2))
    if flips > n_pix // 100:
        raise AssertionError(f"{phase} {name}: kernel and plain renders "
                             f"disagree")
    return img_k


def phase_direct(scenes, camera, dev, refs):
    """The direct-light integrator through ``Renderer(scene,
    camera).integrator("direct").samples(4).render()`` on the
    327,692-triangle scene built as BVH (K2) and as kd-tree (K3) at
    256^2: rays/s over DIRECT_FRAMES frames after a warm-up, K2/K3
    launches a frame, the idle share of one profiled frame, finiteness;
    then at 64^2 (1 spp, square filter) the kernel-routed image against
    the plain-routed one (rtol 1e-5, atol 1e-6, flips counted) and the K3
    image against the K2 image.  The last K2 frame goes into
    ``refs["direct"]``."""
    from lumo_tpu_torch.camera import build_camera
    t_phase = time.perf_counter()
    small = build_camera(resolution=(PARITY_RES, PARITY_RES), device=dev)
    images = {}
    launches = {}
    for accel, scene in scenes.items():
        frame = lambda: integrator_frame(scene, camera, "direct", SPP)
        launches[accel] = _timed_frames(
            "direct", "bench", accel, frame, DIRECT_FRAMES, RES,
            keep=refs.setdefault("direct", {}) if accel == "bvh" else None)
        idle_share(f"direct-profile-{accel}", lambda: frame()[2])
        images[accel] = _routed_parity(
            "direct", "bench", accel, lambda: integrator_frame(
                scene, small, "direct", 1, square=True))
    flips, err = _image_parity(images["kdtree"], images["bvh"], 1e-5, 1e-6)
    log("direct", case="kd-vs-bvh", scene="bench", pixels=PARITY_RES ** 2,
        flips=flips, image_max_abs_err=err, rtol=1e-5, atol=1e-6)
    if flips > PARITY_RES ** 2 // 100:
        raise AssertionError("direct: K3 and K2 renders disagree")
    log("direct", phase_s=round(time.perf_counter() - t_phase, 1))
    return launches


def phase_bdpt(bench, camera, dev, refs):
    """The bidirectional integrator through ``Renderer(scene,
    camera).integrator("bdpt")`` on ``examples/caustics.py``'s scene at
    its 512^2 (``bdpt_depth`` automatic: 12 with glass) built as BVH (K2)
    and as kd-tree (K3), ``examples/box.py``'s at 512^2 (dense, its wide
    Gaussian filter) and the 327,692-triangle scene at 256^2 with depth
    6 (K2); BDPT_SPP spp, BDPT_FRAMES timed frames after a warm-up
    (BDPT_TWIN_FRAMES on box and caustics-kd): per
    scene rays/s, K2/K3 launches a frame, splats a frame, peak device
    memory, finiteness; the idle share of one profiled frame of
    BDPT_PROFILED.  Then at
    64^2 (1 spp, fixed Russian-roulette threshold, square filter) the K2
    images against the plain-routed ones and caustics' K3 image against
    its K2 image (rtol 1e-5, atol 1e-6, flips counted).  The last frame
    of the 327,692-triangle scene goes into ``refs["bdpt"]``."""
    from lumo_tpu_torch import film
    from lumo_tpu_torch.camera import build_camera
    t_phase = time.perf_counter()
    gaussian = lambda r: r.pixel_filter(film.PixelFilter.gaussian(
        2.5, 2.5 / 4.0))
    small_images = {}
    launches = {}
    for name, accel in (("caustics", "bvh"), ("caustics-kd", "kdtree"),
                        ("box", "dense"), ("bench", "bvh")):
        t0 = time.perf_counter()
        if name == "bench":
            scene, make_camera, res = bench, None, RES
            cam = camera
            conf = lambda r: r.bdpt_depth(BDPT_BENCH_DEPTH)
        else:
            scene, make_camera, _ = example_scene(
                name.replace("-kd", ""), dev,
                "kdtree" if accel == "kdtree" else "bvh")
            res = MAT_RES
            cam = make_camera(res)
            conf = gaussian if name == "box" else None
        torch.cuda.synchronize()
        log("bdpt", scene=name, build_s=round(time.perf_counter() - t0, 3),
            tris=scene.n_tris, spheres=scene.n_spheres,
            depth=_bdpt_depth(scene, conf))
        frame = lambda: integrator_frame(scene, cam, "bdpt", BDPT_SPP,
                                         configure=conf)
        launches[name] = _timed_frames(
            "bdpt", name, accel, frame,
            BDPT_TWIN_FRAMES if name in ("box", "caustics-kd")
            else BDPT_FRAMES, res,
            keep=refs.setdefault("bdpt", {}) if name == "bench" else None)
        if name in BDPT_PROFILED:
            idle_share(f"bdpt-profile-{name}", lambda: frame()[2])
        if accel == "dense":
            del scene
            continue
        small = (build_camera(resolution=(PARITY_RES, PARITY_RES),
                              device=dev) if make_camera is None
                 else make_camera(PARITY_RES))
        small_frame = lambda: integrator_frame(
            scene, small, "bdpt", 1, delta=1.0, square=True,
            configure=None if name != "bench" else conf)
        # K3 is held against K2 below (its plain walk, which
        # [parity-kd] and [direct] run, would take 40 s here)
        small_images[name] = (small_frame()[0] if accel == "kdtree" else
                              _routed_parity("bdpt", name, accel,
                                             small_frame))
        del scene
    flips, err = _image_parity(small_images["caustics-kd"],
                               small_images["caustics"], 1e-5, 1e-6)
    log("bdpt", case="kd-vs-bvh", scene="caustics", pixels=PARITY_RES ** 2,
        flips=flips, image_max_abs_err=err, rtol=1e-5, atol=1e-6)
    if flips > PARITY_RES ** 2 // 100:
        raise AssertionError("bdpt: caustics' K3 and K2 renders disagree")
    log("bdpt", phase_s=round(time.perf_counter() - t_phase, 1))
    return launches


def _bdpt_depth(scene, configure):
    from lumo_tpu_torch.renderer import Renderer
    from lumo_tpu_torch.camera import build_camera
    r = Renderer(scene, build_camera(resolution=(1, 1),
                                     device=scene.device))
    if configure is not None:
        configure(r)
    return r._resolved_bdpt_depth()


# ---------------------------------------------------------------------------
# slice 7: runtime instancing and the .obj/.mtl/PNG loaders

INST_FRAMES = 1        # timed frames per scene after a warm-up (2 until
                       # slice 8)
INST_PARITY_RES = 24   # kernel- against plain-routed: the plain test is dense
                       # (32 until slice 13)
INST_DEFAULT_SPP = 30  # one Renderer step at its 2,000,000-lane target
IO_FRAMES = 1          # 2 until slice 9


def instance_transforms(n):
    """The instances of ``[instance]`` (PERF.md section 4), each placing
    the unit-size blob centred at the origin on the box's floor (y = -0.8):
    n = 3, three at half size side by side, each turned about y; n = 16, a
    4 x 4 grid over the floor, instance i turned by 0.4 i about y and
    scaled non-uniformly."""
    from lumo_tpu_torch.scene.instance import rotate_y, scale, translation
    if n == 3:
        return [translation(x, -0.799 + 0.25, z) @ rotate_y(r)
                @ scale(0.5, 0.5, 0.5)
                for x, z, r in ((-0.55, -1.5, 0.3), (0.0, -1.2, 1.1),
                                (0.55, -1.5, 2.0))]
    out = []
    for i in range(n):
        sx, sy, sz = 0.26 + 0.03 * (i % 3), 0.2 + 0.05 * (i % 4), \
            0.3 - 0.03 * (i % 2)
        out.append(translation(-0.69 + 0.46 * (i % 4), -0.799 + 0.5 * sy,
                               -1.8 + 0.35 * (i // 4))
                   @ rotate_y(0.4 * i) @ scale(sx, sy, sz))
    return out


def instance_scene(dev, n, baked=False):
    """``bench_scene``'s blob (327,692 triangles, unit size, at the
    origin) registered once with ``Mesh.add_instances_to`` in the empty
    Cornell box under ``instance_transforms(n)``, materials cycling
    diffuse, metal (roughness 0.1) and glass; with ``baked`` each instance
    is baked with ``Mesh.add_to`` instead."""
    from lumo_tpu_torch.scene import shapes
    from lumo_tpu_torch.scene.cornell import empty_box
    from lumo_tpu_torch.scene.instance import Mesh
    from lumo_tpu_torch.scene.materials import Material
    sb = empty_box((0.95, 0.95, 0.95), Material.diffuse((0.9, 0.1, 0.1)),
                   Material.diffuse((0.1, 0.9, 0.1)))
    v, f, vn = shapes.blob(subdiv=7, seed=11, amp=0.22)
    mesh = Mesh(v, f, normals=vn).to_unit_size().to_origin()
    kinds = (Material.diffuse((0.8, 0.8, 0.3)),
             Material.metal((0.9, 0.7, 0.1), 0.1, 2.5, 3.0), Material.glass())
    mats = [kinds[i % 3] for i in range(n)]
    if baked:
        for m, mat in zip(instance_transforms(n), mats):
            mesh.clone().apply(m).add_to(sb, mat)
    else:
        mesh.add_instances_to(sb, instance_transforms(n), mats)
    return sb.build(device=dev)


def _instance_frames(name, scene, frame, n_inst):
    """A warm-up frame and INST_FRAMES timed ones (launch counts and peak
    memory reset just before each): rays/s, bounce iterations, K2
    launches a frame (n_inst a query per instance, 1 flattened), peak
    bytes, finiteness.  Returns the launches of a frame."""
    frame()
    walls, rays, per_frame, peaks = [], [], [], []
    for _ in range(INST_FRAMES):
        _reset_launches()
        torch.cuda.reset_peak_memory_stats()
        img, r, wall, bounces, _ = frame()
        per_frame.append(_launch_counts())
        peaks.append(torch.cuda.max_memory_allocated())
        if img.shape != (RES, RES, 3) or not np.isfinite(img).all():
            raise AssertionError(f"instance {name}: wrong shape or non-finite")
        walls.append(wall)
        rays.append(r)
    launches = per_frame[0]
    per_query = n_inst if n_inst < 5 else 1
    if any(f != launches for f in per_frame) or launches["k3_closest"] \
            or launches["k3_any"] or launches["k2_closest"] \
            != per_query * bounces or launches["k2_any"] <= 0 \
            or launches["k2_any"] % per_query:
        raise AssertionError(f"instance {name}: launches per frame "
                             f"{per_frame}, {bounces} bounces")
    rate = sorted(r / w for r, w in zip(rays, walls))
    log("instance", scene=name, res=f"{RES}x{RES}", spp=SPP,
        frames=INST_FRAMES, warmup_frames=1,
        wall_s=json.dumps(walls).replace(" ", ""), rays=int(rays[-1]),
        rays_per_s_median=float(np.median(rate)), rays_per_s_min=rate[0],
        rays_per_s_max=rate[-1], bounces=bounces,
        launches=json.dumps(launches).replace(" ", ""),
        k2_queries_per_closest=per_query, peak_bytes=max(peaks),
        image_mean=float(img.mean()), finite=True)
    return launches


def phase_instance(camera, dev):
    """Runtime instancing through K2: ``bench_scene``'s blob registered
    once and instanced 3 times (one K2 query per instance) and 16 times
    (one flattened query of 16 x 262,144 rays) in the empty box, through
    ``Renderer(scene, camera).integrator("path").samples(4).render()`` at
    256^2: build seconds, group records, instanced prims, rays/s,
    launches, peak memory; instance_16's idle share and the peak of one
    step at the Renderer's default target.  instance_3 also renders one
    1-spp frame through "direct" and through "bdpt" (depth 6).  At
    INST_PARITY_RES^2 (1 spp, fixed Russian-roulette threshold, square
    filter) each kernel-routed image equals the plain-routed one (rtol
    1e-5, atol 1e-6), and instance_3 equals its three instances baked
    (983,076 triangles through K2; rtol 2e-2, atol 2e-3), flips counted
    (at most 1%)."""
    from lumo_tpu_torch.camera import build_camera
    from lumo_tpu_torch.renderer import Renderer
    t_phase = time.perf_counter()
    small = build_camera(resolution=(INST_PARITY_RES, INST_PARITY_RES),
                         device=dev)
    small_frame = lambda s: integrator_frame(s, small, "path", 1, delta=1.0,
                                             square=True)
    launches = {}
    for n in (3, 16):
        name = f"instance_{n}"
        t0 = time.perf_counter()
        scene = instance_scene(dev, n)
        torch.cuda.synchronize()
        grp = scene.inst[0]
        log("instance", scene=name, build_s=round(time.perf_counter() - t0, 3),
            tris=scene.n_tris, instances=grp["minv"].shape[0],
            group_tris=grp["a"].shape[0], group_records=grp["bvh"]["nodes"]
            .shape[0], group_depth=grp["bvh"]["depth"],
            inst_prims=scene.n_inst_prims)
        frame = lambda: integrator_frame(scene, camera, "path", SPP)
        launches[name] = _instance_frames(name, scene, frame, n)
        img_k = _routed_parity("instance", name, "bvh",
                               lambda: small_frame(scene))
        if n == 3:
            for kind, conf in (("direct", None),
                               ("bdpt", lambda r: r.bdpt_depth(6))):
                _reset_launches()
                img, r, wall, _, _ = integrator_frame(scene, camera, kind, 1,
                                                      configure=conf)
                got = _launch_counts()
                if not np.isfinite(img).all() or got["k2_closest"] <= 0 \
                        or got["k2_any"] <= 0:
                    raise AssertionError(f"instance {kind}: {got}")
                log("instance", scene=name, integrator=kind, spp=1,
                    rays_per_s=r / wall, launches=json.dumps(got).replace(
                        " ", ""), finite=True)
            del scene
            t0 = time.perf_counter()
            baked = instance_scene(dev, n, baked=True)
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
            img_b = small_frame(baked)[0]
            flips, err = _image_parity(img_k, img_b, 2e-2, 2e-3)
            log("instance", case="instanced-vs-baked", scene=name,
                baked_tris=baked.n_bvh_tris, baked_build_s=round(build_s, 3),
                pixels=INST_PARITY_RES ** 2, flips=flips,
                image_max_abs_err=err, rtol=2e-2, atol=2e-3)
            if flips > INST_PARITY_RES ** 2 // 100:
                raise AssertionError("instance_3 and its baked twin disagree")
            del baked
        else:
            idle_share(f"instance-profile-{name}", lambda: frame()[2])
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            r = Renderer(scene, camera).samples(INST_DEFAULT_SPP)
            lanes = RES * RES * r._auto_batch()
            img = r.render(verbose=False)
            log("instance", case="default-step", scene=name, lanes=lanes,
                rays_per_query=lanes * n, spp=INST_DEFAULT_SPP,
                peak_bytes=torch.cuda.max_memory_allocated(),
                card_bytes=torch.cuda.get_device_properties(0).total_memory,
                wall_s=round(time.perf_counter() - t0, 3),
                finite=bool(np.isfinite(img).all()))
            del scene
    log("instance", phase_s=round(time.perf_counter() - t_phase, 1))
    return launches


def phase_io(camera, dev):
    """The committed asset ``scenes/demo.zip`` through
    ``io.obj.scene_from_zip`` (the port's own PNG decoder), built on the
    card (K2), rendered through ``Renderer(...).integrator("path")`` at
    256^2, 4 spp: decode and build seconds, rays/s, launches; the 64^2
    kernel-routed image against the plain-routed one, and the glow panel
    at the image's top brighter than the ground at its bottom
    (``tests/test_io.py``'s check)."""
    from lumo_tpu_torch.camera import build_camera
    from lumo_tpu_torch.io import obj as obj_io
    t_phase = time.perf_counter()
    with open(os.path.join(ROOT, "scenes", "demo.zip"), "rb") as f:
        data = f.read()
    t0 = time.perf_counter()
    sb = obj_io.scene_from_zip(data)
    decode_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    scene = sb.build(device=dev)
    torch.cuda.synchronize()
    log("io", scene="demo_zip", decode_s=round(decode_s, 3),
        build_s=round(time.perf_counter() - t0, 3), tris=scene.n_tris,
        lights=scene.n_lights, textures=len(sb.textures.images),
        normal_maps=scene.n_normal_maps)
    if scene.bvh is None or scene.n_tris <= 4000:
        raise AssertionError("demo_zip: expected a BVH scene")
    frame = lambda: integrator_frame(scene, camera, "path", SPP)
    launches = _timed_frames("io", "demo_zip", "bvh", frame, IO_FRAMES, RES)
    small = build_camera(resolution=(PARITY_RES, PARITY_RES), device=dev)
    _routed_parity("io", "demo_zip", "bvh", lambda: integrator_frame(
        scene, small, "path", 1, delta=1.0, square=True))
    img = frame()[0]
    rows = img.shape[0]       # tests/test_io.py's rows [:10] and [22:] of 32
    top = float(img[:rows * 10 // 32].mean())
    bottom = float(img[rows * 22 // 32:].mean())
    log("io", scene="demo_zip", top_mean=top, bottom_mean=bottom)
    if not (top > 5 * bottom and bottom > 1e-4):
        raise AssertionError("demo_zip: the glow panel is not at the top")
    log("io", phase_s=round(time.perf_counter() - t_phase, 1))
    return launches


# ---------------------------------------------------------------------------
# slice 8: the float64 reference mode and the quality harness

QUALITY_CORNELL = (64, 4)   # ``tools/quality.py``'s default configuration
QUALITY_BVH = (32, 2)       # its ``run_bvh()``


def _plain_f64_counts():
    from lumo_tpu_torch.accel import bvh_kernel, kd_kernel
    return {"k2_closest": bvh_kernel.PLAIN_F64["closest"],
            "k2_any": bvh_kernel.PLAIN_F64["any"],
            "k3_closest": kd_kernel.PLAIN_F64["closest"],
            "k3_any": kd_kernel.PLAIN_F64["any"]}


def _reset_plain_f64():
    from lumo_tpu_torch.accel import bvh_kernel, kd_kernel
    for table in (bvh_kernel.PLAIN_F64, kd_kernel.PLAIN_F64):
        for k in table:
            table[k] = 0


def quality_thresholds(name, out):
    """Every threshold of ``tests/test_quality_f64.py`` on one block of
    the harness's result (``grad_flipped_rays`` where it has it)."""
    rays = out["rays"]
    checks = {
        "bin_rel_err_mean < 1e-3": out["bin_rel_err_mean"] < 1e-3,
        "bin_rel_err_p999 < 5e-2": out["bin_rel_err_p999"] < 5e-2,
        "flipped_rays <= max(2, rays // 100)":
            out["flipped_rays"] <= max(2, rays // 100),
        "grad_ad_vs_fd_rel_err < 1e-6": out["grad_ad_vs_fd_rel_err"] < 1e-6,
        "grad_f32_vs_ref_rel_err < 1e-2":
            out["grad_f32_vs_ref_rel_err"] < 1e-2,
    }
    if "grad_flipped_rays" in out:
        checks["grad_flipped_rays <= rays // 5"] = \
            out["grad_flipped_rays"] <= rays // 5
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"quality {name}: {failed}")


def phase_quality(dev):
    """The quality harness (``lumo_tpu_torch/tools/quality.py``) on the
    card at ``tools/quality.py 64 4``'s configurations: the Cornell box
    (``run(64, 4)``, dense: no scene query at all) and the instanced,
    textured blob scene (``run_bvh(32, 2)``), float32 against the float64
    reference and float64 AD against finite differences.  Prints both
    results and their wall seconds, and raises unless every threshold of
    ``tests/test_quality_f64.py`` holds, the blob scene's two float32
    renders (forward, AD) launched K2 once an instance and bounce for
    their closest hits, and its six float64 renders (forward, AD, four
    finite-difference losses) launched no kernel and sent as many closest
    queries through the float64 plain route."""
    from lumo_tpu_torch.tools import quality
    t_phase = time.perf_counter()
    for name, run, conf in (("cornell", quality.run, QUALITY_CORNELL),
                            ("bvh", quality.run_bvh, QUALITY_BVH)):
        _reset_launches()
        _reset_plain_f64()
        t0 = time.perf_counter()
        out = run(*conf, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, plain = _launch_counts(), _plain_f64_counts()
        log("quality", harness=name, res=conf[0], spp=conf[1],
            wall_s=round(wall, 3),
            launches=json.dumps(launches).replace(" ", ""),
            plain_f64=json.dumps(plain).replace(" ", ""),
            result=json.dumps(out).replace(" ", ""))
        quality_thresholds(name, out)
        if name == "cornell":
            if any(launches.values()) or any(plain.values()):
                raise AssertionError(f"quality cornell: the dense box ran "
                                     f"queries {launches} {plain}")
            continue
        # one closest query an instance and bounce of each render
        per_render = 2 * quality.BVH_DEPTH * conf[1]
        if (launches["k2_closest"] != 2 * per_render or launches["k2_any"] <= 0
                or launches["k3_closest"] or launches["k3_any"]
                or plain["k2_closest"] != 6 * per_render
                or plain["k2_any"] <= 0 or plain["k3_closest"]
                or plain["k3_any"]):
            raise AssertionError(f"quality bvh: K2 launches {launches}, "
                                 f"float64 plain queries {plain}")
    log("quality", phase_s=round(time.perf_counter() - t_phase, 1))


# ---------------------------------------------------------------------------
# slice 9: rendering over several devices (torch.distributed)

DEV_WORLD = 2          # gloo ranks sharing the one card
DEV_CASES = ("path", "stream", "direct", "bdpt")
DEV_TIMEOUT_S = 300    # the longest wait for the ranks of one spawn
DEV_PSUM_REPS = 5      # timed all_reduces of a film after a warm-up
DEV_LABEL = "two processes on one card; not a multi-card scaling figure"


DEV_GO_TIMEOUT_S = 1200  # the longest a rank waits for its go file


def wait_for_go(go_file, parent):
    """Block until ``go_file`` exists; exit when the process ``parent``
    that started this one is gone, or after DEV_GO_TIMEOUT_S."""
    deadline = time.monotonic() + DEV_GO_TIMEOUT_S
    while not os.path.exists(go_file):
        if os.getppid() != parent or time.monotonic() > deadline:
            raise SystemExit(f"no go file {go_file}")
        time.sleep(0.05)


def _k2_query_sizes():
    """(context, sizes): inside the context every K2 query's ray count is
    appended to ``sizes["closest"]`` or ``sizes["any"]``."""
    from lumo_tpu_torch.accel import bvh_kernel
    sizes = {"closest": [], "any": []}
    stack = contextlib.ExitStack()
    for kind in sizes:
        real = getattr(bvh_kernel, f"{kind}_hit")

        def wrapped(bvh, tri, o, *args, _real=real, _kind=kind, **kwargs):
            sizes[_kind].append(int(o.shape[0]))
            return _real(bvh, tri, o, *args, **kwargs)

        stack.enter_context(mock.patch.object(bvh_kernel, f"{kind}_hit",
                                              wrapped))
    return stack, sizes


def devices_configure(case, n_dev):
    """The Renderer settings of a ``[devices]`` case over ``n_dev``
    devices.  The stream takes the fixed Russian-roulette threshold 1:
    its adaptive threshold follows each rank's own running stats while it
    runs (as the JAX package's does), so only at a fixed threshold is
    each sample's radiance the same however the samples are split."""
    def configure(r):
        r.devices(n_dev)
        if case == "stream":
            r.stream().fixed_rr_delta(1.0)
        elif case == "bdpt":
            r.bdpt_depth(BDPT_BENCH_DEPTH)
    return configure


def devices_frames(scene, camera, n_dev, cases=DEV_CASES):
    """Each of ``cases`` through ``Renderer(scene,
    camera)...devices(n_dev).render()``: image, rays (2 x sum of this
    process's path depths, not counted in the stream; the batch path
    after a warm-up frame), wall
    seconds, K2/K3 launches (counts set to 0 just before and read just
    after) and the ray count of every K2 query."""
    out = {}
    for case in cases:
        kind = "path" if case == "stream" else case
        frame = lambda: integrator_frame(
            scene, camera, kind, 1 if case == "bdpt" else SPP,
            configure=devices_configure(case, n_dev))
        if case == "path":
            frame()
        stack, sizes = _k2_query_sizes()
        _reset_launches()
        with stack:
            img, rays, wall, _, _ = frame()
        out[case] = {"image": img, "rays": rays, "wall": wall,
                     "launches": _launch_counts(), "sizes": sizes}
    return out


def devices_grads(scene, camera, block, mesh=None):
    """Gradients of mean(r^2) at fixed depth 2 over the lanes ``block``
    of the 262,144-lane first-bounce wavefront in every float leaf of the
    material table (``tests/test_parallel.py``'s loss), ``pmean``'d over
    ``mesh`` when given."""
    import dataclasses
    from lumo_tpu_torch.integrators import path_trace
    from lumo_tpu_torch.parallel import mesh as mesh_mod
    o, d, lam, rk = (x[block] for x in camera_wavefront(
        camera, camera.resolution[0], SPP, scene.device))
    mats = {k: v.detach().clone().requires_grad_(True)
            for k, v in scene.materials.items() if v.is_floating_point()}
    sc = dataclasses.replace(scene, materials={**scene.materials, **mats})
    r = path_trace.integrate(sc, o, d, lam, ray_key=rk, fixed_depth=2)[0]
    g = torch.autograd.grad(loss_r2(r, None, None), list(mats.values()),
                            allow_unused=True)
    grads = {k: torch.zeros_like(v) if gk is None else gk
             for (k, v), gk in zip(mats.items(), g)}
    return mesh_mod.pmean(grads, mesh) if mesh is not None else grads


def psum_ms(mesh, res, dev):
    """Mean ms of ``mesh.psum`` of a ``res``^2 film triplet, its stats and
    a ray count (the tree a step sums: one ``all_reduce`` of the float32
    leaves, one of the int64 count) over DEV_PSUM_REPS after a warm-up,
    and the bytes they carry."""
    from lumo_tpu_torch import film
    from lumo_tpu_torch.parallel import mesh as mesh_mod
    tree = (film.new_film((res, res), device=dev),
            {k: torch.zeros(res * res, device=dev)
             for k in ("f", "f2", "cost", "n")},
            torch.zeros((), dtype=torch.int64, device=dev))
    mesh_mod.psum(tree, mesh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(DEV_PSUM_REPS):
        mesh_mod.psum(tree, mesh)
    torch.cuda.synchronize()
    n = sum(x.numel() * x.element_size()
            for x in (*tree[0], *tree[1].values(), tree[2]))
    return (time.perf_counter() - t0) / DEV_PSUM_REPS * 1e3, n


def devices_rank(rank, world, init_url, out_dir, device, res, go_file=None,
                 parent=None):
    """One rank of ``[devices]``: (a) joins the gloo group on ``device``
    and builds the bench scene; with ``go_file``, waits for it (the parent
    starts the ranks early, so that this set-up overlaps its earlier
    phases, and writes the file when ``[devices]`` begins); then renders
    every case over the world, takes its block of the gradient and the
    ``pmean``, times a film's ``all_reduce``, and saves it all with its
    set-up and working seconds to ``out_dir/rank{rank}.pt``; then (c)
    :func:`nccl_refusal`."""
    from lumo_tpu_torch.camera import build_camera
    from lumo_tpu_torch.parallel import distributed
    from lumo_tpu_torch.parallel import mesh as mesh_mod
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    distributed.initialize(coordinator=init_url, num_processes=world,
                           process_id=rank, backend="gloo", device=device)
    try:
        dev = distributed.device()
        scene = bench_scene(dev)
        camera = build_camera(resolution=(res, res), device=dev)
        mesh = mesh_mod.make_mesh()
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        if go_file is not None:
            wait_for_go(go_file, parent)
        t1 = time.perf_counter()
        out = {"summary": distributed.process_summary(),
               "frames": devices_frames(scene, camera, world)}
        n = res * res * SPP
        out["grads"] = {k: v.cpu() for k, v in devices_grads(
            scene, camera, slice(rank * n // world, (rank + 1) * n // world),
            mesh).items()}
        out["psum_ms"], out["psum_bytes"] = psum_ms(mesh, res, dev)
        out["setup_s"] = setup_s
        out["wall_s"] = time.perf_counter() - t1
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        distributed.shutdown()
    nccl_refusal(rank, world, init_url + "-nccl", out_dir)


def start_devices_ranks(dev, res):
    """Start ``[devices]``' DEV_WORLD gloo ranks now; they set up and wait
    for the go file that :func:`phase_devices` writes.  Returns what
    phase_devices and :func:`stop_devices_ranks` take."""
    import tempfile
    from lumo_tpu_torch.parallel import distributed
    tmp = tempfile.TemporaryDirectory()
    rank_dev = (f"cuda:{torch.cuda.current_device()}" if dev.type == "cuda"
                else str(dev))
    go = os.path.join(tmp.name, "go")
    ctx = distributed.start_ranks(devices_rank, DEV_WORLD,
                                  (f"file://{tmp.name}/gloo", tmp.name,
                                   rank_dev, res, go, os.getpid()))
    log("devices", ranks_started=DEV_WORLD, backend="gloo",
        note=repr("setting up while the earlier phases run"))
    return {"ctx": ctx, "tmp": tmp, "go": go}


def stop_devices_ranks(ranks):
    """Stop ranks still running (a phase before ``[devices]`` failed) and
    remove their directory."""
    from lumo_tpu_torch.parallel import distributed
    if ranks is not None:
        distributed.stop_ranks(ranks["ctx"])
        ranks["tmp"].cleanup()


def nccl_refusal(rank, world, init_url, out_dir):
    """One of two NCCL ranks on the one card: the first collective is
    expected to fail (NCCL refuses two ranks on one GPU); saves the error
    it raised, or that none was raised, to ``out_dir/rank{rank}.txt``."""
    import torch.distributed as dist
    from lumo_tpu_torch.parallel import distributed
    distributed.initialize(coordinator=init_url, num_processes=world,
                           process_id=rank, backend="nccl", device="cuda:0")
    msg = "no error"
    try:
        x = torch.ones(1, device="cuda:0")
        try:
            dist.all_reduce(x)
            torch.cuda.synchronize()
        except dist.DistBackendError as e:     # the expected refusal
            msg = str(e)
        with open(os.path.join(out_dir, f"rank{rank}.txt"), "w") as f:
            f.write(msg)
    finally:
        distributed.shutdown()


def _devices_check(phase, case, got, want, rtol, atol):
    close = np.isclose(got, want, rtol=rtol, atol=atol)
    err = float(np.abs(got - want).max())
    log(phase, case=case, compare="two-ranks-vs-one-device",
        elements=close.size, outside=int((~close).sum()),
        max_abs_err=err, rtol=rtol, atol=atol)
    if not close.all():
        raise AssertionError(f"{phase} {case}: the two-rank result and the "
                             f"one-device result disagree")
    return err


def _check_rank_launches(case, rank, frame, one):
    """Every rank launched K2 closest and any, and each of its K2 queries
    took half the one-device query's rays."""
    launches, sizes = frame["launches"], frame["sizes"]
    halves = {k: sorted({s // DEV_WORLD for s in one["sizes"][k]})
              for k in sizes}
    if (launches["k2_closest"] <= 0 or launches["k2_any"] <= 0
            or {k: sorted(set(v)) for k, v in sizes.items()} != halves):
        raise AssertionError(f"devices {case} rank {rank}: launches "
                             f"{launches}, K2 query sizes "
                             f"{ {k: sorted(set(v)) for k, v in sizes.items()} }"
                             f" against the one-device halves {halves}")


def phase_devices(scene, camera, dev, refs, started):
    """Slice 9: rendering over several devices on torch.distributed.

    (a) DEV_WORLD gloo ranks on the one card (``initialize(...,
    backend="gloo", device="cuda:0")``, started by
    ``torch.multiprocessing`` before ``[parity-kd]``
    (:func:`start_devices_ranks`), each building the bench scene, waiting
    for the go file this phase writes, then rendering it at 256^2 through ``Renderer(...).devices(2)``: the path
    integrator at 4 spp in batch and in stream mode, the direct-light
    integrator and BDPT at depth 6 and 1 spp; then the gradient of
    mean(r^2) at fixed depth 2 over its half of the 262,144 first-bounce
    lanes, ``pmean``'d.  Held against the same renders and gradient on one
    device in this process (images rtol 1e-4, atol 1e-5; gradients rtol
    2e-4, atol 1e-6), both ranks' images bit-equal, every rank launching K2
    closest and any on every case with half the rays of each one-device
    query.  The one-device direct and BDPT frames are those of [direct]
    and [bdpt] (``refs``); the path and stream frames are rendered here.
    Per-ray radiance through K2 of the 262,144 lanes whole and as two
    halves: bit-equal.  (b) One NCCL rank: ``mesh.shard_step`` over the
    world of one rank (its ``all_reduce`` of CUDA tensors runs) equals
    ``shard_step`` over the groupless one-rank mesh, the Renderer's
    one-device step, bit for bit, both under torch's deterministic
    algorithms.  (c) The same two processes as (a), after leaving the gloo
    group, join an NCCL group on the one card: each rank's first
    collective fails with NCCL's "Duplicate GPU detected", which is
    checked.  Prints each rank's rays, wall seconds, launches and K2 query
    sizes, gloo's and NCCL's ms per film ``all_reduce``, and the batch
    path's two-process and one-process rays/s (``DEV_LABEL``)."""
    from lumo_tpu_torch import film as film_mod
    from lumo_tpu_torch.integrators import path_trace
    from lumo_tpu_torch.parallel import distributed
    from lumo_tpu_torch.parallel import mesh as mesh_mod
    import tempfile
    from lumo_tpu_torch.renderer import Renderer
    t_phase = time.perf_counter()
    res = camera.resolution[0]
    tmp = started["tmp"].name
    t0 = time.perf_counter()
    with open(started["go"], "w") as f:
        f.write("go")
    distributed.join_ranks(started["ctx"], DEV_TIMEOUT_S)
    wait_s = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
             for r in range(DEV_WORLD)]
    refusals = [open(os.path.join(tmp, f"rank{r}.txt")).read()
                for r in range(DEV_WORLD)]
    log("devices", ranks=DEV_WORLD, backend="gloo", wait_s=round(wait_s, 2),
        setup_s=json.dumps([round(out["setup_s"], 2) for out in ranks]),
        summary=repr(ranks[0]["summary"]))

    one = {**devices_frames(scene, camera, 1, ("path", "stream")), **refs}
    rays_of = lambda f: ("not counted" if case == "stream"
                         else int(f["rays"]))
    for case in DEV_CASES:
        for r, out in enumerate(ranks):
            f = out["frames"][case]
            log("devices", case=case, rank=r, rays=rays_of(f),
                wall_s=f["wall"],
                launches=json.dumps(f["launches"]).replace(" ", ""),
                k2_max_rays=json.dumps({k: max(v, default=0) for k, v in
                                        f["sizes"].items()}).replace(" ", ""))
            _check_rank_launches(case, r, f, one[case])
        f = one[case]
        log("devices", case=case, rank="one-device", rays=rays_of(f),
            wall_s=f["wall"],
            launches=json.dumps(f["launches"]).replace(" ", ""),
            k2_max_rays=json.dumps({k: max(v, default=0) for k, v in
                                    f["sizes"].items()}).replace(" ", ""))
        img = ranks[0]["frames"][case]["image"]
        if not all(np.array_equal(img, out["frames"][case]["image"])
                   for out in ranks[1:]):
            raise AssertionError(f"devices {case}: the ranks' images differ")
        if img.shape != (res, res, 3) or not np.isfinite(img).all():
            raise AssertionError(f"devices {case}: wrong shape or non-finite")
        _devices_check("devices", case, img, f["image"], 1e-4, 1e-5)
    for r, out in enumerate(ranks):
        log("devices", rank=r, rank_wall_s=out["wall_s"],
            gloo_psum_ms=out["psum_ms"], psum_bytes=out["psum_bytes"])

    two = [out["frames"]["path"] for out in ranks]
    log("devices", case="path", label=repr(DEV_LABEL),
        two_process_rays_per_s=sum(f["rays"] for f in two)
        / max(f["wall"] for f in two),
        one_process_rays_per_s=one["path"]["rays"] / one["path"]["wall"])

    n = res * res * SPP
    grads = devices_grads(scene, camera, slice(0, n))
    for k, g in grads.items():
        if not all(torch.equal(ranks[0]["grads"][k], out["grads"][k])
                   for out in ranks[1:]):
            raise AssertionError(f"devices grad {k}: the ranks differ")
        _devices_check("devices", f"grad-{k}", ranks[0]["grads"][k].numpy(),
                       g.cpu().numpy(), 2e-4, 1e-6)

    # per-ray radiance through K2: the wavefront whole and as two halves
    o, d, lam, rk = camera_wavefront(camera, res, SPP, dev)
    _reset_launches()
    whole = path_trace.integrate(scene, o, d, lam, ray_key=rk)[0]
    halves = torch.cat([path_trace.integrate(
        scene, o[s], d[s], lam[s], ray_key=rk[s])[0]
        for s in (slice(0, n // 2), slice(n // 2, n))])
    same = (whole == halves) | (torch.isnan(whole) & torch.isnan(halves))
    launches = _launch_counts()
    log("devices", case="per-ray-radiance", lanes=n,
        differing=int((~same).sum()),
        max_abs_err=float((whole - halves).abs().max()),
        launches=json.dumps(launches).replace(" ", ""))
    if not bool(same.all()) or launches["k2_closest"] <= 0:
        raise AssertionError("devices: per-ray radiance through K2 depends "
                             "on the split")

    # (b) one NCCL rank through shard_step.  The film's and stats'
    # index_add_ sum with atomics on the card, so two runs of one step
    # differ in the last bits (up to 2.4e-07, PERF.md) unless torch's
    # deterministic algorithms are on: both steps run with them
    r = Renderer(scene, camera).samples(SPP)
    spp_batch = r._auto_batch()
    work = r._make_work(spp_batch, SPP)
    n_rays = res * res * spp_batch
    film = film_mod.new_film((res, res), device=dev)
    stats = r.new_stats(res * res)
    one_rank = mesh_mod.shard_step(mesh_mod.make_mesh(1, dev), work, n_rays)
    with tempfile.TemporaryDirectory() as tmp:
        distributed.initialize(coordinator=f"file://{tmp}/nccl",
                               num_processes=1, process_id=0,
                               backend="nccl")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            mesh = mesh_mod.make_mesh()
            want = one_rank(film, stats, 0)
            _reset_launches()
            got = mesh_mod.shard_step(mesh, work, n_rays)(film, stats, 0)
            launches = _launch_counts()
            nccl_ms, _ = psum_ms(mesh, res, dev)
            backend = torch.distributed.get_backend()
        finally:
            torch.use_deterministic_algorithms(False)
            distributed.shutdown()
    equal = (all(torch.equal(a, b) for a, b in zip(got[0], want[0]))
             and all(torch.equal(got[1][k], want[1][k]) for k in want[1])
             and int(got[2]) == int(want[2]))
    log("devices", case="nccl-one-rank", backend=backend,
        group_size=mesh.size, bit_equal=equal, nccl_psum_ms=nccl_ms,
        launches=json.dumps(launches).replace(" ", ""))
    if (not equal or backend != "nccl" or mesh.group is None
            or launches["k2_closest"] <= 0):
        raise AssertionError("devices: the NCCL shard_step differs from "
                             "the one-device step")

    # (c) NCCL refuses two ranks on one card (run by the ranks of (a))
    line = next((ln for ln in refusals[0].splitlines()
                 if "Duplicate GPU" in ln), "")
    log("devices", case="nccl-two-ranks-one-card", refused=bool(line),
        message=repr(line.strip()[:200]))
    if not all("Duplicate GPU detected" in m for m in refusals):
        raise AssertionError(f"devices: NCCL did not refuse two ranks on "
                             f"one card: {[m[:300] for m in refusals]}")
    log("devices", phase_s=round(time.perf_counter() - t_phase, 1))


# ---------------------------------------------------------------------------
# slice 10: the user programs (``lumo_tpu_torch.examples``)

EX_RES = 512           # every program's default resolution
EX_SPP = 1             # cut from the programs' 64 to 2,048 spp
EX_PARITY_RES = 64
EX_KD = ("dragon", ("--accel", "kdtree"))    # once more, through K3
# the programs no earlier phase ran, held against their plain-routed images
EX_NEW = {"bunny": ("path", None),
          "bistro": ("bdpt", lambda r: r.tone_map("reinhard"))}


def run_program(name, argv):
    """``lumo_tpu_torch.examples.<name>.main(argv)``, the program as a
    user runs it, observed: (the path it returned, a dict with the
    Renderer its ``make`` built, ``make``'s seconds, ``render``'s wall
    seconds, the image handed to ``save_png`` and the rays: 2 x the
    summed path depths of every ``integrate``)."""
    import importlib
    from lumo_tpu_torch import film as film_mod
    from lumo_tpu_torch import renderer
    mod = importlib.import_module(f"lumo_tpu_torch.examples.{name}")
    seen = {"depths": []}
    real_make, real_render = mod.make, renderer.Renderer.render
    real_save = film_mod.save_png

    def make(args):
        t0 = time.perf_counter()
        r = real_make(args)
        torch.cuda.synchronize()
        seen.update(renderer=r, build_s=time.perf_counter() - t0)
        return r

    def render(self, verbose=True):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = real_render(self, verbose)    # ends with the image on the host
        seen["wall_s"] = time.perf_counter() - t0
        return img

    def save_png(img, path, *args, **kwargs):
        seen["image"] = img
        return real_save(img, path, *args, **kwargs)

    patches = [(mod, "make", make), (renderer.Renderer, "render", render),
               (film_mod, "save_png", save_png)]
    for integ in (renderer.path_trace, renderer.direct_light, renderer.bdpt):
        def integrate(*args, _real=integ.integrate, **kwargs):
            out = _real(*args, **kwargs)
            seen["depths"].append(out[-1].sum())
            return out
        patches.append((integ, "integrate", integrate))
    with contextlib.ExitStack() as stack:
        for obj, attr, fn in patches:
            stack.enter_context(mock.patch.object(obj, attr, fn))
        path = mod.main(list(argv))
    seen["rays"] = 2.0 * float(sum(seen["depths"]))
    return path, seen


def phase_examples(dev):
    """Slice 10: each of the 11 example programs (and dragon once more
    with ``--accel kdtree``) through its own ``main(["--res", "512",
    "--spp", "1", "--out", ...])`` in this process, as a user runs it:
    the PNG exists and the port's decoder reads it back as (512, 512, 3),
    not all black; the film was finite; the scene lay on the card; a BVH
    program launched K2 closest and any (a kd one K3, a dense one
    neither), the counts set to 0 just before each program and read just
    after.  Per program: build and frame seconds, rays/s, launches.
    Then at 64^2, 1 spp, fixed Russian-roulette threshold and the square
    filter: bunny's and the bistro stand-in's kernel-routed images
    against their plain-routed ones (rtol 1e-5, atol 1e-7, flips
    counted, at most 1%), and dragon's K3 image against its K2 image, both
    built by its ``make`` (rtol 1e-5, atol 1e-6)."""
    import tempfile
    from lumo_tpu_torch.examples import NAMES
    from lumo_tpu_torch.io import image
    t_phase = time.perf_counter()
    log("examples", card=repr(card_line()), res=f"{EX_RES}x{EX_RES}",
        spp=EX_SPP)
    on_cpu = ["--cpu"] if dev.type == "cpu" else []     # a CPU rehearsal
    with tempfile.TemporaryDirectory() as tmp:
        for name, extra in [(name, ()) for name in NAMES] + [EX_KD]:
            label = name + ("-kd" if extra else "")
            out = os.path.join(tmp, f"{label}.png")
            _reset_launches()
            path, seen = run_program(name, ["--res", str(EX_RES), "--spp",
                                            str(EX_SPP), "--out", out,
                                            *extra, *on_cpu])
            launches = _launch_counts()
            r = seen["renderer"]
            scene = r.scene
            with open(path, "rb") as f:
                png = image.decode_png(f.read())
            accel = ("kdtree" if scene.kdtree is not None else
                     "bvh" if scene.bvh is not None else "dense")
            k2 = (launches["k2_closest"] > 0, launches["k2_any"] > 0)
            k3 = (launches["k3_closest"] > 0, launches["k3_any"] > 0)
            want = {"bvh": ((True, True), (False, False)),
                    "kdtree": ((False, False), (True, True)),
                    "dense": ((False, False), (False, False))}[accel]
            log("examples", program=label, integrator=r._integrator,
                accel=accel, tris=scene.n_tris, spheres=scene.n_spheres,
                analytics=scene.n_analytic, device=str(scene.device),
                build_s=round(seen["build_s"], 3), wall_s=seen["wall_s"],
                rays=int(seen["rays"]),
                rays_per_s=seen["rays"] / seen["wall_s"],
                launches=json.dumps(launches).replace(" ", ""),
                image_mean=float(seen["image"].mean()),
                png_mean=float(png.mean()), black=not png.any())
            faults = [what for what, bad in (
                ("png", path != out or png.shape != (EX_RES, EX_RES, 3)),
                # the JAX program renders the bistro stand-in black too
                ("black png", not png.any() and name != "bistro"),
                ("non-finite film", not np.isfinite(seen["image"]).all()),
                ("not on the card", scene.device.type != dev.type),
                ("launches", (k2, k3) != want)) if bad]
            if faults:
                raise AssertionError(f"examples {label}: {faults}, "
                                     f"launches {launches}")

    for name, (kind, configure) in EX_NEW.items():
        scene, make_camera, illum = example_scene(name, dev, "bvh")
        if scene.bvh is None:
            raise AssertionError(f"examples {name}: no BVH, so no K2")
        small = make_camera(EX_PARITY_RES)
        runs = []     # per-lane depths: kernel-routed, then plain-routed

        def frame():
            runs.append([])
            return integrator_frame(scene, small, kind, 1, illum, delta=1.0,
                                    square=True, configure=configure,
                                    lanes=runs[-1])
        img = _routed_parity("examples", name, "bvh", frame, rtol=1e-5,
                             atol=1e-7)
        # each lane's depth follows every hit of its path(s), and holds
        # where the image is black (the bistro stand-in, as the JAX
        # program renders it: its environment sphere is a one-sided light
        # seen from inside)
        d_k, d_p = (torch.cat(r).cpu().numpy() for r in runs)
        differ = int((d_k != d_p).sum())
        log("examples", case="kernel-vs-plain-depths", scene=name,
            lanes=d_k.size, differing=differ, mean_depth=float(d_k.mean()),
            black_image=not img.any())
        if differ > d_k.size // 100:
            raise AssertionError(f"examples {name}: the kernel- and "
                                 f"plain-routed paths differ")
        del scene
    images = {}
    for accel in ("bvh", "kdtree"):
        scene, make_camera, illum = example_scene("dragon", dev, accel)
        images[accel] = integrator_frame(scene, make_camera(EX_PARITY_RES),
                                         "path", 1, illum, delta=1.0,
                                         square=True)[0]
    flips, err = _image_parity(images["kdtree"], images["bvh"], 1e-5, 1e-6)
    n_pix = EX_PARITY_RES ** 2
    log("examples", case="kd-vs-bvh", scene="dragon",
        res=f"{EX_PARITY_RES}x{EX_PARITY_RES}", pixels=n_pix, flips=flips,
        image_max_abs_err=err, rtol=1e-5, atol=1e-6)
    if flips > n_pix // 100:
        raise AssertionError("examples: dragon's K3 and K2 renders disagree")
    log("examples", phase_s=round(time.perf_counter() - t_phase, 1))


# ---------------------------------------------------------------------------
# slice 11: the driver's entry points (``lumo_tpu_torch.graft_entry``) and
# the spectral-uplift table fit

GRAFT_WORLD = 2         # gloo ranks sharing the card
GRAFT_RES = 8           # the JAX package's dryrun resolution
GRAFT_TRAIN_RES = 256   # the training step once more: 65,536 rays a step
FIT_RES = 64            # the shipped table's nodes an axis
FIT_RGB_ATOL = 1e-6     # the fitted table against the shipped one


def _k2_both(launches):
    return launches["closest"] > 0 and launches["any"] > 0


def _fit_rgb(coeffs):
    """The linear sRGB each coefficient row reproduces, in float64."""
    from lumo_tpu_torch.color import uplift
    A, xs = uplift._fit_basis()
    poly = coeffs.astype(np.float64) @ np.stack([xs * xs, xs,
                                                  np.ones_like(xs)])
    return (0.5 + poly / (2.0 * np.sqrt(1.0 + poly * poly))) @ A.T


def _graft_check(case, pairs, rtol, atol):
    """The ranks' tensors against one device's, (got, want) pairs on the
    host: one line with the elements, those outside the tolerance and the
    largest difference; raises if any lies outside."""
    got = np.concatenate([g.numpy().ravel() for g, _ in pairs])
    want = np.concatenate([w.numpy().ravel() for _, w in pairs])
    _devices_check("graft", case, got, want, rtol, atol)


def phase_graft(dev):
    """Slice 11: the driver's entry points.

    (a) ``graft_entry.entry()`` on the card: radiance (64, 4), finite.
    (b) ``graft_entry.dryrun_multichip(2)`` at the JAX dryrun's 8^2: two
    gloo ranks sharing the card (``rank_layout``), each building the rich
    scene (1,282 triangles through K2, a disk light), taking its block of
    the training step (render, loss, gradients of the float material
    tables, ``pmean``, SGD), the ``psum``'d BDPT film and the scaling
    protocol.  Held: each rank launched K2 closest and any in the
    forward and none in the backward; the ranks agree bit for bit (checked
    by the dryrun); their gradients and update are within the
    ``[devices]`` tolerances (rtol 2e-4, atol 1e-6) of the mean of the
    same two blocks taken on one device here, and their film within rtol
    1e-4, atol 1e-5 of one device's.  (c) The training step once more on
    one device at 256^2 (65,536 rays): fwd+bwd wall, K2 launches (counts
    set to 0 just before, read just after: closest and any in the
    forward, none in the backward), peak ``max_memory_allocated`` and
    the device's idle share over one more step.
    (d) ``uplift.fit_table(64)`` on the card against the shipped
    ``uplift_srgb_64.npz``: the largest coefficient difference, the
    largest difference of the RGB each entry reproduces (at most
    FIT_RGB_ATOL), the entries whose coefficients differ by more than
    1e-5 of their largest (at most 1%), and the seconds."""
    from lumo_tpu_torch import graft_entry as ge
    from lumo_tpu_torch.color import uplift
    from lumo_tpu_torch.parallel import mesh as mesh_mod
    t_phase = time.perf_counter()
    log("graft", card=repr(card_line()))

    # (a) the forward entry step
    fn, args = ge.entry(dev)
    _reset_launches()
    out = fn(*args)
    torch.cuda.synchronize()
    log("graft", case="entry", shape=tuple(out.shape),
        finite=bool(torch.isfinite(out).all()), radiance_sum=float(out.sum()),
        launches=json.dumps(_launch_counts()).replace(" ", ""))
    if out.shape != (ge.ENTRY_RAYS, 4) or not bool(torch.isfinite(out).all()):
        raise AssertionError("graft: entry() gave a wrong shape or "
                             "non-finite radiance")

    # (b) the dryrun over two ranks sharing the card
    t0 = time.perf_counter()
    dry = ge.dryrun_multichip(GRAFT_WORLD, device=dev, res=GRAFT_RES)
    dry_s = time.perf_counter() - t0
    log("graft", case="dryrun", ranks=GRAFT_WORLD, backend=dry["backend"],
        devices=json.dumps(dry["devices"]).replace(" ", ""),
        wall_s=dry_s, loss=dry["loss"],
        params_l1=dry["params_l1"], bdpt_film_l1=dry["bdpt_film_l1"],
        scaling_rays_per_s_per_device=json.dumps(dry["scaling"]).replace(
            " ", ""), label=repr(DEV_LABEL))
    for out in dry["ranks"]:
        log("graft", case="dryrun", rank=out["rank"], device=out["device"],
            tris=out["n_tris"],
            k2_launches=json.dumps(out["launches"]).replace(" ", ""))
        if (not _k2_both(out["launches"]["fwd"])
                or sum(out["launches"]["bwd"].values()) != 0):
            raise AssertionError(f"graft: rank {out['rank']}'s K2 launches "
                                 f"{out['launches']}: want closest and any "
                                 f"in the forward, none in the backward")
    scene, camera = ge.rich_scene_camera(GRAFT_RES, dev)
    mats = ge.float_tables(scene)
    n_pix = GRAFT_RES * GRAFT_RES
    blocks = []
    for rank in range(GRAFT_WORLD):
        ids = torch.arange(rank * n_pix // GRAFT_WORLD,
                           (rank + 1) * n_pix // GRAFT_WORLD, device=dev)
        lam = ge.train_wavelengths(rank, ids.shape[0], dev)
        blocks.append(ge.loss_and_grads(scene, camera, mats, ids, lam, ids))
    got = dry["ranks"][0]
    want = {k: sum(b[1][k] for b in blocks).cpu() / GRAFT_WORLD for k in mats}
    _graft_check("grads", [(got["grads"][k], want[k]) for k in mats],
                 2e-4, 1e-6)
    _graft_check("sgd-update", [(got["new_mats"][k],
                                 mats[k].cpu() - ge.LR * want[k])
                                for k in mats], 2e-4, 1e-6)
    one = ge.bdpt_film(mesh_mod.make_mesh(1, dev), scene, camera)
    _graft_check("bdpt-film", [(a, b.cpu()) for a, b in zip(got["film"], one)],
                 1e-4, 1e-5)

    # (c) the training step at 256^2 on one device
    scene, camera = ge.rich_scene_camera(GRAFT_TRAIN_RES, dev)
    mats = ge.float_tables(scene)
    mesh = mesh_mod.make_mesh(1, dev)
    ge.train_step(mesh, scene, camera, mats)                    # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    launches = {}
    _reset_launches()
    t0 = time.perf_counter()
    loss, new, grads = ge.train_step(mesh, scene, camera, mats,
                                     launches=launches)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counted = _launch_counts()
    finite = all(bool(torch.isfinite(g).all()) for g in grads.values())
    lanes = GRAFT_TRAIN_RES * GRAFT_TRAIN_RES
    log("graft", case="train-step", res=f"{GRAFT_TRAIN_RES}x{GRAFT_TRAIN_RES}",
        lanes=lanes, depth=ge.LOSS_DEPTH, fwd_bwd_wall_s=wall,
        lanes_per_s=lanes / wall, loss=float(loss),
        params_l1=ge.l1(new.values()), grads_finite=finite,
        k2_launches=json.dumps(launches).replace(" ", ""),
        launches=json.dumps(counted).replace(" ", ""),
        peak_bytes=torch.cuda.max_memory_allocated(),
        allocated_before_bytes=base)
    if (not finite or not _k2_both(launches["fwd"])
            or sum(launches["bwd"].values()) != 0
            or counted["k2_closest"] != launches["fwd"]["closest"]):
        raise AssertionError(f"graft: the 256^2 training step: finite "
                             f"{finite}, K2 launches {launches}")

    def step():
        t = time.perf_counter()
        ge.train_step(mesh, scene, camera, mats)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    idle_share("graft", step)
    del scene, camera, mats, new, grads

    # (d) the uplift table fitted on the card against the shipped one
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fit = uplift.fit_table(FIT_RES, dev)
    fit_s = time.perf_counter() - t0
    with np.load(uplift._DATA) as d:
        shipped = {k: d[k] for k in ("coeffs", "scale")}
    diff = np.abs(fit["coeffs"] - shipped["coeffs"])
    scale = np.abs(shipped["coeffs"]).max(axis=-1, keepdims=True)
    differ = int((diff > 1e-5 * scale).any(axis=-1).sum())
    rgb_err = float(np.abs(_fit_rgb(fit["coeffs"])
                           - _fit_rgb(shipped["coeffs"])).max())
    log("graft", case="uplift-fit", res=FIT_RES, seconds=fit_s,
        entries=diff.size // 3, max_coeff_abs_diff=float(diff.max()),
        entries_coeffs_differ=differ, max_rgb_abs_diff=rgb_err,
        rgb_atol=FIT_RGB_ATOL,
        scale_equal=bool(np.array_equal(fit["scale"], shipped["scale"])))
    if (rgb_err > FIT_RGB_ATOL or differ > diff.size // 3 // 100
            or not np.allclose(fit["scale"], shipped["scale"])):
        raise AssertionError("graft: the table fitted on the card and the "
                             "shipped table disagree")
    log("graft", phase_s=round(time.perf_counter() - t_phase, 1))


# ---------------------------------------------------------------------------
# slice 12: the benchmark entry (python -m lumo_tpu_torch.bench)

BENCH_SPP = 2           # cut from bench.py's 64 spp for the script's time
BENCH_TIMEOUT_S = 600   # the longest the entry may take at BENCH_SPP
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "extra"}


def _bench_launches(extra):
    """(name, query, launches) of every kernel query the entry's subs
    report: K2 in bvh (stream, fwd+bwd), smoke and quality, K3 in smoke's
    kd scene."""
    bvh, smoke = extra["bvh"]["k2_launches"], extra["smoke"]
    rows = [(f"bvh-{part}", q, bvh[part][q]) for part in ("stream", "fwd_bwd")
            for q in ("closest", "any")]
    rows += [("smoke-bvh", q, smoke["bvh"]["launches"][q])
             for q in ("closest", "any")]
    rows += [("smoke-bvh_large", "closest",
              smoke["bvh_large"]["launches"]["closest"]),
             ("smoke-kd", "closest", smoke["kd"]["launches"]["closest"])]
    rows += [("quality", q, extra["quality"]["k2_launches"][q])
             for q in ("closest", "any")]
    return rows


def phase_bench():
    """``python -m lumo_tpu_torch.bench --spp 2`` as a user runs it, in a
    subprocess from the checkout's root: every sub at bench.py's sizes but
    for the samples per pixel, the smoke gate whole (its 5,242,880-triangle
    K2 query and every query's check against the plain walk).  Checks exit
    code 0, bench.py's keys in the last line, no sub with an error, smoke
    ok, and K2 (K3) launches in every sub that uses them."""
    from lumo_tpu_torch import bench
    t_phase = time.perf_counter()
    p = subprocess.run([sys.executable, "-m", "lumo_tpu_torch.bench",
                        "--spp", str(BENCH_SPP)], cwd=ROOT,
                       capture_output=True, text=True,
                       timeout=BENCH_TIMEOUT_S)
    if p.returncode != 0:
        raise AssertionError(f"bench: exit code {p.returncode}: "
                             + p.stderr[-2000:] + p.stdout[-2000:])
    line = json.loads(p.stdout.strip().splitlines()[-1])
    if set(line) != BENCH_KEYS or line["metric"] != bench.METRIC:
        raise AssertionError(f"bench: not bench.py's schema: {sorted(line)}")
    extra = line["extra"]
    if bench.failed(line):
        raise AssertionError(f"bench: failed subs {bench.failed(line)}")
    smoke = extra["smoke"]
    log("bench", cmd=repr(f"python -m lumo_tpu_torch.bench --spp {BENCH_SPP}"),
        card=repr(extra["card"]), res=extra["res"], spp=extra["spp"],
        value=line["value"], vs_baseline=line["vs_baseline"],
        fwd_only=extra["fwd_only"]["rays_per_s"],
        fwd_only_mode=extra["fwd_only"]["mode"],
        peak_bytes=extra["peak_bytes"],
        bvh_fwd=extra["bvh"]["bvh_scene_fwd_rays_per_sec"],
        bvh_fwd_bwd=extra["bvh"]["bvh_scene_fwd_bwd_rays_per_sec"],
        bdpt=extra["bdpt"]["bdpt_cornell_rays_per_sec"],
        bdpt_peak_bytes=extra["bdpt"]["peak_bytes"],
        sub_s=json.dumps({k: round(extra[k]["sub_s"], 1)
                          for k in bench.SUBS}).replace(" ", ""))
    for name in ("bvh", "bvh_large", "kd"):
        rec = smoke[name]
        log("bench", case=f"smoke-{name}", tris=rec["tris"], rays=rec["rays"],
            hits=rec["hits"], closest_s=rec["closest_s"],
            blocks=json.dumps(rec["blocks"]).replace(" ", ""),
            checked=rec["vs_plain_walk"]["rays"],
            checked_hits=rec["vs_plain_walk"]["hits"],
            vs_plain_walk="prims equal, t bit-equal",
            total_s=rec["total_s"])
    rows = _bench_launches(extra)
    log("bench", launches=json.dumps(
        {f"{n}-{q}": k for n, q, k in rows}).replace(" ", ""))
    if min(k for _, _, k in rows) <= 0:
        raise AssertionError(f"bench: a kernel was not launched: {rows}")
    log("bench", wall_s=extra["wall_s"],
        phase_s=round(time.perf_counter() - t_phase, 1))


# ---------------------------------------------------------------------------
# slice 13: forward-mode derivatives (torch.autograd.forward_ad)

JVP_TANGENT = (0.3, -0.2, 0.5)  # the tangent of the camera origin c2w_t
JVP_DEPTH = GRAD_DEPTH          # the fixed-depth renders' bounces
JVP_CHECK = 2048       # lanes traced again on the plain route, half on blob
JVP_RTOL, JVP_ATOL_REL = GRAD_RTOL, GRAD_ATOL_REL
# jvp(v) against <grad L, v>: the loss's float32 sums over 65,536 lanes in
# two orders
JVP_IDENTITY_RTOL = 1e-3
JVP_CKPT_RES = PARITY_RES
DIAG = (64, 4)                 # tools/diag_grad.py's default res and spp
# diag_grad's float32 net tangent against float64, over the sum of |terms|
DIAG_REL_ERR_GROSS = 1e-3


def jvp_render(scene, camera, depth, sub=None, res=None, checkpoint=False):
    """One forward-mode render of sample 1 at res^2 (:func:`grad_rays`)
    with the tangent JVP_TANGENT on ``c2w_t``: ``depth`` bounces, or
    Russian roulette with ``depth`` None; ``sub`` (lane ids) traces those
    lanes only.  No reverse graph is kept unless ``checkpoint`` (whose
    checkpointed bounce runs only with grad enabled).  Returns the
    radiance and its tangent, the loss mean(r^2) and its tangent, the
    per-bounce prims, wall seconds, peak bytes above those allocated
    before, and the K2/K3 launches of the render."""
    import dataclasses

    from torch.autograd import forward_ad

    from lumo_tpu_torch.integrators import path_trace
    dev, res = scene.device, res or RES
    _reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    with torch.set_grad_enabled(checkpoint), forward_ad.dual_level():
        cam = dataclasses.replace(camera, c2w_t=forward_ad.make_dual(
            camera.c2w_t, torch.tensor(JVP_TANGENT, device=dev)))
        o, d, lam, rk = grad_rays(cam, res, 1, dev)
        if sub is not None:
            o, d, lam, rk = (x[sub] for x in (o, d, lam, rk))
        r, lam_out, _, prims = path_trace.integrate(
            scene, o, d, lam, ray_key=rk, fixed_depth=depth,
            trace_prims=True, checkpoint=checkpoint)
        loss = forward_ad.unpack_dual(loss_r2(r, lam_out))
        r = forward_ad.unpack_dual(r)
        out = {"r": r.primal.detach(), "r_tan": r.tangent.detach(),
               "loss": float(loss.primal), "loss_tan": float(loss.tangent),
               "prims": prims}
    torch.cuda.synchronize()
    out["wall"] = time.perf_counter() - t0
    out["peak_bytes"] = torch.cuda.max_memory_allocated() - base
    out["launches"] = _launch_counts()
    return out


def vjp_render(scene, camera, depth):
    """The same loss as :func:`jvp_render` at full width by reverse mode:
    (loss, <grad L, JVP_TANGENT>, wall seconds, peak bytes above those
    allocated before)."""
    import dataclasses

    from lumo_tpu_torch.integrators import path_trace
    dev = scene.device
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    c2w_t = camera.c2w_t.detach().clone().requires_grad_(True)
    o, d, lam, rk = grad_rays(dataclasses.replace(camera, c2w_t=c2w_t), RES,
                              1, dev)
    r, lam_out, _ = path_trace.integrate(scene, o, d, lam, ray_key=rk,
                                         fixed_depth=depth)
    loss = loss_r2(r, lam_out)
    loss.backward()
    loss = loss.detach()
    v = torch.tensor(JVP_TANGENT, device=dev)
    dot = float((c2w_t.grad * v).sum())
    torch.cuda.synchronize()
    return (float(loss), dot, time.perf_counter() - t0,
            torch.cuda.max_memory_allocated() - base)


def _check_lanes(scene, full):
    """JVP_CHECK lane ids of a full-width render, half whose first bounce
    hit the blob (the scene's last material, its metal), half others,
    drawn with a fixed seed."""
    first = full["prims"][0].cpu()
    mat = scene.tri_mat.cpu()
    on_blob = (first >= 0) & (first < mat.shape[0])
    on_blob &= mat[first.clamp(0, mat.shape[0] - 1)] == int(mat.max())
    g = torch.Generator().manual_seed(13)
    pick = lambda ids, n: ids[torch.randperm(ids.numel(), generator=g)[:n]]
    ids = torch.cat([pick(on_blob.nonzero()[:, 0], JVP_CHECK // 2),
                     pick((~on_blob).nonzero()[:, 0], JVP_CHECK // 2)])
    return ids.to(scene.device), int(on_blob.sum())


def _padded(prims, n):
    """Per-bounce prims (bounces, lanes) padded with -1 to n bounces."""
    pad = torch.full((n - prims.shape[0], prims.shape[1]), -1,
                     dtype=prims.dtype, device=prims.device)
    return torch.cat([prims, pad])


def jvp_route_check(phase, scene, camera, full, depth, accel):
    """The lanes of :func:`_check_lanes` through the plain route against
    the kernel's full-width render: lanes whose per-bounce prims differ
    are counted and left out, the rest's radiance tangents within
    (JVP_RTOL, JVP_ATOL_REL x the largest).  Returns (flips, max error
    relative to that entry, lanes checked, blob lanes of the frame, plain
    wall seconds)."""
    sub, blob_lanes = _check_lanes(scene, full)
    with _plain_routed(accel):
        plain = jvp_render(scene, camera, depth, sub=sub)
    pk, pp = full["prims"][:, sub], plain["prims"]
    n = max(pk.shape[0], pp.shape[0])
    same = (_padded(pk, n) == _padded(pp, n)).all(dim=0)
    got, want = full["r_tan"][sub][same], plain["r_tan"][same]
    scale = max(float(want.abs().max()), 1e-30)
    err = float((got - want).abs().max()) / scale
    if not (torch.allclose(got, want, rtol=JVP_RTOL,
                           atol=JVP_ATOL_REL * scale)
            and torch.allclose(full["r"][sub][same], plain["r"][same],
                               rtol=1e-5, atol=1e-7)):
        raise AssertionError(f"{phase}: the kernel's tangents disagree with "
                             f"the plain route's (max error {err} of the "
                             "largest entry)")
    flips = int((~same).sum())
    if flips > sub.numel() // 100 or scale == 0.0:
        raise AssertionError(f"{phase}: {flips} flips of {sub.numel()} "
                             f"lanes, largest tangent {scale}")
    return flips, err, sub.numel(), blob_lanes, plain["wall"]


def jvp_twin_check(phase, got, want):
    """Two full-width frames of the same rays through two kernels: lanes
    whose per-bounce hit pattern differs are counted (at most 1%) and left
    out, the rest's radiance tangents within (JVP_RTOL, JVP_ATOL_REL x the
    largest).  Returns (flips, max error relative to that entry, lanes)."""
    n = max(got["prims"].shape[0], want["prims"].shape[0])
    same = ((_padded(got["prims"], n) >= 0)
            == (_padded(want["prims"], n) >= 0)).all(dim=0)
    a, b = got["r_tan"][same], want["r_tan"][same]
    scale = max(float(b.abs().max()), 1e-30)
    err = float((a - b).abs().max()) / scale
    flips = int((~same).sum())
    if (flips > same.numel() // 100
            or not torch.allclose(a, b, rtol=JVP_RTOL,
                                  atol=JVP_ATOL_REL * scale)):
        raise AssertionError(f"{phase}: {flips} flips, max error {err} of "
                             "the largest entry against the other kernel")
    return flips, err, same.numel()


def phase_jvp(scene, scene_kd, camera, dev):
    """Forward-mode derivatives on the card: (a) the 327,692-triangle
    scene at 256^2 (one sample, 65,536 lanes) with a tangent on the camera
    origin through K2 at fixed depth and with Russian roulette, and through
    K3 on the kd-built scene, each held on JVP_CHECK lanes against the
    plain route (K3's Russian-roulette frame against K2's whole frame),
    K2's fixed-depth loss tangent against reverse mode's <grad L, v>, with
    the wall and peak bytes of both; (b)
    ``tools/diag_grad.py``'s diagnosis (``lumo_tpu_torch.tools.diag_grad``)
    at its own size, float32 and float64; (c) ``checkpoint=True`` against
    ``False`` under forward mode.  The launches of each render are counted
    from 0 and must be one closest and one any query a bounce."""
    from lumo_tpu_torch.tools import diag_grad
    t_phase = time.perf_counter()
    tag = {"bvh": "k2", "kdtree": "k3"}
    k2_rr = None
    for accel, sc in (("bvh", scene), ("kdtree", scene_kd)):
        jvp_render(sc, camera, JVP_DEPTH)                       # warm-up
        for mode, depth in (("fixed", JVP_DEPTH), ("rr", None)):
            full = jvp_render(sc, camera, depth)
            phase = f"jvp-{tag[accel]}-{mode}"
            bounces = full["prims"].shape[0]
            mine = {k: v for k, v in full["launches"].items()
                    if k.startswith(tag[accel])}
            if (set(mine.values()) != {bounces}
                    or sum(full["launches"].values()) != 2 * bounces):
                raise AssertionError(f"{phase}: launches {full['launches']} "
                                     f"for {bounces} bounces")
            if not (bool(torch.isfinite(full["r_tan"]).all())
                    and float(full["r_tan"].abs().max()) > 0.0):
                raise AssertionError(f"{phase}: tangents zero or not finite")
            extra = {}
            if accel == "kdtree" and mode == "rr":
                # K3 gives K2's t bit for bit on the same rays ([grad-kd]),
                # and the plain kd walk through the whole Russian-roulette
                # tail costs about 26 s: held against K2's frame instead
                flips, err, lanes = jvp_twin_check(phase, full, k2_rr)
                extra = dict(checked_against="k2-rr")
            else:
                flips, err, lanes, blob, plain_s = jvp_route_check(
                    phase, sc, camera, full, depth, accel)
                extra = dict(checked_against="plain", blob_lanes_of_frame=blob,
                             plain_s=round(plain_s, 2))
            if accel == "bvh" and mode == "rr":
                k2_rr = full
            if accel == "bvh" and mode == "fixed":
                loss, dot, wall_r, peak_r = vjp_render(sc, camera, depth)
                rel = abs(full["loss_tan"] - dot) / max(abs(dot), 1e-30)
                if rel > JVP_IDENTITY_RTOL or dot == 0.0:
                    raise AssertionError(f"{phase}: jvp {full['loss_tan']} "
                                         f"against <grad L, v> {dot}")
                extra.update(vjp_dot=dot, jvp_vs_vjp_rel_err=rel,
                             identity_rtol=JVP_IDENTITY_RTOL,
                             reverse_wall_s=wall_r, reverse_peak_bytes=peak_r,
                             reverse_loss=loss)
            log(phase, res=f"{RES}x{RES}", spp=1, lanes=RES * RES,
                depth=depth if depth else "rr", bounces=bounces,
                tangent=json.dumps(JVP_TANGENT).replace(" ", ""),
                launches=json.dumps(full["launches"]).replace(" ", ""),
                wall_s=full["wall"], peak_bytes=full["peak_bytes"],
                loss=full["loss"], loss_tangent=full["loss_tan"],
                checked_lanes=lanes, flips=flips, max_rel_err=err,
                rtol=JVP_RTOL, atol_rel=JVP_ATOL_REL, **extra)

    # (b) tools/diag_grad.py at its own size
    t0 = time.perf_counter()
    _reset_launches()
    diag = diag_grad.main(*DIAG, device=dev)
    log("jvp-diag-grad", res=DIAG[0], spp=DIAG[1],
        wall_s=round(time.perf_counter() - t0, 3),
        launches=json.dumps(_launch_counts()).replace(" ", ""),
        result=json.dumps(diag).replace(" ", ""))
    if not (all(np.isfinite(v) for v in diag.values())
            and diag["cancellation"] >= 1.0
            and diag["rel_err_gross"] <= DIAG_REL_ERR_GROSS):
        raise AssertionError(f"jvp-diag-grad: {diag}")

    # (c) the checkpointed bounce under forward mode
    from lumo_tpu_torch.camera import build_camera
    cam = build_camera(resolution=(JVP_CKPT_RES, JVP_CKPT_RES), device=dev)
    runs = {c: jvp_render(scene, cam, JVP_DEPTH, res=JVP_CKPT_RES,
                          checkpoint=c) for c in (False, True)}
    off, on = runs[False], runs[True]
    equal = torch.equal(on["r_tan"], off["r_tan"])
    scale = max(float(off["r_tan"].abs().max()), 1e-30)
    err = float((on["r_tan"] - off["r_tan"]).abs().max()) / scale
    log("jvp-checkpoint", res=f"{JVP_CKPT_RES}x{JVP_CKPT_RES}", spp=1,
        depth=JVP_DEPTH, bit_equal=equal, max_rel_err=err,
        launches_on=json.dumps(on["launches"]).replace(" ", ""),
        launches_off=json.dumps(off["launches"]).replace(" ", ""),
        wall_s_on=on["wall"], wall_s_off=off["wall"],
        peak_bytes_on=on["peak_bytes"], peak_bytes_off=off["peak_bytes"])
    if (err > GRAD_ATOL_REL or on["launches"] != off["launches"]
            or on["launches"]["k2_closest"] != JVP_DEPTH):
        raise AssertionError("jvp-checkpoint: the checkpointed bounce "
                             "differs under forward mode")
    log("jvp", phase_s=round(time.perf_counter() - t_phase, 1))


def run_phases(dev, started):
    """Every phase on ``dev``, then the kernels' line; ``started["ranks"]``
    gets ``[devices]``' ranks when they start."""
    t_start = time.perf_counter()
    phase_card()
    phase_soup(dev)
    phase_soup_kd(dev)
    table = phase_table_grad(dev)
    from lumo_tpu_torch.camera import build_camera
    camera = build_camera(resolution=(RES, RES), device=dev)

    # the BVH path through path_trace.integrate
    t0 = time.perf_counter()
    scene = bench_scene(dev)
    torch.cuda.synchronize()
    log("render", scene_build_s=round(time.perf_counter() - t0, 3),
        tris=scene.n_tris, bvh_depth=scene.bvh["depth"],
        nodes=scene.bvh["nodes"].shape[0])
    nums, queries = phase_scene_kernels(scene, camera, dev)
    launches = phase_render(scene, camera, dev)
    per_frame = phase_profile(
        "profile", lambda: render(scene, camera, RES, SPP, dev)[2],
        "integrate", "traverse")
    log_per_frame("bvh", nums, per_frame, launches)
    phase_parity(scene, dev)
    stats = phase_stats(scene, queries, dev)

    # the differentiable path: the Cornell box (dense), then the BVH scene
    from lumo_tpu_torch import film
    from lumo_tpu_torch.accel import bvh_kernel
    from lumo_tpu_torch.camera import cornell_camera
    from lumo_tpu_torch.scene.cornell import cornell_box
    cornell = cornell_box().build(device=dev)
    tg_cornell = phase_grad("grad-cornell", cornell,
               cornell_camera(resolution=(RES, RES), device=dev), RES,
               GRAD_CORNELL_SPP, GRAD_CORNELL_DEPTH,
               loss_rgb(film.wb_matrix("DCI-P3", "CORNELL")))
    del cornell
    tg_bvh = phase_grad("grad-bvh", scene, camera, RES, GRAD_SPP, GRAD_DEPTH,
                        loss_r2, kernels=bvh_kernel)
    parity = phase_grad_parity(scene, dev)
    phase_stream(scene, camera, dev)

    # the kd-tree path through the Renderer
    t0 = time.perf_counter()
    scene_kd = bench_scene(dev, accel="kdtree")
    torch.cuda.synchronize()
    log("render-kd", scene_build_s=round(time.perf_counter() - t0, 3),
        tris=scene_kd.n_tris, kd_depth=scene_kd.kdtree["depth"],
        nodes=scene_kd.kdtree["nodes"].shape[0],
        refs=scene_kd.kdtree["refs"].shape[0])
    nums_kd, queries_kd = phase_scene_kernels(scene_kd, camera, dev)
    phase_cross_check(scene_kd, scene, queries_kd)
    launches_kd = phase_render_kd(scene_kd, camera)
    per_frame_kd = phase_profile(
        "profile-kd", lambda: kd_frame(scene_kd, camera, SPP)[2], "render",
        "kd_traverse")
    log_per_frame("kd", nums_kd, per_frame_kd, launches_kd)
    # [devices]' ranks set up (interpreter, card, scene) while [parity-kd]
    # and the phases after it run, and wait for [devices]' go file
    started["ranks"] = start_devices_ranks(dev, RES)
    phase_parity_kd(scene_kd, dev)
    phase_grad_kd(scene_kd, scene, parity)
    phase_render_kd_stream(scene_kd, camera)
    phase_jvp(scene, scene_kd, camera, dev)
    refs = {}     # [devices]' one-device frames, rendered by [direct], [bdpt]
    phase_direct({"bvh": scene, "kdtree": scene_kd}, camera, dev, refs)
    del scene_kd
    phase_materials(dev)
    phase_bdpt(scene, camera, dev, refs)
    phase_devices(scene, camera, dev, refs, started["ranks"])
    del scene
    phase_instance(camera, dev)
    phase_io(camera, dev)
    phase_examples(dev)
    phase_quality(dev)
    phase_graft(dev)
    phase_bench()
    sync = phase_sync(dev)

    bvh_src = ("lumo_tpu_torch/csrc/bvh_traverse.cu",
               "lumo_tpu/accel/pallas_bvh.py:459")
    kd_src = ("lumo_tpu_torch/csrc/kd_traverse.cu",
              "lumo_tpu/accel/pallas_kd.py:199")
    rows = [("bvh_closest_hit", bvh_src, nums["closest"], launches["closest"]),
            ("bvh_any_hit", bvh_src, nums["any"], launches["any"]),
            ("bvh_closest_hit_stats", bvh_src, stats, stats["launches"]),
            ("kd_closest_hit", kd_src, nums_kd["closest"],
             launches_kd["closest"]),
            ("kd_any_hit", kd_src, nums_kd["any"], launches_kd["any"]),
            ("exp_sync", ("lumo_tpu_torch/csrc/exp_sync.cu",
                          "tools/exp_sync.py:42"), sync, sync["launches"])]
    # the table-gradient kernel's launches: a fwd+bwd sample of
    # [grad-cornell] and one of [grad-bvh], of the form the row times
    tg_form = {"w1": "rows_w1", "w4": "rows_wide", "dense": "pair"}
    rows += [(f"table_grad_{form}", ("lumo_tpu_torch/csrc/table_grad.cu",
                                     "none: autograd's index_put_"), v,
              tg_cornell[tg_form[form]] + tg_bvh[tg_form[form]])
             for form, v in table.items()]
    kernels = []
    for name, (source, replaces), v, n_launches in rows:
        if n_launches <= 0:
            raise AssertionError(f"{name} was not launched on its path")
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": n_launches,
            "max_abs_err": v["max_abs_err"], "ms": v["ms"],
            "plain_ms": v["plain_ms"], "bound_ms": v["bound_ms"],
            "bound_by": v["bound_by"], "library_ms": v.get("library_ms")})
    log("done", total_s=round(time.perf_counter() - t_start, 2))
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    started = {}
    try:
        return run_phases(dev, started)
    finally:
        stop_devices_ranks(started.get("ranks"))


if __name__ == "__main__":
    sys.exit(main())
