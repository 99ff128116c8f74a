"""Smoke run of the PyTorch/CUDA port (lumo_tpu_torch) on one CUDA card.

Run from the root of a checkout:

    python3 chip_smoke.py

It builds the port's CUDA kernels (BVH traversal with its stats variant,
kd-tree traversal, the in-kernel loop microbenchmark) and both native
tree builders from the sources in the checkout, holds every kernel
against its plain PyTorch version on the card, and drives two paths over
the 327,692-triangle scene of ``bench.py::bench_bvh_scene`` at 256x256, 4
samples per pixel (one wavefront of 262,144 lanes): the BVH scene through
``path_trace.integrate``, and the same scene built with
``accel="kdtree"`` through ``Renderer(scene, camera).samples(4).render()``.
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

import json
import os
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

RES = 256            # bench.py's resolution
SPP = 4              # 4 spp x 256^2 = one wavefront of 262,144 lanes
PARITY_RES = 64
FRAMES = 5           # timed frames of the render

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


def log(phase, **kv):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def timed_ms(fn, reps):
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events)."""
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bench_scene(dev, accel="bvh"):
    """bench.py::bench_bvh_scene's scene, built with the port's builder."""
    from lumo_tpu_torch.scene import shapes
    from lumo_tpu_torch.scene.cornell import empty_box
    from lumo_tpu_torch.scene.instance import Mesh
    from lumo_tpu_torch.scene.materials import Material
    sb = empty_box((0.95, 0.95, 0.95), Material.diffuse((0.9, 0.1, 0.1)),
                   Material.diffuse((0.1, 0.9, 0.1)))
    v, f, vn = shapes.blob(subdiv=7, seed=11, amp=0.22)
    (Mesh(v, f, normals=vn).to_unit_size().to_origin().set_y(-0.799)
     .translate(0.0, 0.0, -1.5)
     .add_to(sb, Material.metal((0.9, 0.7, 0.1), 0.1, 2.5, 3.0)))
    return sb.build(device=dev, accel=accel)


def camera_wavefront(camera, res, spp, dev):
    """Jittered camera rays keyed per (pixel, sample), as bench.py:234-245
    generates them."""
    from lumo_tpu_torch.color import wavelength
    from lumo_tpu_torch.sampling.samplers import _hash_u32, _randfloat
    n = res * res
    idx = torch.arange(n * spp, dtype=torch.int64, device=dev)
    p, s = idx % n, idx // n
    gx, gy = (p % res).float(), (p // res).float()
    jx = _randfloat(p, s ^ 0x51633E2D)
    jy = _randfloat(p, s ^ 0x68BC21EB)
    raster = torch.stack([gx + jx, gy + jy], -1)
    o, d = camera.generate_ray(raster, torch.full_like(raster, 0.5))
    lam = wavelength.sample(_randfloat(p, s ^ 0x02E5BE93))
    rk = _hash_u32(p ^ _hash_u32(s ^ 0x9E3779B9))
    return o, d, lam, rk


def kernel_libraries():
    from lumo_tpu_torch.accel import bvh_kernel, kd_kernel
    from lumo_tpu_torch.tools import exp_sync
    return [bvh_kernel.LIB, kd_kernel.LIB, exp_sync.LIB]


def phase_card():
    """Build both native tree builders (g++) and every kernel library
    (nvcc), and print each kernel's ptxas lines."""
    log("card", nvidia_smi=repr(card_line()),
        device=repr(torch.cuda.get_device_name(0)),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda)
    from lumo_tpu_torch import native
    t0 = time.perf_counter()
    for which in ("bvh", "kdtree"):
        native.load(which)
    log("card", native_builds_s=round(time.perf_counter() - t0, 3))
    for lib in kernel_libraries():
        lib.load()
        for line in lib.ptxas_lines():
            print(f"  ptxas {lib.name}: {line}", flush=True)
        log("card", library=lib.name, nvcc_build_s=round(lib.info["seconds"], 3))
    log("card", all_builds_s=round(time.perf_counter() - t0, 3))


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
        rays=int(rays[-1]), rays_per_s_median=rate[FRAMES // 2],
        rays_per_s_min=rate[0], rays_per_s_max=rate[-1],
        mean_depth=float(depth.float().mean()),
        launches=json.dumps(launches).replace(" ", ""),
        image_mean=float(img.mean()), finite=True)
    write_ppm(img, os.path.join(ROOT, "out", "render_256.ppm"))
    return launches


def phase_profile(phase, frame, span, kernel_tag):
    """One more frame under torch.profiler: the traversal kernels' device
    time and the device's idle share over the host range ``span``.
    ``frame()`` renders the frame and returns its wall seconds."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = frame()
    events = list(prof.events())
    card = lambda e: str(e.device_type).endswith("CUDA")
    window = [e.time_range for e in events
              if e.name == span and not card(e)]
    # device work: kernels, copies and sets (not the range's own marker)
    on_card = [e for e in events if card(e) and e.name != span]
    if not window or not on_card:
        log(phase, device_events=len(on_card), device_time="not measured")
        return {}
    w0, w1 = window[0].start, window[0].end
    spans = sorted((max(e.time_range.start, w0), min(e.time_range.end, w1))
                   for e in on_card)
    busy, end = 0.0, w0
    for a, b in spans:                  # union of the device intervals
        a = max(a, end)
        if b > a:
            busy, end = busy + b - a, b
    us = lambda tag: sum(e.time_range.elapsed_us() for e in on_card
                         if tag in e.name)
    per_frame = {"closest": us(f"{kernel_tag}<false") / 1e3,
                 "any": us(f"{kernel_tag}<true") / 1e3}
    log(phase, wall_ms=wall * 1e3, window_ms=(w1 - w0) / 1e3,
        device_events=len(on_card), device_busy_ms=busy / 1e3,
        idle_share=1.0 - busy / (w1 - w0),
        closest_ms_total=per_frame["closest"], any_ms_total=per_frame["any"],
        kernel_launches=sum(f"{kernel_tag}<" in e.name for e in on_card))
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
    """Two warm-up frames, then FRAMES timed frames of the kd main path;
    the launch counts are reset just before each frame and read just
    after."""
    from lumo_tpu_torch.accel import kd_kernel
    for _ in range(2):
        kd_frame(scene, camera, SPP)
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
        spp=SPP, lanes=RES * RES * SPP, frames=FRAMES, warmup_frames=2,
        wall_s=json.dumps(walls).replace(" ", ""), rays=int(rays[-1]),
        rays_per_s_median=rate[FRAMES // 2], rays_per_s_min=rate[0],
        rays_per_s_max=rate[-1],
        mean_depth=rays[-1] / 2.0 / (RES * RES * SPP),
        launches=json.dumps(launches).replace(" ", ""),
        image_mean=float(img.mean()), finite=True)
    write_ppm(torch.as_tensor(img), os.path.join(ROOT, "out",
                                                 "render_kd_256.ppm"))
    return launches


def phase_parity_kd(scene, dev, rtol=1e-5, atol=1e-6):
    """A 64x64 Renderer image (4 spp, fixed Russian-roulette threshold 1)
    with the kernel against the same with the plain walk.  The film's
    ``index_add_`` uses atomics on the card, so sums differ in order:
    pixels within (rtol, atol); pixels beyond it are counted as flips."""
    from lumo_tpu_torch.accel import kd_kernel
    from lumo_tpu_torch.camera import build_camera
    cam = build_camera(resolution=(PARITY_RES, PARITY_RES), device=dev)
    img_k, _, _ = kd_frame(scene, cam, SPP, delta=1.0)
    t0 = time.perf_counter()
    with mock.patch.object(kd_kernel, "closest_hit",
                           kd_kernel.closest_hit_plain), \
            mock.patch.object(kd_kernel, "any_hit", kd_kernel.any_hit_plain):
        img_p, _, _ = kd_frame(scene, cam, SPP, delta=1.0)
    close = np.isclose(img_k, img_p, rtol=rtol, atol=atol).all(axis=-1)
    flips = int((~close).sum())
    max_err = float(np.abs(img_k - img_p)[close].max())
    log("parity-kd", res=f"{PARITY_RES}x{PARITY_RES}", spp=SPP,
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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, "lumo_tpu_torch")):
        print("chip_smoke: run from the root of a lumo_tpu checkout "
              "(lumo_tpu_torch/ not found)", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    phase_card()
    phase_soup(dev)
    phase_soup_kd(dev)
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
    phase_parity_kd(scene_kd, dev)
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
    kernels = []
    for name, (source, replaces), v, n_launches in rows:
        if n_launches <= 0:
            raise AssertionError(f"{name} was not launched on its path")
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": n_launches,
            "max_abs_err": v["max_abs_err"], "ms": v["ms"],
            "plain_ms": v["plain_ms"], "bound_ms": v["bound_ms"],
            "bound_by": v["bound_by"], "library_ms": None})
    log("done", total_s=round(time.perf_counter() - t_start, 2))
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
