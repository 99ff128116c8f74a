"""Smoke run of the PyTorch/CUDA port (lumo_tpu_torch) on one CUDA card.

Run from the root of a checkout:

    python3 chip_smoke.py

It builds the port's CUDA kernel from the sources in the checkout, holds
the kernel against its plain PyTorch version on the card, renders the
327,692-triangle BVH scene of ``bench.py::bench_bvh_scene`` (256x256, 4
samples per pixel, one wavefront of 262,144 lanes) through
``path_trace.integrate``, checks that render against a kernel-free render
on a small image, and prints the kernels' numbers as one JSON line.  Any
failure raises and exits non-zero; the last line is the result
``{"ok": true, "device": {...}}``, printed only when every phase passed.
It needs one card and exits non-zero without one, or outside a checkout.
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
# 4 reduce min/max, 2 inflate mul, 3 compares) and per triangle test
# (9 sub, 9 shear mul/add pairs = 18, 6 mul + 3 sub edges, 2 add det,
# 3 mul + 2 add t_scaled, 6 sign min/max, 4 range mul/cmp, 1 div, 24 for
# the error bound)
OPS_PER_NODE = 27
OPS_PER_TRI = 78


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


def bench_scene(dev):
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
    return sb.build(device=dev)


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


def phase_card():
    log("card", nvidia_smi=repr(card_line()),
        device=repr(torch.cuda.get_device_name(0)),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda)
    from lumo_tpu_torch.accel import bvh_kernel
    bvh_kernel.build()
    bvh_kernel._load()
    for line in bvh_kernel.BUILD_INFO["log"].splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas: " + line.strip(), flush=True)
    log("card", nvcc_build_s=round(bvh_kernel.BUILD_INFO["seconds"], 3))


def _soup(T, N, seed, dev):
    from lumo_tpu_torch.accel import build as accel_build
    from lumo_tpu_torch.accel import bvh_kernel
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1, 1, (T, 3)).astype(np.float32)
    b = a + rng.uniform(-0.25, 0.25, (T, 3)).astype(np.float32)
    c = a + rng.uniform(-0.25, 0.25, (T, 3)).astype(np.float32)
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
    tri = tuple(torch.as_tensor(x, device=dev) for x in (a, b, c))
    o = rng.uniform(-2, 2, (N, 3)).astype(np.float32)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = np.full(N, np.inf, np.float32)
    t_max[: N // 8] = 0.0                                   # dead lanes
    t_max[N // 8: N // 2] = rng.uniform(0.05, 3.0, N // 2 - N // 8)
    rng.shuffle(t_max)
    return (dev_bvh, tri, torch.as_tensor(o, device=dev),
            torch.as_tensor(d, device=dev), torch.as_tensor(t_max, device=dev))


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


def capture_bounce_queries(scene, state, n_bounces):
    """Run ``n_bounces`` bounces of the main path and record the (o, d,
    t_max) each closest-hit and any-hit call received."""
    from lumo_tpu_torch.accel import bvh_kernel
    from lumo_tpu_torch.integrators import path_trace
    calls = {"closest": [], "any": []}
    real = {"closest": bvh_kernel.closest_hit, "any": bvh_kernel.any_hit}

    def recorder(kind):
        def call(bvh, tri, o, d, t_max):
            calls[kind].append((o.clone(), d.clone(), t_max.clone()))
            return real[kind](bvh, tri, o, d, t_max)
        return call

    with mock.patch.object(bvh_kernel, "closest_hit", recorder("closest")), \
            mock.patch.object(bvh_kernel, "any_hit", recorder("any")):
        for _ in range(n_bounces):
            state = path_trace.bounce(scene, state, 1.0)
    return calls


def bound(scene, kind, o, t_max, counts, seen):
    """The least time the card could take for one call on these rays: the
    larger of the bytes the call must move at the HBM rate and its float
    operations at the f32 peak.  Bytes: o, d and t_max of each live ray
    (t_max > 0; a dead lane reads only its t_max), each distinct node (32
    B) and triangle (36 B: three vertices) the call read, and the outputs
    (closest: t f32 and a 32-bit prim; any: one byte).  Operations: the
    call's node visits and triangle tests."""
    N = o.shape[0]
    M = scene.bvh["nodes"].shape[0]
    nodes, tris = (int(x) for x in counts.cpu())
    seen_nodes, seen_tris = int(seen[:M].sum()), int(seen[M:].sum())
    live = int((t_max > 0).sum())
    out_bytes = N * (4 + 4) if kind == "closest" else N
    needed = live * 24 + N * 4 + seen_nodes * 32 + seen_tris * 36 + out_bytes
    t_bytes = needed / HBM_BYTES_PER_S * 1e3
    t_ops = (nodes * OPS_PER_NODE + tris * OPS_PER_TRI) / F32_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_needed": needed, "node_visits": nodes, "tri_tests": tris,
            "distinct_nodes": seen_nodes, "distinct_tris": seen_tris,
            "live_rays": live,
            "fetched_bytes_ms": (nodes * 32 + tris * 36) / HBM_BYTES_PER_S
            * 1e3}


def kernel_numbers(scene, kind, o, d, t_max, reps=20):
    """One query family at the main path's shape: the kernel's ms, the
    plain version's ms, the timed kernel's output held against the plain
    output of the same rays, and the bound."""
    from lumo_tpu_torch.accel import bvh_kernel
    from lumo_tpu_torch.scene.trace import _bvh_tris
    args = (scene.bvh, _bvh_tris(scene), o, d, t_max)
    fn = bvh_kernel.closest_hit if kind == "closest" else bvh_kernel.any_hit
    plain = (bvh_kernel.closest_hit_plain if kind == "closest"
             else bvh_kernel.any_hit_plain)
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
    M, T = scene.bvh["nodes"].shape[0], scene.bvh["tris"].shape[0]
    counts = torch.zeros(2, dtype=torch.int64, device=o.device)
    seen = torch.zeros(M + T, dtype=torch.uint8, device=o.device)
    fn(*args, counts=counts, seen=seen)
    return {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err,
            "rays": o.shape[0], **check,
            **bound(scene, kind, o, t_max, counts, seen)}


def phase_scene_kernels(scene, camera, dev):
    """Kernel vs plain on the full scene at the main path's 262,144-ray
    shapes (camera rays, first-bounce rays, first-bounce shadow rays), and
    the kernels' numbers."""
    from lumo_tpu_torch.accel import bvh_kernel
    from lumo_tpu_torch.integrators.path_trace import initial_state
    from lumo_tpu_torch.scene.trace import _bvh_tris
    o, d, lam, rk = camera_wavefront(camera, RES, SPP, dev)
    calls = capture_bounce_queries(scene, initial_state(o, d, lam, rk), 2)
    cam, bnc = calls["closest"][0], calls["closest"][1]
    shadow = calls["any"][0]
    args = (scene.bvh, _bvh_tris(scene), *cam)
    ties, hits, err = compare_closest(bvh_kernel.closest_hit(*args),
                                      bvh_kernel.closest_hit_plain(*args),
                                      exact=False)
    log("kernels", case="scene", query="closest", rays_from="camera",
        tris=scene.n_tris, bvh_tris=scene.n_bvh_tris, rays=cam[0].shape[0],
        hits=hits, tie_flips=ties, prims="equal except ties", t="bit-equal",
        max_abs_err=err)
    nums = {"closest": kernel_numbers(scene, "closest", *bnc),
            "any": kernel_numbers(scene, "any", *shadow)}
    nums["closest"]["max_abs_err"] = max(err, nums["closest"]["max_abs_err"])
    for k, v in nums.items():
        log("kernels", case="scene", query=k,
            rays_from="first bounce" if k == "closest" else
            "first-bounce shadow", **v)
    return nums


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
        per_frame.append(dict(bvh_kernel.LAUNCHES))
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


def phase_profile(scene, camera, dev):
    """One more frame under torch.profiler: the BVH kernels' device time
    and the device's idle share over ``integrate``."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, _, wall = render(scene, camera, RES, SPP, dev)
    events = list(prof.events())
    card = lambda e: str(e.device_type).endswith("CUDA")
    window = [e.time_range for e in events
              if e.name == "integrate" and not card(e)]
    # device work: kernels, copies and sets (not the range's own marker)
    on_card = [e for e in events if card(e) and e.name != "integrate"]
    if not window or not on_card:
        log("profile", device_events=len(on_card), device_time="not measured")
        return
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
    log("profile", wall_ms=wall * 1e3, window_ms=(w1 - w0) / 1e3,
        device_events=len(on_card), device_busy_ms=busy / 1e3,
        idle_share=1.0 - busy / (w1 - w0),
        closest_ms_total=us("traverse<false") / 1e3,
        any_ms_total=us("traverse<true") / 1e3,
        kernel_launches=sum("traverse<" in e.name for e in on_card))


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
    from lumo_tpu_torch.camera import build_camera
    t0 = time.perf_counter()
    scene = bench_scene(dev)
    torch.cuda.synchronize()
    log("render", scene_build_s=round(time.perf_counter() - t0, 3),
        tris=scene.n_tris, bvh_depth=scene.bvh["depth"],
        nodes=scene.bvh["nodes"].shape[0])
    camera = build_camera(resolution=(RES, RES), device=dev)
    nums = phase_scene_kernels(scene, camera, dev)
    launches = phase_render(scene, camera, dev)
    phase_profile(scene, camera, dev)
    phase_parity(scene, dev)
    kernels = []
    for k, name in (("closest", "bvh_closest_hit"), ("any", "bvh_any_hit")):
        v = nums[k]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "lumo_tpu_torch/csrc/bvh_traverse.cu",
            "replaces": "lumo_tpu/accel/pallas_bvh.py:459",
            "launches": launches[k], "max_abs_err": v["max_abs_err"],
            "ms": v["ms"], "plain_ms": v["plain_ms"],
            "bound_ms": v["bound_ms"], "bound_by": v["bound_by"],
            "library_ms": None})
    log("done", total_s=round(time.perf_counter() - t_start, 2))
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
