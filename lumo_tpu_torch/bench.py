"""Benchmark entry of the port: rays per second on the card at
``bench.py``'s own sizes (counterpart of the JAX package's ``bench.py``).

Prints ONE JSON line last, ``bench.py``'s schema: ``{"metric", "value",
"unit", "vs_baseline", "extra"}``.  The headline is the Cornell box at
256², 64 samples per pixel, fixed depth 6, forward and backward
(:func:`bench_cornell`), measured first and in this process; every
secondary bench (``bvh``, ``bdpt``, ``smoke``, ``quality``) runs in its
own ``python -m lumo_tpu_torch.bench --sub NAME`` under a timeout, so a
device fault or a hang in one cannot hide the headline.  Where a sub
fails, its record is ``{"error": ...}``; the line is printed all the
same and the process then exits 1, as it does when the smoke gate's
``ok`` is false.  Nothing falls back to the CPU or to a plain version.

Rays are counted as ``bench.py`` counts them: 2 x the sum of the
integrator's per-lane depths (one extension and one shadow ray a
bounce; a BDPT sample counts both subpaths), an integer held in int64 and
reported as a float.  ``vs_baseline`` divides by ``BASELINE_ANCHOR.json``'s
anchors, which are host-CPU figures of ``tools/cpu_anchor*.cpp``.

JAX's ``jax.random`` keys become explicit ``torch.Generator``s drawn on the
CPU (seeded by the bench's seed, the run and the sample), so a seed gives
the same draws on every device.  JAX runs the 64 headline samples as one
``lax.scan``; here the host loops, one fwd+bwd a sample, with the
checkpoint off, so the peak is one sample's.  Each timed quantity is the
best of two runs after a one-sample warm-up, with the card synchronised;
every run's rate is kept in ``extra``.

    python -m lumo_tpu_torch.bench [--sub NAME] [--cpu] [--res R]
                                   [--spp S] [--subdiv K]

runs on the card (without one it raises "no CUDA device").  ``--cpu``,
``--res``, ``--spp`` (a cap on every sub's samples per pixel) and
``--subdiv`` (the blob's subdivisions; the smoke gate's large scene has
two more) exist so that tests can run the entry at a tiny size.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import torch

from lumo_tpu_torch.config import resolve_device
from lumo_tpu_torch.graft_entry import _generator, _sync, float_tables

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RES = 256              # bench.py:44-46
SPP = 64
DEPTH = 6
SUBDIV = 7             # bench.py::bench_bvh_scene's blob: 327,692 triangles
BVH_SPP = 32           # bench.py:216-219: the stream's 262,144-lane pool
BVH_LANES = 262144
GRAD_SPP = 2           # bench.py:275-276
GRAD_DEPTH = 4
BDPT_SPP = 4           # bench.py:345
QUALITY = ((64, 4), (32, 2))   # quality.run(64, 4), quality.run_bvh()
CORNELL_SEED = 42      # bench.py's PRNGKey(42)
BDPT_SEED = 5          # its PRNGKey(5)
TIMED_RUNS = (7, 8)    # bench.py's fold_in(key, 7), fold_in(key, 8)
WARMUP_RUN = 0
SUB_TIMEOUT_S = 1500   # per-sub wall clock cap, set-up included
WB = ("DCI-P3", "CORNELL")
METRIC = "cornell_256_64spp_fwd_bwd_rays_per_sec_per_chip"
ANCHOR_NOTE = ("host-CPU figures of tools/cpu_anchor.cpp and "
               "tools/cpu_anchor_bvh.cpp (BASELINE_ANCHOR.json), not a TPU's")


def anchors():
    """(Cornell anchor, BVH anchor) rays/s of the checkout's
    ``BASELINE_ANCHOR.json``, read as a plain JSON file."""
    with open(os.path.join(ROOT, "BASELINE_ANCHOR.json")) as f:
        anchor = json.load(f)
    return anchor["rays_per_s"], anchor["bvh"]["rays_per_s"]


def card_line():
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _log(*parts):
    print("[bench]", *parts, file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# scenes, rays and losses (shared with chip_smoke.py)

def bench_scene(dev, accel="bvh", subdiv=SUBDIV):
    """bench.py::bench_bvh_scene's scene: the displaced icosphere of
    ``subdiv`` subdivisions (20·4^subdiv triangles), metal, in the empty
    box, built with the port's builder on ``dev``."""
    from lumo_tpu_torch.scene import shapes
    from lumo_tpu_torch.scene.cornell import empty_box
    from lumo_tpu_torch.scene.instance import Mesh
    from lumo_tpu_torch.scene.materials import Material
    sb = empty_box((0.95, 0.95, 0.95), Material.diffuse((0.9, 0.1, 0.1)),
                   Material.diffuse((0.1, 0.9, 0.1)))
    v, f, vn = shapes.blob(subdiv=subdiv, seed=11, amp=0.22)
    (Mesh(v, f, normals=vn).to_unit_size().to_origin().set_y(-0.799)
     .translate(0.0, 0.0, -1.5)
     .add_to(sb, Material.metal((0.9, 0.7, 0.1), 0.1, 2.5, 3.0)))
    return sb.build(device=dev, accel=accel)


def sample_rays(camera, res, idx):
    """Jittered camera rays of the sample ids ``idx`` (pixel ``idx % n``,
    sample ``idx // n``), keyed per (pixel, sample), as bench.py:234-245
    generates them: (o, d, lam, ray_key, pixel)."""
    from lumo_tpu_torch.color import wavelength
    from lumo_tpu_torch.sampling.samplers import _hash_u32, _randfloat
    n = res * res
    p, s = idx % n, idx // n
    gx, gy = (p % res).float(), (p // res).float()
    jx = _randfloat(p, s ^ 0x51633E2D)
    jy = _randfloat(p, s ^ 0x68BC21EB)
    raster = torch.stack([gx + jx, gy + jy], -1)
    o, d = camera.generate_ray(raster, torch.full_like(raster, 0.5))
    lam = wavelength.sample(_randfloat(p, s ^ 0x02E5BE93))
    rk = _hash_u32(p ^ _hash_u32(s ^ 0x9E3779B9))
    return o, d, lam, rk, p


def grad_rays(camera, res, sp, dev):
    """bench.py:285-291's rays of sample ``sp`` at every pixel: jittered
    raster, hero wavelengths, ray_key = hash(pixel ^ hash(sp))."""
    from lumo_tpu_torch.color import wavelength
    from lumo_tpu_torch.sampling.samplers import _hash_u32, _randfloat
    pix = torch.arange(res * res, dtype=torch.int64, device=dev)
    jx = _randfloat(pix, sp ^ 0x51633E2D)
    jy = _randfloat(pix, sp ^ 0x68BC21EB)
    raster = torch.stack([(pix % res).float() + jx, (pix // res).float() + jy],
                         -1)
    o, d = camera.generate_ray(raster, torch.full_like(raster, 0.5))
    lam = wavelength.sample(_randfloat(pix, sp ^ 0x02E5BE93))
    return o, d, lam, _hash_u32(pix ^ _hash_u32(torch.full_like(pix, sp)))


def cornell_rays(camera, u, u_lam):
    """bench.py:71-79's rays of one sample at every pixel: raster = pixel +
    the jitter ``u`` (n, 2), lens sample 0.5, hero wavelengths of the
    uniforms ``u_lam`` (n,): (o, d, lam)."""
    from lumo_tpu_torch.color import wavelength
    res = camera.resolution[0]
    pix = torch.arange(u.shape[0], dtype=torch.int64, device=u.device)
    raster = torch.stack([(pix % res).float(), (pix // res).float()], -1) + u
    o, d = camera.generate_ray(raster, torch.full_like(raster, 0.5))
    return o, d, wavelength.sample(u_lam)


def cornell_draw(camera, run, i):
    """Sample ``i`` of run ``run`` of the headline: the jitter, the
    wavelengths' uniforms and the ray keys from one CPU generator seeded
    by (CORNELL_SEED, run, i): (o, d, lam, ray_key) on the camera's
    device."""
    from lumo_tpu_torch.integrators import path_trace
    res = camera.resolution[0]
    n, dev = res * res, camera.c2w_t.device
    g = _generator(CORNELL_SEED, run, i)
    u = torch.rand((n, 2), generator=g)
    u_lam = torch.rand(n, generator=g)
    rk = path_trace.ray_keys(g, n)
    return (*cornell_rays(camera, u.to(dev), u_lam.to(dev)), rk.to(dev))


def loss_rgb(wbm):
    """bench.py:85-87's loss: mean(rgb^2) through the film's colour
    matrix, over the lanes of weight ``w`` (all when None)."""
    from lumo_tpu_torch import film

    def loss(r, lam, w=None):
        sq = film.spectral_to_rgb(r, lam, wbm) ** 2
        return sq.mean() if w is None else (w[:, None] * sq).mean()
    return loss


def loss_r2(r, lam, w=None):
    """bench.py:297's loss, mean(r^2), over the lanes of weight ``w``."""
    return (r * r).mean() if w is None else (w[:, None] * r * r).mean()


def gnorm(grads, spp):
    """bench.py's gradient norm: sum of |g| over the material leaves, per
    sample."""
    return sum(float(g.abs().sum()) for k, g in grads.items()
               if g is not None and k != "c2w_t") / spp


def accumulate(scene, rays_of, samples, depth, loss_fn, backward=True):
    """fwd(+bwd) of each sample ``sp`` of ``samples`` at fixed ``depth``,
    ``rays_of(sp)`` giving its (o, d, lam, ray_key) and ``loss_fn(r,
    lam, None)`` its loss, the gradients of every float material leaf
    accumulated over them (the checkpoint off).  Returns {"loss": summed
    loss (tensor), "rays": 2 x sum of depths (int64 tensor), "grads":
    {leaf: gradient} or None}."""
    from lumo_tpu_torch.integrators import path_trace
    mats = {k: v.detach().clone().requires_grad_(backward)
            for k, v in float_tables(scene).items()}
    sc = dataclasses.replace(scene, materials={**scene.materials, **mats})
    loss_sum = torch.zeros((), device=scene.device)
    rays = torch.zeros((), dtype=torch.int64, device=scene.device)
    with torch.set_grad_enabled(backward):
        for sp in samples:
            o, d, lam, rk = rays_of(sp)
            r, lam_out, dep = path_trace.integrate(sc, o, d, lam, ray_key=rk,
                                                   fixed_depth=depth)
            loss = loss_fn(r, lam_out, None)
            if backward:
                loss.backward()
            loss_sum += loss.detach()
            rays += dep.sum()
    return {"loss": loss_sum, "rays": 2 * rays,
            "grads": {k: v.grad for k, v in mats.items()} if backward
            else None}


def stream_rays(scene, camera, res, lanes, n_samples):
    """bench.py:153-184's forward: ``integrate_stream`` over ``lanes``
    lanes and the sample ids [0, n_samples) of :func:`sample_rays`,
    folding 2 x the depth of every terminated lane into an int64."""
    from lumo_tpu_torch.integrators import path_trace

    def gen(idx):
        o, d, lam, rk, _ = sample_rays(camera, res, idx)
        return {"o": o, "d": d, "lam": lam, "rng": rk}

    def fold(acc, term, st):
        return acc + torch.where(term, st["depth"], 0).sum()

    acc0 = torch.zeros((), dtype=torch.int64, device=scene.device)
    return 2 * path_trace.integrate_stream(scene, gen, fold, acc0,
                                           min(lanes, n_samples), n_samples)


def bdpt_keys(pix, i):
    """bench.py:346-348's ray keys of BDPT sample ``i``:
    (pix * 2654435761) ^ (i * 7919 + 13), as uint32 in int64."""
    from lumo_tpu_torch.sampling.samplers import MASK32, _mul32
    return _mul32(pix, 2654435761) ^ ((i * 7919 + 13) & MASK32)


def bdpt_depths(scene, camera, o, d, lam, i):
    """Per-lane depths of BDPT sample ``i`` (``bdpt.integrate`` called
    directly, as bench.py does, with :func:`bdpt_keys`)."""
    from lumo_tpu_torch.integrators import bdpt
    pix = torch.arange(o.shape[0], dtype=torch.int64, device=o.device)
    return bdpt.integrate(scene, camera, o, d, lam,
                          ray_key=bdpt_keys(pix, i))[-1]


# ---------------------------------------------------------------------------
# timing

def _peak_reset(dev):
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def _peak(dev):
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None


def best_of(dev, fn, runs=TIMED_RUNS):
    """``fn(run)`` -> a dict with "rays" (int64 tensor) for each timed
    run, the card synchronised around it: (best rays/s, every run's
    rays/s, the last run's dict)."""
    rates = []
    for run in runs:
        _sync(dev)
        t0 = time.perf_counter()
        out = fn(run)
        rays = int(out["rays"])
        _sync(dev)
        rates.append(rays / (time.perf_counter() - t0))
    return max(rates), rates, out


def launches(mod):
    """The kernel module ``mod``'s closest and any launch counts."""
    return {k: mod.LAUNCHES[k] for k in ("closest", "any")}


def launched_since(mod, before):
    """Launches of ``mod`` since :func:`launches` gave ``before``."""
    return {k: mod.LAUNCHES[k] - before[k] for k in before}


def _check(what, acc):
    """Raise unless the loss and every gradient of ``acc`` are finite and
    some gradient is nonzero."""
    grads = [g for g in acc["grads"].values() if g is not None]
    if not (bool(torch.isfinite(acc["loss"]))
            and all(bool(torch.isfinite(g).all()) for g in grads)
            and any(bool((g != 0).any()) for g in grads)):
        raise FloatingPointError(f"{what}: non-finite loss or gradients, "
                                 "or all gradients zero")


# ---------------------------------------------------------------------------
# the benches

def bench_cornell(res=RES, spp=SPP, device=None):
    """Headline: Cornell 256² at 64 spp, fixed depth 6, fwd+bwd, material
    gradients accumulated over the samples (bench.py:51-184).  The box
    has 32 triangles, below ``BVH_THRESHOLD``, so it runs the dense path
    and no kernel.  Returns (fwd+bwd rays/s, its extra record)."""
    from lumo_tpu_torch import film
    from lumo_tpu_torch.camera import cornell_camera
    from lumo_tpu_torch.scene.cornell import cornell_box
    dev = resolve_device(device)
    scene = cornell_box().build(device=dev)
    camera = cornell_camera(resolution=(res, res), device=dev)
    loss_fn = loss_rgb(film.wb_matrix(*WB))
    n = res * res

    def run_of(run, samples=range(spp), backward=True):
        return accumulate(scene, lambda i: cornell_draw(camera, run, i),
                          samples, DEPTH, loss_fn, backward)

    def stream(run, n_samples=n * spp):
        return {"rays": stream_rays(scene, camera, res, n, n_samples)}

    run_of(WARMUP_RUN, range(1))                            # warm-up
    _peak_reset(dev)
    best, rates, acc = best_of(dev, run_of)
    peak = _peak(dev)
    _check("cornell fwd+bwd", acc)
    _log(f"cornell fwd+bwd {rates} rays/s")
    run_of(WARMUP_RUN, range(1), backward=False)            # warm-up
    best_f, rates_f, _ = best_of(dev, lambda run: run_of(run, backward=False))
    _log(f"cornell forward {rates_f} rays/s")
    stream(WARMUP_RUN, n)                                   # warm-up
    best_s, rates_s, out_s = best_of(dev, stream)
    _log(f"cornell stream {rates_s} rays/s")
    return best, {
        "res": res, "spp": spp, "depth": DEPTH, "rays": float(acc["rays"]),
        "loss": float(acc["loss"]) / spp, "gnorm": gnorm(acc["grads"], spp),
        "fwd_bwd_rays_per_s_runs": rates, "checkpoint": False,
        "peak_bytes": peak, "warmup": "one sample",
        "kernel": "none (32 triangles, dense)",
        "fwd_only": {"rays_per_s": max(best_f, best_s),
                     "mode": "stream" if best_s > best_f else "batch",
                     "batch_rays_per_s_runs": rates_f,
                     "stream_rays_per_s_runs": rates_s,
                     "stream_lanes": n, "stream_samples": n * spp,
                     "stream_rays": float(out_s["rays"])}}


def bench_bvh_scene(res=RES, spp=SPP, subdiv=SUBDIV, device=None):
    """The 327,692-triangle blob in the empty box through K2
    (bench.py:187-315): the stream over 262,144 lanes and 32 spp, then
    fwd+bwd at 2 spp, depth 4, loss mean(r^2)."""
    from lumo_tpu_torch.accel import bvh_kernel
    from lumo_tpu_torch.camera import build_camera
    dev = resolve_device(device)
    t0 = time.perf_counter()
    scene = bench_scene(dev, subdiv=subdiv)
    camera = build_camera(resolution=(res, res), device=dev)
    _sync(dev)
    build_s = time.perf_counter() - t0
    n = res * res
    stream_spp, grad_spp = min(BVH_SPP, spp), min(GRAD_SPP, spp)

    def counted(fn):
        def call(run, *args):
            before = launches(bvh_kernel)
            out = fn(run, *args)
            return {**out, "launches": launched_since(bvh_kernel, before)}
        return call

    @counted
    def stream(run, n_samples=n * stream_spp):
        return {"rays": stream_rays(scene, camera, res, BVH_LANES, n_samples)}

    @counted
    def fwd_bwd(run, samples=range(1, grad_spp + 1)):
        return accumulate(scene, lambda sp: grad_rays(camera, res, sp, dev),
                          samples, GRAD_DEPTH, loss_r2)

    stream(WARMUP_RUN, n)                                   # warm-up
    best, rates, out = best_of(dev, stream)
    _log(f"bvh stream {rates} rays/s")
    fwd_bwd(WARMUP_RUN, range(1, 2))                        # warm-up
    _peak_reset(dev)
    best_g, rates_g, acc = best_of(dev, fwd_bwd)
    _check("bvh fwd+bwd", acc)
    _log(f"bvh fwd+bwd {rates_g} rays/s")
    return {
        "bvh_scene_tris": int(scene.n_tris),
        "bvh_scene_fwd_rays_per_sec": best,
        "vs_baseline": best / anchors()[1],
        "bvh_scene_fwd_bwd_rays_per_sec": best_g, "fwd_bwd_depth": GRAD_DEPTH,
        "res": res, "stream_lanes": min(BVH_LANES, n * stream_spp),
        "stream_spp": stream_spp, "stream_samples": n * stream_spp,
        "stream_rays": float(out["rays"]), "stream_rays_per_s_runs": rates,
        "fwd_bwd_spp": grad_spp, "fwd_bwd_rays": float(acc["rays"]),
        "fwd_bwd_rays_per_s_runs": rates_g, "checkpoint": False,
        "loss": float(acc["loss"]) / grad_spp,
        "gnorm": gnorm(acc["grads"], grad_spp),
        "peak_bytes_fwd_bwd": _peak(dev), "scene_build_s": build_s,
        "k2_launches": {"stream": out["launches"],
                        "fwd_bwd": acc["launches"]}}


def bench_bdpt(res=RES, spp=SPP, device=None):
    """BDPT on the Cornell box at 256², 4 spp (bench.py:318-364):
    pixel-centre rays, wavelengths from a generator seeded BDPT_SEED,
    ``bdpt.integrate`` on all 65,536 lanes at once (no Renderer step
    cap).  Rays: 2 x the sum of both subpaths' depths."""
    from lumo_tpu_torch.camera import cornell_camera
    from lumo_tpu_torch.color import wavelength
    from lumo_tpu_torch.graft_entry import pixel_rays
    from lumo_tpu_torch.integrators import bdpt
    from lumo_tpu_torch.scene.cornell import cornell_box
    dev = resolve_device(device)
    scene = cornell_box().build(device=dev)
    camera = cornell_camera(resolution=(res, res), device=dev)
    n = res * res
    _, o, d, _ = pixel_rays(camera, torch.arange(n, device=dev))
    lam = wavelength.sample(torch.rand(n, generator=_generator(BDPT_SEED))
                            ).to(dev)
    n_spp = min(BDPT_SPP, spp)

    def run(_run, samples=range(n_spp)):
        return {"rays": 2 * sum(bdpt_depths(scene, camera, o, d, lam, i).sum()
                                for i in samples)}

    run(WARMUP_RUN, range(1))                               # warm-up
    _peak_reset(dev)
    best, rates, out = best_of(dev, run)
    _log(f"bdpt {rates} rays/s")
    return {"bdpt_cornell_rays_per_sec": best, "max_verts": bdpt.MAX_VERTS,
            "spp": n_spp, "res": res, "lanes": n, "rays": float(out["rays"]),
            "rays_per_s_runs": rates, "peak_bytes": _peak(dev)}


def bench_smoke(subdiv=SUBDIV, device=None):
    """The on-card gate (``tools/smoke.py``): K2 on the 327,692- and
    5,242,880-triangle blobs, K3 on the kd-built one."""
    from lumo_tpu_torch.tools import smoke
    return smoke.run(subdiv=subdiv, device=device)


def bench_quality(res=RES, spp=SPP, device=None):
    """``tools/quality.py``'s harnesses: ``run(64, 4)`` with
    ``run_bvh()`` under "bvh", and K2's launches over both."""
    from lumo_tpu_torch.accel import bvh_kernel
    from lumo_tpu_torch.tools import quality
    (c_res, c_spp), (b_res, b_spp) = QUALITY
    before = launches(bvh_kernel)
    out = quality.run(min(c_res, res), min(c_spp, spp), device=device)
    out["bvh"] = quality.run_bvh(min(b_res, res), min(b_spp, spp),
                                 device=device)
    out["k2_launches"] = launched_since(bvh_kernel, before)
    return out


SUBS = {
    "bvh": lambda a, dev: bench_bvh_scene(a.res, a.spp, a.subdiv, dev),
    "bdpt": lambda a, dev: bench_bdpt(a.res, a.spp, dev),
    "smoke": lambda a, dev: bench_smoke(a.subdiv, dev),
    "quality": lambda a, dev: bench_quality(a.res, a.spp, dev),
}


def _scale_args(args):
    out = ["--res", str(args.res), "--spp", str(args.spp),
           "--subdiv", str(args.subdiv)]
    return out + (["--cpu"] if args.cpu else [])


def run_sub(name, args):
    """Run one sub in its own process; its JSON record (with its wall
    seconds, ``sub_s``) or an {"error": ...} record."""
    t0 = time.perf_counter()
    try:
        p = subprocess.run(
            [sys.executable, "-m", "lumo_tpu_torch.bench", "--sub", name,
             *_scale_args(args)], capture_output=True, text=True,
            timeout=SUB_TIMEOUT_S, cwd=ROOT)
    except subprocess.TimeoutExpired:
        return {"error": f"timeout after {SUB_TIMEOUT_S}s"}
    if p.returncode != 0:
        tail = (p.stderr or p.stdout or "").strip().splitlines()[-3:]
        return {"error": f"rc={p.returncode}: " + " | ".join(tail)[-300:]}
    for line in reversed(p.stdout.strip().splitlines()):
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        rec["sub_s"] = time.perf_counter() - t0
        return rec
    return {"error": "no JSON in the sub's output"}


def failed(result):
    """The names of the subs of ``result`` that failed: an error record,
    or a smoke gate whose ``ok`` is false."""
    extra = result["extra"]
    bad = [k for k in SUBS if "error" in extra.get(k, {"error": "missing"})]
    if "smoke" not in bad and not extra["smoke"].get("ok", False):
        bad.append("smoke")
    return bad


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m lumo_tpu_torch.bench",
        description=__doc__.splitlines()[0])
    p.add_argument("--sub", default=None,
                   help="run one secondary bench: " + ", ".join(SUBS))
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of the card (tests)")
    p.add_argument("--res", type=int, default=RES)
    p.add_argument("--spp", type=int, default=SPP,
                   help="cap on every sub's samples per pixel")
    p.add_argument("--subdiv", type=int, default=SUBDIV)
    args = p.parse_args(argv)
    if args.sub is not None and args.sub not in SUBS:
        print(json.dumps({"error": f"unknown sub {args.sub!r}; one of "
                          f"{sorted(SUBS)}"}))
        return 1
    dev = resolve_device("cpu" if args.cpu else None)
    if args.sub is not None:
        print(json.dumps(SUBS[args.sub](args, dev)))
        return 0
    anchor, _ = anchors()
    t0 = time.perf_counter()
    value, extra = bench_cornell(args.res, args.spp, dev)
    extra["fwd_only"]["vs_baseline"] = extra["fwd_only"]["rays_per_s"] / anchor
    result = {
        "metric": METRIC, "value": value, "unit": "rays/s/chip",
        "vs_baseline": value / anchor,
        "extra": {"anchor_rays_per_s": anchor, "anchor": ANCHOR_NOTE,
                  "card": card_line() if dev.type == "cuda" else "cpu",
                  "cornell_s": time.perf_counter() - t0, **extra}}
    for name in SUBS:               # the headline is safe from here on
        _log(f"sub {name}")
        result["extra"][name] = run_sub(name, args)
    result["extra"]["wall_s"] = time.perf_counter() - t0
    print(json.dumps(result))
    bad = failed(result)
    if bad:
        print(f"lumo_tpu_torch.bench: failed subs: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
