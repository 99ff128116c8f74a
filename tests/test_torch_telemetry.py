"""The port's spans and counters (``lumo_tpu_torch/telemetry.py``): on
exactly while a torch profiler records, and no work of their own.

With no profiler a render records no span or counter but the ``setup.*``
spans, and its image is bit-equal to the same render under the profiler;
so are a fixed-depth step's gradients.  Under the profiler the lane
counters count each bounce of the liveness-tested loop, the live lanes
being the Renderer's ray count (its fold's Σ(depth + 1) over the same
samples), every bounce phase lies inside its bounce on the profiler's
clock, a query
operator's first call in the process is recorded once, and the material
table reads of a fixed-depth bounce are the same at every bounce.  No
JAX call: CPU, 16² images or 256 lanes."""
import ctypes.util
import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from _torch_port import blob_box
from lumo_tpu_torch import telemetry
from lumo_tpu_torch.accel import bvh_kernel, cuda_build
from lumo_tpu_torch.camera import build_camera, cornell_camera
from lumo_tpu_torch.color import wavelength
from lumo_tpu_torch.integrators import path_trace
from lumo_tpu_torch.renderer import Renderer
from lumo_tpu_torch.sampling.samplers import _hash_u32, _randfloat
from lumo_tpu_torch.scene import trace
from lumo_tpu_torch.scene.cornell import cornell_box

RES = 16
SPP = 4
LANES = 256


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean_registry():
    telemetry.reset()
    yield
    telemetry.reset()


@pytest.fixture(scope="module")
def scenes():
    """name -> (scene, camera): the dense Cornell box, the blob through
    the BVH and through the kd-tree."""
    cam = build_camera(resolution=(RES, RES), device="cpu")
    return {
        "cornell": (cornell_box().build(device="cpu"),
                    cornell_camera(resolution=(RES, RES), device="cpu")),
        "bvh": (blob_box("lumo_tpu_torch", 2).build(device="cpu"), cam),
        "kdtree": (blob_box("lumo_tpu_torch", 2).build(accel="kdtree",
                                                       device="cpu"), cam),
    }


def _renderer(scenes, name, stream=False):
    scene, cam = scenes[name]
    return (Renderer(scene, cam).samples(SPP).batch_samples(2)
            .fixed_rr_delta(1.0).stream(stream))


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def _lanes(camera, n=LANES):
    idx = torch.arange(n)
    pix = idx % (RES * RES)
    raster = torch.stack([(pix % RES).float() + 0.5,
                          (pix // RES).float() + 0.5], -1)
    o, d = camera.generate_ray(raster, torch.full_like(raster, 0.5))
    lam = wavelength.sample(_randfloat(idx, 0x1234))
    return o, d, lam, _hash_u32(idx ^ 0x9E3779B9)


def test_off_is_one_null_context():
    assert not telemetry.on()
    a, b = telemetry.span("path.bounce"), telemetry.span("render.step")
    assert a is b
    with a:
        pass
    assert telemetry.snapshot()["spans"] == {}


def test_setup_spans_record_without_a_profiler():
    with telemetry.span("setup.x") as outer:
        with telemetry.span("setup.y"):
            pass
    spans = telemetry.snapshot()["spans"]
    assert outer.seconds > 0 and spans["setup.x"]["n"] == 1
    assert spans["setup.x"]["self_ns"] == (spans["setup.x"]["host_ns"]
                                           - spans["setup.y"]["host_ns"])


def test_spans_nest_under_the_profiler():
    def body():
        assert telemetry.on()
        with telemetry.span("a"):
            for _ in range(2):
                with telemetry.span("b"):
                    torch.ones(8).sum()
        telemetry.add("c", 3)
    _, prof = _profiled(body)
    snap = telemetry.snapshot()
    a, b = snap["spans"]["a"], snap["spans"]["b"]
    assert (a["n"], b["n"]) == (1, 2) and snap["counters"]["c"] == 3
    assert a["self_ns"] == a["host_ns"] - b["host_ns"] >= 0
    assert b["self_ns"] == b["host_ns"]
    names = [e.name for e in prof.events()]
    assert names.count("lumo.a") == 1 and names.count("lumo.b") == 2


def test_launch_counters_since_reset(monkeypatch):
    monkeypatch.setitem(bvh_kernel.LAUNCHES, "closest",
                        bvh_kernel.LAUNCHES["closest"] + 5)
    telemetry.reset()
    monkeypatch.setitem(bvh_kernel.LAUNCHES, "closest",
                        bvh_kernel.LAUNCHES["closest"] + 3)
    c = telemetry.snapshot()["counters"]
    assert c["launches.bvh.closest"] == 3 and c["launches.kd.any"] == 0


def test_kernel_load_is_a_setup_span(monkeypatch):
    lib = cuda_build.Library("libm_stand_in", {})
    lib.so = ctypes.util.find_library("m") or "libm.so.6"
    monkeypatch.setattr(lib, "stale", lambda: False)
    lib.load()
    lib.load()
    assert lib.load_span.seconds > 0
    assert telemetry.snapshot()["spans"]["setup.kernel_load"]["n"] == 1


@pytest.mark.parametrize("name,stream", [("cornell", False), ("bvh", False),
                                         ("cornell", True)])
def test_render_off_records_nothing_and_image_is_bit_equal(scenes, name,
                                                           stream):
    r = _renderer(scenes, name, stream)
    off = r.render(verbose=False)
    snap = telemetry.snapshot()
    assert all(k.startswith("setup.") for k in snap["spans"])
    assert all(k.startswith("launches.") and v == 0
               for k, v in snap["counters"].items())
    on, _ = _profiled(lambda: r.render(verbose=False))
    np.testing.assert_array_equal(on.view(np.int32), off.view(np.int32))
    snap = telemetry.snapshot()
    assert snap["counters"]["lanes.alive"] > 0
    assert snap["spans"]["sync.readback"]["n"] == 1


@pytest.mark.parametrize("name", ["cornell", "bvh"])
def test_rays_steps_and_lanes(scenes, name):
    r = _renderer(scenes, name)
    _profiled(lambda: r.render(verbose=False))
    snap = telemetry.snapshot()
    spans, c = snap["spans"], snap["counters"]
    # the same samples through integrate: a lane is alive entering each
    # bounce up to the one that ends it, so the live lanes are the fold's
    # ray count Σ(depth + 1), but for a lane that outlives the last bounce
    scene, _ = scenes[name]
    gen = r._sample_gen(SPP)
    rays = 0
    for b in range(SPP // 2):
        smp = gen(torch.arange(RES * RES * 2) + b * 2 * RES * RES)
        _, _, depth = path_trace.integrate(scene, smp["o"], smp["d"],
                                           smp["lam"], ray_key=smp["rng"])
        rays += int(torch.clamp(depth + 1, max=path_trace.MAX_DEPTH).sum())
    assert c["lanes.alive"] == rays
    assert spans["render.step"]["n"] == SPP // 2
    for k in ("render.camera", "render.integrate", "render.fold"):
        assert spans[k]["n"] == SPP // 2
    assert c["lanes.total"] == RES * RES * 2 * spans["path.bounce"]["n"]
    assert 0 < c["lanes.alive"] <= c["lanes.total"]
    assert spans["sync.alive"]["n"] == spans["path.bounce"]["n"] + SPP // 2


def test_bounce_phases_lie_inside_bounces(scenes):
    r = _renderer(scenes, "bvh")
    _, prof = _profiled(lambda: r.render(verbose=False))
    ev = prof.events()
    bounces = sorted((e.time_range.start, e.time_range.end) for e in ev
                     if e.name == "lumo.path.bounce")
    phases = [e for e in ev if e.name == "lumo.path.intersect"]
    assert bounces and len(phases) == len(bounces)
    for e in phases:
        assert any(a <= e.time_range.start and e.time_range.end <= b
                   for a, b in bounces)


@pytest.mark.parametrize("name", ["bvh", "kdtree"])
def test_first_query_once_per_operator(scenes, name, monkeypatch):
    monkeypatch.setattr(trace, "_CALLED", set())
    r = _renderer(scenes, name)
    r.render(verbose=False)
    r.render(verbose=False)
    # one closest-hit and one any-hit operator, each once
    assert telemetry.snapshot()["spans"]["setup.first_query"]["n"] == 2


def _leaves(scene):
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in scene.materials.items() if v.is_floating_point()}
    return dataclasses.replace(scene, materials={**scene.materials,
                                                 **leaves}), leaves


@pytest.mark.parametrize("checkpoint", [False, True])
def test_gradients_bit_equal_on_and_off(scenes, checkpoint):
    scene, leaves = _leaves(scenes["cornell"][0])
    o, d, lam, key = _lanes(scenes["cornell"][1])

    def step():
        r, _, _ = path_trace.integrate(scene, o, d, lam, ray_key=key,
                                       fixed_depth=3, checkpoint=checkpoint)
        g = torch.autograd.grad((r * r).mean(), list(leaves.values()),
                                allow_unused=True)
        return [x.numpy().copy() for x in g if x is not None]
    off = step()
    on, _ = _profiled(step)
    for a, b in zip(off, on):
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))
    # a checkpointed bounce's recompute records its spans again
    n = telemetry.snapshot()["spans"]["path.bounce"]["n"]
    assert n == (6 if checkpoint else 3)


@pytest.mark.parametrize("name,grad", [("cornell", False), ("cornell", True),
                                       ("bvh", True)])
def test_table_gathers_same_every_bounce(scenes, name, grad):
    scene, cam = scenes[name]
    if grad:
        scene, _ = _leaves(scene)
    s = path_trace.initial_state(*_lanes(cam))
    counts = []

    def bounces():
        nonlocal s
        for _ in range(4):
            before = telemetry.snapshot()["counters"].get(
                "bsdf.table_gathers", 0)
            s = path_trace.bounce(scene, s, 1.0)
            counts.append(telemetry.snapshot()["counters"][
                "bsdf.table_gathers"] - before)
    _profiled(bounces)
    assert counts[0] > 0 and counts == counts[:1] * 4
    assert counts[0] == {"cornell": 20, "bvh": 25}[name]


def test_verbose_lines_keep_their_format(scenes, capsys):
    r = _renderer(scenes, "cornell")
    r.render(verbose=True)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("  batch 1/2  ") and "Mray/s  ETA" in lines[0]
    assert lines[-1].startswith(f"Rendered {RES}x{RES}@{SPP}spp on 1 "
                                "device(s) (cpu): ")
    assert lines[-1].endswith(" Mray/s") and " Mrays in " in lines[-1]
