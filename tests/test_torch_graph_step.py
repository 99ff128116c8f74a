"""The fixed-depth step as a CUDA graph (``integrators/graph_step.py``).

On the CPU every fixed-depth call runs eagerly and equals the eager step;
``checkpoint`` and forward mode take the eager route whatever the device;
the key changes with the depth, the lane count, a replaced material
table, ``trace_prims`` and grad mode, and only with what shapes the step;
two calls' outputs share no memory.  CPU tests: 16² or 256 lanes, no JAX.

On a card (the tests marked ``cuda``, skipped without one): three calls
with one key (eager, capture, replay) give the eager step's radiance,
loss and gradients at the same rays, on the dense Cornell box at depth 6
and on a K2 scene at depth 4; a replay after an in-place update of a
leaf table reads the new values; alternating keys never capture; and
under a profiler a replayed step counts the eager step's table reads,
bounces and K2 launches; a step that cannot be captured warns and stays
eager.  The file imports neither JAX nor lumo_tpu:

    python -m pytest --noconftest -q tests/test_torch_graph_step.py
"""
import dataclasses
from unittest import mock

import pytest
import torch
from torch.autograd import forward_ad
from torch.profiler import ProfilerActivity, profile

from _torch_port import blob_box
from lumo_tpu_torch import telemetry
from lumo_tpu_torch.accel import bvh_kernel
from lumo_tpu_torch.bsdf import table_grad
from lumo_tpu_torch.camera import build_camera, cornell_camera
from lumo_tpu_torch.color import wavelength
from lumo_tpu_torch.integrators import graph_step, path_trace
from lumo_tpu_torch.sampling.samplers import _hash_u32, _randfloat
from lumo_tpu_torch.scene.cornell import cornell_box

RES = 16
CARD_RES = 64


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_state():
    telemetry.reset()
    graph_step._step = graph_step._last = graph_step._refused = None
    yield
    graph_step._step = graph_step._last = graph_step._refused = None
    telemetry.reset()


def _leaves(scene):
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in scene.materials.items() if v.is_floating_point()}
    return dataclasses.replace(scene, materials={**scene.materials,
                                                 **leaves}), leaves


def _rays(camera, res, salt=0, dev="cpu"):
    """One sample at each of res² pixels, drawn by ``salt``."""
    idx = torch.arange(res * res, device=dev)
    raster = torch.stack([(idx % res).float() + 0.5,
                          (idx // res).float() + 0.5], -1)
    u = torch.stack([_randfloat(idx ^ salt, 0x51), _randfloat(idx ^ salt,
                                                               0x52)], -1)
    o, d = camera.generate_ray(raster, u)
    lam = wavelength.sample(_randfloat(idx ^ salt, 0x1234))
    return o, d, lam, _hash_u32(idx ^ 0x9E3779B9 ^ salt)


@pytest.fixture(scope="module")
def cornell():
    return (cornell_box().build(device="cpu"),
            cornell_camera(resolution=(RES, RES), device="cpu"))


def _counters():
    return telemetry.snapshot()["counters"]


def test_cpu_never_captures_and_equals_eager(cornell):
    scene, cam = cornell
    scene, _ = _leaves(scene)
    rays = _rays(cam, RES)
    eager = path_trace._fixed_depth(scene, *rays, 1.0, 3, True, False)
    with profile(activities=[ProfilerActivity.CPU]):
        outs = [path_trace.integrate(scene, *rays[:3], ray_key=rays[3],
                                     fixed_depth=3, trace_prims=True)
                for _ in range(3)]
    c = _counters()
    assert c.get("path.graph.eager") == 3
    assert "path.graph.capture" not in c and "path.graph.replay" not in c
    assert graph_step._step is None
    for out in outs:
        for a, b in zip(out, eager):
            assert torch.equal(a, b)


@pytest.mark.parametrize("mode", ["checkpoint", "dual", "torch.func"])
def test_checkpoint_and_forward_mode_are_eager(cornell, mode):
    scene, cam = cornell
    o, d, lam, key = _rays(cam, RES)
    tensors = [o, d, lam, key]
    if mode == "checkpoint":
        assert graph_step.eager_reason(scene, tensors, True) == "checkpoint"
    elif mode == "dual":
        with forward_ad.dual_level():
            dual = forward_ad.make_dual(o, torch.ones_like(o))
            assert graph_step.eager_reason(scene, [dual, d, lam, key],
                                           False) == "forward mode"
    else:
        seen = []

        def f(x):
            seen.append(graph_step.eager_reason(scene, [x, d, lam, key],
                                                False))
            return x * 2.0
        torch.func.jvp(f, (o,), (torch.ones_like(o),))
        assert seen == ["forward mode"]
    # with neither, only the device sends a CPU call to the eager route
    assert graph_step.eager_reason(scene, tensors, False) == "device"


def _key(scene, rays, depth=3, trace_prims=False, delta=1.0):
    return graph_step.key(scene, *rays, delta, depth, trace_prims)


@pytest.mark.parametrize("change", ["depth", "lanes", "table", "trace_prims",
                                    "grad_mode", "delta", "nothing"])
def test_key_follows_what_shapes_the_step(cornell, change):
    scene, cam = cornell
    scene, leaves = _leaves(scene)
    rays = _rays(cam, RES)
    before = _key(scene, rays)
    other = _rays(cam, RES, salt=77)   # same shapes, other values
    if change == "depth":
        after = _key(scene, other, depth=4)
    elif change == "lanes":
        after = _key(scene, tuple(x[:128] for x in other))
    elif change == "table":
        # the same scene object, one table replaced in its dict
        scene.materials["kd"] = leaves["kd"].detach().clone()
        after = _key(scene, other)
    elif change == "trace_prims":
        after = _key(scene, other, trace_prims=True)
    elif change == "grad_mode":
        with torch.no_grad():
            after = _key(scene, other)
    elif change == "delta":
        after = _key(scene, other, delta=0.5)
    else:
        after = _key(scene, other)
    assert (after == before) == (change == "nothing")


def test_outputs_not_aliased(cornell):
    scene, cam = cornell
    scene, leaves = _leaves(scene)
    rays = _rays(cam, RES)
    outs = []
    for _ in range(2):
        r, lam_out, depth = path_trace.integrate(
            scene, *rays[:3], ray_key=rays[3], fixed_depth=2)
        g = torch.autograd.grad((r * r).mean(), list(leaves.values()),
                                allow_unused=True)
        outs.append([r, lam_out, depth] + [x for x in g if x is not None])
    for a, b in zip(*outs):
        assert a.data_ptr() != b.data_ptr()
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# on the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU mode")
    return torch.device("cuda")


def _card_scene(name, card):
    if name == "cornell":
        scene = cornell_box().build(device=card)
        cam = cornell_camera(resolution=(CARD_RES, CARD_RES), device=card)
    else:
        scene = blob_box("lumo_tpu_torch", 3).build(device=card)
        cam = build_camera(resolution=(CARD_RES, CARD_RES), device=card)
    return scene, cam


def _grad_step(fn, scene, leaves, rays, depth):
    """(radiance, loss, gradients of the leaves and of ``o``) of one
    fixed-depth step ``fn`` with ``o`` a leaf that requires grad."""
    o = rays[0].detach().clone().requires_grad_(True)
    r, lam_out, _ = fn(scene, o, *rays[1:], depth)
    loss = (r * r).mean() + (lam_out * 1e-6).mean()
    wrt = list(leaves.values()) + [o]
    g = torch.autograd.grad(loss, wrt, allow_unused=True)
    return [r.detach(), loss.detach()] + [x for x in g if x is not None]


def _graphed(scene, o, d, lam, key, depth):
    return path_trace.integrate(scene, o, d, lam, ray_key=key,
                                fixed_depth=depth)


def _eager(scene, o, d, lam, key, depth):
    return path_trace._fixed_depth(scene, o, d, lam, key, 1.0, depth, False,
                                   False)


@pytest.mark.cuda
@pytest.mark.parametrize("name,depth", [("cornell", 6), ("k2", 4)])
def test_capture_and_replay_equal_eager(card, name, depth):
    scene, cam = _card_scene(name, card)
    scene, leaves = _leaves(scene)
    k2 = bvh_kernel.LAUNCHES["closest"]
    kept = None
    for call in range(3):
        rays = _rays(cam, CARD_RES, salt=call, dev=card)
        got = _grad_step(_graphed, scene, leaves, rays, depth)
        assert (graph_step._step is None) == (call == 0)
        if call:
            assert graph_step._step.gen == call
        want = _grad_step(_eager, scene, leaves, rays, depth)
        assert len(got) == len(want) > 2
        for a, b in zip(got, want):
            assert torch.equal(a, b), (call, (a - b).abs().max())
        if kept is not None:
            # the previous call's outputs and gradients are its own
            for a, b in zip(*kept):
                assert torch.equal(a, b)
        kept = (got, [x.clone() for x in got])
    if name == "k2":
        # each step launches K2 once a bounce, graphed or eager
        assert bvh_kernel.LAUNCHES["closest"] - k2 == 6 * depth


@pytest.mark.cuda
def test_replay_reads_an_updated_leaf(card):
    scene, cam = _card_scene("cornell", card)
    scene, leaves = _leaves(scene)
    rays = _rays(cam, CARD_RES, dev=card)
    for _ in range(2):                            # eager, then the capture
        _grad_step(_graphed, scene, leaves, rays, 3)
    with torch.no_grad():
        for v in leaves.values():
            v.mul_(0.75)
    got = _grad_step(_graphed, scene, leaves, rays, 3)
    assert graph_step._step.gen == 2
    want = _grad_step(_eager, scene, leaves, rays, 3)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_alternating_keys_never_capture(card):
    scene, cam = _card_scene("cornell", card)
    scene, leaves = _leaves(scene)
    rays = _rays(cam, CARD_RES, dev=card)
    with profile(activities=[ProfilerActivity.CPU]):
        for depth in (4, 2) * 3:
            _grad_step(_graphed, scene, leaves, rays, depth)
            assert graph_step._step is None
    c = _counters()
    assert c.get("path.graph.eager") == 6 and "path.graph.capture" not in c


@pytest.mark.cuda
def test_replayed_counts_equal_eager(card):
    scene, cam = _card_scene("k2", card)
    scene, leaves = _leaves(scene)
    launches = lambda: (bvh_kernel.LAUNCHES["closest"],
                        sum(table_grad.LAUNCHES.values()))
    per_call = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for call in range(3):
            telemetry.reset()
            before = launches()
            _grad_step(_graphed, scene, leaves,
                       _rays(cam, CARD_RES, salt=call, dev=card), 4)
            snap = telemetry.snapshot()
            per_call.append((snap["counters"]["bsdf.table_gathers"],
                             snap["spans"]["path.bounce"]["n"],
                             snap["counters"]["launches.bvh.closest"],
                             launches()[1] - before[1]))
    eager, capture, replay = per_call
    assert eager == capture == replay
    assert eager[1] == 4 and eager[2] == 4 and eager[3] > 0


@pytest.mark.cuda
def test_a_step_that_cannot_be_captured_stays_eager(card):
    """The plain BVH route reads the live lanes' count on the host, which
    no capture can hold: the capture warns, the key stays eager, and the
    results are the eager step's."""
    scene, cam = _card_scene("k2", card)
    scene, leaves = _leaves(scene)
    rays = _rays(cam, CARD_RES, dev=card)
    plain = {"closest_hit": lambda bvh, tri, o, d, t_max=float("inf"):
             bvh_kernel.closest_hit_plain(bvh, tri, o, d, t_max),
             "any_hit": lambda bvh, tri, o, d, t_max=float("inf"):
             bvh_kernel.any_hit_plain(bvh, tri, o, d, t_max)}
    with mock.patch.multiple(bvh_kernel, **plain):
        want = _grad_step(_eager, scene, leaves, rays, 2)
        _grad_step(_graphed, scene, leaves, rays, 2)
        with pytest.warns(UserWarning, match="could not be captured"):
            got = _grad_step(_graphed, scene, leaves, rays, 2)
        again = _grad_step(_graphed, scene, leaves, rays, 2)
    assert graph_step._step is None and graph_step._refused is not None
    for a, b, c in zip(got, want, again):
        assert torch.equal(a, b) and torch.equal(c, b)
    # the card works on: the kernel route captures as before
    graph_step._refused = None
    for call in range(2):
        _grad_step(_graphed, scene, leaves, rays, 2)
    assert graph_step._step is not None
