"""Rendering over several devices: the port's ``parallel/`` on
``torch.distributed`` (gloo, ranks on the CPU) against one device and
against the JAX package's 8-device virtual mesh (conftest), the
counterpart of ``tests/test_parallel.py`` and ``tests/test_distributed.py``.

Per-ray radiance is bit-equal however the rays are split (counter-based
draws).  Two ranks spawned once for the module (``_torch_shard_worker``,
one intra-op thread each, a ``file://`` rendezvous) render the Cornell box
at 16^2, 4 spp in two steps of 2 through ``.devices(2)``: the path,
direct-light and bidirectional images and the stream's equal the
one-device images within rtol 1e-4, atol 1e-5 (the summed films add in
another order), and both ranks hold the same image bit for bit.  The
stream compares at the fixed Russian-roulette threshold: its adaptive
threshold follows each rank's own running stats while it runs, as the
JAX package's does, so a few samples end at other depths.  ``pmean``'d
gradients of the two ranks' halves equal the one-process gradient within
rtol 2e-4, atol 1e-6.

Against JAX: the Cornell box's light lies in the ceiling's plane, so a
few lanes meet the light on one side and the ceiling on the other
(topology flips, already at one device).  So the radiance is held to
``test_torch_path_trace.py``'s tolerance with at most 1% of lanes
flipped, the gradients to ``test_torch_grad.py``'s with the flipped lanes
weighted out, and the image to ``test_torch_renderer.py``'s bar on that
file's empty box.
"""
import dataclasses
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P

import _torch_shard_worker as worker
from lumo_tpu import camera as jcamera
from lumo_tpu.integrators import direct_light as jdl
from lumo_tpu.integrators import path_trace as jpt
from lumo_tpu.parallel import mesh as jmesh
from lumo_tpu.renderer import Renderer as JRenderer
from lumo_tpu.scene.cornell import cornell_box as jcornell_box
from lumo_tpu.scene.cornell import empty_box as jempty_box
from lumo_tpu.scene.materials import Material as JMaterial
from lumo_tpu_torch import film as tfilm
from lumo_tpu_torch.integrators import direct_light as tdl
from lumo_tpu_torch.integrators import path_trace as tpt
from lumo_tpu_torch.parallel import distributed
from lumo_tpu_torch.parallel import mesh as tmesh
from lumo_tpu_torch.renderer import Renderer

RES = worker.RES
N = RES * RES
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INTEGRATE = {
    "path": (lambda s, o, d, lam, k: tpt.integrate(s, o, d, lam,
                                                   ray_key=k)[0],
             lambda s, o, d, lam, k: jpt.integrate(s, o, d, lam,
                                                   ray_key=k)[0]),
    "direct": (lambda s, o, d, lam, k: tdl.integrate(s, o, d, lam,
                                                     ray_key=k)[0],
               lambda s, o, d, lam, k: jdl.integrate(s, o, d, lam,
                                                     ray_key=k)[0]),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small wavefronts: intra-op threads gain nothing, and under parallel
    test workers every process's threads contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cornell():
    return worker.cornell("cpu")


def _jax_rays(o, d, lam, key):
    return (jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
            jnp.asarray(lam.numpy()),
            jnp.asarray(key.numpy().astype(np.uint32)))


@pytest.fixture(scope="module")
def flip_weights(cornell):
    """1 on the gradient rays whose prims agree at both bounces in the
    port and the JAX package, 0 on the flipped ones."""
    scene, camera = cornell
    rays = worker.grad_rays(camera, N)
    prims_t = tpt.integrate(scene, *rays[:3], ray_key=rays[3], fixed_depth=2,
                            trace_prims=True)[3]
    o, d, lam, key = _jax_rays(*rays)
    prims_j = jpt.integrate(jcornell_box().build(), o, d, lam, ray_key=key,
                            fixed_depth=2, trace_prims=True)[3]
    same = (prims_t.numpy() == np.asarray(prims_j)).all(axis=0)
    assert (~same).sum() <= N // 100
    return same.astype(np.float32)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, flip_weights):
    """What each of two gloo ranks computed (``render_ranks``)."""
    tmp = tmp_path_factory.mktemp("ranks")
    worker.spawn(worker.render_ranks, 2, f"file://{tmp}/rendezvous",
                 str(tmp), flip_weights)
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(2)]


@pytest.mark.parametrize("which", ["path", "direct"])
def test_sharded_radiance_bit_exact(cornell, which):
    """Per-ray radiance of 1,024 of the Renderer's samples is bit-equal
    whole and as 8 contiguous shards; JAX's shard_map over 8 devices
    agrees within rtol 1e-4, atol 1e-6 off at most 1% flipped lanes."""
    scene, camera = cornell
    port, ref = INTEGRATE[which]
    smp = Renderer(scene, camera)._sample_gen(4)(torch.arange(4 * N))
    rays = [smp[k] for k in ("o", "d", "lam", "rng")]
    whole = port(scene, *rays)
    shards = torch.cat([port(scene, *part)
                        for part in zip(*(x.chunk(8) for x in rays))])
    assert torch.equal(whole, shards)
    assert whole.sum() > 0

    mesh = jmesh.make_mesh(8)
    js = jcornell_box().build()
    fn = shard_map(lambda o, d, lam, k: ref(js, o, d, lam, k), mesh=mesh,
                   in_specs=(P(jmesh.AXIS),) * 4, out_specs=P(jmesh.AXIS),
                   check_rep=False)
    sharded = np.asarray(jax.jit(fn)(*_jax_rays(*rays)))
    close = np.isclose(whole.numpy(), sharded, rtol=1e-4,
                       atol=1e-6).all(axis=-1)
    assert (~close).sum() <= 4 * N // 100, f"{(~close).sum()} lanes differ"


@pytest.mark.parametrize("kind", worker.INTEGRATORS)
def test_renderer_sharded_image_matches_single(cornell, ranks, kind):
    scene, camera = cornell
    one = worker.renderer(scene, camera, kind).devices(1).render(
        verbose=False)
    img = ranks[0]["images"][kind]
    assert np.array_equal(img, ranks[1]["images"][kind])
    assert img.shape == (RES, RES, 3) and np.isfinite(img).all()
    assert img.mean() > 0.05
    np.testing.assert_allclose(img, one, rtol=1e-4, atol=1e-5)
    if kind == "stream":
        # the adaptive threshold: local to each rank while the stream runs
        one = worker.renderer(scene, camera, "stream-adaptive").render(
            verbose=False)
        img = ranks[0]["images"]["stream-adaptive"]
        assert np.array_equal(img, ranks[1]["images"]["stream-adaptive"])
        close = np.isclose(img, one, rtol=1e-4, atol=1e-5).all(axis=-1)
        assert close.mean() >= 0.95
        assert abs(img.mean() - one.mean()) <= 1e-3 * one.mean()


def test_default_devices_is_the_world(cornell, ranks):
    """``Renderer`` without ``.devices`` spans the process group."""
    scene, camera = cornell
    one = worker.renderer(scene, camera, "path").render(verbose=False)
    np.testing.assert_allclose(ranks[0]["default"], one, rtol=1e-4,
                               atol=1e-5)
    assert np.array_equal(ranks[0]["default"], ranks[0]["images"]["path"])


def test_two_rank_image_matches_jax_8_devices(ranks):
    """The empty box's 2-rank path image against the JAX Renderer over
    8 devices, same seed and samples: 99% of pixels within rtol 1e-3,
    atol 1e-6, the mean within 1e-3."""
    sb = jempty_box((0.9, 0.9, 0.9), JMaterial.diffuse((0.8, 0.2, 0.2)),
                    JMaterial.diffuse((0.2, 0.8, 0.2)))
    ref = (JRenderer(sb.build(), jcamera.build_camera(resolution=(RES, RES)))
           .samples(worker.SPP).seed(worker.SEED)
           .batch_samples(worker.BATCH).devices(8).render(verbose=False))
    img = ranks[0]["empty_box"]
    close = np.isclose(img, ref, rtol=1e-3, atol=1e-6).all(axis=-1)
    assert close.mean() >= 0.99, f"{(~close).sum()} pixels differ"
    assert abs(float(img.mean()) - float(ref.mean())) <= 1e-3


def test_sharded_grads_pmean_correct(cornell, ranks, flip_weights):
    """``pmean`` of two ranks' gradients of mean(r^2) at fixed depth 2 ==
    the one-process gradient (rtol 2e-4, atol 1e-6); with the flipped
    lanes weighted out, == JAX's pmean over 8 devices (rtol 1e-4 plus
    1e-5 of the largest entry)."""
    scene, camera = cornell
    rays = worker.grad_rays(camera, N)
    g1 = worker.r2_grads(scene, *rays)
    for k in g1:
        assert torch.equal(ranks[0]["grads"][k], ranks[1]["grads"][k])
        np.testing.assert_allclose(ranks[0]["grads"][k].numpy(),
                                   g1[k].numpy(), rtol=2e-4, atol=1e-6,
                                   err_msg=k)
    assert g1["kd"].abs().max() > 0 and g1["ke"].abs().max() > 0

    js = jcornell_box().build()
    is_float = {k: jnp.issubdtype(v.dtype, jnp.floating)
                for k, v in js.materials.items()}

    def loss(mats, o, d, lam, key, w):
        materials = {k: mats[k] if is_float[k] else v
                     for k, v in js.materials.items()}
        scene_j = dataclasses.replace(js, materials=materials)
        r = jpt.integrate(scene_j, o, d, lam, ray_key=key, fixed_depth=2)[0]
        return jnp.mean(w[:, None] * r ** 2)

    def shard_fn(mats, *args):
        g = jax.grad(loss)(mats, *args)
        return jax.tree.map(lambda x: jax.lax.pmean(x, jmesh.AXIS), g)

    sharded = shard_map(shard_fn, mesh=jmesh.make_mesh(8),
                        in_specs=(P(),) + (P(jmesh.AXIS),) * 5,
                        out_specs=P(), check_rep=False)
    g8 = jax.jit(sharded)({k: v for k, v in js.materials.items()
                           if is_float[k]}, *_jax_rays(*rays),
                          jnp.asarray(flip_weights))
    for k, want in g8.items():
        want = np.asarray(want)
        np.testing.assert_allclose(
            ranks[0]["grads_weighted"][k].numpy(), want, rtol=1e-4,
            atol=1e-5 * max(float(np.abs(want).max()), 1e-30), err_msg=k)


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_render_matches_single(cornell):
    """Two processes joined by ``initialize(coordinator="localhost:port",
    ...)`` render the default Renderer (devices from the world size) and
    print the same checksum, which matches one process within rtol 2e-6
    (``tests/test_distributed.py``'s bar)."""
    port = _free_port()
    script = os.path.join(ROOT, "tests", "_torch_shard_worker.py")
    procs = [subprocess.Popen([sys.executable, script, str(port), str(i)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, cwd=ROOT)
             for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=worker.SPAWN_TIMEOUT_S)
            assert p.returncode == 0, err[-3000:]
            outs.append((out, err))
    finally:
        for p in procs:
            p.kill()
    sums = []
    for out, err in outs:
        line = [ln for ln in out.splitlines() if ln.startswith("CHECKSUM")]
        assert line, out
        sums.append(tuple(float(x) for x in line[-1].split()[1:]))
        assert "1 local / 2 global devices" in err
    assert sums[0] == sums[1], sums
    scene, camera = cornell
    img = worker.renderer(scene, camera, "path", spp=8, seed=7).render(
        verbose=False).astype(np.float64)
    ref = (img.sum(), np.abs(img).max())
    assert np.allclose(sums[0], ref, rtol=2e-6), (sums[0], ref)


def test_shard_step_on_one_rank_equals_step(cornell, tmp_path):
    """``shard_step`` over a one-rank gloo group (its ``all_reduce`` runs)
    equals ``shard_step`` over the groupless one-rank mesh, the
    Renderer's one-device step, bit for bit; ``psum`` and ``pmean`` keep
    each leaf's dtype; ``initialize`` called twice joins once."""
    scene, camera = cornell
    r = worker.renderer(scene, camera, "path")
    work = r._make_work(2, worker.SPP)
    film = tuple(torch.full_like(x, 0.5)
                 for x in tfilm.new_film((RES, RES), device="cpu"))
    stats = {k: torch.full_like(v, 2.0) for k, v in r.new_stats(N).items()}
    local = tmesh.make_mesh()
    assert (local.size, local.rank, local.group) == (1, 0, None)
    want = tmesh.shard_step(local, work, 2 * N)(film, stats, 2)
    for _ in range(2):      # idempotent: the second call joins nothing
        distributed.initialize(coordinator=f"file://{tmp_path}/rendezvous",
                               num_processes=1, process_id=0, device="cpu")
    try:
        mesh = tmesh.make_mesh()
        assert (mesh.size, mesh.rank, mesh.group is not None) == (1, 0, True)
        assert tmesh.make_mesh(1).group is None
        got = tmesh.shard_step(mesh, work, 2 * N)(film, stats, 2)
        tree = {"a": torch.arange(3), "b": (torch.ones(2, 2),)}
        summed = tmesh.psum(tree, mesh)
        mean = tmesh.pmean({"g": torch.full((3,), 3.0)}, mesh)
    finally:
        distributed.shutdown()
    for a, b in zip(got[0], want[0]):
        assert torch.equal(a, b)
    for k in want[1]:
        assert torch.equal(got[1][k], want[1][k])
    assert got[2].dtype == want[2].dtype and int(got[2]) == int(want[2])
    assert summed["a"].dtype == torch.int64
    assert torch.equal(summed["a"], tree["a"])
    assert torch.equal(summed["b"][0], tree["b"][0])
    assert torch.equal(mean["g"], torch.full((3,), 3.0))


def test_external_group_render(cornell, ranks):
    """In a group joined by ``torch.distributed.init_process_group``
    (torchrun's way, not ``initialize``) the default Renderer spans the
    world and equals one device within rtol 1e-4, atol 1e-5, and
    ``.devices(1)`` renders this rank alone, bit-equal to one device."""
    scene, camera = cornell
    one = worker.renderer(scene, camera, "path").render(verbose=False)
    for out in ranks:
        np.testing.assert_allclose(out["external"]["default"], one,
                                   rtol=1e-4, atol=1e-5)
        assert np.array_equal(out["external"]["one"], one)
    assert np.array_equal(ranks[0]["external"]["default"],
                          ranks[1]["external"]["default"])


@pytest.mark.parametrize("case", ["no_group", "pixels", "stream_samples",
                                  "ranks_disagree", "other_device",
                                  "no_card"])
def test_multi_device_errors(cornell, ranks, case):
    scene, camera = cornell
    if case == "no_group":
        with pytest.raises(ValueError, match="distributed.initialize"):
            Renderer(scene, camera).devices(2).render(verbose=False)
    elif case == "pixels":
        with pytest.raises(ValueError, match="pixel count 256 must be "
                                             "divisible by 3 devices"):
            Renderer(scene, camera).devices(3).render(verbose=False)
    elif case == "stream_samples":
        # unreachable through render (the pixel count divides first); the
        # stream's own check, as the JAX package keeps it
        r = Renderer(scene, camera).samples(1).stream()
        with pytest.raises(ValueError, match="samples 256 must divide over "
                                             "3 devices"):
            r._render_stream(tmesh.Mesh(None, 3, 0, scene.device))
    elif case == "ranks_disagree":
        # each rank another seed: every rank raises, none waits
        for out in ranks:
            assert out["disagree"].startswith("the ranks disagree on")
    elif case == "other_device":
        assert ranks[0]["other_device"] == ("the scene is on meta, this "
                                            "rank's device is cpu")
    elif not torch.cuda.is_available():
        # initialize, as every entry point, runs on the card unless asked
        with pytest.raises(RuntimeError, match="no CUDA device"):
            distributed.initialize(num_processes=1, process_id=0)
    else:
        assert distributed._rank_device(None, 0).type == "cuda"


def test_process_summary(ranks):
    assert ranks[0]["summary"] == "process 0/2, 1 local / 2 global devices"
    assert ranks[1]["summary"] == "process 1/2, 1 local / 2 global devices"
    assert ranks[0]["multi"] and ranks[1]["multi"]
    assert not distributed.is_multi_process()
    assert distributed.process_summary() == ("process 0/1, 1 local / 1 "
                                             "global devices")
