"""The port's benchmark entry (``lumo_tpu_torch/bench.py``) and smoke gate
(``lumo_tpu_torch/tools/smoke.py``) against the JAX package's
``bench.py`` and ``tools/tpu_smoke.py``, on the CPU at small sizes.

Each package builds its own scene (``_torch_port.blob_box``, the Cornell
box) and traces the same rays: the smoke gate's numpy rays, the counter
hashes of the ``bvh`` sub and the stream, and explicit jitter,
wavelengths and ray keys for the headline (``jax.random`` stays out).

- (a) The smoke gate's closest and any hits at subdiv 3 against
  ``trace._closest``/``occluded``: prims equal, t within rtol 1e-5; the
  gate whole at subdiv 2, and a wrong kernel answer caught by its check
  against the plain walk.
- (b) The ``bvh`` sub's fwd+bwd (16², 2 spp, depth 4, mean(r^2)) against
  ``path_trace.integrate(fixed_depth=4)``: rays equal, loss within rtol
  1e-5, each material gradient within rtol 1e-4 plus 1e-5 of its largest
  entry (``test_torch_grad.py``'s bar).
- (c) The headline's fwd+bwd (Cornell 16², depth 6, mean(rgb^2)): the
  box's light lies in the ceiling's plane (ROADMAP.md section 3), so
  lanes whose per-bounce prims differ are counted (at most 1%) and
  weighted out; loss and gradients as in (b) on the rest, rays within
  what the flipped lanes can carry.  The JAX package runs op by op
  (``jax.disable_jit``) in (c) to (e): jitted, XLA's fused rounding moves
  more lanes across that plane (0.9% of lanes at depth 6 against 0.26%
  op by op, over ten and six seeds of (c)'s inputs).
- (d) The stream's rays (Cornell 16², 2 spp) equal batch mode's in the
  port bit for bit, and JAX's ``integrate_stream`` per sample but for at
  most 1% flipped samples.
- (e) The ``bdpt`` sub's per-lane depths (Cornell 8², 1 spp, bench.py's
  key formula) against ``bdpt.integrate`` under ``jax.disable_jit()``.
- (f) ``python -m lumo_tpu_torch.bench --cpu --res 8 --spp 1 --subdiv 2``:
  bench.py's keys in its last line and every sub present; an unknown
  ``--sub`` prints an error record and exits 1; a failed sub makes the
  entry exit 1 after it printed the line; without a card both entries
  raise.
"""
import dataclasses
import json
import os
import subprocess
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import blob_box, t
from lumo_tpu import film as jfilm
from lumo_tpu.camera import build_camera as jbuild_camera
from lumo_tpu.camera import cornell_camera as jcornell_camera
from lumo_tpu.color import wavelength as jwl
from lumo_tpu.integrators import bdpt as jbdpt
from lumo_tpu.integrators import path_trace as jpt
from lumo_tpu.sampling import samplers as jsamp
from lumo_tpu.scene import trace as jtrace
from lumo_tpu.scene.cornell import cornell_box as jcornell_box
from lumo_tpu_torch import bench
from lumo_tpu_torch import film as tfilm
from lumo_tpu_torch.accel import bvh_kernel, kd_kernel
from lumo_tpu_torch.camera import build_camera as tbuild_camera
from lumo_tpu_torch.camera import cornell_camera as tcornell_camera
from lumo_tpu_torch.graft_entry import pixel_rays
from lumo_tpu_torch.integrators import path_trace as tpt
from lumo_tpu_torch.scene import trace as ttrace
from lumo_tpu_torch.scene.cornell import cornell_box as tcornell_box
from lumo_tpu_torch.tools import smoke

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL_REL = 1e-4, 1e-5
RES = 16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small wavefronts: intra-op threads gain nothing, and under parallel
    test workers they contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, what):
    """``got`` (a tensor, None where no path reached the leaf) within
    rtol 1e-4 plus 1e-5 of ``want``'s largest entry."""
    want = np.asarray(want)
    got = np.zeros_like(want) if got is None else got.numpy()
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL_REL * max(scale, 1e-30),
                               err_msg=what)


def _jax_float_tables(js):
    return {k: v for k, v in js.materials.items()
            if jnp.issubdtype(v.dtype, jnp.floating)}


def _with(js, mats):
    return dataclasses.replace(js, materials={**js.materials, **mats})


# ---------------------------------------------------------------------------
# (a) the smoke gate

@pytest.mark.parametrize("accel,seed", [("bvh", 0), ("kdtree", 1)])
def test_smoke_queries_match_jax(accel, seed):
    n = 2048
    js = blob_box("lumo_tpu", 3).build(accel=accel)
    ts = bench.bench_scene("cpu", accel=accel, subdiv=3)
    o, d = smoke.rays(n, seed, "cpu")
    oj, dj = jnp.asarray(o.numpy()), jnp.asarray(d.numpy())
    mod = kd_kernel if accel == "kdtree" else bvh_kernel
    t_t, p_t, _, calls = smoke._closest(ts, o, d, mod)
    t_j, p_j = jtrace._closest(js, oj, dj, jnp.full((n,), 1e30))
    assert len(calls) == 1 and ts.n_tris == js.n_tris
    np.testing.assert_array_equal(p_t.numpy(), np.asarray(p_j))
    np.testing.assert_allclose(t_t.numpy(), np.asarray(t_j), rtol=1e-5)
    assert int((p_t >= 0).sum()) > n // 2
    occ_t = ttrace.occluded(ts, o, d, torch.full((n,), 3.0))
    occ_j = jtrace.occluded(js, oj, dj, jnp.full((n,), 3.0))
    np.testing.assert_array_equal(occ_t.numpy(), np.asarray(occ_j))
    smoke.check_against_walk(mod, calls[0])


def test_smoke_gate_runs_whole():
    out = smoke.run(subdiv=2, device="cpu")
    assert out["ok"] and out["backend"] == "cpu", out
    assert out["bvh_large"]["tris"] > out["bvh"]["tris"] == out["kd"]["tris"]
    for name in ("bvh", "bvh_large", "kd"):
        rec = out[name]
        assert rec["hits"] > rec["rays"] // 2 and rec["total_s"] > 0
        assert rec["vs_plain_walk"]["t"] == "bit-equal"
        assert rec["vs_plain_walk"]["hits"] > 0
    assert np.isfinite(out["bvh"]["gnorm"]) and out["bvh"]["gnorm"] > 0


def test_smoke_gate_reports_a_wrong_answer():
    """A closest-hit answer one ulp off on one ray fails the check against
    the plain walk: the scene gets an error record and ``ok`` is false,
    the other scenes still run."""
    real = bvh_kernel.closest_hit

    def off_by_an_ulp(*args, **kwargs):
        t_k, p_k = real(*args, **kwargs)
        hit = torch.nonzero(p_k >= 0)[:, 0]
        t_k = t_k.clone()
        t_k[hit[0]] = torch.nextafter(t_k[hit[0]], torch.tensor(np.inf))
        return t_k, p_k

    with mock.patch.object(bvh_kernel, "closest_hit", off_by_an_ulp):
        out = smoke.run(subdiv=1, device="cpu")
    assert not out["ok"]
    assert "plain walk" in out["bvh"]["error"]
    assert "plain walk" in out["bvh_large"]["error"]
    assert "error" not in out["kd"]


# ---------------------------------------------------------------------------
# (b) the bvh sub's fwd+bwd

def test_bvh_sub_fwd_bwd_matches_jax():
    spp, depth = bench.GRAD_SPP, bench.GRAD_DEPTH
    js = blob_box("lumo_tpu", 2).build()
    jc = jbuild_camera(resolution=(RES, RES))
    ts = bench.bench_scene("cpu", subdiv=2)
    tc = tbuild_camera(resolution=(RES, RES), device="cpu")
    n = RES * RES
    pix = jnp.arange(n, dtype=jnp.uint32)
    px, py = (pix % RES).astype(jnp.float32), (pix // RES).astype(jnp.float32)

    def loss_and_rays(mats, sp):        # bench.py:278-291
        jx = jsamp._randfloat(pix, sp ^ jnp.uint32(0x51633E2D))
        jy = jsamp._randfloat(pix, sp ^ jnp.uint32(0x68BC21EB))
        raster = jnp.stack([px + jx, py + jy], -1)
        oo, dd = jc.generate_ray(raster, jnp.full((n, 2), 0.5))
        ll = jwl.sample(jsamp._randfloat(pix, sp ^ jnp.uint32(0x02E5BE93)))
        rk = jsamp._hash_u32(pix ^ jsamp._hash_u32(sp))
        r, _, dep = jpt.integrate(_with(js, mats), oo, dd, ll, ray_key=rk,
                                  fixed_depth=depth)
        return jnp.mean(r ** 2), jnp.sum(dep) * 2

    step = jax.jit(jax.value_and_grad(loss_and_rays, has_aux=True))
    runs = [step(_jax_float_tables(js), jnp.uint32(sp))
            for sp in range(1, spp + 1)]            # one compile, two samples
    loss_j = sum(float(r[0][0]) for r in runs)
    rays_j = sum(int(r[0][1]) for r in runs)
    g_j = {k: sum(np.asarray(r[1][k]) for r in runs) for k in runs[0][1]}
    acc = bench.accumulate(ts, lambda sp: bench.grad_rays(tc, RES, sp, "cpu"),
                           range(1, spp + 1), depth, bench.loss_r2)
    assert int(acc["rays"]) == int(rays_j) > 0
    np.testing.assert_allclose(float(acc["loss"]), float(loss_j), rtol=1e-5)
    assert set(acc["grads"]) == set(g_j)
    for k, g in acc["grads"].items():
        _close(g, g_j[k], k)
    assert bench.gnorm(acc["grads"], spp) > 0


# ---------------------------------------------------------------------------
# (c) the headline's fwd+bwd

def test_cornell_headline_matches_jax():
    js = jcornell_box().build()
    jc = jcornell_camera(resolution=(RES, RES))
    ts = tcornell_box().build(device="cpu")
    tc = tcornell_camera(resolution=(RES, RES), device="cpu")
    n = RES * RES
    rng = np.random.default_rng(42)
    u = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    u_lam = rng.uniform(0, 1, n).astype(np.float32)
    key = rng.integers(0, 1 << 32, n, dtype=np.uint32)
    wbm = jnp.asarray(jfilm.wb_matrix(*bench.WB), jnp.float32)
    pix = jnp.arange(n, dtype=jnp.uint32)

    def jax_render(mats, w):            # bench.py:66-88 with explicit draws
        raster = jnp.stack([(pix % RES).astype(jnp.float32),
                            (pix // RES).astype(jnp.float32)], -1) + u
        o, d = jc.generate_ray(raster, jnp.full((n, 2), 0.5))
        r, lam_out, dep, prims = jpt.integrate(
            _with(js, mats), o, d, jwl.sample(jnp.asarray(u_lam)),
            ray_key=jnp.asarray(key), fixed_depth=bench.DEPTH,
            trace_prims=True)
        rgb = jfilm.spectral_to_rgb(r, lam_out, wbm)
        return jnp.mean(w[:, None] * rgb ** 2), (jnp.sum(dep) * 2, prims)

    rays_of = lambda _: (*bench.cornell_rays(tc, t(u), t(u_lam)), t(key))
    wbm_t = tfilm.wb_matrix(*bench.WB)
    rays_t = bench.accumulate(ts, rays_of, [0], bench.DEPTH,
                              bench.loss_rgb(wbm_t), backward=False)["rays"]
    o, d, lam, rk = rays_of(0)
    prims_t = tpt.integrate(ts, o, d, lam, ray_key=rk, fixed_depth=bench.DEPTH,
                            trace_prims=True)[3]
    mats_j = _jax_float_tables(js)
    with jax.disable_jit():
        _, (rays_all, prims_j) = jax_render(mats_j, jnp.ones(n))
    same = (prims_t.numpy() == np.asarray(prims_j)).all(axis=0)
    flips = int((~same).sum())
    assert flips <= n // 100, flips
    assert abs(int(rays_t) - int(rays_all)) <= 2 * bench.DEPTH * flips
    w = same.astype(np.float32)
    with jax.disable_jit():
        (loss_j, _), g_j = jax.value_and_grad(jax_render, has_aux=True)(
            mats_j, jnp.asarray(w))
    weighted = lambda r, lam, _: bench.loss_rgb(wbm_t)(r, lam, t(w))
    acc = bench.accumulate(ts, rays_of, [0], bench.DEPTH, weighted)
    np.testing.assert_allclose(float(acc["loss"]), float(loss_j), rtol=1e-5)
    for k, g in acc["grads"].items():
        _close(g, g_j[k], k)


# ---------------------------------------------------------------------------
# (d) the stream

def test_stream_rays_match_batch_and_jax():
    spp = 2
    n = RES * RES
    n_samples = n * spp
    ts = tcornell_box().build(device="cpu")
    tc = tcornell_camera(resolution=(RES, RES), device="cpu")
    rays = bench.stream_rays(ts, tc, RES, n, n_samples)
    o, d, lam, rk, _ = bench.sample_rays(tc, RES, torch.arange(n_samples))
    dep_b = tpt.integrate(ts, o, d, lam, ray_key=rk)[2]
    assert int(rays) == 2 * int(dep_b.sum()) > 0        # bit for bit

    js = jcornell_box().build()
    jc = jcornell_camera(resolution=(RES, RES))

    def gen(idx):                                       # bench.py:153-166
        p = (idx % n).astype(jnp.uint32)
        s = (idx // n).astype(jnp.uint32)
        jx = jsamp._randfloat(p, s ^ jnp.uint32(0x51633E2D))
        jy = jsamp._randfloat(p, s ^ jnp.uint32(0x68BC21EB))
        raster = jnp.stack([(p % RES).astype(jnp.float32) + jx,
                            (p // RES).astype(jnp.float32) + jy], -1)
        oo, dd = jc.generate_ray(raster, jnp.full(raster.shape, 0.5))
        ll = jwl.sample(jsamp._randfloat(p, s ^ jnp.uint32(0x02E5BE93)))
        rk = jsamp._hash_u32(p ^ jsamp._hash_u32(s ^ jnp.uint32(0x9E3779B9)))
        return {"o": oo, "d": dd, "lam": ll, "rng": rk, "samp": idx}

    def fold(acc, term, st):            # each sample's depth at its id
        samp = jnp.where(term, st["samp"], n_samples)
        return acc.at[samp].add(jnp.where(term, st["depth"], 0), mode="drop")

    with jax.disable_jit():
        dep_j = np.asarray(jpt.integrate_stream(
            js, gen, fold, jnp.zeros(n_samples, jnp.int32), n, n_samples))
    flipped = dep_b.numpy() != dep_j
    assert flipped.sum() <= n_samples // 100, flipped.sum()
    assert int(rays) - 2 * int(dep_j.sum()) == 2 * int(
        (dep_b.numpy() - dep_j)[flipped].sum())


# ---------------------------------------------------------------------------
# (e) the bdpt sub

def test_bdpt_sub_depths_match_jax():
    res = 8
    n = res * res
    js = jcornell_box().build()
    jc = jcornell_camera(resolution=(res, res))
    ts = tcornell_box().build(device="cpu")
    tc = tcornell_camera(resolution=(res, res), device="cpu")
    u_lam = np.random.default_rng(5).uniform(0, 1, n).astype(np.float32)
    raster, o, d, pix = pixel_rays(tc, torch.arange(n))
    lam = jwl.sample(jnp.asarray(u_lam))
    dep_t = bench.bdpt_depths(ts, tc, o, d, t(np.asarray(lam)), 0)
    pj = jnp.arange(n, dtype=jnp.uint32)
    rk = (pj * jnp.uint32(2654435761)) ^ (jnp.uint32(0) * jnp.uint32(7919)
                                          + jnp.uint32(13))
    np.testing.assert_array_equal(bench.bdpt_keys(pix, 0).numpy(),
                                  np.asarray(rk))
    oj, dj = jc.generate_ray(jnp.asarray(raster.numpy()),
                             jnp.full((n, 2), 0.5))
    with jax.disable_jit():
        dep_j = jbdpt.integrate(js, jc, oj, dj, lam, ray_key=rk)[-1]
    np.testing.assert_array_equal(dep_t.numpy(), np.asarray(dep_j))
    assert int(dep_t.sum()) > n


# ---------------------------------------------------------------------------
# (f) the entry as a user runs it

def _entry(*args):
    """The entry in a subprocess whose processes each take one intra-op
    thread: under parallel test workers, processes that each take every
    core run the entry about ten times slower."""
    return subprocess.run([sys.executable, "-m", "lumo_tpu_torch.bench",
                           *args], cwd=ROOT, capture_output=True, text=True,
                          timeout=600,
                          env=dict(os.environ, OMP_NUM_THREADS="1"))


def test_entry_prints_bench_py_line():
    p = _entry("--cpu", "--res", "8", "--spp", "1", "--subdiv", "2")
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert set(line) == {"metric", "value", "unit", "vs_baseline", "extra"}
    assert line["metric"] == bench.METRIC and line["unit"] == "rays/s/chip"
    extra = line["extra"]
    assert {"fwd_only", "bvh", "bdpt", "smoke", "quality", "card",
            "anchor_rays_per_s"} <= set(extra)
    assert extra["card"] == "cpu" and "not a TPU" in extra["anchor"]
    assert extra["anchor_rays_per_s"] == 8551481.2
    assert line["value"] > 0 and extra["checkpoint"] is False
    assert line["vs_baseline"] == pytest.approx(line["value"] / 8551481.2)
    assert extra["fwd_only"]["mode"] in ("batch", "stream")
    assert bench.failed(line) == [] and extra["smoke"]["ok"]
    assert extra["bvh"]["vs_baseline"] == pytest.approx(
        extra["bvh"]["bvh_scene_fwd_rays_per_sec"] / 3179916.2)
    assert extra["bdpt"]["max_verts"] == 6 and extra["bdpt"]["spp"] == 1
    assert extra["quality"]["res"] == 8 and "bvh" in extra["quality"]


def test_unknown_sub_is_an_error():
    p = _entry("--sub", "nope", "--cpu")
    assert p.returncode == 1
    assert "unknown sub" in json.loads(p.stdout.strip().splitlines()[-1])[
        "error"]


@pytest.mark.parametrize("bad", ["error", "smoke"])
def test_a_failed_sub_fails_the_entry(bad, capsys):
    """The line is printed, then the entry returns 1: a sub with an error
    record, or a smoke gate that is not ok."""
    def sub(name, args):
        if bad == "error" and name == "bdpt":
            return {"error": "rc=1: CUDA error"}
        return {"ok": bad != "smoke"} if name == "smoke" else {"x": 1}

    headline = (1.0, {"fwd_only": {"rays_per_s": 2.0}})
    with mock.patch.object(bench, "bench_cornell", return_value=headline), \
            mock.patch.object(bench, "run_sub", sub):
        assert bench.main(["--cpu"]) == 1
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["value"] == 1.0 and bench.failed(line) == [
        "bdpt" if bad == "error" else "smoke"]


@pytest.mark.parametrize("entry", [bench.main, smoke.main])
def test_entries_need_the_card(entry):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the entry would run on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry([])
