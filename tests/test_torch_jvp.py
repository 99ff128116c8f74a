"""Forward-mode derivatives of the port (``torch.autograd.forward_ad``)
against the JAX package's ``jax.jvp``, on the CPU: the traversal
boundary, the integrators on the dense Cornell box, the diag_grad tool,
and the port's own checks.

The traversal is opaque to differentiation in both packages: the walk
gets detached rays, and the hit distance is re-derived from the prim id
(``trace._HitT`` in the port, the custom JVP ``_hit_t`` in the JAX
package).  A forward tangent crosses that boundary from the rays (a
camera tangent on ``c2w_t``), the vertex tables or the material table.
Here ``_HitT`` and ``intersect`` are held to JAX on 256 and 512 rays,
and ``path_trace.integrate`` at fixed depth and with Russian roulette,
``direct_light.integrate`` and ``bdpt.integrate`` on an 8x8 Cornell
frame (``_torch_jvp.py`` gives the directions, the flips left out and
the tolerances; ``test_torch_jvp_routes.py`` has the tree-routed
scenes).  ``tools/diag_grad.py``'s per-pixel tangent is held to the
port's ``lumo_tpu_torch.tools.diag_grad``.

Then the port alone: ``checkpoint=True`` gives ``checkpoint=False``'s
tangent bit for bit (each walk still runs once a bounce), forward mode
agrees with reverse mode on the directional derivative <grad L, v>, and
a traversal query refuses rays that carry a tangent.
"""
import dataclasses
import importlib.util
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.autograd import forward_ad

from _torch_jvp import (DEPTH, INTEGRATORS, N, RES, apply, case,
                        check_integrator, close, directions, inputs, leaves,
                        renders)
from _torch_port import ROOT, blob_box, port_scene_from_jax, rays_into_box, t
from lumo_tpu.scene import trace as jtrace
from lumo_tpu_torch.accel import bvh_kernel, kd_kernel
from lumo_tpu_torch.integrators import path_trace as tpt
from lumo_tpu_torch.scene import trace as ttrace
from lumo_tpu_torch.tools import diag_grad


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The wavefronts here are small: intra-op threads gain nothing, and
    under parallel test workers every process's threads contend for the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the hit distance of a traversal

def test_hit_t_jvp_matches_jax():
    """``_HitT`` against ``_hit_t`` on 256 lanes of the subdiv-2 blob box:
    the prims of a dense closest hit (some lanes miss), tangents on o, d
    and all three vertex tables at once and one at a time; the primal is
    the given t_k and the tangent within rtol 1e-4 plus 1e-6 of its
    largest entry of JAX's, zero where the lane misses."""
    js = blob_box("lumo_tpu", 2).build(accel="bvh")
    ts = port_scene_from_jax(js)
    o, d = rays_into_box(256, seed=21)
    with torch.no_grad():
        t_k, p = ttrace._argmin_t(ttrace._all_t(ts, t(o), t(d),
                                                torch.full((256,), 1e30)))
    hit = torch.isfinite(t_k) & (torch.arange(256) % 7 != 0)
    assert 128 < int(hit.sum()) < 256
    rng = np.random.default_rng(22)
    tans = {"o": rng.normal(size=o.shape), "d": rng.normal(size=d.shape),
            **{k: 0.05 * rng.normal(size=js.tri_a.shape)
               for k in ("a", "b", "c")}}
    tans = {k: v.astype(np.float32) for k, v in tans.items()}
    tri_cat = jnp.concatenate([js.tri_a, js.tri_b, js.tri_c], axis=1)
    for subset in (("o", "d", "a", "b", "c"), ("o",), ("d",), ("b",)):
        zero = lambda k, like: (jnp.asarray(tans[k]) if k in subset
                                else jnp.zeros_like(like))
        dtri = jnp.concatenate([zero(k, js.tri_a) for k in "abc"], axis=1)
        val_j, tan_j = jax.jvp(
            lambda o_, d_, tri: jtrace._hit_t(
                o_, d_, tri, jnp.asarray(p.numpy()),
                jnp.asarray(t_k.numpy()), jnp.asarray(hit.numpy())),
            (jnp.asarray(o), jnp.asarray(d), tri_cat),
            (zero("o", o), zero("d", d), dtri))
        with forward_ad.dual_level():
            dual = lambda k, x: (forward_ad.make_dual(x, t(tans[k]))
                                 if k in subset else x)
            out = ttrace._HitT.apply(
                dual("o", t(o)), dual("d", t(d)), dual("a", ts.tri_a),
                dual("b", ts.tri_b), dual("c", ts.tri_c), p, t_k, hit)
            val_t, tan_t = forward_ad.unpack_dual(out)
        np.testing.assert_array_equal(val_t.numpy(), np.asarray(val_j))
        tan_t = tan_t.numpy()
        assert np.isfinite(tan_t).all() and (tan_t[~hit.numpy()] == 0).all()
        assert np.abs(tan_t).max() > 0.0, subset
        close(tan_t, tan_j, str(subset), rtol=1e-4, atol_rel=1e-6)


@pytest.mark.parametrize("accel", ["bvh", "kdtree"])
def test_intersect_jvp_matches_jax(accel):
    """The tangent of ``intersect``'s hit distance (the walk, ``_hit_t``
    and, on the BVH scene, the walls' dense test) for tangents on the
    rays and the vertex tables, 512 rays into the blob box."""
    js = blob_box("lumo_tpu", 2).build(accel=accel)
    ts = port_scene_from_jax(js)
    o, d = rays_into_box(512, seed=11)
    rng = np.random.default_rng(13)
    tans = [rng.normal(size=o.shape), rng.normal(size=d.shape),
            *(0.05 * rng.normal(size=js.tri_a.shape) for _ in range(3))]
    tans = [x.astype(np.float32) for x in tans]

    def jt(o_, d_, a, b, c):
        h = jtrace.intersect(dataclasses.replace(js, tri_a=a, tri_b=b,
                                                 tri_c=c), o_, d_)
        return jnp.where(h["valid"], h["t"], 0.0)

    val_j, tan_j = jax.jvp(jt, (jnp.asarray(o), jnp.asarray(d), js.tri_a,
                                js.tri_b, js.tri_c),
                           tuple(jnp.asarray(x) for x in tans))
    with forward_ad.dual_level():
        o_, d_, a, b, c = (forward_ad.make_dual(x, t(v)) for x, v in zip(
            (t(o), t(d), ts.tri_a, ts.tri_b, ts.tri_c), tans))
        h = ttrace.intersect(dataclasses.replace(ts, tri_a=a, tri_b=b,
                                                 tri_c=c), o_, d_)
        val_t, tan_t = forward_ad.unpack_dual(
            torch.where(h["valid"], h["t"], 0.0))
    assert int(h["valid"].sum()) > 256
    close(val_t.numpy(), val_j, "t", rtol=1e-6, atol_rel=1e-7)
    assert np.isfinite(tan_t.numpy()).all()
    close(tan_t.numpy(), tan_j, "dt", rtol=1e-4, atol_rel=1e-6)

# ---------------------------------------------------------------------------
# the integrators on the dense Cornell box

@pytest.fixture(scope="module")
def cornell():
    return renders("cornell")


@pytest.mark.parametrize("which", INTEGRATORS)
def test_integrator_jvp_matches_jax(cornell, which):
    check_integrator(cornell, which)


# ---------------------------------------------------------------------------
# tools/diag_grad.py

def _jax_diag_grad():
    """``tools/diag_grad.py`` as a module, without its process-wide
    configuration (CPU platform, x64): the caller enables x64 in a
    context, as the tool runs."""
    spec = importlib.util.spec_from_file_location(
        "_jax_diag_grad", os.path.join(ROOT, "tools", "diag_grad.py"))
    mod = importlib.util.module_from_spec(spec)
    with mock.patch.object(jax.config, "update"):
        spec.loader.exec_module(mod)
    return mod


def test_diag_grad_per_pixel_tangent_matches_jax():
    """8x8, one sample, float32: each pixel's RGB within rtol 1e-4 plus
    1e-6 of the largest, its dL/dtheta term within rtol 1e-3 plus 1e-5
    of the largest, on pixels whose RGB agrees within the tool's own
    flip threshold (0.5; all of them here)."""
    with jax.enable_x64(True):
        g_j, rgb_j = _jax_diag_grad().per_pixel_tangent(np.float32, RES, 1)
    g_t, rgb_t = diag_grad.per_pixel_tangent(torch.float32, RES, 1,
                                             device="cpu")
    assert g_t.shape == (N,) and rgb_t.shape == (N, 3)
    stable = np.abs(rgb_t - rgb_j).max(axis=1) < 0.5
    assert stable.all()
    close(rgb_t, rgb_j, "rgb", rtol=1e-4, atol_rel=1e-6)
    assert np.abs(g_j).max() > 0.0
    close(g_t, g_j, "g")


def test_diag_grad_main_prints_the_tool_lines(capsys):
    out = diag_grad.main(8, 1, device="cpu")
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("net64=") and "cancellation=" in lines[0]
    assert lines[1].startswith("net32=") and lines[2].startswith(
        "rel_err_gross=")
    assert len(lines) == 14 and all(x.startswith("  pix ") for x in lines[4:])
    assert out["cancellation"] >= 1.0 and out["rel_err_net"] < 1e-3


# ---------------------------------------------------------------------------
# the port alone

def _fixed_loss(ts, tc, raster, lam, key, params, checkpoint=False):
    sc, cam = apply(ts, tc, params)
    o, d = cam.generate_ray(t(raster), torch.full((N, 2), 0.5))
    r, _, _ = tpt.integrate(sc, o, d, t(lam), ray_key=t(key),
                            fixed_depth=DEPTH, checkpoint=checkpoint)
    w = torch.linspace(0.5, 1.5, N)
    return (w[:, None] * r).sum()


@pytest.mark.parametrize("which", ["bvh", "kd"])
def test_checkpoint_gives_the_same_tangent(which):
    """Under forward mode the checkpointed bounce (its selective policy
    sees the registered query operators) gives the plain bounce's tangent
    bit for bit, each walk still runs once a bounce, and with reverse mode
    in the same pass the gradients agree too."""
    js, ts, jc, tc = case(which)
    raster, lam, key = inputs(14)
    tan = directions(js, 15)
    tan = {**tan["camera"], **tan["vertex"]}
    mod = kd_kernel if which == "kd" else bvh_kernel
    res = {}
    for ckpt in (False, True):
        calls = {"closest": 0, "any": 0}

        def counted(kind, fn):
            def call(*args, **kwargs):
                calls[kind] += 1
                return fn(*args, **kwargs)
            return call

        kd = ts.materials["kd"].clone().requires_grad_(True)
        with mock.patch.object(mod, "closest_hit",
                               counted("closest", mod.closest_hit)), \
                mock.patch.object(mod, "any_hit",
                                  counted("any", mod.any_hit)), \
                forward_ad.dual_level():
            params = {k: forward_ad.make_dual(v, t(tan[k]))
                      for k, v in leaves(ts, tc).items() if k in tan}
            params["mat:kd"] = kd
            loss = _fixed_loss(ts, tc, raster, lam, key, params,
                               checkpoint=ckpt)
            walks = dict(calls)
            loss_tan = forward_ad.unpack_dual(loss).tangent.detach()
            loss.backward()
        res[ckpt] = (loss_tan, kd.grad, walks)
    assert res[True][2] == res[False][2] == {"closest": DEPTH, "any": DEPTH}
    assert torch.isfinite(res[False][0]) and float(res[False][0]) != 0.0
    assert torch.equal(res[True][0], res[False][0])
    assert torch.equal(res[True][1], res[False][1])


@pytest.mark.parametrize("which", ["cornell", "bvh"])
def test_jvp_equals_vjp_directional_derivative(which):
    """jvp(v) == <grad L, v> for a weighted fixed-depth loss, v over the
    material table, ``c2w_t`` and the vertex tables at once, within rtol
    1e-4 (float32 sums in two orders)."""
    js, ts, jc, tc = case(which)
    raster, lam, key = inputs(16)
    dirs = directions(js, 17)
    v = {**dirs["material"], **dirs["camera"], **dirs["vertex"]}
    with forward_ad.dual_level():
        params = {k: forward_ad.make_dual(x, t(v[k]))
                  for k, x in leaves(ts, tc).items()}
        jvp = float(forward_ad.unpack_dual(_fixed_loss(
            ts, tc, raster, lam, key, params)).tangent)
    params = {k: x.clone().requires_grad_(True)
              for k, x in leaves(ts, tc).items()}
    _fixed_loss(ts, tc, raster, lam, key, params).backward()
    vjp = sum(float((x.grad * t(v[k])).sum()) for k, x in params.items()
              if x.grad is not None)
    assert jvp != 0.0
    assert jvp == pytest.approx(vjp, rel=1e-4)


@pytest.mark.parametrize("accel", ["bvh", "kdtree"])
def test_queries_reject_rays_with_a_tangent(accel):
    """A dual ray never reaches a walk: the registered operators would
    drop its tangent, so the query raises instead."""
    ts = port_scene_from_jax(blob_box("lumo_tpu", 2).build(accel=accel))
    o, d = (t(x) for x in rays_into_box(16, seed=1))
    t_max = torch.full((16,), float("inf"))
    tri = ttrace._bvh_tris(ts)
    if accel == "bvh":
        calls = (lambda o_: bvh_kernel.closest_query(ts.bvh, tri, o_, d,
                                                     t_max),
                 lambda o_: bvh_kernel.any_query(ts.bvh, tri, o_, d, t_max))
    else:
        calls = (lambda o_: kd_kernel.closest_query(ts.kdtree, o_, d, t_max,
                                                    tri),
                 lambda o_: kd_kernel.any_query(ts.kdtree, o_, d, t_max))
    with forward_ad.dual_level():
        dual = forward_ad.make_dual(o, torch.ones_like(o))
        for call in calls:
            with pytest.raises(ValueError,
                               match=r"o carries a forward-mode tangent"):
                call(dual)
            call(o)
