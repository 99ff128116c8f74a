"""The slice as a whole: the port's forward path tracer against the JAX
package's on a subdiv-2 blob in ``empty_box`` (the scene of
``bench.py::bench_bvh_scene`` at 332 triangles), carried over with
``from_numpy``, 1024 rays with the same per-ray ``ray_key``.

``intersect`` and ``occluded`` are compared first.  Then both integrators
run to completion: JAX's with ``fixed_depth = MAX_DEPTH`` so that it
reports each bounce's hit prim, the port's Python loop until no lane is
alive.  On lanes whose prim sequences agree, depth and hero wavelengths
are exact and radiance lies within rtol 1e-4, atol 1e-6 (XLA contracts
multiply-adds where PyTorch's CPU kernels round each operation, and a
path compounds those ulps over its bounces).  Lanes whose sequence differs
(a topology flip, a hit that one side finds by an ulp and the other
misses) are counted and must stay under 1%, as ``tools/quality.py``
excludes them.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import blob_box, port_scene_from_jax, rays_into_box, t
from lumo_tpu.color import wavelength as jwl
from lumo_tpu.integrators import path_trace as jpt
from lumo_tpu.scene import trace as jtrace
from lumo_tpu_torch.integrators import path_trace as tpt
from lumo_tpu_torch.scene import trace as ttrace

N = 1024
RTOL, ATOL = 1e-4, 1e-6


@pytest.fixture(scope="module")
def case():
    js = blob_box("lumo_tpu", 2).build()
    ts = port_scene_from_jax(js)
    assert ts.bvh is not None and ts.n_bvh_tris < ts.n_tris
    o, d = rays_into_box(N, seed=3)
    rng = np.random.default_rng(4)
    lam = np.asarray(jwl.sample(jnp.asarray(
        rng.uniform(0, 1, N).astype(np.float32))))
    key = rng.integers(0, 1 << 32, N, dtype=np.uint32)
    alive = rng.uniform(0, 1, N) > 0.1
    t_occ = rng.uniform(0.05, 3.0, N).astype(np.float32)
    t_occ[rng.uniform(0, 1, N) < 0.1] = 0.0
    return js, ts, dict(o=o, d=d, lam=lam, key=key, alive=alive,
                        t_occ=t_occ)


def test_intersect_matches_jax(case):
    js, ts, h = case
    hj = jtrace.intersect(js, jnp.asarray(h["o"]), jnp.asarray(h["d"]),
                          alive=jnp.asarray(h["alive"]))
    ht = ttrace.intersect(ts, t(h["o"]), t(h["d"]), alive=t(h["alive"]))
    valid = np.asarray(hj["valid"])
    np.testing.assert_array_equal(ht["valid"].numpy(), valid)
    assert not valid[~h["alive"]].any()       # dead lanes miss
    assert valid.sum() > N // 2
    np.testing.assert_array_equal(ht["prim"].numpy()[valid],
                                  np.asarray(hj["prim"])[valid])
    for k in ("mat", "backface", "light"):
        np.testing.assert_array_equal(ht[k].numpy()[valid],
                                      np.asarray(hj[k])[valid], err_msg=k)
    for k in ("t", "p", "ng", "ns", "uv", "err"):
        np.testing.assert_allclose(ht[k].numpy()[valid],
                                   np.asarray(hj[k])[valid], rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_occluded_matches_jax(case):
    js, ts, h = case
    occ_j = np.asarray(jtrace.occluded(js, jnp.asarray(h["o"]),
                                       jnp.asarray(h["d"]),
                                       jnp.asarray(h["t_occ"])))
    occ_t = ttrace.occluded(ts, t(h["o"]), t(h["d"]), t(h["t_occ"]))
    np.testing.assert_array_equal(occ_t.numpy(), occ_j)
    assert 0 < occ_j.sum() < N
    assert not occ_j[h["t_occ"] == 0.0].any()


def test_integrate_matches_jax(case):
    js, ts, h = case
    r_j, lam_j, dep_j, pr_j = jpt.integrate(
        js, jnp.asarray(h["o"]), jnp.asarray(h["d"]), jnp.asarray(h["lam"]),
        ray_key=jnp.asarray(h["key"]), fixed_depth=jpt.MAX_DEPTH,
        trace_prims=True)
    r_j, lam_j, dep_j, pr_j = (np.asarray(x) for x in (r_j, lam_j, dep_j,
                                                       pr_j))
    assert dep_j.max() < jpt.MAX_DEPTH        # every JAX path ended
    r_t, lam_t, dep_t, pr_t = tpt.integrate(
        ts, t(h["o"]), t(h["d"]), t(h["lam"]), ray_key=t(h["key"]),
        trace_prims=True)
    pr_t = pr_t.numpy()
    assert pr_t.shape[0] <= jpt.MAX_DEPTH
    pad = np.full((jpt.MAX_DEPTH - pr_t.shape[0], N), -1, pr_t.dtype)
    same = (np.concatenate([pr_t, pad]) == pr_j).all(axis=0)
    flips = int(N - same.sum())
    assert flips <= N // 100, f"{flips} topology flips"
    np.testing.assert_array_equal(dep_t.numpy()[same], dep_j[same])
    np.testing.assert_array_equal(lam_t.numpy()[same], lam_j[same])
    np.testing.assert_allclose(r_t.numpy()[same], r_j[same], rtol=RTOL,
                               atol=ATOL)
    # the paths are long enough for Russian roulette, and light arrives
    assert dep_j.max() > tpt.RR_DEPTH
    assert (r_j.sum(-1) > 0).sum() > N // 4
