"""Forward-mode derivatives of the port against the JAX package's
``jax.jvp`` on the tree-routed scenes, on the CPU (where the routes take
the plain walks; ``test_torch_jvp.py`` has the rest).

The subdiv-2 blob box of ``bench.py::bench_bvh_scene``: through the BVH
route every integrator with material, camera and vertex tangents
(``_torch_jvp.py``), through the kd route the path tracer at fixed depth
and with Russian roulette with camera and vertex tangents, and
``integrate_stream`` through the BVH route with a camera tangent.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.autograd import forward_ad

from _torch_jvp import (DEPTH, INTEGRATORS, MAX_FLIPS, N, RES, apply, case,
                        check_integrator, close, directions, flips, inputs,
                        jax_jvp, leaves, port_jvp, renders)
from _torch_port import t
from lumo_tpu.color import wavelength as jwl
from lumo_tpu.integrators import path_trace as jpt
from lumo_tpu.sampling import samplers as jsamp
from lumo_tpu_torch.color import wavelength as twl
from lumo_tpu_torch.integrators import path_trace as tpt
from lumo_tpu_torch.sampling import samplers as tsamp


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def bvh():
    return renders("bvh")


@pytest.mark.parametrize("which", INTEGRATORS)
def test_integrator_jvp_matches_jax(bvh, which):
    check_integrator(bvh, which)


def test_kd_route_jvp_matches_jax():
    """The kd-routed blob box: fixed depth and Russian roulette with a
    camera tangent and a vertex tangent."""
    js, ts, jc, tc = case("kd")
    raster, lam, key = inputs(8)
    dirs = {k: v for k, v in directions(js, 9).items() if k != "material"}
    lam_j, key_j = jnp.asarray(lam), jnp.asarray(key)

    def jfn(leaves):
        sc, cam = apply(js, jc, leaves)
        o, d = cam.generate_ray(jnp.asarray(raster), jnp.full((N, 2), 0.5))
        return {"fixed": jpt.integrate(sc, o, d, lam_j, ray_key=key_j,
                                       fixed_depth=DEPTH, trace_prims=True),
                "rr": jpt.integrate(sc, o, d, lam_j, ray_key=key_j)}

    def tfn(leaves):
        sc, cam = apply(ts, tc, leaves)
        o, d = cam.generate_ray(t(raster), torch.full((N, 2), 0.5))
        return {"fixed": tpt.integrate(sc, o, d, t(lam), ray_key=t(key),
                                       fixed_depth=DEPTH, trace_prims=True),
                "rr": tpt.integrate(sc, o, d, t(lam), ray_key=t(key))}

    leaves_j = {k: v for k, v in leaves(js, jc).items()
                if not k.startswith("mat:")}
    want = jax_jvp(jfn, leaves_j, dirs)
    for name, tan in dirs.items():
        out_t, tan_t = port_jvp(tfn, leaves(ts, tc), tan)
        out_j, tan_j = want[name]
        for which in ("fixed", "rr"):
            keep = ~flips(which, out_t[which], out_j[which])
            assert (~keep).sum() <= MAX_FLIPS, (name, which)
            assert np.abs(tan_j[which][0][keep]).max() > 0.0
            close(tan_t[which][0][keep], tan_j[which][0][keep],
                   f"kd {which} {name}")


def test_stream_jvp_matches_jax():
    """``integrate_stream`` over the BVH-routed blob box, 2 samples a
    pixel on 48 lanes (so lanes pick up fresh samples), a camera tangent
    in ``gen``: each sample's radiance tangent, folded by sample id,
    against JAX's; samples whose depth or radiance differ are left out."""
    js, ts, jc, tc = case("bvh")
    spp = 2
    n_samples, lanes = N * spp, 48
    tan = np.array([0.3, -0.2, 0.5], np.float32)

    def jgen(cam, idx):
        pix = (idx % N).astype(jnp.uint32)
        sp = (idx // N).astype(jnp.uint32)
        raster = jnp.stack(
            [(pix % RES).astype(jnp.float32)
             + jsamp._randfloat(pix, sp ^ jnp.uint32(0x51633E2D)),
             (pix // RES).astype(jnp.float32)
             + jsamp._randfloat(pix, sp ^ jnp.uint32(0x68BC21EB))], -1)
        o, d = cam.generate_ray(raster, jnp.full(raster.shape, 0.5))
        lam = jwl.sample(jsamp._randfloat(pix, sp ^ jnp.uint32(0x02E5BE93)))
        rng = jsamp._hash_u32(pix ^ jsamp._hash_u32(sp ^ jnp.uint32(
            0x9E3779B9)))
        return {"o": o, "d": d, "lam": lam, "rng": rng, "samp": idx}

    def jfold(acc, term, st):
        samp = jnp.where(term, st["samp"], jnp.uint32(n_samples))
        rad, dep = acc
        rad = rad.at[samp].add(jnp.where(term[:, None], st["radiance"], 0.0),
                               mode="drop")
        dep = dep.at[samp].add(jnp.where(term, st["depth"], 0), mode="drop")
        return rad, dep

    def jrun(c2w_t):
        cam = dataclasses.replace(jc, c2w_t=c2w_t)
        acc0 = (jnp.zeros((n_samples, 4), jnp.float32),
                jnp.zeros((n_samples,), jnp.int32))
        return jpt.integrate_stream(js, lambda i: jgen(cam, i), jfold, acc0,
                                    lanes, n_samples)

    (rad_j, dep_j), (tan_j, _) = jax.tree.map(np.asarray, jax.jit(
        lambda c, v: jax.jvp(jrun, (c,), (v,)))(jc.c2w_t, jnp.asarray(tan)))

    def tgen(cam, idx):
        pix, sp = idx % N, idx // N
        raster = torch.stack(
            [(pix % RES).float() + tsamp._randfloat(pix, sp ^ 0x51633E2D),
             (pix // RES).float() + tsamp._randfloat(pix, sp ^ 0x68BC21EB)],
            -1)
        o, d = cam.generate_ray(raster, torch.full_like(raster, 0.5))
        lam = twl.sample(tsamp._randfloat(pix, sp ^ 0x02E5BE93))
        rng = tsamp._hash_u32(pix ^ tsamp._hash_u32(sp ^ 0x9E3779B9))
        return {"o": o, "d": d, "lam": lam, "rng": rng, "samp": idx}

    def tfold(acc, term, st):
        rad, dep = acc
        samp = st["samp"]
        return (rad.index_add(0, samp, torch.where(term[:, None],
                                                   st["radiance"], 0.0)),
                dep.index_add(0, samp, torch.where(term, st["depth"], 0)))

    with forward_ad.dual_level():
        cam = dataclasses.replace(tc, c2w_t=forward_ad.make_dual(
            tc.c2w_t, t(tan)))
        acc0 = (torch.zeros((n_samples, 4)),
                torch.zeros(n_samples, dtype=torch.int32))
        rad, dep = tpt.integrate_stream(ts, lambda i: tgen(cam, i), tfold,
                                        acc0, lanes, n_samples)
        rad_t, tan_t = (x.numpy() for x in forward_ad.unpack_dual(rad))
    keep = (np.isclose(rad_t, rad_j, rtol=1e-3, atol=1e-6).all(-1)
            & (dep.numpy() == dep_j))
    assert (~keep).sum() <= MAX_FLIPS * spp, int((~keep).sum())
    assert int(dep_j.max()) >= tpt.RR_DEPTH
    assert np.abs(tan_j[keep]).max() > 0.0
    close(tan_t[keep], tan_j[keep], "stream radiance tangent")
