"""Shared parts of the forward-mode tests (``test_torch_jvp*.py``): the
tangent directions, both packages' frames under ``jax.jvp`` and
``torch.autograd.forward_ad``, and the comparison of their tangents.

An 8x8 frame (64 rays from a numpy seed, ``ray_key`` passed explicitly)
goes through ``path_trace.integrate`` at fixed depth 4 and with Russian
roulette, ``direct_light.integrate`` and ``bdpt.integrate`` in both
packages, once for each of three tangent directions: every float leaf of
the material table, the camera origin ``c2w_t``, and the three vertex
tables.  The JAX side is one jitted ``jax.jvp`` a scene, run once a
direction (its compile takes most of a test's time).

Lanes whose path differs between the packages are counted, at most 2 of
64, and left out: another prim on some bounce at fixed depth, else a
radiance beyond rtol 1e-3 of the other's or another depth, and for BDPT
another set of splats.  On the rest the radiance and its tangent lie
within rtol 1e-3 plus 1e-5 of the largest entry (float32 in another
order: XLA contracts multiply-adds; measured at most 4.3e-05 of the
largest entry, on the Cornell box's vertex tangent, and no flip but one
BDPT lane of the blob box).  BDPT's MIS weights amplify an ulp where two
vertices lie in one plane (``test_torch_bdpt_render.py``): its tangents
lie within 1% everywhere and 98% of them within the tolerance above
(measured: 2.0e-04 of the largest entry, 1.0e-02 relative at worst).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch
from torch.autograd import forward_ad

from _torch_port import blob_box, port_scene_from_jax, t
from lumo_tpu.camera import build_camera as jbuild_camera
from lumo_tpu.camera import cornell_camera as jcornell_camera
from lumo_tpu.color import wavelength as jwl
from lumo_tpu.integrators import bdpt as jbdpt
from lumo_tpu.integrators import direct_light as jdl
from lumo_tpu.integrators import path_trace as jpt
from lumo_tpu.scene.cornell import cornell_box as jcornell_box
from lumo_tpu_torch.camera import build_camera as tbuild_camera
from lumo_tpu_torch.camera import cornell_camera as tcornell_camera
from lumo_tpu_torch.integrators import bdpt as tbdpt
from lumo_tpu_torch.integrators import direct_light as tdl
from lumo_tpu_torch.integrators import path_trace as tpt

RES = 8
N = RES * RES
DEPTH = 4
RTOL, ATOL_REL = 1e-3, 1e-5
# lanes whose path differs between the packages, at most
MAX_FLIPS = 2
DIRECTIONS = ("material", "camera", "vertex")
INTEGRATORS = ("fixed", "rr", "direct", "bdpt")


def close(got, want, what, rtol=RTOL, atol_rel=ATOL_REL):
    want = np.asarray(want, np.float64)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_rel * max(scale, 1e-30),
                               err_msg=what)


def _tangent(x):
    """The tangent of a port output as numpy, zeros where none flows."""
    tan = forward_ad.unpack_dual(x).tangent
    return (np.zeros(x.shape, np.float32) if tan is None
            else tan.detach().numpy())


def case(which):
    """(JAX scene, port scene, JAX camera, port camera)."""
    if which == "cornell":
        js = jcornell_box().build()
        return (js, port_scene_from_jax(js),
                jcornell_camera(resolution=(RES, RES)),
                tcornell_camera(resolution=(RES, RES), device="cpu"))
    js = blob_box("lumo_tpu", 2).build(accel="kdtree" if which == "kd"
                                       else "bvh")
    return (js, port_scene_from_jax(js), jbuild_camera(resolution=(RES, RES)),
            tbuild_camera(resolution=(RES, RES), device="cpu"))


def inputs(seed):
    rng = np.random.default_rng(seed)
    raster = rng.uniform(0, RES, (N, 2)).astype(np.float32)
    lam = np.asarray(jwl.sample(jnp.asarray(
        rng.uniform(0, 1, N).astype(np.float32))))
    key = rng.integers(0, 1 << 32, N, dtype=np.uint32)
    return raster, lam, key


def _float_mats(materials):
    return sorted(k for k, v in materials.items()
                  if np.issubdtype(np.asarray(v).dtype, np.floating))


def directions(js, seed):
    """Each direction's tangents as numpy: {leaf: tangent}, leaves among
    ``mat:<key>``, ``c2w_t``, ``tri_a``, ``tri_b``, ``tri_c``."""
    rng = np.random.default_rng(seed)
    normal = lambda x, s=1.0: (s * rng.normal(size=np.shape(x))).astype(
        np.float32)
    return {
        "material": {f"mat:{k}": normal(js.materials[k])
                     for k in _float_mats(js.materials)},
        "camera": {"c2w_t": np.array([0.3, -0.2, 0.5], np.float32)},
        "vertex": {k: normal(getattr(js, k), 0.05)
                   for k in ("tri_a", "tri_b", "tri_c")},
    }


def leaves(scene, cam):
    """The differentiable leaves of either package's scene and camera:
    {``mat:<key>``, ``c2w_t``, ``tri_a``, ``tri_b``, ``tri_c``: array}."""
    out = {f"mat:{k}": scene.materials[k]
           for k in _float_mats(scene.materials)}
    out.update(c2w_t=cam.c2w_t, tri_a=scene.tri_a, tri_b=scene.tri_b,
               tri_c=scene.tri_c)
    return out


def apply(scene, cam, leaves):
    """(scene, camera) with the leaves of ``leaves`` put in."""
    mats = {k[4:]: v for k, v in leaves.items() if k.startswith("mat:")}
    tri = {k: v for k, v in leaves.items() if k.startswith("tri_")}
    scene = dataclasses.replace(scene,
                                materials={**scene.materials, **mats}, **tri)
    if "c2w_t" in leaves:
        cam = dataclasses.replace(cam, c2w_t=leaves["c2w_t"])
    return scene, cam


def jax_jvp(fn, primals, directions):
    """{direction: (outputs, tangents)} of ``fn(leaves)`` by one jitted
    ``jax.jvp``, run once per direction (zeros on the other leaves)."""
    run = jax.jit(lambda tg: jax.jvp(fn, (primals,), (tg,)))
    out = {}
    for name, tan in directions.items():
        tg = {k: jnp.asarray(tan[k]) if k in tan else jnp.zeros_like(v)
              for k, v in primals.items()}
        out[name] = jax.tree.map(np.asarray, run(tg))
    return out


def port_jvp(fn, primals, tan):
    """(outputs, tangents) of ``fn(leaves)`` under forward mode, the
    tangents as numpy (zeros where none flows), outputs detached."""
    with forward_ad.dual_level():
        leaves = {k: forward_ad.make_dual(v, t(tan[k])) if k in tan else v
                  for k, v in primals.items()}
        outs = fn(leaves)
        tans = {k: tuple(_tangent(x) if x.is_floating_point() else None
                         for x in v) for k, v in outs.items()}
        outs = {k: tuple(forward_ad.unpack_dual(x).primal.detach().numpy()
                         for x in v) for k, v in outs.items()}
    return outs, tans




def _jax_renders(js, jc, raster, lam, key):
    """leaves -> {integrator: outputs} of one JAX frame."""
    lam, key = jnp.asarray(lam), jnp.asarray(key)

    def fn(leaves):
        sc, cam = apply(js, jc, leaves)
        o, d = cam.generate_ray(jnp.asarray(raster), jnp.full((N, 2), 0.5))
        return {
            "fixed": jpt.integrate(sc, o, d, lam, ray_key=key,
                                   fixed_depth=DEPTH, trace_prims=True),
            "rr": jpt.integrate(sc, o, d, lam, ray_key=key),
            "direct": jdl.integrate(sc, o, d, lam, ray_key=key),
            "bdpt": jbdpt.integrate(sc, cam, o, d, lam, ray_key=key),
        }
    return fn


def _port_renders(ts, tc, raster, lam, key):
    lam, key = t(lam), t(key)

    def fn(leaves):
        sc, cam = apply(ts, tc, leaves)
        o, d = cam.generate_ray(t(raster), torch.full((N, 2), 0.5))
        return {
            "fixed": tpt.integrate(sc, o, d, lam, ray_key=key,
                                   fixed_depth=DEPTH, trace_prims=True),
            "rr": tpt.integrate(sc, o, d, lam, ray_key=key),
            "direct": tdl.integrate(sc, o, d, lam, ray_key=key),
            "bdpt": tbdpt.integrate(sc, cam, o, d, lam, ray_key=key),
        }
    return fn


def renders(which):
    """(which, JAX's, the port's) outputs and tangents of one 8x8 frame
    per integrator and tangent direction on the scene ``which``."""
    js, ts, jc, tc = case(which)
    raster, lam, key = inputs(5)
    dirs = directions(js, 6)
    want = jax_jvp(_jax_renders(js, jc, raster, lam, key), leaves(js, jc),
                   dirs)
    fn = _port_renders(ts, tc, raster, lam, key)
    got = {name: port_jvp(fn, leaves(ts, tc), tan)
           for name, tan in dirs.items()}
    return which, want, got


def flips(which, out_t, out_j):
    """(N,) lanes whose path differs between the packages: another prim on
    some bounce at fixed depth, else another depth or radiance, and for
    BDPT another set of splats."""
    if which == "fixed":
        return (out_t[3] != out_j[3]).any(axis=0)
    flip = (~np.isclose(out_t[0], out_j[0], rtol=1e-3, atol=1e-6).all(-1)
            | (out_t[-1] != out_j[-1]))
    if which == "bdpt":                 # or another splat strategy set
        flip |= (out_t[4] != out_j[4]).any(axis=0)
    return flip


def check_integrator(renders, which):
    """Radiance tangents of every direction on the lanes both packages
    trace alike; for BDPT also the splats' colours and raster positions
    where their masks are set.  A camera tangent and a vertex tangent
    reach the radiance (through ``_hit_t`` on the blob box) and the
    material tangent too (the box's walls), so every tangent is nonzero
    somewhere."""
    scene, want, got = renders
    for name in DIRECTIONS:
        (out_j, tan_j), (out_t, tan_t) = want[name][:2], got[name]
        out_j, tan_j = out_j[which], tan_j[which]
        out_t, tan_t = out_t[which], tan_t[which]
        flip = flips(which, out_t, out_j)
        assert flip.sum() <= MAX_FLIPS, (name, int(flip.sum()))
        keep = ~flip
        what = f"{scene} {which} {name}"
        close(out_t[0][keep], out_j[0][keep], what + " radiance")
        assert np.isfinite(tan_t[0]).all(), what
        assert np.abs(tan_j[0][keep]).max() > 0.0, what
        if which != "bdpt":
            close(tan_t[0][keep], tan_j[0][keep], what)
            continue
        # MIS weights amplify an ulp where two vertices lie in one plane
        # (``test_torch_bdpt_render.py``): every entry within 1%, 98%
        # within the tolerance of the other integrators
        scale = np.abs(tan_j[0][keep]).max()
        near = np.isclose(tan_t[0][keep], tan_j[0][keep], rtol=RTOL,
                          atol=ATOL_REL * scale)
        assert near.mean() >= 0.98, (what, near.mean())
        close(tan_t[0][keep], tan_j[0][keep], what, rtol=1e-2)
        mask = out_j[4] & keep[None, :]
        assert mask.any()
        close(tan_t[3][mask], tan_j[3][mask], what + " splat colour",
              rtol=1e-2)
        close(tan_t[2][mask], tan_j[2][mask], what + " splat raster")
