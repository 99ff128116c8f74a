"""Shared inputs for the tests that hold lumo_tpu_torch against lumo_tpu.

Both packages build the same scene from the same host inputs; the JAX
scene's arrays, converted with ``np.asarray``, are carried into the port
with ``lumo_tpu_torch.scene.scene.from_numpy``.  Everything runs on the
CPU.
"""
import importlib

import numpy as np
import torch

SCENE_FIELDS = ("tri_a", "tri_b", "tri_c", "tri_na", "tri_nb", "tri_nc",
                "tri_uva", "tri_uvb", "tri_uvc", "tri_mat", "light_prim",
                "light_pdf", "alias_p", "alias_idx", "prim_light", "bounds")
SHAPE_FIELDS = ("sph_center", "sph_radius", "sph_mat", "ana_kind", "ana_rot",
                "ana_trans", "ana_radius", "ana_height", "ana_mat")
BVH_KEYS = ("lo", "hi", "right", "first", "count", "axis")
KD_KEYS = ("split", "axis", "right", "first", "count", "prims", "lo", "hi")
# the arrays of an instanced group besides its BVH
INST_FIELDS = ("a", "b", "c", "na", "nb", "nc", "uva", "uvb", "uvc", "minv",
               "mfwd", "trans", "mat")

BLOB_SEED = 11


def blob_box(pkg, subdiv):
    """``bench.py::bench_bvh_scene``'s scene (a displaced icosphere with a
    metal material in ``empty_box``) as a SceneBuilder of ``pkg``, either
    ``"lumo_tpu"`` or ``"lumo_tpu_torch"``."""
    cornell = importlib.import_module(f"{pkg}.scene.cornell")
    shapes = importlib.import_module(f"{pkg}.scene.shapes")
    Mesh = importlib.import_module(f"{pkg}.scene.instance").Mesh
    Material = importlib.import_module(f"{pkg}.scene.materials").Material
    sb = cornell.empty_box((0.95, 0.95, 0.95),
                           Material.diffuse((0.9, 0.1, 0.1)),
                           Material.diffuse((0.1, 0.9, 0.1)))
    v, f, vn = shapes.blob(subdiv=subdiv, seed=BLOB_SEED, amp=0.22)
    (Mesh(v, f, normals=vn).to_unit_size().to_origin().set_y(-0.799)
     .translate(0.0, 0.0, -1.5)
     .add_to(sb, Material.metal((0.9, 0.7, 0.1), 0.1, 2.5, 3.0)))
    return sb


def jax_scene_arrays(js):
    """(fields, bvh) host dicts of a JAX SceneData, as ``from_numpy``
    takes them."""
    host = lambda d: None if d is None else {k: np.asarray(v)
                                             for k, v in d.items()}
    fields = {k: np.asarray(getattr(js, k))
              for k in SCENE_FIELDS + SHAPE_FIELDS}
    fields["n_bvh_tris"] = js.n_bvh_tris
    fields["n_normal_maps"] = js.n_normal_maps
    fields["materials"] = host(js.materials)
    fields["textures"] = host(js.textures)
    fields["medium"] = host(js.medium)
    fields["inst"] = tuple(
        {**{k: np.asarray(g[k]) for k in INST_FIELDS},
         "bvh": None if g["bvh"] is None else {k: np.asarray(g["bvh"][k])
                                               for k in BVH_KEYS}}
        for g in js.inst)
    bvh = None
    if js.bvh is not None:
        bvh = {k: np.asarray(js.bvh[k]) for k in BVH_KEYS}
    return fields, bvh


def jax_kd_arrays(js):
    """The flat kd tables of a JAX SceneData built with ``accel="kdtree"``
    as ``from_numpy(..., kd=...)`` takes them, else None."""
    if js.kdtree is None:
        return None
    return {k: np.asarray(js.kdtree[k]) for k in KD_KEYS}


def port_scene_from_jax(js):
    from lumo_tpu_torch.scene import scene as tscene
    fields, bvh = jax_scene_arrays(js)
    return tscene.from_numpy(fields, bvh, "cpu", kd=jax_kd_arrays(js))


def soup(T, seed=0):
    """A random triangle soup: a, b, c (T, 3) float32."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1, 1, (T, 3)).astype(np.float32)
    b = a + rng.uniform(-0.25, 0.25, (T, 3)).astype(np.float32)
    c = a + rng.uniform(-0.25, 0.25, (T, 3)).astype(np.float32)
    return a, b, c


def soup_rays(N, seed, dead=True):
    """Rays through the soup's box: o, d (N, 3), t_max (N,) float32; with
    ``dead`` an eighth of the lanes have t_max 0 and three eighths a
    finite t_max."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-2, 2, (N, 3)).astype(np.float32)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = np.full(N, np.inf, np.float32)
    if dead:
        t_max[: N // 8] = 0.0
        t_max[N // 8: N // 2] = rng.uniform(0.05, 3.0, N // 2 - N // 8)
        rng.shuffle(t_max)
    return o, d, t_max


def rays_into_box(N, seed):
    """Rays from near the camera into the box: o, d (N, 3) float32."""
    rng = np.random.default_rng(seed)
    o = (np.array([0.0, 0.0, 0.5], np.float32)
         + rng.uniform(-0.1, 0.1, (N, 3)).astype(np.float32))
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d[:, 2] = -np.abs(d[:, 2]) - 0.3
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def t(x):
    """A numpy array as a CPU tensor (uint32 widened to int64)."""
    x = np.array(x)                     # a writable, contiguous copy
    if x.dtype == np.uint32:
        x = x.astype(np.int64)
    return torch.as_tensor(x)


# ---------------------------------------------------------------------------
# the example programs' scenes (``examples/*.py``), each built with the
# same calls as its program; meshes the programs load from ``scenes/`` are
# their procedural stand-in blobs

EXAMPLES = ("dragon", "dof", "medium", "circle", "nefertiti", "conference",
            "box", "caustics", "cornell")


def _blob_mesh(pkg, subdiv, seed, amp):
    """``examples/_common.py::load_mesh_or_blob``'s stand-in mesh."""
    shapes = importlib.import_module(f"{pkg}.scene.shapes")
    Mesh = importlib.import_module(f"{pkg}.scene.instance").Mesh
    v, f, vn = shapes.blob(subdiv=subdiv, seed=seed, amp=amp)
    return Mesh(v, f, normals=vn)


def example_scene(pkg, name, res):
    """(SceneBuilder, camera kwargs, camera function name, renderer
    illuminant or None) of example ``name`` in package ``pkg``; the camera
    is ``getattr(camera_module, fn)(resolution=(res, res), **kwargs)``."""
    import math
    PI = math.pi
    mod = lambda m: importlib.import_module(f"{pkg}.{m}")
    Material = mod("scene.materials").Material
    SceneBuilder = mod("scene.scene").SceneBuilder
    Mesh = mod("scene.instance").Mesh
    uplift = mod("color.uplift")
    cam = {}
    if name == "dragon":
        sb = mod("scene.cornell").empty_box(
            uplift.from_srgb8(242, 242, 242).reshape(4),
            Material.diffuse(uplift.from_srgb8(255, 0, 0).reshape(4)),
            Material.diffuse(uplift.from_srgb8(0, 255, 0).reshape(4)))
        magenta = uplift.from_srgb8(255, 0, 255).reshape(4)
        (_blob_mesh(pkg, 5, 13, 0.25).to_unit_size().to_origin()
         .rotate_y(5.0 * PI / 8.0).scale_uniform(1.3).set_y(-0.799)
         .translate(0.0, 0.0, -1.4)
         .add_to(sb, Material.transparent(magenta, 0.03, 1.5)))
        return sb, cam, "build_camera", None
    if name == "dof":
        shapes = mod("scene.shapes")
        sb = SceneBuilder()
        checker = sb.textures.checkerboard((0.0, 0.0, 0.0), (1.0, 1.0, 1.0),
                                           100.0)
        gv, gf = shapes.grid_plane(n=1, size=10.0, y=0.0)
        Mesh(gv, gf).translate(0.0, -1.0, 0.0).add_to(
            sb, Material.diffuse((1.0, 1.0, 1.0), kd_tex=checker))
        lv, lf = shapes.grid_plane(n=1, size=3.0, y=0.0)
        Mesh(lv, lf).rotate_z(PI).translate(0.0, 8.0, -1.5).add_to(
            sb, Material.light(0.25 * np.ones(4), two_sided=True))
        teapot = _blob_mesh(pkg, 4, 5, 0.18).to_unit_size()
        for i in range(3):
            marble = sb.textures.marble((1.0, 245 / 255.0, 1.0))
            (teapot.clone().to_origin().rotate_y(-PI / 4)
             .translate(0.0, -0.75, -1.0 * i)
             .add_to(sb, Material.diffuse((1.0, 1.0, 1.0), kd_tex=marble)))
        o = np.array([-0.75, 0.25, 0.0])
        tw = np.array([0.0, -0.75, -1.0])
        cam = dict(origin=tuple(o), towards=tuple(tw), lens_radius=0.03,
                   focal_length=float(np.linalg.norm(o - tw)),
                   kind=mod("camera").ORTHOGRAPHIC)
        return sb, cam, "build_camera", None
    if name == "medium":
        sb = mod("scene.cornell").cornell_box()
        sb.set_medium((0.5, 0.5, 0.5), (0.1, 0.1, 0.1), 0.9)
        return sb, cam, "cornell_camera", "CORNELL"
    if name == "circle":
        def hsv_to_rgb(h):
            def f(n):
                k = (n + h / (PI / 3.0)) % 6.0
                return 1.0 - np.clip(min(k, 4.0 - k), 0.0, 1.0)
            return uplift.from_srgb8(int(f(5.0) * 255), int(f(3.0) * 255),
                                     int(f(1.0) * 255)).reshape(4)
        sb = SceneBuilder()
        ground, r = -0.2, 0.2
        sb.add_disk((0.0, ground, 0.0), (0.0, 1.0, 0.0), 100.0,
                    Material.mirror())
        sb.add_sphere((0.0, ground + r + 0.1, 0.0), r,
                      Material.light(0.01 * np.ones(4), illuminant="D65"))
        for i in range(8):
            theta = (i / 8) * 2.0 * PI + PI / 8
            sb.add_sphere((math.cos(theta), ground + r, math.sin(theta)), r,
                          Material.diffuse(hsv_to_rgb(theta - PI / 8)))
        cam = dict(origin=(0.0, 1.0, 1.5), towards=(0.0, -0.5, 0.0),
                   up=(0.0, 1.0, -1.0))
        return sb, cam, "build_camera", None
    if name == "nefertiti":
        sb = SceneBuilder()
        black = Material.diffuse((0.0, 0.0, 0.0))
        sb.add_disk((0.0, -1.0, 0.0), (0.0, 1.0, 0.0), 10.0, black)
        sb.add_disk((0.0, 1.0, 0.0), (0.0, -1.0, 0.0), 10.0, black)
        sb.add_disk((1.0, 0.0, 0.0), (-1.0, 0.0, 0.0), 10.0, black)
        sb.add_rectangle([-0.4, 0.99, -1.4], [-0.4, 0.99, -0.6],
                         [0.4, 0.99, -0.6], Material.light(1.5 * np.ones(4)))
        marble = sb.textures.marble((0.9, 0.85, 0.8))
        (_blob_mesh(pkg, 5, 21, 0.18).to_unit_size().to_origin()
         .rotate_x(-PI / 2).rotate_y(PI).set_y(-0.99)
         .translate(0.0, 0.0, -1.0)
         .add_to(sb, Material.diffuse((1.0, 1.0, 1.0), kd_tex=marble)))
        cam = dict(origin=(0.1, 0.2, 0.3), towards=(0.0, 0.1, -1.0))
        return sb, cam, "build_camera", None
    if name == "conference":
        shapes = mod("scene.shapes")
        sb = SceneBuilder()
        white = Material.diffuse((0.73, 0.71, 0.68))
        wood = Material.diffuse((0.44, 0.28, 0.16))
        gv, gf = shapes.grid_plane(n=1, size=1000.0, y=0.0)
        Mesh(gv, gf).translate(450.0, 0.0, 0.0).add_to(sb, white)
        Mesh(gv, gf).rotate_z(np.pi).translate(450.0, 500.0, 0.0).add_to(
            sb, white)
        table = np.diag([400.0, 10.0, 150.0, 1.0])
        table[:3, 3] = (450.0, 90.0, 150.0)
        sb.add_box(wood, transform=table)
        for dx in (-120.0, 0.0, 120.0):
            tr = np.eye(4)
            tr[:3, 3] = (450.0 + dx, 40.0, 150.0)
            tr[0, 0] = tr[1, 1] = tr[2, 2] = 45.0
            sb.add_box(white, transform=tr)
        sb.add_sphere((-200.0, 40.0, -400.0), 10.0, Material.light(np.ones(4)))
        sb.add_sphere((900.0, 300.0, -600.0), 10.0, Material.light(np.ones(4)))
        cam = dict(origin=(-50.0, 400.0, -350.0), towards=(500.0, 0.0, 250.0))
        return sb, cam, "build_camera", None
    if name in ("box", "caustics"):
        magenta = uplift.from_srgb8(255, 0, 255).reshape(4)
        cyan = uplift.from_srgb8(0, 255, 255).reshape(4)
        sb = mod("scene.cornell").empty_box(
            uplift.from_srgb8(242, 242, 242).reshape(4),
            Material.diffuse(magenta), Material.diffuse(cyan))
        if name == "box":
            sb.add_sphere((-0.45, -0.5, -1.5), 0.25, Material.mirror())
            sb.add_sphere((0.45, -0.5, -1.3), 0.25, Material.glass())
            return sb, cam, "build_camera", None
        suzanne = _blob_mesh(pkg, 4, 7, 0.15).to_unit_size()
        (suzanne.clone().to_origin().rotate_y(-PI / 8).rotate_z(PI / 8)
         .rotate_x(-PI / 8).translate(0.5, -0.3, -1.0)
         .add_to(sb, Material.mirror()))
        (suzanne.clone().to_origin().rotate_y(PI / 8).rotate_z(-PI / 8)
         .rotate_x(PI / 16).translate(-0.35, 0.25, -1.25)
         .add_to(sb, Material.glass()))
        return sb, dict(origin=(0.0, 0.0, 2.0), zoom=3.0), "build_camera", None
    if name == "cornell":
        return (mod("scene.cornell").cornell_box(), cam, "cornell_camera",
                "CORNELL")
    raise ValueError(name)


def _column_t_max(fn):
    """``fn`` with a 1-D last argument (t_max) passed as a column."""
    def call(*args):
        args = list(args)
        if getattr(args[-1], "ndim", 0) == 1:
            args[-1] = args[-1][:, None]
        return fn(*args)
    return call


def render_example(name, accel, res, jax_eager=False, integrator="path",
                   configure=None):
    """``example``'s image from the JAX Renderer and from the port's, both
    at ``res``^2, 1 sample per pixel, fixed Russian-roulette threshold 1
    and the square pixel filter, so that each pixel is one sample's
    radiance (with ``integrator="bdpt"`` plus the splats that land on
    it).  ``jax_eager`` runs the JAX package op by op
    (``jax.disable_jit``); ``configure(renderer, film_module)``, when
    given, configures both renderers further.

    The JAX package's BVH and kd branches of ``trace._closest`` pass a
    1-D t_max to ``sphere_t`` and ``analytic_t``, which broadcast it
    against the (N, S) candidates as a row: a scene with a tree and a
    sphere or an analytic shape (``examples/nefertiti.py``) stops there
    with a shape error.  For the reference run the two are wrapped to
    take t_max as the column that every other call site passes."""
    import contextlib
    from unittest import mock

    import jax
    from lumo_tpu import camera as jcam
    from lumo_tpu.geometry import analytic as jan
    from lumo_tpu.geometry import intersect as jgeo
    from lumo_tpu.renderer import Renderer as JRenderer
    from lumo_tpu_torch import camera as tcam
    from lumo_tpu_torch import film as tfilm
    from lumo_tpu_torch.renderer import Renderer as TRenderer
    from lumo_tpu import film as jfilm
    sb_j, cam, fn, illuminant = example_scene("lumo_tpu", name, res)
    sb_t = example_scene("lumo_tpu_torch", name, res)[0]
    js = sb_j.build(accel=accel)
    ts = sb_t.build(accel=accel, device="cpu")
    jr = (JRenderer(js, getattr(jcam, fn)(resolution=(res, res), **cam))
          .samples(1).devices(1).seed(3).fixed_rr_delta(1.0)
          .pixel_filter(jfilm.PixelFilter.square()))
    tr = (TRenderer(ts, getattr(tcam, fn)(resolution=(res, res),
                                          device="cpu", **cam))
          .samples(1).seed(3).fixed_rr_delta(1.0)
          .pixel_filter(tfilm.PixelFilter.square()))
    if illuminant:
        jr.illuminant(illuminant)
        tr.illuminant(illuminant)
    jr.integrator(integrator)
    tr.integrator(integrator)
    if configure is not None:
        configure(jr, jfilm)
        configure(tr, tfilm)
    with (jax.disable_jit() if jax_eager else contextlib.nullcontext()), \
            mock.patch.object(jan, "analytic_t",
                              _column_t_max(jan.analytic_t)), \
            mock.patch.object(jgeo, "sphere_t", _column_t_max(jgeo.sphere_t)):
        img_j = jr.render(verbose=False)
    img_t = tr.render(verbose=False)
    return js, ts, img_j, img_t


def image_agreement(img_t, img_j, flip_rtol=1e-2):
    """(flips, close share, relative mean error) of two 1-spp images: a
    pixel is a flip when it differs by more than ``flip_rtol`` (a discrete
    change of its path: another prim, checker parity or shadow decision,
    as ``tools/quality.py`` counts rays whose error is of the order of
    the radiance); the share within rtol 1e-3, atol 1e-6 and the mean
    are taken over the other pixels."""
    close_flip = np.isclose(img_t, img_j, rtol=flip_rtol, atol=1e-6).all(-1)
    close = np.isclose(img_t, img_j, rtol=1e-3, atol=1e-6).all(-1)
    keep = close_flip
    mean_j = float(img_j[keep].mean())
    rel = abs(float(img_t[keep].mean()) - mean_j) / max(abs(mean_j), 1e-30)
    return int((~keep).sum()), float(close[keep].mean()), rel


def glass_medium_scene(pkg):
    """A glass sphere on a checker-textured floor under a disk light, in
    a homogeneous medium, before a diffuse wall."""
    mod = lambda m: importlib.import_module(f"{pkg}.{m}")
    M = mod("scene.materials").Material
    sb = mod("scene.scene").SceneBuilder()
    checker = sb.textures.checkerboard((0.8, 0.8, 0.8), (0.2, 0.3, 0.6), 4.0)
    v, f = mod("scene.shapes").grid_plane(n=1, size=2.0, y=-1.0)
    sb.add_triangles(v, f, M.diffuse((1.0, 1.0, 1.0), kd_tex=checker))
    sb.add_rectangle([-2.0, -1.0, -3.0], [-2.0, 1.5, -3.0],
                     [2.0, 1.5, -3.0], M.diffuse((0.7, 0.5, 0.3)))
    sb.add_sphere((0.0, -0.55, -1.8), 0.45, M.glass())
    sb.add_disk((0.0, 1.2, -1.6), (0.0, -1.0, 0.0), 0.6, M.light(6.0))
    # coloured: the medium BxDF's pdf cancel depends on t_scale only
    # through the spread of sigma_t over the wavelengths
    sb.set_medium((0.02, 0.1, 0.3), (0.3, 0.1, 0.02), 0.3)
    return sb


def jax_nan_guards():
    """A context under which the JAX package's sphere, analytic and light
    code guards the masked lanes that make its camera gradients NaN
    (ROADMAP.md section 3): ``sqrt`` of a clamped zero in ``sphere_t``,
    ``_stable_quadratic`` and the sphere light's cone pdf, and shading
    details taken at t = INF in ``light_hit``.  Forward values are
    unchanged; the guards are the port's."""
    import contextlib
    from unittest import mock

    import jax.numpy as jnp
    from lumo_tpu.config import INF
    from lumo_tpu.geometry import analytic as jan
    from lumo_tpu.geometry import intersect as jgeo
    from lumo_tpu.scene import trace as jtrace

    def root(disc):
        pos = disc > 0.0
        return jnp.where(pos, jnp.sqrt(jnp.where(pos, disc, 1.0)), 0.0)

    def sphere_t(o, d, center, radius, t_min, t_max):
        oc = o[..., None, :] - center
        half_b = jnp.sum(oc * d[..., None, :], axis=-1)
        cc = jnp.sum(oc * oc, axis=-1) - radius * radius
        disc = half_b * half_b - cc
        q = -(half_b + jnp.sign(half_b) * root(disc))
        t0 = jnp.where(jnp.abs(q) > 0, cc / jnp.where(q == 0, 1.0, q), INF)
        lo, hi = jnp.minimum(t0, q), jnp.maximum(t0, q)
        eps = 32.0 * jnp.finfo(o.dtype).eps * jnp.maximum(jnp.abs(hi), 1.0)
        ok = disc >= 0.0
        lo_ok = ok & (lo > t_min + eps) & (lo < t_max)
        hi_ok = ok & (hi > t_min + eps) & (hi < t_max)
        return jnp.where(lo_ok, lo, jnp.where(hi_ok, hi, INF))

    def stable_quadratic(a, b, c):
        disc = b * b - 4.0 * a * c
        ok = (disc >= 0.0) & (jnp.abs(a) > 0.0)
        q = -0.5 * (b + jnp.where(b >= 0.0, 1.0, -1.0) * root(disc))
        t0 = q / jnp.where(a == 0.0, 1.0, a)
        t1 = jnp.where(q == 0.0, jnp.where(disc == 0.0, t0, INF),
                       c / jnp.where(q == 0.0, 1.0, q))
        return jnp.minimum(t0, t1), jnp.maximum(t0, t1), ok

    finite = lambda t: jnp.where(jnp.isfinite(t), t, 0.0)
    details = {mod: (name, getattr(mod, name)) for mod, name in
               ((jan, "analytic_detail"), (jgeo, "sphere_detail"))}

    def at_finite_t(fn):
        return lambda o, d, t, *rest: fn(o, d, finite(t), *rest)

    def sample_towards_pdf(scene, light, o, d, xi, ng):
        g = jtrace._light_geom(scene, light)
        dist2 = jnp.sum((xi - o) ** 2, axis=-1)
        cos_l = jnp.abs(jtrace.dot(ng, d))
        cos_ok = cos_l > 1e-7

        def by_area(area):
            den = jnp.where(cos_ok, area * cos_l, 1.0)
            return jnp.where(cos_ok, dist2 / jnp.maximum(den, 1e-30), 0.0)

        fams = [None, None, None]
        if scene.n_tris:
            fams[0] = by_area(0.5 * jnp.linalg.norm(
                jnp.cross(g["b"] - g["a"], g["c"] - g["a"]), axis=-1))
        if scene.n_spheres:
            rel = o - g["center"]
            do2 = jnp.sum(rel * rel, axis=-1)
            r2 = g["radius"] ** 2
            c2 = 1.0 - r2 / jnp.maximum(do2, 1e-30)
            cos_max = jnp.where(c2 > 0.0,
                                jnp.sqrt(jnp.where(c2 > 0.0, c2, 1.0)), 0.0)
            fams[1] = jnp.where(
                do2 < r2, by_area(4.0 * jtrace.PI * r2),
                1.0 / jnp.maximum(2.0 * jtrace.PI * (1.0 - cos_max), 1e-30))
        if scene.n_ana_lights:
            fams[2] = by_area(jtrace.PI * g["ana_radius"] ** 2)
        return jtrace._merge_fams(g, *fams)

    stack = contextlib.ExitStack()
    stack.enter_context(mock.patch.object(jgeo, "sphere_t", sphere_t))
    stack.enter_context(mock.patch.object(jan, "_stable_quadratic",
                                          stable_quadratic))
    for mod, (name, fn) in details.items():
        stack.enter_context(mock.patch.object(mod, name, at_finite_t(fn)))
    stack.enter_context(mock.patch.object(jtrace, "sample_towards_pdf",
                                          sample_towards_pdf))
    return stack
