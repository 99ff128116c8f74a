"""The CUDA kernels against their plain versions, on a card.

The kernels have no CPU mode, so every test here is marked ``cuda`` and
skips where torch sees no card.  The file imports neither JAX nor
lumo_tpu, so it runs on a machine with only the port's dependencies:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(``--noconftest``: ``tests/conftest.py`` configures JAX for the other
test files.)
"""
from unittest import mock

import numpy as np
import pytest
import torch

from _torch_port import blob_box, rays_into_box, soup, soup_rays
from lumo_tpu_torch.accel import build as tbuild
from lumo_tpu_torch.accel import bvh_kernel, kd_kernel
from lumo_tpu_torch.accel import kdtree as tkd
from lumo_tpu_torch.tools import exp_sync

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _port_bvh(a, b, c, card):
    bvh = tbuild.build(*tbuild.triangle_bounds(a, b, c))
    ap, bp, cp = a[bvh.order], b[bvh.order], c[bvh.order]
    tabs = {"lo": bvh.node_lo, "hi": bvh.node_hi, "right": bvh.node_right,
            "first": bvh.node_first, "count": bvh.node_count,
            "axis": bvh.node_axis}
    port = {"nodes": torch.as_tensor(bvh_kernel.pack_nodes(tabs),
                                     device=card),
            "tris": torch.as_tensor(bvh_kernel.pack_tris(ap, bp, cp),
                                    device=card),
            "depth": bvh.depth}
    return port, tuple(torch.as_tensor(x, device=card) for x in (ap, bp, cp))


def _port_kd(a, b, c, card):
    kd = tkd.build(*tbuild.triangle_bounds(a, b, c))
    tabs = {"split": kd.split, "axis": kd.axis, "right": kd.right,
            "first": kd.first, "count": kd.count, "prims": kd.prims,
            "lo": kd.root_lo, "hi": kd.root_hi}
    port = {k: torch.as_tensor(v, device=card)
            for k, v in kd_kernel.pack_kd(tabs, a, b, c).items()}
    port["depth"] = kd.max_depth
    return port


def test_kernel_matches_plain(card):
    """Prims exact and t bit-equal on a random soup with dead and seeded
    lanes; one launch counted per call."""
    port, tri = _port_bvh(*soup(3000, seed=7), card)
    o, d, t_max = (torch.as_tensor(x, device=card)
                   for x in soup_rays(65536, seed=7))
    before = dict(bvh_kernel.LAUNCHES)
    t_k, p_k = bvh_kernel.closest_hit(port, tri, o, d, t_max)
    occ_k = bvh_kernel.any_hit(port, tri, o, d, t_max)
    t_p, p_p = bvh_kernel.closest_hit_plain(port, tri, o, d, t_max)
    occ_p = bvh_kernel.any_hit_plain(port, tri, o, d, t_max)
    torch.cuda.synchronize()
    assert bvh_kernel.LAUNCHES["closest"] == before["closest"] + 1
    assert bvh_kernel.LAUNCHES["any"] == before["any"] + 1
    assert int((p_k >= 0).sum()) > 1000
    assert torch.equal(p_k, p_p)
    assert torch.equal(t_k.view(torch.int32), t_p.view(torch.int32))
    assert torch.equal(occ_k, occ_p)
    # the counting launch: same answer, and the distinct nodes and
    # triangles it marks number no more than its visits and tests
    M, T = port["nodes"].shape[0], port["tris"].shape[0]
    counts = torch.zeros(4, dtype=torch.int64, device=card)
    seen = torch.zeros(M + T, dtype=torch.uint8, device=card)
    t_c, p_c = bvh_kernel.closest_hit(port, tri, o, d, t_max, counts=counts,
                                      seen=seen)
    assert torch.equal(p_c, p_k) and torch.equal(t_c, t_k)
    n_nodes, n_tris, w_inner, w_leaf = counts.tolist()
    # SIMT efficiency of each phase lies in (0, 1]
    assert 0 < n_nodes <= 32 * w_inner and 0 < n_tris <= 32 * w_leaf
    assert 0 < int(seen[:M].sum()) <= min(M, n_nodes)
    assert 0 < int(seen[M:].sum()) <= min(T, n_tris)
    assert int(seen[0]) == 1 and int(seen.max()) == 1


def test_render_through_kernel_matches_plain(card):
    """The slice on a 332-triangle blob scene: ``integrate`` through the
    kernel and through the plain versions gives the same prim sequence,
    depth and radiance (rtol 1e-5) on every lane."""
    from lumo_tpu_torch.color import wavelength
    from lumo_tpu_torch.integrators import path_trace
    scene = blob_box("lumo_tpu_torch", 2).build(device=card)
    o, d = (torch.as_tensor(x, device=card) for x in rays_into_box(1024, 3))
    gen = torch.Generator(device=card).manual_seed(5)
    lam = wavelength.sample(torch.rand(1024, generator=gen, device=card))
    key = path_trace.ray_keys(gen, 1024, device=card)
    before = dict(bvh_kernel.LAUNCHES)
    r_k, _, dep_k, pr_k = path_trace.integrate(scene, o, d, lam,
                                               ray_key=key, trace_prims=True)
    assert all(bvh_kernel.LAUNCHES[k] > before[k] for k in ("closest", "any"))
    with mock.patch.object(bvh_kernel, "closest_hit",
                           bvh_kernel.closest_hit_plain), \
            mock.patch.object(bvh_kernel, "any_hit", bvh_kernel.any_hit_plain):
        r_p, _, dep_p, pr_p = path_trace.integrate(scene, o, d, lam,
                                                   ray_key=key,
                                                   trace_prims=True)
    assert torch.equal(pr_k, pr_p)
    assert torch.equal(dep_k, dep_p)
    torch.testing.assert_close(r_k, r_p, rtol=1e-5, atol=1e-7)
    assert float(r_k.sum()) > 0.0


@pytest.mark.parametrize("accel", ["bvh", "kdtree"])
def test_float64_queries_take_the_plain_route(card, accel):
    """A float64 scene's closest and any-hit queries on the card take the
    float64 plain route: no kernel launch, one plain query each counted,
    prims, hit masks and occlusion equal to the CPU's float64 answers and
    t within rtol 1e-12; a float16 query still raises at the kernel's
    entry point."""
    from lumo_tpu_torch import config
    from lumo_tpu_torch.scene import trace
    mod = kd_kernel if accel == "kdtree" else bvh_kernel
    o, d = (torch.as_tensor(x, dtype=torch.float64)
            for x in rays_into_box(4096, 11))
    t_max = torch.linspace(0.1, 3.0, 4096, dtype=torch.float64)
    config.use_f64(True)
    try:
        got = []
        for dev in ("cpu", card):
            scene = blob_box("lumo_tpu_torch", 2).build(
                accel=accel, dtype=np.float64, device=dev)
            launches, plain = dict(mod.LAUNCHES), dict(mod.PLAIN_F64)
            hit = trace.intersect(scene, o.to(dev), d.to(dev))
            occ = trace.occluded(scene, o.to(dev), d.to(dev), t_max.to(dev))
            assert mod.LAUNCHES == launches
            assert all(mod.PLAIN_F64[k] == plain[k] + 1
                       for k in ("closest", "any"))
            got.append((hit["prim"].cpu(), hit["valid"].cpu(),
                        hit["t"].cpu(), occ.cpu()))
    finally:
        config.use_f64(False)
    (p_c, v_c, t_c, occ_c), (p_g, v_g, t_g, occ_g) = got
    assert t_g.dtype == torch.float64 and int(v_c.sum()) > 1000
    assert torch.equal(p_g, p_c) and torch.equal(v_g, v_c)
    assert torch.equal(occ_g, occ_c)
    torch.testing.assert_close(t_g[v_c], t_c[v_c], rtol=1e-12, atol=0.0)
    half = o.to(card, torch.float16)
    args = ((scene.kdtree,) if accel == "kdtree"
            else (scene.bvh, trace._bvh_tris(scene)))
    with pytest.raises(TypeError, match="float32"):
        mod.closest_hit(*args, half, half, 1.0)


def test_kernel_on_flattened_instance_rays_matches_plain(card):
    """K2 on the rays of an instanced group's flattened query
    (``trace._flat_rays``): 8,192 world rays in the local spaces of eight
    rotated, non-uniformly scaled instances, so 65,536 rays with
    unnormalised directions.  Prims exact and t bit-equal against the
    plain version, any-hit equal; t stays the world parameter: the local
    hit point mapped back equals o + t d."""
    from lumo_tpu_torch.scene import trace
    from lumo_tpu_torch.scene.instance import rotate_y, scale, translation
    port, tri = _port_bvh(*soup(3000, seed=11), card)
    o, d, t_max = (torch.as_tensor(x, device=card)
                   for x in soup_rays(8192, seed=11))
    ms = [translation(0.2 * i - 0.7, 0.1 * (i % 3), -0.3 * (i % 2))
          @ rotate_y(0.4 * i) @ scale(0.5 + 0.1 * i, 1.4 - 0.1 * i, 0.8)
          for i in range(8)]
    f32 = lambda x: torch.as_tensor(np.stack(x), dtype=torch.float32,
                                    device=card)
    grp = {"minv": f32([np.linalg.inv(m[:3, :3]) for m in ms]),
           "trans": f32([m[:3, 3] for m in ms])}
    ol, dl = trace._flat_rays(grp, o, d)
    assert ol.shape == dl.shape == (8192 * 8, 3) and dl.is_contiguous()
    assert float((dl.norm(dim=1) - 1.0).abs().max()) > 0.1
    tm = t_max.repeat_interleave(8)
    before = dict(bvh_kernel.LAUNCHES)
    t_k, p_k = bvh_kernel.closest_hit(port, tri, ol, dl, tm)
    occ_k = bvh_kernel.any_hit(port, tri, ol, dl, tm)
    t_p, p_p = bvh_kernel.closest_hit_plain(port, tri, ol, dl, tm)
    occ_p = bvh_kernel.any_hit_plain(port, tri, ol, dl, tm)
    torch.cuda.synchronize()
    assert bvh_kernel.LAUNCHES["closest"] == before["closest"] + 1
    assert int((p_k >= 0).sum()) > 1000
    assert torch.equal(p_k, p_p)
    assert torch.equal(t_k.view(torch.int32), t_p.view(torch.int32))
    assert torch.equal(occ_k, occ_p)
    hit = p_k >= 0
    fwd = f32([m[:3, :3] for m in ms]).repeat(8192, 1, 1)[hit]
    p_local = (ol + t_k[:, None] * dl)[hit]
    p_world = torch.einsum("nij,nj->ni", fwd, p_local) \
        + grp["trans"].repeat(8192, 1)[hit]
    ow = o.repeat_interleave(8, dim=0)[hit]
    dw = d.repeat_interleave(8, dim=0)[hit]
    torch.testing.assert_close(p_world, ow + t_k[hit, None] * dw,
                               rtol=1e-4, atol=1e-4)


def test_stats_kernel_matches_plain_walk(card):
    """K2 stats: t, prim and every per-warp counter equal the per-lane
    plain walk over the same packed tables, and the closest-hit entry.
    8,201 rays end in a warp of 9 lanes and leave the last block two
    warps without a ray."""
    a, b, c = soup(3000, seed=7)
    port, tri = _port_bvh(a, b, c, card)
    o, d, t_max = (torch.as_tensor(x, device=card)
                   for x in soup_rays(8201, seed=8))
    before = bvh_kernel.LAUNCHES["stats"]
    t_k, p_k, s_k = bvh_kernel.closest_hit_stats(port, tri, o, d, t_max)
    assert bvh_kernel.LAUNCHES["stats"] == before + 1
    t_p, p_p, s_p = bvh_kernel.closest_hit_stats_plain(port, tri, o, d, t_max)
    t_c, p_c = bvh_kernel.closest_hit(port, tri, o, d, t_max)
    torch.cuda.synchronize()
    assert torch.equal(t_k.view(torch.int32), t_p.view(torch.int32))
    assert s_k.shape == (257, 2, 3) and s_k.dtype == torch.int32
    assert torch.equal(p_k, p_p) and torch.equal(s_k, s_p)
    assert torch.equal(t_k, t_c) and torch.equal(p_k, p_c)
    counts = torch.zeros(4, dtype=torch.int64, device=card)
    bvh_kernel.closest_hit(port, tri, o, d, t_max, counts=counts)
    total = s_k[:, 0].sum(0).tolist()
    assert [total[0], total[2]] == counts[:2].tolist()


def test_kd_kernel_matches_plain_walk(card):
    """K3: t bit-equal and prims equal to the plain walk over the same
    packed tables, every occlusion flag equal, t bit-equal to the dense
    test; dead lanes, finite t_max and rays lying in a split plane."""
    a, b, c = soup(3000, seed=11)
    kd = tkd.build(*tbuild.triangle_bounds(a, b, c))
    port = _port_kd(a, b, c, card)
    o, d, t_max = soup_rays(32768, seed=12)
    inner = np.nonzero(kd.axis != 3)[0][:64]
    for i, node in enumerate(inner):            # rays in split planes
        o[i, kd.axis[node]] = kd.split[node]
        d[i, kd.axis[node]] = 0.0
        d[i] /= np.linalg.norm(d[i])
        t_max[i] = np.inf
    o, d, t_max = (torch.as_tensor(x, device=card) for x in (o, d, t_max))
    tri = tuple(torch.as_tensor(x, device=card) for x in (a, b, c))
    before = dict(kd_kernel.LAUNCHES)
    t_k, p_k = kd_kernel.closest_hit(port, o, d, t_max)
    occ_k = kd_kernel.any_hit(port, o, d, t_max)
    assert kd_kernel.LAUNCHES == {"closest": before["closest"] + 1,
                                  "any": before["any"] + 1}
    t_p, p_p = kd_kernel.closest_hit_plain(port, o, d, t_max)
    occ_p = kd_kernel.any_hit_plain(port, o, d, t_max)
    t_d, p_d = bvh_kernel.closest_hit_plain(None, tri, o, d, t_max)
    torch.cuda.synchronize()
    assert int((p_k >= 0).sum()) > 1000
    assert torch.equal(t_k.view(torch.int32), t_p.view(torch.int32))
    assert torch.equal(p_k, p_p)
    assert torch.equal(occ_k, occ_p) and torch.equal(occ_k, p_k >= 0)
    assert torch.equal(t_k.view(torch.int32), t_d.view(torch.int32))
    assert int((p_k != p_d).sum()) <= 8         # ties of equal t only
    M, R, T = (port[k].shape[0] for k in ("nodes", "refs", "tris"))
    counts = torch.zeros(4, dtype=torch.int64, device=card)
    seen = torch.zeros(M + R + T, dtype=torch.uint8, device=card)
    t_c, p_c = kd_kernel.closest_hit(port, o, d, t_max, counts=counts,
                                     seen=seen)
    assert torch.equal(p_c, p_k) and torch.equal(t_c, t_k)
    n_nodes, n_tris, w_inner, w_leaf = counts.tolist()
    assert 0 < n_nodes <= 32 * w_inner and 0 < n_tris <= 32 * w_leaf
    assert 0 < int(seen[:M].sum()) <= min(M, n_nodes)
    assert 0 < int(seen[M:M + R].sum()) <= min(R, n_tris)
    assert 0 < int(seen[M + R:].sum()) <= min(T, int(seen[M:M + R].sum()))
    with pytest.raises(ValueError, match="depth"):
        kd_kernel.closest_hit(dict(port, depth=kd_kernel.STACK + 1), o, d,
                              t_max)


def test_kd_render_through_kernel_matches_plain(card):
    """A kd scene through the Renderer with the kernel and with the plain
    walk: the same image but for the order of the film's atomic adds."""
    from lumo_tpu_torch.camera import build_camera
    from lumo_tpu_torch.renderer import Renderer
    scene = blob_box("lumo_tpu_torch", 2).build(accel="kdtree", device=card)
    cam = build_camera(resolution=(32, 32), device=card)
    before = dict(kd_kernel.LAUNCHES)
    img_k = Renderer(scene, cam).samples(2).render(verbose=False)
    assert all(kd_kernel.LAUNCHES[k] > before[k] for k in before)
    with mock.patch.object(kd_kernel, "closest_hit",
                           kd_kernel.closest_hit_plain), \
            mock.patch.object(kd_kernel, "any_hit", kd_kernel.any_hit_plain):
        img_p = Renderer(scene, cam).samples(2).render(verbose=False)
    np.testing.assert_allclose(img_k, img_p, rtol=1e-5, atol=1e-6)
    assert float(img_k.mean()) > 0.01


@pytest.mark.parametrize("accel", ["bvh", "kdtree"])
@pytest.mark.parametrize("integrator", ["direct", "bdpt"])
def test_direct_and_bdpt_through_kernel_match_plain(card, accel, integrator):
    """The direct-light and bidirectional integrators through the
    Renderer with K2 or K3 and with the plain versions: the same image but
    for the order of the film's atomic adds.  BDPT's light subpaths,
    connection rays and dead lanes (t_max 0) go through the kernels."""
    from lumo_tpu_torch import film
    from lumo_tpu_torch.camera import build_camera
    from lumo_tpu_torch.renderer import Renderer
    mod = kd_kernel if accel == "kdtree" else bvh_kernel
    scene = blob_box("lumo_tpu_torch", 2).build(accel=accel, device=card)
    cam = build_camera(resolution=(24, 24), device=card)

    def frame():
        return (Renderer(scene, cam).integrator(integrator).samples(1)
                .fixed_rr_delta(1.0).pixel_filter(film.PixelFilter.square())
                .render(verbose=False))

    before = dict(mod.LAUNCHES)
    img_k = frame()
    assert all(mod.LAUNCHES[k] > before[k] for k in ("closest", "any"))
    with mock.patch.object(mod, "closest_hit", mod.closest_hit_plain), \
            mock.patch.object(mod, "any_hit", mod.any_hit_plain):
        img_p = frame()
    np.testing.assert_allclose(img_k, img_p, rtol=1e-5, atol=1e-6)
    assert np.isfinite(img_k).all() and float(img_k.mean()) > 0.01


# the traversal kernels at the edges of their ray scheduling: no ray,
# fewer rays than a warp, a ragged last warp, dead lanes (t_max 0, -1 and
# NaN), and more rays than the card holds resident threads
SIZES = {"no_rays": 0, "under_a_warp": 19, "ragged": 1013,
         "dead_lanes": 4099, "beyond_the_grid": None}
QUERIES = ("bvh_closest", "bvh_any", "bvh_stats", "kd_closest", "kd_any")


@pytest.fixture(scope="module")
def soup_ports():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    card = torch.device("cuda")
    a, b, c = soup(3000, seed=31)
    bvh, tri = _port_bvh(a, b, c, card)
    return {"bvh": (bvh, tri), "kd": _port_kd(a, b, c, card)}


def _query(name, ports, o, d, t_max, plain):
    """One query of the named kernel (or of its plain version) -> a tuple
    of outputs."""
    mod = bvh_kernel if name.startswith("bvh") else kd_kernel
    kind = name.split("_")[1]
    fn = {"closest": "closest_hit", "any": "any_hit",
          "stats": "closest_hit_stats"}[kind] + ("_plain" if plain else "")
    args = ports["bvh"] if mod is bvh_kernel else (ports["kd"],)
    out = getattr(mod, fn)(*args, o, d, t_max)
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("query", QUERIES)
def test_traversal_kernels_at_the_edges(soup_ports, query, size):
    """Each kernel against its plain version at the edges of the ray
    scheduling, launched twice in a row: the second launch (with a work
    counter of its own, for the BVH kernel) gives the same answer."""
    mod = bvh_kernel if query.startswith("bvh") else kd_kernel
    kind = query.split("_")[1]
    n = SIZES[size]
    per_sm, _ = mod.grid(kind, 1)
    resident = per_sm * torch.cuda.get_device_properties(0).multi_processor_count
    if n is None:
        n = 2 * resident * 128 + 13
    # the BVH kernel launches at most the resident grid, the kd kernel one
    # thread per ray
    blocks = -(-n // 128)
    assert mod.grid(kind, n)[1] == (min(resident, blocks)
                                    if mod is bvh_kernel else blocks)
    o, d, t_max = soup_rays(n, seed=n + 5)
    if size == "dead_lanes":
        t_max[::3] = 0.0
        t_max[1::7] = np.nan
        t_max[2::11] = -1.0
    card = torch.device("cuda")
    o, d, t_max = (torch.as_tensor(x, device=card) for x in (o, d, t_max))
    before = sum(mod.LAUNCHES.values())
    first = _query(query, soup_ports, o, d, t_max, plain=False)
    second = _query(query, soup_ports, o, d, t_max, plain=False)
    assert sum(mod.LAUNCHES.values()) == before + 2
    want = _query(query, soup_ports, o, d, t_max, plain=True)
    torch.cuda.synchronize()
    for got in (first, second):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.dtype == w.dtype
            if g.dtype == torch.float32:
                g, w = g.view(torch.int32), w.view(torch.int32)
            assert torch.equal(g, w)
    if n and kind != "stats":
        dead = ~(t_max > 0)
        assert not bool(first[-1][dead].any() if kind == "any"
                        else (first[1][dead] >= 0).any())


@pytest.mark.parametrize("variant", exp_sync.VARIANTS)
def test_exp_sync_kernel_matches_plain(card, variant):
    """K4: every variant's output bit-equal to the plain loop at 1,000
    trips."""
    x = torch.full(exp_sync.TILE, 0.5, device=card)
    before = exp_sync.LAUNCHES["exp_sync"]
    out_k = exp_sync.run(variant, x, 1000)
    assert exp_sync.LAUNCHES["exp_sync"] == before + 1
    out_p = exp_sync.run_plain(variant, x, 1000)
    torch.cuda.synchronize()
    assert torch.equal(out_k.view(torch.int32), out_p.view(torch.int32))


# ---------------------------------------------------------------------------
# the differentiable path and the stream through the kernels

def _grad_render(scene, cam, weight, checkpoint=True):
    """A fixed-depth (4) fwd+bwd of sum(weight * r^2) at 32x32 with every
    float material leaf and ``c2w_t`` as leaves -> (loss, grads, prims,
    the kernel launches of the forward and of the backward)."""
    import dataclasses
    from lumo_tpu_torch.integrators import path_trace
    from lumo_tpu_torch.sampling.samplers import _hash_u32, _randfloat
    from lumo_tpu_torch.color import wavelength
    mod = kd_kernel if scene.kdtree is not None else bvh_kernel
    dev = scene.device
    mats = {k: v.clone().requires_grad_(True)
            for k, v in scene.materials.items() if v.is_floating_point()}
    c2w_t = cam.c2w_t.clone().requires_grad_(True)
    n = 32 * 32
    pix = torch.arange(n, device=dev)
    raster = torch.stack([(pix % 32).float() + _randfloat(pix, 0x51633E2D),
                          (pix // 32).float() + _randfloat(pix, 0x68BC21EB)],
                         -1)
    o, d = dataclasses.replace(cam, c2w_t=c2w_t).generate_ray(
        raster, torch.full_like(raster, 0.5))
    lam = wavelength.sample(_randfloat(pix, 0x02E5BE93))
    sc = dataclasses.replace(scene, materials={**scene.materials, **mats})
    before = dict(mod.LAUNCHES)
    r, _, _, prims = path_trace.integrate(sc, o, d, lam, ray_key=_hash_u32(pix),
                                          fixed_depth=4, trace_prims=True,
                                          checkpoint=checkpoint)
    loss = (weight[:, None] * r * r).sum()
    fwd = {k: mod.LAUNCHES[k] - before[k] for k in ("closest", "any")}
    loss.backward()
    bwd = {k: mod.LAUNCHES[k] - before[k] - fwd[k] for k in fwd}
    grads = {k: v.grad for k, v in mats.items()}
    grads["c2w_t"] = c2w_t.grad
    return loss.detach(), grads, prims, fwd, bwd


@pytest.mark.parametrize("accel", ["bvh", "kdtree"])
def test_fwd_bwd_through_kernel_matches_plain(card, accel):
    """A fwd+bwd through K2 (K3) equals the same fwd+bwd routed to the
    plain versions, on lanes whose prims agree (the rest weighted out and
    held under 1%): gradients within rtol 1e-4 plus 1e-5 of their largest
    entry (the card's scatter-adds sum in any order).  The kernels launch
    once per bounce in the forward and never in the backward, with the
    checkpoint on and off."""
    from lumo_tpu_torch.camera import build_camera
    mod = kd_kernel if accel == "kdtree" else bvh_kernel
    scene = blob_box("lumo_tpu_torch", 2).build(accel=accel, device=card)
    cam = build_camera(resolution=(32, 32), device=card)
    ones = torch.ones(32 * 32, device=card)
    _, _, pr_k, fwd, bwd = _grad_render(scene, cam, ones)
    assert fwd == {"closest": 4, "any": 4} and bwd == {"closest": 0, "any": 0}
    with mock.patch.object(mod, "closest_hit", mod.closest_hit_plain), \
            mock.patch.object(mod, "any_hit", mod.any_hit_plain):
        _, _, pr_p, _, _ = _grad_render(scene, cam, ones)
    same = (pr_k == pr_p).all(dim=0)
    assert int((~same).sum()) <= same.numel() // 100
    w = same.float()
    loss_k, g_k, _, _, bwd_k = _grad_render(scene, cam, w)
    _, g_off, _, _, bwd_off = _grad_render(scene, cam, w, checkpoint=False)
    assert bwd_k == bwd_off == {"closest": 0, "any": 0}
    with mock.patch.object(mod, "closest_hit", mod.closest_hit_plain), \
            mock.patch.object(mod, "any_hit", mod.any_hit_plain):
        loss_p, g_p, _, _, _ = _grad_render(scene, cam, w)
    assert torch.isfinite(loss_k) and float(loss_k) > 0.0
    torch.testing.assert_close(loss_k, loss_p, rtol=1e-5, atol=0.0)
    for k, gk in g_k.items():
        if gk is None:
            assert g_p[k] is None and g_off[k] is None, k
            continue
        assert bool(torch.isfinite(gk).all()), k
        scale = float(gk.abs().max())
        for other in (g_p[k], g_off[k]):
            torch.testing.assert_close(gk, other, rtol=1e-4,
                                       atol=1e-5 * max(scale, 1e-30))


def _jvp_render(scene, cam, mod, rr=False):
    """Forward mode of a 32x32 render (fixed depth 4, or Russian roulette)
    with a tangent on ``c2w_t`` and on the vertex table ``tri_b``:
    (radiance, its tangent, prims, launches)."""
    import dataclasses

    from torch.autograd import forward_ad

    from lumo_tpu_torch.color import wavelength
    from lumo_tpu_torch.integrators import path_trace
    g = torch.Generator(device="cpu").manual_seed(3)
    n = 32 * 32
    raster = (torch.rand(n, 2, generator=g) * 32).to(scene.device)
    lam = wavelength.sample(torch.rand(n, generator=g).to(scene.device))
    key = torch.randint(0, 1 << 32, (n,), generator=g).to(scene.device)
    db = 0.05 * torch.randn(scene.tri_b.shape, generator=g)
    before = dict(mod.LAUNCHES)
    with torch.no_grad(), forward_ad.dual_level():
        c2w_t = forward_ad.make_dual(cam.c2w_t, torch.tensor(
            [0.3, -0.2, 0.5], device=scene.device))
        sc = dataclasses.replace(scene, tri_b=forward_ad.make_dual(
            scene.tri_b, db.to(scene.device)))
        o, d = dataclasses.replace(cam, c2w_t=c2w_t).generate_ray(
            raster, torch.full_like(raster, 0.5))
        r, _, _, prims = path_trace.integrate(
            sc, o, d, lam, ray_key=key, fixed_depth=None if rr else 4,
            trace_prims=True)
        r, tan = forward_ad.unpack_dual(r)
    launches = {k: mod.LAUNCHES[k] - before[k] for k in ("closest", "any")}
    return r, tan, prims, launches


@pytest.mark.parametrize("rr", [False, True], ids=["fixed", "rr"])
@pytest.mark.parametrize("accel", ["bvh", "kdtree"])
def test_forward_tangent_through_kernel_matches_plain(card, accel, rr):
    """A forward-mode render (tangents on the camera origin and a vertex
    table) through K2 (K3) equals the same routed to the plain versions
    on lanes whose prims agree (the rest held under 1%): radiance within
    rtol 1e-5, tangents within rtol 1e-4 plus 1e-5 of their largest
    entry.  The kernels launch once a bounce: no dual ray reaches them."""
    from lumo_tpu_torch.camera import build_camera
    mod = kd_kernel if accel == "kdtree" else bvh_kernel
    scene = blob_box("lumo_tpu_torch", 2).build(accel=accel, device=card)
    cam = build_camera(resolution=(32, 32), device=card)
    r_k, tan_k, pr_k, launches = _jvp_render(scene, cam, mod, rr)
    assert launches["closest"] == launches["any"] == pr_k.shape[0] >= 4
    with mock.patch.object(mod, "closest_hit", mod.closest_hit_plain), \
            mock.patch.object(mod, "any_hit", mod.any_hit_plain):
        r_p, tan_p, pr_p, _ = _jvp_render(scene, cam, mod, rr)
    n = max(pr_k.shape[0], pr_p.shape[0])
    pad = lambda p: torch.cat([p, p.new_full((n - p.shape[0], p.shape[1]),
                                             -1)])
    same = (pad(pr_k) == pad(pr_p)).all(dim=0)
    assert int((~same).sum()) <= same.numel() // 100
    assert bool(torch.isfinite(tan_k).all())
    scale = float(tan_p[same].abs().max())
    assert scale > 0.0
    torch.testing.assert_close(r_k[same], r_p[same], rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(tan_k[same], tan_p[same], rtol=1e-4,
                               atol=1e-5 * scale)


def test_stream_on_the_card_matches_batch(card):
    """``integrate_stream`` through K2 against batch ``integrate`` per
    sample: depth equal and radiance within rtol 1e-5, atol 1e-7 on all but
    under 1% of the samples, every sample folded once."""
    from lumo_tpu_torch.camera import build_camera
    from lumo_tpu_torch.color import wavelength
    from lumo_tpu_torch.integrators import path_trace
    from lumo_tpu_torch.sampling.samplers import _hash_u32, _randfloat
    scene = blob_box("lumo_tpu_torch", 2).build(device=card)
    cam = build_camera(resolution=(32, 32), device=card)
    n_pix, spp = 32 * 32, 8
    n = n_pix * spp

    def gen(idx):
        p, s = idx % n_pix, idx // n_pix
        raster = torch.stack([(p % 32).float() + _randfloat(p, s ^ 0x51633E2D),
                              (p // 32).float() + _randfloat(p, s ^ 0x68BC21EB)],
                             -1)
        o, d = cam.generate_ray(raster, torch.full_like(raster, 0.5))
        return {"o": o, "d": d,
                "lam": wavelength.sample(_randfloat(p, s ^ 0x02E5BE93)),
                "rng": _hash_u32(p ^ _hash_u32(s ^ 0x9E3779B9)), "samp": idx}

    def fold(acc, term, st):
        rad, dep, cnt = acc
        return (rad.index_add(0, st["samp"],
                              torch.where(term[:, None], st["radiance"], 0.0)),
                dep.index_add(0, st["samp"], torch.where(term, st["depth"], 0)),
                cnt.index_add(0, st["samp"], term.int()))

    before = bvh_kernel.LAUNCHES["closest"]
    acc0 = (torch.zeros((n, 4), device=card),
            torch.zeros(n, dtype=torch.int32, device=card),
            torch.zeros(n, dtype=torch.int32, device=card))
    rad, dep, cnt = path_trace.integrate_stream(scene, gen, fold, acc0, 2048, n)
    assert bvh_kernel.LAUNCHES["closest"] > before
    assert bool((cnt == 1).all())
    smp = gen(torch.arange(n, device=card))
    r_b, _, dep_b = path_trace.integrate(scene, smp["o"], smp["d"], smp["lam"],
                                         ray_key=smp["rng"])
    close = (torch.isclose(rad, r_b, rtol=1e-5, atol=1e-7).all(dim=1)
             & (dep == dep_b))
    assert int((~close).sum()) <= n // 100
    assert float(r_b.sum()) > 0.0


def test_two_gloo_ranks_on_one_card_match_one_device(card, tmp_path):
    """Two gloo ranks sharing the card render the bench scene at 64^2
    through ``.devices(2)``: the same image on both, equal to the
    one-device image within rtol 1e-4, atol 1e-5, and K2 closest and any
    launched on both ranks.  The kernels and the tree builder are built
    here first, so the ranks do not build them at once."""
    import _torch_shard_worker as worker
    import chip_smoke
    from lumo_tpu_torch import native
    from lumo_tpu_torch.camera import build_camera
    from lumo_tpu_torch.renderer import Renderer
    bvh_kernel.LIB.load()
    native.load("bvh")
    worker.spawn(worker.bench_ranks, 2, f"file://{tmp_path}/rendezvous",
                 str(tmp_path), 64)
    outs = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
            for r in range(2)]
    scene = chip_smoke.bench_scene(card)
    one = Renderer(scene, build_camera(resolution=(64, 64), device=card)) \
        .samples(worker.SPP).render(verbose=False)
    for out in outs:
        assert out["launches"]["closest"] > 0 and out["launches"]["any"] > 0
    assert np.array_equal(outs[0]["image"], outs[1]["image"])
    assert np.isfinite(one).all() and one.mean() > 0
    np.testing.assert_allclose(outs[0]["image"], one, rtol=1e-4, atol=1e-5)


def test_example_program_runs_on_the_card(card, tmp_path):
    """A user's command, ``python -m lumo_tpu_torch.examples.cornell --res
    32 --spp 1``, in a subprocess on the card: exit code 0 and a 32x32
    PNG that the port's decoder reads."""
    import os
    import subprocess
    import sys
    from lumo_tpu_torch.io import image
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = tmp_path / "cornell.png"
    res = subprocess.run(
        [sys.executable, "-m", "lumo_tpu_torch.examples.cornell", "--res",
         "32", "--spp", "1", "--out", str(out)], cwd=tmp_path,
        env=dict(os.environ, PYTHONPATH=root), capture_output=True,
        text=True, timeout=600)
    assert res.returncode == 0, res.stderr
    assert "saved" in res.stdout
    assert image.decode_png(out.read_bytes()).shape == (32, 32, 3)


def test_smoke_gate_on_the_card(card):
    """``tools/smoke.py`` at subdiv 3 (1,292 and 20,492 triangles): ok,
    K2 launched on both BVH scenes and K3 on the kd one, each closest-hit
    query equal to its plain walk on the checked rays (prims equal, t
    bit-equal)."""
    from lumo_tpu_torch.tools import smoke
    out = smoke.run(subdiv=3, device=card)
    assert out["ok"], out
    assert out["backend"] == torch.cuda.get_device_name(card)
    # one closest query a scene, and the fwd+bwd's two bounces of K2
    # closest and any on the first
    assert out["bvh"]["launches"] == {"closest": 3, "any": 3}
    for name in ("bvh", "bvh_large", "kd"):
        rec = out[name]
        assert rec["launches"]["closest"] == (3 if name == "bvh" else 1)
        assert rec["vs_plain_walk"]["t"] == "bit-equal"
        assert rec["vs_plain_walk"]["hits"] > 0
        assert rec["hits"] > rec["rays"] // 2
        assert len(rec["blocks"]) == 2
    assert out["bvh_large"]["tris"] > out["bvh"]["tris"]


def test_bench_entry_on_the_card(card):
    """``python -m lumo_tpu_torch.bench --res 16 --spp 1 --subdiv 3`` in a
    subprocess on the card: exit code 0, bench.py's keys in the last
    line, no sub with an error, K2 launched in the bvh, smoke and quality
    subs and K3 in the smoke gate's kd scene."""
    import json
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run(
        [sys.executable, "-m", "lumo_tpu_torch.bench", "--res", "16",
         "--spp", "1", "--subdiv", "3"], cwd=root, capture_output=True,
        text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-2000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert set(line) == {"metric", "value", "unit", "vs_baseline", "extra"}
    extra = line["extra"]
    assert not [k for k in ("bvh", "bdpt", "smoke", "quality")
                if "error" in extra[k]]
    assert extra["smoke"]["ok"] and line["value"] > 0
    assert min(extra["bvh"]["k2_launches"]["stream"].values()) > 0
    assert min(extra["bvh"]["k2_launches"]["fwd_bwd"].values()) > 0
    assert extra["quality"]["k2_launches"]["closest"] > 0
    assert extra["smoke"]["bvh_large"]["launches"]["closest"] > 0
    assert extra["smoke"]["kd"]["launches"]["closest"] > 0
    assert extra["card"] != "cpu"
