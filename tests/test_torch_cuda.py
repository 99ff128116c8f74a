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
