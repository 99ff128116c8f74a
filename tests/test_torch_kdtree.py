"""The port's kd-tree path against the JAX package's: the numpy builder
table for table, the native builder as a valid kd-tree, the packer of the
CUDA kernel's layout, and the queries.

On the CPU the port's queries are the plain per-lane walk over the packed
tables the CUDA kernel reads (``kd_kernel.closest_hit_plain``).  It is held
against three yardsticks on seeded soups with dead lanes and rays lying in
a split plane: the port's dense test (t within 0 ulp, prims equal except
on counted ties of equal t), the JAX while-loop walk
``traverse.kd_closest_hit`` / ``kd_any_hit`` and the Pallas kernel in
interpret mode (t within rtol 1e-5: XLA's CPU backend contracts
multiply-adds where PyTorch rounds each operation).  Then a kd scene's
``intersect`` / ``occluded`` / ``integrate`` run in both packages on the
same tree, carried over with ``from_numpy(..., kd=...)``; lanes whose
bounce topology flips are excluded and counted, as
``tests/test_torch_path_trace.py`` does.  The CUDA kernel itself is held
against the plain walk on a card by ``tests/test_torch_cuda.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (blob_box, port_scene_from_jax, rays_into_box, soup,
                         soup_rays, t)
from lumo_tpu.accel import kdtree as jkd
from lumo_tpu.accel import pallas_kd, traverse
from lumo_tpu.color import wavelength as jwl
from lumo_tpu.integrators import path_trace as jpt
from lumo_tpu.scene import trace as jtrace
from lumo_tpu_torch.accel import build as tbuild
from lumo_tpu_torch.accel import bvh_kernel, kd_kernel
from lumo_tpu_torch.accel import kdtree as tkd
from lumo_tpu_torch.integrators import path_trace as tpt
from lumo_tpu_torch.scene import trace as ttrace

N_RAYS = 257
KD_FIELDS = ("split", "axis", "right", "first", "count", "prims", "root_lo",
             "root_hi")


def _tables(kd):
    return {"split": kd.split, "axis": kd.axis, "right": kd.right,
            "first": kd.first, "count": kd.count, "prims": kd.prims,
            "lo": kd.root_lo, "hi": kd.root_hi}


def _port_kd(kd, a, b, c):
    packed = kd_kernel.pack_kd(_tables(kd), a, b, c)
    dev = {k: torch.as_tensor(v) for k, v in packed.items()}
    dev["depth"] = kd.max_depth
    return dev


def _in_plane_rays(kd, n, seed):
    """Rays that lie exactly in split planes of the tree's first interior
    nodes: o[axis] == split and d[axis] == 0."""
    rng = np.random.default_rng(seed)
    inner = np.nonzero(kd.axis != 3)[0][:8]
    o = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    for i in range(n):
        node = inner[i % len(inner)]
        ax = kd.axis[node]
        o[i, ax] = kd.split[node]
        d[i, ax] = 0.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d, np.full(n, np.inf, np.float32)


@pytest.mark.parametrize("T", [200, 500])
def test_numpy_builder_matches_jax(T):
    a, b, c = soup(T, seed=T)
    lo, hi = tbuild.triangle_bounds(a, b, c)
    kj = jkd.build(lo, hi, use_native=False)
    kt = tkd.build(lo, hi)                       # numpy below NATIVE_FROM
    assert T < tkd.NATIVE_FROM
    for k in KD_FIELDS:
        np.testing.assert_array_equal(getattr(kt, k), getattr(kj, k),
                                      err_msg=k)
    assert kt.max_depth == kj.max_depth
    assert (tkd.COST_TRAVERSE, tkd.COST_INTERSECT, tkd.EMPTY_BONUS,
            tkd.MAX_DEPTH) == (jkd.COST_TRAVERSE, jkd.COST_INTERSECT,
                               jkd.EMPTY_BONUS, jkd.MAX_DEPTH)


def test_native_builder_is_a_valid_kdtree():
    """The port's copy of the C++ builder: children after their parent,
    every prim referenced, every referenced prim's box overlapping its
    leaf's cell, the depth as reported, and its queries equal to the dense
    test."""
    T = 3000
    a, b, c = soup(T, seed=9)
    lo, hi = tbuild.triangle_bounds(a, b, c)
    kd = tkd.build(lo, hi)                       # native from NATIVE_FROM
    assert T >= tkd.NATIVE_FROM
    M = len(kd.axis)
    inner = kd.axis != 3
    assert np.all(kd.right[inner] > np.nonzero(inner)[0])
    assert np.all(kd.right[inner] < M)
    assert np.array_equal(np.unique(kd.prims), np.arange(T))
    assert kd.max_depth == kd_kernel.kd_depth(kd.axis, kd.right)
    assert kd.max_depth <= tkd.MAX_DEPTH
    stack = [(0, kd.root_lo.astype(np.float64), kd.root_hi.astype(np.float64))]
    leaves = 0
    while stack:
        node, clo, chi = stack.pop()
        if kd.axis[node] == 3:
            ids = kd.prims[kd.first[node]: kd.first[node] + kd.count[node]]
            assert np.all(lo[ids] <= chi + 1e-6) and np.all(hi[ids] >= clo - 1e-6)
            leaves += 1
            continue
        ax, s = kd.axis[node], float(kd.split[node])
        lhi, rlo = chi.copy(), clo.copy()
        lhi[ax], rlo[ax] = s, s
        stack.append((node + 1, clo, lhi))
        stack.append((int(kd.right[node]), rlo, chi))
    assert leaves == int((~inner).sum())

    port = _port_kd(kd, a, b, c)
    o, d, t_max = (torch.as_tensor(x) for x in soup_rays(N_RAYS, seed=3))
    tri = tuple(torch.as_tensor(x) for x in (a, b, c))
    t_w, p_w = kd_kernel.closest_hit(port, o, d, t_max)
    t_d, p_d = bvh_kernel.closest_hit_plain(None, tri, o, d, t_max)
    assert torch.equal(t_w.view(torch.int32), t_d.view(torch.int32))
    assert int((p_w != p_d).sum()) <= 2           # ties of equal t only
    assert int((p_w >= 0).sum()) >= 20


def _unpack_kd(packed):
    """The kernel's layout -> the builder's flat tables (inner nodes with
    first = count = 0, leaves with split = 0 and right = 0, as the
    builders write them) and the vertices."""
    nodes = packed["nodes"]
    w1 = nodes[:, 1].view(np.uint32).astype(np.int64)
    axis, arg = w1 & 3, w1 >> 2
    leaf = axis == 3
    tris, root = packed["tris"], packed["root"]
    return {"split": np.where(leaf, 0.0, nodes[:, 0].view(np.float32))
            .astype(np.float32),
            "axis": axis, "right": np.where(leaf, 0, arg),
            "first": np.where(leaf, nodes[:, 0], 0), "count": np.where(leaf, arg, 0),
            "prims": packed["refs"], "lo": root[:3], "hi": root[3:],
            "a": tris[:, 0, :3], "b": tris[:, 1, :3], "c": tris[:, 2, :3]}


def test_pack_kd_roundtrip_and_limits():
    a, b, c = soup(300, seed=1)
    kd = tkd.build(*tbuild.triangle_bounds(a, b, c))
    tabs = _tables(kd)
    packed = kd_kernel.pack_kd(tabs, a, b, c)
    nodes, refs, tris = packed["nodes"], packed["refs"], packed["tris"]
    assert nodes.dtype == np.int32 and nodes.shape == (len(kd.axis), 2)
    assert refs.dtype == np.int32 and refs.shape == (len(kd.prims),)
    assert tris.dtype == np.float32 and tris.shape == (300, 3, 4)
    assert not tris[:, :, 3].any()
    back = _unpack_kd(packed)
    for k, v in {**tabs, "a": a, "b": b, "c": c}.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)

    def broken(key, index, value):
        bad = dict(tabs)
        bad[key] = bad[key].copy()
        bad[key][index] = value
        return bad

    leaf = kd.axis == 3
    first_leaf = int(np.nonzero(leaf)[0][0])
    first_inner = int(np.nonzero(~leaf)[0][0])
    for bad in (broken("axis", 0, 4), broken("prims", 0, len(a)),
                broken("prims", 0, -1),
                broken("right", first_inner, first_inner),
                broken("right", first_inner, len(kd.axis)),
                broken("count", first_leaf, len(kd.prims) + 1)):
        with pytest.raises(ValueError):
            kd_kernel.pack_kd(bad, a, b, c)
    # the walk and the kernel reject a tree deeper than their stack
    port = _port_kd(kd, a, b, c)
    port["depth"] = kd_kernel.STACK + 1
    o = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="depth"):
        kd_kernel.closest_hit(port, o, o, 1.0)
    with pytest.raises(ValueError, match="unsupported device"):
        kd_kernel.any_hit(port, o.to("meta"), o.to("meta"), 1.0)


def _compare_closest(t_ref, p_ref, t_got, p_got, rtol):
    """Hits agree; t within ``rtol`` (0: bit-equal); returns the number of
    lanes whose prim differs (ties of equal t between two triangles)."""
    t_ref, p_ref = np.asarray(t_ref), np.asarray(p_ref)
    hit = p_ref >= 0
    np.testing.assert_array_equal(p_got >= 0, hit)
    assert np.all(np.isinf(t_got[~hit]))
    if rtol == 0:
        np.testing.assert_array_equal(t_got[hit].view(np.int32),
                                      t_ref[hit].view(np.int32))
    else:
        np.testing.assert_allclose(t_got[hit], t_ref[hit], rtol=rtol, atol=0)
    return int((p_got != p_ref)[hit].sum())


@pytest.mark.parametrize("T", [500, 3000])
def test_walk_matches_dense_traverse_and_pallas(T):
    a, b, c = soup(T, seed=0)
    lo = np.minimum(np.minimum(a, b), c)
    hi = np.maximum(np.maximum(a, b), c)
    kd = jkd.build(lo, hi)                       # the JAX package's tree
    jkd_dev = {k: jnp.asarray(v) for k, v in _tables(kd).items()}
    blk = pallas_kd.to_device(pallas_kd.pack_kd_blocks(kd, a, b, c))
    port = _port_kd(kd, a, b, c)
    tri = tuple(torch.as_tensor(x) for x in (a, b, c))
    jtri = tuple(jnp.asarray(x) for x in (a, b, c))

    rays = [np.concatenate(p) for p in zip(soup_rays(N_RAYS, seed=T + 1),
                                           _in_plane_rays(kd, 32, seed=T))]
    o, d, t_max = rays
    dead = t_max <= 0.0
    ot, dt, tt = (torch.as_tensor(x) for x in rays)
    oj, dj, tj = (jnp.asarray(x) for x in rays)

    t_got, p_got = kd_kernel.closest_hit(port, ot, dt, tt)
    assert p_got.dtype == torch.int64
    t_got, p_got = t_got.numpy(), p_got.numpy()
    occ_got = kd_kernel.any_hit(port, ot, dt, tt).numpy()
    assert not np.any((p_got >= 0) & dead)
    assert (p_got >= 0).sum() >= 20
    assert (p_got[N_RAYS:] >= 0).sum() >= 3      # in-plane rays hit too

    t_de, p_de = bvh_kernel.closest_hit_plain(None, tri, ot, dt, tt)
    ties = _compare_closest(t_de.numpy(), p_de.numpy(), t_got, p_got, rtol=0)
    t_tr, p_tr = traverse.kd_closest_hit(jkd_dev, jtri, oj, dj, t_max=tj)
    ties += _compare_closest(t_tr, p_tr, t_got, p_got, rtol=1e-5)
    t_pl, p_pl = pallas_kd.closest_hit(blk, oj, dj, t_max=tj, interpret=True,
                                       sub=1)
    ties += _compare_closest(t_pl, p_pl, t_got, p_got, rtol=1e-5)
    assert ties <= 3

    np.testing.assert_array_equal(occ_got, p_got >= 0)
    np.testing.assert_array_equal(
        occ_got, np.asarray(traverse.kd_any_hit(jkd_dev, jtri, oj, dj,
                                                t_max=tj)))
    np.testing.assert_array_equal(
        occ_got, np.asarray(pallas_kd.any_hit(blk, oj, dj, t_max=tj,
                                              interpret=True, sub=1)))
    np.testing.assert_array_equal(
        occ_got, bvh_kernel.any_hit_plain(None, tri, ot, dt, tt).numpy())


def test_walk_keeps_the_smaller_prim_on_ties():
    """Every triangle twice (prims i and i + T): each hit is a tie of equal
    t.  The walk over the index layout keeps the smaller prim, as the
    dense test, the JAX walk and the Pallas kernel do; in-plane rays and
    dead lanes included."""
    T = 300
    a, b, c = (np.concatenate([v, v]) for v in soup(T, seed=21))
    lo = np.minimum(np.minimum(a, b), c)
    hi = np.maximum(np.maximum(a, b), c)
    kd = jkd.build(lo, hi)
    port = _port_kd(kd, a, b, c)
    rays = [np.concatenate(p) for p in zip(soup_rays(N_RAYS, seed=22),
                                           _in_plane_rays(kd, 32, seed=23))]
    ot, dt, tt = (torch.as_tensor(x) for x in rays)
    oj, dj, tj = (jnp.asarray(x) for x in rays)
    t_got, p_got = (x.numpy() for x in kd_kernel.closest_hit(port, ot, dt, tt))
    hit = p_got >= 0
    assert hit.sum() >= 20 and np.all(p_got[hit] < T)
    assert not np.any(hit & (rays[2] <= 0.0))
    tri = tuple(torch.as_tensor(x) for x in (a, b, c))
    t_de, p_de = bvh_kernel.closest_hit_plain(None, tri, ot, dt, tt)
    assert _compare_closest(t_de.numpy(), p_de.numpy(), t_got, p_got, 0) == 0
    jkd_dev = {k: jnp.asarray(v) for k, v in _tables(kd).items()}
    jtri = tuple(jnp.asarray(x) for x in (a, b, c))
    t_tr, p_tr = traverse.kd_closest_hit(jkd_dev, jtri, oj, dj, t_max=tj)
    assert _compare_closest(t_tr, p_tr, t_got, p_got, 1e-5) == 0
    blk = pallas_kd.to_device(pallas_kd.pack_kd_blocks(kd, a, b, c))
    t_pl, p_pl = pallas_kd.closest_hit(blk, oj, dj, t_max=tj, interpret=True,
                                       sub=1)
    assert _compare_closest(t_pl, p_pl, t_got, p_got, 1e-5) == 0
    np.testing.assert_array_equal(
        kd_kernel.any_hit(port, ot, dt, tt).numpy(), hit)


# ---------------------------------------------------------------------------
# a kd scene in both packages

N = 512
RTOL, ATOL = 1e-4, 1e-6


@pytest.fixture(scope="module")
def case():
    js = blob_box("lumo_tpu", 2).build(accel="kdtree")
    ts = port_scene_from_jax(js)
    assert ts.kdtree is not None and ts.bvh is None
    assert ts.n_bvh_tris == ts.n_tris          # the walls stay in the tree
    o, d = rays_into_box(N, seed=3)
    rng = np.random.default_rng(4)
    lam = np.asarray(jwl.sample(jnp.asarray(
        rng.uniform(0, 1, N).astype(np.float32))))
    key = rng.integers(0, 1 << 32, N, dtype=np.uint32)
    alive = rng.uniform(0, 1, N) > 0.1
    t_occ = rng.uniform(0.05, 3.0, N).astype(np.float32)
    t_occ[rng.uniform(0, 1, N) < 0.1] = 0.0
    return js, ts, dict(o=o, d=d, lam=lam, key=key, alive=alive, t_occ=t_occ)


def test_port_builds_the_same_kd_scene(case):
    """``SceneBuilder.build(accel="kdtree")`` of the port: the same
    triangles in the same order as the JAX package's, and a tree that
    answers as the JAX scene's does."""
    js, ts, h = case
    own = blob_box("lumo_tpu_torch", 2).build(accel="kdtree", device="cpu")
    assert own.kdtree is not None and own.n_tris == js.n_tris
    np.testing.assert_array_equal(own.tri_a.numpy(), np.asarray(js.tri_a))
    assert own.to("cpu").kdtree["nodes"].shape == own.kdtree["nodes"].shape
    h1 = ttrace.intersect(own, t(h["o"]), t(h["d"]))
    h2 = ttrace.intersect(ts, t(h["o"]), t(h["d"]))
    assert torch.equal(h1["t"].view(torch.int32), h2["t"].view(torch.int32))
    assert int((h1["prim"] != h2["prim"]).sum()) <= 2
    with pytest.raises(ValueError, match="unknown accel"):
        blob_box("lumo_tpu_torch", 2).build(accel="octree", device="cpu")


def test_kd_intersect_matches_jax(case):
    js, ts, h = case
    hj = jtrace.intersect(js, jnp.asarray(h["o"]), jnp.asarray(h["d"]),
                          alive=jnp.asarray(h["alive"]))
    ht = ttrace.intersect(ts, t(h["o"]), t(h["d"]), alive=t(h["alive"]))
    valid = np.asarray(hj["valid"])
    np.testing.assert_array_equal(ht["valid"].numpy(), valid)
    assert not valid[~h["alive"]].any()
    assert valid.sum() > N // 2
    same = valid & (ht["prim"].numpy() == np.asarray(hj["prim"]))
    assert (valid & ~same).sum() <= 2           # ties on shared edges
    for k in ("mat", "backface", "light"):
        np.testing.assert_array_equal(ht[k].numpy()[same],
                                      np.asarray(hj[k])[same], err_msg=k)
    for k in ("t", "p", "ng", "ns", "uv", "err"):
        np.testing.assert_allclose(ht[k].numpy()[same],
                                   np.asarray(hj[k])[same], rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_kd_occluded_matches_jax(case):
    js, ts, h = case
    occ_j = np.asarray(jtrace.occluded(js, jnp.asarray(h["o"]),
                                       jnp.asarray(h["d"]),
                                       jnp.asarray(h["t_occ"])))
    occ_t = ttrace.occluded(ts, t(h["o"]), t(h["d"]), t(h["t_occ"]))
    np.testing.assert_array_equal(occ_t.numpy(), occ_j)
    assert 0 < occ_j.sum() < N
    assert not occ_j[h["t_occ"] == 0.0].any()


def test_kd_integrate_matches_jax(case):
    js, ts, h = case
    r_j, lam_j, dep_j, pr_j = jpt.integrate(
        js, jnp.asarray(h["o"]), jnp.asarray(h["d"]), jnp.asarray(h["lam"]),
        ray_key=jnp.asarray(h["key"]), fixed_depth=jpt.MAX_DEPTH,
        trace_prims=True)
    r_j, lam_j, dep_j, pr_j = (np.asarray(x) for x in (r_j, lam_j, dep_j,
                                                       pr_j))
    assert dep_j.max() < jpt.MAX_DEPTH
    r_t, lam_t, dep_t, pr_t = tpt.integrate(
        ts, t(h["o"]), t(h["d"]), t(h["lam"]), ray_key=t(h["key"]),
        trace_prims=True)
    pr_t = pr_t.numpy()
    pad = np.full((jpt.MAX_DEPTH - pr_t.shape[0], N), -1, pr_t.dtype)
    same = (np.concatenate([pr_t, pad]) == pr_j).all(axis=0)
    flips = int(N - same.sum())
    assert flips <= N // 100, f"{flips} topology flips"
    np.testing.assert_array_equal(dep_t.numpy()[same], dep_j[same])
    np.testing.assert_array_equal(lam_t.numpy()[same], lam_j[same])
    np.testing.assert_allclose(r_t.numpy()[same], r_j[same], rtol=RTOL,
                               atol=ATOL)
    assert (r_j.sum(-1) > 0).sum() > N // 4
