"""The port's BVH builder and closest/any-hit queries against the JAX
package's: the numpy builder array for array, the queries (plain
versions on the CPU) against the JAX package's dense test run op by op,
the Pallas kernel in interpret mode and the JAX while-loop traversal.
Prims must agree exactly except on counted ties of equal t.  t is
bit-equal to the op-by-op dense test; the Pallas and while-loop walks
are compiled whole by XLA, whose CPU backend contracts multiply-adds
into fused ones, so their t may differ by a few ulps.  The CUDA kernel
itself is held against the plain version on a card by
``tests/test_torch_cuda.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import soup as _soup
from _torch_port import soup_rays as _rays
from lumo_tpu.accel import build as jbuild
from lumo_tpu.accel import pallas_bvh
from lumo_tpu.accel import traverse
from lumo_tpu.geometry import intersect as jgeo
from lumo_tpu_torch.accel import build as tbuild
from lumo_tpu_torch.accel import bvh_kernel

N_RAYS = 257


def _tables(bvh):
    return {"lo": bvh.node_lo, "hi": bvh.node_hi, "right": bvh.node_right,
            "first": bvh.node_first, "count": bvh.node_count,
            "axis": bvh.node_axis}


def _port_bvh(tabs, a, b, c, depth):
    return {"nodes": torch.as_tensor(bvh_kernel.pack_nodes(tabs)),
            "tris": torch.as_tensor(bvh_kernel.pack_tris(a, b, c)),
            "depth": depth}


def _compare_closest(t_ref, p_ref, t_got, p_got, dead, ulps=0):
    """Prims equal except on ties (t within ``ulps``, counted); t within
    ``ulps`` on hits (0: bit-equal).  Returns the tie count."""
    t_ref, p_ref = np.asarray(t_ref), np.asarray(p_ref)
    hit = p_ref >= 0
    np.testing.assert_array_equal(p_got >= 0, hit)
    assert not np.any(hit & dead)
    gap = np.abs(t_got.view(np.int32).astype(np.int64)
                 - t_ref.view(np.int32).astype(np.int64))
    assert gap[hit].max(initial=0) <= ulps
    assert np.all(np.isinf(t_got[~hit]))
    diff = p_got != p_ref
    assert np.all(gap[diff] <= ulps)
    return int(diff.sum())


def _dense_jax(ap, bp, cp, o, d, t_max):
    """The JAX package's brute force, op by op (as tests/test_pallas_bvh
    runs it): (t, prim) with prim -1 on a miss."""
    kz, shear = jgeo.ray_setup(d)
    t_all, _, _ = jgeo.triangle_t(o, kz, shear, jnp.asarray(ap)[None],
                                  jnp.asarray(bp)[None],
                                  jnp.asarray(cp)[None], 0.0,
                                  t_max[:, None])
    t = jnp.min(t_all, axis=-1)
    return t, jnp.where(jnp.isfinite(t), jnp.argmin(t_all, axis=-1), -1)


@pytest.mark.parametrize("T", [500, 3000])
def test_numpy_builder_matches_jax(T):
    a, b, c = _soup(T, seed=T)
    lo, hi = jbuild.triangle_bounds(a, b, c)
    lo2, hi2 = tbuild.triangle_bounds(a, b, c)
    np.testing.assert_array_equal(lo2, lo)
    np.testing.assert_array_equal(hi2, hi)
    bj = jbuild.build(lo, hi, use_native=False)
    bt = tbuild.build(lo2, hi2)                 # numpy below 4096 prims
    for k in ("node_lo", "node_hi", "node_right", "node_first", "node_count",
              "node_axis", "order"):
        np.testing.assert_array_equal(getattr(bt, k), getattr(bj, k),
                                      err_msg=k)
    assert bt.depth == bj.depth


def test_native_builder_is_a_valid_bvh():
    """The port's copy of the C++ builder: every prim in exactly one leaf
    of at most LEAF_SIZE, every box bounding its prims, and its queries
    equal the dense test."""
    a, b, c = _soup(5000, seed=9)
    lo, hi = tbuild.triangle_bounds(a, b, c)
    bvh = tbuild.build(lo, hi)                  # native from 4096 prims
    leaf = bvh.node_count > 0
    assert bvh.node_count.max() <= tbuild.LEAF_SIZE
    assert np.array_equal(np.sort(bvh.order), np.arange(5000))
    for i in np.nonzero(leaf)[0]:
        ids = bvh.order[bvh.node_first[i]: bvh.node_first[i]
                        + bvh.node_count[i]]
        assert np.all(lo[ids] >= bvh.node_lo[i] - 1e-6)
        assert np.all(hi[ids] <= bvh.node_hi[i] + 1e-6)
    assert bvh.depth == _depth(bvh)


def _depth(bvh):
    from lumo_tpu_torch.scene.scene import _bvh_depth
    return _bvh_depth(bvh.node_right, bvh.node_count)


def test_pack_nodes_roundtrip():
    a, b, c = _soup(700, seed=1)
    bvh = tbuild.build(*tbuild.triangle_bounds(a, b, c))
    packed = bvh_kernel.pack_nodes(_tables(bvh))
    w0 = packed[:, 0, 3].view(np.uint32).astype(np.int64)
    w1 = packed[:, 1, 3].view(np.uint32).astype(np.int64)
    inner = bvh.node_count == 0
    np.testing.assert_array_equal((w0 >> 2)[inner], bvh.node_right[inner])
    np.testing.assert_array_equal((w0 & 3)[inner], bvh.node_axis[inner])
    np.testing.assert_array_equal(w1 & 7, bvh.node_count)
    np.testing.assert_array_equal((w1 >> 3)[~inner], bvh.node_first[~inner])
    np.testing.assert_array_equal(packed[:, 0, :3], bvh.node_lo)
    np.testing.assert_array_equal(packed[:, 1, :3], bvh.node_hi)
    with pytest.raises(ValueError):
        bad = _tables(bvh)
        bad["count"] = bad["count"].copy()
        bad["count"][-1] = 8
        bvh_kernel.pack_nodes(bad)


@pytest.mark.parametrize("T", [500, 3000])
def test_queries_match_pallas_and_traverse(T):
    a, b, c = _soup(T, seed=0)
    lo, hi = jbuild.triangle_bounds(a, b, c)
    bvh = jbuild.build(lo, hi, use_native=False)
    ap, bp, cp = a[bvh.order], b[bvh.order], c[bvh.order]
    tabs = _tables(bvh)
    blk = pallas_bvh.to_device(pallas_bvh.pack_blocks(tabs, ap, bp, cp))
    o, d, t_max = _rays(N_RAYS, seed=T + 1)
    dead = t_max <= 0.0
    oj, dj, tj = jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max)

    port = _port_bvh(tabs, ap, bp, cp, bvh.depth)
    tri = tuple(torch.as_tensor(x) for x in (ap, bp, cp))
    ot, dt, tt = (torch.as_tensor(x) for x in (o, d, t_max))
    t_got, p_got = bvh_kernel.closest_hit(port, tri, ot, dt, tt)
    assert p_got.dtype == torch.int64
    t_got, p_got = t_got.numpy(), p_got.numpy()
    occ_got = bvh_kernel.any_hit(port, tri, ot, dt, tt).numpy()

    t_de, p_de = _dense_jax(ap, bp, cp, oj, dj, tj)
    ties = _compare_closest(t_de, p_de, t_got, p_got, dead)
    t_pl, p_pl = pallas_bvh.closest_hit(blk, oj, dj, t_max=tj,
                                        interpret=True, sub=1)
    ties += _compare_closest(t_pl, p_pl, t_got, p_got, dead, ulps=4)
    jbvh = {k: jnp.asarray(v) for k, v in tabs.items()}
    jtri = tuple(jnp.asarray(x) for x in (ap, bp, cp))
    t_tr, p_tr = traverse.closest_hit(jbvh, jtri, oj, dj, t_max=tj)
    ties += _compare_closest(t_tr, p_tr, t_got, p_got, dead, ulps=4)
    assert ties <= 2
    assert (p_got >= 0).sum() >= 20

    occ_pl = np.asarray(pallas_bvh.any_hit(blk, oj, dj, t_max=tj,
                                           interpret=True, sub=1))
    occ_tr = np.asarray(traverse.any_hit(jbvh, jtri, oj, dj, t_max=tj))
    np.testing.assert_array_equal(occ_got, occ_pl)
    np.testing.assert_array_equal(occ_got, occ_tr)
    np.testing.assert_array_equal(occ_got, p_got >= 0)


def test_plain_versions_chunk_consistently():
    """Chunked dense test: a tiny chunk budget gives the same answer as
    one chunk, ties to the lowest prim id across chunk edges."""
    a, b, c = _soup(300, seed=5)
    a = np.concatenate([a, a])                 # every prim duplicated:
    b = np.concatenate([b, b])                 # all hits are exact ties
    c = np.concatenate([c, c])
    o, d, t_max = _rays(128, seed=6)
    args = tuple(torch.as_tensor(x) for x in (o, d, t_max))
    tri = tuple(torch.as_tensor(x) for x in (a, b, c))
    t1, p1 = bvh_kernel.closest_hit_plain(None, tri, *args)
    hit = p1 >= 0
    assert bool(hit.any()) and bool((p1[hit] < 300).all())
    real = bvh_kernel._chunks
    try:
        bvh_kernel._chunks = lambda o, T: (7, 64)
        t2, p2 = bvh_kernel.closest_hit_plain(None, tri, *args)
        occ2 = bvh_kernel.any_hit_plain(None, tri, *args)
    finally:
        bvh_kernel._chunks = real
    assert torch.equal(p1, p2) and torch.equal(t1, t2)
    assert torch.equal(occ2, hit)


def test_wrapper_rejects_other_devices():
    a, b, c = _soup(64, seed=2)
    bvh = tbuild.build(*tbuild.triangle_bounds(a, b, c))
    port = _port_bvh(_tables(bvh), a[bvh.order], b[bvh.order],
                     c[bvh.order], bvh.depth)
    o = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        bvh_kernel.closest_hit(port, None, o, o, 1.0)
    with pytest.raises(ValueError, match="unsupported device"):
        bvh_kernel.any_hit(port, None, o, o, 1.0)


@pytest.mark.parametrize("T", [500, 3000])
def test_stats_walk_matches_dense_and_counts(T):
    """``closest_hit_stats`` on the CPU walks the packed nodes and
    triangles the CUDA kernel reads: the same t (bit-equal) and prims as
    the dense plain version, and per-warp counters that are positive where
    a warp has a live lane and zero where all its lanes are dead."""
    a, b, c = _soup(T, seed=3)
    bvh = tbuild.build(*tbuild.triangle_bounds(a, b, c))
    ap, bp, cp = a[bvh.order], b[bvh.order], c[bvh.order]
    port = _port_bvh(_tables(bvh), ap, bp, cp, bvh.depth)
    tri = tuple(torch.as_tensor(x) for x in (ap, bp, cp))
    o, d, t_max = _rays(N_RAYS, seed=T + 7)
    t_max[:64] = 0.0                            # two whole warps dead
    ot, dt, tt = (torch.as_tensor(x) for x in (o, d, t_max))
    t_s, p_s, stats = bvh_kernel.closest_hit_stats(port, tri, ot, dt, tt)
    t_d, p_d = bvh_kernel.closest_hit_plain(port, tri, ot, dt, tt)
    assert torch.equal(t_s.view(torch.int32), t_d.view(torch.int32))
    assert torch.equal(p_s, p_d)
    assert int((p_s >= 0).sum()) >= 10
    W = (N_RAYS + 31) // 32
    assert stats.shape == (W, 2, 3) and stats.dtype == torch.int32
    total, peak = stats[:, 0], stats[:, 1]
    assert not bool(stats[:2].any())            # dead warps count nothing
    live = torch.as_tensor(t_max > 0).float()
    lanes = torch.zeros(W * 32).index_put_((torch.arange(N_RAYS),), live)
    has_live = lanes.view(W, 32).sum(1) > 0
    # every live lane fetches the root, an interior node
    assert bool((total[has_live, 0] > 0).all())
    assert bool((peak <= total).all()) and bool((total <= 32 * peak).all())
    assert int(total[:, 1].sum()) > 0 and int(total[:, 2].sum()) > 0
    # a leaf holds at most LEAF_SIZE triangles
    assert bool((total[:, 2] <= tbuild.LEAF_SIZE * total[:, 1]).all())
    # a deeper tree than the stack is rejected
    with pytest.raises(ValueError, match="depth"):
        bvh_kernel.closest_hit_stats(dict(port, depth=bvh_kernel.STACK + 1),
                                     tri, ot, dt, tt)
