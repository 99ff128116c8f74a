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


def _unpack_records(records, lo_root, hi_root):
    """The kernel's child-pair records -> the builder's binary DFS tables
    (``lo``, ``hi``, ``right``, ``first``, ``count``; inner nodes with
    first = count = 0, leaves with right = 0), walking record 0 down."""
    links = records[:, :2, 3].view(np.int32)
    out = {k: [] for k in ("lo", "hi", "right", "first", "count")}

    def emit(link, lo, hi):
        me = len(out["lo"])
        out["lo"].append(lo)
        out["hi"].append(hi)
        leaf = link >= bvh_kernel.LEAF_LINK
        code = int(link) - bvh_kernel.LEAF_LINK if leaf else 0
        out["first"].append(code >> 3)
        out["count"].append(code & 7)
        out["right"].append(0)
        if not leaf:
            rec = records[link]
            emit(links[link, 0], rec[0, :3], rec[1, :3])
            out["right"][me] = len(out["lo"])
            emit(links[link, 1], rec[2, :3], rec[3, :3])

    emit(0, lo_root, hi_root)
    return {k: np.asarray(v) for k, v in out.items()}


def test_pack_nodes_roundtrip():
    a, b, c = _soup(700, seed=1)
    bvh = tbuild.build(*tbuild.triangle_bounds(a, b, c))
    packed = bvh_kernel.pack_nodes(_tables(bvh))
    inner = bvh.node_count == 0
    assert packed.dtype == np.float32
    assert packed.shape == (int(inner.sum()), 4, 4)
    assert not packed[:, 2:, 3].any()
    back = _unpack_records(packed, bvh.node_lo[0], bvh.node_hi[0])
    for k in ("lo", "hi", "right", "first", "count"):
        want = getattr(bvh, f"node_{k}")
        if k in ("right", "first"):
            want = np.where(inner if k == "first" else ~inner, 0, want)
        np.testing.assert_array_equal(back[k], want, err_msg=k)
    # a tree that is one leaf: one record, the second child an empty leaf
    one = bvh_kernel.pack_nodes({"lo": [[0, 0, 0]], "hi": [[1, 1, 1]],
                                 "right": [0], "first": [0], "count": [3],
                                 "axis": [0]})
    assert one.shape == (1, 4, 4)
    assert one[0, :2, 3].view(np.int32).tolist() == [
        bvh_kernel.LEAF_LINK + 3, bvh_kernel.LEAF_LINK]
    assert not np.isnan(packed).any()
    for key, index, value in (("count", -1, 8), ("axis", 0, 3),
                              ("right", 0, 1)):
        bad = _tables(bvh)
        bad[key] = bad[key].copy()
        bad[key][index] = value
        with pytest.raises(ValueError):
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

    # the walk over the child-pair records gives the dense answer
    t_st, p_st, _ = bvh_kernel.closest_hit_stats_plain(port, tri, ot, dt, tt)
    assert _compare_closest(t_de, p_de, t_st.numpy(), p_st.numpy(), dead) == 0

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


def test_stats_walk_counts_a_hand_counted_tree():
    """Three unit triangles at z = 0, 2 and 4, facing +z, in a tree of a
    root, an inner node and three one-triangle leaves (leaf A, z = 0; leaf
    B, z = 2; leaf C, z = 4; the inner node holds A and B).  Counted by
    hand over the child-pair records (record 0: the inner node and C;
    record 1: A and B), per ray (inner records fetched, leaves entered,
    triangles tested):

    - ray 0, from z = -1 along +z: record 0 hits both children, the inner
      node (entry 1) before C (entry 5, stacked); record 1 hits A (entry
      1) and B (entry 3, stacked); A is tested (t = 1); B pops with entry
      3 >= 1 and C with 5 >= 1: both skipped.  (2, 1, 1), t = 1, prim 0;
    - ray 1, from z = 5 along -z: C (entry 1) before the inner node
      (entry 3); C tested (t = 1); the inner node pops with 3 >= 1,
      skipped.  (1, 1, 1), t = 1, prim 2;
    - ray 2, from z = 3 along -z: the inner node only (C lies behind);
      B (entry 1) before A (entry 3); B tested (t = 1), A skipped.
      (2, 1, 1), t = 1, prim 1;
    - ray 3, beside the triangles, misses every box: (1, 0, 0);
    - ray 4, dead (t_max 0): (0, 0, 0).
    """
    z = np.array([0.0, 2.0, 4.0], np.float32)
    a = np.stack([np.zeros(3), np.zeros(3), z], 1).astype(np.float32)
    b = np.stack([np.ones(3), np.zeros(3), z], 1).astype(np.float32)
    c = np.stack([np.zeros(3), np.ones(3), z], 1).astype(np.float32)
    lo = np.minimum(np.minimum(a, b), c)
    hi = np.maximum(np.maximum(a, b), c)
    # DFS: 0 root, 1 inner (A, B), 2 leaf A, 3 leaf B, 4 leaf C
    tabs = {"lo": np.stack([lo.min(0), lo[:2].min(0), lo[0], lo[1], lo[2]]),
            "hi": np.stack([hi.max(0), hi[:2].max(0), hi[0], hi[1], hi[2]]),
            "right": np.array([4, 3, 0, 0, 0]),
            "first": np.array([0, 0, 0, 1, 2]),
            "count": np.array([0, 0, 1, 1, 1]),
            "axis": np.array([2, 2, 0, 0, 0])}
    port = _port_bvh(tabs, a, b, c, depth=3)
    o = torch.tensor([[0.25, 0.25, -1.0], [0.25, 0.25, 5.0],
                      [0.25, 0.25, 3.0], [3.0, 3.0, -1.0],
                      [0.25, 0.25, -1.0]])
    d = torch.tensor([[0.0, 0.0, 1.0], [0.0, 0.0, -1.0], [0.0, 0.0, -1.0],
                      [0.0, 0.0, 1.0], [0.0, 0.0, 1.0]])
    t_max = torch.tensor([np.inf, np.inf, np.inf, np.inf, 0.0])
    tri = tuple(torch.as_tensor(x) for x in (a, b, c))
    t_s, p_s, stats = bvh_kernel.closest_hit_stats(port, tri, o, d, t_max)
    assert p_s.tolist() == [0, 2, 1, -1, -1]
    assert t_s.tolist() == [1.0, 1.0, 1.0, np.inf, np.inf]
    per_ray = [(2, 1, 1), (1, 1, 1), (2, 1, 1), (1, 0, 0), (0, 0, 0)]
    assert stats.shape == (1, 2, 3)
    assert stats[0, 0].tolist() == [sum(r[k] for r in per_ray)
                                    for k in range(3)]
    assert stats[0, 1].tolist() == [max(r[k] for r in per_ray)
                                    for k in range(3)]
