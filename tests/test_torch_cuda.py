"""The CUDA kernel against its plain version, on a card.

The kernel has no CPU mode, so every test here is marked ``cuda`` and
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

from _torch_port import blob_box, rays_into_box
from lumo_tpu_torch.accel import build as tbuild
from lumo_tpu_torch.accel import bvh_kernel

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _soup_rays(T, N, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1, 1, (T, 3)).astype(np.float32)
    b = a + rng.uniform(-0.25, 0.25, (T, 3)).astype(np.float32)
    c = a + rng.uniform(-0.25, 0.25, (T, 3)).astype(np.float32)
    o = rng.uniform(-2, 2, (N, 3)).astype(np.float32)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = np.full(N, np.inf, np.float32)
    t_max[: N // 8] = 0.0                                  # dead lanes
    t_max[N // 8: N // 2] = rng.uniform(0.05, 3.0, N // 2 - N // 8)
    rng.shuffle(t_max)
    return (a, b, c), (o, d, t_max)


def test_kernel_matches_plain(card):
    """Prims exact and t bit-equal on a random soup with dead and seeded
    lanes; one launch counted per call."""
    (a, b, c), rays = _soup_rays(3000, 65536, seed=7)
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
    tri = tuple(torch.as_tensor(x, device=card) for x in (ap, bp, cp))
    o, d, t_max = (torch.as_tensor(x, device=card) for x in rays)
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
    counts = torch.zeros(2, dtype=torch.int64, device=card)
    seen = torch.zeros(M + T, dtype=torch.uint8, device=card)
    t_c, p_c = bvh_kernel.closest_hit(port, tri, o, d, t_max, counts=counts,
                                      seen=seen)
    assert torch.equal(p_c, p_k) and torch.equal(t_c, t_k)
    n_nodes, n_tris = counts.tolist()
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
    assert all(bvh_kernel.LAUNCHES[k] > before[k] for k in before)
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
