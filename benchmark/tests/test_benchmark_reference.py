"""The plain reference against the port at a tiny size on the CPU (the
test imports both; the reference imports neither the port nor JAX)."""
import os

import numpy as np
import pytest
import torch

from conftest import BENCH, tiny


def _groups(workload):
    from lumobench import cells
    return cells.scene_groups(tiny(workload).config)


@pytest.mark.parametrize("workload,spp,batch", [
    ("cornell.render", 4, 2), ("blob327k.render", 4, 2),
    ("blob327k.render", 3, 3)])
def test_render_matches_the_port(workload, spp, batch):
    """Every pixel of a pass, two batch steps (the second under the
    adaptive threshold the first left) or one."""
    from lumo_tpu_torch.renderer import Renderer
    from lumobench import program
    from reference.camera import Camera
    from reference.render import render_pixels
    from reference.scene import Scene
    cell = tiny(workload)
    groups = _groups(workload)
    res = (16, 16)
    scene = program.build_scene(groups, "bvh", "cpu")
    cam = program.build_camera(cell.config["camera"], res, "cpu")
    img = Renderer(scene, cam).samples(spp).seed(2 ** 31 + 5) \
        .batch_samples(batch).render(verbose=False).reshape(-1, 3)
    ref = render_pixels(Scene(groups, "cpu"),
                        Camera(cell.config["camera"], res, "cpu"), spp,
                        2 ** 31 + 5, np.arange(256), batch=batch).numpy()
    np.testing.assert_allclose(img, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("workload", ["cornell.grad", "blob327k.grad"])
def test_gradients_match_the_port(workload):
    from lumobench import check, inputs, program
    from reference.camera import Camera
    from reference.render import grad_step, loss_r2, loss_rgb
    from reference.scene import Scene
    cell = tiny(workload)
    g = cell.config["grad"]
    groups = _groups(workload)
    rays = inputs.grad_rays(Camera(cell.config["camera"], (16, 16), "cpu"),
                            inputs.step_samples(4294967311, 2, 2), "cpu")
    sc, leaves = program.grad_leaves(program.build_scene(groups, "bvh",
                                                         "cpu"))
    lp, gp = program.grad_step(sc, leaves, rays, g["depth"],
                               program.loss_fn(g))
    lr, gr = grad_step(Scene(groups, "cpu"), *rays, g["depth"],
                       loss_rgb(*g["wb"]) if g["loss"] == "rgb2" else loss_r2)
    assert check.loss_rel(lp, float(lr)) < 1e-6
    assert check.grad_rel(gp, {k: v.numpy() for k, v in gr.items()}) < 1e-5
    assert any(np.abs(v.numpy()).max() > 0 for v in gr.values())


def test_cluster_queries_are_exact():
    """The cluster hierarchy finds the dense test's nearest hit and any
    hit on rays from inside and outside the mesh."""
    from reference.geometry import INF, ray_setup, triangle_t
    from reference.scene import Scene
    scene = Scene(_groups("blob327k.render"), "cpu")
    lo, hi = scene.spans[-1]
    assert scene.clusters[-1] is not None
    g = torch.Generator().manual_seed(3)
    n = 4096
    o = torch.rand((n, 3), generator=g) * torch.tensor([1.6, 1.2, 1.6]) \
        - torch.tensor([0.8, 0.6, 2.3])
    d = torch.nn.functional.normalize(torch.randn((n, 3), generator=g), dim=1)
    t_max = torch.where(torch.rand(n, generator=g) < 0.2, 0.3, INF)
    t, p = scene.closest(o, d, t_max)
    kz, shear = ray_setup(d)
    tri = [scene.tri[k][None] for k in "abc"]
    dense, _, _ = triangle_t(o, kz, shear, *tri, 0.0, t_max[:, None])
    td, pd = dense.min(dim=1)
    pd = torch.where(torch.isfinite(td), pd, -1)
    assert torch.equal(t, td) and torch.equal(p, pd)
    assert (p >= lo).sum() > n // 10
    assert torch.equal(scene.occluded(o, d, t_max),
                       torch.isfinite(dense).any(dim=1))


@pytest.mark.parametrize("name", ["spectra.npz", "uplift_srgb_64.npz"])
def test_frozen_data_equals_the_ports(name):
    """The reference's frozen data files hold what the port ships: the
    same arrays under the same names.  A later change to the port's file
    fails here and leaves the reference's copy as it was."""
    port = os.path.join(os.path.dirname(BENCH), "lumo_tpu_torch", "color",
                        "data", name)
    with np.load(os.path.join(BENCH, "reference", "data", name)) as ref, \
            np.load(port) as got:
        assert sorted(ref.files) == sorted(got.files)
        for k in ref.files:
            np.testing.assert_array_equal(ref[k], got[k])
