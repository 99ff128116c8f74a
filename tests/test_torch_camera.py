"""The camera's bidirectional side (``c2r``, ``image_plane_area`` and the
eleven queries the BDPT integrator makes) against the JAX package, for a
pinhole and a thin-lens perspective camera and for an orthographic camera
without and with a lens (``examples/dof.py``'s).

Inputs are numpy-seeded: world points around the view, lens uniforms and
the directions from sampled lens points.  ``ok`` flags and the lens
points' raster flags must be equal; floats agree within rtol 1e-5, atol
1e-6 (atol 1e-4 on raster coordinates): the two packages round the
(N, 3) @ (3, 3) products differently (``test_torch_examples_tex.py``
gives the measurement).
"""
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_port import t
from lumo_tpu import camera as jcam
from lumo_tpu_torch import camera as tcam

N = 512
RTOL, ATOL = 1e-5, 1e-6

CAMERAS = {
    "pinhole": dict(origin=(0.1, 0.2, 0.3), towards=(0.0, 0.1, -1.0),
                    resolution=(24, 16)),
    "thin_lens": dict(origin=(0.0, 0.3, 1.0), towards=(0.2, -0.1, -1.5),
                      lens_radius=0.05, focal_length=2.2, vfov=60.0,
                      resolution=(16, 24)),
    "orthographic": dict(origin=(0.0, 1.0, 1.5), towards=(0.0, -0.5, 0.0),
                         up=(0.0, 1.0, -1.0), zoom=0.8,
                         kind=jcam.ORTHOGRAPHIC, resolution=(16, 16)),
    "dof": dict(origin=(-0.75, 0.25, 0.0), towards=(0.0, -0.75, -1.0),
                lens_radius=0.03, focal_length=float(np.linalg.norm(
                    np.array([-0.75, 1.0, 1.0]))),
                kind=jcam.ORTHOGRAPHIC, resolution=(16, 16)),
}


@pytest.fixture(scope="module", params=sorted(CAMERAS))
def cams(request):
    kw = CAMERAS[request.param]
    cj = jcam.build_camera(**kw)
    ct = tcam.build_camera(device="cpu", **kw)
    rng = np.random.default_rng(sorted(CAMERAS).index(request.param))
    # world points in front of the camera and around its view
    centre = np.asarray(cj.c2w_t) + 2.0 * np.asarray(cj.c2w_rot)[:, 2]
    xi = (centre + rng.uniform(-1.5, 1.5, (N, 3))).astype(np.float32)
    u = rng.uniform(0, 1, (N, 2)).astype(np.float32)
    w, h = kw["resolution"]
    raster = (rng.uniform(0, 1, (N, 2)) * [w, h]).astype(np.float32)
    o, d = (np.asarray(x) for x in cj.generate_ray(jnp.asarray(raster),
                                                    jnp.asarray(u)))
    return cj, ct, dict(xi=xi, u=u, o=o, d=d, raster=raster)


def _lensed_ortho(camera):
    return camera.kind == tcam.ORTHOGRAPHIC and float(camera.lens_radius) > 0


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


def test_built_tables_match_jax(cams):
    cj, ct, _ = cams
    for k in ("r2c", "c2r", "c2w_rot", "c2w_t", "lens_radius", "focal_length",
              "image_plane_area"):
        np.testing.assert_array_equal(getattr(ct, k).numpy(),
                                      np.asarray(getattr(cj, k)), err_msg=k)
    close(ct.lens_area(), cj.lens_area())


def test_frame_transforms_match_jax(cams):
    cj, ct, h = cams
    for name in ("to_world_dir", "to_local_dir", "to_world_pt",
                 "to_local_pt"):
        close(getattr(ct, name)(t(h["xi"])),
              getattr(cj, name)(jnp.asarray(h["xi"])))
    # world -> local -> world is the identity
    close(ct.to_world_pt(ct.to_local_pt(t(h["xi"]))), h["xi"], atol=1e-5)


def test_raster_xy_matches_jax(cams):
    """The camera's own rays map back to the raster points they were
    generated from (but through an orthographic lens, whose inverse lookup
    reads the origin alone, as the reference's does); random rays get the
    same flags in both packages."""
    cj, ct, h = cams
    r_t, ok_t = ct.raster_xy(t(h["o"]), t(h["d"]))
    r_j, ok_j = cj.raster_xy(jnp.asarray(h["o"]), jnp.asarray(h["d"]))
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    close(r_t, r_j, atol=1e-4)
    ok = ok_t.numpy()
    if not _lensed_ortho(ct):
        assert ok.mean() > 0.95
        np.testing.assert_allclose(r_t.numpy()[ok], h["raster"][ok],
                                   rtol=1e-4, atol=2e-3)
    rng = np.random.default_rng(7)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    r_t, ok_t = ct.raster_xy(t(h["xi"]), t(d))
    r_j, ok_j = cj.raster_xy(jnp.asarray(h["xi"]), jnp.asarray(d))
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    close(r_t, r_j, atol=1e-4)


def test_sample_towards_matches_jax(cams):
    cj, ct, h = cams
    o_t, d_t, ok_t = ct.sample_towards(t(h["xi"]), t(h["u"]))
    o_j, d_j, ok_j = cj.sample_towards(jnp.asarray(h["xi"]),
                                       jnp.asarray(h["u"]))
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    assert 0 < ok_t.sum() < N
    close(o_t, o_j)
    close(d_t, d_j)
    # the ray from the lens point reaches xi
    along = ((h["xi"] - o_t.numpy()) * d_t.numpy()).sum(-1)
    assert (along > 0).all()


def test_importance_and_pdfs_match_jax(cams):
    cj, ct, h = cams
    o_t, d_t, _ = ct.sample_towards(t(h["xi"]), t(h["u"]))
    o_j, d_j, _ = cj.sample_towards(jnp.asarray(h["xi"]), jnp.asarray(h["u"]))
    close(ct.pdf_importance(o_t, d_t, t(h["xi"])),
          cj.pdf_importance(o_j, d_j, jnp.asarray(h["xi"])))
    imp_t, r_t, ok_t = ct.sample_importance(o_t, d_t)
    imp_j, r_j, ok_j = cj.sample_importance(o_j, d_j)
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    close(imp_t, imp_j)
    close(r_t, r_j, atol=1e-4)
    assert (imp_t.numpy()[ok_t.numpy()] > 0).all()
    # the lens points and directions of the camera's own rays (an
    # orthographic lens bends its rays off the axis, where pdf_wi is 0)
    pdf_xo = ct.pdf_xo(t(h["o"]))
    pdf_wi = ct.pdf_wi(t(h["o"]), t(h["d"]))
    close(pdf_xo, cj.pdf_xo(jnp.asarray(h["o"])))
    close(pdf_wi, cj.pdf_wi(jnp.asarray(h["o"]), jnp.asarray(h["d"])))
    assert (pdf_xo.numpy() > 0).all()
    if not _lensed_ortho(ct):
        assert (pdf_wi.numpy() > 0).mean() > 0.9
    close(ct.pdf_xo(o_t), cj.pdf_xo(o_j))
    close(ct.pdf_wi(o_t, d_t), cj.pdf_wi(o_j, d_j))
