"""The port's driver entry points (``lumo_tpu_torch/graft_entry.py``)
against the JAX package's ``__graft_entry__.py``, on the CPU at 8x8.

- ``entry()``: the port's forward step on the Cornell box against
  ``path_trace.integrate`` on ``__graft_entry__._tiny_scene_camera(8)``
  with the same rays, wavelengths and ``ray_key`` (numpy seeds), 4,096
  of them through the step.  The box's light lies in the ceiling's plane
  (ROADMAP.md section 3), so lanes whose bounce prims differ are counted
  (at most 1%; each must begin on a light or ceiling triangle of that
  plane in both packages) and left out; the rest agree within rtol
  1e-4.
- The training step's loss and gradients on one device against
  ``jax.value_and_grad`` of the same loss, written here from the JAX
  package's public calls, on ``_rich_scene_camera(8)``'s scene carried
  across with ``from_numpy``: loss rtol 1e-5, each table's gradient within
  rtol 1e-4 plus 1e-5 of its largest entry (``test_torch_grad.py``'s
  bar); the SGD update is ``v - 1e-3 g``.
- ``dryrun_multichip(2, device="cpu")``, and over 4 ranks: the gloo
  ranks agree bit for bit; their ``pmean``'d gradients equal the mean of
  the blocks taken on one device (rtol 2e-4, atol 1e-6, the multi-device
  tests' bar), the ``psum``'d BDPT film one device's film (rtol 1e-4,
  atol 1e-5); the scaling protocol reports 1, 2 (and 4) devices, the
  two-rank count of four ranks on a sub-mesh; the summary line is
  printed.
- Without a card, the entry points raise unless given ``device="cpu"``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as jge
from _torch_port import port_scene_from_jax, t
from lumo_tpu import film as jfilm
from lumo_tpu.color import wavelength as jwl
from lumo_tpu.integrators import path_trace as jpt
from lumo_tpu_torch import graft_entry as ge
from lumo_tpu_torch.camera import build_camera
from lumo_tpu_torch.color import uplift
from lumo_tpu_torch.integrators import path_trace as tpt
from lumo_tpu_torch.parallel import mesh as tmesh

RES = 8
N_PIX = RES * RES
RTOL, ATOL_REL = 1e-4, 1e-5
ENTRY_CHECK_RAYS = 4096


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small wavefronts: intra-op threads gain nothing, and under parallel
    test workers every process's threads contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, what):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL_REL * max(scale, 1e-30),
                               err_msg=what)


def _lam(rng, n):
    return np.asarray(jwl.sample(jnp.asarray(
        rng.uniform(0, 1, n).astype(np.float32))))


def test_entry_matches_jax():
    fn, args = ge.entry(device="cpu")
    o0, d0, lam0 = args
    assert o0.shape == d0.shape == (ge.ENTRY_RAYS, 3)
    assert lam0.shape == (ge.ENTRY_RAYS, 4)
    out = fn(*args)
    assert out.shape == (ge.ENTRY_RAYS, 4) and torch.isfinite(out).all()

    # fn takes any number of rays: 4,096, each flip a lane in 400 at
    # depth 4 (one a bounce in about 600)
    js, jc = jge._tiny_scene_camera(RES)
    rng = np.random.default_rng(11)
    raster = rng.uniform(0, RES, (ENTRY_CHECK_RAYS, 2)).astype(np.float32)
    o, d = (np.asarray(x) for x in jc.generate_ray(
        jnp.asarray(raster), jnp.full((ENTRY_CHECK_RAYS, 2), 0.5)))
    lam = _lam(rng, ENTRY_CHECK_RAYS)
    key = rng.integers(0, 1 << 32, ENTRY_CHECK_RAYS, dtype=np.uint32)
    r_j, _, _, prims_j = jpt.integrate(
        js, jnp.asarray(o), jnp.asarray(d), jnp.asarray(lam),
        ray_key=jnp.asarray(key), fixed_depth=ge.ENTRY_DEPTH,
        trace_prims=True)
    r_t = fn(t(o), t(d), t(lam), ray_key=t(key)).numpy()
    ts, _ = ge.tiny_scene_camera(RES, "cpu")
    prims_t = tpt.integrate(ts, t(o), t(d), t(lam), ray_key=t(key),
                            fixed_depth=ge.ENTRY_DEPTH, trace_prims=True)[3]
    prims_t, prims_j = prims_t.numpy(), np.asarray(prims_j)
    same = (prims_t == prims_j).all(axis=0)
    assert (~same).sum() <= ENTRY_CHECK_RAYS // 100, f"{(~same).sum()} flips"
    # each flip begins where one package meets the light and the other the
    # ceiling around it, in the light's plane
    y = np.asarray(js.tri_a)[:, 1]
    plane = np.flatnonzero(
        (np.asarray(js.tri_b)[:, 1] == y) & (np.asarray(js.tri_c)[:, 1] == y)
        & (y == y[np.asarray(js.light_prim)[0]]))
    first = (prims_t != prims_j).argmax(axis=0)
    lanes = np.flatnonzero(~same)
    assert np.isin(prims_t[first[lanes], lanes], plane).all()
    assert np.isin(prims_j[first[lanes], lanes], plane).all()
    np.testing.assert_allclose(r_t[same], np.asarray(r_j)[same], rtol=1e-4,
                               atol=1e-6)
    assert r_t.sum() > 0


def _jax_loss_fn(js, jc):
    """The JAX dryrun's loss (``__graft_entry__.py:117-134``) with the
    wavelengths and ray keys as arguments."""
    w, h = jc.resolution
    wbm = jnp.asarray(jfilm.wb_matrix(*ge.WB), jnp.float32)
    filt = jfilm.PixelFilter.square()

    def loss_fn(mat_float, ray_ids, lam, ray_key):
        materials = {k: mat_float.get(k, v) for k, v in js.materials.items()}
        scene = dataclasses.replace(js, materials=materials)
        pix = ray_ids % (w * h)
        raster = jnp.stack([(pix % w).astype(jnp.float32) + 0.5,
                            (pix // w).astype(jnp.float32) + 0.5], -1)
        o, d = jc.generate_ray(raster, jnp.full(raster.shape, 0.5))
        radiance, lam_out, _ = jpt.integrate(
            scene, o, d, lam, ray_key=ray_key, fixed_depth=ge.LOSS_DEPTH)
        rgb = jfilm.spectral_to_rgb(radiance, lam_out, wbm)
        film = jfilm.add_samples(jfilm.new_film((w, h)), filt, raster, rgb,
                                 (w, h))
        return jnp.sum(film[0] ** 2) / (w * h)

    return loss_fn


@pytest.fixture(scope="module")
def rich():
    """(JAX scene, JAX camera, port scene, port camera)."""
    js, jc = jge._rich_scene_camera(RES)
    ts = port_scene_from_jax(js)
    assert ts.bvh is not None and ts.n_tris == js.n_tris > 1000
    return js, jc, ts, build_camera(resolution=(RES, RES), device="cpu")


def test_loss_and_grads_match_jax(rich):
    js, jc, ts, tc = rich
    lam = _lam(np.random.default_rng(3), N_PIX)
    ids = np.arange(N_PIX, dtype=np.int32)
    mats_j = {k: v for k, v in js.materials.items()
              if jnp.issubdtype(v.dtype, jnp.floating)}
    loss_j, g_j = jax.jit(jax.value_and_grad(_jax_loss_fn(js, jc)))(
        mats_j, jnp.asarray(ids), jnp.asarray(lam),
        jnp.asarray(ids.astype(np.uint32)))
    mats_t = ge.float_tables(ts)
    assert set(mats_t) == set(mats_j)
    launches = {}
    ray_ids = torch.arange(N_PIX)
    loss_t, g_t = ge.loss_and_grads(ts, tc, mats_t, ray_ids, t(lam), ray_ids,
                                    launches=launches)
    assert launches == {"fwd": {"closest": 0, "any": 0},
                        "bwd": {"closest": 0, "any": 0}}   # plain on the CPU
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    assert float(loss_t) > 0
    for k in mats_j:
        assert g_t[k].shape == mats_t[k].shape
        _close(g_t[k].numpy(), np.asarray(g_j[k]), k)
    assert sum(float(g.abs().sum()) for g in g_t.values()) > 0


def test_train_step_sgd_update(rich):
    """One rank alone: the loss and gradients of ``loss_and_grads`` on the
    rank's wavelengths, and the update ``v - 1e-3 g``."""
    _, _, ts, tc = rich
    mesh = tmesh.make_mesh(1, "cpu")
    mats = ge.float_tables(ts)
    loss, new, grads = ge.train_step(mesh, ts, tc, mats)
    ids = torch.arange(N_PIX)
    lam = ge.train_wavelengths(0, N_PIX, "cpu")
    loss1, g1 = ge.loss_and_grads(ts, tc, mats, ids, lam, ids)
    assert float(loss) == float(loss1)
    for k, v in mats.items():
        assert torch.equal(grads[k], g1[k])
        assert torch.equal(new[k], v - 1e-3 * g1[k])
    assert any(not torch.equal(new[k], v) for k, v in mats.items())


def _against_one_device(out, ts, tc):
    """A dryrun's ranks agree bit for bit; rank 0's ``pmean``'d loss,
    gradients and update equal the mean of the ranks' blocks taken on one
    device, and its ``psum``'d BDPT film one device's film."""
    ranks = out["ranks"]
    n = len(ranks)
    r0 = ranks[0]
    assert r0["n_tris"] == ts.n_tris
    for r in ranks[1:]:
        assert r0["loss"] == r["loss"] and r0["params_l1"] == r["params_l1"]
        for k in r0["grads"]:
            assert torch.equal(r0["grads"][k], r["grads"][k])
            assert torch.equal(r0["new_mats"][k], r["new_mats"][k])
        for a, b in zip(r0["film"], r["film"]):
            assert torch.equal(a, b)

    mats = ge.float_tables(ts)
    blocks = []
    for rank in range(n):
        ids = torch.arange(rank * N_PIX // n, (rank + 1) * N_PIX // n)
        lam = ge.train_wavelengths(rank, ids.shape[0], "cpu")
        blocks.append(ge.loss_and_grads(ts, tc, mats, ids, lam, ids))
    np.testing.assert_allclose(
        r0["loss"], float(sum(b[0] for b in blocks)) / n, rtol=2e-4)
    for k in mats:
        want = sum(b[1][k] for b in blocks) / n
        np.testing.assert_allclose(r0["grads"][k].numpy(), want.numpy(),
                                   rtol=2e-4, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(r0["new_mats"][k].numpy(),
                                   (mats[k] - 1e-3 * want).numpy(),
                                   rtol=2e-4, atol=1e-6, err_msg=k)
    one = ge.bdpt_film(tmesh.make_mesh(1, "cpu"), ts, tc)
    for got, want in zip(r0["film"], one):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                                   atol=1e-5)
    assert float(one[2].abs().sum()) > 0             # splats landed
    assert np.isfinite(out["bdpt_film_l1"]) and out["bdpt_film_l1"] > 0


def test_dryrun_two_gloo_ranks(rich, capsys):
    _, _, ts, tc = rich
    out = ge.dryrun_multichip(2, device="cpu")
    printed = capsys.readouterr().out
    assert "dryrun_multichip(2): loss=" in printed and " OK" in printed
    assert "scaling_rays_per_s_per_device:" in printed
    assert out["backend"] == "gloo" and out["devices"] == ["cpu", "cpu"]
    assert set(out["scaling"]) == {"1", "2"}
    assert all(v > 0 for v in out["scaling"].values())
    _against_one_device(out, ts, tc)


def test_dryrun_four_ranks_sub_meshes(rich, capsys):
    """Four gloo ranks: the scaling protocol's two-rank count runs on the
    sub-mesh of ranks 0 and 1 (``mesh.sub_mesh``, a new group every rank
    creates), and the step and film still equal one device's."""
    _, _, ts, tc = rich
    out = ge.dryrun_multichip(4, device="cpu")
    assert "dryrun_multichip(4): loss=" in capsys.readouterr().out
    assert set(out["scaling"]) == {"1", "2", "4"}
    assert all(v > 0 for v in out["scaling"].values())
    # rank 1 took part in the counts over 2 and 4 ranks, ranks 2 and 3
    # only in the one over all four
    assert [set(r["scaling"]) for r in out["ranks"]] == [
        {"1", "2", "4"}, {"2", "4"}, {"4"}, {"4"}]
    _against_one_device(out, ts, tc)


@pytest.mark.parametrize("call", ["entry", "dryrun", "fit_table"])
def test_entry_points_need_the_card(call):
    """Without ``device="cpu"`` each raises where no card is visible (and
    names the card where one is): none falls back to the CPU."""
    if torch.cuda.is_available():
        assert ge.rank_layout(1)[0][0].startswith("cuda")
        return
    calls = {"entry": ge.entry, "dryrun": lambda: ge.dryrun_multichip(2),
             "fit_table": lambda: uplift.fit_table(4)}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[call]()


def test_dryrun_rank_failure_raises():
    """A rank that raises makes the call raise with its error: 3x3 pixels
    do not split over two ranks."""
    with pytest.raises(torch.multiprocessing.ProcessRaisedException,
                       match="9 rays do not divide over 2"):
        ge.dryrun_multichip(2, device="cpu", res=3)


def test_rank_layout(tmp_path):
    """On the CPU the ranks are gloo ranks; NCCL is refused where a
    caller asks for it on a rank without a card."""
    from lumo_tpu_torch.parallel import distributed
    assert ge.rank_layout(2, "cpu") == (["cpu", "cpu"], "gloo")
    with pytest.raises(ValueError, match="NCCL needs a card"):
        distributed.initialize(coordinator=f"file://{tmp_path}/rendezvous",
                               num_processes=1, process_id=0,
                               backend="nccl", device="cpu")
    assert not torch.distributed.is_initialized()
