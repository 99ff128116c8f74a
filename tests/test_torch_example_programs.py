"""The user programs: the port's ``lumo_tpu_torch.examples`` against the
JAX package's ``examples/*.py``, on the CPU.

Each JAX program runs as a user runs it (``runpy``, ``--cpu --res 8``),
its ``Renderer`` replaced by a recorder that renders zeros and writes
nothing (``tests/_torch_port.py::run_jax_program``); the port's program
builds its Renderer with ``make`` on the same arguments.  The scene's
arrays (the triangle, shape and light tables, the packed BVH, the
material, texture and medium tables) are equal, integers exactly and
floats within 1e-6 relative; so are the camera and the configuration
(samples at the program's default, integrator, BDPT depth, tone map,
pixel filter, illuminant, output name).  The conference and bistro
programs also take their file branch, from a small ``scenes/*.obj`` and
``.mtl`` written here whose diffuse map is a JPEG written by PIL (and,
for bistro, a Radiance ``.hdr``).  The programs pass no texture
resolver, so neither package decodes the map there; the same files
loaded with ``resolve`` give equal texture tables through PIL and
through the port's JPEG decoder.

Each port program's ``main`` renders 8x8 at 1 spp and writes a PNG that
the port's decoder reads back; without ``--cpu`` and without a card it
raises."""
import os
from unittest import mock

import numpy as np
import pytest
import torch
from PIL import Image

from _torch_port import (EXAMPLES, SCENE_FIELDS, SHAPE_FIELDS, BVH_KEYS,
                         port_program, run_jax_program)
from lumo_tpu_torch.accel import bvh_kernel
from lumo_tpu_torch.io import image as timage

ARGV = ["--cpu", "--res", "8"]
CAMERA_FIELDS = ("r2c", "c2r", "c2w_rot", "c2w_t", "lens_radius",
                 "focal_length", "image_plane_area")
SCENE_INTS = ("n_tris", "n_bvh_tris", "n_spheres", "n_analytic",
              "n_ana_lights", "n_lights", "n_shadow_rays", "n_normal_maps")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _in_tmp(tmp_path, monkeypatch):
    """The programs read ``./scenes`` and write their PNG to the working
    directory: run them in an empty one."""
    monkeypatch.chdir(tmp_path)


def _same(got, want, what):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if np.issubdtype(want.dtype, np.floating):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0.0,
                                   err_msg=what)
    else:
        np.testing.assert_array_equal(got, want.astype(got.dtype),
                                      err_msg=what)


def _same_table(got, want, what):
    assert (got is None) == (want is None), what
    if want is not None:
        assert set(got) == set(want), what
        for k, v in want.items():
            _same(got[k], v, f"{what}.{k}")


def assert_same_program(rec, r):
    """The JAX program's recorded Renderer ``rec`` and the port's ``r``
    hold the same scene, camera and configuration."""
    js, ts = rec.scene, r.scene
    for k in SCENE_INTS:
        assert getattr(ts, k) == getattr(js, k), k
    for k in SCENE_FIELDS + SHAPE_FIELDS:
        _same(getattr(ts, k), getattr(js, k), k)
    _same_table(ts.materials, js.materials, "materials")
    _same_table(ts.textures, js.textures, "textures")
    _same_table(ts.medium, js.medium, "medium")
    assert ts.inst == () and js.inst == ()
    assert (ts.bvh is None) == (js.bvh is None)
    if js.bvh is not None:
        _same(ts.bvh["nodes"], bvh_kernel.pack_nodes(
            {k: np.asarray(js.bvh[k]) for k in BVH_KEYS}), "bvh")
    for k in CAMERA_FIELDS:
        _same(getattr(r.camera, k), getattr(rec.camera, k), k)
    assert (r.camera.kind, r.camera.resolution) == (rec.camera.kind,
                                                    rec.camera.resolution)
    for k in ("_samples", "_integrator", "_bdpt_depth", "_tone_map",
              "_tone_arg", "_illuminant", "_colorspace", "_seed", "_delta",
              "_stream"):
        assert getattr(r, k) == getattr(rec, k), k
    f_t, f_j = r._filter, rec._filter
    assert (f_t.kind, f_t.r_disc) == (f_j.kind, f_j.r_disc)
    np.testing.assert_allclose([f_t.radius, f_t.sigma],
                               [float(f_j.radius), float(f_j.sigma)],
                               rtol=1e-6)
    assert r.scene.device.type == "cpu" and r.camera.c2w_t.device.type == "cpu"


def _module(name):
    import importlib
    return importlib.import_module(f"lumo_tpu_torch.examples.{name}")


@pytest.mark.parametrize("name", EXAMPLES)
def test_program_matches_jax(name):
    _, rec = run_jax_program(name, ARGV)
    r = port_program(name, ARGV)
    assert_same_program(rec, r)
    assert rec.saved == _module(name).OUT
    assert r._samples == _module(name).SPP


OBJ = """v -30 0 -30
v 30 0 -30
v 30 0 30
v -30 0 30
v -2 0 -2
v 2 0 -2
v 2 4 -2
v -2 4 -2
vt 0 0
vt 1 0
vt 1 1
vt 0 1
vn 0 1 0
usemtl ground
f 1/1/1 2/2/1 3/3/1 4/4/1
usemtl wall
f 5/1 6/2 7/3 8/4
"""

MTL = """newmtl ground
Kd 0.5 0.5 0.5
map_Kd ground.jpg
newmtl wall
Kd 0.8 0.3 0.2
Ns 100
"""


def _write_assets(stem, mtl_name, hdr):
    """``scenes/<stem>.obj``, ``scenes/<mtl_name>`` naming a 4:2:0 JPEG
    written by PIL as its diffuse map, and with ``hdr`` a small Radiance
    file as bistro's environment."""
    os.makedirs("scenes")
    with open(f"scenes/{stem}.obj", "w") as f:
        f.write(OBJ)
    with open(f"scenes/{mtl_name}", "w") as f:
        f.write(MTL)
    rng = np.random.default_rng(9)
    Image.fromarray(rng.integers(0, 256, (19, 27, 3)).astype(np.uint8)).save(
        "scenes/ground.jpg", format="JPEG", quality=90, subsampling=2)
    if hdr:
        rgb = rng.uniform(0.0, 4000.0, (6, 10, 3))
        exp = np.ceil(np.log2(np.maximum(rgb.max(-1), 1e-32))).astype(int)
        mant = np.clip(rgb / np.ldexp(1.0, exp)[..., None] * 256.0, 0, 255)
        rgbe = np.concatenate([mant.astype(np.uint8),
                               (exp + 128).astype(np.uint8)[..., None]], -1)
        with open("scenes/cobblestone_street_night_4k.hdr", "wb") as f:
            f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y 6 +X 10\n"
                    + rgbe.tobytes())


@pytest.mark.parametrize("name,stem,mtl", [
    ("conference", "conference", "conference.mtl"),
    ("bistro", "exterior", "exterior-night.mtl")])
def test_file_branch_matches_jax(name, stem, mtl):
    _write_assets(stem, mtl, hdr=name == "bistro")
    _, rec = run_jax_program(name, ARGV)
    r = port_program(name, ARGV)
    assert_same_program(rec, r)
    assert r.scene.n_tris == 4
    if name == "bistro":      # the .hdr is the environment's texture
        assert r.scene.textures is not None
    # the JPEG map, decoded where a resolver is given: PIL and the port
    from lumo_tpu.io import obj as jobj
    from lumo_tpu_torch.io import obj as tobj
    sb_j = jobj.scene_from_file(f"scenes/{stem}.obj", f"scenes/{mtl}",
                                resolve=lambda p: open(f"scenes/{p}", "rb"))
    sb_t = tobj.scene_from_file(f"scenes/{stem}.obj", f"scenes/{mtl}",
                                resolve=lambda p: open(f"scenes/{p}", "rb"))
    tex_j = sb_j.build().textures
    tex_t = sb_t.build(device="cpu").textures
    assert tex_j is not None
    _same_table(tex_t, tex_j, "textures")


@pytest.mark.parametrize("name", EXAMPLES)
def test_main_writes_png(name, tmp_path):
    out = str(tmp_path / f"{name}-out.png")
    assert _module(name).main(["--cpu", "--res", "8", "--spp", "1",
                               "--out", out]) == out
    with open(out, "rb") as f:
        img = timage.decode_png(f.read())
    assert img.shape == (8, 8, 3)


@pytest.mark.parametrize("name", EXAMPLES)
def test_main_without_card_raises(name):
    with mock.patch.object(torch.cuda, "is_available", return_value=False), \
            pytest.raises(RuntimeError, match="no CUDA device"):
        _module(name).main(["--res", "8", "--spp", "1"])
