"""The port's host I/O against the JAX package's and against PIL.

Mirrors the 8 tests of ``tests/test_io.py`` (the .obj/.mtl parser, the
builder of an .obj scene, the fluent bake, sphere instances, the ORM
branch, the ``file://`` texture entry point and the committed real asset
``scenes/demo.zip``), and holds the port's own PNG and JPEG decoders
(``lumo_tpu_torch/io/image.py``, ``native/jpeg_decoder.cpp``) bit for
bit against PIL, which the JAX package decodes with: the images of
``scenes/demo.zip``, the 4x4 grey image ``tests/test_io.py`` writes as
``scenes/tex.png``, synthetic PNGs of every colour type, bit depth and
scanline filter, plain and interlaced (Adam7), and JPEGs written by PIL
(4:4:4, 4:2:2, 4:2:0 and 4:4:0, baseline and progressive, standard and
optimised tables, grey, RGB, restart intervals).  The tolerance is
bit-equality throughout.
"""
import io
import os
import struct
import time
import zipfile
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from _torch_port import SCENE_FIELDS, port_scene_from_jax
from lumo_tpu.io import image as jimage
from lumo_tpu.io import obj as jobj
from lumo_tpu_torch import native
from lumo_tpu_torch.io import image as timage
from lumo_tpu_torch.io import obj as tobj
from lumo_tpu_torch.scene.instance import Mesh, sphere_instance, translation
from lumo_tpu_torch.scene.materials import (LIGHT, MF_CONDUCTOR,
                                            MF_DIELECTRIC, Material)
from lumo_tpu_torch.scene.scene import SceneBuilder

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO = os.path.join(ROOT, "scenes", "demo.zip")

OBJ = """
# comment
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
vn 0 0 1
vt 0 0
vt 1 0
vt 1 1
vt 0 1
usemtl redmat
f 1/1/1 2/2/1 3/3/1 4/4/1
g other
usemtl lamp
f -4 -3 -2
"""

MTL = """
newmtl redmat
Kd 0.9 0.1 0.1
Ns 225
Ni 1.45
illum 7
newmtl lamp
Ke 10 10 10
newmtl metal
Ks 0.9 0.8 0.2
illum 5
Ns 900
"""


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small renders: intra-op threads only contend under -n 6."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_parse_obj_groups_and_fan():
    verts, normals, uvs, groups = tobj.parse_obj(OBJ)
    assert verts.shape == (4, 3) and normals.shape == (1, 3)
    assert uvs.shape == (4, 2) and len(groups) == 2
    name0, fv0, fn0, ft0 = groups[0]
    assert name0 == "redmat"
    assert (fv0 == [[0, 1, 2], [0, 2, 3]]).all()       # quad fan
    assert fn0 is not None and (fn0 == 0).all() and ft0 is not None
    name1, fv1, fn1, ft1 = groups[1]
    assert name1 == "lamp" and (fv1 == [[0, 1, 2]]).all()  # negative ids
    assert fn1 is None and ft1 is None
    want = jobj.parse_obj(OBJ)
    for got_a, want_a in zip((verts, normals, uvs), want[:3]):
        np.testing.assert_array_equal(got_a, want_a)
    for g, w in zip(groups, want[3]):
        assert g[0] == w[0]
        for x, y in zip(g[1:], w[1:]):
            assert (x is None) == (y is None)
            if x is not None:
                np.testing.assert_array_equal(x, y)


def test_parse_mtl_semantics():
    mtls = tobj.parse_mtl(MTL)
    red = mtls["redmat"]
    assert red.is_transparent and red.fresnel_enabled    # illum 7
    assert abs(red.eta - 1.45) < 1e-12
    assert abs(red.roughness - (1.0 - 15.0 / 30.0)) < 1e-12  # Ns=225
    assert red.build_material().kind == MF_DIELECTRIC
    assert mtls["lamp"].build_material().kind == LIGHT
    metal = mtls["metal"]
    assert metal.fresnel_enabled and not metal.is_transparent
    assert metal.build_material().kind == MF_CONDUCTOR
    assert abs(metal.roughness) < 1e-12                  # Ns=900 -> 0
    for name, cfg in jobj.parse_mtl(MTL).items():
        assert vars(mtls[name]) == vars(cfg), name


def test_scene_from_file_builds():
    sd = tobj.scene_from_file(io.StringIO(OBJ), io.StringIO(MTL)).build(
        device="cpu")
    assert sd.n_tris == 3 and sd.n_lights == 1
    js = jobj.scene_from_file(io.StringIO(OBJ), io.StringIO(MTL)).build()
    for k in SCENE_FIELDS:
        np.testing.assert_array_equal(getattr(sd, k).numpy(),
                                      np.asarray(getattr(js, k)), err_msg=k)


def test_mesh_instance_bake():
    v = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 4]], np.float64)
    f = np.array([[0, 1, 2], [0, 1, 3]])
    m = Mesh(v, f).to_unit_size().to_origin().set_y(-0.8).translate(1, 0, 0)
    b = SceneBuilder()
    m.add_to(b, Material.diffuse((0.5, 0.5, 0.5)))
    s = b.build(device="cpu")
    allv = torch.cat([s.tri_a, s.tri_b, s.tri_c]).numpy()
    ext = allv.max(0) - allv.min(0)
    assert abs(ext.max() - 1.0) < 1e-5                   # unit size
    assert abs(allv[:, 1].min() - (-0.8)) < 1e-5         # floor set_y
    assert abs((allv[:, 0].min() + allv[:, 0].max()) / 2 - 1.0) < 1e-5


def test_sphere_instance():
    t = translation(1, 2, 3) @ np.diag([2.0, 2.0, 2.0, 1.0])
    c, r = sphere_instance((1, 0, 0), 0.5, t)
    np.testing.assert_allclose(c, [3, 2, 3])
    assert abs(r - 1.0) < 1e-12
    with pytest.raises(ValueError):
        sphere_instance((0, 0, 0), 1.0, np.diag([1.0, 2.0, 1.0, 1.0]))


def _pil_png(arr) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def test_orm_map_ks_false_branch():
    """map_ks=False: map_Ks names an ORM texture whose channel means set
    roughness (G) and metalness (B), Ks white; no specular texture (the
    reference's ``mtl/task.rs:55-70``); the same material as the JAX
    package's."""
    mtl = "newmtl ormmat\nKd 0.5 0.5 0.5\nillum 5\nmap_Ks orm.png\n"
    obj = "v 0 0 0\nv 1 0 0\nv 1 1 0\nusemtl ormmat\nf 1 2 3\n"
    arr = np.zeros((4, 4, 3), np.uint8)
    arr[..., 0], arr[..., 1], arr[..., 2] = 255, 128, 64
    png = _pil_png(arr)

    def resolve(path):
        assert path == "orm.png"
        return io.BytesIO(png)

    builders = [mod.scene_from_file(io.StringIO(obj), io.StringIO(mtl),
                                    resolve=resolve, map_ks=False)
                for mod in (tobj, jobj)]
    mats = [[m for m in b._materials if m.kind == MF_CONDUCTOR]
            for b in builders]
    assert len(mats[0]) == 1
    m = mats[0][0]
    exp = timage._srgb_to_linear(arr[0, 0])
    assert abs(m.roughness - exp[1]) < 1e-5
    assert m.ks_tex == -1 and np.all(np.asarray(m.k) > 0.0)
    assert all(r.get("kind") != "image" for r in builders[0].textures.rows)
    assert m.roughness == mats[1][0].roughness
    np.testing.assert_array_equal(np.asarray(m.k), np.asarray(mats[1][0].k))


def test_texture_from_url(tmp_path):
    """The texture entry point reads a ``file://`` URI (PNG, or the image
    in a zip); any other scheme raises, since nothing is downloaded."""
    p = tmp_path / "tex.png"
    p.write_bytes(_pil_png(np.full((4, 4, 3), 128, np.uint8)))
    sb = SceneBuilder()
    tid = tobj.texture_from_url(p.as_uri(), sb)
    assert tid >= 0 and sb.textures.pack(np.float32) is not None
    z = tmp_path / "tex.zip"
    with zipfile.ZipFile(z, "w") as zf:
        zf.writestr("maps/tex.png", p.read_bytes())
    assert tobj.texture_from_url(z.as_uri(), sb) == tid + 1
    np.testing.assert_array_equal(sb.textures.images[-1],
                                  sb.textures.images[-2])
    with pytest.raises(ValueError, match="nothing is downloaded"):
        tobj.texture_from_url("https://example.com/tex.png", sb)
    with pytest.raises(ValueError, match="nothing is downloaded"):
        tobj.scene_from_url("http://example.com/scene.zip")


def _demo_arrays(pkg):
    """(builder, scene) of ``scenes/demo.zip`` through ``pkg``'s loader."""
    with open(DEMO, "rb") as f:
        data = f.read()
    if pkg == "jax":
        sb = jobj.scene_from_zip(data)
        return sb, sb.build()
    sb = tobj.scene_from_zip(data)
    return sb, sb.build(device="cpu")


def test_real_asset_zip_to_render():
    """The committed multi-material asset ``scenes/demo.zip`` (a torus,
    spheres, a ground and a glow panel; quads, usemtl groups, map_Kd,
    map_Ke, bump, illum 7, PNG textures) loads to the JAX package's
    arrays (carried through ``from_numpy``), and the 32^2 render shows the
    panel at the top and the textured ground at the bottom."""
    from lumo_tpu_torch.camera import build_camera
    from lumo_tpu_torch.renderer import Renderer
    sb_t, ts = _demo_arrays("torch")
    sb_j, js = _demo_arrays("jax")
    assert ts.n_tris > 4000 and ts.n_lights == 2
    assert len(set(ts.materials["kind"].tolist())) >= 3
    assert ts.textures is not None and ts.n_normal_maps >= 1
    carried = port_scene_from_jax(js)
    for k in SCENE_FIELDS:
        want = np.asarray(getattr(js, k))
        np.testing.assert_array_equal(getattr(ts, k).numpy(), want, err_msg=k)
        np.testing.assert_array_equal(getattr(carried, k).numpy(), want,
                                      err_msg=k)
    for k, v in js.materials.items():
        np.testing.assert_array_equal(ts.materials[k].numpy(), np.asarray(v),
                                      err_msg=k)
    for k, v in js.textures.items():
        np.testing.assert_array_equal(ts.textures[k].numpy(), np.asarray(v),
                                      err_msg=k)
    for got, want in zip(sb_t.textures.normal_images,
                         sb_j.textures.normal_images):
        np.testing.assert_array_equal(got, want)

    img = Renderer(ts, build_camera(resolution=(32, 32), device="cpu")) \
        .samples(4).seed(1).render(verbose=False)
    assert np.isfinite(img).all() and img.std() > 0.05
    top, bottom = img[:10].mean(), img[22:].mean()
    assert top > 5 * bottom, (top, bottom)
    assert bottom > 1e-4


# ---------------------------------------------------------------------------
# the PNG decoder against PIL

def _chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


# Adam7 passes: (first row, first column, row step, column step)
ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4),
         (2, 0, 4, 2), (0, 1, 2, 2), (1, 0, 2, 1))


def _filtered(samples, depth, filters):
    """The scanlines of ``samples`` (H, W, C), each row filtered by the
    next type of ``filters`` in turn, with their filter bytes."""
    h, w, _ = samples.shape
    if depth < 8:
        per = 8 // depth
        rows = []
        for y in range(h):
            v = np.concatenate([samples[y, :, 0], np.zeros(-w % per, int)])
            v = v.reshape(-1, per) << (8 - depth * (1 + np.arange(per)))
            rows.append(v.sum(axis=1).astype(np.uint8).tobytes())
        bpp = 1
    else:
        dt = np.uint8 if depth == 8 else np.dtype(">u2")
        rows = [samples[y].astype(dt).tobytes() for y in range(h)]
        bpp = samples.shape[2] * depth // 8
    out, prior = b"", bytes(len(rows[0]))
    for y, row in enumerate(rows):
        kind = filters[y % len(filters)]
        enc = bytearray(len(row))
        for i in range(len(row)):
            a = row[i - bpp] if i >= bpp else 0
            c = prior[i - bpp] if i >= bpp else 0
            pred = (0, a, prior[i], (a + prior[i]) >> 1,
                    _paeth(a, prior[i], c))[kind]
            enc[i] = (row[i] - pred) & 0xFF
        out += bytes([kind]) + bytes(enc)
        prior = row
    return out


def encode_png(samples, ctype, depth, filters=(0, 1, 2, 3, 4), palette=None,
               interlace=0):
    """A PNG of integer ``samples`` (H, W, C), each row filtered by the
    next type of ``filters`` in turn, the data split over two IDATs; with
    ``interlace`` the seven Adam7 passes, each filtered as an image of its
    own (an empty pass has no scanlines)."""
    h, w, _ = samples.shape
    if interlace:
        out = b"".join(_filtered(samples[y0::dy, x0::dx], depth, filters)
                       for y0, x0, dy, dx in ADAM7
                       if y0 < h and x0 < w)
    else:
        out = _filtered(samples, depth, filters)
    png = timage.PNG_SIGNATURE + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
    if palette is not None:
        png += _chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    z = zlib.compress(out)
    return (png + _chunk(b"IDAT", z[:len(z) // 2])
            + _chunk(b"IDAT", z[len(z) // 2:]) + _chunk(b"IEND", b""))


def _assert_like_pil(data):
    pil = Image.open(io.BytesIO(data))
    np.testing.assert_array_equal(timage.decode_png(data),
                                  np.asarray(pil.convert("RGB")))
    np.testing.assert_array_equal(timage.decode_png(data, grey=True),
                                  np.asarray(pil.convert("L")))


CASES = [(ctype, depth) for ctype, depths in
         ((0, (1, 2, 4, 8, 16)), (2, (8, 16)), (3, (1, 2, 4, 8)),
          (4, (8, 16)), (6, (8, 16))) for depth in depths]


@pytest.mark.parametrize("ctype,depth", CASES)
def test_decoder_equals_pil_on_every_format(ctype, depth):
    """Every colour type and bit depth, rows through all five filters, at
    widths that leave sub-byte rows partly filled; RGB and grey."""
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    rng = np.random.default_rng(17 * ctype + depth)
    for h, w in ((5, 7), (10, 13), (1, 1)):
        s = rng.integers(0, 1 << depth, (h, w, channels))
        pal = rng.integers(0, 256, (1 << depth, 3)) if ctype == 3 else None
        _assert_like_pil(encode_png(s, ctype, depth, palette=pal))


@pytest.mark.parametrize("name", ["checker.png", "bumpy.png", "glow.png",
                                  "tex.png"])
def test_decoder_equals_pil_on_repo_images(name):
    """The images of ``scenes/demo.zip`` and the 4x4 grey-128 image that
    ``tests/test_io.py`` writes with PIL as ``scenes/tex.png``; and the
    loaders equal the JAX package's (PIL-backed) ones."""
    if name == "tex.png":
        data = _pil_png(np.full((4, 4, 3), 128, np.uint8))
    else:
        with zipfile.ZipFile(DEMO) as zf:
            data = zf.read(name)
    _assert_like_pil(data)
    for fn in ("load_png", "load_normal_map", "bump_to_normal_map"):
        np.testing.assert_array_equal(
            getattr(timage, fn)(io.BytesIO(data)),
            getattr(jimage, fn)(io.BytesIO(data)), err_msg=fn)


def test_encoder_round_trip_and_film_save(tmp_path):
    """``encode_png`` writes what PIL and the decoder read back, and the
    film's ``save_png`` (which used PIL) writes it through the colour
    space's transfer curve."""
    from lumo_tpu_torch import film
    from lumo_tpu_torch.color import space
    rgb8 = np.random.default_rng(2).integers(0, 256, (7, 5, 3)).astype(
        np.uint8)
    data = timage.encode_png(rgb8)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))),
                                  rgb8)
    np.testing.assert_array_equal(timage.decode_png(data), rgb8)
    lin = np.random.default_rng(3).uniform(0.0, 1.2, (6, 4, 3))
    path = tmp_path / "film.png"
    film.save_png(lin, str(path))
    np.testing.assert_array_equal(np.asarray(Image.open(path)),
                                  space.get("sRGB").encode(lin))
    with pytest.raises(ValueError, match="uint8"):
        timage.encode_png(lin)


@pytest.mark.parametrize("ctype,depth", CASES)
def test_adam7_equals_pil(ctype, depth):
    """Interlaced (Adam7) PNGs of every colour type and bit depth, at sizes
    where some passes are empty (1x1, 3x2) and where every pass is partly
    filled; RGB and grey."""
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    rng = np.random.default_rng(31 * ctype + depth)
    for h, w in ((1, 1), (3, 2), (9, 13), (16, 16)):
        s = rng.integers(0, 1 << depth, (h, w, channels))
        pal = rng.integers(0, 256, (1 << depth, 3)) if ctype == 3 else None
        _assert_like_pil(encode_png(s, ctype, depth, palette=pal,
                                    interlace=1))


def _jpeg(arr, **kw):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", **kw)
    return buf.getvalue()


def _photo(h, w, seed):
    """A smooth colour image with noise: every band of the DCT is used."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 100 * np.sin(x / 7.0 + c) * np.cos(y / 5.0 - c)
                     for c in range(3)], -1)
    return np.clip(base + rng.normal(0, 20, (h, w, 3)), 0, 255).astype(
        np.uint8)


def _assert_jpeg_like_pil(data):
    """Bit-equal to PIL (libjpeg-turbo at its defaults), RGB and grey."""
    pil = Image.open(io.BytesIO(data))
    np.testing.assert_array_equal(timage.decode_jpeg(data),
                                  np.asarray(pil.convert("RGB")))
    np.testing.assert_array_equal(timage.decode_jpeg(data, grey=True),
                                  np.asarray(pil.convert("L")))


@pytest.mark.parametrize("subsampling", [0, 1, 2])
@pytest.mark.parametrize("progressive", [False, True])
def test_jpeg_equals_pil(subsampling, progressive):
    """4:4:4, 4:2:2 and 4:2:0, baseline and progressive, standard and
    optimised Huffman tables, qualities 50 and 95, sizes that are and are
    not multiples of the MCU, smooth and noise images: bit-equal."""
    rng = np.random.default_rng(3 * subsampling + progressive)
    for h, w in ((23, 37), (64, 64), (1, 1), (17, 5)):
        for optimize, quality in ((False, 50), (True, 95), (False, 95)):
            for arr in (_photo(h, w, h * w),
                        rng.integers(0, 256, (h, w, 3)).astype(np.uint8)):
                _assert_jpeg_like_pil(_jpeg(
                    arr, subsampling=subsampling, progressive=progressive,
                    optimize=optimize, quality=quality))


@pytest.mark.parametrize("kind", ["grey", "restart-blocks", "restart-rows",
                                  "rgb", "440", "loaders"])
def test_jpeg_variants_equal_pil(kind, tmp_path):
    """Grey JPEG; restart intervals (RSTn markers) in baseline and
    progressive scans; an RGB JPEG (Adobe transform 0, no colour
    transform); 4:4:0 (luma sampled 1x2: a square 4:2:2 JPEG with its
    luma factors swapped, which keeps the scan's block count); and the
    loaders on a JPEG file against the JAX package's: bit-equal."""
    arr = _photo(40, 53, 7)
    if kind == "grey":
        for prog in (False, True):
            _assert_jpeg_like_pil(_jpeg(arr[..., 1], progressive=prog))
            _assert_jpeg_like_pil(_jpeg(arr[:23, :37, 0], progressive=prog,
                                        optimize=True))
    elif kind.startswith("restart"):
        kw = ({"restart_marker_blocks": 3} if kind == "restart-blocks"
              else {"restart_marker_rows": 1})
        for prog in (False, True):
            data = _jpeg(arr, subsampling=2, progressive=prog, **kw)
            assert b"\xff\xd0" in data and b"\xff\xdd" in data
            _assert_jpeg_like_pil(data)
    elif kind == "rgb":
        data = _jpeg(arr, keep_rgb=True, subsampling=0)
        assert b"Adobe" in data
        _assert_jpeg_like_pil(data)
    elif kind == "440":
        for n in (37, 64):
            for prog in (False, True):
                data = bytearray(_jpeg(_photo(n, n, n), subsampling=1,
                                       progressive=prog))
                sof = data.index(b"\xff\xc2" if prog else b"\xff\xc0")
                assert data[sof + 11] == 0x21       # luma 2x1
                data[sof + 11] = 0x12
                _assert_jpeg_like_pil(bytes(data))
    else:
        path = tmp_path / "tex.jpg"
        Image.fromarray(arr).save(path, format="JPEG", quality=85)
        for fn in ("load_png", "load_normal_map", "bump_to_normal_map"):
            np.testing.assert_array_equal(getattr(timage, fn)(str(path)),
                                          getattr(jimage, fn)(str(path)),
                                          err_msg=fn)


def test_jpeg_corrupt_data():
    """Truncated and garbled JPEGs decode or raise a ValueError, never
    read or write outside their buffers (an over-subscribed Huffman table
    once indexed past the decoder's lookahead table)."""
    rng = np.random.default_rng(5)
    base = [_jpeg(_photo(33, 47, 2), subsampling=2, progressive=prog,
                  restart_marker_blocks=2) for prog in (False, True)]
    for i in range(600):
        data = bytearray(base[i % 2])
        if i % 3 == 0:
            data = data[:rng.integers(2, len(data))]
        else:
            for _ in range(rng.integers(1, 8)):
                data[rng.integers(2, len(data))] = rng.integers(0, 256)
        try:
            img = timage.decode_jpeg(bytes(data))
        except ValueError:
            continue
        assert img.dtype == np.uint8 and img.shape[-1] == 3
    dht = base[0].index(b"\xff\xc4")
    bad = bytearray(base[0])
    bad[dht + 5:dht + 21] = bytes([3] + [0] * 15)  # 3 codes of length 1
    with pytest.raises(ValueError, match="Huffman"):
        timage.decode_jpeg(bytes(bad))


def test_jpeg_speed():
    """A 2048^2 4:2:0 baseline JPEG decodes in under 2 s (the decoder
    built), as a 2K texture of a loaded asset needs."""
    data = _jpeg(_photo(2048, 2048, 1), subsampling=2, quality=90)
    native.load("jpeg")                  # built, if it was not yet
    t0 = time.perf_counter()
    img = timage.decode_jpeg(data)
    assert time.perf_counter() - t0 < 2.0
    assert img.shape == (2048, 2048, 3)


def test_unsupported_images_raise(tmp_path):
    """Formats the port does not decode raise a ValueError naming them:
    arithmetic-coded and 12-bit JPEG (frame headers), a CMYK JPEG written
    by PIL, and a GIF."""
    def frame(sof, precision):
        body = bytes([precision, 0, 4, 0, 4, 1, 1, 0x11, 0])
        return (b"\xff\xd8" + sof + struct.pack(">H", len(body) + 2) + body
                + b"\xff\xd9")
    with pytest.raises(ValueError, match="arithmetic"):
        timage.decode_jpeg(frame(b"\xff\xc9", 8))
    with pytest.raises(ValueError, match="12-bit"):
        timage.decode_jpeg(frame(b"\xff\xc1", 12))
    jpg = tmp_path / "cmyk.jpg"
    Image.new("CMYK", (4, 4), (10, 20, 30, 40)).save(jpg, format="JPEG")
    with pytest.raises(ValueError, match="CMYK"):
        timage.load_png(str(jpg))
    with pytest.raises(ValueError, match="not a PNG"):
        timage.decode_png(b"GIF89a")
    with pytest.raises(ValueError, match="not a PNG"):
        timage.load_png(io.BytesIO(b"GIF89a"))


def _rgbe(rgb):
    """Float RGB (H, W, 3) -> RGBE bytes (H, W, 4)."""
    m = rgb.max(axis=-1)
    e = np.where(m > 1e-32, np.floor(np.log2(np.maximum(m, 1e-32))) + 1, 0)
    scale = np.where(m > 1e-32, 256.0 / np.exp2(e), 0.0)
    out = np.zeros(rgb.shape[:2] + (4,), np.uint8)
    out[..., :3] = np.clip(rgb * scale[..., None], 0, 255).astype(np.uint8)
    out[..., 3] = np.where(m > 1e-32, e + 128, 0).astype(np.uint8)
    return out


def _rle_row(row):
    """One new-style run-length scanline of RGBE pixels (W, 4)."""
    w = row.shape[0]
    out = bytearray([2, 2, w >> 8, w & 0xFF])
    for c in range(4):
        x = 0
        while x < w:
            run = 1
            while x + run < w and run < 127 and row[x + run, c] == row[x, c]:
                run += 1
            if run >= 3:
                out += bytes([128 + run, row[x, c]])
                x += run
            else:
                n = min(128, w - x)
                out += bytes([n]) + row[x:x + n, c].tobytes()
                x += n
    return bytes(out)


@pytest.mark.parametrize("rle", [False, True])
def test_load_hdr_flat_and_rle(rle):
    """Radiance files with flat and run-length scanlines decode to the
    JAX package's values and to the RGBE values written."""
    rng = np.random.default_rng(3)
    rgb = rng.uniform(0.0, 40.0, (6, 9, 3))
    rgb[2, 3:8] = 5.0                       # a run
    rgb[4, 0] = 0.0                         # exponent 0
    px = _rgbe(rgb)
    body = b"".join(_rle_row(r) if rle else r.tobytes() for r in px)
    data = (b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y 6 +X 9\n" + body)
    got = timage.load_hdr(io.BytesIO(data))
    np.testing.assert_array_equal(got, jimage.load_hdr(io.BytesIO(data)))
    want = px[..., :3] * np.ldexp(1.0, px[..., 3].astype(int) - 136)[..., None]
    want[px[..., 3] == 0] = 0.0
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, rgb, rtol=2e-2, atol=0.4)
    with pytest.raises(ValueError, match="not a Radiance"):
        timage.load_hdr(io.BytesIO(b"P6\n"))
