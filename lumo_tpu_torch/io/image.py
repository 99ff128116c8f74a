"""Image decoding on the host: PNG, JPEG, Radiance .hdr (RGBE), normal
and bump maps.

Counterpart of ``lumo_tpu/io/image.py`` (reference ``src/image.rs``: PNG
decode with palette, grey and alpha ``image.rs:19-79``, the sRGB transfer
``rgb.rs:57-76``, RGBE ``rgb.rs:79-93``, ``image.rs:205-253``, normal and
bump maps ``image.rs:133-172``).  The JAX package decodes with PIL; the
port has its own PNG decoder on ``zlib`` and numpy, which gives the
pixels of PIL's ``Image.open(...).convert("RGB")`` and ``.convert("L")``:

- PNG of colour type 0 (grey, 1 to 16 bits), 2 (RGB), 3
  (palette, 1 to 8 bits), 4 (grey and alpha) and 6 (RGBA), 8 or 16 bits
  where the type allows, with the five scanline filters;
- 16-bit samples keep their high byte, except 16-bit grey, which PIL
  opens as integers (mode "I;16") and clips to 255 on conversion;
- sub-byte grey scales to 0..255 (1 bit: x255, 2: x85, 4: x17); alpha
  and ``tRNS`` are dropped;
- grey from RGB is PIL's integer luma, (19595 R + 38470 G + 7471 B +
  0x8000) >> 16;
- interlaced (Adam7) PNG: each of the seven passes is unfiltered as an
  image of its own and scattered into the image.

JPEG (``decode_jpeg``) decodes in C++ (``native/jpeg_decoder.cpp``,
built with g++ at first use) to the pixels of PIL, which decodes with
libjpeg-turbo at its defaults: the islow integer IDCT, fancy upsampling
and the fixed-point YCbCr tables.  It takes sequential and progressive
Huffman-coded 8-bit JPEG of one (grey) or three components (YCbCr, or
RGB under an Adobe transform 0), sampling factors 1 or 2, restart
intervals; 12-bit, arithmetic-coded, lossless, hierarchical and
CMYK/YCCK JPEG raise a ``ValueError`` naming the format.  EXIF
orientation is ignored, as ``Image.open(...).convert("RGB")`` ignores
it.  ``encode_png`` writes 8-bit RGB (the film's ``save_png``).  The
Average and Paeth filters run as a Python loop over a row's bytes: a
1024^2 RGB texture takes about a second where every row uses them.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
JPEG_SOI = b"\xff\xd8\xff"
# Adam7: (first row, first column, row step, column step) of each pass
ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4),
         (2, 0, 4, 2), (0, 1, 2, 2), (1, 0, 2, 1))
# channels and allowed bit depths of each PNG colour type
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}
LUMA = (19595, 38470, 7471)   # PIL's "L" weights, in 1/65536


def _read_bytes(source) -> bytes:
    if hasattr(source, "read"):
        data = source.read()
        return data.encode() if isinstance(data, str) else data
    with open(source, "rb") as f:
        return f.read()


def _srgb_to_linear(u8: np.ndarray) -> np.ndarray:
    u = u8.astype(np.float64) / 255.0
    return np.where(u <= 0.04045, u / 12.92, ((u + 0.055) / 1.055) ** 2.4)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def encode_png(rgb8: np.ndarray) -> bytes:
    """(H, W, 3) uint8 -> PNG bytes: colour type 2, 8 bits, unfiltered
    scanlines, one zlib stream."""
    rgb8 = np.asarray(rgb8)
    if rgb8.dtype != np.uint8 or rgb8.ndim != 3 or rgb8.shape[2] != 3:
        raise ValueError("encode_png takes an (H, W, 3) uint8 array")
    h, w, _ = rgb8.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           rgb8.reshape(h, w * 3)], axis=1)
    return (PNG_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + _chunk(b"IEND", b""))


def _chunks(data: bytes):
    """Yield (type, payload) of each chunk after the signature."""
    pos = len(PNG_SIGNATURE)
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + n]
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ValueError("truncated PNG: no IEND chunk")


def _recur_row(line, prior, bpp, paeth):
    """The Average (``paeth`` false) or Paeth filter undone on one row,
    byte by byte: each byte's predictor reads its reconstructed left
    neighbour."""
    cur = bytearray(line.tobytes())
    up = prior.tobytes()
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = up[i]
        if paeth:
            c = up[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        else:
            pred = (a + b) >> 1
        cur[i] = (cur[i] + pred) & 0xFF
    return np.frombuffer(bytes(cur), np.uint8)


def _unfilter(raw: bytes, h: int, row_bytes: int, bpp: int) -> np.ndarray:
    """The scanlines (h, row_bytes) uint8 with their filters undone."""
    if len(raw) < h * (row_bytes + 1):
        raise ValueError("truncated PNG image data")
    out = np.zeros((h, row_bytes), np.uint8)
    prior = np.zeros(row_bytes, np.uint8)
    for y in range(h):
        pos = y * (row_bytes + 1)
        kind = raw[pos]
        line = np.frombuffer(raw, np.uint8, row_bytes, pos + 1)
        if kind == 0:                                     # None
            cur = line
        elif kind == 1:                                   # Sub
            cur = line.reshape(-1, bpp).cumsum(axis=0, dtype=np.uint8)
            cur = cur.reshape(-1)
        elif kind == 2:                                   # Up
            cur = line + prior
        elif kind in (3, 4):                              # Average, Paeth
            cur = _recur_row(line, prior, bpp, kind == 4)
        else:
            raise ValueError(f"bad PNG filter type {kind}")
        out[y] = cur
        prior = out[y]
    return out


def _samples(rows: np.ndarray, w: int, channels: int, depth: int):
    """Scanlines -> (h, w, channels) integer samples."""
    h = rows.shape[0]
    if depth == 8:
        return rows[:, :w * channels].reshape(h, w, channels)
    if depth == 16:                          # big-endian pairs
        pairs = rows[:, :2 * w * channels].reshape(h, w, channels, 2)
        return (pairs[..., 0].astype(np.uint16) << 8) | pairs[..., 1]
    # sub-byte samples (one channel), most significant bits first
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    vals = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
    return vals.reshape(h, -1)[:, :w, None]


def decode_png(data: bytes, grey: bool = False) -> np.ndarray:
    """PNG bytes -> (H, W, 3) uint8 RGB as PIL's ``convert("RGB")`` gives
    it, or with ``grey`` (H, W) uint8 as its ``convert("L")`` does."""
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError("not a PNG image")
    header, palette, idat = None, None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG without an IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if ctype not in _CHANNELS or depth not in _DEPTHS[ctype]:
        raise ValueError(f"bad PNG colour type {ctype} at bit depth {depth}")
    if interlace not in (0, 1):
        raise ValueError(f"unknown PNG interlace method {interlace}")
    channels = _CHANNELS[ctype]
    bits = channels * depth
    raw = zlib.decompress(b"".join(idat))
    # a plain image is one pass over every pixel
    s = np.zeros((h, w, channels), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for y0, x0, dy, dx in ADAM7 if interlace else ((0, 0, 1, 1),):
        ph, pw = (h - y0 + dy - 1) // dy, (w - x0 + dx - 1) // dx
        if ph <= 0 or pw <= 0:             # an empty pass has no scanlines
            continue
        row_bytes = (pw * bits + 7) // 8
        n = ph * (row_bytes + 1)
        sub = _unfilter(raw[pos:pos + n], ph, row_bytes, max(1, bits // 8))
        s[y0::dy, x0::dx] = _samples(sub, pw, channels, depth)
        pos += n
    if ctype == 3:
        if palette is None:
            raise ValueError("palette PNG without a PLTE chunk")
        index = s[..., 0].astype(np.int64)
        if index.max(initial=0) >= len(palette):
            raise ValueError("PNG palette index out of range")
        rgb = palette[index]
    elif ctype in (0, 4):
        g = s[..., 0]
        if depth == 16 and ctype == 0:
            g = np.minimum(g, 255)           # PIL's "I;16" -> "RGB" clips
        elif depth == 16:
            g = g >> 8
        elif depth < 8:
            g = g * (255 // ((1 << depth) - 1))
        g = g.astype(np.uint8)
        if grey:
            return g
        rgb = np.repeat(g[..., None], 3, axis=-1)
    else:
        rgb = s[..., :3]
        if depth == 16:
            rgb = rgb >> 8
    return _to_rgb_or_grey(rgb.astype(np.uint8), grey)


def _to_rgb_or_grey(samples: np.ndarray, grey: bool) -> np.ndarray:
    """(H, W, 1) grey or (H, W, 3) RGB uint8 -> PIL's ``convert("RGB")``,
    or with ``grey`` its ``convert("L")``."""
    if samples.shape[-1] == 1:
        g = samples[..., 0]
        return g if grey else np.repeat(g[..., None], 3, axis=-1)
    if grey:
        luma = samples.astype(np.uint32) @ np.array(LUMA, np.uint32)
        return ((luma + 0x8000) >> 16).astype(np.uint8)
    return samples


def decode_jpeg(data: bytes, grey: bool = False) -> np.ndarray:
    """JPEG bytes -> (H, W, 3) uint8 RGB as PIL's ``convert("RGB")`` gives
    it, or with ``grey`` (H, W) uint8 as its ``convert("L")`` does (the
    module docstring lists what it takes).  EXIF orientation is ignored,
    as PIL's ``Image.open(...).convert("RGB")`` ignores it."""
    from lumo_tpu_torch import native
    return _to_rgb_or_grey(native.decode_jpeg(data), grey)


def _decode(source, grey=False) -> np.ndarray:
    data = _read_bytes(source)
    if data.startswith(JPEG_SOI):
        return decode_jpeg(data, grey)
    return decode_png(data, grey)


def load_png(source) -> np.ndarray:
    """PNG or JPEG (a path or a binary file) -> linear RGB (H, W, 3)
    float64."""
    return _srgb_to_linear(_decode(source))


def load_normal_map(source) -> np.ndarray:
    """Tangent-space normal map: rgb in [0, 1] -> 2 rgb - 1, normalised
    (reference ``image.rs:133-150``)."""
    n = _decode(source).astype(np.float64) / 255.0 * 2.0 - 1.0
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
    return n


def bump_to_normal_map(source, strength: float = 1.0) -> np.ndarray:
    """Grey height map -> tangent-space normals by central differences
    (reference ``image.rs:152-172``)."""
    h = _decode(source, grey=True).astype(np.float64) / 255.0
    gy, gx = np.gradient(h)
    n = np.stack([-gx * strength, gy * strength, np.ones_like(h)], axis=-1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    return n


def load_hdr(source) -> np.ndarray:
    """Radiance .hdr (RGBE, flat or run-length scanlines) -> linear RGB
    (H, W, 3) float64 (reference ``image.rs:205-253``, ``rgb.rs:79-93``)."""
    data = _read_bytes(source)
    if not (data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE")):
        raise ValueError("not a Radiance HDR file")
    # the header ends at a blank line; then the resolution line
    pos = data.find(b"\n\n")
    if pos < 0:
        raise ValueError("bad HDR header")
    pos += 2
    eol = data.find(b"\n", pos)
    res = data[pos:eol].split()
    if res[0] != b"-Y" or res[2] != b"+X":
        raise ValueError(f"unsupported HDR orientation {res!r}")
    h, w = int(res[1]), int(res[3])
    buf = np.frombuffer(data, np.uint8, offset=eol + 1)

    rows = np.zeros((h, w, 4), np.uint8)
    p = 0
    for y in range(h):
        # new-style run-length scanline: 0x02 0x02 hi lo
        if buf[p] == 2 and buf[p + 1] == 2 and \
                ((int(buf[p + 2]) << 8) | int(buf[p + 3])) == w:
            p += 4
            for c in range(4):
                x = 0
                while x < w:
                    count = int(buf[p])
                    p += 1
                    if count > 128:                       # a run
                        rows[y, x:x + count - 128, c] = buf[p]
                        p += 1
                        x += count - 128
                    else:                                 # literals
                        rows[y, x:x + count, c] = buf[p:p + count]
                        p += count
                        x += count
        else:                                             # flat scanline
            n = w * 4
            rows[y] = buf[p:p + n].reshape(w, 4)
            p += n
    mant = rows[..., :3].astype(np.float64)
    exp = rows[..., 3].astype(np.int32)
    rgb = mant * np.ldexp(1.0, exp - 128 - 8)[..., None]
    rgb[exp == 0] = 0.0
    return rgb
