"""Textures: solid, checkerboard, marble (Perlin), image, Mandelbrot, and
normal maps.

Counterpart of ``lumo_tpu/texture.py`` (reference ``texture.rs``,
``perlin.rs``): the recursive ``Texture`` enum is an integer-tagged
table.  Nested checkerboards resolve by a fixed unroll, image textures
live in one flat atlas of uplift coefficients sampled by a bilinear
gather with wrap (reference ``image.rs:99-130``), and marble evaluates
6-octave Perlin turbulence over the 256-point gradient lattice, drawn
from the same numpy seed as the JAX package's, so the tables are equal.

Host side: :class:`Textures` collects definitions and ``pack()`` returns
the table as numpy arrays (``scene.from_numpy`` puts them on the
device).  Device side: ``albedo(tex, ids, lam, uv)`` gives spectral
values (N, 4) for per-lane texture ids; lanes with id -1 get 1.0.
"""
from __future__ import annotations

import numpy as np
import torch

from lumo_tpu_torch.color import uplift

TEX_SOLID, TEX_CHECKER, TEX_MARBLE, TEX_IMAGE, TEX_MANDELBROT = range(5)

CHECKER_DEPTH = 4         # max nesting of checkerboards
MARBLE_SCALE = 4.0        # reference ``texture.rs:6-14``
MARBLE_FREQ = 60.0
MARBLE_AMP = 20.0
MARBLE_OCTAVES = 6
MARBLE_GAIN = 0.5
MANDELBROT_DEPTH = 256    # reference ``texture.rs:17-21``
MANDELBROT_R2 = 64.0 ** 2
PERLIN_POINTS = 256


class Textures:
    """Host-side registry; ``pack()`` -> dict of numpy arrays."""

    def __init__(self, seed: int = 0):
        self.rows = []            # kind, spec, child1, child2, scale, img
        self.images = []          # (H, W, 4) coefficient arrays
        self.normal_images = []   # (H, W, 3) normal arrays
        rng = np.random.default_rng(seed)
        # Perlin lattice: uniform sphere gradients and per-axis
        # permutations (reference ``perlin.rs:31-46``)
        z = 1.0 - 2.0 * rng.uniform(size=PERLIN_POINTS)
        phi = 2.0 * np.pi * rng.uniform(size=PERLIN_POINTS)
        r = np.sqrt(np.maximum(0.0, 1.0 - z * z))
        self.lattice = np.stack([r * np.cos(phi), r * np.sin(phi), z], -1)
        self.perm = [rng.permutation(PERLIN_POINTS) for _ in range(3)]

    @staticmethod
    def _row(**kw) -> dict:
        row = dict(kind=TEX_SOLID, spec=np.zeros(4), child1=-1, child2=-1,
                   scale=1.0, img=-1)
        row.update(kw)
        return row

    def _add(self, **kw) -> int:
        self.rows.append(self._row(**kw))
        return len(self.rows) - 1

    def _as_id(self, t) -> int:
        """A texture id, or a spectrum spec that becomes a SOLID row."""
        if isinstance(t, (int, np.integer)):
            return int(t)
        return self.solid(t)

    def solid(self, spec) -> int:
        from lumo_tpu_torch.scene.materials import _spec
        return self._add(kind=TEX_SOLID, spec=_spec(spec))

    def checkerboard(self, t1, t2, scale: float) -> int:
        return self._add(kind=TEX_CHECKER, child1=self._as_id(t1),
                         child2=self._as_id(t2), scale=float(scale))

    def marble(self, spec) -> int:
        from lumo_tpu_torch.scene.materials import _spec
        return self._add(kind=TEX_MARBLE, spec=_spec(spec))

    def mandelbrot(self) -> int:
        return self._add(kind=TEX_MANDELBROT)

    def image(self, rgb_linear: np.ndarray) -> int:
        """An image texture from linear RGB (H, W, 3)."""
        coeffs = uplift.from_rgb(np.asarray(rgb_linear, np.float64))
        self.images.append(coeffs.astype(np.float32))
        return self._add(kind=TEX_IMAGE, img=len(self.images) - 1)

    def normal_map(self, normals: np.ndarray) -> int:
        """A normal map (H, W, 3) in [-1, 1]; returns a normal-map id (an
        id space of its own, apart from albedo textures)."""
        self.normal_images.append(np.asarray(normals, np.float32))
        return len(self.normal_images) - 1

    def mean_rgb(self, tex_id: int):
        """Mean value of an image texture's spectra (host; scales a
        textured light's power), 1 for other kinds."""
        row = self.rows[tex_id]
        if row["kind"] != TEX_IMAGE:
            return np.ones(3)
        img = self.images[row["img"]]
        lam = 360.0 + 5.0 * np.arange(95)
        x = (lam - 360.0) / 470.0
        c = img.reshape(-1, 4)
        t = c[:, 0:1] * x * x + c[:, 1:2] * x + c[:, 2:3]
        s = c[:, 3:4] * (0.5 + t / (2.0 * np.sqrt(1.0 + t * t)))
        return s.mean()

    def pack(self, dtype=np.float32):
        """The table as numpy arrays (None when nothing was defined), with
        the JAX package's keys.  Normal maps without an albedo texture get
        one unused solid row (the JAX package packs no table then, and its
        normal mapping fails on the missing table)."""
        if not self.rows and not self.normal_images:
            return None
        rows = self.rows or [self._row()]
        n = len(rows)

        def flat_atlas(images, channels):
            offs, ws, hs, chunks, o = [], [], [], [], 0
            for im in images:
                h, w = im.shape[:2]
                offs.append(o)
                ws.append(w)
                hs.append(h)
                chunks.append(im.reshape(-1, channels))
                o += h * w
            if not chunks:
                return np.zeros((1, channels), dtype), [0], [1], [1]
            return np.concatenate(chunks), offs, ws, hs

        atlas, offs, ws, hs = flat_atlas(self.images, 4)
        natlas, noffs, nws, nhs = flat_atlas(self.normal_images, 3)
        img_of = [rows[i]["img"] for i in range(n)]
        gi = lambda lst, d: np.asarray(
            [lst[img_of[i]] if img_of[i] >= 0 else d for i in range(n)],
            np.int32)
        i32 = lambda x: np.asarray(x, np.int32)
        return {
            "kind": i32([r["kind"] for r in rows]),
            "spec": np.stack([r["spec"] for r in rows]).astype(dtype),
            "child1": i32([r["child1"] for r in rows]),
            "child2": i32([r["child2"] for r in rows]),
            "scale": np.asarray([r["scale"] for r in rows], dtype),
            "img_ofs": gi(offs, 0), "img_w": gi(ws, 1), "img_h": gi(hs, 1),
            "atlas": np.asarray(atlas, dtype),
            "natlas": np.asarray(natlas, dtype),
            "n_ofs": i32(noffs), "n_w": i32(nws), "n_h": i32(nhs),
            "lattice": np.asarray(self.lattice, dtype),
            "perm_x": i32(self.perm[0]), "perm_y": i32(self.perm[1]),
            "perm_z": i32(self.perm[2]),
        }


# ---------------------------------------------------------------------------
# device side

def _perlin(tex, p):
    """Perlin noise at points p (N, 3) (reference ``perlin.rs:48-108``).
    Per axis and corner offset c in {0, 1}: the lattice index, the
    smootherstep weight 2 s c + 1 - s - c and the offset w - c, each
    computed once and combined over the eight corners."""
    fl = torch.floor(p)
    base = fl.to(torch.int64)
    w = p - fl
    sw = ((6.0 * w - 15.0) * w + 10.0) * w * w * w      # smootherstep
    idx, wgt, off = [], [], []
    for a, perm in enumerate((tex["perm_x"], tex["perm_y"], tex["perm_z"])):
        idx.append([perm[(base[..., a] + c) % PERLIN_POINTS] for c in (0, 1)])
        wgt.append([2.0 * sw[..., a] * c + 1.0 - sw[..., a] - c
                    for c in (0.0, 1.0)])
        off.append([w[..., a] - c for c in (0.0, 1.0)])
    acc = 0.0
    for i in (0, 1):
        for j in (0, 1):
            for k in (0, 1):
                g = tex["lattice"][idx[0][i] ^ idx[1][j] ^ idx[2][k]]
                dot = (g[..., 0] * off[0][i] + g[..., 1] * off[1][j]
                       + g[..., 2] * off[2][k])
                acc = acc + wgt[0][i] * wgt[1][j] * wgt[2][k] * dot
    return acc


def _turbulence(tex, p):
    acc = 0.0
    for octave in range(MARBLE_OCTAVES):
        acc = acc + (MARBLE_GAIN ** octave) * torch.abs(_perlin(tex, p))
        p = 2.0 * p
    return acc


def _bilinear(ids, uv, atlas, ofs_t, w_t, h_t):
    """Bilinear atlas gather with wrap (reference ``image.rs:99-130``);
    ofs/w/h are the per-image tables, indexed by ``ids``."""
    w, h, ofs = w_t[ids], h_t[ids], ofs_t[ids]
    fw, fh = w.to(uv.dtype), h.to(uv.dtype)
    # uv wrap; v flipped (image rows run top-down)
    x = (uv[..., 0] % 1.0) * (fw - 1.0)
    y = (1.0 - uv[..., 1] % 1.0) * (fh - 1.0)
    x0 = torch.minimum(torch.clamp(x.to(torch.int64), min=0), w - 1)
    y0 = torch.minimum(torch.clamp(y.to(torch.int64), min=0), h - 1)
    x1 = (x0 + 1) % torch.clamp(w, min=1)
    y1 = (y0 + 1) % torch.clamp(h, min=1)
    fx = (x - x0.to(uv.dtype))[..., None]
    fy = (y - y0.to(uv.dtype))[..., None]
    g = lambda yy, xx: atlas[torch.clamp(ofs + yy * w + xx, 0,
                                         atlas.shape[0] - 1)]
    v00, v01 = g(y0, x0), g(y0, x1)
    v10, v11 = g(y1, x0), g(y1, x1)
    return ((v00 * (1 - fx) + v01 * fx) * (1 - fy)
            + (v10 * (1 - fx) + v11 * fx) * fy)


def albedo(tex, ids, lam, uv, kinds=None):
    """Texture ids (N,) at wavelengths lam (N, 4) and uv (N, 2) -> (N, 4).
    Lanes with ids < 0 return 1.0.  ``kinds`` (the scene's set of
    texture kinds) decides which branches run, as the JAX package decides
    at trace time."""
    N = ids.shape[0]
    n_rows = tex["kind"].shape[0]
    valid = ids >= 0
    ids_c = torch.clamp(ids, 0, n_rows - 1)
    if kinds is None:
        kinds = (TEX_SOLID, TEX_CHECKER, TEX_MARBLE, TEX_IMAGE,
                 TEX_MANDELBROT)

    # resolve checkerboards; children are evaluated at the ORIGINAL uv
    # (reference ``texture.rs:66-72``)
    if TEX_CHECKER in kinds:
        for _ in range(CHECKER_DEPTH):
            is_ch = tex["kind"][ids_c] == TEX_CHECKER
            uvs = uv * tex["scale"][ids_c][..., None]
            parity = (torch.floor(uvs[..., 0])
                      + torch.floor(uvs[..., 1])).to(torch.int64) % 2
            child = torch.where(parity == 0, tex["child1"][ids_c],
                                tex["child2"][ids_c])
            ids_c = torch.where(is_ch, torch.clamp(child, 0, n_rows - 1),
                                ids_c)

    kind = tex["kind"][ids_c][..., None]
    out = uplift.sample(tex["spec"][ids_c][..., None, :], lam)       # (N, 4)

    if TEX_MARBLE in kinds:
        uvw = torch.abs(torch.cat([uv, torch.zeros_like(uv[..., :1])], -1))
        turb = _turbulence(tex, MARBLE_SCALE * uvw)
        marble_s = 1.0 - (0.5 + 0.5 * torch.sin(MARBLE_FREQ * uvw[..., 0]
                                                + MARBLE_AMP * turb)) ** 6
        out = torch.where(kind == TEX_MARBLE, out * marble_s[..., None], out)

    if TEX_IMAGE in kinds:
        coeffs = _bilinear(ids_c, uv, tex["atlas"], tex["img_ofs"],
                           tex["img_w"], tex["img_h"])
        out = torch.where(kind == TEX_IMAGE,
                          uplift.sample(coeffs[..., None, :], lam), out)

    if TEX_MANDELBROT in kinds:
        # [-1.5, 0.5] x [-1, 1] (reference ``texture.rs:75-90``)
        cr = 2.0 * (uv[..., 0] - 0.75)
        ci = 2.0 * (uv[..., 1] - 0.5)
        zr = torch.zeros(N, dtype=uv.dtype, device=uv.device)
        zi = torch.zeros_like(zr)
        for _ in range(MANDELBROT_DEPTH):
            live = zr * zr + zi * zi < MANDELBROT_R2
            zr, zi = (torch.where(live, zr * zr - zi * zi + cr, zr),
                      torch.where(live, 2.0 * zr * zi + ci, zi))
        inside = (zr * zr + zi * zi < MANDELBROT_R2)[..., None]
        out = torch.where(kind == TEX_MANDELBROT,
                          torch.where(inside, 1.0, 0.0), out)

    return torch.where(valid[..., None], out, 1.0)


def normal_at(tex, nm_ids, uv):
    """Tangent-space normals ([-1, 1]) of normal maps ``nm_ids`` (N,) at
    uv; lanes with id < 0 get (0, 0, 1)."""
    valid = nm_ids >= 0
    ids_c = torch.clamp(nm_ids, 0, tex["n_ofs"].shape[0] - 1)
    n = _bilinear(ids_c, uv, tex["natlas"], tex["n_ofs"], tex["n_w"],
                  tex["n_h"])
    n = n / torch.clamp(torch.linalg.vector_norm(n, dim=-1, keepdim=True),
                        min=1e-8)
    z = torch.zeros_like(n)
    z[..., 2] = 1.0
    return torch.where(valid[..., None], n, z)
