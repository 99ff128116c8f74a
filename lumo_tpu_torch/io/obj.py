"""Wavefront .obj / .mtl ingestion on the host.

Counterpart of ``lumo_tpu/io/obj.py`` (reference ``src/parser/{obj,mtl}.rs``
and ``src/parser.rs``): vertices, normals and uvs with negative indices,
polygon fan triangulation, ``usemtl``/``g``/``o`` grouping (emissive
groups become per-triangle lights through the SceneBuilder), .mtl
microfacet configurations with the Blender ``Ns`` roughness mapping and
the illum 5/6/7 Fresnel and transparency flags, texture maps decoded on a
4-worker pool (``mtl.rs:100-147``), and zip archives.

Nothing is downloaded: the URL entry points (``texture_from_url``,
``scene_from_url``, ``mesh_from_url``) read ``file://`` URIs and raise a
``ValueError`` for any other scheme.
"""
from __future__ import annotations

import dataclasses
import io
import zipfile
from typing import Optional
from urllib.parse import urlparse
from urllib.request import url2pathname

import numpy as np

from lumo_tpu_torch.scene.materials import Material
from lumo_tpu_torch.scene.scene import SceneBuilder


# ---------------------------------------------------------------------------
# .mtl

@dataclasses.dataclass
class MtlConfig:
    """Mirror of reference ``MtlConfig`` (``mtl.rs:10-57``)."""
    Kd: tuple = (0.0, 0.0, 0.0)
    Ks: tuple = (0.0, 0.0, 0.0)
    Ke: tuple = (0.0, 0.0, 0.0)
    Tf: tuple = (0.0, 0.0, 0.0)
    eta: float = 1.5
    k: float = 0.0
    roughness: float = 1.0
    fresnel_enabled: bool = False
    is_transparent: bool = False
    map_Kd: Optional[str] = None
    map_Ks: Optional[str] = None
    map_Ke: Optional[str] = None
    map_Bump: Optional[str] = None

    def build_material(self, textures=None, normal_maps=None) -> Material:
        """Reference ``MtlConfig::build_material`` (``mtl.rs:60-91``);
        ``textures`` and ``normal_maps`` map a path to its registered id."""
        tex = lambda p: -1 if (textures is None or p is None) \
            else textures.get(p, -1)
        nm = (-1 if (normal_maps is None or self.map_Bump is None)
              else normal_maps.get(self.map_Bump, -1))
        if any(v != 0.0 for v in self.Ke) or self.map_Ke is not None:
            ke = self.Ke if any(v != 0.0 for v in self.Ke) else (1.0, 1.0, 1.0)
            return Material.light(ke, ke_tex=tex(self.map_Ke))
        return Material.microfacet(
            self.roughness, self.eta, self.k,
            self.is_transparent, self.fresnel_enabled,
            self.Kd, self.Ks, self.Tf,
            kd_tex=tex(self.map_Kd), ks_tex=tex(self.map_Ks), nm_tex=nm)


def _map_path(tok) -> str:
    return " ".join(tok[1:]).replace("\\", "/")


def parse_mtl(text: str) -> dict:
    """.mtl source -> {name: MtlConfig} (reference ``mtl/task.rs``)."""
    mtls: dict[str, MtlConfig] = {}
    cur: Optional[MtlConfig] = None
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        tok = line.split()
        cmd = tok[0]
        if cmd == "newmtl":
            cur = MtlConfig()
            mtls[tok[1]] = cur
        elif cur is None:
            continue
        elif cmd in ("Kd", "Ks", "Ke", "Tf"):
            setattr(cur, cmd, tuple(float(x) for x in tok[1:4]))
        elif cmd == "Ni":
            cur.eta = float(tok[1])
        elif cmd == "Ns":
            # Blender mapping (reference ``mtl/task.rs:93-99``)
            cur.roughness = 1.0 - min(float(tok[1]), 900.0) ** 0.5 / 30.0
        elif cmd == "illum":
            illum = int(float(tok[1]))
            cur.fresnel_enabled = cur.fresnel_enabled or illum in (5, 7)
            cur.is_transparent = cur.is_transparent or illum in (6, 7)
        elif cmd in ("map_Kd", "map_Ks", "map_Ke"):
            # with ``scene_from_file(map_ks=False)`` map_Ks names an ORM
            # texture (``mtl/task.rs:55-70``)
            setattr(cur, cmd, _map_path(tok))
        elif cmd in ("map_Bump", "map_bump", "bump"):
            cur.map_Bump = _map_path(tok)
    return mtls


# ---------------------------------------------------------------------------
# .obj

def _parse_idx(s: str, n: int) -> int:
    i = int(s)
    return i - 1 if i > 0 else n + i


def parse_obj(text: str):
    """Single-pass .obj parse -> (vertices (V, 3), normals (Vn, 3), uvs
    (Vt, 2), groups), groups a list of (mtl name or None, faces (F, 3),
    normal indices (F, 3) or None, uv indices (F, 3) or None)."""
    v_lines, vn_lines, vt_lines = [], [], []
    groups: list[tuple[Optional[str], list]] = [(None, [])]
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        c0 = line[0]
        if c0 == "v":
            if line.startswith("v "):
                v_lines.append(line[2:])
            elif line.startswith("vn "):
                vn_lines.append(line[3:])
            elif line.startswith("vt "):
                vt_lines.append(line[3:])
        elif c0 == "f":
            groups[-1][1].append(line.split()[1:])
        elif line.startswith(("g", "o")):
            if groups[-1][1]:
                groups.append((groups[-1][0], []))
        elif line.startswith("usemtl"):
            name = line.split(None, 1)[1].strip()
            if groups[-1][1]:
                groups.append((name, []))
            else:
                groups[-1] = (name, groups[-1][1])

    def farr(lines, d):
        if not lines:
            return np.zeros((0, d))
        a = np.array(" ".join(lines).split(), np.float64)
        if len(a) == len(lines) * d:      # uniform arity
            return a.reshape(-1, d)
        return np.array([ln.split()[:d] for ln in lines], np.float64)

    verts = farr(v_lines, 3)
    normals = farr(vn_lines, 3)
    if len(normals):
        nl = np.linalg.norm(normals, axis=-1, keepdims=True)
        normals = np.where(nl < 1e-12, [0.0, 0.0, 1.0],
                           normals / np.maximum(nl, 1e-30))
    uvs = farr(vt_lines, 2)

    out = []
    for name, face_tokens in groups:
        if not face_tokens:
            continue
        fv, fn, ft = [], [], []
        for corners in face_tokens:
            parsed = []
            for tokn in corners:
                parts = tokn.split("/")
                vi = _parse_idx(parts[0], len(verts))
                ti = (_parse_idx(parts[1], len(uvs))
                      if len(parts) > 1 and parts[1] else -1)
                ni = (_parse_idx(parts[2], len(normals))
                      if len(parts) > 2 and parts[2] else -1)
                parsed.append((vi, ti, ni))
            # fan triangulation (reference ``obj.rs:175-196``)
            for i in range(1, len(parsed) - 1):
                a, b, c = parsed[0], parsed[i], parsed[i + 1]
                fv.append((a[0], b[0], c[0]))
                ft.append((a[1], b[1], c[1]))
                fn.append((a[2], b[2], c[2]))
        fv = np.asarray(fv, np.int64)
        fn = np.asarray(fn, np.int64)
        ft = np.asarray(ft, np.int64)
        has_n = len(normals) > 0 and (fn >= 0).all()
        has_t = len(uvs) > 0 and (ft >= 0).all()
        out.append((name, fv, fn if has_n else None, ft if has_t else None))
    return verts, normals, uvs, out


# ---------------------------------------------------------------------------
# entry points (reference ``parser.rs:125-201``)

def _read(source) -> str:
    if hasattr(source, "read"):
        data = source.read()
        return data.decode() if isinstance(data, bytes) else data
    with open(source, "rb") as f:
        return f.read().decode(errors="replace")


def _add_groups(b, verts, normals, uvs, groups, mat_of, transform=None):
    for name, fv, fn, ft in groups:
        b.add_triangles(verts, fv, mat_of(name),
                        normals=normals if fn is not None else None,
                        vertex_normal_idx=fn,
                        uvs=uvs if ft is not None else None, uv_idx=ft,
                        transform=transform)


def mesh_from_file(source, material: Material, builder: SceneBuilder = None,
                   transform=None) -> SceneBuilder:
    """An .obj as one mesh of one material (reference
    ``parser::mesh_from_path``)."""
    b = builder or SceneBuilder()
    mid = b.material(material)
    _add_groups(b, *parse_obj(_read(source)), lambda _: mid, transform)
    return b


def _decode_maps(b, mtls, resolve, map_ks):
    """Decode every image the .mtl names, on a 4-worker pool, and register
    it: {path: texture id}, {path: normal-map id}; with ``map_ks`` false
    the ``map_Ks`` images are ORM maps whose channel means set roughness
    and metalness instead."""
    from concurrent.futures import ThreadPoolExecutor

    from lumo_tpu_torch.io import image as image_io

    tex_paths, orm_paths, bump_paths = set(), set(), set()
    for cfg in mtls.values():
        maps = ((cfg.map_Kd, cfg.map_Ks, cfg.map_Ke) if map_ks
                else (cfg.map_Kd, cfg.map_Ke))
        tex_paths.update(p for p in maps if p)
        if not map_ks and cfg.map_Ks:
            orm_paths.add(cfg.map_Ks)
        if cfg.map_Bump:
            bump_paths.add(cfg.map_Bump)

    def decode(job):
        path, kind = job
        src = resolve(path)
        if src is None:
            return None
        if kind == "bump":
            return image_io.bump_to_normal_map(src)
        return image_io.load_png(src)

    jobs = ([(p, "tex") for p in sorted(tex_paths)]
            + [(p, "orm") for p in sorted(orm_paths)]
            + [(p, "bump") for p in sorted(bump_paths)])
    with ThreadPoolExecutor(max_workers=4) as pool:
        decoded = list(pool.map(decode, jobs))
    textures, normal_maps, orm_means = {}, {}, {}
    for (path, kind), img in zip(jobs, decoded):
        if img is None:
            continue
        if kind == "tex":
            textures[path] = b.textures.image(img)
        elif kind == "bump":
            normal_maps[path] = b.textures.normal_map(img)
        else:
            orm_means[path] = img.reshape(-1, img.shape[-1]).mean(axis=0)
    for cfg in mtls.values():
        orm = orm_means.get(cfg.map_Ks)
        if orm is not None:
            # occlusion, roughness, metalness channels
            cfg.roughness = float(orm[1])
            cfg.k = float(orm[2])
            cfg.Ks = (1.0, 1.0, 1.0)
            cfg.map_Ks = None
    return textures, normal_maps


def scene_from_file(obj_source, mtl_source=None, builder: SceneBuilder = None,
                    default_material: Material = None,
                    resolve=None, map_ks: bool = True) -> SceneBuilder:
    """An .obj with its .mtl library: one sub-mesh per ``usemtl``,
    emissive groups as lights (reference ``obj::load_scene``).

    ``resolve(path)`` returns a binary file for a texture path of the .mtl
    (e.g. out of a zip), or None where there is none.  ``map_ks=False``
    treats ``map_Ks`` as an ORM texture (occlusion, roughness, metalness):
    its channel means set roughness and metalness and Ks becomes white,
    with no specular texture (reference ``mtl/task.rs:55-70``)."""
    b = builder or SceneBuilder()
    mtls = parse_mtl(_read(mtl_source)) if mtl_source is not None else {}
    textures, normal_maps = ({}, {}) if resolve is None else _decode_maps(
        b, mtls, resolve, map_ks)
    mat_ids = {name: b.material(cfg.build_material(textures, normal_maps))
               for name, cfg in mtls.items()}
    default = []

    def mat_of(name):
        if name is not None and name in mat_ids:
            return mat_ids[name]
        if name is not None and mtls:
            raise ValueError(f"could not find material {name}")
        if not default:
            default.append(b.material(
                default_material or Material.diffuse((0.9, 0.9, 0.9))))
        return default[0]

    _add_groups(b, *parse_obj(_read(obj_source)), mat_of)
    return b


def _zip_member(zf: zipfile.ZipFile, suffix: str) -> Optional[str]:
    for n in zf.namelist():
        if n.endswith(suffix):
            return n
    return None


def scene_from_zip(zip_bytes: bytes, builder: SceneBuilder = None) \
        -> SceneBuilder:
    """The .obj and .mtl of a zip archive, found by suffix, with the
    archive's images as their texture maps (reference
    ``parser.rs:88-114``)."""
    zf = zipfile.ZipFile(io.BytesIO(zip_bytes))
    obj_name = _zip_member(zf, ".obj")
    if obj_name is None:
        raise ValueError("no .obj in zip")
    mtl_name = _zip_member(zf, ".mtl")
    obj = io.BytesIO(zf.read(obj_name))
    mtl = io.BytesIO(zf.read(mtl_name)) if mtl_name else None

    def resolve(path):
        m = _zip_member(zf, path.rsplit("/", 1)[-1])
        return io.BytesIO(zf.read(m)) if m else None

    return scene_from_file(obj, mtl, builder=builder, resolve=resolve)


def _local_path(url: str) -> str:
    """The file a ``file://`` URI names; any other scheme raises, since
    the port downloads nothing."""
    u = urlparse(url)
    if u.scheme != "file":
        raise ValueError(f"{url}: only file:// URIs are read; nothing is "
                         "downloaded")
    return url2pathname(u.path)


def _read_url(url: str) -> bytes:
    with open(_local_path(url), "rb") as f:
        return f.read()


def scene_from_url(url: str, builder: SceneBuilder = None) -> SceneBuilder:
    """A zip archive or an .obj at a ``file://`` URI (reference
    ``parser::scene_from_url``)."""
    data = _read_url(url)
    if url.endswith(".zip"):
        return scene_from_zip(data, builder)
    return scene_from_file(io.BytesIO(data), builder=builder)


def mesh_from_url(url: str, material: Material,
                  builder: SceneBuilder = None) -> SceneBuilder:
    """:func:`mesh_from_file` of an .obj, or of the .obj in a zip archive,
    at a ``file://`` URI."""
    data = _read_url(url)
    if url.endswith(".zip"):
        zf = zipfile.ZipFile(io.BytesIO(data))
        data = zf.read(_zip_member(zf, ".obj"))
    return mesh_from_file(io.BytesIO(data), material, builder)


def texture_from_url(url: str, builder: SceneBuilder) -> int:
    """Decode the image at a ``file://`` URI (PNG or .hdr, or the first
    such image in a zip archive) and register it in ``builder.textures``;
    returns the texture id for ``Material(..., kd_tex=id)`` (reference
    ``parser.rs:177-182``)."""
    from lumo_tpu_torch.io import image as image_io

    def decode(name, data):
        if name.lower().endswith(".hdr"):
            return image_io.load_hdr(io.BytesIO(data))
        return image_io.load_png(io.BytesIO(data))

    data = _read_url(url)
    if url.endswith(".zip"):
        zf = zipfile.ZipFile(io.BytesIO(data))
        name = None
        for suffix in (".png", ".hdr", ".jpg", ".jpeg"):
            name = _zip_member(zf, suffix)
            if name:
                break
        if name is None:
            raise ValueError(f"no image inside {url}")
        rgb = decode(name, zf.read(name))
    else:
        rgb = decode(url, data)
    return builder.textures.image(rgb)
