"""The reference's scene: its own material, light and triangle tables,
worked out from the raw arrays the benchmark hands both sides, and its
own scene queries (frozen copies of the triangle paths of
``lumo_tpu_torch/scene/{scene,materials,trace}.py``).

A raw scene is a list of groups, each ``{"v": (V, 3), "f": (F, 3),
"n": (V, 3) or None, "material": spec}`` (float64 host arrays); every
group gets its own material row, in order.  Nearest hits are exact: a
group of fewer than ``DENSE_MAX`` triangles is tested whole; a larger
one through a hierarchy of Morton-ordered clusters whose padded boxes
can only rule out triangles the ray cannot reach, every remaining
triangle through the same watertight test.  Ties keep the lowest
triangle id."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import spectra
from .bsdf import LAMBERTIAN, LIGHT, MF_CONDUCTOR, MF_DIFFUSE, SUPPORTED
from .geometry import (INF, cross, dot, norm, normalize,
                       ray_setup, triangle_detail, triangle_t)

DENSE_MAX = 64
LEAF = 32                 # triangles a cluster
FAN = 8                   # clusters a parent
CHUNK = 1 << 24           # elements of one batch of candidate tests
# the program's float material tables that these kinds read, one for one
# (tf, the transmission, stays zero here but is a leaf all the same)
FLOAT_KEYS = ("kd", "ks", "tf", "roughness", "roughness_y", "eta", "k",
              "ke", "illum", "emit_scale")


# ---------------------------------------------------------------------------
# materials (``materials.py``)

def material_row(spec: dict) -> dict:
    """One material table row (numpy) of a material spec."""
    kind = spec["kind"]
    full = lambda x: np.full(spectra.DENSE_SAMPLES, float(x))
    row = {"kind": 0, "kd": np.zeros(4), "ks": np.zeros(4), "tf": np.zeros(4),
           "roughness": 1.0, "roughness_y": 1.0, "eta": np.ones(95),
           "k": np.zeros(95), "ke": np.zeros(4), "illum": np.zeros(95),
           "emit_scale": 1.0, "two_sided": False}
    if kind == "lambertian":
        row.update(kind=LAMBERTIAN, kd=spectra.spectrum(spec["kd"]))
    elif kind in ("diffuse", "metal"):
        metal = kind == "metal"
        rough = max(float(spec.get("roughness", 1.0)), 1e-5)
        row.update(
            kind=MF_CONDUCTOR if metal else MF_DIFFUSE,
            kd=spectra.spectrum([1, 1, 1] if metal else spec["kd"]),
            ks=spectra.spectrum(spec["ks"] if metal else [1, 1, 1]),
            tf=spectra.spectrum([0, 0, 0]), roughness=rough, roughness_y=rough,
            eta=full(spec.get("eta", 1.5)), k=full(spec.get("k", 0.0)))
    elif kind == "light":
        ke = spec["ke"]
        row.update(kind=LIGHT,
                   ke=(spectra.from_srgb8(*ke["srgb8"])
                       if isinstance(ke, dict) else spectra.spectrum(ke)),
                   illum=spectra.table(spec.get("illuminant", "D65")),
                   emit_scale=float(spec.get("scale", 1.0)),
                   two_sided=bool(spec.get("two_sided", False)))
    else:
        raise ValueError(f"material kind {kind!r} is not in the reference")
    return row


def mean_power(row) -> float:
    """The Y-weighted power of a light row (``Material.mean_power``)."""
    if row["kind"] != LIGHT:
        return 0.0
    lam = 360.0 + 5.0 * np.arange(spectra.DENSE_SAMPLES)
    x = (lam - 360.0) / 470.0
    t = row["ke"][0] * x * x + row["ke"][1] * x + row["ke"][2]
    ke = row["ke"][3] * (0.5 + t / (2.0 * np.sqrt(1.0 + t * t)))
    phi = float(np.sum(ke * row["illum"] * spectra.table("Y"))
                * spectra.STEP / spectra.Y_INTEGRAL) * row["emit_scale"]
    return 2.0 * phi if row["two_sided"] else phi


def build_alias(powers: np.ndarray):
    """Walker alias table: (pdf, accept_p, alias)."""
    n = len(powers)
    total = powers.sum()
    pdf = np.full(n, 1.0 / n) if total <= 0.0 else powers / total
    accept = np.ones(n)
    alias = np.arange(n)
    scaled = (pdf * n).copy()
    small = [i for i in range(n) if scaled[i] < 1.0]
    large = [i for i in range(n) if scaled[i] >= 1.0]
    while small and large:
        s = small.pop()
        l = large.pop()
        accept[s] = scaled[s]
        alias[s] = l
        scaled[l] = scaled[l] + scaled[s] - 1.0
        (large if scaled[l] >= 1.0 else small).append(l)
    for i in small + large:
        accept[i] = 1.0
    return pdf, accept, alias


# ---------------------------------------------------------------------------
# the cluster hierarchy

def _morton(q):
    """30-bit Morton codes of (M, 3) integers in [0, 1024)."""
    def spread(x):
        x = x.astype(np.int64) & 0x3FF
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        return (x | (x << 2)) & 0x09249249
    return (spread(q[:, 0]) << 2) | (spread(q[:, 1]) << 1) | spread(q[:, 2])


def _boxes(lo, hi, width):
    """Boxes of consecutive runs of ``width`` boxes (padding empty)."""
    n = -(-len(lo) // width)
    pad = n * width - len(lo)
    lo = np.concatenate([lo, np.full((pad, 3), np.inf)]).reshape(n, width, 3)
    hi = np.concatenate([hi, np.full((pad, 3), -np.inf)]).reshape(n, width, 3)
    return lo.min(1), hi.max(1)


@dataclasses.dataclass
class Clusters:
    order: torch.Tensor          # (L * LEAF,) group-local ids, -1 padding
    levels: list                 # [(lo, hi)] leaves first, top last


def build_clusters(a, b, c, device) -> Clusters:
    """The cluster hierarchy of a group's triangles (float32 numpy)."""
    lo = np.minimum(np.minimum(a, b), c).astype(np.float64)
    hi = np.maximum(np.maximum(a, b), c).astype(np.float64)
    g_lo, g_hi = lo.min(0), hi.max(0)
    ext = np.maximum(g_hi - g_lo, 1e-30)
    q = np.clip(((lo + hi) / 2 - g_lo) / ext * 1023.0, 0, 1023)
    order = np.argsort(_morton(q), kind="stable")
    pad = 1e-4 * float(ext.max())
    lo, hi = lo[order] - pad, hi[order] + pad
    levels = [_boxes(lo, hi, LEAF)]
    while len(levels[-1][0]) > FAN:
        levels.append(_boxes(*levels[-1], FAN))
    n_slots = len(levels[0][0]) * LEAF
    ids = np.full(n_slots, -1, np.int64)
    ids[:len(order)] = order
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=device)
    return Clusters(torch.as_tensor(ids, device=device),
                    [(f32(l), f32(h)) for l, h in levels])


def _slab(o, inv, t_max, lo, hi):
    t0 = (lo - o) * inv
    t1 = (hi - o) * inv
    tn = torch.maximum(torch.maximum(torch.minimum(t0[..., 0], t1[..., 0]),
                                     torch.minimum(t0[..., 1], t1[..., 1])),
                       torch.minimum(t0[..., 2], t1[..., 2]))
    tf = torch.minimum(torch.minimum(torch.maximum(t0[..., 0], t1[..., 0]),
                                     torch.maximum(t0[..., 1], t1[..., 1])),
                       torch.maximum(t0[..., 2], t1[..., 2])) * 1.0001
    return (tn <= tf) & (tf > 0.0) & (tn < t_max * 1.0001)


def _candidates(cl: Clusters, o, d, t_max):
    """(ray, leaf) pairs whose padded leaf box the ray reaches within
    ``t_max``."""
    tiny = torch.where(d < 0, -1e-30, 1e-30)
    inv = 1.0 / torch.where(d.abs() < 1e-30, tiny, d)
    live = torch.nonzero(t_max > 0.0)[:, 0]
    top_lo, top_hi = cl.levels[-1]
    K = top_lo.shape[0]
    ray = live.repeat_interleave(K)
    node = torch.arange(K, device=o.device).repeat(live.shape[0])
    keep = _slab(o[ray], inv[ray], t_max[ray], top_lo[node], top_hi[node])
    ray, node = ray[keep], node[keep]
    for lo, hi in reversed(cl.levels[:-1]):
        n_lvl = lo.shape[0]
        rays, nodes = [], []
        step = max(1, CHUNK // (FAN * 8))
        for s in range(0, ray.shape[0], step):
            r = ray[s:s + step, None].expand(-1, FAN).reshape(-1)
            ch = (node[s:s + step, None] * FAN
                  + torch.arange(FAN, device=o.device)).reshape(-1)
            ok = ch < n_lvl
            r, ch = r[ok], ch[ok]
            hit = _slab(o[r], inv[r], t_max[r], lo[ch], hi[ch])
            rays.append(r[hit])
            nodes.append(ch[hit])
        ray = torch.cat(rays) if rays else ray[:0]
        node = torch.cat(nodes) if nodes else node[:0]
    return ray, node


def _cluster_hits(cl, tri, o, d, t_max):
    """Per (ray, leaf) pair: the least t and, among equal t, the least
    group-local triangle id."""
    a, b, c = tri
    ray, leaf = _candidates(cl, o, d, t_max)
    kz, shear = ray_setup(d)
    big = torch.iinfo(torch.int64).max
    ts, ids = [], []
    step = max(1, CHUNK // (LEAF * 16))
    for s in range(0, ray.shape[0], step):
        r = ray[s:s + step]
        slot = (leaf[s:s + step, None] * LEAF
                + torch.arange(LEAF, device=o.device))
        tid = cl.order[slot]
        safe = torch.clamp(tid, min=0)
        t, _, _ = triangle_t(o[r], kz[r], shear[r], a[safe], b[safe],
                             c[safe], 0.0, t_max[r, None])
        t = torch.where(tid >= 0, t, INF)
        tb = t.amin(1)
        ts.append(tb)
        ids.append(torch.where(t == tb[:, None], tid, big).amin(1))
    return ray, torch.cat(ts) if ts else o.new_zeros(0), \
        torch.cat(ids) if ids else ray.new_zeros(0)


# ---------------------------------------------------------------------------
# the scene

class Scene:
    """The reference scene on ``device``; ``precision="bf16"`` holds the
    float tables in bfloat16 (the control)."""

    def __init__(self, groups, device, precision="float32"):
        self.device = torch.device(device)
        self.precision = precision
        rows, tri, mats, self.spans = [], {k: [] for k in
                                           ("a", "b", "c", "na", "nb", "nc")}, [], []
        n = 0
        for gi, g in enumerate(groups):
            rows.append(material_row(g["material"]))
            v = np.asarray(g["v"], np.float64)
            f = np.asarray(g["f"], np.int64)
            a, b, c = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
            if g.get("n") is None:
                na = nb = nc = np.zeros_like(a)
            else:
                nv = np.asarray(g["n"], np.float64)
                na, nb, nc = nv[f[:, 0]], nv[f[:, 1]], nv[f[:, 2]]
            keep = np.linalg.norm(np.cross(b - a, c - a), axis=-1) > 1e-20
            for k, x in zip(("a", "b", "c", "na", "nb", "nc"),
                            (a, b, c, na, nb, nc)):
                tri[k].append(x[keep])
            mats.append(np.full(int(keep.sum()), gi, np.int64))
            self.spans.append((n, n + int(keep.sum())))
            n += int(keep.sum())
        if not set(r["kind"] for r in rows) <= SUPPORTED:
            raise ValueError("a material kind the reference does not hold")
        host = {k: np.concatenate(v).astype(np.float32)
                for k, v in tri.items()}
        self.n_tris = n
        tri_mat = np.concatenate(mats)
        # lights and the alias table (``SceneBuilder.build``)
        light_prims = np.nonzero(np.array([rows[m]["kind"] == LIGHT
                                           for m in tri_mat]))[0]
        area = 0.5 * np.linalg.norm(np.cross(
            np.concatenate(tri["b"]) - np.concatenate(tri["a"]),
            np.concatenate(tri["c"]) - np.concatenate(tri["a"])), axis=-1)
        power = np.array([mean_power(r) for r in rows])
        pdf, accept, alias = build_alias(area[light_prims]
                                         * power[tri_mat[light_prims]])
        prim_light = np.full(n, -1, np.int64)
        prim_light[light_prims] = np.arange(len(light_prims))
        L = len(light_prims)
        self.n_lights = L
        self.n_shadow_rays = max(1, int(np.log2(max(L, 1))) if L > 1 else 1)
        dev = self.device
        fl = lambda x: self._store(torch.as_tensor(
            np.asarray(x).astype(np.float32), device=dev))
        it = lambda x: torch.as_tensor(np.asarray(x, np.int64), device=dev)
        self.tri = {k: self._store(torch.as_tensor(v, device=dev))
                    for k, v in host.items()}
        self.tri_mat = it(tri_mat)
        self.light_prim = it(light_prims)
        self.light_pdf, self.alias_p = fl(pdf), fl(accept)
        self.alias_idx = it(alias)
        self.prim_light = it(prim_light)
        self.materials = {
            "kind": it([r["kind"] for r in rows]),
            "two_sided": torch.as_tensor([r["two_sided"] for r in rows],
                                         device=dev),
            **{k: fl(np.stack([np.asarray(r[k], np.float64) for r in rows]))
               for k in FLOAT_KEYS}}
        self.kinds = frozenset(r["kind"] for r in rows)
        stored = {k: self.tri[k].cpu().numpy() for k in "abc"}
        self.clusters = [
            None if hi - lo < DENSE_MAX else build_clusters(
                *(stored[k][lo:hi] for k in "abc"), dev)
            for lo, hi in self.spans]

    def _store(self, x):
        if self.precision == "bf16":
            return x.to(torch.bfloat16).to(torch.float32)
        return x

    def with_materials(self, mats: dict) -> "Scene":
        """The same scene with some float material tables replaced (the
        gradients' leaves)."""
        out = object.__new__(Scene)
        out.__dict__.update(self.__dict__)
        out.materials = {**self.materials, **mats}
        return out

    # -- queries (detached rays) --------------------------------------
    def closest(self, o, d, t_max):
        """(t, global triangle id, -1 on a miss)."""
        N = o.shape[0]
        best_t = torch.full((N,), INF, device=o.device)
        best_p = torch.full((N,), -1, dtype=torch.int64, device=o.device)
        kz, shear = ray_setup(d)
        for (lo, hi), cl in zip(self.spans, self.clusters):
            tri = tuple(self.tri[k][lo:hi] for k in "abc")
            if cl is None:
                t, _, _ = triangle_t(o, kz, shear, *(x[None] for x in tri),
                                     0.0, t_max[:, None])
                j = torch.argmin(t, dim=1)
                tg = torch.gather(t, 1, j[:, None])[:, 0]
                pg = torch.where(torch.isfinite(tg), j + lo, -1)
                better = tg < best_t
                best_t = torch.where(better, tg, best_t)
                best_p = torch.where(better, pg, best_p)
                continue
            ray, tb, ids = _cluster_hits(cl, tri, o, d, t_max)
            gt = torch.full((N,), INF, device=o.device).scatter_reduce(
                0, ray, tb, "amin")
            eq = (tb == gt[ray]) & torch.isfinite(tb)
            big = torch.iinfo(torch.int64).max
            gp = torch.full((N,), big, dtype=torch.int64,
                            device=o.device).scatter_reduce(
                0, ray[eq], ids[eq] + lo, "amin")
            better = gt < best_t
            best_t = torch.where(better, gt, best_t)
            best_p = torch.where(better, gp, best_p)
        return best_t, best_p

    def occluded(self, o, d, t_max):
        occ = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
        kz, shear = ray_setup(d)
        for (lo, hi), cl in zip(self.spans, self.clusters):
            tri = tuple(self.tri[k][lo:hi] for k in "abc")
            if cl is None:
                t, _, _ = triangle_t(o, kz, shear, *(x[None] for x in tri),
                                     0.0, t_max[:, None])
                occ = occ | torch.isfinite(t).any(dim=1)
                continue
            ray, tb, _ = _cluster_hits(cl, tri, o, d, t_max)
            occ[ray[torch.isfinite(tb)]] = True
        return occ


# ---------------------------------------------------------------------------
# the scene queries of a bounce (``trace.py``)

def intersect(scene: Scene, o, d, alive):
    """Nearest hit of the wavefront; the hit distance and the shading
    data are differentiable in o and d, the search is not."""
    t_max = torch.where(alive, INF, 0.0)
    with torch.no_grad():
        _, prim = scene.closest(o.detach(), d.detach(), t_max)
    valid = prim >= 0
    tidx = torch.clamp(prim, 0, scene.n_tris - 1)
    tri = {k: v[tidx] for k, v in scene.tri.items()}
    kz, shear = ray_setup(d)
    t_re = triangle_t(o, kz, shear, tri["a"][:, None], tri["b"][:, None],
                      tri["c"][:, None], 0.0, INF)[0][:, 0]
    t = torch.where(valid, t_re, INF)
    det = triangle_detail(o, d, tri["a"], tri["b"], tri["c"], tri["na"],
                          tri["nb"], tri["nc"])
    return {
        "valid": valid, "t": t, "prim": torch.where(valid, prim, 0),
        "mat": scene.tri_mat[tidx], "p": det["p"], "ng": det["ng"],
        "ns": det["ns"], "err": det["err"],
        "backface": dot(d, det["ng"]) > 0.0,
        "light": scene.prim_light[tidx],
    }


def emitted(scene: Scene, mat, lam, backface):
    m = scene.materials
    ke = spectra.uplift_sample(m["ke"][mat][..., None, :], lam)
    illum = spectra.dense_rows(m["illum"], mat, lam)
    scale = m["emit_scale"][mat][..., None]
    is_light = (m["kind"][mat] == LIGHT)[..., None]
    visible = (m["two_sided"][mat] | ~backface)[..., None]
    return torch.where(is_light & visible, scale * ke * illum, 0.0)


def sample_light(scene: Scene, u):
    L = scene.n_lights
    x = u * L
    idx = torch.clamp(x.to(torch.int64), 0, L - 1)
    frac = x - idx.to(x.dtype)
    light = torch.where(frac < scene.alias_p[idx], idx, scene.alias_idx[idx])
    return light, scene.light_pdf[light]


def _light_tri(scene: Scene, light):
    prim = scene.light_prim[light]
    return (scene.tri["a"][prim], scene.tri["b"][prim], scene.tri["c"][prim],
            scene.tri_mat[prim])


def sample_towards(scene: Scene, light, xo, u):
    a, b, c, _ = _light_tri(scene, light)
    gamma = 1.0 - torch.sqrt(torch.clamp(1.0 - u[..., 0], min=0.0))
    beta = u[..., 1] * (1.0 - gamma)
    xi = a + beta[..., None] * (b - a) + gamma[..., None] * (c - a)
    return normalize(xi - xo)


def light_hit(scene: Scene, light, o, d):
    a, b, c, mat = _light_tri(scene, light)
    kz, shear = ray_setup(d)
    t = triangle_t(o, kz, shear, a[:, None], b[:, None], c[:, None], 0.0,
                   INF)[0][:, 0]
    z3 = torch.zeros_like(a)
    det = triangle_detail(o, d, a, b, c, z3, z3, z3)
    return {"valid": torch.isfinite(t), "t": t, "p": det["p"],
            "ng": det["ng"], "mat": mat,
            "backface": dot(d, det["ng"]) > 0.0}


def sample_towards_pdf(scene: Scene, light, o, d, xi, ng):
    a, b, c, _ = _light_tri(scene, light)
    rel = xi - o
    dist2 = dot(rel, rel)
    cos_l = torch.abs(dot(ng, d))
    cos_ok = cos_l > 1e-7
    area = 0.5 * norm(cross(b - a, c - a))
    den = torch.where(cos_ok, area * cos_l, 1.0)
    return torch.where(cos_ok, dist2 / torch.clamp(den, min=1e-30), 0.0)

