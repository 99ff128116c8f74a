"""Bidirectional path tracer.

Counterpart of ``lumo_tpu/integrators/bdpt.py`` (reference
``src/tracer/integrator/bd_path_trace*``): per sample a light subpath
and a camera subpath of up to ``max_verts`` vertices each, every (s, t)
prefix pair connected and weighted by the power-heuristic MIS sweep
(``mis.rs:103-239``).

- A subpath is a list of vertices, each a dict of (N, ...) tensors (the
  fields of ``_root``).  ``_walk`` runs a fixed number of steps under an alive
  mask with no host sync, as the JAX package's ``lax.scan`` runs every
  step.
- The s = 0, s = 1 and t = 1 families are Python loops over static
  (s, t), in the JAX package's order, so each MIS weight is an unrolled
  sweep over exactly the s + t positions of its strategy; each of their
  connections issues its own any-hit query over the whole wavefront.
- The general strategies (s, t >= 2) of one s run as one batch
  (``_connect``): the t - 1 strategies stacked along the lanes, one
  any-hit query over them all, and MIS sweeps masked per lane
  (``_sweep``); each lane keeps the bits of its own strategy, and the
  sums add in the JAX package's order (s outer, t inner).
- Lanes whose strategy does not apply get t_max 0.
- The t = 1 strategies (light vertex seen by the lens) are splats: raster
  coordinates of their own, laid out (S - 1, N, ...), which the renderer
  scatters into the film's splat buffer.

Every draw is a counter hash of the per-ray key, with the JAX package's
streams and salts, so the port's subpaths are the JAX package's bit for
bit in their random numbers.

While a profiler records (``telemetry``), each phase is a span
(``bdpt.integrate``, ``bdpt.walk.light``, ``bdpt.walk.camera``,
``bdpt.s0``, ``bdpt.s1``, ``bdpt.t1``, one ``bdpt.connect`` a batch) and
three counters count the lanes handed to the connections' any-hit
queries (``bdpt.connect.lanes``), those of them with a positive t_max
(``bdpt.connect.live``) and the t = 1 splats that land
(``bdpt.splats``).
"""
from __future__ import annotations

import math

import torch

from lumo_tpu_torch import telemetry
from lumo_tpu_torch.bsdf import eval as bsdf
from lumo_tpu_torch.color import space, wavelength
from lumo_tpu_torch.config import IMPORTANCE, RADIANCE, epsilon
from lumo_tpu_torch.geometry import intersect as geo
from lumo_tpu_torch.geometry.onb import dot, norm, normalize
from lumo_tpu_torch.integrators import path_trace
from lumo_tpu_torch.integrators.common import shrink
from lumo_tpu_torch.sampling.samplers import MASK32, _hash_u32, _randfloat
from lumo_tpu_torch.scene import trace
from lumo_tpu_torch.scene.materials import BLANK, VOLUMETRIC

PI = math.pi
_TINY = 1e-30
RR_DEPTH = 5         # reference ``bd_path_trace.rs:4``
MAX_VERTS = 6        # per subpath, the root (lens or light point) included

# per-ray counter-hash streams and salts (``lumo_tpu/integrators/bdpt.py:49-62``)
_C_LIGHT = 0x9E3779B9     # light subpath
_C_CAMERA = 0x3C6EF372    # camera subpath
_C_CONNECT = 0xDAA66D2B   # connection strategies
_S_MED = 0x7F4A7C15       # the medium's free flight inside the walks
_S_LOBE = 0xC2B2AE35
_S_SQ0 = 0x85EBCA6B
_S_SQ1 = 0x27D4EB2F
_S_RR = 0x165667B1
_S_PICK = 0x2545F491
_S_ON0 = 0x94D049BB
_S_ON1 = 0xBF58476D
_S_DIR0 = 0xFD7046C5
_S_DIR1 = 0xD3A2646C
_S_OCC = 0x68BC21EB


def _sa_to_area(pdf, xo, xi, wi, ngi):
    """Solid-angle pdf at xo to area pdf at xi (reference
    ``measure.rs:9-12``); coincident points divide by a floor."""
    r = xo - xi
    return pdf * torch.abs(dot(wi, ngi)) / torch.clamp(dot(r, r), min=_TINY)


def _map0(p):
    """pdf 0 -> 1 in the MIS ratios (reference ``mis.rs:122-124``)."""
    return torch.where(p == 0.0, 1.0, p)


def _mp(scene, v, lam):
    """The material parameters of vertex ``v`` at wavelengths lam."""
    return bsdf.gather_params(scene.materials, torch.clamp(v["mat"], min=0),
                              lam, v["uv"], scene.textures, scene.tex_kinds,
                              t=v["t"], kinds=scene.kinds_present,
                              beck=scene.beckmann)


def _vertex_pdf(v, wo, wi, lam, mp):
    """BSDF pdf at vertex v for the world directions (wo, wi)."""
    return bsdf.pdf(mp, wo, wi, v["ng"], v["ns"], lam)


def _vertex_f(v, wi, lam, mode, mp):
    """BSDF value at vertex v towards wi (reference ``vertex.rs:131-136``)."""
    return bsdf.f(mp, v["wo"], wi, v["ng"], v["ns"], v["backface"], lam,
                  mode)


def _shading_correction(mp, v, wi):
    """The non-symmetry correction of importance transport through
    shading normals (reference ``vertex.rs:120-128``)."""
    c = lambda a, b: bsdf.shading_cosine(mp, a, b)
    num = c(wi, v["ng"]) * c(v["wo"], v["ns"])
    den = c(v["wo"], v["ng"]) * c(wi, v["ns"])
    return num / torch.clamp(den, min=_TINY)


# ---------------------------------------------------------------------------
# subpaths (reference ``path_gen.rs``)

def _walk(scene, o, d, lam, rng, gathered, pdf_sa, mode, delta_rr, prev_p,
          prev_ng, prev_delta, prev_surface, n_steps):
    """Random-walk ``n_steps`` vertices from the rays (o, d).

    ``rng``: (N,) per-ray counter states; ``pdf_sa``: the solid-angle pdf
    of d at the root; ``mode``: RADIANCE (camera) or IMPORTANCE (light).
    Returns (vertices, a list of ``n_steps`` dicts; the root's backward
    pdf (N,); the wavelengths after the walk)."""
    N, dev = o.shape[0], o.device
    alive = torch.ones(N, dtype=torch.bool, device=dev)
    verts, pdf_bck_prev = [], []
    for depth in range(1, n_steps + 1):
        rng = _hash_u32(rng + 0x9E3779B9)
        hit = trace.intersect(scene, o, d, rng=rng, salt=_S_MED, alive=alive)
        alive = alive & hit["valid"]
        wo = -d
        tr_seg = trace.transmittance(scene, lam, hit["t"])
        gathered = gathered * torch.where(alive[..., None], tr_seg, 1.0)

        lam2 = wavelength.terminate(
            lam, bsdf.dispersive_mask(scene.materials, hit["mat"]))
        mp = bsdf.gather_params(scene.materials, hit["mat"], lam2, hit["uv"],
                                scene.textures, scene.tex_kinds, t=hit["t"],
                                kinds=scene.kinds_present,
                                beck=scene.beckmann)
        kind = telemetry.gather(scene.materials["kind"], hit["mat"])
        is_surface = (kind != BLANK) & (kind != VOLUMETRIC) & ~hit["is_medium"]

        # forward pdf in area measure at this vertex (reference
        # ``vertex.rs:70-89``; a medium vertex takes the ray as its normal)
        ng_eff = torch.where(hit["is_medium"][..., None], d, hit["ng"])
        pdf_fwd = torch.where(mp["is_delta"], 0.0,
                              _sa_to_area(pdf_sa, prev_p, hit["p"], d, ng_eff))

        u_sq = torch.stack([_randfloat(rng, _S_SQ0), _randfloat(rng, _S_SQ1)],
                           -1)
        wi, ok, _ = bsdf.sample(mp, wo, hit["ns"], hit["backface"], lam2,
                                _randfloat(rng, _S_LOBE), u_sq)
        # a light, a blank or a failed sample ends the path: importance
        # transport drops the vertex, radiance keeps it with its light id
        # (reference ``path_gen.rs:86-99``)
        v_valid = alive & ok if mode == IMPORTANCE else alive
        v_light = torch.where(alive & ~ok, hit["light"], -1)

        p_next = bsdf.pdf(mp, wo, wi, hit["ng"], hit["ns"], lam2)
        cont = alive & ok & (p_next > 0.0) & torch.isfinite(p_next)
        p_safe = torch.where(cont, p_next, 1.0)
        f_val = bsdf.f(mp, wo, wi, hit["ng"], hit["ns"], hit["backface"],
                       lam2, mode)
        f_val = torch.where(hit["is_medium"][..., None],
                            f_val * p_safe[..., None], f_val)
        f_val = torch.where(cont[..., None], f_val, 0.0)
        cosw = bsdf.shading_cosine(mp, wi, hit["ns"])
        if mode == IMPORTANCE:
            cosw = cosw * _shading_correction(
                mp, {"wo": wo, "ng": hit["ng"], "ns": hit["ns"]}, wi)
        g_next = gathered * f_val * (cosw / p_safe)[..., None]

        # backward pdf at the previous vertex (reference
        # ``vertex.rs:139-162``)
        p_swap = bsdf.pdf(mp, wi, wo, hit["ng"], hit["ns"], lam2)
        ngp = torch.where(prev_surface[..., None], prev_ng, wo)
        pdf_bck_prev.append(torch.where(
            mp["is_delta"] | prev_delta | ~cont, 0.0,
            _sa_to_area(p_swap, hit["p"], prev_p, wo, ngp)))

        # Russian roulette (reference ``path_gen.rs:125-137``)
        if depth >= RR_DEPTH:
            rr_prob = torch.clamp(space.luminance(g_next, lam2) / delta_rr,
                                  max=1.0)
            cont = cont & ~(_randfloat(rng, _S_RR) > rr_prob)
            rr_div = torch.where(cont, torch.clamp(rr_prob, min=_TINY), 1.0)
            g_next = g_next / rr_div.detach()[..., None]

        # a delta material zeroes the next forward pdf
        # (reference ``path_gen.rs:140-142``)
        pdf_sa = torch.where(mp["is_delta"], 0.0, p_next)
        ro = geo.offset_ray_origin(hit["p"], hit["err"], hit["ng"], wi)
        verts.append({
            "p": hit["p"], "ng": hit["ng"], "ns": hit["ns"], "wo": wo,
            "uv": hit["uv"], "err": hit["err"], "gathered": gathered,
            "pdf_fwd": pdf_fwd, "pdf_bck": None, "t": hit["t"],
            "mat": hit["mat"], "light": v_light, "valid": v_valid,
            "delta": mp["is_delta"] & v_valid, "surface": is_surface,
            "backface": hit["backface"], "medium": hit["is_medium"]})
        c1, c3 = cont, cont[..., None]
        o = torch.where(c3, ro, o)
        d = torch.where(c3, wi, d)
        lam = torch.where(alive[..., None], lam2, lam)
        gathered = torch.where(c3, g_next, gathered)
        prev_p = torch.where(c3, hit["p"], prev_p)
        prev_ng = torch.where(c3, hit["ng"], prev_ng)
        prev_delta = torch.where(c1, mp["is_delta"], prev_delta)
        prev_surface = torch.where(c1, is_surface, prev_surface)
        alive = cont
    # the backward pdf found at step i belongs to vertex i - 1
    for v, pb in zip(verts, pdf_bck_prev[1:] + [torch.zeros_like(lam[:, 0])]):
        v["pdf_bck"] = pb
    return verts, pdf_bck_prev[0], lam


def _root(p, ng, ns, err, gathered, pdf_fwd, mat, light, surface):
    """A subpath's root vertex: no direction, never delta."""
    N, dev = p.shape[0], p.device
    false = torch.zeros(N, dtype=torch.bool, device=dev)
    zeros = torch.zeros(N, dtype=p.dtype, device=dev)
    return {"p": p, "ng": ng, "ns": ns, "wo": torch.zeros_like(p),
            "uv": torch.zeros((N, 2), dtype=p.dtype, device=dev),
            "err": err, "gathered": gathered, "pdf_fwd": pdf_fwd,
            "pdf_bck": zeros, "t": zeros, "mat": mat, "light": light,
            "valid": torch.ones(N, dtype=torch.bool, device=dev),
            "delta": false, "surface": surface, "backface": false,
            "medium": false}


def _camera_path(scene, camera, o, d, lam, rng0, delta_rr, n_verts):
    """The camera subpath of the rays (o, d): the lens point and
    ``n_verts - 1`` walk vertices (reference ``path_gen.rs:4-19``).
    Returns (vertices, wavelengths after the walk)."""
    N, dev = o.shape[0], o.device
    zeros3 = torch.zeros_like(o)
    no_light = torch.full((N,), -1, dtype=torch.int64, device=dev)
    false = torch.zeros(N, dtype=torch.bool, device=dev)
    root = _root(o, zeros3, zeros3, zeros3, torch.ones_like(lam),
                 camera.pdf_xo(o), no_light, no_light, false)
    verts, root["pdf_bck"], lam_out = _walk(
        scene, o, d, lam, rng0, torch.ones_like(lam), camera.pdf_wi(o, d),
        RADIANCE, delta_rr, o, zeros3, false, false, n_verts - 1)
    return [root] + verts, lam_out


def _light_path(scene, lam, rng0, delta_rr, n_verts):
    """The light subpath: a point leaving a light picked by the alias
    table and ``n_verts - 1`` walk vertices, valid up to its first invalid
    vertex (reference ``path_gen.rs:22-49``).  Returns (vertices,
    wavelengths after the walk)."""
    N = lam.shape[0]
    light, pdf_light = trace.sample_light(scene, _randfloat(rng0, _S_PICK))
    u0 = torch.stack([_randfloat(rng0, _S_ON0), _randfloat(rng0, _S_ON1)], -1)
    u1 = torch.stack([_randfloat(rng0, _S_DIR0), _randfloat(rng0, _S_DIR1)],
                     -1)
    p, d, ng, ns, err, mat = trace.sample_leaving(scene, light, u0, u1)
    pdf_origin, pdf_dir = trace.sample_leaving_pdf(scene, light, d, ng)
    false = torch.zeros(N, dtype=torch.bool, device=lam.device)
    emit = trace.emitted(scene, mat, lam, torch.zeros_like(lam[:, :2]), false)
    root = _root(p, ng, ns, err, emit, pdf_origin * pdf_light, mat, light,
                 ~false)
    denom = torch.clamp(pdf_light * pdf_origin * pdf_dir, min=_TINY)
    gathered = torch.where((pdf_dir > 0.0)[..., None],
                           emit * (torch.abs(dot(d, ns)) / denom)[..., None],
                           0.0)
    verts, root["pdf_bck"], lam_out = _walk(
        scene, geo.offset_ray_origin(p, err, ng, d), d, lam,
        _hash_u32(rng0 ^ 0x51633E2D), gathered, pdf_dir, IMPORTANCE,
        delta_rr, p, ng, false, ~false, n_verts - 1)
    path = [root] + verts
    # a light subpath is only as long as its run of valid vertices
    for prev, v in zip(path, path[1:]):
        v["valid"] = v["valid"] & prev["valid"]
    return path, lam_out


# ---------------------------------------------------------------------------
# MIS (reference ``mis.rs``)

# the vertex fields a connection reads
_CKEYS = ("p", "ng", "ns", "wo", "err", "gathered", "pdf_fwd", "pdf_bck",
          "light", "valid", "delta", "surface", "backface")


def _fields(v):
    return {k: v[k] for k in _CKEYS if k in v}


def _batch(dicts):
    """Vertex or material dicts stacked along the lanes: tensors are
    concatenated, host-side entries (a family set, a flag) taken from the
    first."""
    if len(dicts) == 1:
        return dicts[0]
    return {k: (torch.cat([x[k] for x in dicts]) if isinstance(v, torch.Tensor)
                else v) for k, v in dicts[0].items()}


def _pdf_light_origin(scene, v):
    """Area pdf of choosing vertex v as a light point (``mis.rs:57-64``)."""
    light = torch.clamp(v["light"], min=0)
    pdf = scene.light_pdf[light] / torch.clamp(trace.light_area(scene, light),
                                               min=_TINY)
    return torch.where(v["light"] >= 0, pdf, 0.0)


def _pdf_light_leaving(vc, vn):
    """Area pdf at vn of leaving the light vertex vc (``mis.rs:4-32``):
    the cosine lobe of ``trace.sample_leaving``."""
    wi = normalize(vn["p"] - vc["p"], eps=_TINY)
    pdf_dir = dot(vc["ng"], wi) / PI     # trace.sample_leaving_pdf's
    ngi = torch.where(vn["surface"][..., None], vn["ng"], wi)
    out = _sa_to_area(pdf_dir, vc["p"], vn["p"], wi, ngi)
    return torch.where((vc["light"] >= 0) & ~vn["delta"], out, 0.0)


def _pdf_camera_leaving(camera, vc, vn):
    """Area pdf at vn of leaving the lens point vc (``mis.rs:35-54``)."""
    wi = normalize(vn["p"] - vc["p"], eps=_TINY)
    ngi = torch.where(vn["surface"][..., None], vn["ng"], wi)
    out = _sa_to_area(camera.pdf_wi(vc["p"], wi), vc["p"], vn["p"], wi, ngi)
    return torch.where(vn["delta"], 0.0, out)


def _pdf_connection(lam, vc, vn, mp_c, vp=None):
    """Area pdf at vn of scattering at vc, towards vn, or with ``vp``
    given from vp's direction (``mis.rs:69-97``)."""
    if vp is None:
        wi = normalize(vn["p"] - vc["p"], eps=_TINY)
        pdf_sa = _vertex_pdf(vc, vc["wo"], wi, lam, mp_c)
    else:
        wi = vc["wo"]
        pdf_sa = _vertex_pdf(vc, normalize(vp["p"] - vc["p"], eps=_TINY), wi,
                             lam, mp_c)
    ngi = torch.where(vn["surface"][..., None], vn["ng"], wi)
    out = _sa_to_area(pdf_sa, vc["p"], vn["p"], wi, ngi)
    return torch.where(vn["delta"], 0.0, out)


def _mis_weight(scene, camera, lam, lp, cp, s, t, mp_ls1=None, mp_ct1=None):
    """Power-heuristic MIS weight of strategy (s, t) (reference
    ``mis.rs:103-239``): s light vertices ``lp[:s]`` joined to t camera
    vertices ``cp[:t]`` (``lp`` None for s = 0).  ``t`` may be a sequence
    of lengths: the strategies (s, t) as one batch of len(t) N lanes, with
    ``lam`` and the materials ``mp_*`` batched alike.

    The joined path's positions i = 0 .. s + t - 1 run from the light end:
    light vertex i below s, camera vertex s + t - 1 - i from s on.  The
    four positions around the connection get their pdfs re-derived
    through it, then the ratio sweeps run over the light side (from s - 1
    down) and the camera side, in the JAX package's order; in a batch the
    camera steps beyond a lane's t are masked off (``_sweep``)."""
    ts = [t] if isinstance(t, int) else list(t)
    B, T = len(ts), max(ts)
    if B == 1 and s + T == 2:   # the shortest path has one strategy only
        return torch.ones_like(cp[0]["pdf_fwd"])
    rep = lambda x: x if B == 1 else torch.cat([x] * B)

    def cam(k, key):            # camera vertex t - 1 - k of each lane
        parts = [cp[t - 1 - k][key] if t - 1 - k >= 0 else
                 torch.zeros_like(cp[0][key]) for t in ts]
        return parts[0] if B == 1 else torch.cat(parts)

    pdf_rad = [rep(lp[i]["pdf_bck"]) for i in range(s)] \
        + [cam(k, "pdf_fwd") for k in range(T)]
    pdf_imp = [rep(lp[i]["pdf_fwd"]) for i in range(s)] \
        + [cam(k, "pdf_bck") for k in range(T)]
    delta = [rep(lp[i]["delta"]) for i in range(s)] \
        + [cam(k, "delta") for k in range(T)]
    ct1 = _batch([_fields(cp[t - 1]) for t in ts])
    ls1 = {k: rep(v) for k, v in _fields(lp[s - 1]).items()} if s else None
    if s > 1:             # i = s - 2: back through the connection
        ls2 = {k: rep(v) for k, v in _fields(lp[s - 2]).items()}
        pdf_rad[s - 2] = _pdf_connection(lam, ls1, ls2, mp_ls1, vp=ct1)
    if s > 0:             # i = s - 1: the camera side reaching ls1
        pdf_rad[s - 1] = (_pdf_camera_leaving(camera, ct1, ls1) if T == 1
                          else _pdf_connection(lam, ct1, ls1, mp_ct1))
        delta[s - 1] = None
    # i = s: the light side reaching ct1
    if s == 0:
        pdf_imp[s] = _pdf_light_origin(scene, ct1)
    elif s == 1:
        pdf_imp[s] = _pdf_light_leaving(ls1, ct1)
    else:
        pdf_imp[s] = _pdf_connection(lam, ls1, ct1, mp_ls1)
    delta[s] = None
    if T > 1:             # i = s + 1: back to ct2 through the connection
        ct2 = _batch([_fields(cp[t - 2]) for t in ts])
        pdf_imp[s + 1] = (_pdf_light_leaving(ct1, ct2) if s == 0 else
                          _pdf_connection(lam, ct1, ct2, mp_ct1, vp=ls1))
    active = None
    if B > 1:
        t_lane = torch.cat([torch.full_like(cp[0]["light"], t) for t in ts])
        active = lambda k: None if k + 1 < min(ts) else t_lane > k + 1
    return _sweep(pdf_rad, pdf_imp, delta, s, T - 1, active)


def _sweep(pdf_rad, pdf_imp, delta, s, n_cam, active=None):
    """The ratio sweeps of a strategy's MIS weight (reference
    ``mis.rs:212-238``): the light side from position s - 1 down to 0,
    then ``n_cam`` steps of the camera side from position s.  A None
    delta is a connection vertex, never delta.  ``active(k)``, when given,
    masks camera step k per lane (None: every lane), for a batch of
    strategies whose camera sides differ in length: a masked step leaves
    the running ratio and the sum as they are, so each lane's weight has
    the bits of its own strategy's."""
    def not_delta(*flags):
        out = None
        for f in flags:
            if f is not None:
                out = ~f if out is None else out & ~f
        return out

    def add(total, ri, use):
        sq = ri * ri if use is None else torch.where(use, ri * ri, 0.0)
        return sq if total is None else total + sq

    total = None
    ri = None
    for i in reversed(range(s)):
        r = _map0(pdf_rad[i]) / _map0(pdf_imp[i])
        ri = r if ri is None else ri * r
        total = add(total, ri, not_delta(delta[i],
                                         delta[i - 1] if i > 0 else None))
    total = torch.ones_like(pdf_imp[0]) if total is None else total + 1.0
    ri = None
    for k in range(n_cam):
        i = s + k
        on = None if active is None else active(k)
        r = _map0(pdf_imp[i]) / _map0(pdf_rad[i])
        if ri is None:
            ri = r
        elif on is None:
            ri = ri * r
        else:
            ri = torch.where(on, ri * r, ri)
        use = not_delta(delta[i], delta[i + 1])
        if on is not None:
            use = on if use is None else on & use
        total = add(total, ri, use)
    w = 1.0 / total
    return torch.where(torch.isfinite(w) & (w > 0.0), w, 0.0)


# ---------------------------------------------------------------------------
# the general strategies, batched



def _connect(scene, lam, lp, cp, mp_l, mp_c, rng_con, s, ts):
    """The strategies (s, t), t in ``ts``, as one batch of len(ts) N lanes:
    light vertex lp[s - 1] joined to camera vertex cp[t - 1] through a
    visibility query each (one any-hit query over the batch), weighted by
    MIS.  Returns each strategy's contribution, masked, (len(ts), N, 4).
    Every lane computes what its strategy alone would, bit for bit: the
    operations are elementwise, and the MIS sweep masks the camera steps
    beyond a lane's t (``_sweep``)."""
    B, N = len(ts), lam.shape[0]
    ll = _batch([_fields(lp[s - 1])] * B)
    mp_ll = _batch([mp_l[s - 1]] * B)
    cl = _batch([_fields(cp[t - 1]) for t in ts])
    mp_cl = _batch([mp_c[t - 1] for t in ts])
    lam = torch.cat([lam] * B)
    wi_lc = normalize(cl["p"] - ll["p"], eps=_TINY)   # light -> camera
    wi = -wi_lc
    ro = geo.offset_ray_origin(ll["p"], ll["err"], ll["ng"], wi_lc)
    dist = norm(cl["p"] - ro)
    mask = (ll["valid"] & ~ll["delta"] & cl["valid"] & ~cl["delta"]
            & (cl["light"] < 0) & (dot(wi_lc, ll["ng"]) >= epsilon()))
    rng = torch.cat([_salted(rng_con, s * 64 + t + 300, 0xC2B2AE35)
                     for t in ts])
    t_max = torch.where(mask, dist * shrink(dist.dtype), 0.0).detach()
    _count_query(t_max)
    occ = trace.occluded(scene, ro, wi_lc, t_max, rng=rng, salt=_S_OCC)
    p_sct = (_vertex_pdf(cl, cl["wo"], wi, lam, mp_cl)
             * _vertex_pdf(ll, ll["wo"], -wi, lam, mp_ll))
    mask = mask & ~occ & (p_sct > 0.0)
    light_f = _vertex_f(ll, -wi, lam, IMPORTANCE, mp_ll)
    cam_f = _vertex_f(cl, wi, lam, RADIANCE, mp_cl)
    cos_l = bsdf.shading_cosine(mp_ll, -wi, ll["ns"])
    cos_c = bsdf.shading_cosine(mp_cl, wi, cl["ns"])
    r = cl["p"] - ll["p"]
    dist2 = torch.clamp(dot(r, r), min=_TINY)
    tr = trace.transmittance(scene, lam, torch.sqrt(dist2))
    contrib = (ll["gathered"] * light_f * cl["gathered"] * cam_f * tr
               * (cos_l * cos_c / dist2)[..., None])

    w = _mis_weight(scene, None, lam, lp, cp, s, ts, mp_ls1=mp_ll,
                    mp_ct1=mp_cl)
    return torch.where(mask[..., None], contrib * w[..., None],
                       0.0).view(B, N, 4)


# ---------------------------------------------------------------------------
# the integrator

def _count_query(t_max):
    """Count a connection's any-hit query: its lanes and its live lanes
    (t_max > 0); only while a profiler records (a device reduction)."""
    if telemetry.on():
        telemetry.add("bdpt.connect.lanes", t_max.shape[0])
        telemetry.add("bdpt.connect.live", int((t_max > 0.0).sum()))


def _salted(rng, k, c):
    """The counter state of strategy number k: hash(rng + k * c) in
    uint32 (carried in int64)."""
    return _hash_u32(rng + ((k * c) & MASK32))


def _strategy_s1(scene, camera, lam, cp, mp_c, rng_con, t, zero3, zeros,
                 false):
    """Strategy (1, t): a light point sampled from camera vertex t - 1 and
    joined to it through one any-hit query (reference
    ``connect_camera_path``, ``:158-213``); its contribution (N, 4)."""
    cl, mp_cl = cp[t - 1], mp_c[t - 1]
    rng_t = _salted(rng_con, t, 0x9E3779B9)
    light, pdf_light = trace.sample_light(scene, _randfloat(rng_t, _S_PICK))
    u_sq = torch.stack([_randfloat(rng_t, _S_SQ0),
                        _randfloat(rng_t, _S_SQ1)], -1)
    wi = trace.sample_towards(scene, light, cl["p"], u_sq).detach()
    ro = geo.offset_ray_origin(cl["p"], cl["err"], cl["ng"], wi)
    lh = trace.light_hit(scene, light, ro, wi)
    mask = cl["valid"] & ~cl["delta"] & (cl["light"] < 0) & lh["valid"]
    t_max = torch.where(mask, (lh["t"] - epsilon()) * shrink(ro.dtype), 0.0)
    _count_query(t_max)
    occ = trace.occluded(scene, ro, wi, t_max.detach(), rng=rng_t,
                         salt=_S_OCC)
    p_sct = _vertex_pdf(cl, cl["wo"], wi, lam, mp_cl)
    ngi = torch.where(cl["surface"][..., None], lh["ng"], wi)
    p_lig = trace.sample_towards_pdf(scene, light, ro, wi, lh["p"],
                                     lh["ng"]) * pdf_light
    mask = mask & ~occ & (p_sct > 0.0) & (p_lig > 0.0)
    emit = trace.emitted(scene, lh["mat"], lam, lh["uv"], lh["backface"])
    lvert = {"p": lh["p"], "ng": lh["ng"], "ns": lh["ng"], "wo": zero3,
             "pdf_fwd": _sa_to_area(p_lig, cl["p"], lh["p"], wi, ngi),
             "pdf_bck": zeros, "light": light, "valid": mask,
             "delta": false, "surface": ~false}
    f_val = _vertex_f(cl, wi, lam, RADIANCE, mp_cl)
    tr = trace.transmittance(scene, lam, lh["t"])
    cos_wi = bsdf.shading_cosine(mp_cl, wi, cl["ns"])
    p_safe = torch.where(mask, torch.clamp(p_lig, min=_TINY), 1.0)
    contrib = cl["gathered"] * f_val * emit * tr \
        * (cos_wi / p_safe)[..., None]
    w = _mis_weight(scene, camera, lam, [lvert], cp, 1, t, mp_ct1=mp_cl)
    return torch.where(mask[..., None], contrib * w[..., None], 0.0)


def _strategy_t1(scene, camera, lam, lp, mp_l, rng_con, s, zero3, zeros,
                 false):
    """Strategy (s, 1): light vertex s - 1 seen through the lens, one
    any-hit query (reference ``connect_light_path``, ``:78-135``); its
    splat (raster (N, 2), color (N, 4), mask (N,))."""
    ll, mp_ll = lp[s - 1], mp_l[s - 1]
    rng_s = _salted(rng_con, s + 64, 0x85EBCA6B)
    u_sq = torch.stack([_randfloat(rng_s, _S_SQ0),
                        _randfloat(rng_s, _S_SQ1)], -1)
    co, cd, cam_ok = camera.sample_towards(ll["p"], u_sq)
    dist = norm(ll["p"] - co)
    mask = ll["valid"] & ~ll["delta"] & cam_ok
    t_max = torch.where(mask, dist * shrink(dist.dtype), 0.0).detach()
    _count_query(t_max)
    occ = trace.occluded(scene, co, cd, t_max, rng=rng_s, salt=_S_OCC)
    p_sct = _vertex_pdf(ll, ll["wo"], -cd, lam, mp_ll)
    p_imp = camera.pdf_importance(co, cd, ll["p"])
    imp, raster, imp_ok = camera.sample_importance(co, cd)
    mask = (mask & ~occ & (p_sct > 0.0) & (p_imp > 0.0) & imp_ok
            & (imp > 0.0))
    p_imp_safe = torch.where(mask, torch.clamp(p_imp, min=_TINY), 1.0)
    color = (imp / p_imp_safe)[..., None] * torch.ones_like(lam)
    cvert = {"p": co, "ng": zero3, "pdf_fwd": camera.pdf_xo(co),
             "pdf_bck": zeros, "valid": mask, "delta": false,
             "surface": false}
    tr = trace.transmittance(scene, lam, dist)
    f_val = _vertex_f(ll, -cd, lam, IMPORTANCE, mp_ll)
    cos_l = bsdf.shading_cosine(mp_ll, -cd, ll["ns"])
    corr = _shading_correction(mp_ll, ll, -cd)
    w = _mis_weight(scene, camera, lam, lp, [cvert], s, 1, mp_ls1=mp_ll)
    out = color * ll["gathered"] * tr * f_val \
        * (cos_l * corr * w)[..., None]
    return raster, torch.where(mask[..., None], out, 0.0), mask


@telemetry.spanned("bdpt.integrate")
def integrate(scene, camera, o, d, lam, ray_key=None, generator=None,
              delta=1.0, max_verts=MAX_VERTS):
    """Trace a light and a camera subpath for each of N camera rays and
    connect every (s, t) strategy (reference ``bd_path_trace.rs:23-75``).

    o, d (N, 3); lam (N, 4); ``ray_key`` as in ``path_trace.integrate``;
    ``delta``: the Russian-roulette threshold of both walks, a scalar or
    (N,).  Returns (radiance (N, 4), lam_out (N, 4), splat_raster
    (S-1, N, 2), splat_color (S-1, N, 4), splat_mask (S-1, N), depth (N,))
    with S = ``max_verts``: axis 0 of the splats enumerates the t = 1
    strategies s = 2 .. S, axis 1 is the ray, so per-ray data (lam)
    broadcasts across axis 0.  The film applies the 1/spp splat scale at
    ``finalize`` (reference ``film.rs:103-143``)."""
    N, dev = o.shape[0], o.device
    S = T = int(max_verts)
    if S < 2:
        raise ValueError(f"max_verts must be at least 2, not {max_verts}")
    if ray_key is None:
        ray_key = path_trace.ray_keys(generator, N, device=dev)
    ray_key = torch.as_tensor(ray_key, dtype=torch.int64, device=dev)
    rng_con = _hash_u32(ray_key ^ _C_CONNECT)
    with telemetry.span("bdpt.walk.light"):
        lp, lam = _light_path(scene, lam, _hash_u32(ray_key ^ _C_LIGHT),
                              delta, S)
    with telemetry.span("bdpt.walk.camera"):
        cp, lam = _camera_path(scene, camera, o, d, lam,
                               _hash_u32(ray_key ^ _C_CAMERA), delta, T)
        # every connection reads its vertices' materials at the final lam
        mp_l = [None] + [_mp(scene, v, lam) for v in lp[1:]]
        mp_c = [None] + [_mp(scene, v, lam) for v in cp[1:]]
    zero3 = torch.zeros_like(o)
    false = torch.zeros(N, dtype=torch.bool, device=dev)
    zeros = torch.zeros(N, dtype=o.dtype, device=dev)
    radiance = torch.zeros_like(lam)

    # s = 0: the camera subpath hit a light (reference ``:137-156``)
    with telemetry.span("bdpt.s0"):
        for t in range(2, T + 1):
            cl = cp[t - 1]
            emit = trace.emitted(scene, cl["mat"], lam, cl["uv"],
                                 cl["backface"])
            w = _mis_weight(scene, camera, lam, None, cp, 0, t)
            radiance = radiance + torch.where(
                (cl["valid"] & (cl["light"] >= 0))[..., None],
                cl["gathered"] * emit * w[..., None], 0.0)

    # s = 1: a light sampled from each camera vertex (reference
    # ``connect_camera_path``, ``:158-213``)
    with telemetry.span("bdpt.s1"):
        for t in range(2, T + 1):
            radiance = radiance + _strategy_s1(scene, camera, lam, cp, mp_c,
                                               rng_con, t, zero3, zeros,
                                               false)

    # t = 1: each light vertex seen through the lens, a splat
    # (reference ``connect_light_path``, ``:78-135``)
    with telemetry.span("bdpt.t1"):
        splats = [_strategy_t1(scene, camera, lam, lp, mp_l, rng_con, s,
                               zero3, zeros, false)
                  for s in range(2, S + 1)]
        splat_raster, splat_color, splat_mask = (torch.stack(x) for x in
                                                 zip(*splats))
        if telemetry.on():
            telemetry.add("bdpt.splats", int(splat_mask.sum()))

    # general s, t >= 2, s outer and t inner (reference ``connect_paths``,
    # ``:219-276``), the strategies of one s as one batch
    for s in range(2, S + 1):
        with telemetry.span("bdpt.connect"):
            for c in _connect(scene, lam, lp, cp, mp_l, mp_c, rng_con, s,
                              range(2, T + 1)):
                radiance = radiance + c

    radiance = torch.where(torch.isfinite(radiance), radiance, 0.0)
    splat_color = torch.where(torch.isfinite(splat_color), splat_color, 0.0)
    depth = sum(v["valid"].to(torch.int32) for v in cp + lp)
    return radiance, lam, splat_raster, splat_color, splat_mask, depth
