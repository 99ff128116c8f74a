"""Unidirectional path tracer with NEE + MIS and Russian roulette.

Counterpart of ``lumo_tpu/integrators/path_trace.py`` (reference
``path_trace.rs``): every lane of a fixed-shape SoA path state advances
one bounce per iteration under an alive mask.  Three loops share
:func:`bounce`:

- ``integrate``: a Python loop until no lane is alive or ``max_depth``
  bounces have run (one host read of the live lanes' count per bounce);
- ``integrate(..., fixed_depth=k)``: exactly ``k`` bounces and no host
  sync, the mode that is differentiated; repeated on the card, one CUDA
  graph of the forward and one of its backward (``graph_step``).
  Autograd keeps every bounce's intermediates; with ``checkpoint=True``
  each bounce runs under a selective activation checkpoint that saves
  only the traversal queries' outputs, so the backward recomputes the
  shading glue and never walks a tree again (the JAX package's ``"geom"``
  tape).  Either way each query runs once per bounce;
- ``integrate_stream``: the persistent wavefront, whose dead lanes pick
  up fresh samples.

All randomness is a counter hash of the per-ray ``ray_key``, so a lane's
path matches the JAX package's bit for bit in its random draws, and a
sample's radiance does not depend on the lane or iteration that traced
it.
"""
from __future__ import annotations

import functools

import torch
import torch.utils.checkpoint
from torch.utils.checkpoint import (CheckpointPolicy,
                                    create_selective_checkpoint_contexts)

from lumo_tpu_torch import telemetry
from lumo_tpu_torch.bsdf import eval as bsdf
from lumo_tpu_torch.color import space, wavelength
from lumo_tpu_torch.config import RADIANCE
from lumo_tpu_torch.geometry import intersect as geo
from lumo_tpu_torch.integrators import common, graph_step
from lumo_tpu_torch.sampling.samplers import MASK32, _hash_u32, _randfloat
from lumo_tpu_torch.scene import trace

_TINY = 1e-30

RR_DEPTH = 5          # reference ``path_trace.rs:3``
MAX_DEPTH = 64        # hard wavefront bound (RR terminates long before)

_S_LOBE = 0x632BE59B
_S_SQ0 = 0x85297A4D
_S_SQ1 = 0xD6E8FEB8
_S_RR = 0xA0761D64
_S_MED = 0xE7037ED1


def ray_keys(generator: torch.Generator, n: int, device=None):
    """Per-ray counter states for callers with no per-ray ids: the hash
    of (a draw from ``generator``, lane)."""
    base = int(torch.randint(0, 1 << 32, (), generator=generator,
                             dtype=torch.int64, device=generator.device))
    return _hash_u32(torch.arange(n, dtype=torch.int64, device=device) ^ base)


@telemetry.spanned("path.bounce")
def bounce(scene, s, delta):
    """One wavefront bounce of the path state ``s`` (a dict): the
    ``path.bounce`` span, with one child span a phase."""
    with telemetry.span("path.intersect"):
        rng = _hash_u32((s["rng"] + 0x9E3779B9) & MASK32)
        hit = trace.intersect(scene, s["o"], s["d"], rng=rng, salt=_S_MED,
                              alive=s["alive"])
        alive = s["alive"] & hit["valid"]
        wo = -s["d"]
        lam = s["lam"]
        # per-segment medium transmittance (reference ``path_trace.rs:20``)
        tr_seg = trace.transmittance(scene, lam, hit["t"])
        gathered0 = s["gathered"] * torch.where(alive[..., None], tr_seg,
                                                1.0)

    with telemetry.span("path.material"):
        # dispersion terminates hero wavelengths before the one gather
        # that serves sampling, NEE and evaluation
        lam2 = wavelength.terminate(lam, bsdf.dispersive_mask(
            scene.materials, hit["mat"]))
        mp = bsdf.gather_params(scene.materials, hit["mat"], lam2, hit["uv"],
                                scene.textures, scene.tex_kinds, t=hit["t"],
                                kinds=scene.kinds_present,
                                beck=scene.beckmann)

    with telemetry.span("path.bsdf"):
        u_lobe = _randfloat(rng, _S_LOBE)
        u_sq = torch.stack([_randfloat(rng, _S_SQ0),
                            _randfloat(rng, _S_SQ1)], dim=-1)
        wi, sample_ok, _ = bsdf.sample(mp, wo, hit["ns"], hit["backface"],
                                       lam2, u_lobe, u_sq)

    with telemetry.span("path.emit"):
        # emitter hit: the path ends here; after a NEE vertex the emission
        # is the BSDF-sampled MIS strategy (reference
        # ``path_trace.rs:22-28``)
        emit = trace.emitted(scene, hit["mat"], lam, hit["uv"],
                             hit["backface"])
        w_mis = common.emitter_mis_weight(scene, s["o"], s["d"], hit,
                                          s["p_sct"], s["did_nee"])
        add_emit = alive & ~sample_ok
        radiance = s["radiance"] + torch.where(add_emit[..., None],
                                               gathered0 * emit
                                               * w_mis[..., None], 0.0)
        alive = alive & sample_ok

    with telemetry.span("path.nee"):
        # NEE at non-delta vertices (reference ``path_trace.rs:30-40``)
        nee = common.nee_rays(scene, mp, wo, gathered0, hit, lam2, rng)
        do_nee = alive & ~mp["is_delta"]
        radiance = radiance + torch.where(do_nee[..., None], nee, 0.0)

    # continue the path (the two BSDF calls keep their place in the
    # bounce's order, and so the gradients' order of accumulation)
    with telemetry.span("path.bsdf"):
        ro = geo.offset_ray_origin(hit["p"], hit["err"], hit["ng"], wi)
        f_val, p_sct = bsdf.f_pdf(mp, wo, wi, hit["ng"], hit["ns"],
                                  hit["backface"], lam2, RADIANCE)
        cosine = bsdf.shading_cosine(mp, wi, hit["ns"])

    with telemetry.span("path.roulette"):
        alive = alive & (p_sct > 1e-12) & torch.isfinite(p_sct)
        p_safe = torch.where(alive, p_sct, 1.0)
        # a medium is sampled by its phase function exactly, so the pdf
        # cancels (reference ``path_trace.rs:52-58``)
        f_val = torch.where(hit["is_medium"][..., None],
                            f_val * p_safe[..., None], f_val)
        f_val = torch.where(alive[..., None], f_val, 0.0)
        gathered = gathered0 * f_val * (cosine / p_safe)[..., None]

        # russian roulette after RR_DEPTH (reference
        # ``path_trace.rs:65-72``)
        lum = space.luminance(gathered, lam2)
        rr_prob = torch.clamp(lum / delta, max=1.0)
        u_rr = _randfloat(rng, _S_RR)
        do_rr = s["depth"] >= RR_DEPTH
        alive = alive & ~(do_rr & (u_rr > rr_prob))
        rr_div = torch.where(do_rr & alive, torch.clamp(rr_prob, min=_TINY),
                             1.0)
        gathered = gathered / rr_div.detach()[..., None]

        a3 = alive[..., None]
        out = {
            "o": torch.where(a3, ro, s["o"]),
            "d": torch.where(a3, wi, s["d"]),
            "lam": torch.where(a3, lam2, lam),
            "radiance": radiance,
            "gathered": torch.where(a3, gathered, s["gathered"]),
            "alive": alive,
            "did_nee": torch.where(alive, do_nee, s["did_nee"]),
            "p_sct": torch.where(alive, p_sct, s["p_sct"]),
            "depth": s["depth"] + alive.to(s["depth"].dtype),
            "rng": rng,
            # the prim each live lane hit this bounce, -1 for dead or
            # missed lanes: the discrete path topology
            "prim": torch.where(s["alive"] & hit["valid"], hit["prim"], -1),
        }
        for k in s:                     # per-sample metadata rides along
            out.setdefault(k, s[k])
    return out


def _any_alive(alive) -> bool:
    """The per-bounce liveness test, the loop's one host sync (the
    ``sync.alive`` span): the live lanes' count.  While a profiler records
    it counts the lanes entering the next bounce (``lanes.total``) and the
    live ones (``lanes.alive``)."""
    with telemetry.span("sync.alive"):
        n = int(alive.sum())
    if n and telemetry.on():
        telemetry.add("lanes.total", alive.shape[0])
        telemetry.add("lanes.alive", n)
    return n > 0


def _save_queries(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy: keep the traversal queries' outputs,
    recompute everything else."""
    if op in trace.QUERY_OPS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


_CHECKPOINT_CONTEXTS = functools.partial(create_selective_checkpoint_contexts,
                                         _save_queries)


def _checkpointed_bounce(scene, s, delta):
    # every draw is a counter hash of the state, so the recompute needs no
    # saved generator state
    return torch.utils.checkpoint.checkpoint(
        bounce, scene, s, delta, use_reentrant=False,
        context_fn=_CHECKPOINT_CONTEXTS, preserve_rng_state=False)


def initial_state(o, d, lam, ray_key):
    """The path state of N camera rays before their first bounce."""
    N, dev = o.shape[0], o.device
    return {
        "o": o, "d": d, "lam": lam,
        "radiance": torch.zeros((N, 4), dtype=o.dtype, device=dev),
        "gathered": torch.ones((N, 4), dtype=o.dtype, device=dev),
        "alive": torch.ones(N, dtype=torch.bool, device=dev),
        "did_nee": torch.zeros(N, dtype=torch.bool, device=dev),
        "p_sct": torch.ones(N, dtype=o.dtype, device=dev),
        "depth": torch.zeros(N, dtype=torch.int32, device=dev),
        "rng": torch.as_tensor(ray_key, dtype=torch.int64, device=dev),
    }


def _result(s, prims, trace_prims):
    """integrate's outputs from the final path state and the per-bounce
    prim ids."""
    if trace_prims:
        N = s["o"].shape[0]
        stacked = (torch.stack(prims) if prims else
                   torch.empty((0, N), dtype=torch.int64,
                               device=s["o"].device))
        return s["radiance"], s["lam"], s["depth"], stacked
    return s["radiance"], s["lam"], s["depth"]


def _fixed_depth(scene, o, d, lam, ray_key, delta, depth, trace_prims,
                 checkpoint):
    """Exactly ``depth`` bounces with no host sync: the step that
    ``graph_step`` runs eagerly or as a CUDA graph."""
    s = initial_state(o, d, lam, ray_key)
    step = (_checkpointed_bounce if checkpoint and torch.is_grad_enabled()
            else bounce)
    prims = []
    for _ in range(depth):
        s = step(scene, s, delta)
        prims.append(s["prim"])
    return _result(s, prims, trace_prims)


@telemetry.spanned("path.integrate")
def integrate(scene, o, d, lam, ray_key=None, generator=None, delta=1.0,
              max_depth=MAX_DEPTH, trace_prims=False, fixed_depth=None,
              checkpoint=False):
    """Trace a wavefront of N camera rays.

    o, d (N, 3); lam (N, 4) hero wavelengths; delta: the RR threshold, a
    scalar or (N,).  ``ray_key``: (N,) per-ray uint32 counter states
    (int64 tensor); drawn from ``generator`` with :func:`ray_keys` when
    not given.  Without ``fixed_depth`` the loop runs until no lane is
    alive or ``max_depth`` bounces have run.  ``fixed_depth=k`` runs
    exactly k bounces with no host sync, the mode to differentiate.  With
    ``checkpoint`` (and grad enabled) each bounce is checkpointed, saving
    only the traversal queries' outputs: a third to two thirds of the
    memory, at about three times the fwd+bwd time on a host-bound card
    (the JAX package checkpoints by default; ``PERF.md`` gives the H100's
    numbers).

    A fixed-depth call on the card that repeats the previous one's
    ``graph_step.key`` (the same scene object and tensors, lanes, dtypes,
    depth, delta, ``trace_prims`` and grad mode; only the rays' values
    differ) runs as a CUDA graph: the second such call captures the
    forward and, under grad mode, autograd's backward of it, and every
    later one replays them, with fresh outputs and gradients equal to the
    eager step's.  On the CPU, with ``checkpoint``, in forward mode and at
    a key's first call the step runs eagerly (``graph_step``).

    Returns (radiance (N, 4), lam_out (N, 4), depth (N,)), and with
    ``trace_prims`` also the per-bounce hit prim ids (bounces, N)."""
    N = o.shape[0]
    dev = o.device
    if ray_key is None:
        ray_key = ray_keys(generator, N, device=dev)
    if fixed_depth is not None:
        return graph_step.run(_fixed_depth, scene, o, d, lam, ray_key, delta,
                              fixed_depth, trace_prims, checkpoint)
    s = initial_state(o, d, lam, ray_key)
    prims = []
    for _ in range(max_depth):
        if not _any_alive(s["alive"]):
            break
        s = bounce(scene, s, delta)
        prims.append(s["prim"])
    return _result(s, prims, trace_prims)


# ---------------------------------------------------------------------------
# persistent wavefront with path regeneration

def _fresh(state, f, mask):
    """``state`` with the lanes of ``mask`` restarted from the generated
    samples ``f`` (o, d, lam, rng and any metadata)."""
    m1, m3 = mask, mask[..., None]
    out = dict(state)
    out["o"] = torch.where(m3, f["o"], state["o"])
    out["d"] = torch.where(m3, f["d"], state["d"])
    out["lam"] = torch.where(m3, f["lam"], state["lam"])
    out["rng"] = torch.where(m1, f["rng"], state["rng"])
    out["radiance"] = torch.where(m3, 0.0, state["radiance"])
    out["gathered"] = torch.where(m3, 1.0, state["gathered"])
    out["did_nee"] = torch.where(m1, False, state["did_nee"])
    out["p_sct"] = torch.where(m1, 1.0, state["p_sct"])
    out["depth"] = torch.where(m1, 0, state["depth"])
    out["alive"] = state["alive"] | m1
    for k, v in f.items():
        if k in ("o", "d", "lam", "rng"):
            continue
        if k not in state:
            out[k] = v
        else:
            m = mask.view(mask.shape + (1,) * (v.ndim - 1))
            out[k] = torch.where(m, v, state[k])
    return out


def integrate_stream(scene, gen, fold, acc0, n_lanes, n_samples, delta=1.0,
                     max_bounces=MAX_DEPTH, delta_fn=None):
    """Path tracing at full lane occupancy: a lane whose path ends picks up
    the next unissued sample at once, instead of idling through the
    Russian-roulette tail of its wavefront (``lumo_tpu/integrators/
    path_trace.py::integrate_stream``).

    Every draw of the bounce is a counter hash of the sample's ``ray_key``,
    so a sample's radiance equals its batch-mode value whichever lane or
    iteration traces it.

    gen(idx (L,) int64) -> state dict with o (L, 3), d (L, 3), lam (L, 4),
        rng (L,) [the sample's ray_key] and any per-sample metadata (for
        example "pix"), which rides along untouched and is visible to
        ``fold``.
    fold(acc, term (L,) bool, state) -> acc: called once per wavefront
        iteration with the lanes that have just terminated; reads
        state["radiance"], ["lam"], ["depth"] and the metadata.
    delta_fn(acc, state) -> (L,) per-lane RR threshold, evaluated every
        iteration from the running accumulator (the renderer's adaptive
        delta = sqrt(var/cost)); overrides ``delta`` when given.
    Samples are issued in index order, the dead lanes of an iteration
    taking the next ones by a cumulative sum; one liveness test per
    iteration (the live lanes' count) ends the loop.  Returns the final acc."""
    L = n_lanes
    dev = scene.device
    idx0 = torch.arange(L, dtype=torch.int64, device=dev)
    zeros = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=dev)
    state = {
        "o": zeros(L, 3), "d": zeros(L, 3), "lam": zeros(L, 4),
        "radiance": zeros(L, 4), "gathered": torch.ones((L, 4), device=dev),
        "alive": torch.zeros(L, dtype=torch.bool, device=dev),
        "did_nee": torch.zeros(L, dtype=torch.bool, device=dev),
        "p_sct": torch.ones(L, device=dev),
        "depth": torch.zeros(L, dtype=torch.int32, device=dev),
        "rng": torch.zeros(L, dtype=torch.int64, device=dev),
    }
    state = _fresh(state, gen(torch.clamp(idx0, max=n_samples - 1)),
                   idx0 < n_samples)
    issued = torch.full((), min(L, n_samples), dtype=torch.int64, device=dev)
    acc = acc0
    while _any_alive(state["alive"]):
        d = delta if delta_fn is None else delta_fn(acc, state)
        s2 = bounce(scene, state, d)
        s2["alive"] = s2["alive"] & (s2["depth"] < max_bounces)
        term = state["alive"] & ~s2["alive"]
        acc = fold(acc, term, s2)
        dead = ~s2["alive"]
        new_idx = issued + torch.cumsum(dead, 0) - 1
        can = dead & (new_idx < n_samples)
        state = _fresh(s2, gen(torch.clamp(new_idx, max=n_samples - 1)), can)
        issued = torch.clamp(issued + dead.sum(), max=n_samples)
    return acc
