"""Renderer front end: builds the render step and accumulates the film.

Counterpart of ``lumo_tpu/renderer.py`` (reference builder-pattern
``Renderer``, ``src/renderer.rs``): configuration (samples / integrator /
seed / sampler / tone map / filter) plus ``render()``.  One wavefront step
covers the whole image times a sample sub-batch; ``render`` iterates it and
scatter-adds into a film that stays on the scene's device.  The path
integrator in batch mode is ported; stream mode, the direct-light and
bidirectional integrators and rendering over several devices raise with
the number of their item in ``ROADMAP.md``.

Every random draw of ``work`` is a counter hash of (pixel, sample index,
seed), so a render is a pure function of its configuration and needs no
generator.
"""
from __future__ import annotations

import time

import torch

from lumo_tpu_torch import film as film_mod
from lumo_tpu_torch.camera import Camera
from lumo_tpu_torch.color import space as space_mod
from lumo_tpu_torch.color import wavelength
from lumo_tpu_torch.integrators import path_trace
from lumo_tpu_torch.sampling import samplers
from lumo_tpu_torch.sampling.samplers import MASK32, _hash_u32, _mul32, _randfloat
from lumo_tpu_torch.scene.scene import SceneData, _not_ported

PATH_TRACE = "path"
DIRECT_LIGHT = "direct"
BD_PATH_TRACE = "bdpt"


class Renderer:
    """``Renderer(scene, camera).samples(512).render()``; runs on the
    scene's device."""

    def __init__(self, scene: SceneData, camera: Camera):
        if camera.c2w_t.device != scene.device:
            raise ValueError(f"camera is on {camera.c2w_t.device}, scene on "
                             f"{scene.device}")
        self.scene = scene
        self.camera = camera
        self._samples = 1
        self._integrator = PATH_TRACE
        self._seed = 0
        self._sampler = samplers.MULTI_JITTERED
        self._tone_map = film_mod.NOMAP
        self._tone_arg = 1.0
        self._filter = film_mod.PixelFilter.gaussian()
        self._colorspace = "DCI-P3"
        self._illuminant = "D65"
        self._batch = None  # samples per step (auto)
        self._delta = None  # None: adaptive RR (task.rs:42-53); float: fixed
        self._debug = False  # paint NaN/neg/huge radiance (tone_mapping.rs:42-56)

    # fluent config (mirrors reference ``renderer.rs:66-99``)
    def samples(self, n):
        self._samples = int(n)
        return self

    def integrator(self, name):
        if name in (DIRECT_LIGHT, BD_PATH_TRACE):
            raise _not_ported(f"the {name!r} integrator", 8)
        if name != PATH_TRACE:
            raise ValueError(f"unknown integrator {name}")
        self._integrator = name
        return self

    def seed(self, s):
        self._seed = int(s)
        return self

    def sampler(self, s):
        self._sampler = s
        return self

    def tone_map(self, kind, arg=1.0):
        self._tone_map = film_mod.tone_map_kind(kind)
        self._tone_arg = arg
        return self

    def debug_sanitize(self, on=True):
        """Paint NaN (green) / negative (red) / huge (blue) radiance in the
        output instead of scrubbing it: surfaces estimator bugs
        (reference debug builds, ``tone_mapping.rs:42-56``)."""
        self._debug = bool(on)
        return self

    def pixel_filter(self, f):
        self._filter = f
        return self

    def colorspace(self, cs):
        self._colorspace = cs
        return self

    def illuminant(self, name):
        self._illuminant = name
        return self

    def batch_samples(self, n):
        self._batch = int(n)
        return self

    def fixed_rr_delta(self, delta):
        """Force a fixed Russian-roulette threshold instead of the default
        per-pixel adaptive ``delta = sqrt(var/cost)`` from the running
        sample statistics (reference ``renderer/task.rs:42-53``)."""
        self._delta = float(delta)
        return self

    def bdpt_depth(self, n):
        raise _not_ported("the 'bdpt' integrator", 8)

    def stream(self, on=True):
        """Persistent-wavefront mode of the JAX package."""
        if on:
            raise _not_ported("stream mode", 4)
        return self

    def devices(self, n):
        """Rendering over ``n`` devices; one device is what is ported."""
        if int(n) > 1:
            raise _not_ported("rendering over several devices", 11)
        return self

    # ------------------------------------------------------------------
    def _auto_batch(self):
        if self._batch is not None:
            return max(1, min(self._batch, self._samples))
        w, h = self.camera.resolution
        # target ~2M rays per step
        per = max(1, int(2_000_000 / max(w * h, 1)))
        return max(1, min(per, self._samples))

    def _make_work(self, spp_batch, total_spp):
        """Build work(ray_ids, sample_base, stats) -> (film_partial,
        stats_partial, rays): the per-ray render function.  ray_ids index
        the (spp_batch x n_pix) wavefront; all randomness is a counter
        hash of (pixel, sample index, seed), so any partition of ray_ids
        produces the same image."""
        scene = self.scene
        camera = self.camera
        filt = self._filter
        sampler_kind = self._sampler
        tone_kind = self._tone_map
        tone_arg = self._tone_arg
        seed = self._seed
        w, h = camera.resolution
        n_pix = w * h
        dev = scene.device
        wbm = film_mod.wb_matrix(self._colorspace, self._illuminant)
        fixed_delta = self._delta
        debug = self._debug
        lam_seed = (seed * 7919 + 13) & MASK32
        key_seed = (seed * 0x85EBCA6B + 0x9E3779B9) & MASK32

        def work(ray_ids, sample_base, stats):
            N = ray_ids.shape[0]
            pix = ray_ids % n_pix
            sidx = (ray_ids // n_pix + int(sample_base)) & MASK32
            px = (pix % w).to(torch.float32)
            py = (pix // w).to(torch.float32)
            offs = samplers.pixel_offsets(sampler_kind, sidx, total_spp,
                                          pix, seed)
            raster = torch.stack([px + offs[..., 0], py + offs[..., 1]],
                                 dim=-1)
            u_lam = _randfloat(pix, lam_seed ^ _mul32(sidx, 0x9E3779B9))
            lam = wavelength.sample(u_lam)
            ray_key = _hash_u32(pix ^ _hash_u32(sidx ^ key_seed))
            u_dof = torch.stack([_randfloat(ray_key, 0x7FB5D329),
                                 _randfloat(ray_key, 0x8AD8CE61)], dim=-1)
            o, d = camera.generate_ray(raster, u_dof)

            # Russian-roulette threshold: per-pixel adaptive
            # delta = sqrt(var/cost) over all samples accumulated so far
            # (reference ``renderer/task.rs:42-53``; 1e-5 floor while the
            # variance estimate is empty or degenerate), or the fixed value.
            if fixed_delta is not None:
                delta = fixed_delta
            else:
                cnt = torch.clamp(stats["n"], min=1.0)
                var = stats["f2"] - stats["f"] ** 2 / cnt
                ok = (var > 0.0) & (stats["cost"] > 0.0) & (stats["n"] > 1.0)
                delta_pix = torch.where(
                    ok, torch.sqrt(torch.where(ok, var, 1.0)
                                   / torch.clamp(stats["cost"], min=1.0)),
                    1e-5)
                delta = delta_pix[pix]

            radiance, lam_out, depth = path_trace.integrate(
                scene, o, d, lam, ray_key=ray_key, delta=delta)
            color = film_mod.tone_map(tone_kind, radiance, lam_out, tone_arg,
                                      debug=debug)
            rgb = film_mod.spectral_to_rgb(color, lam_out, wbm)
            film_p = film_mod.add_samples(
                film_mod.new_film((w, h), device=dev), filt, raster, rgb,
                (w, h))
            # per-pixel running stats for the next batch's adaptive delta
            # (luminance of the raw radiance + ray cost, ``task.rs:64-68``)
            f_lum = space_mod.luminance(radiance, lam_out)
            cost = depth.to(torch.float32) * 2.0 + 1.0
            zeros = lambda: torch.zeros(n_pix, dtype=torch.float32,
                                        device=dev)
            stats_p = {
                "f": zeros().index_add_(0, pix, f_lum),
                "f2": zeros().index_add_(0, pix, f_lum * f_lum),
                "cost": zeros().index_add_(0, pix, cost),
                "n": zeros().index_add_(0, pix, torch.ones_like(cost)),
            }
            rays = depth.sum() + N
            return film_p, stats_p, rays

        return work

    def new_stats(self, n_pix):
        return {k: torch.zeros(n_pix, dtype=torch.float32,
                               device=self.scene.device)
                for k in ("f", "f2", "cost", "n")}

    def _step(self, work, n_rays, film, stats, sample_base):
        """One film accumulation step over the whole wavefront."""
        ray_ids = torch.arange(n_rays, dtype=torch.int64,
                               device=self.scene.device)
        film_p, stats_p, rays = work(ray_ids, sample_base, stats)
        return (tuple(a + b for a, b in zip(film, film_p)),
                {k: stats[k] + stats_p[k] for k in stats}, rays)

    def render(self, verbose=True):
        """Render and return the linear-RGB image (H, W, 3) numpy array."""
        w, h = self.camera.resolution
        spp_batch = self._auto_batch()
        work = self._make_work(spp_batch, self._samples)
        n_rays = w * h * spp_batch
        film = film_mod.new_film((w, h), device=self.scene.device)
        stats = self.new_stats(w * h)
        total_rays = 0
        t0 = time.time()
        n_batches = (self._samples + spp_batch - 1) // spp_batch
        for b in range(n_batches):
            film, stats, rays = self._step(work, n_rays, film, stats,
                                           b * spp_batch)
            total_rays += int(rays)
            if verbose and (b == 0 or (b + 1) % 8 == 0 or b == n_batches - 1):
                el = time.time() - t0
                # ETA from completed batches (reference's progress bar,
                # ``renderer.rs:140-156``)
                eta = el / (b + 1) * (n_batches - b - 1)
                print(f"  batch {b + 1}/{n_batches}  "
                      f"{total_rays / max(el, 1e-9) / 1e6:.2f} Mray/s  "
                      f"ETA {eta:.0f}s", flush=True)
        img = film_mod.finalize(film, self._filter, 1.0 / self._samples)
        out = img.cpu().numpy()
        if verbose:
            el = time.time() - t0
            print(f"Rendered {w}x{h}@{self._samples}spp on "
                  f"{self.scene.device}: {total_rays / 1e6:.1f} Mrays in "
                  f"{el:.1f}s = {total_rays / max(el, 1e-9) / 1e6:.2f} Mray/s",
                  flush=True)
        return out

    def save_png(self, img, path):
        film_mod.save_png(img, path, self._colorspace)
