"""Renderer front end: builds the render step and accumulates the film.

Counterpart of ``lumo_tpu/renderer.py`` (reference builder-pattern
``Renderer``, ``src/renderer.rs``): configuration (samples / integrator /
seed / sampler / tone map / filter) plus ``render()``.  One wavefront step
covers the whole image times a sample sub-batch; ``render`` iterates it and
scatter-adds into a film that stays on the scene's device.  ``.stream()``
renders through the persistent wavefront instead
(``path_trace.integrate_stream``), folding each terminated lane into the
film and the per-pixel stats (path integrator only).  The path,
direct-light and bidirectional integrators are ported, on one device;
rendering over several devices raises with the number of its item in
``ROADMAP.md``.  The bidirectional integrator's light-traced samples (its
t = 1 strategies) land at raster coordinates of their own, in the film's
splat buffer.

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
from lumo_tpu_torch.integrators import bdpt, direct_light, path_trace
from lumo_tpu_torch.sampling import samplers
from lumo_tpu_torch.sampling.samplers import MASK32, _hash_u32, _mul32, _randfloat
from lumo_tpu_torch.scene.materials import MF_DIELECTRIC
from lumo_tpu_torch.scene.scene import SceneData, _not_ported

PATH_TRACE = "path"
DIRECT_LIGHT = "direct"
BD_PATH_TRACE = "bdpt"
# lanes x subpath depth of one automatic BDPT step: at its peak a depth-d
# step holds about 2.3 KB a lane for each vertex (the general strategies
# of one s run d - 1 lanes wide; ``tools/bdpt_memory.py``), so this keeps
# a step near 14.5 GB, where 2M lanes at depth 12 would take 55 GB
BDPT_LANE_VERTICES = 6 * 2 ** 20


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
        self._stream = False  # persistent wavefront instead of batches
        self._debug = False  # paint NaN/neg/huge radiance (tone_mapping.rs:42-56)
        self._bdpt_depth = None  # max vertices per BDPT subpath (auto)

    # fluent config (mirrors reference ``renderer.rs:66-99``)
    def samples(self, n):
        self._samples = int(n)
        return self

    def integrator(self, name):
        if name not in (PATH_TRACE, DIRECT_LIGHT, BD_PATH_TRACE):
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
        """Maximum vertices per BDPT subpath; by default 12 where the
        scene has a specular dielectric (caustics through glass need long
        specular chains), else ``bdpt.MAX_VERTS``."""
        self._bdpt_depth = int(n)
        return self

    def _resolved_bdpt_depth(self):
        if self._bdpt_depth is not None:
            return self._bdpt_depth
        m = self.scene.materials
        glass = (m["kind"] == MF_DIELECTRIC) & m["is_specular"]
        return 12 if bool(glass.any()) else bdpt.MAX_VERTS

    def stream(self, on=True):
        """Persistent-wavefront mode: terminated lanes pick up fresh
        samples at once instead of idling through the Russian-roulette
        tail of their batch.  Same estimator and counter-based randomness
        as batch mode, so each sample's radiance is the same; the per-pixel
        adaptive delta updates every wavefront iteration from the running
        stats."""
        self._stream = bool(on)
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
        # target ~2M rays per step; a BDPT lane holds buffers for every
        # vertex of its subpaths, so its steps hold lanes x depth under
        # BDPT_LANE_VERTICES instead
        target = 2_000_000
        if self._integrator == BD_PATH_TRACE:
            target = min(target,
                         BDPT_LANE_VERTICES // self._resolved_bdpt_depth())
        per = max(1, int(target / max(w * h, 1)))
        return max(1, min(per, self._samples))

    def _sample_gen(self, total_spp):
        """gen(idx) -> the camera samples of sample ids ``idx`` (int64,
        pixel ``idx % n_pix``, sample index ``idx // n_pix``): o, d, lam,
        rng (the per-ray key), raster and pix.  All randomness is a counter
        hash of (pixel, sample index, seed)."""
        camera = self.camera
        sampler_kind = self._sampler
        seed = self._seed
        w, h = camera.resolution
        n_pix = w * h
        lam_seed = (seed * 7919 + 13) & MASK32
        key_seed = (seed * 0x85EBCA6B + 0x9E3779B9) & MASK32

        def gen(idx):
            pix = idx % n_pix
            sidx = (idx // n_pix) & MASK32
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
            return {"o": o, "d": d, "lam": lam, "rng": ray_key,
                    "raster": raster, "pix": pix}

        return gen

    def _delta_of(self, stats, pix):
        """Russian-roulette threshold per ray of pixels ``pix``: the fixed
        value, or the per-pixel adaptive delta = sqrt(var/cost) over all
        samples accumulated so far (reference ``renderer/task.rs:42-53``;
        1e-5 floor while the variance estimate is empty or degenerate)."""
        if self._delta is not None:
            return self._delta
        cnt = torch.clamp(stats["n"], min=1.0)
        var = stats["f2"] - stats["f"] ** 2 / cnt
        ok = (var > 0.0) & (stats["cost"] > 0.0) & (stats["n"] > 1.0)
        delta_pix = torch.where(
            ok, torch.sqrt(torch.where(ok, var, 1.0)
                           / torch.clamp(stats["cost"], min=1.0)), 1e-5)
        return delta_pix[pix]

    def _make_fold(self):
        """fold(film, stats, samples, radiance, lam_out, depth, mask=None)
        -> (stats, rays): tone-map finished samples and scatter them into
        ``film`` (in place), add their luminance and ray cost to the
        per-pixel ``stats`` (``task.rs:64-68``) and count the rays they
        traced; only the lanes of ``mask`` when given."""
        w, h = self.camera.resolution
        wbm = film_mod.wb_matrix(self._colorspace, self._illuminant)
        filt, tone_kind, tone_arg = self._filter, self._tone_map, self._tone_arg
        debug = self._debug

        def fold(film, stats, samples, radiance, lam_out, depth, mask=None):
            color = film_mod.tone_map(tone_kind, radiance, lam_out, tone_arg,
                                      debug=debug)
            rgb = film_mod.spectral_to_rgb(color, lam_out, wbm)
            film_mod.add_samples(film, filt, samples["raster"], rgb, (w, h),
                                 mask=mask)
            f_lum = space_mod.luminance(radiance, lam_out)
            cost = depth.to(torch.float32) * 2.0 + 1.0
            one = torch.ones_like(cost)
            n = depth.shape[0]
            if mask is not None:
                f_lum, cost, one = (torch.where(mask, x, 0.0)
                                    for x in (f_lum, cost, one))
                depth = torch.where(mask, depth, 0)
                n = mask.sum()
            pix = samples["pix"]
            stats = {
                "f": stats["f"].index_add(0, pix, f_lum),
                "f2": stats["f2"].index_add(0, pix, f_lum * f_lum),
                "cost": stats["cost"].index_add(0, pix, cost),
                "n": stats["n"].index_add(0, pix, one),
            }
            return stats, depth.sum() + n

        return fold

    def _make_splat(self):
        """splat(film, raster (R, N, 2), color (R, N, 4), mask (R, N),
        lam (N, 4)): tone-map the BDPT's light-traced samples and scatter
        them into ``film``'s splat buffer, in place; ``lam`` broadcasts
        across axis 0 (the layout of ``bdpt.integrate``'s splats)."""
        w, h = self.camera.resolution
        wbm = film_mod.wb_matrix(self._colorspace, self._illuminant)
        filt, tone_kind, tone_arg = self._filter, self._tone_map, self._tone_arg
        debug = self._debug

        def splat(film, raster, color, mask, lam):
            lam_s = lam.expand((raster.shape[0],) + lam.shape).reshape(-1, 4)
            color = film_mod.tone_map(tone_kind, color.reshape(-1, 4), lam_s,
                                      tone_arg, debug=debug)
            rgb = film_mod.spectral_to_rgb(color, lam_s, wbm)
            film_mod.add_samples(film, filt, raster.reshape(-1, 2), rgb,
                                 (w, h), splat=True, mask=mask.reshape(-1))

        return splat

    def _make_work(self, spp_batch, total_spp):
        """Build work(ray_ids, sample_base, stats) -> (film_partial,
        stats_partial, rays): the per-ray render function of the chosen
        integrator.  ray_ids index the (spp_batch x n_pix) wavefront; all
        randomness is a counter hash of (pixel, sample index, seed), so
        any partition of ray_ids produces the same image."""
        scene, camera = self.scene, self.camera
        w, h = camera.resolution
        n_pix = w * h
        gen = self._sample_gen(total_spp)
        fold = self._make_fold()
        kind = self._integrator
        if kind == BD_PATH_TRACE:
            depth_b = self._resolved_bdpt_depth()
            splat = self._make_splat()

        def work(ray_ids, sample_base, stats):
            smp = gen(ray_ids + int(sample_base) * n_pix)
            o, d, lam, key = smp["o"], smp["d"], smp["lam"], smp["rng"]
            film_p = film_mod.new_film((w, h), device=scene.device)
            if kind == DIRECT_LIGHT:
                radiance, lam_out, depth = direct_light.integrate(
                    scene, o, d, lam, ray_key=key)
            elif kind == BD_PATH_TRACE:
                radiance, lam_out, sr, sc, sm, depth = bdpt.integrate(
                    scene, camera, o, d, lam, ray_key=key,
                    delta=self._delta_of(stats, smp["pix"]),
                    max_verts=depth_b)
            else:
                radiance, lam_out, depth = path_trace.integrate(
                    scene, o, d, lam, ray_key=key,
                    delta=self._delta_of(stats, smp["pix"]))
            stats_p, rays = fold(film_p, self.new_stats(n_pix), smp,
                                 radiance, lam_out, depth)
            if kind == BD_PATH_TRACE:
                # light-traced samples land at their own raster coordinates
                # (reference ``film/tile.rs:96-111``)
                splat(film_p, sr, sc, sm, lam_out)
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

    def _render_stream(self, verbose=True):
        """Persistent-wavefront render (see :meth:`stream`): every (pixel,
        sample) is traced once by ``path_trace.integrate_stream``, dead
        lanes taking the next samples at once; each iteration folds the
        lanes that have just terminated into the film and the stats, and
        the adaptive delta of the live lanes follows the running stats."""
        w, h = self.camera.resolution
        n_pix = w * h
        n_samples = n_pix * self._samples
        # 4 lanes per pixel, capped at one wavefront of 262,144
        lanes = min(n_samples, max(4 * n_pix, 8192), 262144)
        fold_samples = self._make_fold()

        def fold(acc, term, st):
            film, stats, rays = acc
            stats, r = fold_samples(film, stats, st, st["radiance"], st["lam"],
                                    st["depth"], mask=term)
            return film, stats, rays + r

        t0 = time.time()
        film = film_mod.new_film((w, h), device=self.scene.device)
        film, _, rays = path_trace.integrate_stream(
            self.scene, self._sample_gen(self._samples), fold,
            (film, self.new_stats(n_pix), 0), lanes, n_samples,
            delta_fn=lambda acc, st: self._delta_of(acc[1], st["pix"]))
        img = film_mod.finalize(film, self._filter, 1.0 / self._samples)
        out = img.cpu().numpy()
        if verbose:
            el = time.time() - t0
            total_rays = int(rays)
            print(f"Rendered {w}x{h}@{self._samples}spp (stream) on "
                  f"{self.scene.device}: {total_rays / 1e6:.1f} Mrays in "
                  f"{el:.1f}s = {total_rays / max(el, 1e-9) / 1e6:.2f} Mray/s",
                  flush=True)
        return out

    def render(self, verbose=True):
        """Render and return the linear-RGB image (H, W, 3) numpy array."""
        if self._stream:
            if self._integrator != PATH_TRACE:
                raise ValueError("stream mode supports the path integrator")
            return self._render_stream(verbose)
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
