"""The one general generator of the benchmark's traffic.  A traffic mix is
a JSON file of parameters (``traffic/<name>.json``); its ``kind`` picks
the unit of work, and everything else is read from the file:

- ``render``: a unit is one render, ``Renderer(scene,
  camera).samples(spp).seed(s_k)``, then the configuration's ``render``
  settings (its integrator, ``bdpt_depth``), then ``.render()``, its
  image copied back; ``spp`` is the mix's own where it gives one, else
  the configuration's ``render_spp``, and the warm-up renders
  ``warmup_spp`` (the same steps, fewer of them).  ``check_passes``
  renders and ``check_pixels`` pixels of each, drawn from the seed, are
  worked out again by the reference's ``render_pixels``, given the same
  settings.
- ``grad``: a unit is one material-gradient step: ``spp`` samples at
  every pixel in one wavefront, ``path_trace.integrate(...,
  fixed_depth)``, the configuration's loss, ``torch.autograd.grad`` over
  the float material tables, loss and gradients read back.  The tables
  are held fixed, so every step can be checked on its own;
  ``check_steps`` steps drawn from the seed are.

Unit ``k`` of a run draws its samples from ``(seed, k)``, so every seed
sees the same sizes and only other samples.  The reference is the
configuration's (``cells.reference``): every unit takes its ``Scene``,
``Camera``, ``render_pixels``, ``grad_step`` and losses from that module,
and ``workload`` refuses a cell that names what it does not hold
(``cells.admit``) before anything is built."""
from __future__ import annotations

import gc

import numpy as np
import torch

from . import cells, check, inputs, program
from .trace import sync


def _rng(seed: int, salt: int):
    return np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32, salt])


class Workload:
    """A configuration under a traffic mix on one device."""

    kind = None

    def __init__(self, config: dict, traffic: dict, groups, ref, seed: int,
                 device, spans):
        self.config, self.traffic, self.ref = config, traffic, ref
        self.groups, self.seed, self.device = groups, seed, device
        self.spans = spans
        res = config["resolution"]
        self.resolution = (res, res) if isinstance(res, int) else tuple(res)
        self.limits = traffic["limits"]
        self.records = []
        self.scene = None
        self.k2_closest = []        # K2 closest launches of each unit

    def build(self):
        with self.spans.span("scene_build", synced=True):
            self.scene = program.build_scene(self.groups,
                                             self.config.get("accel", "bvh"),
                                             self.device)

    def free(self):
        """Drop the program's state before the reference runs."""
        self.scene = None
        gc.collect()
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()

    def reference_scene(self, precision="float32"):
        return self.ref.Scene(self.groups, self.device, precision)

    def reference_camera(self):
        return self.ref.Camera(self.config["camera"], self.resolution,
                               self.device)


class Render(Workload):
    kind = "render"

    def build(self):
        super().build()
        self.camera = program.build_camera(self.config["camera"],
                                           self.resolution, self.device)
        self.spp = int(self.traffic.get("spp", self.config["render_spp"]))
        self.warmup_spp = min(self.spp, int(self.traffic["warmup_spp"]))
        self.pixels = self.resolution[0] * self.resolution[1]
        self.settings = self.config.get("render", {})

    def run_unit(self, k: int, record=True, traced=False):
        s = inputs.unit_seed(self.seed, k)
        spp = self.warmup_spp if k < 0 else self.spp
        before = program.k2_closest_launches()
        with self.spans.span("unit"):
            img = program.render_pass(self.scene, self.camera, spp, s,
                                      **self.settings)
        self.k2_closest.append(program.k2_closest_launches() - before)
        if record:
            self.records.append({"k": k, "seed": s, "image": img})
        return self.pixels * spp

    def free(self):
        self.camera = None
        super().free()

    def chosen(self):
        """The passes and pixels the check compares, drawn from the seed
        among the passes the window completed."""
        rng = _rng(self.seed, 1)
        n = min(int(self.traffic["check_passes"]), len(self.records))
        recs = [self.records[i] for i in
                sorted(rng.choice(len(self.records), n, replace=False))]
        w, h = self.resolution
        pix = [np.sort(rng.choice(w * h, min(int(
            self.traffic["check_pixels"]), w * h), replace=False))
               for _ in recs]
        return recs, pix

    def compare(self, precision="float32"):
        """{"image_rel_l1": ...} of the chosen pixels of the chosen passes
        against the reference (or, for the control, the reference in
        ``precision`` against the reference in float32)."""
        recs, pix = self.chosen()
        scene, cam = self.reference_scene(), self.reference_camera()
        progs, refs = [], []
        control = None if precision == "float32" else \
            self.reference_scene(precision)
        for rec, p in zip(recs, pix):
            ref = self.ref.render_pixels(scene, cam, self.spp, rec["seed"],
                                         p, **self.settings).cpu().numpy()
            if control is None:
                got = rec["image"].reshape(-1, 3)[p]
            else:
                got = self.ref.render_pixels(control, cam, self.spp,
                                             rec["seed"], p,
                                             **self.settings).cpu().numpy()
            progs.append(got)
            refs.append(ref)
        return {"image_rel_l1": check.image_rel_l1(np.concatenate(progs),
                                                   np.concatenate(refs))}


class Grad(Workload):
    kind = "grad"

    def build(self):
        super().build()
        self.scene, self.leaves = program.grad_leaves(self.scene)
        self.ray_camera = self.reference_camera()
        self.spp = int(self.traffic["spp"])
        self.depth = int(self.config["grad"]["depth"])
        self.loss = program.loss_fn(self.config["grad"])
        self.samples_per_unit = self.resolution[0] * self.resolution[1] \
            * self.spp

    def rays(self, k):
        return inputs.grad_rays(self.ray_camera,
                                inputs.step_samples(self.seed, k, self.spp),
                                self.device)

    def run_unit(self, k: int, record=True, traced=False):
        with self.spans.span("unit"):
            loss, grads = program.grad_step(self.scene, self.leaves,
                                            self.rays(k), self.depth,
                                            self.loss,
                                            self.spans if traced else None)
        if record:
            self.records.append({"k": k, "loss": loss, "grads": grads})
        return self.samples_per_unit

    def free(self):
        self.leaves = None
        super().free()

    def compare(self, precision="float32"):
        """{"loss_rel", "grad_rel"}: the worst of the chosen steps."""
        rng = _rng(self.seed, 2)
        n = min(int(self.traffic["check_steps"]), len(self.records))
        recs = [self.records[i] for i in
                sorted(rng.choice(len(self.records), n, replace=False))]
        g = self.config["grad"]
        loss_fn = (self.ref.loss_rgb(*g["wb"]) if g["loss"] == "rgb2"
                   else self.ref.loss_r2)
        scene = self.reference_scene()
        control = None if precision == "float32" else \
            self.reference_scene(precision)
        out = {"loss_rel": 0.0, "grad_rel": 0.0}
        for rec in recs:
            rays = self.rays(rec["k"])
            lr, gr = self.ref.grad_step(scene, *rays, self.depth, loss_fn)
            gr = {k: v.cpu().numpy() for k, v in gr.items()}
            if control is None:
                lp, gp = rec["loss"], rec["grads"]
            else:
                lp, gp = self.ref.grad_step(control, *rays, self.depth,
                                            loss_fn)
                lp, gp = float(lp), {k: v.cpu().numpy()
                                     for k, v in gp.items()}
            del rays
            out["loss_rel"] = max(out["loss_rel"],
                                  check.loss_rel(lp, float(lr)))
            out["grad_rel"] = max(out["grad_rel"], check.grad_rel(gp, gr))
            sync(self.device)
        return out


KINDS = {cls.kind: cls for cls in (Render, Grad)}


def workload(config, traffic, groups, seed, device, spans) -> Workload:
    """The cell's unit of work, after ``cells.admit`` has held the
    configuration and the traffic kind to its reference."""
    ref = cells.reference(config)
    cells.admit(config, traffic["kind"], groups, ref)
    return KINDS[traffic["kind"]](config, traffic, groups, ref, seed, device,
                                  spans)
