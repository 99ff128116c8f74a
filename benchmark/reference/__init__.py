"""The benchmark's plain reference: the path tracer that decides
``correct``, in plain PyTorch and NumPy.

It is a frozen copy of the plain arithmetic of ``lumo_tpu_torch`` as it
stood when the benchmark was defined, cut down to what the benchmark's
scenes hold: triangles only; Lambertian, microfacet-diffuse, conductor
(GGX) and light materials; the path tracer with next-event estimation,
power-2 MIS and adaptive Russian roulette; the multi-jittered camera
samples, hero wavelengths and the Gaussian film.  It imports nothing of
``lumo_tpu_torch`` nor of the JAX package, and it takes nothing the
program made: it builds its own material tables, light tables and
acceleration structure (``scene.py``) from the raw arrays the benchmark
hands both sides.  Its scene queries find the nearest hit by testing
every triangle a conservative cluster hierarchy cannot rule out, with the
same watertight test as the program's kernel, so the hit distances are
the same bits.

It shares no file with the program: the CIE and illuminant spectra and
the fitted RGB-to-spectrum table are frozen copies, in ``data/``, of the
files the port shipped under ``lumo_tpu_torch/color/data/`` when the
benchmark was defined, so a later refit of the port's table moves the
program and not the yardstick.

``precision`` (``"float32"`` or ``"bf16"``) selects the control: with
``"bf16"`` the scene tables, the camera rays and the path state between
bounces are held in bfloat16 (arithmetic stays float32), the step a
later change would be tempted to take to halve the wavefront's memory
traffic.

A configuration names its reference by ``"reference": "<name>"``, the
module ``reference/<name>.py``; one that names none has this package.
Every reference module declares what it holds (``INTEGRATORS``,
``MATERIALS``, ``TRAFFIC``: the integrators, material kinds and traffic
kinds it works out again, each a set of names) and exports what the
harness's units call: ``Scene(groups, device, precision)``,
``Camera(args, resolution, device)``, for the ``render`` traffic
``render_pixels(scene, camera, spp, seed, pixels, **render)`` (the
configuration's ``render`` settings as keywords) and for the ``grad``
traffic ``grad_step``, ``loss_rgb`` and ``loss_r2``.  A cell whose
configuration names anything its reference does not declare is refused
before the scene is built (``lumobench/cells.py`` ``admit``).
"""
from .camera import Camera
from .render import grad_step, loss_r2, loss_rgb
from .render import render_pixels as _render_pixels
from .scene import Scene

INTEGRATORS = frozenset({"path"})
MATERIALS = frozenset({"lambertian", "diffuse", "metal", "light"})
TRAFFIC = frozenset({"render", "grad"})


def render_pixels(scene, camera, spp, seed, pixels, integrator="path"):
    """``render.render_pixels`` of a configuration's ``render`` settings:
    this reference takes its integrator, its one, and no other."""
    return _render_pixels(scene, camera, spp, seed, pixels)
