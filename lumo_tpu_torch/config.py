"""Global constants of the PyTorch port, its float64 switch and its
device rule.

Counterpart of ``lumo_tpu/config.py``.  The production path renders in
float32.  ``use_f64(True)`` switches the precision-dependent constants
(:func:`epsilon`, :func:`machine_eps_half`, :func:`gamma_bound`) to
float64, the reference mode: scenes, cameras and rays are then built in
``float_dtype()`` and every scene query takes the plain float64 route
(the CUDA kernels are float32 only; ``accel/cuda_build.reference_route``).
Torch has no process-global float64 flag, so the switch is all there is
to flip.  Entry points run on the CUDA card unless the caller names
another device: :func:`resolve_device` raises instead of silently
falling back to the CPU when no card is visible.
"""
from __future__ import annotations

import numpy as np
import torch

LAMBDA_MIN = 360.0
LAMBDA_MAX = 830.0
SPECTRUM_SAMPLES = 4       # hero wavelength + 3
DENSE_SAMPLES = 95         # every 5nm over [360, 830]

INF = float(np.inf)

# Transport mode tags (reference ``src/lib.rs:75-80``)
RADIANCE = 0
IMPORTANCE = 1

_F64 = False    # the float64 switch (:func:`use_f64`)


def use_f64(enable: bool = True) -> None:
    """Switch the renderer's constants to float64 (the reference mode);
    build the scene, camera and rays in ``float_dtype()`` as well."""
    global _F64
    _F64 = bool(enable)


def float_dtype() -> torch.dtype:
    return torch.float64 if _F64 else torch.float32


def np_float_dtype():
    return np.float64 if _F64 else np.float32


def epsilon() -> float:
    """Intersection epsilon; the reference uses 1e-10 for float64, 1e-4 for
    float32 (``src/lib.rs:61-67``)."""
    return 1e-10 if _F64 else 1e-4


def machine_eps_half() -> float:
    """Machine epsilon / 2 of the switch's precision, for the gamma error
    bounds (PBR section 3.9)."""
    return float(np.finfo(np_float_dtype()).eps) / 2.0


def gamma_bound(n: int) -> float:
    """PBR gamma(n) = n*e / (1 - n*e) floating point error bound
    (reference ``src/efloat.rs:5-8``)."""
    e = machine_eps_half()
    return n * e / (1.0 - n * e)


def default_device() -> torch.device:
    """The device entry points use when the caller names none."""
    return torch.device("cuda")


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the card, and
    raises when no card is visible rather than running on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible; pass device='cpu' to run the "
                "port on the CPU")
        return default_device()
    return torch.device(device)
