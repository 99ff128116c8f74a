"""Global constants of the PyTorch port and its device rule.

Counterpart of ``lumo_tpu/config.py``.  The port renders in float32 only
(the JAX package's float64 CPU reference mode is not ported).  Entry
points run on the CUDA card unless the caller names another device:
:func:`resolve_device` raises instead of silently falling back to the
CPU when no card is visible.
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


def epsilon() -> float:
    """Intersection epsilon for float32 (reference ``src/lib.rs:61-67``)."""
    return 1e-4


def machine_eps_half() -> float:
    return float(np.finfo(np.float32).eps) / 2.0


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
