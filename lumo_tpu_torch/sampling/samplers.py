"""Counter-based hashes: uint32 avalanche hash and hash-to-float.

Counterpart of ``lumo_tpu/sampling/samplers.py`` (``_hash_u32`` and
``_randfloat`` only; the pixel samplers come with the Renderer).  Every
draw of the integrators is a pure function of a per-ray uint32 state, so
the port reproduces the JAX package's random numbers bit for bit.

torch has no full uint32 arithmetic on every device, so a uint32 value is
carried in an int64 tensor masked to 32 bits.  A 32 x 32-bit product
would overflow int64, so constants are multiplied in 16-bit halves that
keep the low 32 bits exact.
"""
from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF


def u32(x, device=None) -> torch.Tensor:
    """A uint32 value (tensor or int) as a masked int64 tensor."""
    return torch.as_tensor(x, dtype=torch.int64, device=device) & MASK32


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for x < 2**32 and a constant c < 2**32."""
    lo = c & 0xFFFF
    hi = c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & MASK32


def _hash_u32(x) -> torch.Tensor:
    """A small avalanche hash (uint32 in int64)."""
    x = u32(x)
    x = x ^ (x >> 17)
    x = _mul32(x, 0xED5AD4BB)
    x = x ^ (x >> 11)
    x = _mul32(x, 0xAC4C1B51)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x31848BAB)
    x = x ^ (x >> 14)
    return x


def _randfloat(i, p) -> torch.Tensor:
    """Kensler's hash -> float32 in [0, 1)."""
    i = u32(i)
    p = u32(p, device=i.device)
    i = i ^ p
    i = i ^ (i >> 17)
    i = i ^ (i >> 10)
    i = _mul32(i, 0xB36534E5)
    i = i ^ (i >> 12)
    i = i ^ (i >> 21)
    i = _mul32(i, 0x93FC4795)
    i = i ^ 0xDF6E307F
    i = i ^ (i >> 17)
    # the factor is below 2**14 + 1, so the int64 product stays exact
    i = (i * (1 | (p >> 18))) & MASK32
    return i.to(torch.float32) * (1.0 / 4294967808.0)
