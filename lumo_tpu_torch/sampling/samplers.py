"""Counter-based hashes and the stateless pixel samplers: uniform,
jittered, correlated multi-jittered and Sobol, all as pure index -> point
functions.

Counterpart of ``lumo_tpu/sampling/samplers.py``.  Every draw of the
integrators and every sub-pixel offset is a pure function of uint32
counters (pixel, sample index, seed), so the port reproduces the JAX
package's random numbers bit for bit.

torch has no full uint32 arithmetic on every device, so a uint32 value is
carried in an int64 tensor masked to 32 bits.  A 32 x 32-bit product
would overflow int64, so constants are multiplied in 16-bit halves that
keep the low 32 bits exact.
"""
from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF

UNIFORM = 0
JITTERED = 1
MULTI_JITTERED = 2  # default, Kensler 2013 correlated shuffle
SOBOL = 3


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


def _permute(i, l: int, p) -> torch.Tensor:
    """Kensler's cycle-walking permutation of [0, l) ('Correlated
    Multi-Jittered Sampling', Pixar TM 13-01) with the JAX package's
    bijective mixing steps: xor with a masked constant, multiply by an odd
    constant then mask, masked xorshift.  i, p: uint32 in int64; l: int.
    Returns a bijective shuffle of i within [0, l)."""
    l = int(l)
    w = l - 1
    for sh in (1, 2, 4, 8, 16):
        w |= w >> sh
    i = u32(i)
    p = u32(p, device=i.device)

    def step(i):
        i = i ^ (p & w)
        i = _mul32(i, 0x9E3779B1) & w
        i = i ^ (i >> 3)
        i = i ^ ((p >> 13) & w)
        i = _mul32(i, 0x85EBCA77) & w
        i = i ^ (i >> 7)
        i = i ^ ((p >> 23) & w)
        i = _mul32(i, 0xC2B2AE35) & w
        i = i ^ (i >> 5)
        return i

    val = step(i)
    done = val < l
    while not bool(done.all()):
        val = torch.where(done, val, step(val))
        done = val < l
    return ((val + p) & MASK32) % l


def cmj(s, m: int, n: int, p) -> torch.Tensor:
    """Correlated multi-jittered 2D sample ``s`` of an m x n grid with
    pattern seed ``p`` -> (..., 2) float32."""
    N = int(m) * int(n)
    p = u32(p)
    s = _permute(s, N, _mul32(p, 0x51633E2D))
    sx = _permute(s % m, m, _mul32(p, 0x68BC21EB))
    sy = _permute(s // m, n, _mul32(p, 0x02E5BE93))
    jx = _randfloat(s, _mul32(p, 0x967A889B))
    jy = _randfloat(s, _mul32(p, 0x368CC8B7))
    x = (sx.to(torch.float32) + (sy.to(torch.float32) + jx) / n) / m
    y = (s.to(torch.float32) + jy) / N
    return torch.stack([x, y], dim=-1)


def _sobol_directions() -> np.ndarray:
    """(2, 32) direction numbers: van der Corput, and the primitive
    polynomial x^2 + x + 1."""
    v0 = [1 << (31 - i) for i in range(32)]
    m = [1, 3]
    for i in range(2, 32):
        m.append((2 * m[i - 1]) ^ (4 * m[i - 2]) ^ m[i - 2])
    v1 = [(m[i] << (31 - i)) & MASK32 for i in range(32)]
    return np.asarray([v0, v1], np.int64)


_SOBOL_V = _sobol_directions()


def sobol2d(idx, scramble) -> torch.Tensor:
    """2D Sobol point for sample ``idx`` (...) with a per-pixel XOR
    scramble (..., 2), both uint32 in int64 -> (..., 2) float32."""
    idx = u32(idx)
    acc0 = torch.zeros_like(idx)
    acc1 = torch.zeros_like(idx)
    for b in range(32):
        bit = ((idx >> b) & 1) == 1
        acc0 = acc0 ^ torch.where(bit, int(_SOBOL_V[0, b]), 0)
        acc1 = acc1 ^ torch.where(bit, int(_SOBOL_V[1, b]), 0)
    pts = torch.stack([acc0 ^ scramble[..., 0], acc1 ^ scramble[..., 1]],
                      dim=-1)
    return pts.to(torch.float32) * (1.0 / 4294967296.0)


def pixel_offsets(kind: int, sample_idx, n_samples: int, pixel_hash,
                  seed: int) -> torch.Tensor:
    """Sub-pixel offsets in [0, 1)^2 for a wavefront -> (..., 2) float32.

    kind: UNIFORM / JITTERED / MULTI_JITTERED / SOBOL; sample_idx (...)
    sample index; n_samples: the stratification's sample count;
    pixel_hash (...) uint32 unique per pixel; seed: the global seed."""
    p = _hash_u32(u32(pixel_hash) ^ (int(seed) & MASK32))
    s = u32(sample_idx, device=p.device)
    if kind == UNIFORM:
        return torch.stack([_randfloat((s * 2) & MASK32, p),
                            _randfloat((s * 2 + 1) & MASK32, p)], dim=-1)
    if kind == JITTERED:
        m = max(int(np.floor(np.sqrt(n_samples))), 1)
        sx = (s % m).to(torch.float32)
        sy = ((s // m) % m).to(torch.float32)
        jx = _randfloat((s * 2) & MASK32, p)
        jy = _randfloat((s * 2 + 1) & MASK32, p)
        return torch.stack([(sx + jx) / m, (sy + jy) / m], dim=-1)
    if kind == MULTI_JITTERED:
        m = max(int(np.floor(np.sqrt(n_samples))), 1)
        n = max(n_samples // m, 1)
        return cmj(s % (m * n), m, n, p)
    if kind == SOBOL:
        scr = torch.stack([_hash_u32(p), _hash_u32(p ^ 0x9E3779B9)], dim=-1)
        return sobol2d(s, scr)
    raise ValueError(kind)
