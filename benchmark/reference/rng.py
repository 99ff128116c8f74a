"""Counter hashes and the correlated multi-jittered pixel sampler (frozen
copy of ``lumo_tpu_torch/sampling/samplers.py``).  A uint32 value is
carried in an int64 tensor masked to 32 bits; constants multiply in
16-bit halves so the low 32 bits stay exact."""
from __future__ import annotations

import math

import torch

MASK32 = 0xFFFFFFFF


def u32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int64, device=device) & MASK32


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for x < 2**32 and a constant c < 2**32."""
    lo = c & 0xFFFF
    hi = c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & MASK32


def hash_u32(x) -> torch.Tensor:
    x = u32(x)
    x = x ^ (x >> 17)
    x = mul32(x, 0xED5AD4BB)
    x = x ^ (x >> 11)
    x = mul32(x, 0xAC4C1B51)
    x = x ^ (x >> 15)
    x = mul32(x, 0x31848BAB)
    x = x ^ (x >> 14)
    return x


def randfloat(i, p) -> torch.Tensor:
    """Kensler's hash -> float32 in [0, 1)."""
    i = u32(i)
    p = u32(p, device=i.device)
    i = i ^ p
    i = i ^ (i >> 17)
    i = i ^ (i >> 10)
    i = mul32(i, 0xB36534E5)
    i = i ^ (i >> 12)
    i = i ^ (i >> 21)
    i = mul32(i, 0x93FC4795)
    i = i ^ 0xDF6E307F
    i = i ^ (i >> 17)
    i = (i * (1 | (p >> 18))) & MASK32
    return i.to(torch.float32) * (1.0 / 4294967808.0)


def _permute(i, l: int, p) -> torch.Tensor:
    """Kensler's cycle-walking permutation of [0, l)."""
    w = l - 1
    for sh in (1, 2, 4, 8, 16):
        w |= w >> sh
    i = u32(i)
    p = u32(p, device=i.device)

    def step(i):
        i = i ^ (p & w)
        i = mul32(i, 0x9E3779B1) & w
        i = i ^ (i >> 3)
        i = i ^ ((p >> 13) & w)
        i = mul32(i, 0x85EBCA77) & w
        i = i ^ (i >> 7)
        i = i ^ ((p >> 23) & w)
        i = mul32(i, 0xC2B2AE35) & w
        i = i ^ (i >> 5)
        return i

    val = step(i)
    done = val < l
    while not bool(done.all()):
        val = torch.where(done, val, step(val))
        done = val < l
    return ((val + p) & MASK32) % l


def cmj(s, m: int, n: int, p) -> torch.Tensor:
    """Correlated multi-jittered 2D sample ``s`` of an m x n grid."""
    N = m * n
    p = u32(p)
    s = _permute(s, N, mul32(p, 0x51633E2D))
    sx = _permute(s % m, m, mul32(p, 0x68BC21EB))
    sy = _permute(s // m, n, mul32(p, 0x02E5BE93))
    jx = randfloat(s, mul32(p, 0x967A889B))
    jy = randfloat(s, mul32(p, 0x368CC8B7))
    x = (sx.to(torch.float32) + (sy.to(torch.float32) + jx) / n) / m
    y = (s.to(torch.float32) + jy) / N
    return torch.stack([x, y], dim=-1)


def pixel_offsets(sample_idx, n_samples: int, pixel, seed) -> torch.Tensor:
    """Multi-jittered sub-pixel offsets in [0, 1)^2; ``seed`` an int or a
    per-lane int64 tensor."""
    p = hash_u32(u32(pixel) ^ (seed & MASK32))
    s = u32(sample_idx, device=p.device)
    m = max(math.isqrt(n_samples), 1)
    n = max(n_samples // m, 1)
    return cmj(s % (m * n), m, n, p)
