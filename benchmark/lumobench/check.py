"""The comparisons that decide ``correct``: what the timed units
produced against the plain reference, each number beside its limit."""
from __future__ import annotations

import numpy as np


def image_rel_l1(program: np.ndarray, reference: np.ndarray) -> float:
    """sum |program - reference| / sum |reference| over the checked
    pixels and channels."""
    p = np.asarray(program, np.float64)
    r = np.asarray(reference, np.float64)
    return float(np.abs(p - r).sum() / max(np.abs(r).sum(), 1e-30))


def loss_rel(program: float, reference: float) -> float:
    return abs(program - reference) / max(abs(reference), 1e-30)


def grad_rel(program: dict, reference: dict) -> float:
    """The worst leaf's ||g_program - g_reference|| over the larger of
    that leaf's reference norm and the median leaf's; a leaf the program
    leaves out (no gradient) counts as zeros."""
    ref = {k: np.asarray(v, np.float64) for k, v in reference.items()}
    norms = {k: float(np.linalg.norm(v)) for k, v in ref.items()}
    median = float(np.median(list(norms.values())))
    worst = 0.0
    for k, r in ref.items():
        p = program.get(k)
        p = np.zeros_like(r) if p is None else np.asarray(p, np.float64)
        den = max(norms[k], median, 1e-30)
        worst = max(worst, float(np.linalg.norm(p - r)) / den)
    return worst


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): every number at or under
    its limit (a NaN fails)."""
    table = {k: {"value": float(v), "limit": float(limits[k])}
             for k, v in numbers.items()}
    ok = all(np.isfinite(t["value"]) and t["value"] <= t["limit"]
             for t in table.values())
    return bool(ok) and bool(table), table
