"""Rays a camera sample over the traced render: the lanes alive entering
a bounce, each of which traces one ray (the program's ``lanes.alive``
counter, ``lumo_tpu_torch/telemetry.py``; the Renderer's own count, its
fold's sum of depth + 1), over the traced units' samples.  None where the
program counts no lanes."""


def read(run):
    if run.kind != "render" or not run.traced_samples:
        return None
    try:
        from lumo_tpu_torch import telemetry
    except ImportError:
        return None
    rays = telemetry.snapshot()["counters"].get("lanes.alive")
    return rays / run.traced_samples if rays is not None else None
