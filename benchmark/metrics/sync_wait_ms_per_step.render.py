"""Host milliseconds a render step spends waiting on the card in the
program's ``sync.*`` spans (``lumo_tpu_torch/telemetry.py``: the
per-bounce liveness test, the image's read-back) over the traced render,
divided by its ``render.step`` spans.  None where the program records no
steps."""


def read(run):
    if run.kind != "render":
        return None
    try:
        from lumo_tpu_torch import telemetry
    except ImportError:
        return None
    spans = telemetry.snapshot()["spans"]
    steps = spans.get("render.step")
    if not steps:
        return None
    wait = sum(s["host_ns"] for k, s in spans.items() if k.startswith("sync."))
    return wait / steps["n"] / 1e6
