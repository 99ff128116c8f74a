"""Mean host milliseconds of a bounce over the traced render: the
program's ``path.bounce`` span (``lumo_tpu_torch/telemetry.py``), its
duration over its count.  None where the program records no such span."""


def read(run):
    if run.kind != "render":
        return None
    try:
        from lumo_tpu_torch import telemetry
    except ImportError:
        return None
    s = telemetry.snapshot()["spans"].get("path.bounce")
    return s["host_ns"] / s["n"] / 1e6 if s else None
