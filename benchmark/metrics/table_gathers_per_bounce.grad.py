"""Per-lane reads of a material table a bounce over the traced gradient
steps: the program's ``bsdf.table_gathers`` counter over its
``path.bounce`` spans (``lumo_tpu_torch/telemetry.py``).  Each read's
backward is one scatter-add over the lanes.  None where the program
counts no such reads."""


def read(run):
    if run.kind != "grad":
        return None
    try:
        from lumo_tpu_torch import telemetry
    except ImportError:
        return None
    snap = telemetry.snapshot()
    n = snap["counters"].get("bsdf.table_gathers")
    bounces = snap["spans"].get("path.bounce")
    return n / bounces["n"] if n is not None and bounces else None
