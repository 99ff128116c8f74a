"""Seconds of the first call in the process of each registered query
operator, summed: the self time of the program's ``setup.first_query``
spans (``lumo_tpu_torch/telemetry.py``), without a kernel library's load
nested in it.  The warm-up unit pays it, inside ``setup_s``.  None where
the program records no such span."""


def read(run):
    try:
        from lumo_tpu_torch import telemetry
    except ImportError:
        return None
    s = telemetry.snapshot()["spans"].get("setup.first_query")
    return s["self_ns"] / 1e9 if s else None
