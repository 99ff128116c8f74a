"""The share of the BDPT connections' any-hit query lanes that do real
work, in %, over the traced render: the program's ``bdpt.connect.live``
counter (lanes with a positive t_max) over ``bdpt.connect.lanes`` (every
lane the s = 1, t = 1 and general connections hand to a query;
``lumo_tpu_torch/integrators/bdpt.py``).  None where the program counts
no such lanes."""


def read(run):
    if run.kind != "render":
        return None
    try:
        from lumo_tpu_torch import telemetry
    except ImportError:
        return None
    c = telemetry.snapshot()["counters"]
    lanes = c.get("bdpt.connect.lanes")
    return 100.0 * c.get("bdpt.connect.live", 0) / lanes if lanes else None
