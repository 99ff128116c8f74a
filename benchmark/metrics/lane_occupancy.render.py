"""The share of a bounce's lanes that are alive entering it, in %, over
the traced render: the program's ``lanes.alive`` over ``lanes.total``
counters (``lumo_tpu_torch/telemetry.py``, counted at each liveness
test).  None where the program counts no lanes."""


def read(run):
    if run.kind != "render":
        return None
    try:
        from lumo_tpu_torch import telemetry
    except ImportError:
        return None
    c = telemetry.snapshot()["counters"]
    total = c.get("lanes.total")
    return 100.0 * c.get("lanes.alive", 0) / total if total else None
