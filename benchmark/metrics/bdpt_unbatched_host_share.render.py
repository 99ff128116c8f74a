"""The share of BDPT's host time spent in the strategy families that run
one strategy at a time, in %, over the traced render: the self time of
the program's ``bdpt.s0``, ``bdpt.s1`` and ``bdpt.t1`` spans over the host
time of its ``bdpt.integrate`` spans
(``lumo_tpu_torch/integrators/bdpt.py``).  Batching those families, as
the general strategies of one s are batched, would cut it.  None where
the program records no such spans."""

FAMILIES = ("bdpt.s0", "bdpt.s1", "bdpt.t1")


def read(run):
    if run.kind != "render":
        return None
    try:
        from lumo_tpu_torch import telemetry
    except ImportError:
        return None
    spans = telemetry.snapshot()["spans"]
    whole = spans.get("bdpt.integrate")
    if not whole or not whole["host_ns"]:
        return None
    own = sum(spans[k]["self_ns"] for k in FAMILIES if k in spans)
    return 100.0 * own / whole["host_ns"]
