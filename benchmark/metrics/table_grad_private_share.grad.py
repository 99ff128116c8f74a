"""Share of the traced gradient steps' differentiable material-table
reads (a table that requires grad, read under grad mode) whose backward
is the hand-written reduction: the program's ``bsdf.table_grad.private``
counter over ``private + plain`` (``lumo_tpu_torch/bsdf/table_grad.py``),
in %.  None where the program has neither counter (a program without
that module)."""


def read(run):
    if run.kind != "grad":
        return None
    try:
        from lumo_tpu_torch import telemetry
    except ImportError:
        return None
    counters = telemetry.snapshot()["counters"]
    private = counters.get("bsdf.table_grad.private", 0)
    plain = counters.get("bsdf.table_grad.plain", 0)
    if private + plain == 0:
        return None
    return 100.0 * private / (private + plain)
