"""Share of the traced gradient steps whose fixed-depth ``integrate`` ran
as a CUDA graph: the program's ``path.graph.capture`` plus
``path.graph.replay`` counters over those plus ``path.graph.eager``
(``lumo_tpu_torch/integrators/graph_step.py``), in %.  None where the
program counts none of the three (a program without graphed steps)."""


def read(run):
    if run.kind != "grad":
        return None
    try:
        from lumo_tpu_torch import telemetry
    except ImportError:
        return None
    counters = telemetry.snapshot()["counters"]
    graphed = (counters.get("path.graph.capture", 0)
               + counters.get("path.graph.replay", 0))
    total = graphed + counters.get("path.graph.eager", 0)
    if total == 0:
        return None
    return 100.0 * graphed / total
