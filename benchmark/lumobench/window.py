"""One run of one cell: set-up, warm-up, the closed-loop window, the
comparison with the reference, and the result line.

The window is a closed loop (one user waiting on each result): units run
back to back until ``seconds`` have passed since the first began; the
rates are all the work of the window over all its time, from the first
unit's start to the last one's end.  Each unit ends with its result on
the host, so the card is idle at both ends of the window.  In a traced
run the first ``TRACED_UNITS`` units run under ``torch.profiler`` and the
gradient steps close their forward and backward with a synchronize
each, so its times read higher than an untraced run's."""
from __future__ import annotations

import sys
import time

import torch

from . import cells, check, traffic
from .trace import Spans, profiled, sync

TRACED_UNITS = {"render": 1, "grad": 2}
WARMUP_UNIT = -1


class Run:
    """What the metric readers read (``metrics/<name>.py``: ``read(run)``
    -> a number, or None where the run has nothing to read)."""

    def __init__(self, kind, spans):
        self.kind = kind
        self.spans = spans
        self.samples = 0
        self.window_s = None
        self.setup_s = None
        self.peak_bytes = None
        self.traces = []
        self.traced_samples = 0


def run_cell(cell: cells.Cell, seed: int, seconds: float, trace: bool,
             device, t_start: float) -> dict:
    """Run ``cell`` once; returns the result line's dict (``device``
    filled by the caller)."""
    spans = Spans(device)
    groups = cells.scene_groups(cell.config)
    work = traffic.workload(cell.config, cell.traffic, groups, seed, device,
                            spans)
    run = Run(work.kind, spans)
    work.build()
    work.run_unit(WARMUP_UNIT, record=False)
    sync(device)
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    n_traced = TRACED_UNITS[work.kind] if trace else 0
    t0 = time.perf_counter()
    run.setup_s = t0 - t_start
    k = 0
    if n_traced:
        with profiled(run.traces, device):
            for k in range(n_traced):
                run.traced_samples += work.run_unit(k, traced=True)
        run.samples = run.traced_samples
        k = n_traced
    while k == 0 or time.perf_counter() - t0 < seconds:
        run.samples += work.run_unit(k, traced=trace)
        k += 1
    sync(device)
    run.window_s = time.perf_counter() - t0
    # each unit's wall (the warm-up's first): the spread of a run
    print("unit_s " + " ".join(f"{u:.4f}" for u in spans.times["unit"]),
          "k2_closest " + " ".join(map(str, work.k2_closest)),
          file=sys.stderr)
    if torch.device(device).type == "cuda":
        run.peak_bytes = torch.cuda.max_memory_allocated(device)
    work.free()
    t_check = time.perf_counter()
    correct, table = check.verdict(work.compare(), work.limits)
    print(f"check_s {time.perf_counter() - t_check:.4f}", file=sys.stderr)
    metrics = {}
    for entry, reader in (cell.per_layer if trace else cell.end_to_end):
        value = reader.read(run)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    out = {"correct": correct, "attempted": k,
           "failed": 0 if correct else k,
           "metrics": metrics,
           "device": {"memory_peak_bytes": run.peak_bytes}}
    if trace and run.traces:
        busy = sum(t.busy_s for t in run.traces)
        wall = sum(t.window_s for t in run.traces)
        out["device"].update(busy_s=busy, window_s=wall)
        out["breakdown"] = {"device_ops": run.traces[0].top_ops(),
                            "idle_gaps": run.traces[0].top_gaps()}
    out["check"] = table
    return out
