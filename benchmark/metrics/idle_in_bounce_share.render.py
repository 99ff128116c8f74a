"""The share of the device's idle time over the traced render, in %,
whose gaps have their middle inside one of the program's
``lumo.path.bounce`` host ranges (the profiler's clock): idle that the
bounce's own host work leaves.  None where the trace holds no such
range."""
from bisect import bisect_right

from lumobench.trace import idle_gaps

BOUNCE = "lumo.path.bounce"


def read(run):
    if run.kind != "render" or not run.traces:
        return None
    inside = idle = 0
    found = False
    for t in run.traces:
        spans = sorted((a, b) for name, a, b, _ in t.host_ops
                       if name == BOUNCE)
        if not spans:
            continue
        found = True
        starts = [a for a, _ in spans]
        for a, b in idle_gaps([(x, y) for _, x, y in t.device_ops],
                              t.t0, t.t1):
            mid = (a + b) // 2
            i = bisect_right(starts, mid) - 1
            idle += b - a
            if i >= 0 and mid <= spans[i][1]:
                inside += b - a
    return 100.0 * inside / idle if found and idle > 0 else None
