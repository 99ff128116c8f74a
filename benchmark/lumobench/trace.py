"""The benchmark's own spans and the device trace of a traced run.

Spans are host intervals the harness records around its calls into the
program (closed by a ``synchronize()`` where asked), kept in memory.  The
device trace is ``torch.profiler`` over the first units of the window,
with the host's operations and their input shapes, read from the raw
Kineto events (building ``prof.events()`` for some hundred thousand
events takes minutes).  ``busy_ns`` is a frozen copy of
``chip_smoke.py``'s union of device intervals.  The profiled wall
includes the profiler's own overhead on the host."""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch


def sync(device):
    """Wait for the card (nothing on the CPU rehearsal)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Spans:
    """Named host intervals: ``with spans.span("forward", synced=True)``
    (closed by a synchronize on both ends)."""

    def __init__(self, device):
        self.device = device
        self.times = defaultdict(list)

    @contextlib.contextmanager
    def span(self, name, synced=False):
        if synced:
            sync(self.device)
        t0 = time.perf_counter()
        with torch.profiler.record_function(f"bench.{name}"):
            yield
        if synced:
            sync(self.device)
        self.times[name].append(time.perf_counter() - t0)


def busy_ns(intervals):
    """Nanoseconds of the union of (start, end) intervals."""
    spans = sorted(intervals)
    if not spans:
        return 0
    busy, end = 0, spans[0][0]
    for a, b in spans:
        a = max(a, end)
        if b > a:
            busy, end = busy + b - a, b
    return busy


def idle_gaps(intervals, t0, t1):
    """The gaps (start, end) of the window [t0, t1] that no interval
    covers."""
    gaps, end = [], t0
    for a, b in sorted(intervals):
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if t1 > end:
        gaps.append((end, t1))
    return gaps


# the profiler's own host events, which name no work of the program
PROFILER_EVENTS = frozenset(("Activity Buffer Request",))


class DeviceTrace:
    """What a traced window recorded: device operations (name, start,
    end, ns), host operations (name, start, end, input shapes) and the
    window's bounds."""

    def __init__(self, device_ops, host_ops, t0, t1):
        self.device_ops = device_ops
        self.host_ops = host_ops
        self.t0, self.t1 = t0, t1

    @property
    def window_s(self):
        return (self.t1 - self.t0) / 1e9

    @property
    def busy_s(self):
        return busy_ns([(a, b) for _, a, b in self.device_ops]) / 1e9

    def top_ops(self, n=10):
        """The device operations that took most time: [[name, s], ...]."""
        total = defaultdict(int)
        for name, a, b in self.device_ops:
            total[name] += b - a
        top = sorted(total.items(), key=lambda kv: -kv[1])[:n]
        return [[name, ns / 1e9] for name, ns in top]

    def top_gaps(self, n=10):
        """The longest idle gaps, each named by the innermost host
        operation running at its middle: [[name, s], ...]."""
        gaps = sorted(idle_gaps([(a, b) for _, a, b in self.device_ops],
                                self.t0, self.t1),
                      key=lambda g: g[0] - g[1])[:n]
        out = []
        for a, b in gaps:
            mid = (a + b) // 2
            around = [(e - s, name) for name, s, e, _ in self.host_ops
                      if s <= mid <= e and name not in PROFILER_EVENTS]
            out.append([min(around)[1] if around else "host", (b - a) / 1e9])
        return out


@contextlib.contextmanager
def profiled(sink: list, device):
    """Profile the body (host and device activity, input shapes); on
    exit append its :class:`DeviceTrace` to ``sink``."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts, record_shapes=True) as prof:
        sync(device)
        t0 = time.perf_counter_ns()
        with torch.profiler.record_function("bench.traced"):
            yield
        sync(device)
        t1 = time.perf_counter_ns()
    dev, host = [], []
    lo = hi = None
    for e in prof.profiler.kineto_results.events():
        a = e.start_ns()
        b = a + e.duration_ns()
        if str(e.device_type()).endswith("CUDA"):
            # the device timeline's copies of host annotations are no work
            if not (e.is_user_annotation() or e.name().startswith("bench.")):
                dev.append((e.name(), a, b))
        else:
            host.append((e.name(), a, b, e.shapes()))
            if e.name() == "bench.traced":
                lo, hi = a, b
    if lo is None:                 # the annotation is missing: the wall
        lo = min((a for _, a, _ in dev), default=0)
        hi = lo + (t1 - t0)
    sink.append(DeviceTrace(dev, host, lo, hi))


def idle_share(run, kind):
    """The device's idle share over a run's traced units, in %: 100 x (1
    - the union of the device intervals / the traced wall); None for a
    run of another traffic kind or without a device trace."""
    if run.kind != kind or not run.traces:
        return None
    busy = sum(t.busy_s for t in run.traces)
    wall = sum(t.window_s for t in run.traces)
    return 100.0 * (1.0 - busy / wall) if busy > 0 and wall > 0 else None


def ops_per_ksample(run, kind):
    """Device operations (kernels, copies, fills) of a run's traced units
    per 1,000 camera samples; None as :func:`idle_share`."""
    if run.kind != kind or not run.traces or not run.traced_samples:
        return None
    n = sum(len(t.device_ops) for t in run.traces)
    return n / (run.traced_samples / 1e3) if n else None
