"""Spans and counters inside the port, on exactly while a torch profiler
records.

    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        img = Renderer(scene, camera).samples(56).render(verbose=False)
    telemetry.snapshot()   # {"spans": {...}, "counters": {...}}

While a profiler records, :func:`span` opens
``torch.profiler.record_function("lumo." + name)``, so every span lies on
the profiler's clock beside the device's activity (``lumo.*`` ranges in
an exported Chrome trace), and adds its host duration, its self time
(the duration less the part its child spans cover) and a call to an
in-memory registry keyed by name.  :func:`add` adds to a host counter;
counting code runs only under ``if telemetry.on():``, so that no count,
and above all no device reduction, is computed while nothing records.
With no profiler a span is one shared null context.

The ``setup.*`` spans are the one exception: they run once a process
(the scene build, a kernel library's load, a query operator's first
call) and are recorded with or without a profiler.

Code captured into a CUDA graph runs on the host once, at the capture,
and its device work runs at every replay.  Inside :func:`taped` the
spans' calls and the counters go to a tape, whether or not a profiler
records, and not to the registry; :func:`replay` adds a tape to the
registry, while a profiler records, once for each replay.
"""
from __future__ import annotations

import contextlib
import functools
import threading
import time

import torch

PREFIX = "lumo."
ALWAYS = "setup."          # spans recorded with no profiler too

_enabled = torch._C._autograd._profiler_enabled
_NULL = contextlib.nullcontext()
_lock = threading.Lock()
_local = threading.local()     # each thread's open spans, innermost last
_spans = {}                    # name -> [calls, host ns, self ns]
_counters = {}                 # name -> count
_launch_base = {}              # launch counter -> its value at reset()
_tape = None                   # the open tape of :func:`taped`, or None


def on() -> bool:
    """Whether spans and counters are live: a torch profiler records, or a
    tape is open."""
    return _enabled() or _tape is not None


class Span:
    """An open span; ``seconds`` is its host duration once closed."""

    __slots__ = ("name", "ns", "_child", "_t0", "_rf")

    def __init__(self, name: str):
        self.name = name
        self.ns = None
        self._child = 0
        self._rf = (torch.profiler.record_function(PREFIX + name)
                    if _enabled() else None)

    def __enter__(self):
        stack = _stack()
        stack.append(self)
        if self._rf is not None:
            self._rf.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.ns = time.perf_counter_ns() - self._t0
        if self._rf is not None:
            self._rf.__exit__(*exc)
        stack = _stack()
        stack.pop()
        if stack:
            stack[-1]._child += self.ns
        with _lock:
            if _tape is not None and not self.name.startswith(ALWAYS):
                calls = _tape["spans"]
                calls[self.name] = calls.get(self.name, 0) + 1
                return False
            rec = _spans.setdefault(self.name, [0, 0, 0])
            rec[0] += 1
            rec[1] += self.ns
            rec[2] += self.ns - self._child
        return False

    @property
    def seconds(self) -> float:
        return self.ns / 1e9


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def span(name: str):
    """A context manager timing ``name``: a :class:`Span` while spans are
    live (:func:`on`; always, for a ``setup.*`` name), else a shared null
    context."""
    if on() or name.startswith(ALWAYS):
        return Span(name)
    return _NULL


def spanned(name: str):
    """Decorate a function so that each call runs inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def add(name: str, n) -> None:
    """Add ``n`` to the host counter ``name`` (to the open tape's, inside
    :func:`taped`)."""
    with _lock:
        counters = _counters if _tape is None else _tape["counters"]
        counters[name] = counters.get(name, 0) + int(n)


@contextlib.contextmanager
def taped():
    """Record the body's span calls and counters into a fresh tape,
    ``{"spans": {name: calls}, "counters": {name: count}}``, whether or not
    a profiler records, and none of them into the registry: the body is
    being captured into a CUDA graph, and its work runs at the replays
    (:func:`replay`).  ``setup.*`` spans go to the registry as always.
    The tape is open for every thread (autograd's backward runs on its
    own)."""
    global _tape
    outer, _tape = _tape, {"spans": {}, "counters": {}}
    try:
        yield _tape
    finally:
        _tape = outer


def replay(tape: dict) -> None:
    """Add a tape to the registry while a profiler records: each span's
    calls, with no host time (its host code did not run again), and each
    counter."""
    if not _enabled():
        return
    with _lock:
        for name, n in tape["spans"].items():
            _spans.setdefault(name, [0, 0, 0])[0] += n
        for name, n in tape["counters"].items():
            _counters[name] = _counters.get(name, 0) + n


def _launches() -> dict:
    """The traversal kernels' launch counters, as counter names."""
    from lumo_tpu_torch.accel import bvh_kernel, kd_kernel
    return {f"launches.{mod}.{k}": v
            for mod, table in (("bvh", bvh_kernel.LAUNCHES),
                               ("kd", kd_kernel.LAUNCHES))
            for k, v in table.items()}


def snapshot() -> dict:
    """``{"spans": {name: {"n", "host_ns", "self_ns"}}, "counters":
    {name: count}}`` since the last :func:`reset`.  The counters include
    the traversal kernels' launches (``launches.bvh.closest``, ...), read
    from ``bvh_kernel.LAUNCHES`` and ``kd_kernel.LAUNCHES`` themselves
    less their values at the last reset."""
    launches = {k: v - _launch_base.get(k, 0) for k, v in _launches().items()}
    with _lock:
        spans = {k: {"n": n, "host_ns": host, "self_ns": own}
                 for k, (n, host, own) in _spans.items()}
        return {"spans": spans, "counters": {**_counters, **launches}}


def reset() -> None:
    """Clear the registry (the launch counters count from here on)."""
    base = _launches()
    with _lock:
        _spans.clear()
        _counters.clear()
        _launch_base.clear()
        _launch_base.update(base)


def gather(table, index):
    """``table[index]``: one per-lane read of a material table, counted as
    ``bsdf.table_gathers`` while counters are live (each such read's
    backward is one scatter-add over the lanes).  A table that requires
    grad, read under grad mode, goes to ``bsdf.table_grad.gather``, which
    chooses that scatter-add's implementation."""
    if on():
        add("bsdf.table_gathers", 1)
    if table.requires_grad and torch.is_grad_enabled():
        from lumo_tpu_torch.bsdf import table_grad
        return table_grad.gather(table, index)
    return table[index]
