"""One CUDA graph for a repeated fixed-depth step of the path tracer.

``path_trace.integrate(..., fixed_depth=k)`` runs exactly k bounces with
no host sync.  On the card its operations, and autograd's backward of
them, keep their shapes and their buffers from one call to the next when
only the rays change, so the step can run as one graph launch instead
of some ten thousand kernel launches.  :func:`run` decides, from what the call
shows, how a fixed-depth call runs:

- eagerly, as the function itself, where a tensor is off the card,
  ``checkpoint`` is set, forward mode is on (an open dual level or a
  ``torch.func`` transform), a graphed forward still waits for its
  backward, or the call's :func:`key` differs from the previous
  fixed-depth call's;
- where the key equals the previous call's, whose eager run was the
  warm-up a capture needs: it captures the step once and replays it.  The
  forward (all k bounces) is one graph.  Under grad mode, where an output
  requires grad, autograd's backward of it (``torch.autograd.grad`` of
  the outputs over the inputs that require grad, from static cotangent
  buffers) is a second graph in the first one's memory pool: the
  structure of ``torch.cuda.make_graphed_callables``.  A later call with
  the key replays both through :class:`_Replay`.

The graphs read static copies of the rays, a tensor ``delta`` and every
scene tensor that requires grad, refreshed by a copy at each call; every
other scene tensor is read in place, at its address.  Outputs and
gradients are fresh clones, so a caller may keep them.  The graphs run
the eager step's kernels on the same values, so the results equal the
eager step's (the atomics that move bits there move them here too).

One step is kept: a new key, or the scene object's end, releases the
graph and its pool.  Keys that alternate never capture.

A replay runs no Python in the bounce.  The capture records the step's
spans and counters on a tape (``telemetry.taped``) and the launch
counters' increments of the kernels it captured; each replay adds the
launch counts, and while a profiler records the tape.  While a profiler
records, each call also counts its route: ``path.graph.capture`` (a call
that captured and then replayed), ``path.graph.replay`` or
``path.graph.eager``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import warnings
import weakref

import torch
from torch.autograd import forward_ad

from lumo_tpu_torch import config, telemetry

_last = None      # (scene weakref, key) of the previous keyed call
_step = None      # the captured :class:`_Step`, or None
_refused = None   # a key whose capture failed: it stays eager


def _leaves(x):
    """The leaves of a scene, depth first: its tensors and other values
    inside its fields, dicts, tuples and lists."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        for f in dataclasses.fields(x):
            yield from _leaves(getattr(x, f.name))
    elif isinstance(x, dict):
        for v in x.values():
            yield from _leaves(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _leaves(v)
    else:
        yield x


def _swap(x, table):
    """``x`` rebuilt with each tensor whose id ``table`` holds replaced."""
    if isinstance(x, torch.Tensor):
        return table.get(id(x), x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{
            f.name: _swap(getattr(x, f.name), table)
            for f in dataclasses.fields(x) if f.init})
    if isinstance(x, dict):
        return {k: _swap(v, table) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_swap(v, table) for v in x)
    return x


def _sig(x):
    """A leaf as a key: a tensor by its address, layout, dtype, device and
    whether it requires grad; a hashable value as itself; else its id."""
    if isinstance(x, torch.Tensor):
        return (x.data_ptr(), tuple(x.shape), x.stride(), x.dtype, x.device,
                x.requires_grad)
    try:
        hash(x)
    except TypeError:
        return id(x)
    return x


def _routes():
    """The functions a fixed-depth step dispatches its kernels through,
    which callers may patch (the plain routes of tests and smoke runs)."""
    from lumo_tpu_torch.accel import bvh_kernel, kd_kernel
    from lumo_tpu_torch.bsdf import table_grad
    return (bvh_kernel.closest_hit, bvh_kernel.any_hit, kd_kernel.closest_hit,
            kd_kernel.any_hit, table_grad.route, table_grad.reduce)


def key(scene, o, d, lam, ray_key, delta, depth, trace_prims):
    """What a fixed-depth call can observe that shapes its step: every
    leaf of the scene (each tensor's address, shape, dtype and whether it
    requires grad), the rays' lanes and dtypes, ``delta`` (its value, or
    a tensor's shape), the depth, ``trace_prims``, grad and inference
    mode, the float64 switch, deterministic algorithms and the kernels'
    routes."""
    rays = tuple((tuple(x.shape), x.dtype, x.device, x.requires_grad)
                 for x in (o, d, lam, ray_key))
    dl = (_sig(delta)[1:] if isinstance(delta, torch.Tensor)
          else ("value", delta))
    return (id(scene), tuple(_sig(x) for x in _leaves(scene)), rays, dl,
            int(depth), bool(trace_prims), torch.is_grad_enabled(),
            torch.is_inference_mode_enabled(), config.float_dtype(),
            torch.are_deterministic_algorithms_enabled(), _routes())


def eager_reason(scene, tensors, checkpoint):
    """Why a fixed-depth call over ``tensors`` (its rays and a tensor
    delta) must run eagerly whatever its key, or None."""
    if checkpoint:
        return "checkpoint"
    if (forward_ad._current_level >= 0
            or torch._C._functorch.peek_interpreter_stack() is not None):
        return "forward mode"
    dev = scene.device
    if dev.type != "cuda" or any(not isinstance(x, torch.Tensor)
                                 or x.device != dev for x in tensors):
        return "device"
    return None


def _launch_tables():
    """The kernels' launch counters (dicts of counts), which eager calls
    add to at each launch."""
    from lumo_tpu_torch.accel import bvh_kernel, kd_kernel
    from lumo_tpu_torch.bsdf import table_grad
    return (bvh_kernel.LAUNCHES, bvh_kernel.PLAIN_F64, kd_kernel.LAUNCHES,
            kd_kernel.PLAIN_F64, table_grad.LAUNCHES)


@contextlib.contextmanager
def _taped():
    """Tape the body's spans, counters and launch counts: yields a list
    that holds ``(telemetry tape, launch increments)`` once the body has
    run; the launch counters are set back, since a capture runs
    nothing."""
    tables = _launch_tables()
    before = [dict(t) for t in tables]
    out = []
    try:
        with telemetry.taped() as tape:
            yield out
    finally:
        inc = []
        for t, b in zip(tables, before):
            inc.append({k: n - b.get(k, 0) for k, n in t.items()
                        if n != b.get(k, 0)})
            for k in t:
                t[k] = b.get(k, 0)
        out.append((tape, inc))


def _replayed(tapes):
    """Add a replayed graph's launch counts, and its tape while a profiler
    records."""
    tape, inc = tapes
    for t, d in zip(_launch_tables(), inc):
        for k, n in d.items():
            t[k] += n
    telemetry.replay(tape)


def _static(x, grad):
    """A static copy of an input: a leaf that requires grad where ``x``
    does under grad mode."""
    s = x.detach().clone()
    return s.requires_grad_(True) if grad and x.requires_grad else s


class _Token:
    """Lives as long as a graphed forward's autograd node."""


class _Step:
    """One captured fixed-depth step: its graphs, its static inputs and
    outputs, the cotangent and gradient buffers of its backward, and the
    tapes of its forward and backward."""

    def __init__(self, k, fn, scene, args, opts, inputs):
        self.key = k
        self.scene = weakref.ref(scene, _scene_gone)
        grad = torch.is_grad_enabled()
        self.static_in = [_static(x, grad) for x in inputs]
        slots = {id(x): s for x, s in zip(inputs, self.static_in)}
        # the step's own view of the scene: static copies of its tensors
        # that require grad, every other tensor in place (kept alive here,
        # since the graphs read it)
        self.scene_static = _swap(scene, slots)
        args_static = [slots.get(id(a), a) if isinstance(a, torch.Tensor)
                       else a for a in args]
        self.fwd = torch.cuda.CUDAGraph()
        self.bwd = None
        with _taped() as tapes, torch.cuda.graph(self.fwd):
            self.out = fn(self.scene_static, *args_static, *opts)
        self.tapes_fwd = tapes[0]
        self.diff = [o.requires_grad for o in self.out]
        if any(self.diff):
            wrt = [s for s in self.static_in if s.requires_grad]
            self.grad_out = [torch.empty_like(o) for o in self.out
                             if o.requires_grad]
            self.bwd = torch.cuda.CUDAGraph()
            with _taped() as tapes, torch.cuda.graph(self.bwd,
                                                     pool=self.fwd.pool()):
                grads = torch.autograd.grad(
                    [o for o in self.out if o.requires_grad], wrt,
                    grad_outputs=self.grad_out, allow_unused=True)
            self.tapes_bwd = tapes[0]
            it = iter(grads)
            self.grad_in = [next(it) if s.requires_grad else None
                            for s in self.static_in]
        self.out = tuple(o.detach() for o in self.out)
        self.gen = 0           # forward replays so far
        self.waiting = None    # weakref to the token of a pending backward

    def pending(self) -> bool:
        """Whether a graphed forward's backward has yet to run (a replay
        would overwrite what it reads)."""
        return self.waiting is not None and self.waiting() is not None

    def forward(self, inputs):
        with torch.no_grad():
            for s, x in zip(self.static_in, inputs):
                s.copy_(x)
            self.fwd.replay()
            self.gen += 1
            _replayed(self.tapes_fwd)
            return tuple(o.clone() for o in self.out)

    def backward(self, gen, grads):
        if gen != self.gen:
            raise RuntimeError(
                "the graphed fixed-depth step was replayed after this "
                "forward, so its saved tensors are gone: run the backward "
                "before the next call")
        with torch.no_grad():
            for buf, g in zip(self.grad_out,
                              (g for g, d in zip(grads, self.diff) if d)):
                buf.copy_(g)
            self.bwd.replay()
            self.waiting = None
            _replayed(self.tapes_bwd)
            return tuple(None if g is None else g.clone()
                         for g in self.grad_in)

    def call(self, inputs):
        """The step's outputs at ``inputs``, replayed; through autograd
        where its backward was captured."""
        if self.bwd is None:
            return self.forward(inputs)
        return _Replay.apply(self, *inputs)


class _Replay(torch.autograd.Function):
    """A replayed forward whose backward is the replayed backward graph."""

    @staticmethod
    def forward(ctx, step, *inputs):
        out = step.forward(inputs)
        ctx.step, ctx.gen = step, step.gen
        ctx.token = _Token()
        step.waiting = weakref.ref(ctx.token)
        ctx.mark_non_differentiable(*(o for o, d in zip(out, step.diff)
                                      if not d))
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *grads):
        return (None, *ctx.step.backward(ctx.gen, grads))


def _scene_gone(ref):
    """Release the captured step when its scene object ends."""
    global _step
    if _step is not None and _step.scene is ref:
        _step = None


def _inputs(scene, args):
    """The tensors a graph reads from static copies: the call's tensor
    arguments, then the scene's tensors that require grad."""
    inputs = [x for x in args if isinstance(x, torch.Tensor)]
    return inputs + list({id(t): t for t in _leaves(scene)
                          if isinstance(t, torch.Tensor)
                          and t.requires_grad}.values())


def _route(scene, o, d, lam, ray_key, delta, depth, trace_prims,
           checkpoint):
    """("eager" | "capture" | "replay", the key or None)."""
    global _last, _step
    tensors = [o, d, lam, ray_key]
    if isinstance(delta, torch.Tensor):
        tensors.append(delta)
    if eager_reason(scene, tensors, checkpoint) is not None:
        _last = None
        return "eager", None
    k = key(scene, o, d, lam, ray_key, delta, depth, trace_prims)
    same = lambda ref_key: (ref_key is not None and ref_key[0]() is scene
                            and ref_key[1] == k)
    last, _last = _last, (weakref.ref(scene), k)
    if _step is not None and same((_step.scene, _step.key)):
        return ("eager" if _step.pending() else "replay"), k
    _step = None
    if same(last) and k != _refused:
        return "capture", k
    return "eager", k


def run(fn, scene, o, d, lam, ray_key, delta, depth, trace_prims,
        checkpoint):
    """``fn(scene, o, d, lam, ray_key, delta, depth, trace_prims,
    checkpoint)``, the fixed-depth step, eagerly or as a graph (see the
    module's docstring)."""
    global _step, _refused
    args = (o, d, lam, ray_key, delta)
    opts = (depth, trace_prims, checkpoint)
    mode, k = _route(scene, *args, *opts)
    if mode == "capture":
        stream = torch.cuda.current_stream()
        try:
            _step = _Step(k, fn, scene, args, opts, _inputs(scene, args))
        except RuntimeError as exc:
            # a failed capture may leave its side stream current
            torch.cuda.set_stream(stream)
            _refused = k
            warnings.warn(f"the fixed-depth step could not be captured as "
                          f"a CUDA graph and runs eagerly: {exc}")
            mode = "eager"
    if telemetry.on():
        telemetry.add("path.graph." + mode, 1)
    if mode == "eager":
        return fn(scene, *args, *opts)
    return _step.call(_inputs(scene, args))
