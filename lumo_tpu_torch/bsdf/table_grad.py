"""The backward of a per-lane read of a material table: the CUDA kernel
and its plain PyTorch version.

Every per-lane read of a material table goes through
``telemetry.gather(table, index)``, which is ``table[index]``.  Autograd's
backward of that is ``index_put_(accumulate=True)``, which on the card
sorts the indices and gives each distinct row to one warp that adds its
duplicates one after another: with 524,288 lanes over about 8 rows, about
13 ms a read on an H100, most of a gradient step (``PERF.md``).

``telemetry.gather`` hands :func:`gather` each read of a table that
requires grad, under grad mode.  The choice is made from the read alone
(:func:`route`): a float32 or float64 table on the card, small enough that
one copy per warp of a block fits its shared memory, read by one of the
two index forms below, is read through :class:`TableRead`, whose forward
is the same ``table[index]`` and whose backward is :func:`reduce`, the
hand-written deterministic reduction ``csrc/table_grad.cu`` (compiled with
nvcc for sm_90a at first use into ``build/``, bound with ctypes).  Every
other read is the plain ``table[index]``, and no new node is made.  While
a profiler records, each choice adds one to ``bsdf.table_grad.private`` or
``bsdf.table_grad.plain``.

Index forms: a row index (int64, any shape) into an (M, ...) table, and a
pair ``(rows, cols)`` of broadcastable int64 tensors into an (M, C) table
(``color/dense.py::sample_rows``: ``(rows[:, None], bins)`` into an
(M, 95) dense table).

:func:`route` alone decides whether a read fits the kernel, and
:func:`reduce` runs the kernel on what it accepted.  :func:`reduce_plain`
is autograd's own reduction, which the tests and ``chip_smoke.py`` hold
the kernel against.  The kernel's result is the same bits from run to run
and differs from :func:`reduce_plain`'s only by the order of its float
additions.
"""
from __future__ import annotations

import ctypes
import math

import torch

from lumo_tpu_torch import telemetry
from lumo_tpu_torch.accel import cuda_build
from lumo_tpu_torch.accel.cuda_build import ptr, raise_on, stream

WARPS = 8                  # warps of a block (the kernel takes it), each
                           # with its own copy of the table
SMEM_BYTES = 200 * 1024    # a block's shared memory the copies may take
BLOCKS_PER_SM = 4          # at most this many blocks of a launch an SM
DTYPES = {torch.float32: 0, torch.float64: 1}

# Kernel launches since the last reset, by index form: a row index into a
# table of one value a row ("rows_w1") or of more ("rows_wide"), or a pair
# of indices ("pair").  A call launches two kernels, one where it has no
# lanes; :func:`reduce` counts them and nothing else touches the dict.
LAUNCHES = {"rows_w1": 0, "rows_wide": 0, "pair": 0}

_VP, _CI, _CL = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
LIB = cuda_build.Library("table_grad", {
    "lumo_table_grad": [_CI, _VP, _VP, _CL, _CL, _VP, _CL, _CL, _CL, _CI,
                        _CL, _CL, _CI, _CI, _CI, _VP, _VP, _VP],
})


def index_pair(table, index):
    """``(i0, i1)`` of a read of ``table`` by one of the two index forms
    (``i1`` None for a row index), each an int64 tensor on the table's
    device, or None for any other index."""
    if isinstance(index, torch.Tensor) and table.ndim >= 1:
        xs = (index,)
    elif isinstance(index, tuple) and len(index) == 2 and table.ndim == 2:
        xs = index
    else:
        return None
    if not all(isinstance(x, torch.Tensor) and x.dtype == torch.int64
               and x.device == table.device for x in xs):
        return None
    return (index, None) if len(xs) == 1 else xs


def route(table, index):
    """:func:`index_pair` of a read that takes the kernel's backward: a
    float32 or float64 table on the card whose ``WARPS`` copies fit
    ``SMEM_BYTES``; None for a read that stays ``table[index]``."""
    if (not table.is_cuda or table.dtype not in DTYPES
            or not 0 < WARPS * table.numel() * table.element_size()
            <= SMEM_BYTES):
        return None
    return index_pair(table, index)


def gather(table, index):
    """``table[index]`` of a table that requires grad, read under grad
    mode: through :class:`TableRead` where :func:`route` allows, else the
    plain read; the choice is counted while a profiler records."""
    pair = route(table, index)
    if telemetry.on():
        telemetry.add("bsdf.table_grad." + ("plain" if pair is None
                                            else "private"), 1)
    return table[index] if pair is None else TableRead.apply(table, *pair)


def _read(table, i0, i1):
    return table[i0] if i1 is None else table[i0, i1]


class TableRead(torch.autograd.Function):
    """``table[i0]`` or ``table[i0, i1]``, whose backward is
    :func:`reduce` and whose forward-mode tangent is the tangent table
    read at the same index."""

    @staticmethod
    def forward(ctx, table, i0, i1):
        ctx.shape = table.shape
        ctx.save_for_backward(i0, i1)
        ctx.save_for_forward(i0, i1)
        return _read(table, i0, i1)

    @staticmethod
    def backward(ctx, g):
        i0, i1 = ctx.saved_tensors
        return reduce(g, ctx.shape, i0, i1), None, None

    @staticmethod
    def jvp(ctx, t_table, *_):
        i0, i1 = ctx.saved_tensors
        return _read(t_table, i0, i1)


def reduce_plain(g, shape, i0, i1=None):
    """The gradient (``shape``) of a read ``table[i0]`` or
    ``table[i0, i1]`` whose output's cotangent is ``g``: autograd's own
    ``index_put_(accumulate=True)`` into zeros."""
    index = (i0,) if i1 is None else (i0, i1)
    return torch.zeros(shape, dtype=g.dtype, device=g.device).index_put_(
        index, g, accumulate=True)


def _lane_grid(x, shape):
    """``x`` broadcast to ``shape`` as a 2-D (n, k) grid of lanes with k a
    power of two (the kernel splits a lane by shifts), a view wherever the
    shape allows (a broadcast dimension keeps stride 0)."""
    k = shape[-1] if len(shape) >= 2 else 1
    return x.expand(shape).reshape(-1, 1 if k & (k - 1) else k)


def reduce(g, shape, i0, i1=None):
    """:func:`reduce_plain`'s result by the kernel, for a read that
    :func:`route` accepted: ``g`` the float32 or float64 cotangent on the
    card, ``shape`` the table's."""
    if not g.is_cuda:
        raise ValueError(f"the kernel reads CUDA tensors, got {g.device}")
    if i1 is None:
        lead, width = i0.shape, math.prod(shape[1:])
        rows, cols = shape[0], 1
        form = "rows_w1" if width == 1 else "rows_wide"
    else:
        lead = torch.broadcast_shapes(i0.shape, i1.shape)
        rows, cols, width, form = shape[0], shape[1], 1, "pair"
    if tuple(g.shape) != tuple(lead) + tuple(shape[1 if i1 is None else 2:]):
        raise ValueError(f"cotangent {tuple(g.shape)} does not match the "
                         f"read of {tuple(shape)}")
    a = _lane_grid(i0, lead)
    b = None if i1 is None else _lane_grid(i1, lead)
    n, k = a.shape
    max_blocks = BLOCKS_PER_SM * torch.cuda.get_device_properties(
        g.device).multi_processor_count
    g = g.contiguous()
    partials = torch.empty(max_blocks * rows * cols * width, dtype=g.dtype,
                           device=g.device)
    out = torch.empty(shape, dtype=g.dtype, device=g.device)
    s1 = (0, 0) if b is None else b.stride()
    rc = LIB.load().lumo_table_grad(
        DTYPES.get(g.dtype, -1), ptr(g), ptr(a), *a.stride(),
        None if b is None else ptr(b), *s1, n * k, k.bit_length() - 1,
        rows, cols, width, WARPS, max_blocks, ptr(partials), ptr(out),
        stream(g.device))
    raise_on(rc, "table gradient")
    LAUNCHES[form] += 2 if n * k else 1
    return out
