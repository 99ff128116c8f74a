"""The routing of per-lane material-table reads
(``lumo_tpu_torch/bsdf/table_grad.py``) on the CPU, at 256 lanes.

Off the card, or with no backward to take, ``telemetry.gather`` makes no
new node: the output's ``grad_fn`` is the indexing node of ``table[index]``
or None.  The module's plain reduction is autograd's own gradient of
``table[index]`` for both index forms.  While a profiler records, the
counters ``bsdf.table_grad.private`` and ``bsdf.table_grad.plain`` count
each path.  :class:`TableRead` itself, routed on the CPU with the plain
reduction as its backward, gives the read's values, gradient and
forward-mode tangent.  Any other index (int32, a new axis, a scalar, three
indices) keeps the plain read even where the route is open.  The kernel is held to the plain reduction on the
card in ``tests/test_torch_cuda.py``.  No JAX call."""
from unittest import mock

import pytest
import torch
from torch.autograd import forward_ad
from torch.profiler import ProfilerActivity, profile

from lumo_tpu_torch import telemetry
from lumo_tpu_torch.bsdf import table_grad
from lumo_tpu_torch.color import dense

LANES = 256
ROWS = 8


def _read(form, dtype=torch.float32):
    """(table, index) of one index form: a row index into an (8,) or
    (8, 4) table, or ``sample_rows``' pair into an (8, 95) dense table
    with bins clamped at both edges."""
    g = torch.Generator().manual_seed(5)
    rows = torch.randint(0, ROWS, (LANES,), generator=g)
    if form == "dense":
        table = torch.rand(ROWS, dense.DENSE_SAMPLES, generator=g,
                           dtype=dtype)
        bins = torch.randint(-3, dense.DENSE_SAMPLES + 3, (LANES, 4),
                             generator=g)
        return table, (rows[:, None],
                       torch.clamp(bins, 0, dense.DENSE_SAMPLES - 1))
    shape = (ROWS,) if form == "rows-w1" else (ROWS, 4)
    return torch.rand(shape, generator=g, dtype=dtype), rows


def _profiled_counts(fn):
    telemetry.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        fn()
    counters = telemetry.snapshot()["counters"]
    telemetry.reset()
    return {k: counters.get("bsdf.table_grad." + k, 0)
            for k in ("private", "plain")}


def _no_node_off_cuda(form):
    table, index = _read(form)
    leaf = table.clone().requires_grad_(True)
    out = telemetry.gather(leaf, index)
    assert type(out.grad_fn).__name__ == "IndexBackward0"
    assert torch.equal(out.detach(), table[index])


def _no_node_without_grad(form):
    table, index = _read(form)
    leaf = table.clone().requires_grad_(True)
    with mock.patch.object(table_grad, "route", table_grad.index_pair):
        with torch.no_grad():
            assert telemetry.gather(leaf, index).grad_fn is None
        assert telemetry.gather(table, index).grad_fn is None
        ints = telemetry.gather((table * 100).long(), index)
        assert ints.grad_fn is None and ints.dtype == torch.int64


def _plain_equals_autograd(form):
    table, index = _read(form)
    leaf = table.clone().requires_grad_(True)
    out = leaf[index]
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(9))
    want, = torch.autograd.grad(out, leaf, g)
    got = table_grad.reduce_plain(g, table.shape,
                                  *table_grad.index_pair(table, index))
    assert torch.equal(got, want)


def _counters(form):
    table, index = _read(form)
    leaf = table.clone().requires_grad_(True)
    assert _profiled_counts(lambda: telemetry.gather(leaf, index)) == {
        "private": 0, "plain": 1}
    with mock.patch.object(table_grad, "route", table_grad.index_pair):
        assert _profiled_counts(lambda: telemetry.gather(leaf, index)) == {
            "private": 1, "plain": 0}
        # reads with no backward count on neither path
        assert _profiled_counts(lambda: telemetry.gather(table, index)) == {
            "private": 0, "plain": 0}
    # no profiler, no count
    telemetry.reset()
    telemetry.gather(leaf, index)
    assert "bsdf.table_grad.plain" not in telemetry.snapshot()["counters"]


def _function_on_cpu(form):
    table, index = _read(form, torch.float64)
    leaf = table.clone().requires_grad_(True)
    with mock.patch.object(table_grad, "route", table_grad.index_pair), \
            mock.patch.object(table_grad, "reduce", table_grad.reduce_plain):
        out = telemetry.gather(leaf, index)
        assert type(out.grad_fn).__name__ == "TableReadBackward"
        assert torch.equal(out.detach(), table[index])
        g = torch.randn(out.shape, dtype=torch.float64,
                        generator=torch.Generator().manual_seed(9))
        got, = torch.autograd.grad(out, leaf, g)
        ref = leaf.detach().clone().requires_grad_(True)
        want, = torch.autograd.grad(ref[index], ref, g)
        assert torch.equal(got, want)
        tangent = torch.randn(table.shape, dtype=torch.float64,
                              generator=torch.Generator().manual_seed(11))
        with forward_ad.dual_level():
            dual = forward_ad.make_dual(leaf, tangent)
            _, t_out = forward_ad.unpack_dual(telemetry.gather(dual, index))
        assert torch.equal(t_out, tangent[index])
        assert torch.autograd.gradcheck(
            lambda x: telemetry.gather(x, index), (leaf,),
            check_forward_ad=True)


def _other_indices_stay_plain(form):
    table, index = _read(form)
    rows = index if form.startswith("rows") else index[0][:, 0]
    others = [rows.int(), (rows, None), (None, rows), (rows, rows.int()),
              (rows, 1), (rows, rows, rows)]
    leaf = table.clone().requires_grad_(True)
    with mock.patch.object(table_grad, "route", table_grad.index_pair):
        for other in others:
            try:
                want = table[other]
            except IndexError:
                continue
            assert table_grad.index_pair(table, other) is None
            out = telemetry.gather(leaf, other)
            assert type(out.grad_fn).__name__ == "IndexBackward0"
            assert torch.equal(out.detach(), want)


CHECKS = {"no_node_off_cuda": _no_node_off_cuda,
          "no_node_without_grad": _no_node_without_grad,
          "plain_equals_autograd": _plain_equals_autograd,
          "counters": _counters,
          "function_on_cpu": _function_on_cpu,
          "other_indices_stay_plain": _other_indices_stay_plain}


@pytest.mark.parametrize("form", ["rows-w1", "rows-w4", "dense"])
@pytest.mark.parametrize("check", sorted(CHECKS))
def test_table_read_routing(check, form):
    CHECKS[check](form)
