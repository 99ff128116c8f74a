"""The reader of the program's table-gradient counters
(``bsdf.table_grad.private`` and ``.plain``, ``lumo_tpu_torch/bsdf/
table_grad.py``): its arithmetic on a hand-built snapshot, and None in a
render run, where the program counts neither, or where the program has
no telemetry at all."""
import sys

import pytest

from test_benchmark_harness import _reader, _run

NAME = "table_grad_private_share.grad"


def _snap(counters):
    return lambda: {"spans": {}, "counters": counters}


@pytest.mark.parametrize("counters,share", [
    ({"bsdf.table_grad.private": 240}, 100.0),
    ({"bsdf.table_grad.private": 30, "bsdf.table_grad.plain": 10}, 75.0),
    ({"bsdf.table_grad.plain": 5}, 0.0),
    ({"bsdf.table_gathers": 240}, None),
    ({}, None)])
def test_share_on_a_snapshot(counters, share, monkeypatch):
    from lumo_tpu_torch import telemetry
    monkeypatch.setattr(telemetry, "snapshot", _snap(counters))
    assert _reader(NAME).read(_run("grad")) == share
    assert _reader(NAME).read(_run("render")) is None


def test_none_without_the_programs_telemetry(monkeypatch):
    import lumo_tpu_torch
    monkeypatch.delattr(lumo_tpu_torch, "telemetry", raising=False)
    monkeypatch.setitem(sys.modules, "lumo_tpu_torch.telemetry", None)
    assert _reader(NAME).read(_run("grad")) is None
