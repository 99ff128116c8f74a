"""The reader of the program's graphed-step counters
(``path.graph.capture``, ``.replay`` and ``.eager``, ``lumo_tpu_torch/
integrators/graph_step.py``): its arithmetic on a hand-built snapshot,
and None in a render run, where the program counts none of them, or
where the program has no telemetry at all."""
import sys

import pytest

from test_benchmark_harness import _reader, _run

NAME = "graphed_step_share.grad"


def _snap(counters):
    return lambda: {"spans": {}, "counters": counters}


@pytest.mark.parametrize("counters,share", [
    ({"path.graph.capture": 1, "path.graph.replay": 1}, 100.0),
    ({"path.graph.replay": 2}, 100.0),
    ({"path.graph.capture": 1, "path.graph.eager": 1}, 50.0),
    ({"path.graph.eager": 2}, 0.0),
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
