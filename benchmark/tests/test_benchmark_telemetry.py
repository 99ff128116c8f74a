"""The readers of the program's own spans and counters
(``lumo_tpu_torch/telemetry.py``): their arithmetic on a hand-built
snapshot and trace, and None where the program records nothing, or has
no telemetry at all (a parent commit's program)."""
import sys

import pytest

from test_benchmark_harness import _reader, _run

READERS = ["first_query_s", "bounce_host_ms.render",
           "idle_in_bounce_share.render", "sync_wait_ms_per_step.render",
           "lane_occupancy.render", "rays_per_sample.render",
           "table_gathers_per_bounce.grad"]

SNAP = {"spans": {"setup.first_query": {"n": 2, "host_ns": 7_500_000_000,
                                        "self_ns": 7_000_000_000},
                  "path.bounce": {"n": 4, "host_ns": 300_000_000,
                                  "self_ns": 1_000_000},
                  "render.step": {"n": 2, "host_ns": 4_000_000_000,
                                  "self_ns": 1_000},
                  "sync.alive": {"n": 6, "host_ns": 30_000_000,
                                 "self_ns": 30_000_000},
                  "sync.readback": {"n": 1, "host_ns": 10_000_000,
                                    "self_ns": 10_000_000}},
        "counters": {"lanes.total": 20_000, "lanes.alive": 5_000,
                     "bsdf.table_gathers": 80}}


def _both(**kw):
    return _run("render", **kw), _run("grad", **kw)


@pytest.mark.parametrize("name", READERS)
def test_none_without_the_programs_telemetry(name, monkeypatch):
    import lumo_tpu_torch
    monkeypatch.delattr(lumo_tpu_torch, "telemetry", raising=False)
    monkeypatch.setitem(sys.modules, "lumo_tpu_torch.telemetry", None)
    for run in _both(traced_samples=1000):
        assert _reader(name).read(run) is None


@pytest.mark.parametrize("name", READERS)
def test_none_where_nothing_was_recorded(name, monkeypatch):
    from lumo_tpu_torch import telemetry
    monkeypatch.setattr(telemetry, "snapshot",
                        lambda: {"spans": {}, "counters": {}})
    for run in _both(traced_samples=1000):
        assert _reader(name).read(run) is None


def test_arithmetic_on_a_snapshot(monkeypatch):
    from lumo_tpu_torch import telemetry
    monkeypatch.setattr(telemetry, "snapshot", lambda: SNAP)
    render, grad = _both(traced_samples=1000)
    read = lambda name, run: _reader(name).read(run)
    assert read("first_query_s", render) == 7.0
    assert read("first_query_s", grad) == 7.0
    assert read("bounce_host_ms.render", render) == 75.0
    assert read("sync_wait_ms_per_step.render", render) == 20.0
    assert read("lane_occupancy.render", render) == 25.0
    assert read("rays_per_sample.render", render) == 5.0
    assert read("table_gathers_per_bounce.grad", grad) == 20.0
    for name in READERS[1:-1]:
        assert read(name, grad) is None
    assert read("table_gathers_per_bounce.grad", render) is None


def test_idle_in_bounce_share():
    from lumobench.trace import DeviceTrace
    dev = [("k", 0, 10), ("k", 20, 30), ("k", 60, 100)]
    host = [("lumo.path.bounce", 5, 25, []), ("lumo.path.nee", 8, 12, []),
            ("lumo.sync.alive", 30, 40, []), ("lumo.path.bounce", 50, 80, []),
            ("aten::mul", 0, 100, [])]
    # gaps: (10, 20) mid 15 in a bounce, (30, 60) mid 45 outside,
    # (100, 120) mid 110 outside
    run = _run("render", traces=[DeviceTrace(dev, host, 0, 120)])
    read = _reader("idle_in_bounce_share.render").read
    assert read(run) == pytest.approx(100.0 * 10 / 60)
    no_spans = DeviceTrace(dev, [("aten::mul", 0, 100, [])], 0, 120)
    assert read(_run("render", traces=[no_spans])) is None
    assert read(_run("render", traces=[])) is None
    assert read(_run("grad", traces=run.traces)) is None
