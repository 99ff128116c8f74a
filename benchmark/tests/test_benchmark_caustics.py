"""The caustics configuration under BDPT (``caustics.render``): the cell
resolves and its reference takes it, the recipe is the port's example
scene, a CPU rehearsal comes out correct with and without a trace, and
the readers of BDPT's spans and counters give the right numbers."""
import argparse
import json
import os
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT
from test_benchmark_harness import _reader, _run

READERS = ["bdpt_connect_live_share.render",
           "bdpt_unbatched_host_share.render"]


def test_cell_resolves_and_is_admitted():
    from lumobench import cells
    cell = cells.resolve(ROOT, "caustics.render")
    assert cell.config["render"] == {"integrator": "bdpt", "bdpt_depth": 12}
    ref = cells.reference(cell.config)
    assert ref.__name__ == "reference.bdpt"
    cells.admit(cell.config, cell.traffic["kind"],
                cells.scene_groups(cell.config), ref)
    names = {m["name"] for m, _ in cell.per_layer}
    assert set(READERS) <= names
    assert {"idle_share.render", "device_ops_per_ksample.render",
            "k2_roofline.render"} <= names
    assert {m["name"] for m, _ in cell.end_to_end} == {
        "render_samples_per_s", "peak_gib", "setup_s"}


def test_recipe_is_the_ports_example_scene():
    """The recipe's triangles, normals and material rows are those the
    port's ``examples/caustics.py`` builds (the stand-in at seed 7)."""
    import torch
    from lumobench import cells, program
    from lumo_tpu_torch.examples import caustics
    config = cells.resolve(ROOT, "caustics.render").config
    got = program.build_scene(cells.scene_groups(config), config["accel"],
                              "cpu")
    args = argparse.Namespace(res=16, spp=1, cpu=True, accel="bvh")
    want = caustics.make(args).scene
    assert got.n_tris == want.n_tris == 10_252
    for k in ("tri_a", "tri_b", "tri_c", "tri_na", "tri_nb", "tri_nc",
              "tri_mat", "light_prim"):
        assert torch.equal(getattr(got, k), getattr(want, k)), k
    for k, v in want.materials.items():
        assert torch.equal(got.materials[k], v), k


@pytest.mark.parametrize("trace", [0, 1])
def test_rehearsal_is_correct(trace):
    out = subprocess.run(
        [sys.executable, "benchmark/rehearse.py", "--workload",
         "caustics.render", "--res", "16", "--subdiv", "2", "--trace",
         str(trace)], capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["attempted"] >= 1
    if trace:
        assert set(READERS) <= set(line["metrics"])
    else:
        assert "render_samples_per_s" in line["metrics"]


SNAP = {"spans": {"bdpt.integrate": {"n": 2, "host_ns": 1_000_000,
                                     "self_ns": 100_000},
                  "bdpt.s0": {"n": 2, "host_ns": 50_000, "self_ns": 50_000},
                  "bdpt.s1": {"n": 2, "host_ns": 200_000, "self_ns": 150_000},
                  "bdpt.t1": {"n": 2, "host_ns": 100_000, "self_ns": 100_000},
                  "bdpt.connect": {"n": 22, "host_ns": 400_000,
                                   "self_ns": 400_000}},
        "counters": {"bdpt.connect.lanes": 8_000, "bdpt.connect.live": 2_000,
                     "bdpt.splats": 30}}


def test_readers_on_a_snapshot(monkeypatch):
    from lumo_tpu_torch import telemetry
    monkeypatch.setattr(telemetry, "snapshot", lambda: SNAP)
    render, grad = _run("render"), _run("grad")
    assert _reader(READERS[0]).read(render) == 25.0
    assert _reader(READERS[1]).read(render) == pytest.approx(30.0)
    for name in READERS:
        assert _reader(name).read(grad) is None


@pytest.mark.parametrize("name", READERS)
def test_readers_none_without_the_spans(name, monkeypatch):
    from lumo_tpu_torch import telemetry
    monkeypatch.setattr(telemetry, "snapshot",
                        lambda: {"spans": {}, "counters": {}})
    assert _reader(name).read(_run("render")) is None
    import lumo_tpu_torch
    monkeypatch.delattr(lumo_tpu_torch, "telemetry", raising=False)
    monkeypatch.setitem(sys.modules, "lumo_tpu_torch.telemetry", None)
    assert _reader(name).read(_run("render")) is None


def test_reference_loads_nothing_of_the_port():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import reference.bdpt\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'lumo_tpu_torch', 'lumo_tpu', 'jax'}))" % BENCH)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"
    assert os.path.exists(os.path.join(BENCH, "scenes", "caustics_box.py"))
