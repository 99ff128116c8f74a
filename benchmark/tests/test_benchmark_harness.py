"""The harness: cells resolve by name, BENCHMARK.json keeps the
contract's shapes, the metric arithmetic, and what the benchmark may
import."""
import ast
import json
import os
import re
import subprocess
import sys
import time
import types

import pytest

from conftest import BENCH, ROOT, tiny

FORBIDDEN = {"jax", "jaxlib", "flax", "lumo_tpu"}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("workload", [w["name"] for w in bench()["workloads"]])
def test_cell_resolves_by_name(workload):
    from lumobench import cells
    cell = cells.resolve(ROOT, workload)
    assert cell.chips == 1
    assert cell.traffic["kind"] in ("render", "grad")
    assert os.path.exists(os.path.join(
        BENCH, "scenes", f"{cell.config['scene']['recipe']}.py"))
    names = [m["name"] for m, _ in cell.end_to_end]
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    for _, reader in cell.end_to_end + cell.per_layer:
        assert callable(reader.read)
    for m, _ in cell.per_layer:
        assert m["moves"] in names


def test_benchmark_json_shapes():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"]
    assert 1 <= b["run_seconds"] <= 51
    configs = {c["name"] for c in b["configs"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and os.path.exists(
            os.path.join(ROOT, c["file"]))
        assert NAME.match(c["name"]) and len(c["why"]) <= 200
    used = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["config"] in configs
        assert os.path.exists(os.path.join(BENCH, "traffic",
                                           w["traffic"] + ".json"))
        assert w["chips"] == 1 and len(w["why"]) <= 200
        used.add(w["config"])
    assert used == configs
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert set(e2e) == {"render_samples_per_s", "grad_samples_per_s",
                        "peak_gib", "setup_s"}
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert os.path.exists(os.path.join(BENCH, "metrics",
                                           m["name"] + ".py"))
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert w in cells
            assert "workloads" not in e2e[m["moves"]] \
                or w in e2e[m["moves"]]["workloads"]


def test_busy_union_and_gaps():
    from lumobench.trace import DeviceTrace, busy_ns, idle_gaps
    iv = [(0, 10), (5, 15), (20, 30), (25, 26), (40, 41)]
    assert busy_ns(iv) == 15 + 10 + 1
    assert busy_ns([]) == 0
    assert idle_gaps(iv, 0, 50) == [(15, 20), (30, 40), (41, 50)]
    t = DeviceTrace([("k", a, b) for a, b in iv],
                    [("aten::mul", 14, 22, []), ("bench.unit", 0, 50, []),
                     ("Activity Buffer Request", 30, 40, [])], 0, 50)
    assert t.busy_s == 26e-9 and t.window_s == 50e-9
    assert t.top_ops()[0] == ["k", 32e-9]          # summed, not a union
    assert t.top_gaps() == [["bench.unit", 10e-9], ["bench.unit", 9e-9],
                            ["aten::mul", 5e-9]]


def _reader(name):
    from lumobench.cells import load_module
    return load_module(os.path.join(BENCH, "metrics", name + ".py"))


def _run(kind, **kw):
    from lumobench.trace import Spans
    from lumobench.window import Run
    run = Run(kind, Spans("cpu"))
    run.__dict__.update(kw)
    return run


def test_rates_and_spans():
    run = _run("render", samples=3_670_016, window_s=2.0, setup_s=7.5,
               peak_bytes=3 * 2 ** 30)
    assert _reader("render_samples_per_s").read(run) == 1_835_008.0
    assert _reader("grad_samples_per_s").read(run) is None
    assert _reader("peak_gib").read(run) == 3.0
    assert _reader("setup_s").read(run) == 7.5
    g = _run("grad")
    g.spans.times.update(forward=[0.2, 0.4], backward=[1.0],
                         scene_build=[0.5])
    assert _reader("fwd_ms_per_step.grad").read(g) == pytest.approx(300.0)
    assert _reader("bwd_ms_per_step.grad").read(g) == pytest.approx(1000.0)
    assert _reader("scene_build_s").read(g) == 0.5
    assert _reader("fwd_ms_per_step.grad").read(run) is None


def test_k2_bytes_and_roofline():
    from lumobench import peaks
    from lumobench.trace import DeviceTrace
    shapes = [[7, 4, 4], [9, 3, 4], [9, 3], [9, 3], [9, 3], [], [1000, 3],
              [1000, 3], [1000]]
    host = [("lumo_tpu_torch::bvh_closest", 0, 1, shapes),
            ("lumo_tpu_torch::bvh_any", 2, 3, shapes),
            ("aten::mul", 3, 4, [[1000, 3]])]
    assert peaks.k2_bytes(host) == 1000 * (28 + 12) + 1000 * (28 + 1)
    name = ("void (anonymous namespace)::traverse<false, false, false>"
            "(float4 const*)")
    assert peaks.is_k2_kernel(name)
    assert not peaks.is_k2_kernel("void (anonymous namespace)::kd_traverse"
                                  "<false>(int2 const*)")
    need = 69_000 / peaks.HBM_BYTES_PER_S
    dev = [(name, 0, 100), ("kd_traverse<false>", 120, 150)]
    run = _run("render", traces=[DeviceTrace(dev, host, 0, 200)],
               traced_samples=1000)
    assert _reader("k2_roofline.render").read(run) == pytest.approx(
        100.0 * need / 100e-9)
    assert _reader("idle_share.render").read(run) == pytest.approx(35.0)
    assert _reader("device_ops_per_ksample.render").read(run) == 2.0
    assert _reader("k2_roofline.render").read(_run("grad", traces=[])) is None


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and not node.level:
            yield node.module


def _sources(*parts):
    top = os.path.join(BENCH, *parts)
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_jax_or_jax_package_imported():
    """Whole top-level names: lumo_tpu_torch passes, lumo_tpu does not."""
    for path in _sources():
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)
    for path in _sources("reference"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert "lumo_tpu_torch" not in tops, path


def test_rehearsal_loads_nothing_forbidden():
    code = ("import sys; sys.argv = ['x']; sys.path[:0] = [%r, %r]\n"
            "import rehearse, run\n"
            "rehearse.rehearse('blob327k.grad', seconds=0.0, res=8)\n"
            "tops = {m.split('.')[0] for m in sys.modules}\n"
            "print(sorted(tops & %r), run.forbidden_modules())\n"
            % (BENCH, ROOT, FORBIDDEN))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[] []"


def test_reference_loads_nothing_of_the_port():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import reference.render, reference.scene\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'lumo_tpu_torch', 'lumo_tpu', 'jax'}))" % BENCH)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"


def test_run_without_a_card_prints_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the run would measure")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "cornell.render",
         "--seed", "4294967311", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert out.returncode != 0 and out.stdout == ""


def test_checkout_without_the_port_fails(tmp_path):
    """Only BENCHMARK.json and the benchmark's files: no result."""
    import shutil
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path[:0] = [%r]\n"
            "import rehearse; print(rehearse.rehearse('cornell.render'))"
            % str(tmp_path / "benchmark"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=tmp_path, timeout=120)
    assert out.returncode != 0 and "correct" not in out.stdout


@pytest.mark.cuda
def test_one_run_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "cornell.render",
         "--seed", "4294967311", "--seconds", "2", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=360)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "check"
    assert time.perf_counter() - t0 < 360
