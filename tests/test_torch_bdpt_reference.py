"""The port's BDPT render of lumo's caustics scene against the
benchmark's plain BDPT reference (``benchmark/reference/bdpt.py``, a
frozen copy of the port's arithmetic that imports nothing of the port),
on the CPU at 16², 4 spp in 2-spp steps (the second step under the
adaptive Russian-roulette threshold the first left), the recipe at 1 and
2 subdivisions: every pixel equal.  Planted faults in the reference (the
t = 1 splats dropped, the glass evaluated as a mirror, the threshold
frozen) come out not correct by the benchmark's limit.  Under a profiler
the render records BDPT's spans and counters and its image is the same
bits as without one.  No JAX call."""
import os
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmark")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

from lumobench import cells, check, program  # noqa: E402
from reference import bdpt as ref  # noqa: E402
from reference import bdpt_bsdf  # noqa: E402

from lumo_tpu_torch import telemetry  # noqa: E402
from lumo_tpu_torch.color import uplift  # noqa: E402
from lumo_tpu_torch.renderer import Renderer  # noqa: E402

RES, SPP, STEP = 16, 4, 2
# (recipe subdivisions, recipe seed, render seed)
CASES = [(1, 7, 5), (2, 3, 2 ** 31 + 5), (1, 11, 4294967311)]
SPANS = ("bdpt.integrate", "bdpt.walk.light", "bdpt.walk.camera", "bdpt.s0",
         "bdpt.s1", "bdpt.t1", "bdpt.connect", "render.splat")


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    uplift.table(device="cpu")
    yield
    torch.set_num_threads(n)


def _config(subdiv, seed):
    config = cells._json("configs", "caustics.json")
    config["scene"].update(subdiv=subdiv, seed=seed)
    return config


_PORT = {}


def _port(case):
    """(groups, config, the port's image (P, 3)) of a case, rendered once
    in the module."""
    if case not in _PORT:
        subdiv, seed, render_seed = case
        config = _config(subdiv, seed)
        groups = cells.scene_groups(config)
        scene = program.build_scene(groups, "bvh", "cpu")
        cam = program.build_camera(config["camera"], (RES, RES), "cpu")
        r = (Renderer(scene, cam).samples(SPP).seed(render_seed)
             .integrator("bdpt").bdpt_depth(12).batch_samples(STEP))
        _PORT[case] = (groups, config, r, r.render(verbose=False))
    return _PORT[case]


def _reference(case):
    groups, config, _, _ = _port(case)
    return ref.render_pixels(ref.Scene(groups, "cpu"),
                             ref.Camera(config["camera"], (RES, RES), "cpu"),
                             SPP, case[2], np.arange(RES * RES),
                             bdpt_depth=12, batch=STEP).numpy()


@pytest.mark.parametrize("case", CASES)
def test_port_equals_the_reference(case):
    img = _port(case)[3].reshape(-1, 3)
    want = _reference(case)
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(img, want, rtol=1e-6, atol=0)


def _no_splats(fn):
    def strategy(*args):
        raster, color, mask = fn(*args)
        return raster, torch.zeros_like(color), torch.zeros_like(mask)
    return strategy


@pytest.mark.parametrize("fault", ["splats dropped", "glass as mirror",
                                   "frozen threshold"])
def test_planted_faults_are_not_correct(fault, monkeypatch):
    if fault == "splats dropped":
        monkeypatch.setattr(ref, "_strategy_t1", _no_splats(ref._strategy_t1))
    elif fault == "glass as mirror":
        monkeypatch.setitem(bdpt_bsdf.KINDS, "glass",
                            bdpt_bsdf.KINDS["mirror"])
    else:
        monkeypatch.setattr(ref, "_delta",
                            lambda stats: torch.full_like(stats["n"], 1e-5))
    img = _port(CASES[0])[3].reshape(-1, 3)
    limit = cells._json("traffic", "render.json")["limits"]["image_rel_l1"]
    assert check.image_rel_l1(img, _reference(CASES[0])) > limit


def test_spans_and_counters_under_a_profiler():
    """One 2-spp step at 8² (the profiler's own cost is most of it)."""
    res, spp = 8, 2
    groups, config, _, _ = _port(CASES[0])
    scene = program.build_scene(groups, "bvh", "cpu")
    cam = program.build_camera(config["camera"], (res, res), "cpu")
    r = (Renderer(scene, cam).samples(spp).seed(CASES[0][2])
         .integrator("bdpt").bdpt_depth(12))
    telemetry.reset()
    try:
        off = r.render(verbose=False)
        assert not any(k.startswith(("bdpt.", "render."))
                       for k in telemetry.snapshot()["spans"])
        with profile(activities=[ProfilerActivity.CPU]):
            on = r.render(verbose=False)
        snap = telemetry.snapshot()
    finally:
        telemetry.reset()
    np.testing.assert_array_equal(on.view(np.int32), off.view(np.int32))
    spans, c = snap["spans"], snap["counters"]
    for name in SPANS:
        assert spans[name]["n"] >= 1, name
    assert spans["bdpt.integrate"]["n"] == 1
    assert spans["bdpt.connect"]["n"] == 11
    # every connection's lanes: 11 s = 1, 11 t = 1, 11 x 11 general
    lanes = res * res * spp
    assert c["bdpt.connect.lanes"] == lanes * (11 + 11 + 11 * 11)
    assert 0 < c["bdpt.connect.live"] <= c["bdpt.connect.lanes"]
    assert 0 < c["bdpt.splats"] <= lanes * 11
