"""What a configuration may name: its renderer settings, its material
kinds and its reference.  The four cells call the port as they did
before any of these existed; a configuration that names what its
reference does not hold is refused before the scene is built; one that
names BDPT, glass and a mirror under a reference that holds them reaches
the port's BDPT."""
import functools
import inspect
import json
import sys
import types
from unittest import mock

import numpy as np
import pytest
import torch

from conftest import tiny

WORKLOADS = ["blob327k.render", "cornell.grad", "blob327k.grad",
             "cornell.render"]
SEED = 4294967311


def _calls_before(spec):
    """The Material constructor and its arguments that each spec of
    today's scenes was built with before configurations could name any
    constructor (lambertian, diffuse, metal and light, positionally)."""
    from lumo_tpu_torch.color import uplift
    kind = spec["kind"]
    if kind == "lambertian":
        return kind, (spec["kd"],), {}
    if kind == "diffuse":
        return kind, (spec["kd"],), {}
    if kind == "metal":
        return kind, (spec["ks"], spec["roughness"], spec["eta"],
                      spec["k"]), {}
    assert kind == "light"
    ke = spec["ke"]
    if isinstance(ke, dict):
        ke = uplift.from_srgb8(*ke["srgb8"]).reshape(4)
    return kind, (ke,), dict(scale=float(spec.get("scale", 1.0)),
                             illuminant=spec.get("illuminant", "D65"),
                             two_sided=bool(spec.get("two_sided", False)))


def _bound(kind, args, kwargs):
    from lumo_tpu_torch.scene.materials import Material
    b = inspect.signature(getattr(Material, kind)).bind(*args, **kwargs)
    b.apply_defaults()
    return kind, dict(b.arguments)


def _same(a, b):
    assert a[0] == b[0] and a[1].keys() == b[1].keys(), (a, b)
    for k in a[1]:
        x, y = a[1][k], b[1][k]
        assert type(x) is type(y), (k, x, y)
        assert np.array_equal(np.asarray(x), np.asarray(y)), (k, x, y)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cells_make_the_same_port_calls(workload):
    """The same Material constructors with the same arguments, and no
    Renderer call beyond samples, seed and render."""
    from lumo_tpu_torch.renderer import Renderer
    from lumo_tpu_torch.scene.materials import Material
    from lumobench import cells, program, traffic
    from lumobench.trace import Spans
    made, driven, depth = [], [], [0]

    def ctor(kind, real):
        @functools.wraps(real)
        def make(*a, **kw):
            made.append(_bound(kind, a, kw))
            return real(*a, **kw)
        return staticmethod(make)

    def method(name, real):
        @functools.wraps(real)
        def call(self, *a, **kw):
            if not depth[0]:            # the harness's calls, not its own
                driven.append(name)
            depth[0] += 1
            try:
                return real(self, *a, **kw)
            finally:
                depth[0] -= 1
        return call

    cell = tiny(workload)
    groups = cells.scene_groups(cell.config)
    dev = torch.device("cpu")
    patches = [mock.patch.object(Material, k, ctor(k, getattr(Material, k)))
               for k in program.MATERIAL_KINDS]
    patches += [mock.patch.object(Renderer, name, method(name, f))
                for name, f in vars(Renderer).items()
                if callable(f) and not name.startswith("_")]
    for p in patches:
        p.start()
    try:
        work = traffic.workload(cell.config, cell.traffic, groups, SEED, dev,
                                Spans(dev))
        work.build()
        work.run_unit(0)
    finally:
        for p in patches:
            p.stop()
    before = [_bound(*_calls_before(g["material"])) for g in groups]
    assert len(made) == len(before)
    for a, b in zip(made, before):
        _same(a, b)
    kind = cell.traffic["kind"]
    assert driven == (["samples", "seed", "render"] if kind == "render"
                      else [])


def test_explicit_path_integrator_is_the_default():
    from lumobench import cells, program
    cell = tiny("cornell.render")
    scene = program.build_scene(cells.scene_groups(cell.config), "bvh",
                                "cpu")
    cam = program.build_camera(cell.config["camera"], (16, 16), "cpu")
    default = program.render_pass(scene, cam, 2, SEED)
    explicit = program.render_pass(scene, cam, 2, SEED, integrator="path")
    assert default.tobytes() == explicit.tobytes()


def _srgb8():
    from lumo_tpu_torch.color import uplift
    return uplift.from_srgb8(252, 201, 138).reshape(4)


@pytest.mark.parametrize("spec,direct", [
    ({"kind": "glass"}, lambda M: M.glass()),
    ({"kind": "mirror"}, lambda M: M.mirror()),
    ({"kind": "transparent", "tf": [0.9, 0.8, 0.7], "roughness": 0.1,
      "eta": 1.5}, lambda M: M.transparent([0.9, 0.8, 0.7], 0.1, 1.5)),
    ({"kind": "lambertian", "kd": [0.5, 0.4, 0.3]},
     lambda M: M.lambertian([0.5, 0.4, 0.3])),
    ({"kind": "light", "ke": {"srgb8": [252, 201, 138]}, "scale": 2.0},
     lambda M: M.light(_srgb8(), scale=2.0)),
], ids=["glass", "mirror", "transparent", "lambertian", "light-srgb8"])
def test_material_spec_builds_the_constructors_row(spec, direct):
    from lumo_tpu_torch.scene.materials import Material, pack_materials
    from lumobench import program
    got = pack_materials([program._material(spec)])
    want = pack_materials([direct(Material)])
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        assert got[k].tobytes() == want[k].tobytes(), k


@pytest.mark.parametrize("spec,match", [
    ({"kind": "velvet"}, "unknown material kind 'velvet'"),
    ({"kind": "glass", "eta": 1.5}, r"'glass' takes no \['eta'\]"),
    ({"kind": "diffuse", "kd": [1, 1, 1], "kd_tex": 0},
     r"'diffuse' takes no \['kd_tex'\]"),
    ({"kind": "lambertian", "spec": [1, 1, 1]},
     r"'lambertian' takes no \['spec'\]"),
])
def test_material_spec_refused(spec, match):
    from lumobench import program
    with pytest.raises(ValueError, match=match):
        program._material(spec)


def _stub(name, integrators, materials, traffic):
    """A reference module that declares what it holds and computes
    nothing."""
    mod = types.ModuleType(f"reference.{name}")
    mod.INTEGRATORS = frozenset(integrators)
    mod.MATERIALS = frozenset(materials)
    mod.TRAFFIC = frozenset(traffic)

    def render_pixels(scene, camera, spp, seed, pixels, integrator="bdpt",
                      bdpt_depth=None):
        raise AssertionError("the stub computes nothing")
    mod.render_pixels = render_pixels
    return mod


def _boxes(kinds):
    """Groups edit: the Cornell box's two boxes (its last two groups)
    made of the given kinds."""
    def edit(groups):
        for g, kind in zip(groups[-2:], kinds):
            g["material"] = {"kind": kind}
        return groups
    return edit


CORNELL_KINDS = ["lambertian", "light"]


@pytest.mark.parametrize("workload,render,edit,stub,match", [
    ("cornell.render", {"integrator": "bdpt"}, None, None,
     "integrator 'bdpt' is not held by the reference 'reference'"),
    ("cornell.render", {}, _boxes(["glass", "mirror"]), None,
     "material kind 'glass' is not held by the reference 'reference'"),
    ("cornell.grad", {}, None,
     _stub("render_only", ["path"], CORNELL_KINDS, ["render"]),
     "traffic kind 'grad' is not held by the reference "
     "'reference.render_only'"),
    ("cornell.render", {"tone_map": "aces"}, None, None,
     "unknown render setting 'tone_map'"),
    ("cornell.render", {}, _boxes(["velvet", "lambertian"]), None,
     "unknown material kind 'velvet'"),
    ("cornell.render", {"bdpt_depth": 4}, None, None,
     "render setting 'bdpt_depth' is not held by the reference "
     "'reference'"),
], ids=["integrator", "material-kind", "traffic-kind", "render-key",
        "unknown-kind", "render-setting"])
def test_refused_before_the_scene_is_built(monkeypatch, workload, render,
                                           edit, stub, match):
    from lumobench import cells, program, window
    cell = tiny(workload)
    if render:
        cell.config["render"] = render
    if stub is not None:
        cell.config["reference"] = stub.__name__.split(".")[1]
        monkeypatch.setitem(sys.modules, stub.__name__, stub)
    if edit is not None:
        groups = cells.scene_groups
        monkeypatch.setattr(cells, "scene_groups",
                            lambda config: edit(groups(config)))

    def never(*a, **kw):
        raise AssertionError("the scene was built")
    monkeypatch.setattr(program, "build_scene", never)
    monkeypatch.setattr(program, "build_camera", never)
    with pytest.raises(ValueError, match=match):
        window.run_cell(cell, SEED, 0.0, False, torch.device("cpu"), 0.0)


def test_reference_name_is_a_module_name():
    from lumobench import cells
    with pytest.raises(ValueError, match="not a module name"):
        cells.reference({"reference": "../render"})


def test_bdpt_configuration_reaches_the_ports_bdpt(tmp_path, monkeypatch):
    """A configuration outside BENCHMARK.json: BDPT of 4 vertices over a
    glass and a mirror box, under a stub reference that declares them;
    ``program.render_pass`` runs the port's BDPT at 8x8 on the CPU."""
    from lumo_tpu_torch.renderer import Renderer
    from lumobench import cells, traffic
    from lumobench.trace import Spans
    base = tiny("cornell.render")
    path = tmp_path / "caustics_stub.json"
    path.write_text(json.dumps({
        "scene": {"recipe": "cornell_box"},
        "camera": base.config["camera"], "resolution": 8, "render_spp": 1,
        "accel": "bvh", "render": {"integrator": "bdpt", "bdpt_depth": 4},
        "reference": "bdpt_stub"}))
    config = json.loads(path.read_text())
    stub = _stub("bdpt_stub", ["bdpt"], CORNELL_KINDS + ["glass", "mirror"],
                 ["render"])
    monkeypatch.setitem(sys.modules, stub.__name__, stub)
    groups = _boxes(["glass", "mirror"])(cells.scene_groups(config))
    held = []
    real = Renderer.render

    def render(self, *a, **kw):
        held.append((self._integrator, self._bdpt_depth))
        return real(self, *a, **kw)
    monkeypatch.setattr(Renderer, "render", render)
    dev = torch.device("cpu")
    work = traffic.workload(config, base.traffic, groups, SEED, dev,
                            Spans(dev))
    assert work.ref is stub
    work.build()
    work.run_unit(0)
    assert held == [("bdpt", 4)]
    img = work.records[0]["image"]
    assert img.shape == (8, 8, 3) and np.isfinite(img).all()
    assert img.sum() > 0
