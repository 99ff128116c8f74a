"""Cells resolved by name: ``BENCHMARK.json``'s workload, its
configuration (``configs/<name>.json``), its traffic mix
(``traffic/<name>.json``), its scene recipe (``scenes/<recipe>.py``),
its reference (``reference/<name>.py``, or the ``reference`` package)
and the readers of its metrics (``metrics/<name>.py``).  Adding any of
them is adding a file and an entry; no file here names one."""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import inspect
import json
import os

from . import program

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_module(path: str):
    """A module from its file (names may hold dots)."""
    name = "bench_" + os.path.splitext(os.path.basename(path))[0].replace(
        ".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json(*parts):
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list        # [(metric entry, reader)]
    per_layer: list


def _reports(entry: dict, cell: str, e2e_names) -> bool:
    if "workloads" in entry:
        return cell in entry["workloads"]
    return entry.get("moves", entry["name"]) in e2e_names


def resolve(root: str, name: str) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json``."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = by_name[name]
    config = _json("configs", f"{w['config']}.json")
    traffic = _json("traffic", f"{w['traffic']}.json")
    reader = lambda m: load_module(os.path.join(HERE, "metrics",
                                                f"{m['name']}.py"))
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _reports(m, name, names)]
    return Cell(name, int(w["chips"]), config, traffic,
                [(m, reader(m)) for m in e2e],
                [(m, reader(m)) for m in layer])


def scene_groups(config: dict):
    """The raw scene groups of a configuration's recipe."""
    scene = dict(config["scene"])
    recipe = load_module(os.path.join(HERE, "scenes",
                                      f"{scene.pop('recipe')}.py"))
    return recipe.groups(scene)


def reference(config: dict):
    """The configuration's reference module: ``reference.<name>`` where
    it names one (``"reference": "<name>"``), else the ``reference``
    package, the path tracer."""
    name = config.get("reference")
    if name is None:
        return importlib.import_module("reference")
    if not (isinstance(name, str) and name.isidentifier()):
        raise ValueError(f"reference {name!r} is not a module name")
    return importlib.import_module(f"reference.{name}")


def admit(config: dict, kind: str, groups, ref) -> None:
    """Refuse, before anything is built, a cell whose configuration names
    what the program's harness does not drive (a ``render`` setting
    beyond ``program.RENDER_SETTINGS``, a material kind beyond
    ``program.MATERIAL_KINDS``) or what its reference ``ref`` does not
    declare: the integrator, a material kind of the groups, the traffic
    kind, or a ``render`` setting its ``render_pixels`` does not take."""
    render = config.get("render", {})
    kinds = {g["material"]["kind"] for g in groups}
    for what, named, known in (("render setting", set(render),
                                program.RENDER_SETTINGS),
                               ("material kind", kinds,
                                program.MATERIAL_KINDS)):
        for item in sorted(named - set(known)):
            raise ValueError(f"unknown {what} {item!r}: the harness "
                             f"drives {sorted(known)}")
    integrator = render.get("integrator", program.DEFAULT_INTEGRATOR)
    checks = [("integrator", {integrator}, ref.INTEGRATORS),
              ("material kind", kinds, ref.MATERIALS),
              ("traffic kind", {kind}, ref.TRAFFIC)]
    if kind == "render":
        # past scene, camera, spp, seed and pixels: the settings it takes
        takes = list(inspect.signature(ref.render_pixels).parameters)[5:]
        checks.append(("render setting", set(render), takes))
    for what, named, held in checks:
        for item in sorted(named - set(held)):
            raise ValueError(f"{what} {item!r} is not held by the reference "
                             f"{ref.__name__!r}, which holds {sorted(held)}")
