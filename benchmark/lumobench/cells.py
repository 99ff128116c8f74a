"""Cells resolved by name: ``BENCHMARK.json``'s workload, its
configuration (``configs/<name>.json``), its traffic mix
(``traffic/<name>.json``), its scene recipe (``scenes/<recipe>.py``) and
the readers of its metrics (``metrics/<name>.py``).  Adding any of them
is adding a file and an entry; no file here names one."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

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
