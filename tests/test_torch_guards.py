"""Guards on the port's boundaries: lumo_tpu_torch (its host I/O
included), chip_smoke.py and the ranks of the multi-process tests
(tests/_torch_shard_worker.py) import neither JAX, nor anything of lumo_tpu,
nor PIL (the port needs torch, numpy and the standard library only), and
the entry points run on the card unless the caller names another
device."""
import os
import subprocess
import sys

import pytest
import torch

from _torch_port import SCENE_FIELDS
from lumo_tpu_torch.camera import build_camera
from lumo_tpu_torch.renderer import Renderer
from lumo_tpu_torch.scene import scene as tscene
from lumo_tpu_torch.scene.cornell import empty_box
from lumo_tpu_torch.scene.materials import Material

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
sys.modules["jax"] = None            # any `import jax` now raises
sys.modules["PIL"] = None            # and any `import PIL`
import lumo_tpu_torch
names = [m.name for m in pkgutil.walk_packages(lumo_tpu_torch.__path__,
                                               "lumo_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
sys.path.insert(0, "tests")
import _torch_shard_worker
import os, tempfile
import numpy as np
from lumo_tpu_torch import film           # its PNG writer runs without PIL
with tempfile.TemporaryDirectory() as tmp:
    film.save_png(np.zeros((2, 2, 3)), os.path.join(tmp, "x.png"))
leaked = sorted(m for m in sys.modules
                if m == "lumo_tpu" or m.startswith("lumo_tpu."))
assert not leaked, leaked
for banned in ("jax", "PIL"):
    assert banned not in sys.modules or sys.modules[banned] is None, banned
assert {"lumo_tpu_torch.io.obj", "lumo_tpu_torch.io.image"} <= set(names)
print(len(names))
"""


def test_port_imports_neither_jax_nor_lumo_tpu():
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 45     # every module was imported


def _box():
    return empty_box((0.9, 0.9, 0.9), Material.diffuse((0.8, 0.2, 0.2)),
                     Material.diffuse((0.2, 0.8, 0.2)))


def _carry(sd):
    """``from_numpy`` without a device, on a CPU scene's host arrays."""
    fields = {k: getattr(sd, k).numpy() for k in SCENE_FIELDS}
    fields["n_bvh_tris"] = sd.n_bvh_tris
    fields["materials"] = {k: v.numpy() for k, v in sd.materials.items()}
    return tscene.from_numpy(fields, None)


@pytest.mark.parametrize("entry", ["build", "to", "from_numpy", "camera"])
def test_entry_points_default_to_the_card(entry):
    """Without ``device=``: on the card where one is visible, else an
    error, never a silent run on the CPU."""
    calls = {"build": lambda: _box().build(),
             "to": lambda: _box().build(device="cpu").to(),
             "from_numpy": lambda: _carry(_box().build(device="cpu")),
             "camera": lambda: build_camera(resolution=(8, 8))}
    if torch.cuda.is_available():
        out = calls[entry]()
        dev = out.c2w_t.device if entry == "camera" else out.device
        assert dev.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            calls[entry]()


def test_renderer_never_defaults_to_the_cpu():
    """A scene built without a card raises, so no ``Renderer`` comes to
    run on the CPU unasked; one built on the CPU on request renders there,
    and a camera on another device than the scene is refused."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Renderer(_box().build(), build_camera(resolution=(8, 8)))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _box().build(accel="kdtree")
    scene = _box().build(device="cpu")
    img = Renderer(scene, build_camera(resolution=(8, 8), device="cpu")) \
        .samples(1).fixed_rr_delta(1.0).render(verbose=False)
    assert img.shape == (8, 8, 3)
    with pytest.raises(ValueError, match="camera is on"):
        Renderer(scene, build_camera(resolution=(8, 8), device="meta"))
