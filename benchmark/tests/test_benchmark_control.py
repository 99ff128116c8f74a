"""The comparison that decides ``correct`` at a tiny size: its control
(the reference in bfloat16) and the faults a cell can have, each planted
under a whole rehearsal run, come out not correct; a sound run comes out
correct."""
import contextlib
from unittest import mock

import numpy as np
import pytest
import torch

from conftest import tiny

WORKLOADS = ["cornell.render", "blob327k.render", "cornell.grad",
             "blob327k.grad"]


def _run(workload, seed=4294967311, seconds=0.0):
    from lumobench import window
    return window.run_cell(tiny(workload), seed, seconds, False,
                           torch.device("cpu"), 0.0)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_sound_run_is_correct(workload):
    out = _run(workload)
    assert out["correct"], out["check"]
    assert list(out)[-1] == "check"


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_is_not_correct(workload):
    import control
    from lumobench import check
    cell = tiny(workload)
    out = control.readings(cell, [17], [17], torch.device("cpu"),
                           log=lambda line: None)
    limits = cell.traffic["limits"]
    assert check.verdict(out["program"][17], limits)[0]
    assert not check.verdict(out["control"][17], limits)[0]


def _stale():
    """A pass or step that returns the state of the one before."""
    from lumobench import program
    seen = {}

    def render(scene, camera, spp, seed, real=program.render_pass):
        seen.setdefault("img", real(scene, camera, spp, seed))
        return seen["img"]

    def grad(*args, real=program.grad_step, **kw):
        seen.setdefault("g", real(*args, **kw))
        return seen["g"]
    return render, grad


def _half():
    """Half of the batch left out, the mean taken over the rest."""
    from lumobench import program

    def render(scene, camera, spp, seed, real=program.render_pass):
        return real(scene, camera, spp // 2, seed)

    def grad(scene, leaves, rays, *a, real=program.grad_step, **kw):
        return real(scene, leaves, tuple(x[:x.shape[0] // 2] for x in rays),
                    *a, **kw)
    return render, grad


def _altered():
    """An answer altered where it is produced."""
    from lumobench import program

    def render(*a, real=program.render_pass):
        img = real(*a)
        return img * np.float32(1.001)

    def grad(*a, real=program.grad_step, **kw):
        loss, grads = real(*a, **kw)
        return loss, {k: None if v is None else v * 1.001
                      for k, v in grads.items()}
    return render, grad


@pytest.mark.parametrize("fault", [_stale, _half, _altered])
@pytest.mark.parametrize("workload", ["cornell.render", "blob327k.grad"])
def test_fault_is_not_correct(workload, fault):
    from lumobench import program
    render, grad = fault()
    with mock.patch.object(program, "render_pass", render), \
            mock.patch.object(program, "grad_step", grad):
        out = _run(workload, seconds=1.0)
    assert out["attempted"] >= 1
    assert not out["correct"], out["check"]
