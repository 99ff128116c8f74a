"""The plain version of the in-kernel loop microbenchmark
(``lumo_tpu_torch/tools/exp_sync.py``): its outputs have closed forms on
the tile of 0.5 the tool uses, since ``0.5 + i > 1.5`` first holds at
trip 2 and ``0.5 + i > 1.2`` at trip 1.  The CUDA kernel is held against
this plain version, bit for bit, on a card by ``tests/test_torch_cuda.py``.
The JAX tool (``tools/exp_sync.py``) builds a TPU kernel with a fixed trip
count and no interpret mode, so it is not run here; ``_jnp_loop`` evaluates
the same loop body (``tools/exp_sync.py:49-76``) with ``jax.numpy`` and no
Pallas, an implementation independent of the port's, and the plain version
is held against it."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lumo_tpu_torch.tools import exp_sync

ITERS = 1000


def _closed_form(variant, n):
    return {"scalar": 0.0, "reduce1": n - 2.0, "branch1": n - 2.0,
            "reduce4": 4.0 * n - 3.0,
            "packed2": 1024.0 * (2 * n - 3)}[variant]


@pytest.mark.parametrize("variant", ["scalar", "reduce1", "branch1",
                                     "reduce4", "packed2"])
def test_plain_outputs_have_their_closed_form(variant):
    out = exp_sync.make(variant, ITERS, device="cpu")()
    assert out.shape == exp_sync.TILE and out.dtype == torch.float32
    assert torch.equal(out, torch.full(exp_sync.TILE,
                                       _closed_form(variant, ITERS)))


def _jnp_loop(variant, x, iters):
    """``tools/exp_sync.py::make(variant).kern`` line for line, with the
    ``acc`` scratch a loop-carried value that starts at zero, the Pallas
    refs plain arrays and ``pl.when`` a ``jnp.where``."""
    f32, i32 = jnp.float32, jnp.int32

    def body(c):
        i, s, acc = c
        if variant == "vec":                                   # l. 53-54
            acc = acc + x * 1.000001
        elif variant == "reduce1":                             # l. 55-57
            r = jnp.any(x + f32(i) > 1.5)
            s = s + jnp.where(r, 1, 0)
        elif variant == "reduce4":                             # l. 58-61
            for k in range(4):
                r = jnp.any(x + f32(i + k) > 1.5)
                s = s + jnp.where(r, 1, 0)
        elif variant == "packed2":                             # l. 62-66
            v = (x + f32(i) > 1.5).astype(i32) \
                + ((x + f32(i) > 1.2).astype(i32) << 12)
            m = jnp.sum(v)
            s = s + (m & 4095) + (m >> 12)
        elif variant == "branch1":                             # l. 67-72
            r = jnp.any(x + f32(i) > 1.5)
            acc = jnp.where(r, acc + 1.0, acc)
        return i + 1, s, acc

    _, s, acc = jax.lax.while_loop(                            # l. 46-47, 75
        lambda c: c[0] < iters, body, (i32(0), i32(0), jnp.zeros_like(x)))
    return jnp.zeros(x.shape, f32) + f32(s) + acc              # l. 43, 76


@pytest.mark.parametrize("fill", [0.5, None], ids=["half", "random"])
@pytest.mark.parametrize("variant", exp_sync.VARIANTS)
def test_plain_matches_a_jnp_evaluation_of_the_tpu_loop(variant, fill):
    """Bit-equal outputs at 300 trips, on the tool's tile of 0.5 and on a
    seeded random tile in (-300, 2), where the votes turn true at a trip
    that depends on the data."""
    x = (np.full(exp_sync.TILE, fill, np.float32) if fill is not None else
         np.random.default_rng(5).uniform(-300, 2, exp_sync.TILE)
         .astype(np.float32))
    ref = np.asarray(_jnp_loop(variant, jnp.asarray(x), 300))
    out = exp_sync.run_plain(variant, torch.from_numpy(x), 300).numpy()
    assert out.dtype == np.float32 and out.shape == exp_sync.TILE
    assert np.array_equal(out.view(np.int32), ref.view(np.int32))


def test_plain_vec_is_a_float32_running_sum():
    out = exp_sync.make("vec", ITERS, device="cpu")()
    acc, step = np.float32(0.0), np.float32(0.5) * np.float32(1.000001)
    for _ in range(ITERS):
        acc = np.float32(acc + step)
    assert torch.equal(out, torch.full(exp_sync.TILE, float(acc)))
    assert float(acc) == pytest.approx(0.5 * 1.000001 * ITERS, rel=1e-4)


def test_run_checks_its_arguments():
    x = torch.full(exp_sync.TILE, 0.5)
    assert exp_sync.VARIANTS == ("scalar", "vec", "reduce1", "branch1",
                                 "reduce4", "packed2")
    assert torch.equal(exp_sync.run("reduce1", x, 0), torch.zeros_like(x))
    with pytest.raises(ValueError, match="unknown variant"):
        exp_sync.run("reduce9", x, 10)
    with pytest.raises(ValueError, match="iters"):
        exp_sync.run("packed2", x, 1 << 20)
    with pytest.raises(ValueError, match="unsupported device"):
        exp_sync.run("vec", x.to("meta"), 10)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            exp_sync.make("vec")             # defaults to the card
