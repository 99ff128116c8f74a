"""The port's spectral-uplift table fit (``lumo_tpu_torch/color/uplift.py``
``_fit_slice``, ``fit_table``, ``table``) against the JAX package's
numpy fit, on the CPU.

Both fit in float64 with the same damping and iterations; they differ only
in the order of their float64 sums (numpy's einsum and solve against
torch's matmuls and batched solve).  Held:

- one Gauss-Newton fit of 512 rows from small random coefficients
  against in-gamut targets: coefficients within 1e-9 of each row's
  largest, the RGB they reproduce within 1e-12;
- the whole table at 8 nodes an axis against JAX's ``table()`` at RES 8
  (its ``RES`` and ``_CACHE`` patched to a temporary file): float32
  coefficients within rtol 1e-5 of each entry's largest, the scale nodes
  equal, and the RGB each entry reproduces within 1e-9.  Saturated
  entries (a zero channel drives a sigmoid to its asymptote, where the
  coefficients are ill-determined) may differ more in their
  coefficients: they are counted, at most 1% of the entries;
- ``table(device="cpu")`` with its file missing fits the table, writes
  it and reads it back; ``table()`` without a card raises.

The fit at the shipped 64 nodes (77 s in numpy) runs on the card in
``chip_smoke.py``'s ``[graft]`` phase against ``uplift_srgb_64.npz``.
"""
import numpy as np
import pytest
import torch

from lumo_tpu.color import uplift as juplift
from lumo_tpu_torch.color import uplift as tuplift

FIT_RES = 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Batched 3x3 solves of a few dozen rows: intra-op threads only
    slow them (2.8 s against 0.14 s for the 8-node table)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rgb(coeffs):
    """The linear sRGB (..., 3) that coefficient rows (..., 3) reproduce
    under D65, in float64."""
    A, xs = tuplift._fit_basis()
    poly = np.asarray(coeffs, np.float64) @ np.stack(
        [xs * xs, xs, np.ones_like(xs)])
    return (0.5 + poly / (2.0 * np.sqrt(1.0 + poly * poly))) @ A.T


def test_fit_basis_matches_jax():
    for got, want in zip(tuplift._fit_basis(), juplift._fit_basis()):
        np.testing.assert_allclose(got, want, rtol=1e-14, atol=0)


def test_fit_slice_matches_jax():
    rng = np.random.default_rng(7)
    c0 = 0.1 * rng.normal(size=(512, 3))
    targets = (rng.uniform(0.05, 0.95, (512, 3))
               * rng.uniform(0.2, 1.0, (512, 1)))
    want = juplift._fit_slice(c0, targets)
    got = tuplift._fit_slice(torch.as_tensor(c0),
                             torch.as_tensor(targets)).numpy()
    scale = np.abs(want).max(axis=-1, keepdims=True)
    assert (np.abs(got - want) <= 1e-9 * scale).all()
    np.testing.assert_allclose(_rgb(got), _rgb(want), rtol=0, atol=1e-12)
    np.testing.assert_allclose(_rgb(got), targets, rtol=0, atol=1e-9)


@pytest.fixture(scope="module")
def jax_table(tmp_path_factory):
    """JAX's ``table()`` at RES 8, fitted into a temporary file."""
    mp = pytest.MonkeyPatch()
    path = tmp_path_factory.mktemp("uplift") / f"uplift_srgb_{FIT_RES}.npz"
    mp.setattr(juplift, "RES", FIT_RES)
    mp.setattr(juplift, "_CACHE", str(path))
    juplift.table.cache_clear()
    try:
        out = {k: np.array(v) for k, v in juplift.table().items()}
    finally:
        juplift.table.cache_clear()
        mp.undo()
    assert path.exists()
    return out


def test_fit_table_matches_jax(jax_table):
    got = tuplift.fit_table(FIT_RES, device="cpu")
    want = jax_table
    assert got["coeffs"].shape == want["coeffs"].shape == (
        3, FIT_RES, FIT_RES, FIT_RES, 3)
    assert got["coeffs"].dtype == got["scale"].dtype == np.float32
    np.testing.assert_array_equal(got["scale"], want["scale"])
    scale = np.abs(want["coeffs"]).max(axis=-1, keepdims=True)
    differ = (np.abs(got["coeffs"] - want["coeffs"])
              > 1e-5 * scale).any(axis=-1)
    assert differ.sum() <= differ.size // 100, f"{differ.sum()} entries"
    np.testing.assert_allclose(_rgb(got["coeffs"]), _rgb(want["coeffs"]),
                               rtol=0, atol=1e-9)


def test_table_fits_a_missing_file(tmp_path, monkeypatch):
    """``table()`` reads ``_DATA``; with no file there it fits on the
    device it is given (here the CPU, at 8 nodes), writes the file through
    a temporary one moved into place and returns what it reads.  Without
    a card and without a device it raises and writes nothing."""
    folder = tmp_path / "data"
    path = folder / f"uplift_srgb_{FIT_RES}.npz"
    monkeypatch.setattr(tuplift, "_DATA", str(path))
    monkeypatch.setattr(tuplift, "RES", FIT_RES)
    tuplift.table.cache_clear()
    try:
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                tuplift.table()
            assert not path.exists()
        got = tuplift.table(device="cpu")
        assert sorted(p.name for p in folder.iterdir()) == [path.name]
        again = tuplift.fit_table(FIT_RES, device="cpu")
        for k in ("coeffs", "scale"):
            np.testing.assert_array_equal(got[k], again[k])
        with np.load(path) as d:
            np.testing.assert_array_equal(d["coeffs"], got["coeffs"])
        # the fitted table serves lookups (``table()`` now reads the
        # file): a grey reproduces itself
        grey = tuplift.from_rgb([0.5, 0.5, 0.5])
        assert grey.shape == (1, 4) and grey[0, 3] == 1.0
        np.testing.assert_allclose(_rgb(grey[0, :3]), [0.5] * 3, atol=2e-3)
    finally:
        tuplift.table.cache_clear()
