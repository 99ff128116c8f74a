"""The port's spectral pipeline against the JAX package's: wavelength
sampling, RGB uplift, dense-spectrum lookups, luminance and the film's
spectral-to-RGB conversion, plus the byte identity of the data files the
port carries."""
import hashlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lumo_tpu import film as jfilm
from lumo_tpu.color import dense as jdense
from lumo_tpu.color import space as jspace
from lumo_tpu.color import uplift as juplift
from lumo_tpu.color import wavelength as jwave
from lumo_tpu_torch import film as tfilm
from lumo_tpu_torch.color import dense as tdense
from lumo_tpu_torch.color import space as tspace
from lumo_tpu_torch.color import uplift as tuplift
from lumo_tpu_torch.color import wavelength as twave

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-5   # float32 sums of four samples taken in another order


def _wavelengths(N, seed, terminated=True):
    u = np.random.default_rng(seed).uniform(0, 1, N).astype(np.float32)
    u[:2] = [0.0, np.float32(1.0) - np.float32(2.0 ** -24)]
    lam = np.asarray(jwave.sample(jnp.asarray(u)))
    if terminated:
        lam = lam.copy()
        lam[::7, 1:] = 0.0          # dispersion-terminated hero samples
    return u, lam


@pytest.mark.parametrize("name", ["spectra.npz", "uplift_srgb_64.npz"])
def test_data_files_are_byte_copies(name):
    digest = lambda p: hashlib.sha256(open(p, "rb").read()).hexdigest()
    src = os.path.join(ROOT, "lumo_tpu", "color", "data", name)
    dst = os.path.join(ROOT, "lumo_tpu_torch", "color", "data", name)
    assert digest(dst) == digest(src)


def test_wavelength_sample_and_pdf():
    u, lam_j = _wavelengths(8192, 0, terminated=False)
    lam_t = twave.sample(torch.as_tensor(u)).numpy()
    np.testing.assert_allclose(lam_t, lam_j, rtol=1e-6)
    assert lam_t.min() >= 360.0 and lam_t.max() <= 830.0
    _, lam = _wavelengths(8192, 1)
    np.testing.assert_allclose(twave.pdf(torch.as_tensor(lam)).numpy(),
                               np.asarray(jwave.pdf(jnp.asarray(lam))),
                               rtol=1e-6)
    do = np.random.default_rng(2).uniform(size=8192) < 0.3
    np.testing.assert_array_equal(
        twave.terminate(torch.as_tensor(lam), torch.as_tensor(do)).numpy(),
        np.asarray(jwave.terminate(jnp.asarray(lam), jnp.asarray(do))))


def test_uplift_from_rgb_and_sample():
    rgb = np.random.default_rng(3).uniform(0, 1.5, (257, 3))
    rgb[0] = 0.0
    rgb[1] = [1.0, 1.0, 1.0]
    coef_j = juplift.from_rgb(rgb)
    coef_t = tuplift.from_rgb(rgb)
    np.testing.assert_array_equal(coef_t, coef_j)
    _, lam = _wavelengths(257, 4)
    c32 = coef_j.astype(np.float32)
    want = np.asarray(juplift.sample(jnp.asarray(c32)[:, None, :],
                                     jnp.asarray(lam)))
    got = tuplift.sample(torch.as_tensor(c32)[:, None, :],
                         torch.as_tensor(lam)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-7)


def test_dense_sample_rows():
    tbl = np.stack([jdense.table(k) for k in ("D65", "X", "Y", "Z")]
                   ).astype(np.float32)
    rows = np.random.default_rng(5).integers(0, 4, 4096)
    _, lam = _wavelengths(4096, 6)
    lam[:4, 0] = [360.0, 830.0, 362.5, 829.99]       # grid ends
    want = np.asarray(jdense.sample_rows(jnp.asarray(tbl), jnp.asarray(rows),
                                         jnp.asarray(lam)))
    got = tdense.sample_rows(torch.as_tensor(tbl), torch.as_tensor(rows),
                             torch.as_tensor(lam)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6)


def test_luminance():
    _, lam = _wavelengths(4096, 7)
    color = np.random.default_rng(8).uniform(0, 2, (4096, 4)).astype(
        np.float32)
    want = np.asarray(jspace.luminance(jnp.asarray(color), jnp.asarray(lam)))
    got = tspace.luminance(torch.as_tensor(color),
                           torch.as_tensor(lam)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-7)


@pytest.mark.parametrize("cs,illum", [("sRGB", "D65"), ("DCI-P3", "D65")])
def test_spectral_to_rgb(cs, illum):
    wb_j = jfilm.wb_matrix(cs, illum)
    wb_t = tfilm.wb_matrix(cs, illum)
    np.testing.assert_allclose(wb_t, wb_j, rtol=1e-12)
    _, lam = _wavelengths(4096, 9)
    color = np.random.default_rng(10).uniform(0, 2, (4096, 4)).astype(
        np.float32)
    want = np.asarray(jfilm.spectral_to_rgb(
        jnp.asarray(color), jnp.asarray(lam),
        jnp.asarray(wb_j, jnp.float32)))
    got = tfilm.spectral_to_rgb(torch.as_tensor(color), torch.as_tensor(lam),
                                wb_t).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6)
