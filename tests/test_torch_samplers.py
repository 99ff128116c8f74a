"""The port's counter hashes against the JAX package's, bit for bit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lumo_tpu.sampling import samplers as jsamp
from lumo_tpu_torch.sampling import samplers as tsamp

N = 1_000_000


def _inputs(seed):
    """10^6 uint32 values spanning the full range, with the edges and
    values at and above 2^31 included."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 2 ** 32, N, dtype=np.uint64).astype(np.uint32)
    x[:6] = [0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 2, 2 ** 32 - 1]
    return x


def test_hash_u32_bit_exact():
    x = _inputs(0)
    want = np.asarray(jsamp._hash_u32(jnp.asarray(x)))
    got = tsamp._hash_u32(torch.as_tensor(x.astype(np.int64))).numpy()
    assert got.dtype == np.int64 and got.min() >= 0 and got.max() < 2 ** 32
    np.testing.assert_array_equal(got.astype(np.uint32), want)


@pytest.mark.parametrize("salt", [0, 0x51633E2D, 0x9E3779B9, 0xFFFFFFFF])
def test_randfloat_bit_exact(salt):
    x = _inputs(1)
    want = np.asarray(jsamp._randfloat(jnp.asarray(x), jnp.uint32(salt)))
    got = tsamp._randfloat(torch.as_tensor(x.astype(np.int64)), salt).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert got.min() >= 0.0 and got.max() < 1.0


def test_randfloat_per_lane_salt():
    """Both arguments as arrays, as the camera jitter draws them."""
    i = _inputs(2)
    p = _inputs(3)
    want = np.asarray(jsamp._randfloat(jnp.asarray(i), jnp.asarray(p)))
    got = tsamp._randfloat(torch.as_tensor(i.astype(np.int64)),
                           torch.as_tensor(p.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_mul32_wraps_like_uint32():
    rng = np.random.default_rng(4)
    x = rng.integers(0, 2 ** 32, 4096, dtype=np.uint64)
    for c in (0xED5AD4BB, 0xFFFFFFFF, 1, 0x10000):
        got = tsamp._mul32(torch.as_tensor(x.astype(np.int64)), c).numpy()
        np.testing.assert_array_equal(got.astype(np.uint64),
                                      (x * np.uint64(c)) % 2 ** 32)
