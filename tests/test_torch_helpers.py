"""The port's small public helpers against the JAX package's, one case a
helper, on the same numpy inputs (float32; rtol 1e-6, atol 1e-7):
``geometry/onb``'s shading-space trigonometry, ``geometry/intersect``'s
slab test, ``sampling/maps``'s uniform hemisphere, ``color/wavelength``'s
``leading`` and ``sample_uniform_one``, and ``color/uplift``'s ``BLACK``
and ``white``.  The inputs include the pole (sin theta = 0), the horizon
and rays parallel to a slab."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lumo_tpu.color import uplift as juplift
from lumo_tpu.color import wavelength as jwl
from lumo_tpu.geometry import intersect as jgeo
from lumo_tpu.geometry import onb as jonb
from lumo_tpu.sampling import maps as jmaps
from lumo_tpu_torch.color import uplift as tuplift
from lumo_tpu_torch.color import wavelength as twl
from lumo_tpu_torch.geometry import intersect as tgeo
from lumo_tpu_torch.geometry import onb as tonb
from lumo_tpu_torch.sampling import maps as tmaps

N = 1024


def _dirs():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(N, 3))
    w[:8] = [[0, 0, 1], [0, 0, -1], [1, 0, 0], [0, 1, 0], [0.6, 0.8, 0],
             [0, 0, 1e-4], [1e-4, 0, 1], [-1, 0, 1e-6]]
    return (w / np.linalg.norm(w, axis=-1, keepdims=True)).astype(np.float32)


def _slabs():
    rng = np.random.default_rng(1)
    o = rng.uniform(-2, 2, (N, 3)).astype(np.float32)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d[:4, 0] = 0.0                      # parallel to the x slabs
    with np.errstate(divide="ignore"):
        inv_d = (1.0 / d).astype(np.float32)
    lo = rng.uniform(-1, 0, (5, 3)).astype(np.float32)
    hi = lo + rng.uniform(0.1, 1, (5, 3)).astype(np.float32)
    return o, inv_d, lo, hi, np.full(N, np.inf, np.float32)


def _uniform(shape, seed=2):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


def _lams():
    lam = np.array(jwl.sample(jnp.asarray(_uniform(N))))
    lam[:4, 1:] = 0.0                   # terminated states
    return lam


def _onb(name):
    return (lambda m: getattr(m, name)), (_dirs(),)


CASES = {
    **{name: _onb(name) for name in ("sin_theta", "cos2_theta", "sin2_theta",
                                     "tan2_theta", "cos_phi", "sin_phi")},
    "aabb_t": ((lambda m: m.aabb_t), _slabs()),
    "square_to_hemisphere": ((lambda m: m.square_to_hemisphere),
                             (_uniform((N, 2)),)),
    "leading": ((lambda m: m.leading), (_lams(),)),
    "sample_uniform_one": ((lambda m: m.sample_uniform_one), (_uniform(N),)),
    "BLACK": ((lambda m: m.BLACK), None),
    "white": ((lambda m: m.white), ()),
}
MODULES = {"sin_theta": (jonb, tonb), "cos2_theta": (jonb, tonb),
           "sin2_theta": (jonb, tonb), "tan2_theta": (jonb, tonb),
           "cos_phi": (jonb, tonb), "sin_phi": (jonb, tonb),
           "aabb_t": (jgeo, tgeo),
           "square_to_hemisphere": (jmaps, tmaps),
           "leading": (jwl, twl), "sample_uniform_one": (jwl, twl),
           "BLACK": (juplift, tuplift), "white": (juplift, tuplift)}


@pytest.mark.parametrize("name", list(CASES))
def test_helper_matches_jax(name):
    pick, args = CASES[name]
    jmod, tmod = MODULES[name]
    if args is None:                    # a constant
        want, got = pick(jmod), pick(tmod)
    else:
        want = pick(jmod)(*(jnp.asarray(a) for a in args))
        got = pick(tmod)(*(torch.as_tensor(a) for a in args))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)
        assert not np.isnan(g).any()
