"""Host-side material descriptions and the packed material table.

Counterpart of ``lumo_tpu/scene/materials.py`` (reference
``material.rs``, ``bxdf.rs``): the closed set of material kinds is an
integer-tagged SoA parameter table that whole wavefronts gather from,
with masked evaluation over the kinds present.

Kinds:
  0 BLANK       — no scattering, no emission
  1 LAMBERTIAN  — albedo/π
  2 MF_DIFFUSE  — GGX specular + Disney diffuse blend  (Material::diffuse)
  3 MF_CONDUCTOR— GGX conductor (metal/mirror)         (Material::metal)
  4 MF_DIELECTRIC — GGX rough glass w/ transmission    (Material::transparent)
  5 LIGHT       — diffuse emitter (texture × illuminant × scale)
  6 VOLUMETRIC  — HG phase medium interaction
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from lumo_tpu_torch.color import dense, uplift
from lumo_tpu_torch.config import DENSE_SAMPLES

BLANK, LAMBERTIAN, MF_DIFFUSE, MF_CONDUCTOR, MF_DIELECTRIC, LIGHT, VOLUMETRIC = range(7)


def _spec(x) -> np.ndarray:
    """Coerce to uplift coefficients (4,): accepts coeff array, RGB
    triple, scalar reflectance, or 'λ:v …' string."""
    if isinstance(x, str):
        return np.asarray(uplift.from_points(x), dtype=np.float64).reshape(4)
    x = np.asarray(x, dtype=np.float64)
    if x.shape == (4,):
        return x
    if x.shape == (3,):
        return np.asarray(uplift.from_rgb(x)).reshape(4)
    if x.shape == ():
        return np.asarray(uplift.from_rgb([float(x)] * 3)).reshape(4)
    raise ValueError(f"bad spectrum spec: {x.shape}")


@dataclasses.dataclass
class Material:
    """A single material row (host-side)."""
    kind: int = BLANK
    kd: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(4))
    ks: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(4))
    tf: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(4))
    roughness: float = 1.0
    roughness_y: float = -1.0   # anisotropic αy; -1 → isotropic (= roughness)
    beckmann: bool = False      # Beckmann NDF instead of GGX (microfacet.rs:48)
    eta: Optional[np.ndarray] = None       # (95,) dense or None → 1.0
    k: Optional[np.ndarray] = None         # (95,) dense or None → 0.0
    # emission
    ke: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(4))
    illuminant: Optional[np.ndarray] = None  # (95,) dense
    emit_scale: float = 1.0
    two_sided: bool = False
    # volumetric
    hg_g: float = 0.0
    t_scale: float = 1.0
    sigma_t: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(4))
    sigma_s: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(4))
    # texture ids (-1 = use the solid spectra above)
    kd_tex: int = -1
    ks_tex: int = -1
    tf_tex: int = -1
    ke_tex: int = -1
    nm_tex: int = -1    # normal map id (separate id space)

    # ---- factory functions mirroring reference ``material.rs:26-195`` ----

    @staticmethod
    def lambertian(spec) -> "Material":
        return Material(kind=LAMBERTIAN, kd=_spec(spec))

    @staticmethod
    def microfacet(roughness, eta, k, is_transparent, fresnel_enabled,
                   kd, ks, tf, kd_tex=-1, ks_tex=-1, tf_tex=-1,
                   nm_tex=-1, roughness_y=None, beckmann=False) -> "Material":
        if is_transparent and np.isscalar(eta):
            # spectral eta presets (reference ``material.rs:37-45``)
            if eta == 1.5:
                eta = dense.table("glass_eta")
            elif eta == 2.5:
                eta = dense.table("diamond_eta")
        eta_d = np.full(DENSE_SAMPLES, float(eta)) if np.isscalar(eta) else np.asarray(eta)
        k_d = np.full(DENSE_SAMPLES, float(k)) if np.isscalar(k) else np.asarray(k)
        kind = (MF_DIELECTRIC if is_transparent
                else MF_CONDUCTOR if fresnel_enabled else MF_DIFFUSE)
        ry = -1.0 if roughness_y is None else max(float(roughness_y), 1e-5)
        return Material(kind=kind, kd=_spec(kd), ks=_spec(ks), tf=_spec(tf),
                        roughness=max(float(roughness), 1e-5),
                        roughness_y=ry, beckmann=bool(beckmann),
                        eta=eta_d, k=k_d,
                        kd_tex=kd_tex, ks_tex=ks_tex, tf_tex=tf_tex,
                        nm_tex=nm_tex)

    @staticmethod
    def metal(ks, roughness, eta, k, ks_tex=-1) -> "Material":
        return Material.microfacet(roughness, eta, k, False, True,
                                   [1, 1, 1], ks, [0, 0, 0], ks_tex=ks_tex)

    @staticmethod
    def diffuse(kd, kd_tex=-1) -> "Material":
        return Material.microfacet(1.0, 1.5, 0.0, False, False,
                                   kd, [1, 1, 1], [0, 0, 0], kd_tex=kd_tex)

    @staticmethod
    def transparent(tf, roughness, eta, tf_tex=-1) -> "Material":
        return Material.microfacet(roughness, eta, 0.0, True, True,
                                   [0, 0, 0], [1, 1, 1], tf, tf_tex=tf_tex)

    @staticmethod
    def mirror() -> "Material":
        m = Material.microfacet(0.0, 1.0, 0.0, False, True,
                                [0, 0, 0], [1, 1, 1], [0, 0, 0])
        m.eta = dense.table("mirror_eta").copy()
        m.k = dense.table("mirror_k").copy()
        m.roughness = 1e-5
        return m

    @staticmethod
    def glass() -> "Material":
        m = Material.microfacet(0.0, 1.5, 0.0, True, True,
                                [0, 0, 0], [1, 1, 1], [1, 1, 1])
        m.roughness = 1e-5
        return m

    @staticmethod
    def light(ke, scale=1.0, illuminant="D65", two_sided=False, ke_tex=-1) -> "Material":
        illum = dense.table(illuminant) if isinstance(illuminant, str) else np.asarray(illuminant)
        return Material(kind=LIGHT, ke=_spec(ke), illuminant=illum,
                        emit_scale=float(scale), two_sided=two_sided, ke_tex=ke_tex)

    @staticmethod
    def volumetric(g, t_scale, sigma_t, sigma_s) -> "Material":
        return Material(kind=VOLUMETRIC, hg_g=float(g), t_scale=float(t_scale),
                        sigma_t=_spec(sigma_t), sigma_s=_spec(sigma_s))

    @staticmethod
    def blank() -> "Material":
        return Material(kind=BLANK)

    # ---- classification (reference ``material.rs:205-221``,
    #      ``microfacet.rs:71-83``) ----
    def is_specular(self) -> bool:
        if self.kind in (VOLUMETRIC, MF_DIELECTRIC):
            return True
        if self.kind == MF_CONDUCTOR:
            return self.roughness < 0.01
        return False

    def mean_power(self) -> float:
        """Scalar emission power for light-sampling weights: Y-weighted
        integral of ke × illuminant × scale (reference ``material.rs:238-246``
        evaluates this spectrally; the alias table needs one scalar)."""
        if self.kind != LIGHT:
            return 0.0
        lam = 360.0 + 5.0 * np.arange(DENSE_SAMPLES)
        x = (lam - 360.0) / 470.0
        t = self.ke[0] * x * x + self.ke[1] * x + self.ke[2]
        ke = self.ke[3] * (0.5 + t / (2.0 * np.sqrt(1.0 + t * t)))
        y = dense.table("Y")
        phi = float(np.sum(ke * self.illuminant * y) * dense.STEP / dense.Y_INTEGRAL)
        phi *= self.emit_scale
        return 2.0 * phi if self.two_sided else phi


def pack_materials(mats: list) -> dict:
    """Pack a material list into the SoA table (numpy, float32)."""
    M = len(mats)
    ones_eta = np.ones(DENSE_SAMPLES)
    zeros = np.zeros(DENSE_SAMPLES)
    out = {
        "kind": np.array([m.kind for m in mats], np.int32),
        "kd": np.stack([m.kd for m in mats]).astype(np.float32),
        "ks": np.stack([m.ks for m in mats]).astype(np.float32),
        "tf": np.stack([m.tf for m in mats]).astype(np.float32),
        "roughness": np.array([m.roughness for m in mats], np.float32),
        "roughness_y": np.array(
            [m.roughness if m.roughness_y < 0 else m.roughness_y
             for m in mats], np.float32),
        "mf_beck": np.array([m.beckmann for m in mats], bool),
        "eta": np.stack([m.eta if m.eta is not None else ones_eta
                         for m in mats]).astype(np.float32),
        "k": np.stack([m.k if m.k is not None else zeros
                       for m in mats]).astype(np.float32),
        "ke": np.stack([m.ke for m in mats]).astype(np.float32),
        "illum": np.stack([m.illuminant if m.illuminant is not None else zeros
                           for m in mats]).astype(np.float32),
        "emit_scale": np.array([m.emit_scale for m in mats], np.float32),
        "two_sided": np.array([m.two_sided for m in mats], bool),
        "hg_g": np.array([m.hg_g for m in mats], np.float32),
        "t_scale": np.array([m.t_scale for m in mats], np.float32),
        "sigma_t": np.stack([m.sigma_t for m in mats]).astype(np.float32),
        "sigma_s": np.stack([m.sigma_s for m in mats]).astype(np.float32),
        "kd_tex": np.array([m.kd_tex for m in mats], np.int32),
        "ks_tex": np.array([m.ks_tex for m in mats], np.int32),
        "tf_tex": np.array([m.tf_tex for m in mats], np.int32),
        "ke_tex": np.array([m.ke_tex for m in mats], np.int32),
        "nm_tex": np.array([m.nm_tex for m in mats], np.int32),
        "is_specular": np.array([m.is_specular() for m in mats], bool),
        "eta_const": np.array(
            [m.eta is None or bool(np.all(m.eta == m.eta[0])) for m in mats], bool),
    }
    assert out["kind"].shape == (M,)
    return out
