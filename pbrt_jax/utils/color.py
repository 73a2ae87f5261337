"""Color spaces + RGB<->spectrum conversion (reference util/color.{h,cpp},
util/colorspace.{h,cpp}).

RGB->spectrum uses the Jakob & Hanika 2019 sigmoid-polynomial representation:
a reflectance spectrum is s(p(lambda)) with p a quadratic and
s(x) = 0.5 + x / (2 sqrt(1 + x^2)). The reference ships precomputed 64^3
coefficient tables generated offline by cmd/rgb2spec_opt.cpp; we generate
equivalent tables ourselves with a batched Gauss-Newton fit in JAX
(tools/gen_rgb2spec.py) and cache them in pbrt_jax/data/.
"""
from __future__ import annotations

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from . import spectrum as spc

_DATA = Path(__file__).resolve().parent.parent / "data"


# ---------------------------------------------------------------------------
# XYZ <-> RGB matrices from chromaticities (host, float64)

def _xyz_from_xy(x, y):
    return np.array([x / y, 1.0, (1.0 - x - y) / y], np.float64)


def rgb_to_xyz_matrix(r_xy, g_xy, b_xy, w_xy):
    """Standard primaries->matrix derivation (reference colorspace.cpp:20-36)."""
    R = _xyz_from_xy(*r_xy)
    G = _xyz_from_xy(*g_xy)
    B = _xyz_from_xy(*b_xy)
    W = _xyz_from_xy(*w_xy)
    M = np.stack([R, G, B], axis=1)
    scale = np.linalg.solve(M, W)
    return M * scale[None, :]


class RGBColorSpace:
    """An RGB color space: primaries + whitepoint + illuminant + spectrum table
    (reference util/colorspace.h:20)."""

    def __init__(self, name, r, g, b, w_xy, illuminant: spc.Spectrum):
        self.name = name
        self.r_xy, self.g_xy, self.b_xy = r, g, b
        self.illuminant = illuminant
        # whitepoint from illuminant spectrum (reference colorspace.cpp ctor)
        W = illuminant.to_xyz()
        self.w_xy = (W[0] / W.sum(), W[1] / W.sum()) if w_xy is None else w_xy
        self.xyz_from_rgb = rgb_to_xyz_matrix(r, g, b, self.w_xy)
        self.rgb_from_xyz = np.linalg.inv(self.xyz_from_rgb)

    def to_rgb(self, xyz):
        """xyz (..., 3) -> rgb (..., 3); works for numpy or jnp."""
        m = jnp.asarray(self.rgb_from_xyz, jnp.float32)
        return jnp.matmul(xyz, m.T, precision=jax.lax.Precision.HIGHEST)

    def to_xyz(self, rgb):
        m = jnp.asarray(self.xyz_from_rgb, jnp.float32)
        return jnp.matmul(rgb, m.T, precision=jax.lax.Precision.HIGHEST)

    @functools.cached_property
    def spectrum_table(self):
        return RGBToSpectrumTable.load(self.name)

    def to_spectrum_coeffs(self, rgb):
        """Reflectance RGB in [0,1] -> sigmoid-poly coeffs (..., 3). Host numpy."""
        return self.spectrum_table.lookup(np.asarray(rgb, np.float32))

    @functools.cached_property
    def illuminant_dense(self):
        return self.illuminant.to_dense()


# sRGB transfer function (reference util/color.h LinearToSRGB etc.)
def linear_to_srgb(x):
    x = jnp.clip(x, 0.0, 1.0)
    return jnp.where(x <= 0.0031308, 12.92 * x, 1.055 * jnp.power(x, 1.0 / 2.4) - 0.055)


def srgb_to_linear(x):
    x = jnp.clip(x, 0.0, 1.0)
    return jnp.where(x <= 0.04045, x / 12.92, jnp.power((x + 0.055) / 1.055, 2.4))


# ---------------------------------------------------------------------------
# Sigmoid-polynomial spectra (device-side evaluation)

def sigmoid(x):
    return jnp.where(jnp.isinf(x), jnp.where(x > 0, 1.0, 0.0),
                     0.5 + x / (2.0 * jnp.sqrt(1.0 + x * x)))


def eval_rgb_sigmoid_polynomial(coeffs, lam):
    """coeffs (..., 3) [c0, c1, c2]; lam (..., 4) in nm. Returns (..., 4).

    (reference util/color.h RGBSigmoidPolynomial::operator(), :332)
    """
    c0 = coeffs[..., 0:1]
    c1 = coeffs[..., 1:2]
    c2 = coeffs[..., 2:3]
    x = (c0 * lam + c1) * lam + c2
    return sigmoid(x)


def sigmoid_poly_max_value(coeffs):
    """Max over [360,830] of the sigmoid polynomial (reference color.h:349)."""
    c0, c1, c2 = coeffs[..., 0], coeffs[..., 1], coeffs[..., 2]
    e0 = eval_rgb_sigmoid_polynomial(coeffs, jnp.full(coeffs.shape[:-1] + (1,), 360.0))[..., 0]
    e1 = eval_rgb_sigmoid_polynomial(coeffs, jnp.full(coeffs.shape[:-1] + (1,), 830.0))[..., 0]
    result = jnp.maximum(e0, e1)
    lam_ext = -c1 / (2.0 * jnp.where(c0 == 0, 1.0, c0))
    valid = (c0 != 0) & (lam_ext > 360.0) & (lam_ext < 830.0)
    ee = eval_rgb_sigmoid_polynomial(coeffs, lam_ext[..., None])[..., 0]
    return jnp.where(valid, jnp.maximum(result, ee), result)


class RGBToSpectrumTable:
    """res^3 coefficient table with max-component slicing (reference
    util/color.h:368 RGBToSpectrumTable; layout re-designed: uniform z grid)."""

    def __init__(self, coeffs: np.ndarray):
        # coeffs: (3, res, res, res, 3): [maxcomp][z][y][x][c]
        self.coeffs = np.asarray(coeffs, np.float32)
        self.res = coeffs.shape[1]

    @staticmethod
    @functools.lru_cache(maxsize=8)
    def load(name: str) -> "RGBToSpectrumTable":
        f = _DATA / f"rgb2spec_{name}.npz"
        if not f.exists():
            raise FileNotFoundError(
                f"{f} missing — run tools/gen_rgb2spec.py to generate it")
        return RGBToSpectrumTable(np.load(f)["coeffs"])

    def lookup(self, rgb: np.ndarray) -> np.ndarray:
        """rgb (..., 3) in [0,1] -> coeffs (..., 3). Vectorized numpy.

        Same slicing strategy as the reference (color.cpp operator()): the
        largest component picks one of 3 table slabs; coordinates are
        (z = maxc, x = rgb[(maxc+1)%3]/maxc_val, y = rgb[(maxc+2)%3]/maxc_val).
        """
        rgb = np.asarray(rgb, np.float32)
        shape = rgb.shape[:-1]
        rgb = rgb.reshape(-1, 3)
        out = np.zeros((rgb.shape[0], 3), np.float32)
        maxc = np.argmax(rgb, axis=-1)
        z = rgb[np.arange(len(rgb)), maxc]
        const = z == 0.0  # black: constant 0 spectrum
        x = rgb[np.arange(len(rgb)), (maxc + 1) % 3] / np.maximum(z, 1e-9)
        y = rgb[np.arange(len(rgb)), (maxc + 2) % 3] / np.maximum(z, 1e-9)
        res = self.res
        xf = np.clip(x, 0, 1) * (res - 1)
        yf = np.clip(y, 0, 1) * (res - 1)
        zf = np.clip(z, 0, 1) * (res - 1)
        xi, yi, zi = (np.minimum(xf.astype(np.int32), res - 2),
                      np.minimum(yf.astype(np.int32), res - 2),
                      np.minimum(zf.astype(np.int32), res - 2))
        dx, dy, dz = xf - xi, yf - yi, zf - zi
        co = self.coeffs

        def C(ddx, ddy, ddz):
            return co[maxc, zi + ddz, yi + ddy, xi + ddx]

        c = np.zeros((len(rgb), 3), np.float32)
        for ddz, wz in ((0, 1 - dz), (1, dz)):
            for ddy, wy in ((0, 1 - dy), (1, dy)):
                for ddx, wx in ((0, 1 - dx), (1, dx)):
                    c += (wz * wy * wx)[:, None] * C(ddx, ddy, ddz)
        out = np.where(const[:, None], np.array([0, 0, -1e8], np.float32), c)
        return out.reshape(*shape, 3)


# ---------------------------------------------------------------------------
# Standard color spaces (reference colorspace.cpp:35-60)

@functools.lru_cache(maxsize=1)
def srgb():
    return RGBColorSpace("srgb", (0.64, 0.33), (0.30, 0.60), (0.15, 0.06),
                         None, spc.d65_spectrum())


@functools.lru_cache(maxsize=1)
def rec2020():
    return RGBColorSpace("rec2020", (0.708, 0.292), (0.170, 0.797), (0.131, 0.046),
                         None, spc.d65_spectrum())


@functools.lru_cache(maxsize=1)
def dci_p3():
    return RGBColorSpace("dci-p3", (0.680, 0.320), (0.265, 0.690), (0.150, 0.060),
                         None, spc.d65_spectrum())


@functools.lru_cache(maxsize=1)
def aces2065_1():
    return RGBColorSpace("aces2065-1", (0.7347, 0.2653), (0.0, 1.0), (0.0001, -0.077),
                         None, spc.get_named_spectrum("illum-acesD60"))


def get_colorspace(name: str) -> RGBColorSpace:
    name = name.lower()
    return {"srgb": srgb, "rec2020": rec2020, "dci-p3": dci_p3,
            "aces2065-1": aces2065_1}[name]()


# ---------------------------------------------------------------------------
# Host-side RGB-derived spectra (reference util/spectrum.h RGBAlbedoSpectrum,
# RGBUnboundedSpectrum, RGBIlluminantSpectrum)

class RGBAlbedoSpectrum(spc.Spectrum):
    """Reflectance spectrum from RGB in [0,1] via sigmoid polynomial."""

    def __init__(self, rgb, cs: "RGBColorSpace" = None):
        cs = cs or srgb()
        self.coeffs = np.asarray(cs.to_spectrum_coeffs(np.asarray(rgb)), np.float64)

    def __call__(self, lam):
        lam = np.asarray(lam, np.float64)
        x = (self.coeffs[0] * lam + self.coeffs[1]) * lam + self.coeffs[2]
        return 0.5 + x / (2.0 * np.sqrt(1.0 + x * x))


class RGBUnboundedSpectrum(spc.Spectrum):
    """RGB with components > 1: scale to max 2, fold scale back in."""

    def __init__(self, rgb, cs: "RGBColorSpace" = None):
        rgb = np.asarray(rgb, np.float64)
        m = max(float(rgb.max()), 1e-9)
        self.scale = 2.0 * m
        self.albedo = RGBAlbedoSpectrum(rgb / self.scale if self.scale > 0 else rgb, cs)

    def __call__(self, lam):
        return self.scale * self.albedo(lam)


class RGBIlluminantSpectrum(spc.Spectrum):
    """Emission spectrum: albedo-shaped modulation of the space's illuminant."""

    def __init__(self, rgb, cs: "RGBColorSpace" = None):
        cs = cs or srgb()
        self.unbounded = RGBUnboundedSpectrum(rgb, cs)
        self.illum = cs.illuminant

    def __call__(self, lam):
        return self.unbounded(lam) * self.illum(lam)


# White balance: von Kries in LMS (reference util/color.cpp WhiteBalance)
_LMS_FROM_XYZ = np.array([[0.8951, 0.2664, -0.1614],
                          [-0.7502, 1.7135, 0.0367],
                          [0.0389, -0.0685, 1.0296]], np.float64)


def white_balance_matrix(src_xy, target_xy):
    src = _xyz_from_xy(*src_xy)
    dst = _xyz_from_xy(*target_xy)
    lms_s = _LMS_FROM_XYZ @ src
    lms_d = _LMS_FROM_XYZ @ dst
    A = np.linalg.inv(_LMS_FROM_XYZ) @ np.diag(lms_d / lms_s) @ _LMS_FROM_XYZ
    return A.astype(np.float32)
