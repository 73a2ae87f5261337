"""Point-sampled spectral rendering core (reference util/spectrum.{h,cpp}).

Device-side representation: a "SampledSpectrum" is any ``(..., 4)`` float32
array of radiometric values at 4 sampled wavelengths; a ``SampledWavelengths``
carries the wavelengths and their sampling PDFs. All heavy spectral data
(CIE curves, named illuminants/IOR spectra) lives in dense 1-nm tables over
[360, 830] nm, evaluated on device by linear interpolation gathers.

Host-side ``Spectrum`` classes mirror the reference's closed world
{Constant, DenselySampled, PiecewiseLinear, Blackbody, RGBAlbedo,
RGBUnbounded, RGBIlluminant} (util/spectrum.h:49) for scene construction; at
scene-compile time they are baked into device arrays.
"""
from __future__ import annotations

import functools
from pathlib import Path

import jax.numpy as jnp
import numpy as np
from . import struct

LAMBDA_MIN = 360.0
LAMBDA_MAX = 830.0
N_SPECTRUM_SAMPLES = 4  # reference util/spectrum.h:36
N_CIE = 471
CIE_Y_INTEGRAL = 106.856895

_DATA = Path(__file__).resolve().parent.parent / "data"


@functools.lru_cache(maxsize=1)
def cie_tables():
    """Dense 1-nm CIE 1931 X/Y/Z matching curves over [360, 830]. Returns
    a (3, 471) float32 numpy array."""
    d = np.load(_DATA / "cie_xyz.npz")
    return np.stack([d["CIE_X"], d["CIE_Y"], d["CIE_Z"]]).astype(np.float32)


@functools.lru_cache(maxsize=1)
def named_spectra_raw():
    return dict(np.load(_DATA / "named_spectra.npz"))


# ---------------------------------------------------------------------------
# SampledWavelengths

@struct.dataclass
class SampledWavelengths:
    """4 wavelengths + their PDFs (reference util/spectrum.h SampledWavelengths)."""
    lam: jnp.ndarray   # (..., 4)
    pdf: jnp.ndarray   # (..., 4)

    def secondary_terminated(self):
        return jnp.all(self.pdf[..., 1:] == 0.0, axis=-1)

    def terminate_secondary(self):
        """Collapse to the hero wavelength (for dispersive dielectrics)."""
        already = self.secondary_terminated()
        new_pdf = jnp.concatenate(
            [self.pdf[..., :1] / N_SPECTRUM_SAMPLES,
             jnp.zeros_like(self.pdf[..., 1:])], axis=-1)
        pdf = jnp.where(already[..., None], self.pdf, new_pdf)
        return SampledWavelengths(lam=self.lam, pdf=pdf)


def sample_uniform_wavelengths(u):
    """Stratified-uniform wavelengths from a single uniform u (reference
    SampledWavelengths::SampleUniform, util/spectrum.h:~160)."""
    u = jnp.asarray(u, jnp.float32)
    lam0 = LAMBDA_MIN + u * (LAMBDA_MAX - LAMBDA_MIN)
    delta = (LAMBDA_MAX - LAMBDA_MIN) / N_SPECTRUM_SAMPLES
    i = jnp.arange(N_SPECTRUM_SAMPLES, dtype=jnp.float32)
    lam = lam0[..., None] + i * delta
    lam = jnp.where(lam > LAMBDA_MAX, LAMBDA_MIN + (lam - LAMBDA_MAX), lam)
    pdf = jnp.full_like(lam, 1.0 / (LAMBDA_MAX - LAMBDA_MIN))
    return SampledWavelengths(lam=lam, pdf=pdf)


def _sample_visible_scalar(u):
    return 538.0 - 138.888889 * jnp.arctanh(0.85691062 - 1.82750197 * u)


def visible_wavelengths_pdf(lam):
    """PDF of the visible-wavelength importance distribution (reference
    util/spectrum.h VisibleWavelengthsPDF)."""
    x = 0.0072 * (lam - 538.0)
    pdf = 0.0039398042 / (jnp.cosh(x) ** 2)
    return jnp.where((lam >= LAMBDA_MIN) & (lam <= LAMBDA_MAX), pdf, 0.0)


def sample_visible_wavelengths(u):
    """Importance-sample wavelengths ~ CIE visibility (reference
    SampledWavelengths::SampleVisible)."""
    u = jnp.asarray(u, jnp.float32)
    i = jnp.arange(N_SPECTRUM_SAMPLES, dtype=jnp.float32)
    up = u[..., None] + i / N_SPECTRUM_SAMPLES
    up = jnp.where(up > 1.0, up - 1.0, up)
    lam = _sample_visible_scalar(up)
    pdf = visible_wavelengths_pdf(lam)
    return SampledWavelengths(lam=lam, pdf=pdf)


# ---------------------------------------------------------------------------
# Dense-table evaluation on device

def eval_dense(table, lam):
    """Linearly interpolate a dense 1-nm table over [LAMBDA_MIN, LAMBDA_MAX].

    table: (..., 471) or (471,); lam: (..., 4). Returns (..., 4).
    """
    table = jnp.asarray(table, jnp.float32)
    x = jnp.clip(lam - LAMBDA_MIN, 0.0, N_CIE - 1.000001)
    i0 = jnp.clip(jnp.floor(x).astype(jnp.int32), 0, N_CIE - 2)
    frac = x - i0.astype(jnp.float32)
    if table.ndim == 1:
        # ROW gather of both interpolation taps from an in-program pair
        # table (see lights.eval_light_spectrum)
        pairs = jnp.stack([table, jnp.roll(table, -1)], axis=-1)  # (471, 2)
        v = pairs[i0]                                             # (..., 2)
    else:
        idx = jnp.stack([i0, i0 + 1], axis=-1)
        v = jnp.take(table, idx, axis=-1, mode="clip")
    out = v[..., 0] * (1.0 - frac) + v[..., 1] * frac
    return jnp.where((lam >= LAMBDA_MIN) & (lam <= LAMBDA_MAX), out, 0.0)


def eval_cie_xyz(lam):
    """Returns (X, Y, Z) matching-curve values at lam (..., 4)."""
    t = cie_tables()
    return eval_dense(t[0], lam), eval_dense(t[1], lam), eval_dense(t[2], lam)


def _asym_gauss(x, mu, t1, t2):
    t = (x - mu) * jnp.where(x < mu, t1, t2)
    return jnp.exp(-0.5 * t * t)


def eval_cie_xyz_analytic(lam):
    """Analytic multi-lobe Gaussian fits of the CIE 1931 curves (Wyman,
    Sloan & Shirley 2013) — gather-free (max abs error ~1e-2 vs tables,
    which is below rendering noise; no table lookups in the sensor)."""
    X = (0.362 * _asym_gauss(lam, 442.0, 0.0624, 0.0374) +
         1.056 * _asym_gauss(lam, 599.8, 0.0264, 0.0323) -
         0.065 * _asym_gauss(lam, 501.1, 0.0490, 0.0382))
    Y = (0.821 * _asym_gauss(lam, 568.8, 0.0213, 0.0247) +
         0.286 * _asym_gauss(lam, 530.9, 0.0613, 0.0322))
    Z = (1.217 * _asym_gauss(lam, 437.0, 0.0845, 0.0278) +
         0.681 * _asym_gauss(lam, 459.0, 0.0385, 0.0725))
    inside = (lam >= LAMBDA_MIN) & (lam <= LAMBDA_MAX)
    return (jnp.where(inside, X, 0.0), jnp.where(inside, Y, 0.0),
            jnp.where(inside, Z, 0.0))


def blackbody(lam_nm, T):
    """Planck's law, W/(m^2 sr nm-ish scale) normalized like the reference
    (util/spectrum.h Blackbody). lam in nm, T in Kelvin."""
    c = 299792458.0
    h = 6.62606957e-34
    kb = 1.3806488e-23
    l = lam_nm * 1e-9
    T = jnp.maximum(jnp.asarray(T, jnp.float32), 1e-3)
    le = (2.0 * h * c * c) / ((l ** 5) * (jnp.exp(jnp.asarray(h * c) / (l * kb * T)) - 1.0))
    return le.astype(jnp.float32)


def blackbody_normalized(lam, T):
    """Blackbody normalized so peak (Wien) value is 1 (reference
    BlackbodySpectrum, util/spectrum.h:~240)."""
    lambda_max_m = 2.8977721e-3 / jnp.maximum(jnp.asarray(T, jnp.float32), 1e-3)
    max_le = blackbody(lambda_max_m * 1e9, T)
    return blackbody(lam, T) / max_le


# ---------------------------------------------------------------------------
# MC spectral -> XYZ / photometric conversion

def safe_div_spectrum(a, b):
    return jnp.where(b != 0.0, a / jnp.where(b == 0.0, 1.0, b), 0.0)


def spectrum_to_xyz_mc(L, swl: SampledWavelengths):
    """MC estimate of XYZ from sampled radiance (reference film.cpp ToXYZ):
    X = E[ Xbar(l) L(l) / pdf(l) ] / CIE_Y_integral, averaged over samples."""
    X, Y, Z = eval_cie_xyz(swl.lam)
    w = safe_div_spectrum(L, swl.pdf) / CIE_Y_INTEGRAL
    return jnp.stack([jnp.mean(X * w, axis=-1),
                      jnp.mean(Y * w, axis=-1),
                      jnp.mean(Z * w, axis=-1)], axis=-1)


# ---------------------------------------------------------------------------
# Host-side spectrum objects (scene construction; numpy)

_DENSE_LAMBDA = np.arange(LAMBDA_MIN, LAMBDA_MAX + 1.0, 1.0, dtype=np.float64)


class Spectrum:
    """Host-side spectrum: callable lam(nm, array) -> values (numpy)."""

    def __call__(self, lam):
        raise NotImplementedError

    def max_value(self) -> float:
        return float(np.max(self(_DENSE_LAMBDA)))

    def to_dense(self) -> np.ndarray:
        """Bake to the standard 471-entry 1-nm table."""
        return np.asarray(self(_DENSE_LAMBDA), np.float32)

    def inner_product(self, other: "Spectrum") -> float:
        return float(np.sum(self(_DENSE_LAMBDA) * other(_DENSE_LAMBDA)))

    def to_xyz(self) -> np.ndarray:
        t = cie_tables().astype(np.float64)
        v = self(_DENSE_LAMBDA)
        return np.array([np.sum(t[0] * v), np.sum(t[1] * v), np.sum(t[2] * v)]) / CIE_Y_INTEGRAL

    def to_photometric(self) -> float:
        """Luminance: 683 * integral(Y * s) (reference SpectrumToPhotometric)."""
        t = cie_tables().astype(np.float64)
        return float(683.0 * np.sum(t[1] * self(_DENSE_LAMBDA)) / CIE_Y_INTEGRAL)


class ConstantSpectrum(Spectrum):
    def __init__(self, c: float):
        self.c = float(c)

    def __call__(self, lam):
        return np.full_like(np.asarray(lam, np.float64), self.c)


class DenselySampledSpectrum(Spectrum):
    def __init__(self, values, lambda_min=LAMBDA_MIN):
        self.values = np.asarray(values, np.float64)
        self.lambda_min = float(lambda_min)

    def __call__(self, lam):
        lam = np.asarray(lam, np.float64)
        i = np.clip((lam - self.lambda_min).astype(np.int64), 0, len(self.values) - 1)
        out = self.values[i]
        out[(lam < self.lambda_min) | (lam > self.lambda_min + len(self.values) - 1)] = 0.0
        return out


class PiecewiseLinearSpectrum(Spectrum):
    def __init__(self, lambdas, values, normalize_to=None):
        self.lambdas = np.asarray(lambdas, np.float64)
        self.values = np.asarray(values, np.float64)
        assert np.all(np.diff(self.lambdas) >= 0)
        if normalize_to is not None:
            self.values = self.values * (normalize_to / self.to_photometric())

    @staticmethod
    def from_interleaved(data, normalize=False):
        """[lam0, v0, lam1, v1, ...] (reference FromInterleaved). If the data
        doesn't cover [360, 830] it is clamp-extended like the reference."""
        data = np.asarray(data, np.float64)
        lam, v = data[0::2].copy(), data[1::2].copy()
        if lam[0] > LAMBDA_MIN:
            lam = np.concatenate([[LAMBDA_MIN - 1], lam])
            v = np.concatenate([[v[0]], v])
        if lam[-1] < LAMBDA_MAX:
            lam = np.concatenate([lam, [LAMBDA_MAX + 1]])
            v = np.concatenate([v, [v[-1]]])
        s = PiecewiseLinearSpectrum(lam, v)
        if normalize:
            # normalize so luminance == CIE D65 luminance (reference: scales to
            # have the same photometric normalization as illuminant spectra)
            s.values *= CIE_Y_INTEGRAL / s.inner_product(_cie_y_spectrum())
        return s

    def __call__(self, lam):
        lam = np.asarray(lam, np.float64)
        out = np.interp(lam, self.lambdas, self.values, left=0.0, right=0.0)
        # exact clamp behavior: inside range interp; outside -> 0
        return out


class BlackbodySpectrum(Spectrum):
    def __init__(self, T: float):
        self.T = float(T)

    def __call__(self, lam):
        return np.asarray(blackbody_normalized(jnp.asarray(lam, jnp.float32), self.T), np.float64)


def cie_d_illuminant(temperature: float) -> Spectrum:
    """CIE standard daylight illuminant D for a color temperature in Kelvin
    (reference util/spectrum.cpp Spectra::D).  Below 4000K CCT the D series
    is undefined and a blackbody is returned, matching the reference."""
    cct = temperature * 1.4388 / 1.4380
    if cct < 4000.0:
        return BlackbodySpectrum(cct)
    if cct <= 7000.0:
        x = (-4.607e9 / cct ** 3 + 2.9678e6 / cct ** 2
             + 0.09911e3 / cct + 0.244063)
    else:
        x = (-2.0064e9 / cct ** 3 + 1.9018e6 / cct ** 2
             + 0.24748e3 / cct + 0.23704)
    y = -3.0 * x * x + 2.870 * x - 0.275
    m = 0.0241 + 0.2562 * x - 0.7341 * y
    m1 = (-1.3515 - 1.7703 * x + 5.9114 * y) / m
    m2 = (0.0300 - 31.4424 * x + 30.0717 * y) / m
    d = np.load(_DATA / "cie_daylight.npz")
    vals = (d["s0"] + d["s1"] * m1 + d["s2"] * m2) * 0.01
    return PiecewiseLinearSpectrum(d["lam"], vals)


class ScaledSpectrum(Spectrum):
    def __init__(self, scale: float, s: Spectrum):
        self.scale, self.s = float(scale), s

    def __call__(self, lam):
        return self.scale * self.s(lam)


@functools.lru_cache(maxsize=4)
def _cie_y_spectrum():
    return DenselySampledSpectrum(cie_tables()[1].astype(np.float64))


def cie_x():
    return DenselySampledSpectrum(cie_tables()[0].astype(np.float64))


def cie_y():
    return _cie_y_spectrum()


def cie_z():
    return DenselySampledSpectrum(cie_tables()[2].astype(np.float64))


_NAME_MAP = {
    "glass-BK7": "GlassBK7_eta", "glass-BAF10": "GlassBAF10_eta",
    "glass-FK51A": "GlassFK51A_eta", "glass-LASF9": "GlassLASF9_eta",
    "glass-F5": "GlassSF5_eta", "glass-F10": "GlassSF10_eta",
    "glass-F11": "GlassSF11_eta",
    "metal-Ag-eta": "Ag_eta", "metal-Ag-k": "Ag_k",
    "metal-Al-eta": "Al_eta", "metal-Al-k": "Al_k",
    "metal-Au-eta": "Au_eta", "metal-Au-k": "Au_k",
    "metal-Cu-eta": "Cu_eta", "metal-Cu-k": "Cu_k",
    "metal-CuZn-eta": "CuZn_eta", "metal-CuZn-k": "CuZn_k",
    "metal-MgO-eta": "MgO_eta", "metal-MgO-k": "MgO_k",
    "metal-TiO2-eta": "TiO2_eta", "metal-TiO2-k": "TiO2_k",
    "stdillum-A": "CIE_Illum_A", "stdillum-D50": "CIE_Illum_D5000",
    "stdillum-D65": "CIE_Illum_D6500",
    "illum-acesD60": "ACES_Illum_D60",
}
for _i in range(1, 13):
    _NAME_MAP[f"stdillum-F{_i}"] = f"CIE_Illum_F{_i}"


@functools.lru_cache(maxsize=128)
def get_named_spectrum(name: str) -> Spectrum | None:
    """Named spectrum database (reference GetNamedSpectrum, spectrum.cpp:2654)."""
    raw = named_spectra_raw()
    key = _NAME_MAP.get(name)
    if key is None and name in raw:
        key = name
    if key is None or key not in raw:
        return None
    normalize = name.startswith("stdillum") or name.startswith("illum")
    return PiecewiseLinearSpectrum.from_interleaved(raw[key], normalize=normalize)


@functools.lru_cache(maxsize=1)
def d65_spectrum() -> Spectrum:
    return get_named_spectrum("stdillum-D65")
