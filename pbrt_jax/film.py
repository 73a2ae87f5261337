"""Film + pixel sensor (reference film.{h,cpp}: PixelSensor:36, RGBFilm:232,
GBufferFilm:319).

The film is a pure accumulation tensor: samples scatter-add (pixel_index,
sensor_rgb * weight, weight) into (H*W, 4) float32 buffers — the array analogue
of the reference's per-pixel double accumulators + AtomicFloat splats. The
PixelSensor models the sensor response: by default the CIE XYZ matching
curves (reference's default when no named sensor is given), optionally a
measured camera RGB response from the named-spectra database, with
white-balance chromatic adaptation folded into a 3x3 matrix.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
from .utils import struct

from .utils import spectrum as spc
from .utils import color as pcolor
from .utils.spectrum import SampledWavelengths, CIE_Y_INTEGRAL


@struct.dataclass
class PixelSensor:
    # response curves as dense tables (3, 471): rows rbar, gbar, bbar
    response: jnp.ndarray
    # output RGB = xyz_from_sensor_rgb @ sensor_rgb (includes white balance)
    xyz_from_sensor_rgb: jnp.ndarray  # (3, 3)
    imaging_ratio: jnp.ndarray        # scalar
    # cie1931 default sensor: evaluate analytic CIE fits (gather-free)
    analytic_cie: bool = struct.field(pytree_node=False, default=False)


def make_pixel_sensor(colorspace=None, sensor_name="cie1931", iso=100.0,
                      exposure_time=1.0, fnumber=1.0, white_balance_temp=None):
    """(reference film.cpp PixelSensor::Create / CreateDefault)"""
    if colorspace is None:
        colorspace = pcolor.srgb()
    imaging_ratio = np.pi * exposure_time * iso / (100.0 * fnumber ** 2) \
        if sensor_name != "cie1931" else exposure_time * iso / 100.0
    if sensor_name == "cie1931":
        response = spc.cie_tables()
        xyz_from_sensor = np.eye(3, dtype=np.float32)
        if white_balance_temp:
            # adapt from the blackbody whitepoint to the colorspace whitepoint
            bb = spc.BlackbodySpectrum(white_balance_temp).to_xyz()
            src_xy = (bb[0] / bb.sum(), bb[1] / bb.sum())
            xyz_from_sensor = pcolor.white_balance_matrix(src_xy, colorspace.w_xy)
    else:
        r = spc.get_named_spectrum(f"{sensor_name}_r")
        g = spc.get_named_spectrum(f"{sensor_name}_g")
        b = spc.get_named_spectrum(f"{sensor_name}_b")
        if r is None:
            raise ValueError(f"unknown sensor {sensor_name}")
        response = np.stack([r.to_dense(), g.to_dense(), b.to_dense()])
        # solve sensor->XYZ by least squares over training swatches under the
        # illuminant (reference PixelSensor ctor solves with reflectance swatches;
        # we use the sigmoid-spectrum table's grid colors as swatches)
        xyz_from_sensor = _solve_sensor_matrix(response, colorspace,
                                               white_balance_temp)
    return PixelSensor(response=jnp.asarray(response, jnp.float32),
                       xyz_from_sensor_rgb=jnp.asarray(xyz_from_sensor, jnp.float32),
                       imaging_ratio=jnp.asarray(imaging_ratio, jnp.float32),
                       analytic_cie=(sensor_name == "cie1931"))


def _solve_sensor_matrix(response, colorspace, white_balance_temp):
    """LSQ fit mapping sensor RGB -> XYZ over reflectance training swatches
    (reference film.cpp:~80, using 24 swatch reflectances; we use a color grid)."""
    rng = np.random.RandomState(7)
    swatches = rng.rand(64, 3).astype(np.float32)
    coeffs = colorspace.to_spectrum_coeffs(swatches)
    lam = np.arange(360.0, 831.0, 1.0, dtype=np.float32)
    refl = np.asarray(pcolor.eval_rgb_sigmoid_polynomial(
        jnp.asarray(coeffs)[:, None, :], jnp.asarray(lam)[None, :, None]))[..., 0]
    illum = colorspace.illuminant.to_dense()[None, :]
    cie = spc.cie_tables()
    xyz = (refl * illum) @ cie.T / np.sum(cie[1] * illum[0])
    sens = (refl * illum) @ np.asarray(response).T
    sens /= np.maximum(np.sum(np.asarray(response)[1] * illum[0]), 1e-9)
    M, *_ = np.linalg.lstsq(sens, xyz, rcond=None)
    return M.T.astype(np.float32)


def sensor_to_sensor_rgb(sensor: PixelSensor, L, swl: SampledWavelengths):
    """MC projection of sampled radiance onto the sensor response (reference
    PixelSensor::ToSensorRGB, film.h:74). L: (..., 4) -> (..., 3).

    Default cie1931 sensor: analytic CIE fits (gather-free); named sensors:
    one fused gather for all 3 curves x 2 interpolation taps."""
    w = spc.safe_div_spectrum(L, swl.pdf) / CIE_Y_INTEGRAL
    lam = swl.lam
    if sensor.analytic_cie:
        X, Y, Z = spc.eval_cie_xyz_analytic(lam)
        rgb = jnp.stack([jnp.mean(X * w, -1), jnp.mean(Y * w, -1),
                         jnp.mean(Z * w, -1)], axis=-1)
        return sensor.imaging_ratio * rgb
    x = jnp.clip(lam - spc.LAMBDA_MIN, 0.0, spc.N_CIE - 1.000001)
    i0 = jnp.clip(jnp.floor(x).astype(jnp.int32), 0, spc.N_CIE - 2)
    frac = (x - i0.astype(jnp.float32))[..., None]
    resp_t = sensor.response.T  # (471, 3)
    # (471, 6) pair rows [RGB@i, RGB@i+1]: one ROW gather for both taps
    pairs = jnp.concatenate([resp_t, jnp.roll(resp_t, -1, axis=0)], axis=-1)
    v = pairs[i0]                                    # (..., 4, 6)
    curves = v[..., 0:3] * (1.0 - frac) + v[..., 3:6] * frac  # (..., 4, 3)
    rgb = jnp.mean(curves * w[..., None], axis=-2)   # (..., 3)
    return sensor.imaging_ratio * rgb


@struct.dataclass
class Film:
    """Film accumulation: ONE (H*W, 8) tensor so a sample wave costs one
    fused scatter-add (separate buffers would be separate scatters).

    accum columns: [rgb_sum(3), weight_sum, lum_sum, lum_sq_sum,
    n_samples, pad]. lum moments feed the per-pixel VarianceEstimator
    channels of the reference GBufferFilm (film.h:319)."""
    accum: jnp.ndarray       # (HW, 8)
    splat_sum: jnp.ndarray   # (HW, 3)
    width: int = struct.field(pytree_node=False)
    height: int = struct.field(pytree_node=False)

    @property
    def rgb_sum(self):
        return self.accum[:, 0:3]

    @property
    def weight_sum(self):
        return self.accum[:, 3]

    @property
    def lum_sum(self):
        return self.accum[:, 4]

    @property
    def lum_sq_sum(self):
        return self.accum[:, 5]

    @property
    def n_samples(self):
        return self.accum[:, 6]


def make_film(width, height) -> Film:
    hw = width * height
    return Film(accum=jnp.zeros((hw, 8), jnp.float32),
                splat_sum=jnp.zeros((hw, 3), jnp.float32),
                width=width, height=height)


def add_samples(film: Film, pixel_index, rgb, weight, identity=False) -> Film:
    """Scatter-add samples (reference RGBFilm::AddSample, film.h:239).

    pixel_index: (N,) int32 flat pixel ids; rgb: (N, 3); weight: (N,).
    identity: static promise that pixel_index is arange(H*W) tiled m times
    (the full-image wave layout) — the scatter becomes a dense add.
    """
    rgb = jnp.where(jnp.isfinite(rgb), rgb, 0.0)  # nan scrub like reference
    lum = 0.2126 * rgb[:, 0] + 0.7152 * rgb[:, 1] + 0.0722 * rgb[:, 2]
    row = jnp.concatenate([
        rgb * weight[:, None], weight[:, None], lum[:, None],
        (lum * lum)[:, None], jnp.ones_like(lum)[:, None],
        jnp.zeros_like(lum)[:, None]], axis=1)
    if identity:
        hw = film.accum.shape[0]
        m = row.shape[0] // hw
        add = row if m == 1 else row.reshape(m, hw, 8).sum(axis=0)
        return film.replace(accum=film.accum + add)
    return film.replace(accum=film.accum.at[pixel_index].add(row))


def get_variance_image(film: Film) -> np.ndarray:
    """(H, W) per-pixel sample variance of luminance (the reference
    GBufferFilm's VarianceEstimator channel, film.h:319)."""
    n = np.maximum(np.asarray(film.n_samples), 1.0)
    mean = np.asarray(film.lum_sum) / n
    ex2 = np.asarray(film.lum_sq_sum) / n
    var = np.maximum(ex2 - mean * mean, 0.0) * n / np.maximum(n - 1, 1.0)
    return var.reshape(film.height, film.width).astype(np.float32)


def get_relative_variance_image(film: Film) -> np.ndarray:
    var = get_variance_image(film)
    n = np.maximum(np.asarray(film.n_samples), 1.0)
    mean = (np.asarray(film.lum_sum) / n).reshape(var.shape)
    return (var / np.maximum(mean * mean, 1e-12)).astype(np.float32)


def add_splats(film: Film, pixel_index, rgb) -> Film:
    rgb = jnp.where(jnp.isfinite(rgb), rgb, 0.0)
    return film.replace(splat_sum=film.splat_sum.at[pixel_index].add(rgb))


def save_checkpoint(film: Film, path, waves_done: int):
    """Persist film accumulators so a killed render can resume (role of the
    reference's partial-image checkpointing, options.h:42
    --write-partial-images / cpu render recovery)."""
    np.savez(path, accum=np.asarray(film.accum),
             splat_sum=np.asarray(film.splat_sum),
             width=film.width, height=film.height,
             waves_done=int(waves_done))


def load_checkpoint(path):
    """Returns (Film, waves_done). Raises on shape mismatch upstream."""
    z = np.load(path)
    film = Film(accum=jnp.asarray(z["accum"]),
                splat_sum=jnp.asarray(z["splat_sum"]),
                width=int(z["width"]), height=int(z["height"]))
    return film, int(z["waves_done"])


def get_image(film: Film, sensor: PixelSensor, colorspace=None,
              splat_scale=1.0) -> np.ndarray:
    """Resolve to (H, W, 3) linear RGB in the output color space (reference
    RGBFilm::GetPixelRGB + GetImage)."""
    if colorspace is None:
        colorspace = pcolor.srgb()
    w = np.asarray(film.weight_sum)
    rgb = np.asarray(film.rgb_sum) / np.maximum(w, 1e-12)[:, None]
    rgb = rgb + splat_scale * np.asarray(film.splat_sum)
    xyz = rgb @ np.asarray(sensor.xyz_from_sensor_rgb).T
    out = xyz @ np.asarray(colorspace.rgb_from_xyz).T
    return out.reshape(film.height, film.width, 3).astype(np.float32)
