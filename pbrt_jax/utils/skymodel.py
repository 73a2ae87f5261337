"""Hosek-Wilkie analytic sky-dome radiance model (spectral).

Evaluates the published model
  L. Hosek, A. Wilkie, "An Analytic Model for Full Spectral Sky-Dome
  Radiance", SIGGRAPH 2012 (+ the 2013 solar-radiance extension)
from the authors' BSD-licensed coefficient dataset, re-packed as
``pbrt_jax/data/hosek_spectral.npz`` by ``tools/extract_skymodel.py``.

Role model: the reference's ``imgtool makesky``
(/root/reference/src/pbrt/cmd/imgtool.cpp:335-430) drives the vendored
ArHosekSkyModel (src/ext/skymodel/ArHosekSkyModel.c); this is an original
vectorized numpy implementation of the same published formulas, validated
against the reference evaluator in tests/test_skymodel.py.

The model covers 320..720nm in 11 bands of 40nm; sky radiance between
bands is linearly interpolated.  All evaluation is host-side numpy (the
tool bakes an environment map once; the renderer consumes the image).
"""
from __future__ import annotations

import numpy as np
from pathlib import Path

_DATA = Path(__file__).resolve().parent.parent / "data"

_TERRESTRIAL_SOLAR_RADIUS = np.deg2rad(0.51) / 2.0
_N_BANDS = 11
_WL0, _WL_STEP = 320.0, 40.0
_SOLAR_PIECES = 45
_SOLAR_ORDER = 4

_BERN5 = np.array([1.0, 5.0, 10.0, 10.0, 5.0, 1.0])


def _quintic_bezier(ctrl, t):
    """ctrl (..., 6, K) Bernstein-weighted at scalar t -> (..., K)."""
    k = np.arange(6)
    w = _BERN5 * (1.0 - t) ** (5 - k) * t ** k          # (6,)
    return np.tensordot(ctrl, w, axes=([-2], [0]))


class HosekSkyModel:
    """Cooked sky-model state for one (turbidity, albedo, solar elevation).

    elevation is measured from the horizon, in radians (matching
    arhosekskymodelstate_alloc_init).
    """

    def __init__(self, turbidity: float, albedo: float, elevation: float):
        if not (1.0 <= turbidity <= 10.0):
            raise ValueError("turbidity must be in [1, 10]")
        if not (0.0 <= albedo <= 1.0):
            raise ValueError("albedo must be in [0, 1]")
        d = np.load(_DATA / "hosek_spectral.npz")
        self.turbidity = float(turbidity)
        self.albedo = float(albedo)
        self.elevation = float(elevation)
        self._solar = d["solar"]      # (11, 10, 45, 4)
        self._limb = d["limb"]        # (11, 6)

        # --- cook the 9-coefficient configuration per band -----------------
        # bilinear in (albedo, turbidity-cell) x quintic Bezier in elevation
        t_e = (elevation / (np.pi / 2.0)) ** (1.0 / 3.0)
        it = int(turbidity)
        rem = turbidity - it
        w_alb = np.array([1.0 - albedo, albedo])         # (2,)
        w_turb = np.zeros(10)
        w_turb[it - 1] = 1.0 - rem
        if it < 10:
            w_turb[it] = rem
        else:
            w_turb[9] = 1.0  # turbidity == 10 exactly

        cfg = _quintic_bezier(d["configs"], t_e)         # (11, 2, 10, 9)
        self.configs = np.einsum("wati,a,t->wi", cfg, w_alb, w_turb)  # (11, 9)
        rad = _quintic_bezier(d["radiances"][..., None], t_e)[..., 0]  # (11, 2, 10)
        self.radiances = np.einsum("wat,a,t->w", rad, w_alb, w_turb)   # (11,)

    # -- per-band sky radiance distribution --------------------------------

    def _band_distribution(self, theta, gamma):
        """Normalized sky radiance F(theta, gamma) per band -> (..., 11).

        The 9-coefficient extended Perez-style formula
        (ArHosekSkyModel_GetRadianceInternal).
        """
        c = self.configs                                  # (11, 9)
        theta = np.asarray(theta, np.float64)[..., None]  # (..., 1)
        gamma = np.asarray(gamma, np.float64)[..., None]
        cg, ct = np.cos(gamma), np.cos(theta)
        exp_m = np.exp(c[:, 4] * gamma)
        ray_m = cg * cg
        mie_m = (1.0 + cg * cg) / (1.0 + c[:, 8] ** 2 - 2.0 * c[:, 8] * cg) ** 1.5
        zenith = np.sqrt(np.maximum(ct, 0.0))
        return ((1.0 + c[:, 0] * np.exp(c[:, 1] / (ct + 0.01)))
                * (c[:, 2] + c[:, 3] * exp_m + c[:, 5] * ray_m
                   + c[:, 6] * mie_m + c[:, 7] * zenith))

    def sky_radiance(self, theta, gamma, wavelength):
        """In-scattered sky radiance at wavelength (nm); arrays broadcast.

        theta: angle from zenith; gamma: angle to the sun direction.
        Matches arhosekskymodel_radiance: linear interpolation between the
        two adjacent 40nm bands, zero outside [320, 760).
        """
        wavelength = np.asarray(wavelength, np.float64)
        x = (wavelength - _WL0) / _WL_STEP
        lo = np.floor(x).astype(np.int64)
        frac = x - lo
        valid = (lo >= 0) & (lo < _N_BANDS)
        lo_c = np.clip(lo, 0, _N_BANDS - 1)
        hi_c = np.clip(lo + 1, 0, _N_BANDS - 1)
        per_band = self._band_distribution(theta, gamma) * self.radiances  # (..., 11)
        out_shape = np.broadcast_shapes(per_band.shape[:-1], wavelength.shape)
        per_band = np.broadcast_to(per_band, out_shape + (_N_BANDS,))
        v_lo = np.take_along_axis(
            per_band, np.broadcast_to(lo_c, out_shape)[..., None], -1)[..., 0]
        v_hi = np.take_along_axis(
            per_band, np.broadcast_to(hi_c, out_shape)[..., None], -1)[..., 0]
        v_hi = np.where(lo + 1 < _N_BANDS, v_hi, 0.0)
        return np.where(valid, (1.0 - frac) * v_lo + frac * v_hi, 0.0)

    # -- direct solar radiance ---------------------------------------------

    def _sr_internal(self, turb_idx, band, elevation):
        """Piecewise-polynomial direct solar radiance for one (turbidity
        index, band); elevation in radians (arhosekskymodel_sr_internal)."""
        pos = int((2.0 * elevation / np.pi) ** (1.0 / 3.0) * _SOLAR_PIECES)
        pos = min(pos, _SOLAR_PIECES - 1)
        break_x = (pos / _SOLAR_PIECES) ** 3 * (np.pi * 0.5)
        x = elevation - break_x
        coefs = self._solar[band, turb_idx, pos]          # (4,) highest-degree last
        # res = sum_i x^i * coefs[order-1-i]
        return sum(x ** i * coefs[_SOLAR_ORDER - 1 - i] for i in range(_SOLAR_ORDER))

    def solar_radiance(self, theta, gamma, wavelength):
        """Direct sun-disc radiance (with limb darkening) + in-scattered sky,
        i.e. arhosekskymodel_solar_radiance.  theta/gamma arrays broadcast;
        wavelength may be scalar or array."""
        theta = np.asarray(theta, np.float64)
        gamma = np.asarray(gamma, np.float64)
        wavelength = np.asarray(wavelength, np.float64)
        elevation = np.pi / 2.0 - theta

        sin_rad = np.sin(_TERRESTRIAL_SOLAR_RADIUS)
        ar2 = 1.0 / (sin_rad * sin_rad)
        sg = np.sin(gamma)
        sc2 = np.maximum(1.0 - ar2 * sg * sg, 0.0)
        sample_cos = np.sqrt(sc2)

        turb_low = int(self.turbidity) - 1
        turb_frac = self.turbidity - (turb_low + 1)
        if turb_low == 9:
            turb_low, turb_frac = 8, 1.0

        wl_low = np.minimum((wavelength - _WL0) / _WL_STEP, _N_BANDS - 1).astype(np.int64)
        wl_frac = np.mod(wavelength, _WL_STEP) / _WL_STEP
        wl_frac = np.where(wl_low == _N_BANDS - 1, 1.0, wl_frac)
        wl_low = np.where(wl_low == _N_BANDS - 1, _N_BANDS - 2, wl_low)

        # direct radiance: bilinear over (turbidity, band); elevation varies
        # per-sample, so evaluate the piecewise cubic vectorized.
        def sr_vec(turb_idx, band_arr, elev_arr):
            pos = ((2.0 * np.maximum(elev_arr, 0.0) / np.pi) ** (1.0 / 3.0)
                   * _SOLAR_PIECES).astype(np.int64)
            pos = np.minimum(pos, _SOLAR_PIECES - 1)
            break_x = (pos / _SOLAR_PIECES) ** 3 * (np.pi * 0.5)
            x = elev_arr - break_x
            coefs = self._solar[band_arr, turb_idx, pos]   # (..., 4)
            res = np.zeros_like(x)
            for i in range(_SOLAR_ORDER):
                res += x ** i * coefs[..., _SOLAR_ORDER - 1 - i]
            return res

        band_lo = np.broadcast_to(wl_low, np.broadcast_shapes(wl_low.shape, elevation.shape))
        elev_b = np.broadcast_to(elevation, band_lo.shape)
        direct = ((1.0 - turb_frac)
                  * ((1.0 - wl_frac) * sr_vec(turb_low, band_lo, elev_b)
                     + wl_frac * sr_vec(turb_low, band_lo + 1, elev_b))
                  + turb_frac
                  * ((1.0 - wl_frac) * sr_vec(turb_low + 1, band_lo, elev_b)
                     + wl_frac * sr_vec(turb_low + 1, band_lo + 1, elev_b)))

        ld = ((1.0 - wl_frac)[..., None] * self._limb[band_lo]
              + wl_frac[..., None] * self._limb[band_lo + 1])   # (..., 6)
        darkening = sum(ld[..., i] * sample_cos ** i for i in range(6))
        direct = np.where(sample_cos > 0.0, direct * darkening, 0.0)

        return direct + self.sky_radiance(theta, gamma, wavelength)


def make_sky_image(resolution=2048, elevation_deg=10.0, turbidity=3.0,
                   albedo=0.5, n_lambda=13):
    """Render an equal-area octahedral sky environment map -> (res, res, 3)
    linear RGB in the ACES2065-1 color space (imgtool.cpp makesky:374-420)."""
    import jax
    from . import vecmath as vm
    from . import spectrum as spc
    from . import color as col

    model = HosekSkyModel(turbidity, albedo, np.deg2rad(elevation_deg))
    sun_dir = np.array([0.0, np.cos(np.deg2rad(elevation_deg)),
                        np.sin(np.deg2rad(elevation_deg))])

    xy = (np.arange(resolution) + 0.5) / resolution
    u, v = np.meshgrid(xy, xy)                       # v indexes rows (y)
    uv = np.stack([u, v], -1).reshape(-1, 2)
    with jax.default_device(jax.local_devices(backend="cpu")[0]):
        d = np.asarray(vm.equal_area_square_to_sphere(uv.astype(np.float32)),
                       np.float64)
    up = d[:, 2] > 0.0
    theta = np.arccos(np.clip(d[:, 2], -1.0, 1.0))
    gamma = np.arccos(np.clip(d @ sun_dir, -1.0, 1.0))

    lam = np.linspace(320.0, 720.0, n_lambda)
    spec = np.zeros((d.shape[0], n_lambda))
    spec[up] = model.solar_radiance(theta[up, None], gamma[up, None], lam[None, :])

    # XYZ via the piecewise-linear hat basis integrated against the CIE
    # curves (equivalent to densely evaluating PiecewiseLinearSpectrum).
    dense_lam = np.arange(spc.LAMBDA_MIN, spc.LAMBDA_MAX + 1, dtype=np.float64)
    hats = np.zeros((n_lambda, dense_lam.size))
    for i in range(n_lambda):
        hats[i] = np.interp(dense_lam, lam, np.eye(n_lambda)[i],
                            left=0.0, right=0.0)
    cie = spc.cie_tables().astype(np.float64)         # (3, 471)
    W = cie @ hats.T / spc.CIE_Y_INTEGRAL             # (3, n_lambda)
    xyz = spec @ W.T                                  # (N, 3)
    cs = col.aces2065_1()
    rgb = xyz @ np.asarray(cs.rgb_from_xyz, np.float64).T
    return np.maximum(rgb, 0.0).reshape(resolution, resolution, 3).astype(np.float32)
