"""Hosek-Wilkie sky model vs the reference evaluator.

Golden data: tests/data/skymodel_golden.npz was produced by compiling the
reference's vendored BSD-licensed ArHosekSkyModel.c with a tiny driver and
dumping sky/solar radiance on a grid of (turbidity, albedo, elevation,
theta, gamma, wavelength) — an exact oracle for our numpy reimplementation.
"""
import numpy as np
import pytest
from pathlib import Path

from pbrt_jax.utils.skymodel import HosekSkyModel, make_sky_image

_G = np.load(Path(__file__).parent / "data" / "skymodel_golden.npz")


def test_sky_radiance_matches_reference():
    for ti, turb in enumerate(_G["turbs"]):
        for ai, alb in enumerate(_G["albs"]):
            for ei, elev in enumerate(_G["elevs"]):
                m = HosekSkyModel(turb, alb, elev)
                th = np.asarray(_G["thetas"])[:, None, None]
                ga = np.asarray(_G["gammas"])[None, :, None]
                lam = np.asarray(_G["lams"])[None, None, :]
                got = m.sky_radiance(th, ga, lam)
                want = _G["sky"][ti, ai, ei]
                np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)


def test_solar_radiance_matches_reference():
    for ti, turb in enumerate(_G["turbs"]):
        for ai, alb in enumerate(_G["albs"]):
            for ei, elev in enumerate(_G["elevs"]):
                m = HosekSkyModel(turb, alb, elev)
                th = np.asarray(_G["thetas"])[:, None, None]
                ga = np.asarray(_G["gammas"])[None, :, None]
                lam = np.asarray(_G["lams"])[None, None, :]
                got = m.solar_radiance(th, ga, lam)
                want = _G["sun"][ti, ai, ei]
                np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-10)


def test_make_sky_image_basic():
    img = make_sky_image(resolution=32, elevation_deg=30.0, turbidity=3.0,
                         albedo=0.3)
    assert img.shape == (32, 32, 3)
    assert np.all(np.isfinite(img))
    assert img.max() > 0.0
    # lower hemisphere (z<0) must be black: corners of the octahedral square
    assert img[0, 0].max() == 0.0 and img[-1, -1].max() == 0.0
