"""Spectrum/color tests (modeled on reference spectrum_test.cpp, color_test.cpp)."""
import jax.numpy as jnp
import numpy as np
import pytest

from pbrt_jax.utils import spectrum as spc
from pbrt_jax.utils import color


def test_cie_y_integral():
    t = spc.cie_tables()
    np.testing.assert_allclose(t[1].sum(), spc.CIE_Y_INTEGRAL, rtol=1e-5)


def test_blackbody_wien():
    # Wien's law: peak of 6000K blackbody near 483nm; normalized peak == 1
    lam = jnp.asarray([[483.0, 600.0, 500.0, 700.0]])
    v = spc.blackbody_normalized(lam, 6000.0)
    assert 0.999 < float(v[0, 0]) <= 1.000001
    # 2700K peak at ~1073nm -> in-range values below 1
    v2 = spc.blackbody_normalized(lam, 2700.0)
    assert float(v2.max()) < 1.0


def test_sample_uniform_wavelengths_in_range():
    u = jnp.linspace(0.0, 0.999, 50)
    swl = spc.sample_uniform_wavelengths(u)
    lam = np.asarray(swl.lam)
    assert lam.min() >= spc.LAMBDA_MIN and lam.max() <= spc.LAMBDA_MAX
    assert np.allclose(np.asarray(swl.pdf), 1.0 / (spc.LAMBDA_MAX - spc.LAMBDA_MIN))


def test_sample_visible_wavelengths_pdf_integrates_to_one():
    lam = jnp.linspace(360.0, 830.0, 2000)
    pdf = spc.visible_wavelengths_pdf(lam)
    integral = float(jnp.trapezoid(pdf, lam))
    np.testing.assert_allclose(integral, 1.0, atol=1e-3)


def test_sample_visible_is_consistent_with_pdf():
    u = jnp.asarray(np.random.RandomState(0).rand(1000), jnp.float32)
    swl = spc.sample_visible_wavelengths(u)
    lam = np.asarray(swl.lam).ravel()
    pdf = np.asarray(swl.pdf).ravel()
    assert lam.min() >= 360.0 and lam.max() <= 830.0
    expected = np.asarray(spc.visible_wavelengths_pdf(jnp.asarray(lam)))
    np.testing.assert_allclose(pdf, expected, rtol=1e-4)


def test_dense_eval_interpolates():
    table = jnp.asarray(np.linspace(0, 470, 471), jnp.float32)  # f(lam) = lam-360
    lam = jnp.asarray([[400.5, 360.0, 830.0, 600.25]])
    v = np.asarray(spc.eval_dense(table, lam))
    np.testing.assert_allclose(v[0], [40.5, 0.0, 470.0, 240.25], atol=1e-3)


def test_d65_whitepoint():
    wp = spc.d65_spectrum().to_xyz()
    x = wp[0] / wp.sum()
    y = wp[1] / wp.sum()
    assert abs(x - 0.3127) < 2e-3
    assert abs(y - 0.3290) < 2e-3


def test_named_spectra_exist():
    for name in ["metal-Au-eta", "metal-Au-k", "glass-BK7", "stdillum-A",
                 "stdillum-D65", "illum-acesD60", "stdillum-F11"]:
        s = spc.get_named_spectrum(name)
        assert s is not None, name
        assert s.max_value() > 0


def test_gold_eta_reasonable():
    # Gold IOR at 550nm: eta ~0.42, k ~2.45 (physical data sanity)
    eta = spc.get_named_spectrum("metal-Au-eta")(np.array([550.0]))[0]
    k = spc.get_named_spectrum("metal-Au-k")(np.array([550.0]))[0]
    assert 0.2 < eta < 0.7
    assert 1.8 < k < 3.0


def test_srgb_matrix():
    cs = color.srgb()
    # known sRGB D65 matrix first row ~ [0.4124, 0.3576, 0.1805]
    np.testing.assert_allclose(cs.xyz_from_rgb[0], [0.4124, 0.3576, 0.1805], atol=2e-3)
    # white round trip
    rgb = np.asarray(cs.to_rgb(jnp.asarray(cs.to_xyz(jnp.asarray([1.0, 1.0, 1.0])))))
    np.testing.assert_allclose(rgb, [1, 1, 1], atol=1e-5)


def test_srgb_transfer_roundtrip():
    x = jnp.linspace(0, 1, 64)
    y = color.srgb_to_linear(color.linear_to_srgb(x))
    np.testing.assert_allclose(np.asarray(y), np.asarray(x), atol=1e-5)


def test_rgb_to_spectrum_roundtrip():
    """RGB -> sigmoid spectrum -> RGB must round-trip (reference
    color_test.cpp RGBToSpectrumTable tests)."""
    cs = color.srgb()
    rng = np.random.RandomState(3)
    rgbs = rng.rand(64, 3).astype(np.float32)
    coeffs = cs.to_spectrum_coeffs(rgbs)
    # integrate the spectrum against CIE under D65
    lam = np.arange(360.0, 831.0, 1.0, dtype=np.float32)
    refl = np.asarray(color.eval_rgb_sigmoid_polynomial(
        jnp.asarray(coeffs)[:, None, :], jnp.asarray(lam)[None, :, None]))[..., 0]
    t = spc.cie_tables().astype(np.float64)
    illum = cs.illuminant(lam.astype(np.float64))
    norm = np.sum(t[1] * illum)
    xyz = np.stack([(refl * (t[i] * illum)[None, :]).sum(-1) / norm for i in range(3)], -1)
    rt = xyz @ np.asarray(cs.rgb_from_xyz, np.float64).T
    err = np.abs(rt - rgbs).max()
    assert err < 0.01, f"max roundtrip err {err}"


def test_rgb_spectrum_black_and_white():
    cs = color.srgb()
    c_black = cs.to_spectrum_coeffs(np.array([0.0, 0.0, 0.0]))
    v = np.asarray(color.eval_rgb_sigmoid_polynomial(
        jnp.asarray(c_black), jnp.asarray([[400.0, 500.0, 600.0, 700.0]])))
    assert v.max() < 1e-4
    c_white = cs.to_spectrum_coeffs(np.array([1.0, 1.0, 1.0]))
    v = np.asarray(color.eval_rgb_sigmoid_polynomial(
        jnp.asarray(c_white), jnp.asarray([[400.0, 500.0, 600.0, 700.0]])))
    assert v.min() > 0.9


def test_spectrum_to_xyz_mc_white():
    """MC spectral->XYZ of the illuminant should match analytic XYZ."""
    rng = np.random.RandomState(0)
    u = jnp.asarray(rng.rand(8192), jnp.float32)
    swl = spc.sample_visible_wavelengths(u)
    d65 = jnp.asarray(spc.d65_spectrum().to_dense())
    L = spc.eval_dense(d65, swl.lam)
    xyz = np.asarray(spc.spectrum_to_xyz_mc(L, swl)).mean(axis=0)
    ref = spc.d65_spectrum().to_xyz()
    np.testing.assert_allclose(xyz, ref, rtol=0.01)
