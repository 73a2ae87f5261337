"""Measured (tabulated) BRDF (reference MeasuredBxDF bxdfs.h:1022; MERL
half/difference grid representation)."""
import pytest
import numpy as np
import jax.numpy as jnp

from pbrt_jax import bxdfs


def _params(n, table, lam=550.0):
    return bxdfs.BSDFParams(
        tag=jnp.full((n,), bxdfs.BXDF_MEASURED, jnp.int32),
        albedo=jnp.zeros((n, 4)),
        alpha_x=jnp.zeros((n,)), alpha_y=jnp.zeros((n,)),
        eta=jnp.full((n, 4), 1.5), k=jnp.full((n, 4), lam),
        measured_table=table,
        tags_present=(bxdfs.BXDF_MEASURED,))


def _lambertian_table(albedo=0.6):
    from pbrt_jax.utils import color as pcolor
    cs = pcolor.srgb()
    grid = np.full((90 * 90 * 180, 3), albedo / np.pi, np.float32)
    coeffs = cs.to_spectrum_coeffs(grid)
    return jnp.asarray(np.concatenate(
        [coeffs, np.ones((grid.shape[0], 1), np.float32)], 1))


@pytest.mark.slow
def test_measured_lambertian_is_flat():
    table = _lambertian_table(0.6)
    rng = np.random.default_rng(0)
    n = 256
    wo = rng.normal(size=(n, 3)); wo[:, 2] = np.abs(wo[:, 2]) + 0.1
    wo /= np.linalg.norm(wo, axis=-1, keepdims=True)
    wi = rng.normal(size=(n, 3)); wi[:, 2] = np.abs(wi[:, 2]) + 0.1
    wi /= np.linalg.norm(wi, axis=-1, keepdims=True)
    p = _params(n, table)
    f, pdf = bxdfs._measured_f_pdf(p, jnp.asarray(wo, jnp.float32),
                                   jnp.asarray(wi, jnp.float32))
    f = np.asarray(f).mean(-1)
    # flat table -> constant BRDF ~ albedo/pi at every angle pair
    np.testing.assert_allclose(f, 0.6 / np.pi, rtol=0.1)
    assert (np.asarray(pdf) > 0).all()


@pytest.mark.slow
def test_measured_energy_reasonable():
    """Directional-hemispherical reflectance of the flat table == albedo."""
    table = _lambertian_table(0.5)
    rng = np.random.default_rng(1)
    n = 100000
    wo = jnp.tile(jnp.asarray([[0.3, 0.2, 0.933]]), (n, 1))
    wo = wo / jnp.linalg.norm(wo, axis=-1, keepdims=True)
    wi = rng.normal(size=(n, 3))
    wi /= np.linalg.norm(wi, axis=-1, keepdims=True)
    p = _params(n, table)
    f, _ = bxdfs._measured_f_pdf(p, wo, jnp.asarray(wi, jnp.float32))
    est = (np.asarray(f).mean(-1) * np.abs(wi[:, 2])).mean() * 4 * np.pi
    assert abs(est - 0.5) < 0.05, est


def test_merl_loader(tmp_path):
    import struct
    from pbrt_jax.materials import load_merl_brdf
    nh, nd, np_ = 4, 3, 6
    n = nh * nd * np_
    rng = np.random.default_rng(2)
    vals = rng.uniform(0, 100, 3 * n)
    raw = struct.pack("<iii", nh, nd, np_) + vals.astype("<f8").tobytes()
    f = tmp_path / "m.binary"
    f.write_bytes(raw)
    out = load_merl_brdf(str(f))
    assert out.shape == (4, 3, 6, 3)
    np.testing.assert_allclose(out[0, 0, 0, 0], vals[0] / 1500.0, rtol=1e-6)
    np.testing.assert_allclose(out[0, 0, 0, 1], vals[n] * 1.15 / 1500.0,
                               rtol=1e-6)


@pytest.mark.slow
def test_measured_render_smoke():
    from pbrt_jax import scene_core as sc, cameras as cam_mod
    from pbrt_jax.integrators import render as rdr
    from pbrt_jax.integrators.path import PathOptions
    from pbrt_jax.utils import spectrum as spc
    b = sc.SceneBuilder()
    grid = np.full((90, 90, 180, 3), 0.5 / np.pi, np.float32)
    grid[:10] *= 8.0   # a specular-ish boost near theta_h = 0
    m = b.materials.add_measured(grid)
    b.add_mesh([[-2, -1, -4], [2, -1, -4], [2, 1, -4], [-2, 1, -4]],
               [[0, 1, 2], [0, 2, 3]], m)
    b.add_uniform_infinite_light(spc.ConstantSpectrum(1.0))
    scene = b.build(force_bvh=False)
    cam = cam_mod.make_camera("perspective", fov=60, width=16, height=16)
    img, _ = rdr.render(scene, cam, spp=8, opts=PathOptions(max_depth=2))
    a = np.asarray(img)
    assert np.isfinite(a).all() and a.max() > 0
