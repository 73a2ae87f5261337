"""VolPath integrator tests: DDA majorant grid + rescaled-probability
estimator (reference VolPathIntegrator integrators.cpp:953, MajorantGrid
media.h:105). Oracles are analytic transmittances."""
import pytest
import jax.numpy as jnp
import numpy as np

from pbrt_jax import scene_core as sc
from pbrt_jax import cameras as cm
from pbrt_jax import samplers as smp
from pbrt_jax.utils import transform as tfm
from pbrt_jax.utils import spectrum as spc
from pbrt_jax.integrators import render as rdr
from pbrt_jax.integrators.path import PathOptions


def _look_down_z(width=8, height=8, fov=10.0):
    return cm.make_camera(
        "perspective",
        camera_from_world=tfm.look_at((0, 0, -10), (0, 0, 0),
                                      (0, 1, 0)).inverse(),
        width=width, height=height, fov=fov)


def _emissive_wall(b, L=1.0, z=5.0):
    m = b.materials.add_diffuse((0.0, 0.0, 0.0))
    b.add_mesh([[-20, -20, z], [20, -20, z], [20, 20, z], [-20, 20, z]],
               [[0, 2, 1], [0, 3, 2]], m, emission=spc.ConstantSpectrum(L))


@pytest.mark.slow
def test_two_disjoint_media_boxes():
    """A ray crossing two separate absorbing boxes must be attenuated by the
    PRODUCT of both transmittances — the scene-level DDA sweeps both
    (round-1 code stopped at the first box)."""
    s1, s2 = 0.5, 0.3
    b = sc.SceneBuilder()
    _emissive_wall(b, L=1.0)
    b.media.add_homogeneous(sigma_a=(s1,) * 3, sigma_s=(0.0,) * 3,
                            bounds_lo=(-10, -10, -3), bounds_hi=(10, 10, -2))
    b.media.add_homogeneous(sigma_a=(s2,) * 3, sigma_s=(0.0,) * 3,
                            bounds_lo=(-10, -10, 1), bounds_hi=(10, 10, 3))
    scene = b.build(light_sampler="uniform", force_bvh=False)
    img, _ = rdr.render(scene, _look_down_z(), spp=512,
                        sampler=smp.make_sampler("independent", spp=512),
                        opts=PathOptions(max_depth=2))
    expect = np.exp(-s1 * 1.0) * np.exp(-s2 * 2.0)
    np.testing.assert_allclose(img.mean(), expect, rtol=0.06)


@pytest.mark.slow
def test_heterogeneous_grid_transmittance():
    """Linear density ramp along z: T = exp(-sigma * integral dens dz) with
    trilinear interpolation. Exercises non-uniform majorant grid cells."""
    sigma = 1.0
    nz = 16
    # density ramps 0 -> 1 over z in [-1, 1] (y/x constant)
    dens = np.broadcast_to(
        ((np.arange(nz) + 0.5) / nz)[:, None, None].astype(np.float32),
        (nz, 4, 4)).copy()
    b = sc.SceneBuilder()
    _emissive_wall(b, L=1.0)
    b.media.add_grid(dens, (-10, -10, -1), (10, 10, 1),
                     sigma_a=(sigma,) * 3, sigma_s=(0.0,) * 3)
    scene = b.build(light_sampler="uniform", force_bvh=False)
    img, _ = rdr.render(scene, _look_down_z(), spp=512,
                        sampler=smp.make_sampler("independent", spp=512),
                        opts=PathOptions(max_depth=2))
    # brute-force the 1D trilinear density integral along z
    zs = np.linspace(-1, 1, 4097)
    g = (zs + 1) / 2 * nz - 0.5
    g0 = np.clip(np.floor(g), 0, nz - 1).astype(int)
    g1 = np.clip(g0 + 1, 0, nz - 1)
    fr = np.clip(g - g0, 0, 1)
    prof = (np.arange(nz) + 0.5) / nz
    dvals = prof[g0] * (1 - fr) + prof[g1] * fr
    integral = np.trapezoid(dvals, zs)
    expect = np.exp(-sigma * integral)
    np.testing.assert_allclose(img.mean(), expect, rtol=0.06)


@pytest.mark.slow
def test_spectral_absorber_tints():
    """A red-tinted absorber (low sigma_a in red, high in green/blue) must
    pass red and block green/blue — exercises spectral sigma ratios and the
    r_u/r_l accounting across the 4 wavelengths."""
    b = sc.SceneBuilder()
    _emissive_wall(b, L=1.0)
    b.media.add_homogeneous(sigma_a=(0.2, 2.0, 2.0), sigma_s=(0.0,) * 3,
                            bounds_lo=(-10, -10, -1), bounds_hi=(10, 10, 1))
    scene = b.build(light_sampler="uniform", force_bvh=False)
    img, _ = rdr.render(scene, _look_down_z(), spp=768,
                        sampler=smp.make_sampler("independent", spp=768),
                        opts=PathOptions(max_depth=2))
    mean = img.mean(axis=(0, 1))
    # nominal: red ~ exp(-0.4)=0.67, green/blue ~ exp(-4)=0.018. The
    # sigmoid-polynomial upsampling of the unbounded sigma spectrum smooths
    # the band edges (extra red absorption), as in the reference's
    # RGBUnboundedSpectrum — assert ordering + scale, not exact values.
    assert mean[0] > 0.3, mean
    assert mean[1] < 0.1, mean
    assert mean[2] < 0.1, mean
    assert mean[0] > 10 * max(mean[1], mean[2]), mean


def test_majorant_supergrid_conservative():
    """Supergrid cells must bound sigma_t everywhere; cells far from a
    sparse density spike must be zero (that is the DDA speedup)."""
    from pbrt_jax import media as med_mod
    from pbrt_jax.utils import color as pcolor
    mb = med_mod.MediumBuilder()
    dens = np.zeros((32, 32, 32), np.float32)
    dens[4, 5, 6] = 3.0
    mb.add_grid(dens, (0, 0, 0), (32, 32, 32), sigma_a=(1.0,) * 3,
                sigma_s=(0.5,) * 3)
    pool = mb.build()
    maj = np.asarray(pool.maj_grid)
    mx, my, mz = pool.maj_res
    m3 = maj.reshape(mz, my, mx)
    # the spike voxel center (x=6.5, y=5.5, z=4.5 world) -> supercell
    cell = 32.0 / np.asarray([mx, my, mz])
    sx, sy, szp = (np.asarray([6.5, 5.5, 4.5]) / cell).astype(int)
    sigma_peak = float(np.asarray(pool.desc)[0, 23])
    assert m3[szp, sy, sx] >= 3.0 * sigma_peak * 0.999
    # far corner must be zero
    assert m3[-1, -1, -1] == 0.0
    # total non-zero fraction is small (sparse majorants -> DDA skips)
    assert (m3 > 0).mean() < 0.05


@pytest.mark.slow
def test_volumetric_furnace_with_bvh_geometry():
    """Scattering medium + geometry + BVH path: albedo-1 medium in uniform
    env stays at env radiance (exercises volpath with the full scene
    intersect path rather than force_bvh=False)."""
    b = sc.SceneBuilder()
    m = b.materials.add_diffuse((0.5, 0.5, 0.5))
    b.add_mesh([[900, 900, 900], [901, 900, 900], [900, 901, 900]],
               [[0, 1, 2]], m)
    b.add_uniform_infinite_light(spc.ConstantSpectrum(1.0))
    dens = np.ones((4, 4, 4), np.float32)
    b.media.add_grid(dens, (-2, -2, -2), (2, 2, 2),
                     sigma_a=(0.0,) * 3, sigma_s=(1.0,) * 3, g=-0.2)
    scene = b.build(light_sampler="uniform")
    cam = _look_down_z(8, 8, fov=25)
    img, _ = rdr.render(scene, cam, spp=256,
                        sampler=smp.make_sampler("independent", spp=256),
                        opts=PathOptions(max_depth=48))
    mean = img.mean(axis=(0, 1))
    lum = 0.2126 * mean[0] + 0.7152 * mean[1] + 0.0722 * mean[2]
    np.testing.assert_allclose(lum, 1.0, rtol=0.06)
