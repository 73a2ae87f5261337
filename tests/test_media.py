"""Volumetric tests with analytic oracles (reference media_test.cpp +
VolPath semantics)."""
import jax.numpy as jnp
import numpy as np
import pytest

from pbrt_jax import scene_core as sc
from pbrt_jax import cameras as cm
from pbrt_jax import samplers as smp
from pbrt_jax.utils import transform as tfm
from pbrt_jax.utils import spectrum as spc
from pbrt_jax.integrators import render as rdr
from pbrt_jax.integrators.path import PathOptions


def _look_down_z(width=16, height=16, fov=20.0):
    return cm.make_camera(
        "perspective",
        camera_from_world=tfm.look_at((0, 0, -10), (0, 0, 0), (0, 1, 0)).inverse(),
        width=width, height=height, fov=fov)


def _emissive_wall(b, L=1.0, z=5.0, mat=None):
    from pbrt_jax.utils import color as pcolor
    m = mat if mat is not None else b.materials.add_diffuse((0.0, 0.0, 0.0))
    emit = spc.ConstantSpectrum(L)
    b.add_mesh([[-20, -20, z], [20, -20, z], [20, 20, z], [-20, 20, z]],
               [[0, 2, 1], [0, 3, 2]], m, emission=emit)


@pytest.mark.slow
def test_beer_lambert_absorption():
    """Absorbing slab between camera and emissive wall: L = L0 exp(-sigma_a l).

    Exercises: delta-tracking flight (absorption events terminate paths with
    the surviving fraction = transmittance in expectation)."""
    sigma = 0.4
    thickness = 2.0
    b = sc.SceneBuilder()
    _emissive_wall(b, L=1.0)
    b.media.add_homogeneous(sigma_a=(sigma,) * 3, sigma_s=(0.0,) * 3,
                            bounds_lo=(-10, -10, -1), bounds_hi=(10, 10, 1))
    scene = b.build(light_sampler="uniform", force_bvh=False)
    cam = _look_down_z()
    img, _ = rdr.render(scene, cam, spp=256,
                        sampler=smp.make_sampler("independent", spp=256),
                        opts=PathOptions(max_depth=2))
    lum = img.mean()
    expect = np.exp(-sigma * thickness)
    np.testing.assert_allclose(lum, expect, rtol=0.05), (lum, expect)


@pytest.mark.slow
def test_shadow_transmittance():
    """NEE shadow rays through an absorbing box are attenuated by
    exp(-sigma l): diffuse floor lit by a point light through the slab."""
    sigma = 0.5
    thickness = 2.0
    b = sc.SceneBuilder()
    m = b.materials.add_diffuse((0.8, 0.8, 0.8))
    b.add_mesh([[-5, 0, -5], [5, 0, -5], [5, 0, 5], [-5, 0, 5]],
               [[0, 1, 2], [0, 2, 3]], m)
    b.add_point_light((0, 10, 0), spc.ConstantSpectrum(100.0))
    # slab hovering between light and floor
    b.media.add_homogeneous(sigma_a=(sigma,) * 3, sigma_s=(0.0,) * 3,
                            bounds_lo=(-5, 4, -5), bounds_hi=(5, 6, 5))
    scene = b.build(light_sampler="uniform", force_bvh=False)
    # compare against the same scene without the medium
    b2 = sc.SceneBuilder()
    m2 = b2.materials.add_diffuse((0.8, 0.8, 0.8))
    b2.add_mesh([[-5, 0, -5], [5, 0, -5], [5, 0, 5], [-5, 0, 5]],
                [[0, 1, 2], [0, 2, 3]], m2)
    b2.add_point_light((0, 10, 0), spc.ConstantSpectrum(100.0))
    scene2 = b2.build(light_sampler="uniform", force_bvh=False)
    cam = cm.make_camera(
        "perspective",
        camera_from_world=tfm.look_at((0, 3, -6), (0, 0, 0), (0, 1, 0)).inverse(),
        width=12, height=12, fov=30)
    opts = PathOptions(max_depth=1)
    samp = smp.make_sampler("independent", spp=128)
    img_med, _ = rdr.render(scene, cam, spp=128, sampler=samp, opts=opts)
    img_clear, _ = rdr.render(scene2, cam, spp=128, sampler=samp, opts=opts)
    # center pixels look at the floor under the slab: ratio ~ exp(-sigma*2)
    c = slice(4, 8)
    ratio = img_med[c, c].mean() / max(img_clear[c, c].mean(), 1e-9)
    np.testing.assert_allclose(ratio, np.exp(-sigma * thickness), rtol=0.1)


@pytest.mark.slow
def test_scattering_volume_furnace():
    """Purely scattering medium (albedo 1) in a uniform env: radiance == env
    everywhere (volumetric white furnace), for any density/g."""
    b = sc.SceneBuilder()
    m = b.materials.add_diffuse((0.5, 0.5, 0.5))
    # far-away tiny triangle so the scene has geometry
    b.add_mesh([[900, 900, 900], [901, 900, 900], [900, 901, 900]], [[0, 1, 2]], m)
    b.add_uniform_infinite_light(spc.ConstantSpectrum(1.0))
    b.media.add_homogeneous(sigma_a=(0.0,) * 3, sigma_s=(1.0,) * 3, g=0.3,
                            bounds_lo=(-2, -2, -2), bounds_hi=(2, 2, 2))
    scene = b.build(light_sampler="uniform", force_bvh=False)
    cam = _look_down_z(12, 12, fov=25)
    img, _ = rdr.render(scene, cam, spp=128,
                        sampler=smp.make_sampler("independent", spp=128),
                        opts=PathOptions(max_depth=48))
    mean = img.mean(axis=(0, 1))
    lum = 0.2126 * mean[0] + 0.7152 * mean[1] + 0.0722 * mean[2]
    np.testing.assert_allclose(lum, 1.0, rtol=0.05)


def test_grid_medium_density_lookup():
    from pbrt_jax import media as med_mod
    mb = med_mod.MediumBuilder()
    dens = np.zeros((4, 4, 4), np.float32)
    dens[1, 2, 3] = 8.0  # z=1, y=2, x=3
    mi = mb.add_grid(dens, (0, 0, 0), (4, 4, 4))
    pool = mb.build()
    idx = jnp.full((2,), mi, jnp.int32)
    row = med_mod.medium_row(pool, idx)
    # voxel centers: x=3.5, y=2.5, z=1.5
    p = jnp.asarray([[3.5, 2.5, 1.5], [0.5, 0.5, 0.5]])
    d = np.asarray(med_mod.density_at(pool, row, p))
    np.testing.assert_allclose(d, [8.0, 0.0], atol=1e-4)
    # outside the box -> 0
    p2 = jnp.asarray([[10.0, 0.0, 0.0], [-1.0, 0, 0]])
    d2 = np.asarray(med_mod.density_at(pool, row, p2))
    np.testing.assert_allclose(d2, 0.0)


@pytest.mark.slow
def test_grid_medium_beer_lambert():
    """Grid slab with constant density: same Beer-Lambert as homogeneous."""
    sigma = 0.4
    b = sc.SceneBuilder()
    _emissive_wall(b, L=1.0)
    dens = np.ones((4, 4, 4), np.float32)
    b.media.add_grid(dens, (-10, -10, -1), (10, 10, 1),
                     sigma_a=(sigma,) * 3, sigma_s=(0.0,) * 3)
    scene = b.build(light_sampler="uniform", force_bvh=False)
    cam = _look_down_z()
    img, _ = rdr.render(scene, cam, spp=256,
                        sampler=smp.make_sampler("independent", spp=256),
                        opts=PathOptions(max_depth=2))
    np.testing.assert_allclose(img.mean(), np.exp(-sigma * 2.0), rtol=0.06)


def test_rgbgrid_emissive_slab_analytic():
    """Pure-absorbing emissive RGBGrid slab viewed head-on: L =
    Le * (1 - exp(-sigma_a * depth)) analytically (emission source term
    integrated against its own attenuation; reference RGBGridMedium
    media.h:355 + the absorb-event emission, integrators.cpp:1006)."""
    from pbrt_jax import scene_core as sc
    from pbrt_jax import cameras as cam_mod
    from pbrt_jax import samplers as smp
    from pbrt_jax.integrators import render as rdr
    from pbrt_jax.integrators.path import PathOptions
    from pbrt_jax.utils import transform as tfm
    b = sc.SceneBuilder()
    b.materials.add_diffuse((0.0,) * 3)
    sig = 1.2
    le = 0.8
    n = 4
    sa = np.full((n, n, n, 3), sig, np.float32)
    ss = np.zeros((n, n, n, 3), np.float32)
    Le = np.full((n, n, n, 3), le, np.float32)
    mid = b.media.add_rgbgrid(sa, ss, (-1, -1, -1), (1, 1, 1), Le_rgb=Le)
    assert mid >= 0
    scene = b.build(force_bvh=False)
    assert scene.media.has_rgbgrid and scene.media.has_emissive
    cam = cam_mod.make_camera(
        "perspective", fov=8, width=8, height=8,
        camera_from_world=tfm.look_at((0, 0, 5), (0, 0, 0),
                                      (0, 1, 0)).inverse())
    img, _ = rdr.render(scene, cam, spp=64,
                        sampler=smp.make_sampler("independent", spp=64),
                        opts=PathOptions(max_depth=3))
    got = float(np.asarray(img)[2:6, 2:6].mean())
    want = le * (1.0 - np.exp(-sig * 2.0))   # slab depth 2
    assert abs(got - want) / want < 0.06, (got, want)


def test_cloud_medium_renders():
    """Baked procedural cloud (reference CloudMedium media.h:430 recipe):
    builds, has structure, renders finite."""
    from pbrt_jax import scene_core as sc
    from pbrt_jax import cameras as cam_mod
    from pbrt_jax import samplers as smp
    from pbrt_jax.integrators import render as rdr
    from pbrt_jax.integrators.path import PathOptions
    from pbrt_jax.utils import spectrum as spc
    from pbrt_jax.utils import transform as tfm
    b = sc.SceneBuilder()
    mg = b.materials.add_diffuse((0.4,) * 3)
    b.add_mesh([[-6, -1.5, -6], [6, -1.5, -6], [6, -1.5, 6], [-6, -1.5, 6]],
               [[0, 1, 2], [0, 2, 3]], mg)
    b.media.add_cloud((-1, -1, -1), (1, 1, 1), sigma_a=(0.3,) * 3,
                      sigma_s=(3.0,) * 3, scale=3.0, res=32)
    b.add_uniform_infinite_light(spc.ConstantSpectrum(1.0))
    scene = b.build(force_bvh=False)
    dens = np.asarray(scene.media.grid)
    assert dens.max() > 0.3 and dens.min() >= 0.0
    cam = cam_mod.make_camera(
        "perspective", fov=45, width=16, height=16,
        camera_from_world=tfm.look_at((0, 0.5, 4), (0, 0, 0),
                                      (0, 1, 0)).inverse())
    img, _ = rdr.render(scene, cam, spp=8,
                        sampler=smp.make_sampler("independent", spp=8),
                        opts=PathOptions(max_depth=4))
    assert np.isfinite(np.asarray(img)).all()
    assert float(np.asarray(img).mean()) > 0.05
