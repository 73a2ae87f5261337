"""End-to-end radiometric tests (reference integrators_test.cpp pattern:
render analytic scenes, check scene averages, tolerance ~2.5%)."""
import numpy as np
import pytest

from pbrt_jax import scenes
from pbrt_jax import samplers as smp
from pbrt_jax.integrators import render as rdr
from pbrt_jax.integrators.path import PathOptions


def test_furnace_plane_single_bounce():
    """Diffuse plane under uniform env: pixel value == albedo * L_env.
    Exercises: camera, intersection, NEE+MIS vs env light, BSDF sampling."""
    scene, cam = scenes.make_furnace_plane(albedo=0.6, env_radiance=1.0,
                                           width=48, height=48)
    img, stats = rdr.render(scene, cam, spp=32,
                            sampler=smp.make_sampler("independent", spp=32),
                            opts=PathOptions(max_depth=3))
    # luminance of a constant 0.6-reflectance under equal-energy env in sRGB:
    # spectral albedo is flat 0.6, env flat 1 -> reflected spectrum flat 0.6
    # -> y = 0.6 (XYZ Y of constant spectrum w/ our normalization)
    mean = img.mean(axis=(0, 1))
    lum = 0.2126 * mean[0] + 0.7152 * mean[1] + 0.0722 * mean[2]
    assert abs(lum - 0.6) < 0.025, f"lum={lum}, rgb={mean}"


def test_furnace_plane_large_coordinates():
    """Same furnace but with hit points at |p| ~ 10^3 (scene translated to
    (2000, -500, 1500)): guards the conservative-t / offset-ray robustness
    at large scene coordinates, where the round-3 regression silently lost
    ~11% of the energy to false self-intersections."""
    scene, cam = scenes.make_furnace_plane(albedo=0.6, env_radiance=1.0,
                                           width=48, height=48,
                                           center=(2000.0, -500.0, 1500.0))
    img, stats = rdr.render(scene, cam, spp=32,
                            sampler=smp.make_sampler("independent", spp=32),
                            opts=PathOptions(max_depth=3))
    mean = img.mean(axis=(0, 1))
    lum = 0.2126 * mean[0] + 0.7152 * mean[1] + 0.0722 * mean[2]
    assert abs(lum - 0.6) < 0.025, f"lum={lum}, rgb={mean}"


@pytest.mark.slow
def test_white_furnace_sphere():
    """Albedo-1 sphere in uniform env: every pixel == env radiance
    (energy conservation through multiple bounces + RR)."""
    scene, cam = scenes.make_furnace_sphere(albedo=1.0, env_radiance=1.0,
                                            width=32, height=32, subdiv=2)
    img, _ = rdr.render(scene, cam, spp=64,
                        sampler=smp.make_sampler("independent", spp=64),
                        opts=PathOptions(max_depth=40))
    mean = img.mean(axis=(0, 1))
    lum = 0.2126 * mean[0] + 0.7152 * mean[1] + 0.0722 * mean[2]
    # small loss from finite depth + RR variance
    assert abs(lum - 1.0) < 0.03, f"lum={lum}, rgb={mean}"


@pytest.mark.slow
def test_cornell_box_renders():
    """Cornell smoke test: renders, is finite, has expected structure
    (light bright, red wall reddish on left, green wall on right)."""
    scene, cam = scenes.make_cornell_box(width=64, height=64)
    img, stats = rdr.render(scene, cam, spp=16,
                            sampler=smp.make_sampler("zsobol", spp=16,
                                                     full_resolution=(64, 64)),
                            opts=PathOptions(max_depth=5))
    assert np.isfinite(img).all()
    assert img.max() > 0.5  # light source visible
    # left half should be redder than right half; right greener
    left = img[:, :10].mean(axis=(0, 1))
    right = img[:, -10:].mean(axis=(0, 1))
    assert left[0] / max(left[1], 1e-6) > right[0] / max(right[1], 1e-6)
    assert right[1] / max(right[0], 1e-6) > left[1] / max(left[0], 1e-6)
    # energy sane: mean luminance in a plausible range
    lum = (0.2126 * img[..., 0] + 0.7152 * img[..., 1] + 0.0722 * img[..., 2]).mean()
    assert 0.05 < lum < 2.0, lum


@pytest.mark.slow
def test_sampler_convergence_order():
    """ZSobol at 16spp should have lower error than independent at 16spp on
    the furnace plane (QMC beats MC)."""
    scene, cam = scenes.make_furnace_plane(albedo=0.5, env_radiance=1.0,
                                           width=32, height=32)
    opts = PathOptions(max_depth=2)
    img_mc, _ = rdr.render(scene, cam, spp=16,
                           sampler=smp.make_sampler("independent", spp=16), opts=opts)
    img_qmc, _ = rdr.render(scene, cam, spp=16,
                            sampler=smp.make_sampler("zsobol", spp=16,
                                                     full_resolution=(32, 32)), opts=opts)
    lum = lambda im: 0.2126 * im[..., 0] + 0.7152 * im[..., 1] + 0.0722 * im[..., 2]
    err_mc = np.abs(lum(img_mc) - 0.5).mean()
    err_qmc = np.abs(lum(img_qmc) - 0.5).mean()
    assert err_qmc < err_mc * 1.1, (err_qmc, err_mc)


@pytest.mark.slow
def test_analytic_sphere_matches_tessellated():
    """Quadric sphere renders ~ the same as a finely tessellated mesh sphere
    (exercises _merge_sphere_hits + shading)."""
    from pbrt_jax import scene_core as sc
    from pbrt_jax import cameras as cm
    from pbrt_jax.utils import transform as tfm
    from pbrt_jax.utils import spectrum as spc
    import jax.numpy as jnp

    def build(analytic):
        b = sc.SceneBuilder()
        m = b.materials.add_diffuse((0.6, 0.6, 0.6))
        if analytic:
            b.add_sphere((0, 0, 0), 1.0, m)
        else:
            v, f, n = scenes.make_sphere_mesh((0, 0, 0), 1.0, 4)
            b.add_mesh(v, f, m, normals=n)
        b.add_uniform_infinite_light(spc.ConstantSpectrum(1.0))
        return b.build(light_sampler="uniform", force_bvh=False)

    cam = cm.make_camera(
        "perspective",
        camera_from_world=tfm.look_at((0, 0, -4), (0, 0, 0), (0, 1, 0)).inverse(),
        width=32, height=32, fov=40)
    opts = PathOptions(max_depth=4)
    samp = smp.make_sampler("independent", spp=48)
    img_a, _ = rdr.render(build(True), cam, spp=48, sampler=samp, opts=opts)
    img_t, _ = rdr.render(build(False), cam, spp=48, sampler=samp, opts=opts)
    # means agree within MC noise
    assert abs(img_a.mean() - img_t.mean()) < 0.03, (img_a.mean(), img_t.mean())


@pytest.mark.slow
def test_emissive_sphere_light():
    """Sphere area light with cone-sampled NEE: irradiance on a floor point
    directly below a small sphere ~ L * pi * r^2 / d^2 (point-source limit);
    also exercises MIS (BSDF rays hitting the sphere)."""
    from pbrt_jax import scene_core as sc
    from pbrt_jax import cameras as cm
    from pbrt_jax.utils import transform as tfm
    from pbrt_jax.utils import spectrum as spc
    b = sc.SceneBuilder()
    m = b.materials.add_diffuse((1.0, 1.0, 1.0))
    b.add_mesh([[-20, 0, -20], [20, 0, -20], [20, 0, 20], [-20, 0, 20]],
               [[0, 1, 2], [0, 2, 3]], m)
    b.add_sphere((0, 4.0, 0), 0.5, m, emission=spc.ConstantSpectrum(10.0))
    scene = b.build(light_sampler="uniform", force_bvh=False)
    cam = cm.make_camera(
        "perspective",
        camera_from_world=tfm.look_at((0, 2.0, -6), (0, 0, 0), (0, 1, 0)).inverse(),
        width=24, height=24, fov=35)
    img, _ = rdr.render(scene, cam, spp=128,
                        sampler=smp.make_sampler("independent", spp=128),
                        opts=PathOptions(max_depth=2))
    # radiance of the white diffuse floor at the center (directly under the
    # light): L_o = albedo/pi * E; E ~ L*pi*r^2/d^2 (solid-angle limit):
    # = 10*pi*0.25/16 = 0.49; L_o ~ 0.156 (first bounce only, albedo 1)
    center = img[10:14, 10:14].mean()
    assert 0.1 < center < 0.25, center
    assert np.isfinite(img).all()


def test_compaction_matches_fused():
    """Lane compaction (PathOptions.compaction) must be a pure execution-
    strategy change: same sampler streams per lane, same image bit-for-bit
    (lane order is restored after the sort)."""
    scene, cam = scenes.make_cornell_box(width=32, height=32)
    sampler = smp.make_sampler("independent", spp=2)
    img_f, _ = rdr.render(scene, cam, spp=2, sampler=sampler,
                          opts=PathOptions(max_depth=5),
                          waves_per_dispatch=1)
    img_c, _ = rdr.render(scene, cam, spp=2, sampler=sampler,
                          opts=PathOptions(max_depth=5, compaction=True),
                          waves_per_dispatch=1)
    np.testing.assert_allclose(np.asarray(img_c), np.asarray(img_f),
                               rtol=1e-5, atol=1e-6)
