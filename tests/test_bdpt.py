"""BDPT integrator (reference cpu/integrators.h:345 BDPTIntegrator):
bidirectional estimates must agree with forward path tracing."""
import numpy as np
import pytest

from pbrt_jax import scene_core as sc
from pbrt_jax import scenes, samplers as smp, cameras as cm
from pbrt_jax.integrators import render as rdr
from pbrt_jax.integrators.path import PathOptions
from pbrt_jax.utils import spectrum as spc
from pbrt_jax.utils import transform as tfm


def test_direct_lighting_matches_path():
    """max_depth=2: strategies (s,t) = (0,3),(1,2),(2,2),(t=1) must combine
    to the same direct+one-bounce image path tracing gives."""
    b = sc.SceneBuilder()
    md = b.materials.add_diffuse((0.6, 0.6, 0.6))
    mb = b.materials.add_diffuse((0.0, 0.0, 0.0))
    b.add_mesh([[-1, 2, 2], [1, 2, 2], [1, 2, 4], [-1, 2, 4]],
               [[0, 1, 2], [0, 2, 3]], mb,
               emission=spc.ConstantSpectrum(8.0))
    b.add_mesh([[-4, -1, 0], [-4, -1, 8], [4, -1, 8], [4, -1, 0]],
               [[0, 1, 2], [0, 2, 3]], md)
    scene = b.build(light_sampler="power", force_bvh=False)
    cam = cm.make_camera(width=32, height=32, fov=70.0,
                         camera_from_world=tfm.identity())
    opts = PathOptions(max_depth=2)
    s = smp.make_sampler("independent", spp=64, full_resolution=(32, 32))
    img_p, _ = rdr.render(scene, cam, sampler=s, opts=opts,
                          integrator="path")
    img_b, _ = rdr.render(scene, cam, sampler=s, opts=opts,
                          integrator="bdpt")
    assert abs(img_b.mean() / img_p.mean() - 1.0) < 0.05, \
        (img_b.mean(), img_p.mean())


@pytest.mark.slow
def test_cornell_bdpt_matches_path():
    scene, cam = scenes.make_cornell_box(width=40, height=40)
    opts = PathOptions(max_depth=4)
    s = smp.make_sampler("independent", spp=64, full_resolution=(40, 40))
    img_p, _ = rdr.render(scene, cam, sampler=s, opts=opts,
                          integrator="path")
    img_b, _ = rdr.render(scene, cam, sampler=s, opts=opts,
                          integrator="bdpt")
    assert abs(img_b.mean() / img_p.mean() - 1.0) < 0.04
    for c in range(3):
        r = img_b[..., c].mean() / img_p[..., c].mean()
        assert abs(r - 1.0) < 0.06, (c, r)
    bp = img_p.reshape(8, 5, 8, 5, 3).mean(axis=(1, 3, 4))
    bb = img_b.reshape(8, 5, 8, 5, 3).mean(axis=(1, 3, 4))
    rel = np.abs(bb - bp) / np.maximum(bp, 0.05)
    assert np.percentile(rel, 90) < 0.25, np.percentile(rel, 90)


@pytest.mark.slow
def test_bdpt_specular_scene_matches_path():
    """Delta vertices: a smooth conductor floor under an area light —
    exercises the specular pdf_fwd/pdf_rev = 0 and delta-flag MIS rules."""
    b = sc.SceneBuilder()
    mb = b.materials.add_diffuse((0.0, 0.0, 0.0))
    mwall = b.materials.add_diffuse((0.7, 0.7, 0.7))
    mmirror = b.materials.add_conductor(roughness=0.0)
    b.add_mesh([[-1, 2.5, 2], [1, 2.5, 2], [1, 2.5, 4], [-1, 2.5, 4]],
               [[0, 1, 2], [0, 2, 3]], mb,
               emission=spc.ConstantSpectrum(6.0))
    # mirror floor
    b.add_mesh([[-4, -1, 0], [-4, -1, 8], [4, -1, 8], [4, -1, 0]],
               [[0, 1, 2], [0, 2, 3]], mmirror)
    # diffuse back wall catches the reflected light
    b.add_mesh([[-4, -1, 7], [4, -1, 7], [4, 4, 7], [-4, 4, 7]],
               [[0, 1, 2], [0, 2, 3]], mwall)
    scene = b.build(light_sampler="power", force_bvh=False)
    cam = cm.make_camera(width=32, height=32, fov=70.0,
                         camera_from_world=tfm.identity())
    opts = PathOptions(max_depth=4)
    s = smp.make_sampler("independent", spp=128, full_resolution=(32, 32))
    img_p, _ = rdr.render(scene, cam, sampler=s, opts=opts,
                          integrator="path")
    img_b, _ = rdr.render(scene, cam, sampler=s, opts=opts,
                          integrator="bdpt")
    assert abs(img_b.mean() / img_p.mean() - 1.0) < 0.08, \
        (img_b.mean(), img_p.mean())


def test_bdpt_envlit_matches_path():
    """Infinite-light vertices (reference integrators.cpp:1668-1690): an
    env-lit scene must agree between BDPT (escaped-ray light vertices with
    InfiniteLightDensity MIS) and forward path tracing. Before round 4,
    env contributions only flowed through s=0 at weight computed without
    the infinite-light pdfs, biasing env-lit scenes."""
    scene, cam = scenes.make_furnace_plane(albedo=0.6, env_radiance=1.0,
                                           width=32, height=32)
    opts = PathOptions(max_depth=3)
    s = smp.make_sampler("independent", spp=32, full_resolution=(32, 32))
    img_p, _ = rdr.render(scene, cam, sampler=s, opts=opts,
                          integrator="path")
    img_b, _ = rdr.render(scene, cam, sampler=s, opts=opts,
                          integrator="bdpt")
    assert abs(img_b.mean() / img_p.mean() - 1.0) < 0.05, \
        (img_b.mean(), img_p.mean())


def _fog_wall_scene(sigma_a, sigma_s, g=0.0, floor=False):
    """Emissive wall at z=5 seen through a homogeneous fog box
    (reference Vertex::CreateMedium scenes, integrators.cpp:1595)."""
    b = sc.SceneBuilder()
    m = b.materials.add_diffuse((0.0, 0.0, 0.0))
    b.add_mesh([[-20, -20, 5.0], [20, -20, 5.0], [20, 20, 5.0],
                [-20, 20, 5.0]],
               [[0, 2, 1], [0, 3, 2]], m,
               emission=spc.ConstantSpectrum(1.0))
    if floor:
        mf = b.materials.add_diffuse((0.6, 0.6, 0.6))
        b.add_mesh([[-20, -1.5, -9], [20, -1.5, -9], [20, -1.5, 5],
                    [-20, -1.5, 5]],
                   [[0, 1, 2], [0, 2, 3]], mf)
    b.media.add_homogeneous(sigma_a=sigma_a, sigma_s=sigma_s, g=g,
                            bounds_lo=(-10, -10, -1), bounds_hi=(10, 10, 2))
    scene = b.build(light_sampler="uniform", force_bvh=False)
    cam = cm.make_camera(
        "perspective",
        camera_from_world=tfm.look_at((0, 0, -10), (0, 0, 0),
                                      (0, 1, 0)).inverse(),
        width=8, height=8, fov=10.0)
    return scene, cam


@pytest.mark.slow
def test_bdpt_fog_absorption_analytic():
    """Pure-absorption fog: BDPT's pass-through weights and connection
    transmittance must reproduce exp(-sigma_a * 3) exactly (the box spans
    z in [-1, 2] along the view ray)."""
    s_a = 0.4
    scene, cam = _fog_wall_scene((s_a,) * 3, (0.0,) * 3)
    s = smp.make_sampler("independent", spp=256, full_resolution=(8, 8))
    img_b, _ = rdr.render(scene, cam, sampler=s,
                          opts=PathOptions(max_depth=2), integrator="bdpt")
    expect = np.exp(-s_a * 3.0)
    np.testing.assert_allclose(img_b.mean(), expect, rtol=0.06)


@pytest.mark.slow
def test_bdpt_fog_scattering_matches_volpath():
    """Scattering fog (medium vertices): BDPT with HG medium vertices,
    phase MIS pdfs and transmittance-weighted connections must agree with
    the volpath oracle (reference RandomWalk mi.phase branch,
    integrators.cpp:1964)."""
    scene, cam = _fog_wall_scene((0.05,) * 3, (0.35,) * 3, g=0.3,
                                 floor=True)
    s = smp.make_sampler("independent", spp=512, full_resolution=(8, 8))
    opts = PathOptions(max_depth=3)
    img_v, _ = rdr.render(scene, cam, sampler=s, opts=opts,
                          integrator="volpath")
    img_b, _ = rdr.render(scene, cam, sampler=s, opts=opts,
                          integrator="bdpt")
    assert abs(img_b.mean() / img_v.mean() - 1.0) < 0.08, \
        (img_b.mean(), img_v.mean())


@pytest.mark.slow
def test_bdpt_grid_media_falls_back_to_volpath():
    """Grid (heterogeneous) media are outside BDPT's medium-vertex scope
    (homogeneous point-in-box only, module docstring): the render driver
    must route such scenes to volpath with a warning instead of silently
    ignoring the medium (VERDICT r4 #9). Gate: integrator='bdpt' on a
    grid-fog scene reproduces the analytic transmittance (which the
    surface-only BDPT would miss entirely)."""
    from pbrt_jax.integrators import bdpt as bdpt_mod
    from pbrt_jax.integrators import render as rdr_mod
    sigma = 0.4
    b = sc.SceneBuilder()
    m = b.materials.add_diffuse((0.0, 0.0, 0.0))
    b.add_mesh([[-20, -20, 5.0], [20, -20, 5.0], [20, 20, 5.0],
                [-20, 20, 5.0]],
               [[0, 2, 1], [0, 3, 2]], m,
               emission=spc.ConstantSpectrum(1.0))
    dens = np.ones((4, 4, 4), np.float32)
    b.media.add_grid(dens, (-10, -10, -1), (10, 10, 2),
                     sigma_a=(sigma,) * 3, sigma_s=(0.0,) * 3)
    scene = b.build(light_sampler="uniform", force_bvh=False)
    assert not bdpt_mod.bdpt_supports_media(scene)
    assert rdr_mod.wave_module(scene, "bdpt") is not bdpt_mod
    # homogeneous scenes stay on BDPT
    scene_h, _cam = _fog_wall_scene((sigma,) * 3, (0.0,) * 3)
    assert bdpt_mod.bdpt_supports_media(scene_h)
    assert rdr_mod.wave_module(scene_h, "bdpt") is bdpt_mod
    cam = cm.make_camera(
        "perspective",
        camera_from_world=tfm.look_at((0, 0, -10), (0, 0, 0),
                                      (0, 1, 0)).inverse(),
        width=8, height=8, fov=10.0)
    s = smp.make_sampler("independent", spp=128, full_resolution=(8, 8))
    img, _ = rdr.render(scene, cam, sampler=s,
                        opts=PathOptions(max_depth=2), integrator="bdpt")
    np.testing.assert_allclose(img.mean(), np.exp(-sigma * 3.0), rtol=0.06)
