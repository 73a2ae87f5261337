"""RandomWalk and SimplePath integrators (reference cpu/integrators.h:115,
:183): unoptimized estimators must agree in expectation with the
MIS-weighted path integrator."""
import numpy as np
import pytest

from pbrt_jax import scenes, samplers as smp
from pbrt_jax.integrators import render as rdr
from pbrt_jax.integrators.path import PathOptions


@pytest.mark.parametrize("integ,tol,spp", [("simplepath", 0.05, 64),
                                           ("randomwalk", 0.25, 256)])
def test_matches_path_on_cornell(integ, tol, spp):
    scene, cam = scenes.make_cornell_box(width=32, height=32)
    opts = PathOptions(max_depth=4)
    s = smp.make_sampler("independent", spp=spp, full_resolution=(32, 32))
    img_p, _ = rdr.render(scene, cam, sampler=s, opts=opts,
                          integrator="path")
    img_s, _ = rdr.render(scene, cam, sampler=s, opts=opts, integrator=integ)
    r = img_s.mean() / img_p.mean()
    assert abs(r - 1.0) < tol, (integ, r)


def test_furnace_randomwalk():
    """RandomWalk on the furnace plane: mean luminance == albedo exactly
    (one bounce to a uniform environment)."""
    scene, cam = scenes.make_furnace_plane(albedo=0.5, width=24, height=24)
    s = smp.make_sampler("independent", spp=128, full_resolution=(24, 24))
    img, _ = rdr.render(scene, cam, sampler=s,
                        opts=PathOptions(max_depth=2),
                        integrator="randomwalk")
    lum = img @ np.asarray([0.2126, 0.7152, 0.0722])
    assert abs(lum.mean() - 0.5) < 0.04, lum.mean()


def test_simplevolpath_beer_lambert():
    """SimpleVolPath (reference integrators.h:239): absorbing slab before an
    emissive wall gives L = L0 exp(-sigma_a l) without any NEE machinery."""
    from pbrt_jax import scene_core as sc
    from pbrt_jax.utils import spectrum as spc
    from pbrt_jax import cameras as cm
    from pbrt_jax.utils import transform as tfm
    sigma = 0.4
    b = sc.SceneBuilder()
    m = b.materials.add_diffuse((0.0, 0.0, 0.0))
    b.add_mesh([[-20, -20, 5], [20, -20, 5], [20, 20, 5], [-20, 20, 5]],
               [[0, 2, 1], [0, 3, 2]], m, emission=spc.ConstantSpectrum(1.0))
    b.media.add_homogeneous(sigma_a=(sigma,) * 3, sigma_s=(0.0,) * 3,
                            bounds_lo=(-10, -10, -1), bounds_hi=(10, 10, 1))
    scene = b.build(light_sampler="uniform", force_bvh=False)
    cam = cm.make_camera(width=16, height=16, fov=30.0,
                         camera_from_world=tfm.identity())
    s = smp.make_sampler("independent", spp=256, full_resolution=(16, 16))
    img, _ = rdr.render(scene, cam, sampler=s, opts=PathOptions(max_depth=3),
                        integrator="simplevolpath")
    lum = img.mean()
    # camera at the origin sits inside the slab: traversed thickness is 1
    expect = np.exp(-sigma * 1.0)
    assert abs(lum / expect - 1.0) < 0.07, (lum, expect)


def test_simplevolpath_scattering_matches_volpath():
    """Scattering slab under a dome: phase-sampled walk must agree with the
    full volpath integrator in expectation."""
    from pbrt_jax import scene_core as sc
    from pbrt_jax import cameras as cm
    from pbrt_jax.utils import transform as tfm
    b = sc.SceneBuilder()
    b.media.add_homogeneous(sigma_a=(0.1,) * 3, sigma_s=(0.8,) * 3, g=0.2,
                            bounds_lo=(-6, -6, 1), bounds_hi=(6, 6, 3))
    from pbrt_jax.utils import spectrum as spc
    b.add_uniform_infinite_light(spc.ConstantSpectrum(1.0))
    scene = b.build(light_sampler="uniform", force_bvh=False)
    cam = cm.make_camera(width=16, height=16, fov=40.0,
                         camera_from_world=tfm.identity())
    s = smp.make_sampler("independent", spp=256, full_resolution=(16, 16))
    img_v, _ = rdr.render(scene, cam, sampler=s,
                          opts=PathOptions(max_depth=6),
                          integrator="volpath")
    img_s, _ = rdr.render(scene, cam, sampler=s,
                          opts=PathOptions(max_depth=6),
                          integrator="simplevolpath")
    assert abs(img_s.mean() / img_v.mean() - 1.0) < 0.08, \
        (img_s.mean(), img_v.mean())
