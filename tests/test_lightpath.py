"""LightPath integrator (reference cpu/integrators.h:322
LightPathIntegrator): adjoint transport from the lights with camera
connections must agree with forward path tracing."""
import numpy as np
import pytest

from pbrt_jax import scene_core as sc
from pbrt_jax import scenes, samplers as smp, cameras as cm
from pbrt_jax.integrators import render as rdr
from pbrt_jax.integrators.path import PathOptions
from pbrt_jax.utils import spectrum as spc
from pbrt_jax.utils import transform as tfm


def test_direct_visible_area_light_matches():
    """t=1 term: an emissive quad seen by the camera must splat the same
    image forward tracing produces."""
    b = sc.SceneBuilder()
    m = b.materials.add_diffuse((0.0, 0.0, 0.0))
    b.add_mesh([[-1, -1, 3], [-1, 1, 3], [1, 1, 3], [1, -1, 3]],
               [[0, 1, 2], [0, 2, 3]], m,
               emission=spc.ConstantSpectrum(2.0))
    scene = b.build(light_sampler="power", force_bvh=False)
    cam = cm.make_camera(width=24, height=24, fov=60.0,
                         camera_from_world=tfm.identity())
    opts = PathOptions(max_depth=2)
    s = smp.make_sampler("independent", spp=128, full_resolution=(24, 24))
    img_p, _ = rdr.render(scene, cam, sampler=s, opts=opts,
                          integrator="path")
    img_l, _ = rdr.render(scene, cam, sampler=s, opts=opts,
                          integrator="lightpath")
    assert abs(img_l.mean() / img_p.mean() - 1.0) < 0.05


@pytest.mark.slow
def test_cornell_lightpath_matches_path():
    scene, cam = scenes.make_cornell_box(width=48, height=48)
    opts = PathOptions(max_depth=5)
    s = smp.make_sampler("independent", spp=96, full_resolution=(48, 48))
    img_p, _ = rdr.render(scene, cam, sampler=s, opts=opts,
                          integrator="path")
    img_l, _ = rdr.render(scene, cam, sampler=s, opts=opts,
                          integrator="lightpath")
    # global energy agreement
    assert abs(img_l.mean() / img_p.mean() - 1.0) < 0.04
    # per-channel means agree too (color transport, not just luminance)
    for c in range(3):
        r = img_l[..., c].mean() / img_p[..., c].mean()
        assert abs(r - 1.0) < 0.06, (c, r)
    # coarse spatial agreement: 6x6 block means
    bp = img_p.reshape(8, 6, 8, 6, 3).mean(axis=(1, 3, 4))
    bl = img_l.reshape(8, 6, 8, 6, 3).mean(axis=(1, 3, 4))
    rel = np.abs(bl - bp) / np.maximum(bp, 0.05)
    assert np.percentile(rel, 90) < 0.25, np.percentile(rel, 90)
