"""AO integrator (reference AOIntegrator, cpu/integrators.h:296).
Analytic oracle: unoccluded plane -> AO == 1 exactly in expectation;
a point under an enclosing box -> 0."""
import numpy as np

from pbrt_jax import scene_core as sc
from pbrt_jax import cameras as cam_mod
from pbrt_jax import samplers as smp
from pbrt_jax.integrators import render as rdr
from pbrt_jax.integrators.path import PathOptions
from pbrt_jax.utils import transform as tfm


def _cam():
    return cam_mod.make_camera(
        "perspective", fov=30, width=16, height=16,
        camera_from_world=tfm.look_at((0, 3, 0.01), (0, 0, 0),
                                      (0, 1, 0)).inverse())


def test_ao_open_plane_is_one():
    b = sc.SceneBuilder()
    m = b.materials.add_diffuse((0.5,) * 3)
    b.add_mesh([[-50, 0, -50], [50, 0, -50], [50, 0, 50], [-50, 0, 50]],
               [[0, 1, 2], [0, 2, 3]], m)
    scene = b.build(force_bvh=False)
    img, _ = rdr.render(scene, _cam(), spp=16,
                        sampler=smp.make_sampler("independent", spp=16),
                        opts=PathOptions(max_depth=1), integrator="ao")
    # cosine-weighted visibility over an open hemisphere == 1
    assert abs(float(np.asarray(img).mean()) - 1.0) < 0.02


def test_ao_under_box_is_dark():
    b = sc.SceneBuilder()
    m = b.materials.add_diffuse((0.5,) * 3)
    b.add_mesh([[-50, 0, -50], [50, 0, -50], [50, 0, 50], [-50, 0, 50]],
               [[0, 1, 2], [0, 2, 3]], m)
    # low ceiling over the whole visible area; camera INSIDE the cavity
    b.add_mesh([[-50, 0.2, -50], [50, 0.2, -50], [50, 0.2, 50],
                [-50, 0.2, 50]], [[0, 2, 1], [0, 3, 2]], m)
    scene = b.build(force_bvh=False)
    cam = cam_mod.make_camera(
        "perspective", fov=60, width=16, height=16,
        camera_from_world=tfm.look_at((0, 0.15, 0.01), (0, 0, 0),
                                      (0, 1, 0)).inverse())
    img, _ = rdr.render(scene, cam, spp=16,
                        sampler=smp.make_sampler("independent", spp=16),
                        opts=PathOptions(max_depth=1), integrator="ao")
    center = np.asarray(img)[6:10, 6:10]
    assert float(center.mean()) < 0.02
