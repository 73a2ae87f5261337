"""RealisticCamera lens-system tracing (reference cameras.h:466)."""
import pytest
import numpy as np
import jax.numpy as jnp

from pbrt_jax import cameras as cam_mod


def test_focus_gap_monotone_with_distance():
    gaps = []
    for fd in (0.8, 2.0, 8.0):
        cam = cam_mod.make_realistic_camera(width=16, height=16,
                                            focus_distance=fd)
        gaps.append(float(cam.rear_z))
    # focusing closer extends the lens away from the film
    assert gaps[0] > gaps[1] > gaps[2] > 0


def test_center_ray_is_axial():
    cam = cam_mod.make_realistic_camera(width=32, height=32)
    # geometric check on the rear-disk path (u=0.5 -> exact disk center);
    # the exit-pupil path centers on the tabulated bbox, which is only
    # grid-accurate
    o, d, t, w = cam_mod.generate_ray_weighted(
        cam.replace(exit_pupil=None), jnp.asarray([[16.0, 16.0]]),
        jnp.full((1, 2), 0.5), jnp.zeros(1))
    d = np.asarray(d)[0]
    assert float(w[0]) == 1.0
    np.testing.assert_allclose(d, [0, 0, 1], atol=1e-5)
    # pupil-sampled center ray: near-axial, weight = cos^4 * A_pupil/A_rear
    o, d, t, w = cam_mod.generate_ray_weighted(
        cam, jnp.asarray([[16.0, 16.0]]), jnp.full((1, 2), 0.5),
        jnp.zeros(1))
    assert 0.2 < float(w[0]) < 3.0
    np.testing.assert_allclose(np.asarray(d)[0], [0, 0, 1], atol=2e-2)


def test_exit_pupil_mean_preserved_variance_reduced():
    """Exit-pupil sampling (reference cameras.cpp:861 SampleExitPupil)
    must keep the image mean of rear-disk sampling (unbiasedness) while
    cutting the per-sample weight variance from vignetted samples."""
    # stopped-down aperture: the exit pupil is far smaller than the rear
    # element, so rear-disk sampling wastes most rays (VERDICT r3 #9)
    cam = cam_mod.make_realistic_camera(width=24, height=24,
                                        aperture_diameter=0.008)
    cam_disk = cam.replace(exit_pupil=None)
    n = 4096
    rng = np.random.default_rng(7)
    # off-center film point (vignetting is worst off-axis)
    pf = jnp.tile(jnp.asarray([[19.0, 12.0]]), (n, 1))
    u = jnp.asarray(rng.uniform(0, 1, (n, 2)), jnp.float32)
    _, _, _, w_pup = cam_mod.generate_ray_weighted(cam, pf, u, jnp.zeros(n))
    _, _, _, w_dsk = cam_mod.generate_ray_weighted(cam_disk, pf, u,
                                                   jnp.zeros(n))
    w_pup, w_dsk = np.asarray(w_pup), np.asarray(w_dsk)
    # same expected weight (the pupil-area ratio keeps it unbiased)
    assert abs(w_pup.mean() / max(w_dsk.mean(), 1e-9) - 1.0) < 0.05, \
        (w_pup.mean(), w_dsk.mean())
    # far fewer dead (vignetted) samples and lower relative variance
    assert (w_pup > 0).mean() > (w_dsk > 0).mean() + 0.1
    rv_pup = w_pup.var() / max(w_pup.mean() ** 2, 1e-12)
    rv_dsk = w_dsk.var() / max(w_dsk.mean() ** 2, 1e-12)
    assert rv_pup < rv_dsk, (rv_pup, rv_dsk)


def test_focus_converges_point():
    """Rays from one film point through different lens samples converge
    near the focus distance (the definition of being in focus)."""
    fd = 2.0
    cam = cam_mod.make_realistic_camera(width=64, height=64,
                                        focus_distance=fd)
    n = 64
    rng = np.random.default_rng(0)
    pf = jnp.tile(jnp.asarray([[40.0, 32.0]]), (n, 1))  # off-center pixel
    u = jnp.asarray(rng.uniform(0.2, 0.8, (n, 2)), jnp.float32)
    o, d, t, w = cam_mod.generate_ray_weighted(cam, pf, u, jnp.zeros(n))
    o, d, w = np.asarray(o), np.asarray(d), np.asarray(w)
    live = w > 0
    assert live.sum() > 10
    # intersect each ray with the plane z = fd; spread should be tiny
    tt = (fd - o[live, 2]) / d[live, 2]
    pts = o[live] + tt[:, None] * d[live]
    spread = pts[:, :2].std(axis=0).max()
    assert spread < 0.01, spread   # <1cm blur at the focal plane
    # and clearly larger away from focus
    tt2 = (0.5 - o[live, 2]) / d[live, 2]
    pts2 = o[live] + tt2[:, None] * d[live]
    assert pts2[:, :2].std(axis=0).max() > 3 * spread


def test_vignetting_at_extreme_apertures():
    """Stopping down the aperture kills more off-axis lens samples."""
    cam_open = cam_mod.make_realistic_camera(width=32, height=32)
    cam_stop = cam_mod.make_realistic_camera(width=32, height=32,
                                             aperture_diameter=0.004)
    n = 256
    rng = np.random.default_rng(1)
    pf = jnp.tile(jnp.asarray([[16.0, 16.0]]), (n, 1))
    u = jnp.asarray(rng.uniform(0, 1, (n, 2)), jnp.float32)
    _, _, _, w_open = cam_mod.generate_ray_weighted(cam_open, pf, u,
                                                    jnp.zeros(n))
    _, _, _, w_stop = cam_mod.generate_ray_weighted(cam_stop, pf, u,
                                                    jnp.zeros(n))
    assert np.asarray(w_stop).mean() < np.asarray(w_open).mean()


@pytest.mark.slow
def test_realistic_render_smoke():
    from pbrt_jax import scene_core as sc
    from pbrt_jax.integrators import render as rdr
    from pbrt_jax.integrators.path import PathOptions
    from pbrt_jax.utils import spectrum as spc, transform as tfm
    b = sc.SceneBuilder()
    m = b.materials.add_diffuse((0.7, 0.3, 0.3))
    b.add_mesh([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]],
               [[0, 1, 2], [0, 2, 3]], m)
    b.add_uniform_infinite_light(spc.ConstantSpectrum(1.0))
    scene = b.build(force_bvh=False)
    cam = cam_mod.make_realistic_camera(
        width=16, height=16, focus_distance=2.0,
        camera_from_world=tfm.look_at((0, 0, -2), (0, 0, 0),
                                      (0, 1, 0)).inverse())
    img, _ = rdr.render(scene, cam, spp=8, opts=PathOptions(max_depth=2))
    a = np.asarray(img)
    assert np.isfinite(a).all() and a.max() > 0
