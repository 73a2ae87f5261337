"""Camera + AOV/G-buffer tests (reference cameras tests + GBufferFilm)."""
import jax.numpy as jnp
import numpy as np
import pytest

from pbrt_jax import cameras as cm
from pbrt_jax import scenes
from pbrt_jax.utils import transform as tfm


def test_perspective_ray_directions():
    cam = cm.make_camera("perspective", width=64, height=64, fov=90.0)
    # center pixel looks straight down +z (identity camera-to-world)
    p = jnp.asarray([[32.0, 32.0]])
    o, d, _ = cm.generate_ray(cam, p, jnp.zeros((1, 2)), jnp.zeros((1,)))
    np.testing.assert_allclose(np.asarray(o)[0], 0, atol=1e-6)
    np.testing.assert_allclose(np.asarray(d)[0], [0, 0, 1], atol=1e-5)
    # corner pixel: 45 deg off-axis horizontally at fov 90
    p2 = jnp.asarray([[0.0, 32.0]])
    _, d2, _ = cm.generate_ray(cam, p2, jnp.zeros((1, 2)), jnp.zeros((1,)))
    d2 = np.asarray(d2)[0]
    assert abs(abs(np.degrees(np.arctan2(d2[0], d2[2]))) - 45.0) < 0.5


def test_orthographic_rays_parallel():
    cam = cm.make_camera("orthographic", width=32, height=32)
    px = jnp.asarray([[4.0, 4.0], [28.0, 28.0]])
    o, d, _ = cm.generate_ray(cam, px, jnp.zeros((2, 2)), jnp.zeros((2,)))
    d = np.asarray(d)
    np.testing.assert_allclose(d[0], d[1], atol=1e-6)  # parallel
    o = np.asarray(o)
    assert np.linalg.norm(o[0] - o[1]) > 0.1  # origins differ


def test_spherical_camera_covers_sphere():
    cam = cm.make_camera("spherical", width=64, height=32, mapping="equalarea")
    xs, ys = np.meshgrid(np.arange(64) + 0.5, np.arange(32) + 0.5)
    p = jnp.asarray(np.stack([xs.ravel(), ys.ravel()], -1), jnp.float32)
    _, d, _ = cm.generate_ray(cam, p, jnp.zeros((p.shape[0], 2)),
                              jnp.zeros((p.shape[0],)))
    d = np.asarray(d)
    np.testing.assert_allclose(np.linalg.norm(d, axis=-1), 1.0, atol=1e-4)
    # directions cover both hemispheres in every axis
    for k in range(3):
        assert d[:, k].min() < -0.5 and d[:, k].max() > 0.5


def test_depth_of_field_blurs_off_focus():
    cam = cm.make_camera("perspective", width=16, height=16, fov=40,
                         lens_radius=0.2, focal_distance=5.0)
    p = jnp.tile(jnp.asarray([[8.0, 8.0]]), (64, 1))
    u_lens = jnp.asarray(np.random.RandomState(0).rand(64, 2), jnp.float32)
    o, d, _ = cm.generate_ray(cam, p, u_lens, jnp.zeros((64,)))
    o, d = np.asarray(o), np.asarray(d)
    # all rays converge at the focal plane z = 5
    t = (5.0 - o[:, 2]) / d[:, 2]
    pts = o + t[:, None] * d
    assert pts.std(axis=0).max() < 1e-3
    # but origins are spread over the lens
    assert o[:, 0].std() > 0.05


def test_aov_pass():
    from pbrt_jax.integrators import aov
    scene, cam = scenes.make_cornell_box(width=24, height=24)
    out = aov.render_aovs(scene, cam, spp=2)
    assert out["z"].shape == (24, 24)
    assert out["n"].shape == (24, 24, 3)
    assert out["albedo"].shape == (24, 24, 3)
    # center of the image hits the box: depth in a plausible range (mm scale)
    assert 500 < out["z"][12, 12] < 2000
    # hit mask mostly true
    assert out["hit"].mean() > 0.9
    # normals are unit-ish where hit
    nl = np.linalg.norm(out["n"], axis=-1)
    assert nl[out["hit"] > 0.5].max() <= 1.01
