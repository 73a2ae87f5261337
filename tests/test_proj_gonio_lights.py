"""Projection + Goniometric lights and bilinear env lookup (reference
lights.h:516/599/544)."""
import numpy as np
import jax.numpy as jnp

from pbrt_jax import scene_core as sc
from pbrt_jax import lights as lgt
from pbrt_jax.utils import spectrum as spc


def _sample_from(scene, light_idx, pts):
    n = pts.shape[0]
    swl = spc.sample_uniform_wavelengths(jnp.full((n,), 0.5))
    ls = lgt.sample_li(scene.lights, jnp.full((n,), light_idx, jnp.int32),
                       jnp.asarray(pts), jnp.zeros((n, 3)),
                       jnp.full((n, 2), 0.5), swl.lam, scene.spectra_pool,
                       scene.tri_geo, scene.scene_radius, env=scene.env)
    return ls


def test_projection_light_window():
    """Receivers inside the projection cone get light; outside get none."""
    b = sc.SceneBuilder()
    m = b.materials.add_diffuse((0.5,) * 3)
    b.add_mesh([[50, 50, 50], [51, 50, 50], [50, 51, 50]], [[0, 1, 2]], m)
    img = np.ones((4, 4, 3), np.float32)
    b.add_projection_light((0, 0, 0), (0, 0, 1), img,
                           spc.ConstantSpectrum(1.0), fov=60.0)
    scene = b.build(force_bvh=False)
    # inside the 60-degree cone (on-axis) vs far off-axis
    pts = np.asarray([[0, 0, 5.0], [5.0, 0, 0.1], [0, 0, -5.0]], np.float32)
    ls = _sample_from(scene, 0, pts)
    L = np.asarray(ls["L"]).sum(-1)
    assert L[0] > 0
    assert L[1] == 0 and L[2] == 0


def test_projection_image_modulates():
    """Half-dark projection image: the dark half projects no light."""
    b = sc.SceneBuilder()
    m = b.materials.add_diffuse((0.5,) * 3)
    b.add_mesh([[50, 50, 50], [51, 50, 50], [50, 51, 50]], [[0, 1, 2]], m)
    img = np.ones((8, 8, 3), np.float32)
    img[:, :4] = 0.0  # left half (u < 0.5) dark
    b.add_projection_light((0, 0, 0), (0, 0, 1), img,
                           spc.ConstantSpectrum(1.0), fov=90.0)
    scene = b.build(force_bvh=False)
    # receiver at +x maps to u > 0.5 (bright); -x maps dark
    pts = np.asarray([[2.0, 0, 5.0], [-2.0, 0, 5.0]], np.float32)
    ls = _sample_from(scene, 0, pts)
    L = np.asarray(ls["L"]).sum(-1)
    assert (L[0] > 0) != (L[1] > 0)  # exactly one side lit


def test_goniometric_light_runs_and_scales():
    b = sc.SceneBuilder()
    m = b.materials.add_diffuse((0.5,) * 3)
    b.add_mesh([[50, 50, 50], [51, 50, 50], [50, 51, 50]], [[0, 1, 2]], m)
    img = np.full((8, 8, 3), 0.25, np.float32)
    b.add_goniometric_light((0, 0, 0), img, spc.ConstantSpectrum(1.0),
                            scale=2.0)
    scene = b.build(force_bvh=False)
    pts = np.asarray([[0, 0, 3.0], [3.0, 0, 0], [0, -3.0, 0]], np.float32)
    ls = _sample_from(scene, 0, pts)
    L = np.asarray(ls["L"]).sum(-1)
    assert (L > 0).all()
    # uniform image -> isotropic: equal radiance at equal distance
    np.testing.assert_allclose(L, L[0], rtol=2e-2)


def test_env_bilinear_is_smooth():
    """Bilinear env lookup interpolates between texels (no nearest-texel
    stair-step): radiance varies smoothly along a path crossing texels."""
    from pbrt_jax.utils import color as pcolor
    rng = np.random.default_rng(0)
    img = rng.uniform(0.1, 1.0, (16, 16, 3)).astype(np.float32)
    env = lgt.make_env_light(img, pcolor.srgb())
    swl = spc.sample_uniform_wavelengths(jnp.full((64,), 0.5))
    # directions sweeping a small arc
    t = np.linspace(0, 0.2, 64)
    d = np.stack([np.sin(t), np.cos(t) * 0.3, np.cos(t)], -1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    L = np.asarray(lgt.env_radiance(env, jnp.asarray(d, jnp.float32),
                                    swl.lam)).sum(-1)
    # smooth: successive differences bounded well below the total range
    assert np.abs(np.diff(L)).max() < 0.6 * (L.max() - L.min() + 1e-9)


def test_parser_projection_and_gonio():
    from pbrt_jax.scene import parser
    desc = parser.parse_string('''
Camera "perspective"
Film "rgb" "integer xresolution" [8] "integer yresolution" [8]
WorldBegin
LightSource "projection" "float fov" [45]
LightSource "goniometric"
Material "diffuse"
Shape "trianglemesh" "point3 P" [-1 -1 -3  1 -1 -3  0 1 -3]
    "integer indices" [0 1 2]
''')
    tags = set(int(t) for t in np.asarray(desc.scene.lights.tag))
    assert lgt.LIGHT_PROJECTION in tags and lgt.LIGHT_GONIOMETRIC in tags
