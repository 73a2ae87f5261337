"""Texture + image-infinite-light tests."""
import jax.numpy as jnp
import numpy as np
import pytest

from pbrt_jax import textures as tex_mod
from pbrt_jax import lights as lgt
from pbrt_jax import scene_core as sc
from pbrt_jax import cameras as cm
from pbrt_jax import samplers as smp
from pbrt_jax.utils import color as pcolor
from pbrt_jax.utils import transform as tfm
from pbrt_jax.utils import image_env


def _albedo_of(pool, idx, uv, lam):
    c, s = tex_mod.eval_texture(pool, idx, uv)
    return np.asarray(pcolor.eval_rgb_sigmoid_polynomial(c, lam) * s[..., None])


def test_constant_texture():
    tb = tex_mod.TextureBuilder()
    t = tb.add_constant((0.25, 0.25, 0.25))
    pool = tb.build()
    lam = jnp.full((4, 4), 550.0)
    a = _albedo_of(pool, jnp.full(4, t, jnp.int32), jnp.zeros((4, 2)), lam)
    np.testing.assert_allclose(a, 0.25, atol=0.01)


def test_checker_texture():
    tb = tex_mod.TextureBuilder()
    t = tb.add_checker((0.9, 0.9, 0.9), (0.1, 0.1, 0.1))
    pool = tb.build()
    lam = jnp.full((2, 4), 550.0)
    uv = jnp.asarray([[0.5, 0.5], [1.5, 0.5]])
    a = _albedo_of(pool, jnp.full(2, t, jnp.int32), uv, lam)
    assert a[0].mean() > 0.7
    assert a[1].mean() < 0.2


def test_image_texture_bilinear():
    img = np.zeros((2, 2, 3), np.float32)
    img[0, 0] = 1.0  # one bright texel
    tb = tex_mod.TextureBuilder()
    t = tb.add_image(img)
    pool = tb.build()
    lam = jnp.full((2, 4), 550.0)
    # image textures flip t (reference textures.cpp:367): uv (0.25, 0.75)
    # lands on array texel (0,0) = the bright one; (0.75, 0.25) on (1,1)
    uv = jnp.asarray([[0.25, 0.75], [0.75, 0.25]])
    a = _albedo_of(pool, jnp.full(2, t, jnp.int32), uv, lam)
    assert a[0].mean() > 0.8
    assert a[1].mean() < 0.1


def test_perlin_noise_range_and_smoothness():
    p = jnp.asarray(np.random.RandomState(0).rand(256, 3) * 10, jnp.float32)
    n = np.asarray(tex_mod.perlin_noise(p))
    assert np.abs(n).max() <= 1.5
    # continuity: nearby points have nearby noise
    n2 = np.asarray(tex_mod.perlin_noise(p + 1e-3))
    assert np.abs(n - n2).max() < 0.05


def test_textured_material_renders():
    """Checkerboard floor seen by the camera shows contrast."""
    b = sc.SceneBuilder()
    t = b.textures.add_checker((0.9, 0.9, 0.9), (0.05, 0.05, 0.05), su=8, sv=8)
    m = b.materials.add_diffuse((0.5, 0.5, 0.5), albedo_tex=t)
    b.add_mesh([[-2, 0, -2], [2, 0, -2], [2, 0, 2], [-2, 0, 2]],
               [[0, 1, 2], [0, 2, 3]], m,
               uvs=[[0, 0], [1, 0], [1, 1], [0, 1]])
    from pbrt_jax.utils import spectrum as spc
    b.add_uniform_infinite_light(spc.ConstantSpectrum(1.0))
    scene = b.build(light_sampler="uniform", force_bvh=False)
    cam = cm.make_camera("perspective",
                         camera_from_world=tfm.look_at((0, 3, 0), (0, 0, 0.001),
                                                       (0, 0, 1)).inverse(),
                         width=32, height=32, fov=50)
    from pbrt_jax.integrators import render as rdr
    from pbrt_jax.integrators.path import PathOptions
    img, _ = rdr.render(scene, cam, spp=16,
                        sampler=smp.make_sampler("independent", spp=16),
                        opts=PathOptions(max_depth=2))
    lum = img.mean(axis=-1)
    assert lum.max() > 2.5 * max(lum.min(), 0.01)  # visible checker contrast


def test_env_light_mean_radiance():
    """Constant equal-area env map: every escaped ray sees L; a camera in an
    empty scene (tiny far-away tri) integrates to L."""
    img = np.full((16, 16, 3), 0.7, np.float32)
    b = sc.SceneBuilder()
    m = b.materials.add_diffuse((0.5, 0.5, 0.5))
    b.add_mesh([[1000, 1000, 1000], [1001, 1000, 1000], [1000, 1001, 1000]],
               [[0, 1, 2]], m)
    b.add_image_infinite_light(img)
    scene = b.build(light_sampler="power", force_bvh=False)
    cam = cm.make_camera("perspective",
                         camera_from_world=tfm.identity(), width=16, height=16)
    from pbrt_jax.integrators import render as rdr
    from pbrt_jax.integrators.path import PathOptions
    img_out, _ = rdr.render(scene, cam, spp=32,
                            sampler=smp.make_sampler("independent", spp=32),
                            opts=PathOptions(max_depth=2))
    mean = img_out.mean(axis=(0, 1))
    np.testing.assert_allclose(mean, 0.7, rtol=0.05)


def test_env_light_importance_sampling_direction():
    """Env with one bright texel: NEE should find it; furnace plane lit from
    a single direction behaves like a distant light."""
    img = np.full((16, 16, 3), 0.01, np.float32)
    # bright texel near map center -> some specific direction
    img[4, 4] = 100.0
    b = sc.SceneBuilder()
    m = b.materials.add_diffuse((0.8, 0.8, 0.8))
    b.add_mesh([[-5, 0, -5], [5, 0, -5], [5, 0, 5], [-5, 0, 5]],
               [[0, 1, 2], [0, 2, 3]], m)
    b.add_image_infinite_light(img)
    scene = b.build(light_sampler="power", force_bvh=False)
    cam = cm.make_camera("perspective",
                         camera_from_world=tfm.look_at((0, 3, 0), (0, 0, 0.001),
                                                       (0, 0, 1)).inverse(),
                         width=16, height=16, fov=40)
    from pbrt_jax.integrators import render as rdr
    from pbrt_jax.integrators.path import PathOptions
    img_out, _ = rdr.render(scene, cam, spp=64,
                            sampler=smp.make_sampler("independent", spp=64),
                            opts=PathOptions(max_depth=2))
    assert np.isfinite(img_out).all()
    assert img_out.mean() > 0.0


def test_env_pdf_consistency():
    """env_pdf_li must match the alias sampler's actual density."""
    rng = np.random.RandomState(0)
    img = rng.rand(8, 8, 3).astype(np.float32)
    env = lgt.make_env_light(img, pcolor.srgb())
    u2 = jnp.asarray(rng.rand(4096, 2), jnp.float32)
    lam = jnp.full((4096, 4), 550.0)
    p_ref = jnp.zeros((4096, 3))
    wi, L, pdf, _ = lgt.env_sample_li(env, p_ref, u2, lam, jnp.float32(1.0))
    pdf2 = np.asarray(lgt.env_pdf_li(env, wi))
    np.testing.assert_allclose(np.asarray(pdf), pdf2, rtol=1e-3)
    # integral check: E[1/pdf] over samples = 4pi (solid angle of sphere)
    est = (1.0 / np.asarray(pdf)).mean()
    np.testing.assert_allclose(est, 4 * np.pi, rtol=0.05)


def test_latlong_to_equalarea_preserves_energy():
    rng = np.random.RandomState(1)
    latlong = rng.rand(32, 64, 3).astype(np.float32)
    ea = image_env.equalarea_from_latlong(latlong, res=32)
    # equal-area resampling preserves the mean over the sphere (latlong mean
    # must be sin-theta weighted)
    theta = (np.arange(32) + 0.5) / 32 * np.pi
    w = np.sin(theta)[:, None, None]
    ll_mean = (latlong * w).sum() / (w.sum() * 64 * 3)
    np.testing.assert_allclose(ea.mean(), ll_mean, rtol=0.05)


def test_mix_family_textures():
    """TEX_MIX / TEX_DIRMIX / TEX_BILERP blend SPECTRALLY (reference
    textures.h:803-900, :333): amounts interpolate evaluated albedos."""
    import jax.numpy as jnp
    from pbrt_jax import textures as tex_mod
    from pbrt_jax.utils import spectrum as spc

    tb = tex_mod.TextureBuilder(None)
    red = tb.add_constant((0.8, 0.1, 0.1))
    blue = tb.add_constant((0.1, 0.1, 0.8))
    mix = tb.add_mix(red, blue, amount=0.25)
    dmix = tb.add_direction_mix(red, blue, dir=(0, 1, 0))
    bil = tb.add_bilerp((1, 0, 0), (0, 1, 0), (0, 0, 1), (1, 1, 1))
    pool = tb.build()
    assert pool.has_mixers

    lam = jnp.tile(jnp.asarray([[460.0, 550.0, 600.0, 630.0]]), (4, 1))
    uv = jnp.asarray([[0.3, 0.3]] * 4)
    a_red = tex_mod.eval_texture_spectral(pool, jnp.full(4, red), uv, lam)
    a_blue = tex_mod.eval_texture_spectral(pool, jnp.full(4, blue), uv, lam)

    # mix: (1-0.25)*red + 0.25*blue
    a_mix = tex_mod.eval_texture_spectral(pool, jnp.full(4, mix), uv, lam)
    np.testing.assert_allclose(np.asarray(a_mix),
                               0.75 * np.asarray(a_red) +
                               0.25 * np.asarray(a_blue), rtol=1e-5)

    # directionmix: n == dir -> amt=1 -> tex1; n perp dir -> tex2
    ns_up = jnp.asarray([[0.0, 1.0, 0.0]] * 4)
    ns_x = jnp.asarray([[1.0, 0.0, 0.0]] * 4)
    a_up = tex_mod.eval_texture_spectral(pool, jnp.full(4, dmix), uv, lam,
                                         ns=ns_up)
    a_x = tex_mod.eval_texture_spectral(pool, jnp.full(4, dmix), uv, lam,
                                        ns=ns_x)
    np.testing.assert_allclose(np.asarray(a_up), np.asarray(a_red),
                               rtol=1e-5)
    np.testing.assert_allclose(np.asarray(a_x), np.asarray(a_blue),
                               rtol=1e-5)

    # bilerp: corner uv reproduces the matching child's albedo
    for k, (u, v) in enumerate([(0.0, 0.0), (1.0, 0.0), (0.0, 1.0),
                                (1.0, 1.0)]):
        uvq = jnp.asarray([[u, v]] * 4)
        got = tex_mod.eval_texture_spectral(pool, jnp.full(4, bil), uvq,
                                            lam)
        want = tex_mod.eval_texture_spectral(
            pool, jnp.full(4, bil - 4 + k), uvq, lam)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=1e-5)
    # midpoint is the average of all four corners
    uvm = jnp.asarray([[0.5, 0.5]] * 4)
    am = tex_mod.eval_texture_spectral(pool, jnp.full(4, bil), uvm, lam)
    corners = []
    for idx in range(bil - 4, bil):  # the 4 auto-created constant children
        corners.append(np.asarray(tex_mod.eval_texture_spectral(
            pool, jnp.full(4, idx), uvm, lam)))
    np.testing.assert_allclose(np.asarray(am),
                               np.mean(corners, axis=0), rtol=1e-5)


def test_texture_mappings():
    """Spherical/cylindrical/planar coordinate mappings (reference
    textures.h:86-201 TextureMapping2D family)."""
    b = tex_mod.TextureBuilder()
    # checker with planar mapping: s = p.x, t = p.y
    t_pla = b.add_checker((1, 1, 1), (0, 0, 0))
    w2t = np.zeros((3, 4), np.float32)
    w2t[0, 0] = 1.0  # v1 = +x, udelta 0
    w2t[1, 1] = 1.0  # v2 = +y, vdelta 0
    b.set_mapping(t_pla, "planar", w2t)
    t_sph = b.add_checker((1, 1, 1), (0, 0, 0))
    b.set_mapping(t_sph, "spherical", np.eye(3, 4, dtype=np.float32))
    t_cyl = b.add_checker((1, 1, 1), (0, 0, 0))
    b.set_mapping(t_cyl, "cylindrical", np.eye(3, 4, dtype=np.float32))
    t_uv = b.add_checker((1, 1, 1), (0, 0, 0))
    pool = b.build()
    assert pool.has_mapped

    uv = jnp.asarray([[0.25, 0.25]] * 4)
    # planar: checker cell flips between p=(0.5,0.5) and p=(1.5,0.5)
    p = jnp.asarray([[0.5, 0.5, 0.0], [1.5, 0.5, 0.0],
                     [0.5, 1.5, 0.0], [1.5, 1.5, 0.0]])
    st = tex_mod.apply_mapping(pool, jnp.full(4, t_pla), uv, p)
    np.testing.assert_allclose(np.asarray(st), np.asarray(p[:, :2]),
                               atol=1e-6)

    # spherical: north pole -> theta 0 (s=0); equator +x -> s=0.5, t=0
    p_sph = jnp.asarray([[0.0, 0.0, 1.0], [1.0, 0.0, 0.0],
                         [0.0, 1.0, 0.0], [0.0, 0.0, -1.0]])
    st = np.asarray(tex_mod.apply_mapping(pool, jnp.full(4, t_sph), uv,
                                          p_sph))
    np.testing.assert_allclose(st[0, 0], 0.0, atol=1e-6)
    np.testing.assert_allclose(st[1], [0.5, 0.0], atol=1e-6)
    np.testing.assert_allclose(st[2], [0.5, 0.25], atol=1e-6)
    np.testing.assert_allclose(st[3, 0], 1.0, atol=1e-6)

    # cylindrical: s = (pi + atan2(y, x)) / 2pi, t = z
    p_cyl = jnp.asarray([[1.0, 0.0, 0.7], [-1.0, 0.0, -0.3],
                         [0.0, 1.0, 2.0], [0.0, -1.0, 0.0]])
    st = np.asarray(tex_mod.apply_mapping(pool, jnp.full(4, t_cyl), uv,
                                          p_cyl))
    np.testing.assert_allclose(st[:, 1], [0.7, -0.3, 2.0, 0.0], atol=1e-6)
    np.testing.assert_allclose(st[0, 0], 0.5, atol=1e-6)
    np.testing.assert_allclose(st[2, 0], 0.75, atol=1e-6)

    # uv rows pass uv through untouched
    st = tex_mod.apply_mapping(pool, jnp.full(4, t_uv), uv, p)
    np.testing.assert_allclose(np.asarray(st), np.asarray(uv), atol=0)

    # end-to-end: eval_texture on the planar checker alternates cells
    c, s = tex_mod.eval_texture(pool, jnp.full(4, t_pla), uv, p_world=p)
    # (0.5,0.5)->cell(0,0) white; (1.5,0.5)->cell(1,0) black; etc.
    got = np.asarray(s * 0 + np.asarray(c)[:, 0])  # coeff sign differs; use
    # scale channel select: white cell scale==row14, but simpler: compare
    # pairwise difference pattern
    assert not np.allclose(np.asarray(c[0]), np.asarray(c[1]))
    np.testing.assert_allclose(np.asarray(c[0]), np.asarray(c[3]), atol=1e-6)
    np.testing.assert_allclose(np.asarray(c[1]), np.asarray(c[2]), atol=1e-6)


def test_parser_texture_mapping_directive():
    """Parser accepts "string mapping" on 2D textures (VERDICT r3 #10)."""
    from pbrt_jax.scene import parser as pparser
    txt = b'''
    Integrator "path"
    Camera "perspective" "float fov" [45]
    Film "rgb" "integer xresolution" [8] "integer yresolution" [8]
    WorldBegin
    Texture "ck" "spectrum" "checkerboard"
        "string mapping" "planar"
        "vector3 v1" [2 0 0] "vector3 v2" [0 2 0] "float udelta" [0.5]
    Material "diffuse" "texture reflectance" "ck"
    Shape "trianglemesh" "integer indices" [0 1 2]
        "point3 P" [0 0 0  1 0 0  0 1 0]
    LightSource "infinite" "rgb L" [1 1 1]
    '''
    desc = pparser.parse_string(txt)
    pool = desc.scene.textures
    assert pool.has_mapped
    maps = np.asarray(pool.maps)
    rows = maps[maps[:, 0] == tex_mod.MAP_PLANAR]
    assert len(rows) == 1
    np.testing.assert_allclose(rows[0][1:5], [2, 0, 0, 0.5], atol=1e-6)
