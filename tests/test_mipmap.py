"""MIPMap pyramid + trilinear/EWA filtering (reference util/mipmap.h:49).

The pyramid is stored in the texture atlas with per-level offsets; LOD is
selected from the ray-cone uv footprint."""
import pytest
import numpy as np
import jax.numpy as jnp

from pbrt_jax import textures as tex_mod


def _pool_with_image(img, raw=False):
    tb = tex_mod.TextureBuilder()
    idx = tb.add_image(np.asarray(img, np.float32))
    return tb.build(), idx


def test_pyramid_levels_and_offsets():
    img = np.arange(16, dtype=np.float32).reshape(4, 4) / 16.0
    pool, idx = _pool_with_image(img)
    mips = np.asarray(pool.mips)[idx]
    assert mips[0] == 3  # 4x4 -> 2x2 -> 1x1
    # offsets strictly increasing, sized 16, 4, 1
    offs = mips[1:4].astype(int)
    assert offs[1] - offs[0] == 16 and offs[2] - offs[1] == 4


def test_trilinear_top_level_is_mean():
    rng = np.random.default_rng(0)
    img = rng.uniform(0.1, 0.9, (8, 8, 3)).astype(np.float32)
    pool, idx = _pool_with_image(img)
    n = 5
    uv = jnp.asarray(rng.uniform(0, 1, (n, 2)), jnp.float32)
    ti = jnp.full((n,), idx, jnp.int32)
    # huge footprint -> coarsest level -> global mean color
    c_far, s_far = tex_mod.eval_texture(pool, ti, uv,
                                        footprint=jnp.full((n,), 100.0))
    # reconstruct rgb via the sigmoid polynomial at... simpler: raw atlas
    # check that all far samples agree (single 1x1 texel)
    far = np.asarray(c_far)
    assert np.allclose(far, far[0], atol=1e-6)
    # zero footprint -> base level -> spatial variation
    c_near, _ = tex_mod.eval_texture(pool, ti, uv,
                                     footprint=jnp.zeros((n,)))
    assert not np.allclose(np.asarray(c_near), np.asarray(c_near)[0],
                           atol=1e-4)


def test_trilinear_matches_bilinear_at_lod0():
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 1, (8, 8, 3)).astype(np.float32)
    pool, idx = _pool_with_image(img)
    uv = jnp.asarray(rng.uniform(0, 1, (32, 2)), jnp.float32)
    ti = jnp.full((32,), idx, jnp.int32)
    c0, s0 = tex_mod.eval_texture(pool, ti, uv)
    c1, s1 = tex_mod.eval_texture(pool, ti, uv,
                                  footprint=jnp.zeros((32,)))
    np.testing.assert_allclose(np.asarray(c0), np.asarray(c1), atol=1e-5)
    np.testing.assert_allclose(np.asarray(s0), np.asarray(s1), atol=1e-5)


def test_ewa_runs_and_blurs_along_major_axis():
    rng = np.random.default_rng(2)
    img = rng.uniform(0, 1, (16, 16, 3)).astype(np.float32)
    pool, idx = _pool_with_image(img)
    from pbrt_jax.ops.gather import pool_lookup
    n = 8
    uv = jnp.asarray(rng.uniform(0.2, 0.8, (n, 2)), jnp.float32)
    ti = jnp.full((n,), idx, jnp.int32)
    row = pool_lookup(pool.desc, ti)
    mip_row = pool_lookup(pool.mips, ti)
    duv0 = jnp.tile(jnp.asarray([[0.3, 0.0]]), (n, 1))   # wide in u
    duv1 = jnp.tile(jnp.asarray([[0.0, 0.01]]), (n, 1))  # narrow in v
    out = tex_mod._image_ewa(pool, row, mip_row, uv[:, 0], uv[:, 1],
                             duv0, duv1)
    assert np.isfinite(np.asarray(out)).all()


def test_nonpow2_image_resampled():
    img = np.random.default_rng(3).uniform(0, 1, (6, 10, 3)).astype(np.float32)
    pool, idx = _pool_with_image(img)
    row = np.asarray(pool.desc)[idx]
    assert row[2] == 16 and row[3] == 8  # resampled to pow2 dims


@pytest.mark.slow
def test_render_with_mipmapped_texture_smoke():
    """Textured plane renders with the cone-driven MIP path (footprint
    threads camera -> intersect -> material -> texture)."""
    from pbrt_jax import scene_core as sc, samplers as smp
    from pbrt_jax.integrators import render as rdr
    from pbrt_jax.integrators.path import PathOptions
    from pbrt_jax import cameras as cam_mod

    rng = np.random.default_rng(4)
    img = rng.uniform(0.2, 0.8, (16, 16, 3)).astype(np.float32)
    b = sc.SceneBuilder()
    t = b.textures.add_image(img)
    m = b.materials.add_diffuse((1, 1, 1), albedo_tex=t)
    # big ground plane receding to the horizon (grazing -> high LOD far away)
    P = np.asarray([[-50, 0, -50], [50, 0, -50], [50, 0, 50], [-50, 0, 50]],
                   np.float32)
    b.add_mesh(P, np.asarray([[0, 1, 2], [0, 2, 3]]), m,
               uvs=np.asarray([[0, 0], [25, 0], [25, 25], [0, 25]], np.float32))
    from pbrt_jax.utils import spectrum as spc
    b.add_uniform_infinite_light(spc.ConstantSpectrum(1.0), 1.0)
    scene = b.build(force_bvh=False)
    from pbrt_jax.utils import transform as tfm
    cam = cam_mod.make_camera(
        "perspective", fov=60, width=24, height=24,
        camera_from_world=tfm.look_at((0, 1.0, 0), (0, 0.3, -5),
                                      (0, 1, 0)).inverse())
    img_out, _ = rdr.render(scene, cam, spp=4, opts=PathOptions(max_depth=2))
    a = np.asarray(img_out)
    assert np.isfinite(a).all() and a.max() > 0
