"""Textured-alpha intersection (reference anyhit alpha program,
gpu/optix/optix.cu:231-246): hits on alpha=0 texels pass through (bounded
re-trace), alpha=1 texels hit normally; shadow rays agree."""
import numpy as np
import jax.numpy as jnp

from pbrt_jax import scene_core as sc


def _scene():
    b = sc.SceneBuilder()
    mg = b.materials.add_diffuse((0.5,) * 3)
    # ground at z = -2
    b.add_mesh([[-5, -5, -2], [5, -5, -2], [5, 5, -2], [-5, 5, -2]],
               [[0, 1, 2], [0, 2, 3]], mg)
    # binary alpha mask: left half (u < 0.5) transparent, right half solid
    mask = np.zeros((8, 8, 3), np.float32)
    mask[:, 4:, :] = 1.0
    atex = b.textures.add_image_raw(mask)
    mq = b.materials.add_diffuse((0.8, 0.2, 0.2))
    # quad at z = 0 with standard uv (u right, v up)
    b.add_mesh([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]],
               [[0, 1, 2], [0, 2, 3]], mq,
               uvs=[[0, 0], [1, 0], [1, 1], [0, 1]],
               alpha_tex=atex)
    return b.build(force_bvh=False), mg, mq


def test_alpha_cutout_pass_through():
    scene, mg, mq = _scene()
    assert scene.has_alpha
    o = jnp.asarray([[-0.6, 0.0, 3.0],    # u ~ 0.2 -> transparent
                     [0.6, 0.0, 3.0]])    # u ~ 0.8 -> solid
    d = jnp.asarray([[0.0, 0.0, -1.0]] * 2)
    r = sc.intersect(scene, o, d, jnp.asarray([1e30] * 2))
    assert bool(r["hit"][0]) and bool(r["hit"][1])
    # transparent texel: ray passes to the ground (z=-2 => t=5)
    np.testing.assert_allclose(float(r["t"][0]), 5.0, atol=1e-3)
    assert int(r["mat"][0]) == mg
    # solid texel: quad hit (t=3)
    np.testing.assert_allclose(float(r["t"][1]), 3.0, atol=1e-3)
    assert int(r["mat"][1]) == mq


def test_alpha_cutout_shadows():
    scene, _, _ = _scene()
    o = jnp.asarray([[-0.6, 0.0, 3.0], [0.6, 0.0, 3.0]])
    d = jnp.asarray([[0.0, 0.0, -1.0]] * 2)
    occ = sc.intersect_p(scene, o, d, 4.0)  # range ends before the ground
    assert not bool(occ[0])   # transparent texel does not occlude
    assert bool(occ[1])       # solid texel occludes
