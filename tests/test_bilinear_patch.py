"""Exact bilinear patch (reference shapes.h:1279 IntersectBilinearPatch,
Reshetov). Unit math + scene integration + shadow occlusion."""
import numpy as np
import jax.numpy as jnp

from pbrt_jax import scene_core as sc
from pbrt_jax import cameras as cam_mod
from pbrt_jax import samplers as smp
from pbrt_jax.ops.intersect import ray_bilinear_patch
from pbrt_jax.integrators import render as rdr
from pbrt_jax.integrators.path import PathOptions
from pbrt_jax.utils import spectrum as spc
from pbrt_jax.utils import transform as tfm


def _patch_pt(p00, p10, p01, p11, u, v):
    uo = (1 - u) * p00 + u * p10
    u1 = (1 - u) * p01 + u * p11
    return (1 - v) * uo + v * u1


def test_patch_intersection_uv_and_t():
    rng = np.random.default_rng(5)
    p00, p10, p01, p11 = [rng.uniform(-1, 1, 3).astype(np.float32)
                          for _ in range(4)]
    M = 500
    uv = rng.uniform(0.05, 0.95, (M, 2)).astype(np.float32)
    P = np.stack([_patch_pt(p00, p10, p01, p11, u, v) for u, v in uv])
    o = rng.uniform(-4, 4, (M, 3)).astype(np.float32)
    d = P - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_exp = np.linalg.norm(P - o, axis=-1)
    r = ray_bilinear_patch(jnp.asarray(o), jnp.asarray(d),
                           jnp.full((M,), 1e30, np.float32),
                           jnp.asarray(p00), jnp.asarray(p10),
                           jnp.asarray(p01), jnp.asarray(p11))
    hit = np.asarray(r["hit"])
    t = np.asarray(r["t"])
    assert hit.all()
    # always the CLOSEST crossing (curved patches can be crossed twice)
    assert (t <= t_exp * (1 + 1e-3) + 1e-4).all()
    same = np.abs(t - t_exp) < 1e-3 * (1 + t_exp)
    np.testing.assert_allclose(np.asarray(r["u"])[same], uv[same, 0],
                               atol=2e-3)
    np.testing.assert_allclose(np.asarray(r["v"])[same], uv[same, 1],
                               atol=2e-3)
    # rays aimed far off the patch miss
    d_miss = np.tile(np.asarray([[0.0, 0.0, 1.0]], np.float32), (M, 1))
    o_miss = o.copy()
    o_miss[:, 2] = 50.0
    r2 = ray_bilinear_patch(jnp.asarray(o_miss), jnp.asarray(d_miss),
                            jnp.full((M,), 1e30, np.float32),
                            jnp.asarray(p00), jnp.asarray(p10),
                            jnp.asarray(p01), jnp.asarray(p11))
    assert not np.asarray(r2["hit"]).any()


def test_patch_scene_render_and_shadow():
    """A curved patch lit from above: renders, normals/uv finite, and the
    patch casts a shadow on the ground (intersect_p sees it)."""
    b = sc.SceneBuilder()
    mg = b.materials.add_diffuse((0.6,) * 3)
    b.add_mesh([[-5, -1, -5], [5, -1, -5], [5, -1, 5], [-5, -1, 5]],
               [[0, 1, 2], [0, 2, 3]], mg)
    mp = b.materials.add_diffuse((0.7, 0.2, 0.2))
    # saddle patch above the ground
    b.add_bilinear_patch((-1, 0.5, -1), (1, 0.0, -1),
                         (-1, 0.0, 1), (1, 0.5, 1), mp)
    b.add_point_light((0, 4, 0), spc.ConstantSpectrum(30.0))
    scene = b.build(force_bvh=False)
    assert scene.has_blps
    cam = cam_mod.make_camera(
        "perspective", fov=45, width=32, height=32,
        camera_from_world=tfm.look_at((0, 2.5, 4), (0, 0, 0),
                                      (0, 1, 0)).inverse())
    img, _ = rdr.render(scene, cam, spp=8,
                        sampler=smp.make_sampler("independent", spp=8),
                        opts=PathOptions(max_depth=2))
    img = np.asarray(img)
    assert np.isfinite(img).all()
    # patch visible: center pixels redder than ground
    c = img[13:19, 13:19].mean(axis=(0, 1))
    assert c[0] > 1.3 * c[1], f"patch not visible/red: {c}"
    # direct query: ray straight down through the patch center
    o = jnp.asarray([[0.0, 3.0, 0.0]])
    d = jnp.asarray([[0.0, -1.0, 0.0]])
    r = sc.intersect(scene, o, d, jnp.asarray([1e30]))
    assert bool(r["hit"][0])
    # hits the patch (y=0.25 at center), not the ground (y=-1)
    np.testing.assert_allclose(float(r["p"][0, 1]), 0.25, atol=1e-3)
    assert int(r["mat"][0]) == mp
    # shadow: point under the patch is occluded toward the light
    occ = sc.intersect_p(scene, jnp.asarray([[0.0, -0.99, 0.0]]),
                         jnp.asarray([[0.0, 1.0, 0.0]]), 10.0)
    assert bool(occ[0])
