"""Kd-tree aggregate (reference cpu/aggregates.h:76 KdTreeAggregate)."""
import numpy as np
import pytest
import jax.numpy as jnp

from pbrt_jax.ops import kdtree as kd_mod
from pbrt_jax.ops import bvh as bvh_mod


def _soup(n, seed=0):
    rng = np.random.RandomState(seed)
    c = rng.rand(n, 3) * 10
    e1 = rng.rand(n, 3) * 0.5
    e2 = rng.rand(n, 3) * 0.5
    return c.astype(np.float32), (c + e1).astype(np.float32), \
        (c + e2).astype(np.float32)


def test_kdtree_matches_brute_force():
    p0, p1, p2 = _soup(1500)
    lo = np.minimum(np.minimum(p0, p1), p2)
    hi = np.maximum(np.maximum(p0, p1), p2)
    kd = kd_mod.build_kdtree(lo, hi)
    assert kd.max_leaf <= 64
    tri_geo = jnp.asarray(np.asarray(bvh_mod.pack_tri_geo(p0, p1, p2)))
    rng = np.random.RandomState(1)
    N = 4096
    o = jnp.asarray(rng.rand(N, 3).astype(np.float32) * 10)
    d = rng.randn(N, 3).astype(np.float32)
    d = jnp.asarray(d / np.linalg.norm(d, axis=1, keepdims=True))
    tb = jnp.full((N,), 1e30, jnp.float32)
    r_kd = kd_mod.kdtree_intersect_triangles(kd, tri_geo, o, d, tb)
    r_bf = bvh_mod.brute_force_intersect_triangles(
        jnp.asarray(p0), jnp.asarray(p1), jnp.asarray(p2), o, d, tb)
    np.testing.assert_array_equal(np.asarray(r_kd["hit"]),
                                  np.asarray(r_bf["hit"]))
    both = np.asarray(r_kd["hit"])
    np.testing.assert_allclose(np.asarray(r_kd["t"])[both],
                               np.asarray(r_bf["t"])[both], rtol=1e-4)
    # any-hit agrees on occlusion
    r_any = kd_mod.kdtree_intersect_triangles(kd, tri_geo, o, d, tb,
                                              any_hit=True)
    np.testing.assert_array_equal(np.asarray(r_any["hit"]), both)


def test_accelerator_kdtree_directive_renders():
    """Accelerator "kdtree" selects the kd backend and produces the same
    image as the BVH."""
    from pbrt_jax.scene.parser import parse_string
    from pbrt_jax.integrators import render as rdr
    from pbrt_jax import samplers as smp
    from pbrt_jax.integrators.path import PathOptions
    base = '''
Camera "perspective" "float fov" [50]
Film "rgb" "integer xresolution" [24] "integer yresolution" [24]
WorldBegin
LightSource "infinite" "rgb L" [1 1 1]
Material "diffuse" "rgb reflectance" [0.6 0.4 0.3]
Translate 0 0 4
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
  "point3 P" [-1 -1 0  1 -1 0  1 1 0  -1 1 0]
'''
    d_bvh = parse_string(base, force_bvh=True)
    d_kd = parse_string('Accelerator "kdtree"\n' + base)
    assert d_kd.scene.traversal == "kdtree" and d_bvh.scene.traversal != "kdtree"
    s = smp.make_sampler("independent", spp=8, full_resolution=(24, 24))
    img_b, _ = rdr.render(d_bvh.scene, d_bvh.camera, sampler=s,
                          opts=PathOptions(max_depth=2))
    img_k, _ = rdr.render(d_kd.scene, d_kd.camera, sampler=s,
                          opts=PathOptions(max_depth=2))
    np.testing.assert_allclose(img_k, img_b, atol=1e-5)
