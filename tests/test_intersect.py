"""Ray-primitive intersection + BVH tests (modeled on reference
shapes_test.cpp watertight/rain tests and BVH traversal semantics)."""
import jax.numpy as jnp
import numpy as np

from pbrt_jax.ops import intersect as isect
from pbrt_jax.ops import bvh as bvh_mod


def test_triangle_basic_hit():
    p0 = jnp.asarray([0.0, 0.0, 0.0])
    p1 = jnp.asarray([1.0, 0.0, 0.0])
    p2 = jnp.asarray([0.0, 1.0, 0.0])
    o = jnp.asarray([0.2, 0.2, 1.0])
    d = jnp.asarray([0.0, 0.0, -1.0])
    r = isect.ray_triangle(o, d, jnp.float32(1e30), p0, p1, p2)
    assert bool(r["hit"])
    np.testing.assert_allclose(float(r["t"]), 1.0, rtol=1e-5)
    b = np.array([float(r["b0"]), float(r["b1"]), float(r["b2"])])
    np.testing.assert_allclose(b @ np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]]),
                               [0.2, 0.2, 0.0], atol=1e-5)


def test_triangle_miss_and_backface():
    p0 = jnp.asarray([0.0, 0.0, 0.0])
    p1 = jnp.asarray([1.0, 0.0, 0.0])
    p2 = jnp.asarray([0.0, 1.0, 0.0])
    # outside triangle
    o = jnp.asarray([0.9, 0.9, 1.0])
    d = jnp.asarray([0.0, 0.0, -1.0])
    assert not bool(isect.ray_triangle(o, d, jnp.float32(1e30), p0, p1, p2)["hit"])
    # behind origin
    o2 = jnp.asarray([0.2, 0.2, -1.0])
    assert not bool(isect.ray_triangle(o2, d, jnp.float32(1e30), p0, p1, p2)["hit"])
    # t_max clipping
    o3 = jnp.asarray([0.2, 0.2, 1.0])
    assert not bool(isect.ray_triangle(o3, d, jnp.float32(0.5), p0, p1, p2)["hit"])


def test_triangle_watertight_rain():
    """Rays at shared edges/vertices must not leak (reference
    shapes_test.cpp:33 'Watertight')."""
    rng = np.random.RandomState(0)
    # fan of triangles sharing a center vertex, forming a closed disk
    n = 16
    ang = np.linspace(0, 2 * np.pi, n + 1)
    center = np.array([0.0, 0.0, 0.0])
    ring = np.stack([np.cos(ang), np.sin(ang), np.zeros(n + 1)], -1)
    p0 = np.tile(center, (n, 1)).astype(np.float32)
    p1 = ring[:-1].astype(np.float32)
    p2 = ring[1:].astype(np.float32)
    # rays raining straight down onto random points strictly inside the disk,
    # including points exactly on shared edges
    pts = []
    for i in range(n):
        t = rng.rand()
        pts.append(t * 0.999 * ring[i])          # on an interior shared edge
        pts.append(0.5 * (ring[i] + ring[i + 1]) * 0.7)  # inside a triangle
    pts = np.asarray(pts, np.float32)
    o = jnp.asarray(pts + np.array([0, 0, 1], np.float32))
    d = jnp.tile(jnp.asarray([[0.0, 0.0, -1.0]]), (len(pts), 1))
    r = isect.ray_triangle(o[:, None], d[:, None], jnp.float32(1e30),
                           jnp.asarray(p0)[None], jnp.asarray(p1)[None],
                           jnp.asarray(p2)[None])
    any_hit = np.asarray(r["hit"]).any(axis=1)
    assert any_hit.all(), f"leaked {np.where(~any_hit)}"


def test_sphere_intersect():
    o = jnp.asarray([0.0, 0.0, 5.0])
    d = jnp.asarray([0.0, 0.0, -1.0])
    r = isect.ray_sphere(o, d, jnp.float32(1e30), jnp.float32(1.0))
    assert bool(r["hit"])
    np.testing.assert_allclose(float(r["t"]), 4.0, rtol=1e-5)
    # from inside
    o2 = jnp.asarray([0.0, 0.0, 0.0])
    r2 = isect.ray_sphere(o2, d, jnp.float32(1e30), jnp.float32(1.0))
    assert bool(r2["hit"])
    np.testing.assert_allclose(float(r2["t"]), 1.0, rtol=1e-5)
    # miss
    o3 = jnp.asarray([2.0, 0.0, 5.0])
    assert not bool(isect.ray_sphere(o3, d, jnp.float32(1e30), jnp.float32(1.0))["hit"])


def test_partial_sphere():
    o = jnp.asarray([0.0, 0.0, 5.0])
    d = jnp.asarray([0.0, 0.0, -1.0])
    # clip z to lower hemisphere: ray along +z axis hits at z=+1 -> clipped,
    # but back side z=-1 passes
    r = isect.ray_sphere(o, d, jnp.float32(1e30), jnp.float32(1.0),
                         z_min=jnp.float32(-1.0), z_max=jnp.float32(0.0))
    assert bool(r["hit"])
    np.testing.assert_allclose(float(r["t"]), 6.0, rtol=1e-5)


def test_disk_intersect():
    o = jnp.asarray([0.3, 0.0, 5.0])
    d = jnp.asarray([0.0, 0.0, -1.0])
    r = isect.ray_disk(o, d, jnp.float32(1e30), jnp.float32(1.0),
                       height=jnp.float32(0.0))
    assert bool(r["hit"]) and abs(float(r["t"]) - 5.0) < 1e-4
    # inner radius hole
    r2 = isect.ray_disk(o, d, jnp.float32(1e30), jnp.float32(1.0),
                        height=jnp.float32(0.0),
                        inner_radius=jnp.float32(0.5))
    assert not bool(r2["hit"])


def test_cylinder_intersect():
    o = jnp.asarray([5.0, 0.0, 0.5])
    d = jnp.asarray([-1.0, 0.0, 0.0])
    r = isect.ray_cylinder(o, d, jnp.float32(1e30), jnp.float32(1.0),
                           jnp.float32(0.0), jnp.float32(1.0))
    assert bool(r["hit"])
    np.testing.assert_allclose(float(r["t"]), 4.0, rtol=1e-4)


def _random_tris(n, seed=0, spread=10.0):
    rng = np.random.RandomState(seed)
    base = rng.rand(n, 3).astype(np.float32) * spread
    e1 = rng.randn(n, 3).astype(np.float32)
    e2 = rng.randn(n, 3).astype(np.float32)
    return base, base + e1, base + e2


def test_bvh_matches_brute_force():
    """BVH traversal closest-hit must agree with all-pairs reference."""
    p0, p1, p2 = _random_tris(200, seed=1)
    lo = np.minimum(np.minimum(p0, p1), p2)
    hi = np.maximum(np.maximum(p0, p1), p2)
    bvh = bvh_mod.build_bvh(lo, hi)
    rng = np.random.RandomState(2)
    n_rays = 256
    o_np = rng.rand(n_rays, 3).astype(np.float32) * 10 + np.array([0, 0, 20], np.float32)
    # aim at random triangle centroids (jittered) so most rays hit
    targets = ((p0 + p1 + p2) / 3)[rng.randint(0, len(p0), n_rays)]
    targets = targets + 0.1 * rng.randn(n_rays, 3).astype(np.float32)
    d_np = targets - o_np
    d_np /= np.linalg.norm(d_np, axis=-1, keepdims=True)
    o = jnp.asarray(o_np)
    d = jnp.asarray(d_np)
    t_max = jnp.full((n_rays,), 1e30, jnp.float32)
    tp0, tp1, tp2 = jnp.asarray(p0), jnp.asarray(p1), jnp.asarray(p2)
    rb = bvh_mod.brute_force_intersect_triangles(tp0, tp1, tp2, o, d, t_max)
    geo = bvh_mod.pack_tri_geo(p0, p1, p2, order=np.asarray(bvh.prim_indices))
    rv = bvh_mod.bvh_intersect_triangles(bvh, geo, o, d, t_max)
    hit_b, hit_v = np.asarray(rb["hit"]), np.asarray(rv["hit"])
    np.testing.assert_array_equal(hit_b, hit_v)
    tb, tv = np.asarray(rb["t"]), np.asarray(rv["t"])
    np.testing.assert_allclose(tv[hit_v], tb[hit_b], rtol=1e-4)
    assert hit_b.sum() > 20  # the test actually exercises hits


def test_bvh_any_hit():
    p0, p1, p2 = _random_tris(100, seed=3)
    lo = np.minimum(np.minimum(p0, p1), p2)
    hi = np.maximum(np.maximum(p0, p1), p2)
    bvh = bvh_mod.build_bvh(lo, hi)
    rng = np.random.RandomState(4)
    n_rays = 128
    o = jnp.asarray(rng.rand(n_rays, 3).astype(np.float32) * 10 + np.array([0, 0, 20], np.float32))
    d_np = rng.randn(n_rays, 3).astype(np.float32)
    d_np[:, 2] = -np.abs(d_np[:, 2]) - 0.5
    d_np /= np.linalg.norm(d_np, axis=-1, keepdims=True)
    d = jnp.asarray(d_np)
    t_max = jnp.full((n_rays,), 1e30, jnp.float32)
    tp0, tp1, tp2 = jnp.asarray(p0), jnp.asarray(p1), jnp.asarray(p2)
    rb = bvh_mod.brute_force_intersect_triangles(tp0, tp1, tp2, o, d, t_max)
    geo = bvh_mod.pack_tri_geo(p0, p1, p2, order=np.asarray(bvh.prim_indices))
    rv = bvh_mod.bvh_intersect_triangles(bvh, geo, o, d, t_max, any_hit=True)
    np.testing.assert_array_equal(np.asarray(rb["hit"]), np.asarray(rv["hit"]))


def test_bvh_single_triangle():
    p0 = np.array([[0, 0, 0]], np.float32)
    p1 = np.array([[1, 0, 0]], np.float32)
    p2 = np.array([[0, 1, 0]], np.float32)
    bvh = bvh_mod.build_bvh(np.minimum(np.minimum(p0, p1), p2),
                            np.maximum(np.maximum(p0, p1), p2))
    o = jnp.asarray([[0.2, 0.2, 1.0]])
    d = jnp.asarray([[0.0, 0.0, -1.0]])
    geo = bvh_mod.pack_tri_geo(p0, p1, p2, order=np.asarray(bvh.prim_indices))
    r = bvh_mod.bvh_intersect_triangles(bvh, geo, o, d,
                                        jnp.full((1,), 1e30, jnp.float32))
    assert bool(r["hit"][0])
    np.testing.assert_allclose(float(r["t"][0]), 1.0, rtol=1e-5)
