"""Math/vecmath unit tests (modeled on reference math_test.cpp, vecmath_test.cpp)."""
import jax.numpy as jnp
import numpy as np
import pytest

from pbrt_jax.utils import math as pm
from pbrt_jax.utils import vecmath as vm


def test_lerp_clamp_sqr():
    assert pm.lerp(0.5, 0.0, 2.0) == 1.0
    assert pm.sqr(3.0) == 9.0
    assert float(pm.clamp(jnp.float32(5.0), 0.0, 1.0)) == 1.0


def test_quadratic_roots():
    has, t0, t1 = pm.quadratic(jnp.float32(1.0), jnp.float32(-3.0), jnp.float32(2.0))
    assert bool(has)
    np.testing.assert_allclose([float(t0), float(t1)], [1.0, 2.0], rtol=1e-6)
    has, _, _ = pm.quadratic(jnp.float32(1.0), jnp.float32(0.0), jnp.float32(1.0))
    assert not bool(has)
    # linear degenerate case
    has, t0, t1 = pm.quadratic(jnp.float32(0.0), jnp.float32(2.0), jnp.float32(-4.0))
    assert bool(has) and float(t0) == 2.0


def test_quadratic_catastrophic_cancellation():
    # roots 1 and 1e7: naive formula loses the small root
    a, b, c = 1.0, -(1.0 + 1e7), 1e7
    has, t0, t1 = pm.quadratic(jnp.float32(a), jnp.float32(b), jnp.float32(c))
    assert bool(has)
    np.testing.assert_allclose(float(t0), 1.0, rtol=1e-4)
    np.testing.assert_allclose(float(t1), 1e7, rtol=1e-4)


def test_next_float_up_down():
    x = jnp.float32(1.0)
    up = float(pm.next_float_up(x))
    down = float(pm.next_float_down(x))
    assert up > 1.0 and down < 1.0
    assert up == float(np.nextafter(np.float32(1.0), np.float32(2.0)))
    assert down == float(np.nextafter(np.float32(1.0), np.float32(0.0)))


def test_power_heuristic():
    assert abs(float(pm.power_heuristic(1, 1.0, 1, 1.0)) - 0.5) < 1e-6
    assert float(pm.power_heuristic(1, 10.0, 1, 0.0)) == 1.0


def test_normalize_dot_cross():
    v = vm.v3(3.0, 0.0, 0.0)
    n = vm.normalize(v)
    np.testing.assert_allclose(np.asarray(n), [[1, 0, 0]][0], atol=1e-6)
    a = vm.v3(1.0, 2.0, 3.0)
    b = vm.v3(4.0, 5.0, 6.0)
    assert abs(float(vm.dot(a, b)) - 32.0) < 1e-5
    c = vm.cross(a, b)
    np.testing.assert_allclose(np.asarray(c), [-3, 6, -3], atol=1e-5)


def test_coordinate_system_orthonormal():
    rng = np.random.RandomState(0)
    for _ in range(20):
        v = rng.randn(3).astype(np.float32)
        v /= np.linalg.norm(v)
        t1, t2 = vm.coordinate_system(jnp.asarray(v))
        t1, t2 = np.asarray(t1), np.asarray(t2)
        assert abs(np.dot(t1, v)) < 1e-5
        assert abs(np.dot(t2, v)) < 1e-5
        assert abs(np.dot(t1, t2)) < 1e-5
        assert abs(np.linalg.norm(t1) - 1) < 1e-5
        assert abs(np.linalg.norm(t2) - 1) < 1e-5


def test_reflect_refract():
    n = vm.v3(0.0, 0.0, 1.0)
    wo = vm.normalize(vm.v3(1.0, 0.0, 1.0))
    r = vm.reflect(wo, n)
    np.testing.assert_allclose(np.asarray(vm.normalize(r)),
                               np.asarray(vm.normalize(vm.v3(-1.0, 0.0, 1.0))), atol=1e-6)
    # refraction, normal incidence: direction passes straight through
    wi = vm.v3(0.0, 0.0, 1.0)
    ok, wt, eta = vm.refract(wi, n, jnp.float32(1.5))
    assert bool(ok)
    np.testing.assert_allclose(np.asarray(wt), [0, 0, -1], atol=1e-5)


def test_refract_tir():
    # grazing ray inside dense medium: total internal reflection
    n = vm.v3(0.0, 0.0, 1.0)
    wi = vm.normalize(vm.v3(0.99, 0.0, -0.14))  # wi below surface (inside)
    ok, _, _ = vm.refract(wi, n, jnp.float32(1.5))
    assert not bool(ok)


def test_spherical_roundtrip():
    rng = np.random.RandomState(1)
    v = rng.randn(100, 3).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    v = jnp.asarray(v)
    theta = vm.spherical_theta(v)
    phi = vm.spherical_phi(v)
    v2 = vm.spherical_direction(jnp.sin(theta), jnp.cos(theta), phi)
    np.testing.assert_allclose(np.asarray(v2), np.asarray(v), atol=1e-4)


def test_equal_area_mapping_roundtrip():
    rng = np.random.RandomState(2)
    d = rng.randn(500, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d = jnp.asarray(d)
    p = vm.equal_area_sphere_to_square(d)
    p_np = np.asarray(p)
    assert p_np.min() >= 0.0 and p_np.max() <= 1.0
    d2 = vm.equal_area_square_to_sphere(p)
    np.testing.assert_allclose(np.asarray(d2), np.asarray(d), atol=2e-3)


def test_equal_area_mapping_is_area_preserving():
    # uniform grid on square -> directions should cover sphere uniformly
    n = 64
    u, v = np.meshgrid((np.arange(n) + 0.5) / n, (np.arange(n) + 0.5) / n)
    p = jnp.asarray(np.stack([u.ravel(), v.ravel()], -1), jnp.float32)
    d = np.asarray(vm.equal_area_square_to_sphere(p))
    assert np.allclose(np.linalg.norm(d, axis=-1), 1.0, atol=1e-4)
    # mean of uniformly distributed directions ~ 0
    assert np.linalg.norm(d.mean(axis=0)) < 0.01
    # z should be uniformly distributed in [-1, 1]
    z = np.sort(d[:, 2])
    expect = np.linspace(-1, 1, len(z))
    assert np.abs(z - expect).max() < 0.05


def test_ray_bounds_intersect():
    o = vm.v3(0.0, 0.0, -5.0)
    inv_d = 1.0 / vm.v3(1e-9, 1e-9, 1.0)
    hit, t = vm.ray_bounds_intersect_p(o, inv_d, jnp.float32(1e30),
                                       vm.v3(-1., -1., -1.), vm.v3(1., 1., 1.))
    assert bool(hit)
    np.testing.assert_allclose(float(t), 4.0, rtol=1e-4)
    # miss
    o2 = vm.v3(5.0, 0.0, -5.0)
    hit2, _ = vm.ray_bounds_intersect_p(o2, inv_d, jnp.float32(1e30),
                                        vm.v3(-1., -1., -1.), vm.v3(1., 1., 1.))
    assert not bool(hit2)


def test_bounds_helpers():
    b = jnp.asarray([[[0, 0, 0], [1, 2, 3]]], jnp.float32)
    assert abs(float(vm.bounds_surface_area(b)[0]) - 22.0) < 1e-5
    np.testing.assert_allclose(np.asarray(vm.bounds_centroid(b))[0], [0.5, 1.0, 1.5])


def test_spherical_triangle_area():
    # octant = 4*pi/8
    a = vm.v3(1.0, 0.0, 0.0)
    b = vm.v3(0.0, 1.0, 0.0)
    c = vm.v3(0.0, 0.0, 1.0)
    np.testing.assert_allclose(float(vm.spherical_triangle_area(a, b, c)),
                               np.pi / 2, rtol=1e-5)
