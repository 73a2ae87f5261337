"""Spherical triangle sampling, SAT, WindowedPiecewiseConstant2D, reservoir
(reference sampling.h:76/593/830/895)."""
import numpy as np
import jax.numpy as jnp

from pbrt_jax.utils import sampling as sp


def test_spherical_triangle_area_octant():
    """One octant of the sphere = 4pi/8."""
    a = jnp.asarray([[1.0, 0, 0]])
    b = jnp.asarray([[0, 1.0, 0]])
    c = jnp.asarray([[0, 0, 1.0]])
    area = sp.spherical_triangle_area(a, b, c)
    np.testing.assert_allclose(float(area[0]), np.pi / 2, rtol=1e-5)


def test_sample_spherical_triangle_uniform_solid_angle():
    """Chi^2-lite: samples of a large triangle from a point have ~uniform
    density in solid angle (bucket by direction octant-ish bins)."""
    rng = np.random.default_rng(0)
    n = 4096
    v0 = jnp.tile(jnp.asarray([[-2.0, -2.0, 2.0]]), (n, 1))
    v1 = jnp.tile(jnp.asarray([[2.0, -2.0, 2.0]]), (n, 1))
    v2 = jnp.tile(jnp.asarray([[0.0, 2.0, 2.0]]), (n, 1))
    p = jnp.zeros((n, 3))
    u2 = jnp.asarray(rng.uniform(0, 1, (n, 2)), jnp.float32)
    bary, pdf = sp.sample_spherical_triangle(v0, v1, v2, p, u2)
    bary = np.asarray(bary)
    assert np.all(bary > -1e-5) and np.allclose(bary.sum(-1), 1.0, atol=1e-4)
    assert np.asarray(pdf).min() > 0
    # pdf must equal 1/solid-angle everywhere (uniform)
    area = float(sp.spherical_triangle_area(
        jnp.asarray([[-2.0, -2.0, 2.0]]) / np.linalg.norm([2, 2, 2]),
        jnp.asarray([[2.0, -2.0, 2.0]]) / np.linalg.norm([2, 2, 2]),
        jnp.asarray([[0.0, 2.0, 2.0]]) / np.linalg.norm([0, 2, 2]))[0])
    np.testing.assert_allclose(np.asarray(pdf), 1.0 / area, rtol=1e-3)
    # MC estimate of the subtended solid angle using the samples' uniform
    # property: mean(1/pdf) over cos-weighted... simpler: directions spread
    pts = (bary[:, 0:1] * np.asarray(v0) + bary[:, 1:2] * np.asarray(v1)
           + bary[:, 2:3] * np.asarray(v2))
    w = pts / np.linalg.norm(pts, axis=-1, keepdims=True)
    # all directions inside the triangle's cone
    assert w[:, 2].min() > 0.5


def test_summed_area_table_integrals():
    rng = np.random.default_rng(1)
    f = rng.uniform(0, 1, (16, 24)).astype(np.float32)
    sat = sp.SummedAreaTable.build(f)
    for (x0, y0, x1, y1) in ((0, 0, 24, 16), (3, 2, 10, 9), (5, 5, 6, 6)):
        want = f[y0:y1, x0:x1].sum()
        got = float(sat.integral(jnp.asarray(x0), jnp.asarray(y0),
                                 jnp.asarray(x1), jnp.asarray(y1)))
        np.testing.assert_allclose(got, want, rtol=1e-4)


def test_windowed_pc2d_samples_in_window_proportional():
    rng = np.random.default_rng(2)
    f = np.ones((16, 16), np.float32)
    f[4:8, 4:8] = 10.0  # hot block
    dist = sp.WindowedPiecewiseConstant2D.build(f)
    n = 2048
    u2 = jnp.asarray(rng.uniform(0, 1, (n, 2)), jnp.float32)
    x0 = jnp.full((n,), 2, jnp.int32)
    y0 = jnp.full((n,), 2, jnp.int32)
    x1 = jnp.full((n,), 12, jnp.int32)
    y1 = jnp.full((n,), 12, jnp.int32)
    x, y, pdf = dist.sample(u2, x0, y0, x1, y1)
    x, y = np.asarray(x), np.asarray(y)
    assert x.min() >= 2 and x.max() < 12 and y.min() >= 2 and y.max() < 12
    hot = ((x >= 4) & (x < 8) & (y >= 4) & (y < 8)).mean()
    # hot block: 16 texels * 10 vs 84 texels * 1 -> ~65.6% of samples
    assert 0.55 < hot < 0.75
    # pdf consistency at sampled points
    pd = np.asarray(dist.pdf(jnp.asarray(x), jnp.asarray(y),
                             x0, y0, x1, y1))
    np.testing.assert_allclose(np.asarray(pdf), pd, rtol=1e-4)


def test_reservoir_uniform_over_stream():
    rng = np.random.default_rng(3)
    n_trials = 3000
    counts = np.zeros(4)
    for t in range(n_trials):
        state = sp.reservoir_init()
        for i in range(4):
            state = sp.reservoir_add(state, jnp.int32(i), jnp.float32(1.0),
                                     jnp.float32(rng.uniform()))
        counts[int(state[1])] += 1
    # equal weights -> uniform pick
    assert (np.abs(counts / n_trials - 0.25) < 0.05).all()
