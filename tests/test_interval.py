"""Interval arithmetic + error-free transforms (reference util/math.h:
Interval:206, CompensatedSum:158, CompensatedFloat:191)."""
import jax.numpy as jnp
import numpy as np
import pytest

from pbrt_jax.utils import interval as iv


def _rand_intervals(rng, n):
    v = rng.uniform(-100, 100, n).astype(np.float32)
    e = rng.uniform(0, 0.1, n).astype(np.float32)
    return iv.Interval.from_value_and_error(jnp.asarray(v), jnp.asarray(e))


def test_interval_ops_contain_true_result():
    rng = np.random.RandomState(0)
    a = _rand_intervals(rng, 256)
    b = _rand_intervals(rng, 256)
    # true results in float64 from the exact bounds
    alo, ahi = np.asarray(a.lo, np.float64), np.asarray(a.hi, np.float64)
    blo, bhi = np.asarray(b.lo, np.float64), np.asarray(b.hi, np.float64)
    for op, ref in [
        (iv.i_add, lambda: (alo + blo, ahi + bhi)),
        (iv.i_sub, lambda: (alo - bhi, ahi - blo)),
        (iv.i_mul, lambda: (np.min([alo * blo, alo * bhi, ahi * blo,
                                    ahi * bhi], axis=0),
                            np.max([alo * blo, alo * bhi, ahi * blo,
                                    ahi * bhi], axis=0))),
    ]:
        r = op(a, b)
        tlo, thi = ref()
        assert np.all(np.asarray(r.lo, np.float64) <= tlo + 1e-6)
        assert np.all(np.asarray(r.hi, np.float64) >= thi - 1e-6)
    s = iv.i_sqr(a)
    true_sq_lo = np.where((alo < 0) & (ahi > 0), 0.0,
                          np.minimum(alo * alo, ahi * ahi))
    assert np.all(np.asarray(s.lo, np.float64) <= true_sq_lo + 1e-6)


def test_interval_div_straddle():
    a = iv.Interval.point(jnp.asarray([1.0, 1.0]))
    b = iv.Interval(lo=jnp.asarray([-1.0, 0.5]), hi=jnp.asarray([1.0, 2.0]))
    r = iv.i_div(a, b)
    assert np.isinf(np.asarray(r.lo)[0]) and np.isinf(np.asarray(r.hi)[0])
    assert np.isfinite(np.asarray(r.lo)[1])


def test_two_sum_two_prod_exact():
    rng = np.random.RandomState(1)
    a = jnp.asarray(rng.uniform(-1e5, 1e5, 512).astype(np.float32))
    b = jnp.asarray(rng.uniform(-1e-3, 1e-3, 512).astype(np.float32))
    s, e = iv.two_sum(a, b)
    np.testing.assert_array_equal(
        np.asarray(s, np.float64) + np.asarray(e, np.float64),
        np.asarray(a, np.float64) + np.asarray(b, np.float64))
    p, pe = iv.two_prod(a, b)
    np.testing.assert_allclose(
        np.asarray(p, np.float64) + np.asarray(pe, np.float64),
        np.asarray(a, np.float64) * np.asarray(b, np.float64), rtol=1e-12)


def test_difference_of_products_compensated():
    # catastrophic cancellation: a*b ~ c*d
    a = jnp.float32(33962.035)
    b = jnp.float32(-30438.8)
    c = jnp.float32(41563.4)
    d = jnp.float32(-24871.969)
    naive = np.float32(a * b) - np.float32(c * d)
    comp = iv.difference_of_products_compensated(a, b, c, d)
    # float64 reference over the float32-ROUNDED inputs
    true = (np.float64(np.float32(33962.035)) * np.float64(np.float32(-30438.8))
            - np.float64(np.float32(41563.4)) * np.float64(np.float32(-24871.969)))
    assert abs(float(comp) - true) < abs(float(naive) - true)
    assert abs(float(comp) - true) / abs(true) < 1e-5


def test_kahan_sum_beats_naive():
    rng = np.random.RandomState(2)
    # large value + many tiny values: naive f32 loses the tail
    vals = np.concatenate([[1e8], rng.uniform(0, 1, 4096)]).astype(np.float32)
    true = np.sum(vals.astype(np.float64))
    naive = np.float32(0)
    for v in vals:
        naive += v
    k = float(iv.kahan_sum(jnp.asarray(vals)))
    assert abs(k - true) <= abs(float(naive) - true)
    assert abs(k - true) / true < 1e-6
