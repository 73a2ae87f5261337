"""Interval arithmetic + error-free transforms.

Role models: the reference's ``Interval`` (util/math.h:206 — directed-
rounding interval type used for robust quadric intersections,
shapes.h:107/404/574), ``CompensatedSum`` (util/math.h:158 Kahan
summation) and ``CompensatedFloat`` (util/math.h:191 — TwoProd/TwoSum
error-free transforms feeding ``DifferenceOfProducts``).

All operations are vectorized jnp functions; an interval is the pair
``(lo, hi)``.  Directed rounding is emulated with next_float_up/down after
each IEEE-rounded op (conservative by <= 1 ulp per bound, exactly the
reference's approach — math.h Interval uses the same next-float nudges).
Error-free transforms use Dekker/Veltkamp splitting because XLA exposes no
user-facing FMA.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
from . import struct

from .math import next_float_up, next_float_down


@struct.dataclass
class Interval:
    lo: jnp.ndarray
    hi: jnp.ndarray

    @staticmethod
    def point(v):
        v = jnp.asarray(v, jnp.float32)
        return Interval(lo=v, hi=v)

    @staticmethod
    def from_value_and_error(v, err):
        v = jnp.asarray(v, jnp.float32)
        err = jnp.asarray(err, jnp.float32)
        return Interval(lo=next_float_down(v - err),
                        hi=next_float_up(v + err))

    @property
    def midpoint(self):
        return 0.5 * (self.lo + self.hi)

    @property
    def width(self):
        return self.hi - self.lo

    def contains(self, v):
        return (v >= self.lo) & (v <= self.hi)

    def exactly(self, v):
        return (self.lo == v) & (self.hi == v)


def i_add(a: Interval, b: Interval) -> Interval:
    return Interval(lo=next_float_down(a.lo + b.lo),
                    hi=next_float_up(a.hi + b.hi))


def i_sub(a: Interval, b: Interval) -> Interval:
    return Interval(lo=next_float_down(a.lo - b.hi),
                    hi=next_float_up(a.hi - b.lo))


def i_neg(a: Interval) -> Interval:
    return Interval(lo=-a.hi, hi=-a.lo)


def i_mul(a: Interval, b: Interval) -> Interval:
    p = jnp.stack([a.lo * b.lo, a.lo * b.hi, a.hi * b.lo, a.hi * b.hi])
    return Interval(lo=next_float_down(jnp.min(p, axis=0)),
                    hi=next_float_up(jnp.max(p, axis=0)))


def i_div(a: Interval, b: Interval) -> Interval:
    # interval straddling zero -> everything (reference Interval::operator/)
    straddles = (b.lo < 0) & (b.hi > 0)
    q = jnp.stack([a.lo / b.lo, a.lo / b.hi, a.hi / b.lo, a.hi / b.hi])
    lo = next_float_down(jnp.min(q, axis=0))
    hi = next_float_up(jnp.max(q, axis=0))
    inf = jnp.float32(np.inf)
    return Interval(lo=jnp.where(straddles, -inf, lo),
                    hi=jnp.where(straddles, inf, hi))


def i_sqr(a: Interval) -> Interval:
    alo, ahi = jnp.abs(a.lo), jnp.abs(a.hi)
    lo = jnp.minimum(alo, ahi)
    hi = jnp.maximum(alo, ahi)
    straddles = (a.lo < 0) & (a.hi > 0)
    return Interval(lo=jnp.where(straddles, 0.0, next_float_down(lo * lo)),
                    hi=next_float_up(hi * hi))


def i_sqrt(a: Interval) -> Interval:
    return Interval(lo=next_float_down(jnp.sqrt(jnp.maximum(a.lo, 0.0))),
                    hi=next_float_up(jnp.sqrt(jnp.maximum(a.hi, 0.0))))


# ---------------------------------------------------------------------------
# Error-free transforms (reference CompensatedFloat, util/math.h:191)

def two_sum(a, b):
    """s + e == a + b exactly (Knuth TwoSum)."""
    s = a + b
    bp = s - a
    ap = s - bp
    e = (a - ap) + (b - bp)
    return s, e


def _split(a):
    """Veltkamp split of a float32 into hi+lo halves (no FMA on XLA)."""
    c = jnp.float32(4097.0) * a  # 2^12 + 1
    hi = c - (c - a)
    lo = a - hi
    return hi, lo


def two_prod(a, b):
    """p + e == a * b exactly (Dekker TwoProd)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def difference_of_products_compensated(a, b, c, d):
    """a*b - c*d with the cross-cancellation error compensated (the role of
    the reference's FMA-based DifferenceOfProducts, util/math.h)."""
    cd, cd_err = two_prod(c, d)
    ab, ab_err = two_prod(a, b)
    dop = ab - cd
    return dop + (ab_err - cd_err)


def inner_product_compensated(*pairs):
    """Compensated sum of products: pairs = (a0, b0, a1, b1, ...)
    (reference InnerProduct, math.h)."""
    assert len(pairs) % 2 == 0
    s = jnp.zeros_like(jnp.asarray(pairs[0], jnp.float32) * pairs[1])
    c = jnp.zeros_like(s)
    for i in range(0, len(pairs), 2):
        p, pe = two_prod(jnp.asarray(pairs[i], jnp.float32),
                         jnp.asarray(pairs[i + 1], jnp.float32))
        s, se = two_sum(s, p)
        c = c + se + pe
    return s + c


def kahan_add(total, comp, value):
    """One Kahan step: returns (total', comp')
    (reference CompensatedSum::operator+=, util/math.h:158)."""
    y = value - comp
    t = total + y
    comp = (t - total) - y
    return t, comp


def kahan_sum(values, axis=None):
    """Compensated reduction of an array along an axis (host/debug tool;
    XLA reductions reassociate, so this walks explicitly)."""
    values = jnp.asarray(values, jnp.float32)
    if axis is None:
        values = values.reshape(-1)
        axis = 0
    n = values.shape[axis]
    total = jnp.take(values, 0, axis=axis) * 0.0
    comp = total
    for i in range(n):
        total, comp = kahan_add(total, comp, jnp.take(values, i, axis=axis))
    return total
