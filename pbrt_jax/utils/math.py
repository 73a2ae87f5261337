"""Scalar math utilities (reference: pbrt-v4 util/math.h, util/float.h).

All functions are elementwise over jnp arrays and jit/vmap-safe.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

# Largest float32 strictly below 1.0 (reference util/float.h OneMinusEpsilon).
ONE_MINUS_EPSILON = np.float32(np.nextafter(np.float32(1.0), np.float32(0.0)))
PI = np.float32(np.pi)
INV_PI = np.float32(1.0 / np.pi)
INV_2PI = np.float32(1.0 / (2 * np.pi))
INV_4PI = np.float32(1.0 / (4 * np.pi))
PI_OVER_2 = np.float32(np.pi / 2)
PI_OVER_4 = np.float32(np.pi / 4)
SQRT2 = np.float32(np.sqrt(2.0))
INF = np.float32(np.inf)
MACHINE_EPSILON = np.float32(np.finfo(np.float32).eps * 0.5)


def sqr(x):
    return x * x


def lerp(t, a, b):
    """a*(1-t) + b*t (reference util/math.h Lerp)."""
    return (1.0 - t) * a + t * b


def clamp(x, lo, hi):
    return jnp.clip(x, lo, hi)


def safe_sqrt(x):
    return jnp.sqrt(jnp.maximum(x, 0.0))


def safe_acos(x):
    return jnp.arccos(jnp.clip(x, -1.0, 1.0))


def safe_asin(x):
    return jnp.arcsin(jnp.clip(x, -1.0, 1.0))


def safe_div(a, b):
    """a/b, 0 where b == 0."""
    return jnp.where(b != 0.0, a / jnp.where(b == 0.0, 1.0, b), 0.0)


def difference_of_products(a, b, c, d):
    """a*b - c*d. (Reference uses FMA error compensation, util/math.h:

    DifferenceOfProducts; XLA has no user-facing FMA so we rely on the
    compiler's fusion. Robustness-critical call sites use algorithm-level
    fixes instead — see shapes.py watertight triangle intersection.)
    """
    return a * b - c * d


def sum_of_products(a, b, c, d):
    return a * b + c * d


def quadratic(a, b, c):
    """Solve a t^2 + b t + c = 0 robustly (reference util/math.h Quadratic).

    Returns (has_solution, t0, t1) with t0 <= t1. Uses the numerically stable
    form q = -(b + sign(b) sqrt(disc)) / 2; t0 = q/a, t1 = c/q.
    """
    disc = b * b - 4.0 * a * c
    has = (disc >= 0.0) & (a != 0.0)
    root = safe_sqrt(disc)
    q = -0.5 * (b + jnp.where(b < 0.0, -root, root))
    t0 = safe_div(q, a)
    t1 = safe_div(c, q)
    lo = jnp.minimum(t0, t1)
    hi = jnp.maximum(t0, t1)
    # Linear fallback when a == 0: b t + c = 0
    lin_ok = (a == 0.0) & (b != 0.0)
    lin_t = safe_div(-c, b)
    has = has | lin_ok
    lo = jnp.where(lin_ok, lin_t, lo)
    hi = jnp.where(lin_ok, lin_t, hi)
    return has, lo, hi


def smoothstep(x, a, b):
    t = jnp.clip(safe_div(x - a, b - a), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def sinc(x):
    """sin(pi x)/(pi x), the normalized sinc (reference util/math.h Sinc)."""
    px = PI * x
    return jnp.where(jnp.abs(x) < 1e-5, 1.0, jnp.sin(px) / jnp.where(px == 0, 1.0, px))


def windowed_sinc(x, radius, tau):
    lanczos = sinc(x / tau)
    return jnp.where(jnp.abs(x) > radius, 0.0, sinc(x) * lanczos)


def gaussian(x, mu=0.0, sigma=1.0):
    return (1.0 / jnp.sqrt(2.0 * PI * sigma * sigma)) * jnp.exp(
        -sqr(x - mu) / (2.0 * sigma * sigma))


def gaussian_integral(x0, x1, mu=0.0, sigma=1.0):
    sigma_root2 = sigma * SQRT2
    import jax
    return 0.5 * (jax.scipy.special.erf((mu - x0) / sigma_root2) -
                  jax.scipy.special.erf((mu - x1) / sigma_root2))


def power_heuristic(nf, f_pdf, ng, g_pdf):
    """MIS power heuristic, beta=2 (reference util/sampling.h PowerHeuristic)."""
    f = nf * f_pdf
    g = ng * g_pdf
    w = safe_div(sqr(f), sqr(f) + sqr(g))
    return jnp.where(jnp.isinf(sqr(f)), 1.0, w)


def next_float_up(v):
    """Next float32 towards +inf (reference util/float.h NextFloatUp)."""
    v = jnp.asarray(v, jnp.float32)
    bits = v.view(jnp.uint32) if hasattr(v, "view") else v
    ui = jax_bitcast_f2u(v)
    ui = jnp.where(v >= 0, ui + 1, ui - 1)
    out = jax_bitcast_u2f(ui)
    out = jnp.where(jnp.isinf(v) & (v > 0), v, out)
    out = jnp.where(v == -0.0, jnp.float32(np.nextafter(np.float32(0), np.float32(1))), out)
    return out


def next_float_down(v):
    v = jnp.asarray(v, jnp.float32)
    ui = jax_bitcast_f2u(v)
    ui = jnp.where(v > 0, ui - 1, ui + 1)
    out = jax_bitcast_u2f(ui)
    out = jnp.where(jnp.isinf(v) & (v < 0), v, out)
    out = jnp.where(v == 0.0, jnp.float32(np.nextafter(np.float32(0), np.float32(-1))), out)
    return out


def jax_bitcast_f2u(x):
    import jax.lax as lax
    return lax.bitcast_convert_type(jnp.asarray(x, jnp.float32), jnp.uint32)


def jax_bitcast_u2f(x):
    import jax.lax as lax
    return lax.bitcast_convert_type(jnp.asarray(x, jnp.uint32), jnp.float32)


def gamma_bound(n):
    """(n eps)/(1 - n eps) float rounding bound (reference util/float.h:195)."""
    ne = n * MACHINE_EPSILON
    return ne / (1.0 - ne)


def erf_inv(a):
    """Inverse error function (reference util/math.h ErfInv, Giles 2012).

    Explicit Giles polynomial rather than jax.scipy.special.erfinv, so the
    result does not depend on the backend's erf-inv lowering."""
    x = jnp.clip(jnp.asarray(a, jnp.float32), -0.99999, 0.99999)
    w = -jnp.log((1.0 - x) * (1.0 + x))
    w1 = w - 2.5
    p1 = jnp.float32(2.81022636e-08)
    for c in (3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
              0.00021858087, -0.00125372503, -0.00417768164,
              0.246640727, 1.50140941):
        p1 = jnp.float32(c) + p1 * w1
    w2 = jnp.sqrt(jnp.maximum(w, 1e-6)) - 3.0
    p2 = jnp.float32(-0.000200214257)
    for c in (0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
              -0.0076224613, 0.00943887047, 1.00167406, 2.83297682):
        p2 = jnp.float32(c) + p2 * w2
    return jnp.where(w < 5.0, p1, p2) * x


def log2_int(v):
    """floor(log2(v)) for positive ints (host utility)."""
    return int(np.floor(np.log2(v)))


def round_up_pow2(v: int) -> int:
    v = int(v)
    if v <= 1:
        return 1
    return 1 << (v - 1).bit_length()


def i0(x):
    """Modified Bessel function of the first kind, order 0 (series, for hair BxDF)."""
    val = jnp.zeros_like(x)
    x2i = jnp.ones_like(x)
    ifact = 1.0
    i4 = 1.0
    for i in range(10):
        if i > 1:
            ifact *= i
        val = val + x2i / (i4 * ifact * ifact)
        x2i = x2i * x * x
        i4 *= 4.0
    return val


def log_i0(x):
    return jnp.where(
        x > 12.0,
        x + 0.5 * (-jnp.log(2.0 * PI) + jnp.log(1.0 / jnp.maximum(x, 1e-8)) + 1.0 / (8.0 * jnp.maximum(x, 1e-8))),
        jnp.log(jnp.maximum(i0(x), 1e-35)),
    )
