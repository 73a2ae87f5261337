"""Reconstruction filters + filter importance sampling (reference
filters.{h,cpp}: Box, Triangle, Gaussian, Mitchell, LanczosSinc + FilterSampler).

Filter importance sampling (FilterSampler, filters.h:26) lets every film
sample carry weight f(p)/pdf(p) (±1 for the tabulated case), which removes
the need for splatting into neighbouring pixels — ideal for the array film
(pure scatter-add at one pixel per sample).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
from .utils import struct

from .utils import sampling as sp
from .utils.math import sqr, windowed_sinc

FILTER_BOX = 0
FILTER_TRIANGLE = 1
FILTER_GAUSSIAN = 2
FILTER_MITCHELL = 3
FILTER_LANCZOS = 4


@struct.dataclass
class Filter:
    kind: int = struct.field(pytree_node=False, default=FILTER_BOX)
    radius: tuple = struct.field(pytree_node=False, default=(0.5, 0.5))
    # gaussian
    sigma: float = struct.field(pytree_node=False, default=0.5)
    # mitchell
    b: float = struct.field(pytree_node=False, default=1.0 / 3.0)
    c: float = struct.field(pytree_node=False, default=1.0 / 3.0)
    # lanczos
    tau: float = struct.field(pytree_node=False, default=3.0)
    # tabulated |f| distribution for importance sampling (mitchell/lanczos/gauss)
    table: object = struct.field(default=None)  # PiecewiseConstant2D or None


def _mitchell_1d(x, b, c):
    x = jnp.abs(x)
    f_lt1 = ((12 - 9 * b - 6 * c) * x ** 3 + (-18 + 12 * b + 6 * c) * x ** 2 +
             (6 - 2 * b)) * (1.0 / 6.0)
    f_lt2 = ((-b - 6 * c) * x ** 3 + (6 * b + 30 * c) * x ** 2 +
             (-12 * b - 48 * c) * x + (8 * b + 24 * c)) * (1.0 / 6.0)
    return jnp.where(x < 1, f_lt1, jnp.where(x < 2, f_lt2, 0.0))


def evaluate(f: Filter, p):
    """Filter value at offset p (..., 2) from pixel center."""
    x, y = p[..., 0], p[..., 1]
    rx, ry = f.radius
    if f.kind == FILTER_BOX:
        return jnp.where((jnp.abs(x) <= rx) & (jnp.abs(y) <= ry), 1.0, 0.0)
    if f.kind == FILTER_TRIANGLE:
        return jnp.maximum(0.0, rx - jnp.abs(x)) * jnp.maximum(0.0, ry - jnp.abs(y))
    if f.kind == FILTER_GAUSSIAN:
        def g(v, r):
            return jnp.maximum(0.0, jnp.exp(-v * v / (2 * f.sigma ** 2)) -
                               np.exp(-r * r / (2 * f.sigma ** 2)))
        return g(x, rx) * g(y, ry)
    if f.kind == FILTER_MITCHELL:
        return _mitchell_1d(2 * x / rx, f.b, f.c) * _mitchell_1d(2 * y / ry, f.b, f.c)
    if f.kind == FILTER_LANCZOS:
        return windowed_sinc(x, rx, f.tau) * windowed_sinc(y, ry, f.tau)
    raise ValueError(f.kind)


def integral(f: Filter) -> float:
    """Filter integral (reference per-filter Integral())."""
    rx, ry = f.radius
    if f.kind == FILTER_BOX:
        return 4.0 * rx * ry
    if f.kind == FILTER_TRIANGLE:
        return sqr(rx) * sqr(ry)
    # numeric for the rest
    n = 129
    xs = np.linspace(-rx, rx, n)
    ys = np.linspace(-ry, ry, n)
    g = np.stack(np.meshgrid(xs, ys, indexing="ij"), -1)
    v = np.asarray(evaluate(f, jnp.asarray(g, jnp.float32)))
    return float(np.trapezoid(np.trapezoid(v, ys, axis=1), xs))


def make_filter(kind="gaussian", xradius=None, yradius=None, sigma=0.5,
                b=1 / 3, c=1 / 3, tau=3.0) -> Filter:
    kinds = {"box": FILTER_BOX, "triangle": FILTER_TRIANGLE,
             "gaussian": FILTER_GAUSSIAN, "mitchell": FILTER_MITCHELL,
             "sinc": FILTER_LANCZOS}
    k = kinds[kind]
    default_r = {FILTER_BOX: 0.5, FILTER_TRIANGLE: 2.0, FILTER_GAUSSIAN: 1.5,
                 FILTER_MITCHELL: 2.0, FILTER_LANCZOS: 4.0}[k]
    rx = default_r if xradius is None else xradius
    ry = default_r if yradius is None else yradius
    f = Filter(kind=k, radius=(rx, ry), sigma=sigma, b=b, c=c, tau=tau)
    if k in (FILTER_MITCHELL, FILTER_LANCZOS):
        # tabulate |f| on a 32x32 grid for importance sampling (reference
        # FilterSampler ctor, filters.cpp)
        n = 32
        xs = (np.arange(n) + 0.5) / n * 2 * rx - rx
        ys = (np.arange(n) + 0.5) / n * 2 * ry - ry
        g = np.stack(np.meshgrid(xs, ys, indexing="xy"), -1)
        vals = np.asarray(evaluate(f, jnp.asarray(g, jnp.float32)))
        f = f.replace(table=sp.PiecewiseConstant2D.build(np.abs(vals)))
    return f


def sample(f: Filter, u):
    """Importance-sample offset from pixel center.

    u: (..., 2) -> (p (..., 2), weight (...,)) with weight = f(p)/pdf(p).
    """
    rx, ry = f.radius
    if f.kind == FILTER_BOX:
        p = jnp.stack([(u[..., 0] - 0.5) * 2 * rx, (u[..., 1] - 0.5) * 2 * ry], -1)
        return p, jnp.ones(u.shape[:-1], jnp.float32)
    if f.kind == FILTER_TRIANGLE:
        p = jnp.stack([sp.sample_tent(u[..., 0], rx), sp.sample_tent(u[..., 1], ry)], -1)
        return p, jnp.ones(u.shape[:-1], jnp.float32)
    if f.kind == FILTER_GAUSSIAN:
        # analytic truncated-gaussian inverse CDF per axis (gather-free;
        # the reference tabulates via FilterSampler — equivalent up to the
        # g(r) offset, which the f/pdf weight accounts for exactly)
        from .utils.math import erf_inv

        def samp_axis(uu, r):
            # x ~ gaussian truncated to [-r, r]: inverse CDF via erfinv.
            import math
            s2 = f.sigma * np.sqrt(2.0)
            z = math.erf(r / s2)
            x = s2 * erf_inv(
                jnp.clip((2.0 * uu - 1.0) * z, -0.999999, 0.999999))
            x = jnp.clip(x, -r, r)
            pdf = jnp.exp(-x * x / (2 * f.sigma ** 2)) / \
                (f.sigma * np.sqrt(2 * np.pi)) / z
            return x, pdf

        x, pdf_x = samp_axis(u[..., 0], rx)
        y, pdf_y = samp_axis(u[..., 1], ry)
        p = jnp.stack([x, y], -1)
        fv = evaluate(f, p)
        w = fv / jnp.maximum(pdf_x * pdf_y, 1e-12)
        return p, w
    # tabulated: sample uv in [0,1]^2 ~ |f|, weight = f/pdf (may be negative)
    uv, pdf_uv = f.table.sample(u)
    p = jnp.stack([(uv[..., 0] * 2 - 1) * rx, (uv[..., 1] * 2 - 1) * ry], -1)
    pdf = pdf_uv / (4 * rx * ry)  # uv pdf -> area pdf
    fv = evaluate(f, p)
    w = jnp.where(pdf > 0, fv / jnp.where(pdf == 0, 1.0, pdf), 0.0)
    return p, w
