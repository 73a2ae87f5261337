"""Monte Carlo sampling warps and distributions (reference util/sampling.{h,cpp}).

All warps take uniform samples in [0,1)^k as (..., k) or scalar arrays and are
elementwise/jit-safe. Distributions (PiecewiseConstant1D/2D, AliasTable) are
built on host (numpy) and sampled on device via gathers.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
from . import struct

from .math import PI, INV_PI, INV_2PI, INV_4PI, ONE_MINUS_EPSILON, safe_sqrt, sqr, lerp, safe_div
from .vecmath import v3, dot, cross, normalize, length


# ---------------------------------------------------------------------------
# Basic warps

def sample_uniform_disk_concentric(u):
    """Concentric disk mapping (reference sampling.h:SampleUniformDiskConcentric)."""
    ox = 2.0 * u[..., 0] - 1.0
    oy = 2.0 * u[..., 1] - 1.0
    zero = (ox == 0.0) & (oy == 0.0)
    cond = jnp.abs(ox) > jnp.abs(oy)
    r = jnp.where(cond, ox, oy)
    theta = jnp.where(cond, (PI / 4.0) * safe_div(oy, ox),
                      (PI / 2.0) - (PI / 4.0) * safe_div(ox, oy))
    r = jnp.where(zero, 0.0, r)
    return jnp.stack([r * jnp.cos(theta), r * jnp.sin(theta)], axis=-1)


def sample_uniform_disk_polar(u):
    r = jnp.sqrt(u[..., 0])
    theta = 2.0 * PI * u[..., 1]
    return jnp.stack([r * jnp.cos(theta), r * jnp.sin(theta)], axis=-1)


def sample_uniform_hemisphere(u):
    z = u[..., 0]
    r = safe_sqrt(1.0 - sqr(z))
    phi = 2.0 * PI * u[..., 1]
    return v3(r * jnp.cos(phi), r * jnp.sin(phi), z)


def uniform_hemisphere_pdf():
    return INV_2PI


def sample_uniform_sphere(u):
    z = 1.0 - 2.0 * u[..., 0]
    r = safe_sqrt(1.0 - sqr(z))
    phi = 2.0 * PI * u[..., 1]
    return v3(r * jnp.cos(phi), r * jnp.sin(phi), z)


def uniform_sphere_pdf():
    return INV_4PI


def sample_cosine_hemisphere(u):
    d = sample_uniform_disk_concentric(u)
    z = safe_sqrt(1.0 - sqr(d[..., 0]) - sqr(d[..., 1]))
    return v3(d[..., 0], d[..., 1], z)


def cosine_hemisphere_pdf(cos_theta):
    return cos_theta * INV_PI


def sample_uniform_cone(u, cos_theta_max):
    cos_theta = (1.0 - u[..., 0]) + u[..., 0] * cos_theta_max
    sin_theta = safe_sqrt(1.0 - sqr(cos_theta))
    phi = 2.0 * PI * u[..., 1]
    return v3(jnp.cos(phi) * sin_theta, jnp.sin(phi) * sin_theta, cos_theta)


def uniform_cone_pdf(cos_theta_max):
    return 1.0 / (2.0 * PI * (1.0 - cos_theta_max))


def sample_uniform_triangle(u):
    """Low-distortion triangle warp (reference sampling.h:173): returns
    barycentrics (b0, b1, b2)."""
    cond = u[..., 0] < u[..., 1]
    b0 = jnp.where(cond, u[..., 0] / 2.0, u[..., 0] - u[..., 1] / 2.0)
    b1 = jnp.where(cond, u[..., 1] - b0, u[..., 1] / 2.0)
    return jnp.stack([b0, b1, 1.0 - b0 - b1], axis=-1)


def invert_uniform_triangle_sample(b):
    """Inverse of sample_uniform_triangle (reference InvertUniformTriangleSample)."""
    cond = b[..., 0] > b[..., 1]
    # b0 = u0/2, b1 = u1 - u0/2      (u0 < u1 branch)
    u0_a = 2.0 * b[..., 0]
    u1_a = b[..., 1] + b[..., 0]
    # b0 = u0 - u1/2, b1 = u1/2      (other branch)
    u1_b = 2.0 * b[..., 1]
    u0_b = b[..., 0] + b[..., 1]
    u0 = jnp.where(cond, u0_b, u0_a)
    u1 = jnp.where(cond, u1_b, u1_a)
    return jnp.stack([u0, u1], axis=-1)


def sample_exponential(u, a):
    """Sample t ~ a e^{-a t} (reference SampleExponential)."""
    return -jnp.log1p(-u) / a


def sample_discrete(weights, u):
    """Sample an index from unnormalized weights along last axis.

    Returns (index, pmf, u_remapped)."""
    cdf = jnp.cumsum(weights, axis=-1)
    total = cdf[..., -1:]
    up = u[..., None] * total
    idx = jnp.sum((up >= cdf).astype(jnp.int32), axis=-1)
    idx = jnp.clip(idx, 0, weights.shape[-1] - 1)
    w = jnp.take_along_axis(weights, idx[..., None], axis=-1)[..., 0]
    pmf = safe_div(w, total[..., 0])
    prev = jnp.where(idx == 0, 0.0,
                     jnp.take_along_axis(cdf, jnp.maximum(idx - 1, 0)[..., None], axis=-1)[..., 0])
    u_new = jnp.clip(safe_div(up[..., 0] - prev, w), 0.0, ONE_MINUS_EPSILON)
    return idx, pmf, u_new


def balance_heuristic(nf, f_pdf, ng, g_pdf):
    return safe_div(nf * f_pdf, nf * f_pdf + ng * g_pdf)


# Henyey-Greenstein phase function (reference media.h HGPhaseFunction)
def henyey_greenstein(cos_theta, g):
    g = jnp.clip(g, -0.99, 0.99)
    denom = 1.0 + sqr(g) + 2.0 * g * cos_theta
    return INV_4PI * (1.0 - sqr(g)) / (denom * safe_sqrt(denom))


def sample_henyey_greenstein(u, g, wo):
    """Sample direction w.r.t. wo; returns (wi, pdf). (reference sampling.h)"""
    from .vecmath import coordinate_system
    g = jnp.clip(g, -0.99, 0.99)
    g_nz = jnp.where(jnp.abs(g) < 1e-3, jnp.where(g < 0, -1e-3, 1e-3), g)
    s = (1.0 - sqr(g_nz)) / (1.0 + g_nz - 2.0 * g_nz * u[..., 0])
    cos_theta_hg = -(1.0 + sqr(g_nz) - sqr(s)) / (2.0 * g_nz)
    cos_theta_iso = 1.0 - 2.0 * u[..., 0]
    cos_theta = jnp.where(jnp.abs(g) < 1e-3, cos_theta_iso, cos_theta_hg)
    sin_theta = safe_sqrt(1.0 - sqr(cos_theta))
    phi = 2.0 * PI * u[..., 1]
    t1, t2 = coordinate_system(wo)
    wi = (sin_theta * jnp.cos(phi))[..., None] * t1 + \
         (sin_theta * jnp.sin(phi))[..., None] * t2 + cos_theta[..., None] * wo
    pdf = henyey_greenstein(cos_theta, g)
    return wi, pdf


# Visible wavelength / misc helpers used by film & lights
def sample_linear(u, a, b):
    """Sample x in [0,1] ~ lerp(x, a, b) (reference SampleLinear)."""
    x = safe_div(u * (a + b), a + jnp.sqrt(jnp.maximum(lerp(u, sqr(a), sqr(b)), 0.0)))
    return jnp.minimum(x, ONE_MINUS_EPSILON)


def linear_pdf(x, a, b):
    inside = (x >= 0) & (x <= 1)
    return jnp.where(inside, 2.0 * lerp(x, a, b) / (a + b), 0.0)


def sample_tent(u, radius):
    """Tent filter importance sample over [-r, r] (reference SampleTent).

    Inverse CDF: CDF(x) = (x/r + 1)^2 / 2 for x < 0; 1 - (1 - x/r)^2 / 2 else.
    """
    left = u < 0.5
    xl = radius * (jnp.sqrt(jnp.maximum(2.0 * u, 0.0)) - 1.0)
    xr = radius * (1.0 - jnp.sqrt(jnp.maximum(2.0 * (1.0 - u), 0.0)))
    return jnp.where(left, xl, xr)


def tent_pdf(x, radius):
    return jnp.where(jnp.abs(x) < radius, 1.0 / radius - jnp.abs(x) / sqr(radius), 0.0)


# ---------------------------------------------------------------------------
# PiecewiseConstant1D/2D: host build, device sample (reference sampling.h:603,698)

@struct.dataclass
class PiecewiseConstant1D:
    func: jnp.ndarray      # (n,) absolute values
    cdf: jnp.ndarray       # (n+1,)
    func_int: jnp.ndarray  # scalar
    min_x: float = struct.field(pytree_node=False, default=0.0)
    max_x: float = struct.field(pytree_node=False, default=1.0)

    @staticmethod
    def build(f, min_x=0.0, max_x=1.0):
        f = np.abs(np.asarray(f, np.float64))
        n = len(f)
        cdf = np.zeros(n + 1)
        cdf[1:] = np.cumsum(f * (max_x - min_x) / n)
        func_int = cdf[-1]
        if func_int == 0:
            cdf[1:] = np.arange(1, n + 1) / n
        else:
            cdf[1:] /= func_int
        return PiecewiseConstant1D(
            func=jnp.asarray(f, jnp.float32), cdf=jnp.asarray(cdf, jnp.float32),
            func_int=jnp.asarray(func_int, jnp.float32),
            min_x=float(min_x), max_x=float(max_x))

    def sample(self, u):
        """Returns (x, pdf, offset)."""
        n = self.func.shape[0]
        offset = jnp.searchsorted(self.cdf, u, side="right") - 1
        offset = jnp.clip(offset, 0, n - 1)
        c0 = self.cdf[offset]
        c1 = self.cdf[offset + 1]
        du = jnp.where(c1 > c0, (u - c0) / jnp.where(c1 == c0, 1.0, c1 - c0), 0.0)
        pdf = jnp.where(self.func_int > 0, self.func[offset] / self.func_int, 0.0)
        x = self.min_x + (offset.astype(jnp.float32) + du) / n * (self.max_x - self.min_x)
        return x, pdf, offset


@struct.dataclass
class PiecewiseConstant2D:
    """2D distribution: p_marginal over rows (v), conditional over cols (u)."""
    func: jnp.ndarray          # (nv, nu)
    cond_cdf: jnp.ndarray      # (nv, nu+1)
    marg_cdf: jnp.ndarray      # (nv+1,)
    marg_func: jnp.ndarray     # (nv,)
    func_int: jnp.ndarray      # scalar

    @staticmethod
    def build(f):
        f = np.abs(np.asarray(f, np.float64))
        nv, nu = f.shape
        cond_cdf = np.zeros((nv, nu + 1))
        cond_cdf[:, 1:] = np.cumsum(f / nu, axis=1)
        row_int = cond_cdf[:, -1].copy()
        safe = np.where(row_int == 0, 1.0, row_int)
        cond_cdf[:, 1:] /= safe[:, None]
        zero_rows = row_int == 0
        if zero_rows.any():
            cond_cdf[zero_rows, 1:] = np.arange(1, nu + 1) / nu
        marg_cdf = np.zeros(nv + 1)
        marg_cdf[1:] = np.cumsum(row_int / nv)
        func_int = marg_cdf[-1]
        marg_cdf[1:] /= func_int if func_int > 0 else 1.0
        return PiecewiseConstant2D(
            func=jnp.asarray(f, jnp.float32),
            cond_cdf=jnp.asarray(cond_cdf, jnp.float32),
            marg_cdf=jnp.asarray(marg_cdf, jnp.float32),
            marg_func=jnp.asarray(row_int, jnp.float32),
            func_int=jnp.asarray(func_int, jnp.float32))

    def sample(self, u2):
        """u2 (..., 2) -> ((..., 2) uv in [0,1]^2, pdf)."""
        nv, nu = self.func.shape
        vi = jnp.clip(jnp.searchsorted(self.marg_cdf, u2[..., 1], side="right") - 1, 0, nv - 1)
        c0 = self.marg_cdf[vi]
        c1 = self.marg_cdf[vi + 1]
        dv = jnp.where(c1 > c0, (u2[..., 1] - c0) / jnp.where(c1 == c0, 1.0, c1 - c0), 0.0)
        row_cdf = self.cond_cdf[vi]  # gathered (..., nu+1)
        uu = u2[..., 0]
        ui = jnp.sum((uu[..., None] >= row_cdf).astype(jnp.int32), axis=-1) - 1
        ui = jnp.clip(ui, 0, nu - 1)
        d0 = jnp.take_along_axis(row_cdf, ui[..., None], axis=-1)[..., 0]
        d1 = jnp.take_along_axis(row_cdf, (ui + 1)[..., None], axis=-1)[..., 0]
        du = jnp.where(d1 > d0, (uu - d0) / jnp.where(d1 == d0, 1.0, d1 - d0), 0.0)
        fv = jnp.take_along_axis(self.func[vi], ui[..., None], axis=-1)[..., 0]
        u_coord = (ui.astype(jnp.float32) + du) / nu
        v_coord = (vi.astype(jnp.float32) + dv) / nv
        # joint pdf over [0,1]^2: f(u,v) / integral(f)
        pdf = safe_div(fv, self.func_int)
        return jnp.stack([u_coord, v_coord], axis=-1), pdf

    def pdf(self, uv):
        nv, nu = self.func.shape
        ui = jnp.clip((uv[..., 0] * nu).astype(jnp.int32), 0, nu - 1)
        vi = jnp.clip((uv[..., 1] * nv).astype(jnp.int32), 0, nv - 1)
        return safe_div(self.func[vi, ui], self.func_int)


# ---------------------------------------------------------------------------
# Alias table (reference sampling.h:804): O(1) discrete sampling

@struct.dataclass
class AliasTable:
    q: jnp.ndarray        # (n,) acceptance thresholds
    alias: jnp.ndarray    # (n,) alias indices
    pmf: jnp.ndarray      # (n,)

    @staticmethod
    def build(weights):
        w = np.asarray(weights, np.float64)
        n = len(w)
        total = w.sum()
        if total == 0:
            w = np.ones(n)
            total = n
        pmf = w / total
        scaled = pmf * n
        q = np.ones(n)
        alias = np.arange(n)
        small = [i for i in range(n) if scaled[i] < 1.0]
        large = [i for i in range(n) if scaled[i] >= 1.0]
        scaled = scaled.copy()
        while small and large:
            s = small.pop()
            l = large.pop()
            q[s] = scaled[s]
            alias[s] = l
            scaled[l] = (scaled[l] + scaled[s]) - 1.0
            (small if scaled[l] < 1.0 else large).append(l)
        return AliasTable(q=jnp.asarray(q, jnp.float32),
                          alias=jnp.asarray(alias, jnp.int32),
                          pmf=jnp.asarray(pmf, jnp.float32))

    def sample(self, u):
        """Returns (index, pmf, u_remapped)."""
        n = self.q.shape[0]
        up = u * n
        i = jnp.clip(up.astype(jnp.int32), 0, n - 1)
        frac = up - i.astype(jnp.float32)
        take_primary = frac < self.q[i]
        idx = jnp.where(take_primary, i, self.alias[i])
        qi = self.q[i]
        u_new = jnp.where(take_primary, safe_div(frac, qi),
                          safe_div(frac - qi, 1.0 - qi))
        return idx, self.pmf[idx], jnp.clip(u_new, 0.0, ONE_MINUS_EPSILON)


# ---------------------------------------------------------------------------
# Variance estimation (reference sampling.h:484 VarianceEstimator) — Welford,
# expressed functionally for scan-style accumulation.

def variance_update(state, x):
    """state = (mean, m2, n). Returns updated state."""
    mean, m2, n = state
    n1 = n + 1.0
    delta = x - mean
    mean = mean + delta / n1
    m2 = m2 + delta * (x - mean)
    return (mean, m2, n1)


def variance_value(state):
    mean, m2, n = state
    return jnp.where(n > 1, m2 / jnp.maximum(n - 1, 1.0), 0.0)


# ---------------------------------------------------------------------------
# Spherical triangle sampling (reference sampling.h:76 SampleSphericalTriangle
# / Arvo 1995): uniform solid-angle sampling of a triangle seen from p.

def spherical_triangle_area(a, b, c):
    """Solid angle of the spherical triangle with unit vertices a, b, c
    (reference SphericalTriangleArea, vecmath.h): Girard via atan2 of the
    scalar triple product — numerically stable near zero area."""
    num = jnp.abs(dot(a, cross(b, c)))
    den = 1.0 + dot(a, b) + dot(a, c) + dot(b, c)
    return 2.0 * jnp.arctan2(num, den)


def sample_spherical_triangle(v0, v1, v2, p, u2):
    """Uniform solid-angle triangle sample (reference Arvo's algorithm).

    v0/v1/v2: (N, 3) triangle vertices; p: (N, 3) reference point;
    u2: (N, 2). Returns (bary (N, 3), pdf_solid_angle (N,)) — pdf 0 when
    the subtended solid angle vanishes."""
    a = normalize(v0 - p)
    b = normalize(v1 - p)
    c = normalize(v2 - p)
    area = spherical_triangle_area(a, b, c)
    # sample sub-triangle area fraction
    Ap = u2[..., 0] * area
    # Arvo: compute the new vertex c' on edge (a, c)
    cos_alpha = dot(b - a * dot(a, b)[..., None],
                    c - a * dot(a, c)[..., None])
    # dihedral angle at vertex a
    n_ab = cross(a, b)
    n_ac = cross(a, c)
    n_ab = n_ab / jnp.maximum(length(n_ab), 1e-12)[..., None]
    n_ac = n_ac / jnp.maximum(length(n_ac), 1e-12)[..., None]
    cos_a = jnp.clip(-dot(n_ab, n_ac), -1.0, 1.0)
    alpha = jnp.arccos(cos_a)
    sin_a = jnp.sin(alpha)
    # spherical triangle angles via spherical trig (Girard)
    # Arvo's closed form:
    s = jnp.sin(Ap - alpha)
    t = jnp.cos(Ap - alpha)
    uu = t - jnp.cos(alpha)
    vv = s + sin_a * dot(a, b)
    q = safe_div((vv * t - uu * s) * jnp.cos(alpha) - vv,
                 (vv * s + uu * t) * sin_a)
    q = jnp.clip(q, -1.0, 1.0)
    c_hat = q[..., None] * a + jnp.sqrt(jnp.maximum(1 - q * q, 0.0))[..., None] * \
        normalize(c - a * dot(a, c)[..., None])
    z = 1.0 - u2[..., 1] * (1.0 - dot(c_hat, b))
    z = jnp.clip(z, -1.0, 1.0)
    w = z[..., None] * b + jnp.sqrt(jnp.maximum(1 - z * z, 0.0))[..., None] * \
        normalize(c_hat - b * dot(b, c_hat)[..., None])
    # intersect the ray (p, w) with the triangle plane for barycentrics
    n = cross(v1 - v0, v2 - v0)
    denom = dot(w, n)
    tt = safe_div(dot(v0 - p, n), denom)
    hit_p = p + tt[..., None] * w
    # barycentric via areas
    n2 = jnp.maximum(dot(n, n), 1e-20)
    b1 = dot(cross(v2 - v0, hit_p - v0), n) / n2
    b2 = dot(cross(hit_p - v0, v1 - v0), n) / n2
    b1 = jnp.clip(b1, 0.0, 1.0)
    b2 = jnp.clip(b2, 0.0, 1.0 - b1)
    bary = jnp.stack([1.0 - b1 - b2, b1, b2], -1)
    pdf = jnp.where(area > 1e-7, safe_div(1.0, area), 0.0)
    return bary, pdf


# ---------------------------------------------------------------------------
# Summed-area table + windowed 2D distribution (reference sampling.h:830
# SummedAreaTable, :895 WindowedPiecewiseConstant2D) — the machinery behind
# PortalImageInfiniteLight.

from . import struct as _struct


@_struct.dataclass
class SummedAreaTable:
    """Inclusive 2D prefix sums of a (H, W) function; integrals over any
    axis-aligned window in O(1) (4 taps)."""
    sums: jnp.ndarray  # (H+1, W+1) f64-ish f32 prefix sums

    @staticmethod
    def build(f):
        f = jnp.asarray(f, jnp.float32)
        s = jnp.cumsum(jnp.cumsum(f, axis=0), axis=1)
        s = jnp.pad(s, ((1, 0), (1, 0)))
        return SummedAreaTable(sums=s)

    def integral(self, x0, y0, x1, y1):
        """Sum of f over texel window [x0, x1) x [y0, y1) (int coords)."""
        s = self.sums
        return (s[y1, x1] - s[y0, x1] - s[y1, x0] + s[y0, x0])


@_struct.dataclass
class WindowedPiecewiseConstant2D:
    """Sample proportionally to f restricted to a window (reference
    WindowedPiecewiseConstant2D, sampling.h:895): conditional inversion by
    binary search on SAT column/row integrals."""
    sat: SummedAreaTable
    f: jnp.ndarray  # (H, W)

    @staticmethod
    def build(f):
        f = jnp.asarray(f, jnp.float32)
        return WindowedPiecewiseConstant2D(sat=SummedAreaTable.build(f), f=f)

    def sample(self, u2, x0, y0, x1, y1):
        """u2: (N, 2); window texel bounds (N,) int32. Returns (x, y texel
        coords (N,), pdf (N,) in texel measure). pdf 0 if the window
        integral vanishes."""
        H, W = self.f.shape
        total = self.sat.integral(x0, y0, x1, y1)

        # sample x: invert the marginal via bisection over columns
        def bisect(lo, hi, target, integral_fn, iters):
            for _ in range(iters):
                mid = (lo + hi) // 2
                below = integral_fn(mid) <= target
                lo = jnp.where(below, mid, lo)
                hi = jnp.where(below, hi, mid)
            return lo

        tx = u2[..., 0] * total
        n_iter = int(np.ceil(np.log2(max(W, 2)))) + 1
        x = bisect(x0, x1, tx,
                   lambda m: self.sat.integral(x0, y0, m, y1), n_iter)
        x = jnp.clip(x, x0, x1 - 1)
        # sample y within column x
        col = self.sat.integral(x, y0, x + 1, y1)
        ty = u2[..., 1] * col
        n_iter_y = int(np.ceil(np.log2(max(H, 2)))) + 1
        y = bisect(y0, y1, ty,
                   lambda m: self.sat.integral(x, y0, x + 1, m), n_iter_y)
        y = jnp.clip(y, y0, y1 - 1)
        fxy = self.f[y, x]
        pdf = jnp.where(total > 0, safe_div(fxy, total), 0.0)
        return x, y, pdf

    def pdf(self, x, y, x0, y0, x1, y1):
        total = self.sat.integral(x0, y0, x1, y1)
        return jnp.where(total > 0, safe_div(self.f[y, x], total), 0.0)


# ---------------------------------------------------------------------------
# Weighted reservoir sampling (reference sampling.h:593
# WeightedReservoirSampler) — functional single-slot reservoir.

def reservoir_init(shape=()):
    """state = (weight_sum, reservoir_value_index, rng_carry)."""
    return (jnp.zeros(shape, jnp.float32), jnp.full(shape, -1, jnp.int32))


def reservoir_add(state, index, weight, u):
    """Consider `index` with `weight`; u: uniform [0,1). Returns state."""
    wsum, cur = state
    wsum_new = wsum + weight
    take = u * wsum_new < weight
    return (wsum_new, jnp.where(take & (weight > 0), index, cur))
