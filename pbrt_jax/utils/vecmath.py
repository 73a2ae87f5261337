"""Vector geometry on packed (..., 3) / (..., 2) arrays.

Array replacement for the reference's templated value classes
(pbrt-v4 util/vecmath.h): instead of Vector3f objects we operate on arrays
whose trailing axis is the component axis, so every function is trivially
batched and fuses into surrounding XLA ops.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from .math import safe_acos, safe_sqrt, sqr, PI


def v3(x, y, z):
    return jnp.stack(jnp.broadcast_arrays(
        jnp.asarray(x, jnp.float32), jnp.asarray(y, jnp.float32),
        jnp.asarray(z, jnp.float32)), axis=-1)


def v2(x, y):
    return jnp.stack(jnp.broadcast_arrays(
        jnp.asarray(x, jnp.float32), jnp.asarray(y, jnp.float32)), axis=-1)


def dot(a, b):
    return jnp.sum(a * b, axis=-1)


def absdot(a, b):
    return jnp.abs(dot(a, b))


def cross(a, b):
    return jnp.cross(a, b)


def length_squared(v):
    return dot(v, v)


def length(v):
    return jnp.sqrt(length_squared(v))


def normalize(v):
    return v / jnp.maximum(length(v), 1e-20)[..., None]


def distance(a, b):
    return length(a - b)


def distance_squared(a, b):
    return length_squared(a - b)


def face_forward(n, v):
    """Flip n to lie in the hemisphere of v (reference vecmath.h FaceForward)."""
    return jnp.where((dot(n, v) < 0.0)[..., None], -n, n)


def reflect(wo, n):
    """Mirror reflection of wo about n (reference util/scattering.h Reflect)."""
    return -wo + 2.0 * dot(wo, n)[..., None] * n


def refract(wi, n, eta):
    """Snell refraction (reference util/scattering.h Refract).

    wi points away from the surface; n is oriented to the same side as wi.
    eta is the relative IOR (transmitted/incident handled by caller flipping).
    Returns (valid, wt, eta_used) where eta_used accounts for orientation.
    """
    cos_theta_i = dot(n, wi)
    flip = cos_theta_i < 0.0
    eta = jnp.where(flip, 1.0 / eta, eta)
    cos_theta_i = jnp.abs(cos_theta_i)
    n = jnp.where(flip[..., None], -n, n)
    sin2_theta_i = jnp.maximum(0.0, 1.0 - sqr(cos_theta_i))
    sin2_theta_t = sin2_theta_i / sqr(eta)
    tir = sin2_theta_t >= 1.0
    cos_theta_t = safe_sqrt(1.0 - sin2_theta_t)
    wt = -wi / eta[..., None] + (cos_theta_i / eta - cos_theta_t)[..., None] * n
    return ~tir, wt, eta


def coordinate_system(v):
    """Branchless orthonormal basis (Duff et al. 2017; reference vecmath.h:560).

    Returns (t, b) such that (t, b, v) is an orthonormal frame.
    """
    z = v[..., 2]
    sign = jnp.where(z >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + z)
    b = v[..., 0] * v[..., 1] * a
    t1 = jnp.stack([1.0 + sign * sqr(v[..., 0]) * a, sign * b, -sign * v[..., 0]], axis=-1)
    t2 = jnp.stack([b, sign + sqr(v[..., 1]) * a, -v[..., 1]], axis=-1)
    return t1, t2


def gram_schmidt(v, w):
    return v - dot(v, w)[..., None] * w


def angle_between(a, b):
    """Numerically stable angle (reference vecmath.h AngleBetween)."""
    small = dot(a, b) < 0.0
    ang_pos = 2.0 * jnp.arcsin(jnp.clip(length(b - a) / 2.0, -1.0, 1.0))
    ang_neg = PI - 2.0 * jnp.arcsin(jnp.clip(length(a + b) / 2.0, -1.0, 1.0))
    return jnp.where(small, ang_neg, ang_pos)


# ---------------------------------------------------------------------------
# Spherical geometry (reference vecmath.h SphericalDirection etc.)

def spherical_direction(sin_theta, cos_theta, phi):
    sin_theta = jnp.clip(sin_theta, -1.0, 1.0)
    cos_theta = jnp.clip(cos_theta, -1.0, 1.0)
    return jnp.stack([sin_theta * jnp.cos(phi), sin_theta * jnp.sin(phi), cos_theta], axis=-1)


def spherical_theta(v):
    return safe_acos(v[..., 2])


def spherical_phi(v):
    p = jnp.arctan2(v[..., 1], v[..., 0])
    return jnp.where(p < 0.0, p + 2.0 * PI, p)


def cos_theta(w):
    return w[..., 2]


def cos2_theta(w):
    return sqr(w[..., 2])


def abs_cos_theta(w):
    return jnp.abs(w[..., 2])


def sin2_theta(w):
    return jnp.maximum(0.0, 1.0 - cos2_theta(w))


def sin_theta(w):
    return jnp.sqrt(sin2_theta(w))


def tan_theta(w):
    return sin_theta(w) / w[..., 2]


def tan2_theta(w):
    return sin2_theta(w) / cos2_theta(w)


def cos_phi(w):
    s = sin_theta(w)
    return jnp.where(s == 0.0, 1.0, jnp.clip(w[..., 0] / jnp.maximum(s, 1e-20), -1.0, 1.0))


def sin_phi(w):
    s = sin_theta(w)
    return jnp.where(s == 0.0, 0.0, jnp.clip(w[..., 1] / jnp.maximum(s, 1e-20), -1.0, 1.0))


def same_hemisphere(w, wp):
    return w[..., 2] * wp[..., 2] > 0.0


def spherical_triangle_area(a, b, c):
    """Solid angle of spherical triangle (reference vecmath.h:99 Girard)."""
    return jnp.abs(2.0 * jnp.arctan2(dot(a, cross(b, c)),
                                     1.0 + dot(a, b) + dot(a, c) + dot(b, c)))


def spherical_quad_area(a, b, c, d):
    axb, bxc = cross(a, b), cross(b, c)
    cxd, dxa = cross(c, d), cross(d, a)
    g1 = angle_between(normalize(dxa), -normalize(axb))
    g2 = angle_between(normalize(axb), -normalize(bxc))
    g3 = angle_between(normalize(bxc), -normalize(cxd))
    g4 = angle_between(normalize(cxd), -normalize(dxa))
    return jnp.abs(g1 + g2 + g3 + g4 - 2.0 * PI)


# ---------------------------------------------------------------------------
# Octahedral / equal-area sphere mappings (reference vecmath.h:1640-1784),
# used by ImageInfiniteLight and compact normal storage.

def _sign_not_zero(x):
    return jnp.where(x >= 0.0, 1.0, -1.0)


def equal_area_sphere_to_square(d):
    """Direction -> [0,1]^2 equal-area octahedral map (Clarberg 2008)."""
    x, y, z = jnp.abs(d[..., 0]), jnp.abs(d[..., 1]), jnp.abs(d[..., 2])
    r = safe_sqrt(1.0 - z)
    a = jnp.maximum(x, y)
    b = jnp.minimum(x, y)
    b = jnp.where(a == 0.0, 0.0, b / jnp.maximum(a, 1e-20))
    # atan approximation domain [0,1]
    phi = jnp.arctan(b) * (2.0 / PI)
    phi = jnp.where(x < y, 1.0 - phi, phi)
    v = phi * r
    u = r - v
    # southern hemisphere: fold
    u_s, v_s = 1.0 - v, 1.0 - u
    u = jnp.where(d[..., 2] < 0.0, u_s, u)
    v = jnp.where(d[..., 2] < 0.0, v_s, v)
    u = u * _sign_not_zero(d[..., 0])
    v = v * _sign_not_zero(d[..., 1])
    return jnp.stack([0.5 * (u + 1.0), 0.5 * (v + 1.0)], axis=-1)


def equal_area_square_to_sphere(p):
    """[0,1]^2 -> unit direction, inverse of the above (reference vecmath.cpp)."""
    u = 2.0 * p[..., 0] - 1.0
    v = 2.0 * p[..., 1] - 1.0
    up = jnp.abs(u)
    vp = jnp.abs(v)
    sd = 1.0 - (up + vp)
    d = jnp.abs(sd)
    r = 1.0 - d
    phi = jnp.where(r == 0.0, 1.0, (vp - up) / jnp.maximum(r, 1e-20) + 1.0) * PI / 4.0
    z = (1.0 - r * r) * jnp.sign(sd)
    cos_phi_v = jnp.cos(phi) * jnp.sign(u)
    sin_phi_v = jnp.sin(phi) * jnp.sign(v)
    scale = r * safe_sqrt(2.0 - r * r)
    return jnp.stack([cos_phi_v * scale, sin_phi_v * scale, z], axis=-1)


# ---------------------------------------------------------------------------
# Axis-aligned bounds as (..., 2, 3) arrays: [..., 0, :]=lo, [..., 1, :]=hi.

def bounds_union(b1, b2):
    lo = jnp.minimum(b1[..., 0, :], b2[..., 0, :])
    hi = jnp.maximum(b1[..., 1, :], b2[..., 1, :])
    return jnp.stack([lo, hi], axis=-2)


def bounds_union_point(b, p):
    lo = jnp.minimum(b[..., 0, :], p)
    hi = jnp.maximum(b[..., 1, :], p)
    return jnp.stack([lo, hi], axis=-2)


def bounds_diagonal(b):
    return b[..., 1, :] - b[..., 0, :]


def bounds_surface_area(b):
    d = bounds_diagonal(b)
    return 2.0 * (d[..., 0] * d[..., 1] + d[..., 0] * d[..., 2] + d[..., 1] * d[..., 2])


def bounds_centroid(b):
    return 0.5 * (b[..., 0, :] + b[..., 1, :])


def empty_bounds():
    return np.array([[np.inf, np.inf, np.inf], [-np.inf, -np.inf, -np.inf]], np.float32)


def ray_bounds_intersect_p(o, inv_d, t_max, blo, bhi):
    """Slab test (reference vecmath.h:1547 Bounds3::IntersectP).

    o, inv_d: (..., 3); blo, bhi: (..., 3). Returns (hit, t_near).
    """
    t0 = (blo - o) * inv_d
    t1 = (bhi - o) * inv_d
    t_near = jnp.max(jnp.minimum(t0, t1), axis=-1)
    t_far = jnp.min(jnp.maximum(t0, t1), axis=-1) * 1.0000004  # 2*gamma(3) pad
    hit = (t_near <= t_far) & (t_far > 0.0) & (t_near < t_max)
    return hit, t_near
