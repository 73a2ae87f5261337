"""Batched ray-primitive intersection kernels.

Vectorized: every function is elementwise over leading batch axes (rays and
primitives broadcast together), pure jnp, and fuses under jit. Reference
algorithms: watertight triangle test (shapes.cpp Triangle::Intersect, Woop et
al. 2013), robust quadric intersections (shapes.h Sphere:107/Disk:404/
Cylinder:574).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..utils.math import quadratic, sqr, safe_div
from ..utils import vecmath as vm


def ray_triangle(o, d, t_max, p0, p1, p2):
    """Watertight ray-triangle intersection.

    All args broadcast; o, d, p*: (..., 3); t_max: (...,).
    Returns dict(hit, t, b0, b1, b2) — barycentrics b0 p0 + b1 p1 + b2 p2.
    """
    # translate so ray origin is at (0,0,0)
    p0t = p0 - o
    p1t = p1 - o
    p2t = p2 - o
    # permute so |d| is largest along z (arithmetic select, no gather)
    kz = jnp.argmax(jnp.abs(d), axis=-1)
    kx = (kz + 1) % 3
    ky = (kx + 1) % 3

    from .gather import pick3 as pick

    dx, dy, dz = pick(d, kx), pick(d, ky), pick(d, kz)
    # shear to align d with +z
    inv_dz = safe_div(1.0, dz)
    sx = -dx * inv_dz
    sy = -dy * inv_dz
    sz = inv_dz

    def shear_xy(p):
        px, py, pz = pick(p, kx), pick(p, ky), pick(p, kz)
        return px + sx * pz, py + sy * pz, pz

    x0, y0, z0 = shear_xy(p0t)
    x1, y1, z1 = shear_xy(p1t)
    x2, y2, z2 = shear_xy(p2t)

    # 2D edge functions
    e0 = x1 * y2 - y1 * x2
    e1 = x2 * y0 - y2 * x0
    e2 = x0 * y1 - y0 * x1

    same_side = ((e0 >= 0) & (e1 >= 0) & (e2 >= 0)) | ((e0 <= 0) & (e1 <= 0) & (e2 <= 0))
    det = e0 + e1 + e2
    valid = same_side & (det != 0.0)

    z0s, z1s, z2s = z0 * sz, z1 * sz, z2 * sz
    t_scaled = e0 * z0s + e1 * z1s + e2 * z2s
    # reject t <= 0 or t >= t_max with det-sign-aware comparisons
    neg_det = det < 0
    t_ok = jnp.where(neg_det,
                     (t_scaled <= 0) & (t_scaled > det * t_max),
                     (t_scaled >= 0) & (t_scaled < det * t_max))
    valid = valid & t_ok

    inv_det = safe_div(1.0, det)
    t = t_scaled * inv_det
    b0 = e0 * inv_det
    b1 = e1 * inv_det
    b2 = e2 * inv_det
    # Conservative t > 0 test: reject hits whose computed t could round to
    # <= 0 (reference shapes.h "Ensure that computed triangle t is
    # conservatively greater than zero", derived via the gamma-bound error
    # analysis on the sheared edge-function evaluation). Without this, a
    # ray spawned exactly on a surface (e.g. an axis-aligned plane whose
    # hit-point error box is degenerate along the normal) falsely re-hits
    # its own triangle at t ~ eps * |coords| and silently loses energy.
    from ..utils.math import gamma_bound
    g2, g3, g5 = gamma_bound(2), gamma_bound(3), gamma_bound(5)
    max_zt = jnp.maximum(jnp.abs(z0s), jnp.maximum(jnp.abs(z1s),
                                                   jnp.abs(z2s)))
    max_xt = jnp.maximum(jnp.abs(x0), jnp.maximum(jnp.abs(x1), jnp.abs(x2)))
    max_yt = jnp.maximum(jnp.abs(y0), jnp.maximum(jnp.abs(y1), jnp.abs(y2)))
    delta_z = g3 * max_zt
    delta_x = g5 * (max_xt + max_zt)
    delta_y = g5 * (max_yt + max_zt)
    delta_e = 2.0 * (g2 * max_xt * max_yt + delta_y * max_xt
                     + delta_x * max_yt)
    max_e = jnp.maximum(jnp.abs(e0), jnp.maximum(jnp.abs(e1), jnp.abs(e2)))
    delta_t = 3.0 * (g3 * max_e * max_zt + delta_e * max_zt
                     + delta_z * max_e) * jnp.abs(inv_det)
    hit = valid & (t > delta_t)
    return dict(hit=hit, t=jnp.where(hit, t, jnp.inf),
                b0=b0, b1=b1, b2=b2)


def triangle_geometry(p0, p1, p2, b0, b1, b2):
    """Hit point, geometric normal, and default UV partials for a triangle."""
    p = b0[..., None] * p0 + b1[..., None] * p1 + b2[..., None] * p2
    ng = vm.normalize(vm.cross(p1 - p0, p2 - p0))
    return p, ng


def ray_sphere(o, d, t_max, radius, z_min=None, z_max=None, phi_max=None):
    """Ray-sphere in the sphere's object space (center at origin).

    Returns dict(hit, t, p, phi). Partial spheres via z/phi clipping
    (reference shapes.h:107 Sphere::BasicIntersect).
    """
    a = vm.dot(d, d)
    b = 2.0 * vm.dot(o, d)
    c = vm.dot(o, o) - sqr(radius)
    has, t0, t1 = quadratic(a, b, c)

    def clip(t):
        p = o + t[..., None] * d
        # refine hit point onto sphere
        p = p * (radius / jnp.maximum(vm.length(p), 1e-20))[..., None]
        phi = jnp.arctan2(p[..., 1], p[..., 0])
        phi = jnp.where(phi < 0, phi + 2 * np.pi, phi)
        ok = (t > 1e-7) & (t < t_max)
        if z_min is not None:
            ok = ok & (p[..., 2] >= z_min) & (p[..., 2] <= z_max)
        if phi_max is not None:
            ok = ok & (phi <= phi_max)
        return ok, t, p, phi

    ok0, t0v, p0v, phi0 = clip(t0)
    ok1, t1v, p1v, phi1 = clip(t1)
    use0 = ok0
    hit = has & (ok0 | ok1)
    t = jnp.where(use0, t0v, t1v)
    p = jnp.where(use0[..., None], p0v, p1v)
    phi = jnp.where(use0, phi0, phi1)
    return dict(hit=hit, t=jnp.where(hit, t, jnp.inf), p=p, phi=phi)


def sphere_geometry(p, radius, z_min, z_max, phi_max, phi):
    """Surface frame for a sphere hit in object space: returns (n, uv, dpdu, dpdv)."""
    theta = jnp.arccos(jnp.clip(p[..., 2] / radius, -1.0, 1.0))
    theta_zmin = np.arccos(np.clip(z_min / radius, -1, 1))
    theta_zmax = np.arccos(np.clip(z_max / radius, -1, 1))
    u = phi / phi_max
    v = (theta - theta_zmin) / jnp.where(theta_zmax == theta_zmin, 1.0, (theta_zmax - theta_zmin))
    z_radius = jnp.sqrt(jnp.maximum(sqr(p[..., 0]) + sqr(p[..., 1]), 1e-20))
    cos_phi = p[..., 0] / z_radius
    sin_phi = p[..., 1] / z_radius
    dpdu = jnp.stack([-phi_max * p[..., 1], phi_max * p[..., 0],
                      jnp.zeros_like(p[..., 0])], axis=-1)
    sin_theta = jnp.sqrt(jnp.maximum(1.0 - sqr(p[..., 2] / radius), 1e-12))
    dpdv = (theta_zmax - theta_zmin) * jnp.stack(
        [p[..., 2] * cos_phi, p[..., 2] * sin_phi, -radius * sin_theta], axis=-1)
    n = vm.normalize(p)
    uv = jnp.stack([u, v], axis=-1)
    return n, uv, dpdu, dpdv


def ray_disk(o, d, t_max, radius, height=0.0, inner_radius=0.0,
             phi_max=None):
    """Exact ray-disk intersection in the disk's object space: the disk is
    the annulus inner_radius <= r <= radius in the plane z == height
    (reference shapes.h:404 Disk::BasicIntersect — no tessellation).

    Returns dict(hit, t, p, phi)."""
    dz = d[..., 2]
    t = safe_div(height - o[..., 2], dz)
    p = o + t[..., None] * d
    r2 = sqr(p[..., 0]) + sqr(p[..., 1])
    phi = jnp.arctan2(p[..., 1], p[..., 0])
    phi = jnp.where(phi < 0, phi + 2 * np.pi, phi)
    hit = (jnp.abs(dz) > 1e-12) & (t > 1e-7) & (t < t_max) & \
        (r2 <= sqr(radius)) & (r2 >= sqr(inner_radius))
    if phi_max is not None:
        hit = hit & (phi <= phi_max)
    return dict(hit=hit, t=t, p=p, phi=phi)


def ray_cylinder(o, d, t_max, radius, z_min, z_max, phi_max=None):
    """Exact ray-cylinder intersection in object space: x^2 + y^2 == r^2,
    z in [z_min, z_max] (reference shapes.h:574 Cylinder::BasicIntersect).

    Returns dict(hit, t, p, phi)."""
    a = sqr(d[..., 0]) + sqr(d[..., 1])
    b = 2.0 * (d[..., 0] * o[..., 0] + d[..., 1] * o[..., 1])
    c = sqr(o[..., 0]) + sqr(o[..., 1]) - sqr(radius)
    has, t0, t1 = quadratic(a, b, c)

    def clip(t):
        p = o + t[..., None] * d
        # refine the hit point onto the cylinder (shapes.h:618)
        hit_rad = jnp.sqrt(jnp.maximum(sqr(p[..., 0]) + sqr(p[..., 1]),
                                       1e-20))
        s = radius / hit_rad
        p = jnp.stack([p[..., 0] * s, p[..., 1] * s, p[..., 2]], axis=-1)
        phi = jnp.arctan2(p[..., 1], p[..., 0])
        phi = jnp.where(phi < 0, phi + 2 * np.pi, phi)
        ok = (t > 1e-7) & (t < t_max) & \
            (p[..., 2] >= z_min) & (p[..., 2] <= z_max)
        if phi_max is not None:
            ok = ok & (phi <= phi_max)
        return ok, t, p, phi

    ok0, t0v, p0v, phi0 = clip(t0)
    ok1, t1v, p1v, phi1 = clip(t1)
    use0 = ok0
    hit = has & (ok0 | ok1)
    t = jnp.where(use0, t0v, t1v)
    p = jnp.where(use0[..., None], p0v, p1v)
    phi = jnp.where(use0, phi0, phi1)
    return dict(hit=hit, t=t, p=p, phi=phi)


def ray_bilinear_patch(o, d, t_max, p00, p10, p01, p11):
    """Reshetov ray/bilinear-patch intersection (reference shapes.h:1279
    IntersectBilinearPatch; "Cool Patches", Ray Tracing Gems ch. 8).

    o, d: (N, 3); t_max: (N,); patch corners broadcastable to (N, 3)
    with point(u, v) = lerp(v; lerp(u; p00, p10), lerp(u; p01, p11)).
    Returns dict(hit, t, u, v)."""
    def dot(a, b):
        return jnp.sum(a * b, axis=-1)

    def cross(a, b):
        return jnp.cross(a, b)

    a = dot(cross(p10 - p00, p01 - p11), d)
    c = dot(cross(p00 - o, d), p01 - p00)
    b = dot(cross(p10 - o, d), p11 - p10) - (a + c)

    # robust quadratic (linear when the patch is a parallelogram: a ~ 0)
    disc = b * b - 4.0 * a * c
    has_roots = disc >= 0.0
    sd = jnp.sqrt(jnp.maximum(disc, 0.0))
    qq = -0.5 * (b + jnp.where(b < 0, -sd, sd))
    lin = jnp.abs(a) < 1e-12 * jnp.maximum(jnp.abs(b), 1.0)
    ra = qq / jnp.where(jnp.abs(a) < 1e-30, 1e-30, a)
    rb = c / jnp.where(jnp.abs(qq) < 1e-30, 1e-30, qq)
    u_lin = -c / jnp.where(jnp.abs(b) < 1e-30, 1e-30, b)
    u1 = jnp.where(lin, u_lin, jnp.minimum(ra, rb))
    u2 = jnp.where(lin, jnp.inf, jnp.maximum(ra, rb))

    mag = (jnp.max(jnp.abs(o), -1) + jnp.max(jnp.abs(d), -1) +
           jnp.max(jnp.abs(p00), -1) + jnp.max(jnp.abs(p10), -1) +
           jnp.max(jnp.abs(p01), -1) + jnp.max(jnp.abs(p11), -1))
    eps = 1.79e-6 * mag  # gamma(30) ~ 30 * 2^-23 / (1 - 30 * 2^-24)

    def eval_at(u):
        uu = u[..., None]
        uo = (1 - uu) * p00 + uu * p10
        ud = ((1 - uu) * p01 + uu * p11) - uo
        deltao = uo - o
        perp = cross(d, ud)
        p2 = dot(perp, perp)
        # det([deltao | d | perp]) and det([deltao | ud | perp]) as columns:
        # det = dot(col0, cross(col1, col2))
        v_num = dot(deltao, cross(d, perp))
        t_num = dot(deltao, cross(ud, perp))
        in_u = (u >= 0.0) & (u <= 1.0) & has_roots
        ok = in_u & (t_num > p2 * eps) & (v_num >= 0.0) & (v_num <= p2)
        p2s = jnp.where(p2 <= 0, 1.0, p2)
        return ok & (p2 > 0), t_num / p2s, v_num / p2s

    ok1, t1, v1 = eval_at(u1)
    ok2, t2, v2 = eval_at(u2)
    ok1 = ok1 & (t1 < t_max)
    ok2 = ok2 & (t2 < t_max)
    pick2 = ok2 & (~ok1 | (t2 < t1))
    hit = ok1 | ok2
    t = jnp.where(pick2, t2, t1)
    u = jnp.where(pick2, u2, u1)
    v = jnp.where(pick2, v2, v1)
    return dict(hit=hit, t=jnp.where(hit, t, jnp.inf), u=u, v=v)
