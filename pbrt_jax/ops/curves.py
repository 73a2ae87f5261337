"""Curve shape: cubic Bezier hair/fur primitives (reference shapes.h:1219
Curve + shapes.cpp Curve::RecursiveIntersect).

Design: the reference walks a recursive splitting tree per (ray, curve)
until a depth bound, then runs a width-aware LINEAR segment test in a
ray-aligned coordinate system. Data-dependent recursion does not map to
masked lanes, so the splitting is hoisted to scene build: each curve is split ONCE
into 2^depth Bezier sub-segments (the same segments the recursion would
reach), each with its own tight bound, and those sub-segments become the
leaf primitives of a dedicated curve BVH (reusing the binned-SAH builder
and stack traversal from ops/bvh.py). The per-leaf test is exactly the
reference's base case.

Curve types (reference CurveType): flat (faces the ray), cylinder (shaded
as a tube), ribbon (fixed orientation lerped along the curve).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..utils import vecmath as vm
from .gather import f32_to_i32, pool_lookup
from . import bvh as bvh_mod

CURVE_FLAT = 0
CURVE_CYLINDER = 1
CURVE_RIBBON = 2

# packed sub-segment rows:
# [pa(3), pb(3), wa, wb, ua, ub, n_a(3 ribbon normal), type, curve_id] = 16
SEG_COLS = 16


def bezier_eval(cp, u):
    """cp: (4, 3) control points; u: scalar or array -> points."""
    u = np.asarray(u)[..., None]
    b0 = (1 - u) ** 3
    b1 = 3 * u * (1 - u) ** 2
    b2 = 3 * u ** 2 * (1 - u)
    b3 = u ** 3
    return b0 * cp[0] + b1 * cp[1] + b2 * cp[2] + b3 * cp[3]


def split_curve(cp, width0, width1, depth, ctype=CURVE_FLAT, normal0=None,
                normal1=None, curve_id=0, u_min=0.0, u_max=1.0):
    """Host-side: split one cubic Bezier into 2^depth linear sub-segments.

    Returns (rows (S, SEG_COLS) float32, lo (S, 3), hi (S, 3)). The linear
    chord approximates the Bezier within its convex hull; bounds are padded
    by the max local half-width like the reference's curve bounds
    (shapes.cpp Curve::Bounds)."""
    cp = np.asarray(cp, np.float32).reshape(4, 3)
    n = 1 << int(depth)
    us = u_min + (u_max - u_min) * np.linspace(0.0, 1.0, n + 1)
    pts = bezier_eval(cp, us).astype(np.float32)          # (n+1, 3)
    ws = (width0 + (width1 - width0) * us).astype(np.float32)
    if normal0 is None:
        normal0 = (0.0, 0.0, 1.0)
    if normal1 is None:
        normal1 = normal0
    n0 = np.asarray(normal0, np.float32)
    n1 = np.asarray(normal1, np.float32)
    rows = np.zeros((n, SEG_COLS), np.float32)
    rows[:, 0:3] = pts[:-1]
    rows[:, 3:6] = pts[1:]
    rows[:, 6] = ws[:-1]
    rows[:, 7] = ws[1:]
    rows[:, 8] = us[:-1]
    rows[:, 9] = us[1:]
    # ribbon normal at segment midpoint (slerp is overkill; nlerp)
    um = 0.5 * (us[:-1] + us[1:])[:, None]
    nm = n0 * (1 - um) + n1 * um
    nm /= np.maximum(np.linalg.norm(nm, axis=-1, keepdims=True), 1e-9)
    rows[:, 10:13] = nm
    rows[:, 13] = float(ctype)
    rows[:, 14] = float(curve_id)
    pad = 0.5 * np.maximum(ws[:-1], ws[1:])[:, None]
    lo = np.minimum(pts[:-1], pts[1:]) - pad
    hi = np.maximum(pts[:-1], pts[1:]) + pad
    return rows, lo, hi


def _segment_test(o, d, t_max, rows):
    """Width-aware linear segment test in ray space (the reference's
    RecursiveIntersect base case, shapes.cpp:~1030-1130).

    o, d: (N, 3); rows: (N, SEG_COLS) gathered sub-segments.
    Returns dict(hit, t, u, v, n (N,3) geometric normal)."""
    # ray-aligned frame: z along d, x/y perpendicular
    dn = vm.normalize(d)
    t1, t2 = vm.coordinate_system(dn)
    pa = rows[..., 0:3] - o
    pb = rows[..., 3:6] - o
    ax = vm.dot(pa, t1)
    ay = vm.dot(pa, t2)
    az = vm.dot(pa, dn)
    bx = vm.dot(pb, t1)
    by = vm.dot(pb, t2)
    bz = vm.dot(pb, dn)
    ex = bx - ax
    ey = by - ay
    seg_len2 = jnp.maximum(ex * ex + ey * ey, 1e-16)
    # parametric closest approach of (0,0) to the 2D segment
    w = jnp.clip(-(ax * ex + ay * ey) / seg_len2, 0.0, 1.0)
    cx = ax + w * ex
    cy = ay + w * ey
    dist2 = cx * cx + cy * cy
    wa = rows[..., 6]
    wb = rows[..., 7]
    hit_width = wa + (wb - wa) * w
    # curve u at the hit (sub-segment range lerp)
    u = rows[..., 8] + (rows[..., 9] - rows[..., 8]) * w
    inside = dist2 <= 0.25 * hit_width * hit_width
    dlen = vm.length(d)
    ctype = f32_to_i32(rows[..., 13])
    # flat/ribbon: hit plane faces the ray -> t at the curve axis depth;
    # cylinder: pull the hit toward the viewer by the tube profile
    # (reference adjusts pHit by the cylinder cross-section)
    z_axis = az + w * (bz - az)
    edge = jnp.sqrt(jnp.maximum(0.25 * hit_width * hit_width - dist2, 0.0))
    z_hit = jnp.where(ctype == CURVE_CYLINDER, z_axis - edge, z_axis)
    t = z_hit / jnp.maximum(dlen, 1e-12)
    hit = inside & (t > 1e-4) & (t < t_max)
    # v across the width, signed by which side of the axis we pass
    side = jnp.sign(cx * ey - cy * ex)
    v = 0.5 + side * jnp.sqrt(dist2) / jnp.maximum(hit_width, 1e-9)
    # geometric normal: flat/cylinder face the ray (cylinder gets a
    # profile tilt downstream via shading); ribbon uses its fixed normal
    n_face = -dn
    axis = vm.normalize(rows[..., 3:6] - rows[..., 0:3])
    # cylinder: normal = normalize(offset from axis in the plane orthogonal
    # to the axis); approximate with the ray-space perpendicular offset
    perp = (cx[..., None] * t1 + cy[..., None] * t2) - \
        vm.dot(cx[..., None] * t1 + cy[..., None] * t2, axis)[..., None] * axis
    n_cyl_raw = perp - edge[..., None] * dn
    n_cyl = vm.normalize(jnp.where(
        (vm.length(n_cyl_raw) > 1e-9)[..., None], n_cyl_raw,
        jnp.broadcast_to(n_face, n_cyl_raw.shape)))
    n_rib = rows[..., 10:13]
    n = jnp.where((ctype == CURVE_CYLINDER)[..., None], n_cyl,
        jnp.where((ctype == CURVE_RIBBON)[..., None], n_rib,
                  jnp.broadcast_to(n_face, n_cyl.shape)))
    return dict(hit=hit, t=jnp.where(hit, t, jnp.inf), u=u, v=v, n=n)


def bvh_intersect_curves(nodes, seg_rows_ordered, o, d, t_max,
                         any_hit=False):
    """Stack traversal over the curve BVH; leaf test = _segment_test.

    nodes: packed BVH node rows; seg_rows_ordered: (S, SEG_COLS) in leaf
    order with column 15 = ORIGINAL sub-segment index... (column 14 holds
    curve_id for material/uv resolution).
    Returns dict(hit, t, u, v, n, curve_id)."""
    N = o.shape[0]
    inv_d = 1.0 / jnp.where(d == 0.0, 1e-20, d)
    dir_neg = (inv_d < 0.0)

    STACK_DEPTH = bvh_mod.STACK_DEPTH
    MAX_LEAF = bvh_mod.MAX_LEAF_PRIMS
    stack = jnp.zeros((N, STACK_DEPTH), jnp.int32)
    sp = jnp.zeros((N,), jnp.int32)
    current = jnp.zeros((N,), jnp.int32)
    active = jnp.ones((N,), bool)
    t_best = jnp.asarray(t_max, jnp.float32) + jnp.zeros((N,), jnp.float32)
    found = jnp.zeros((N,), bool)
    u_best = jnp.zeros((N,), jnp.float32)
    v_best = jnp.zeros((N,), jnp.float32)
    n_best = jnp.zeros((N, 3), jnp.float32)
    ax_best = jnp.zeros((N, 3), jnp.float32)
    id_best = jnp.full((N,), -1, jnp.int32)
    rows_i = jnp.arange(N)

    from .gather import pick3

    def cond(state):
        return jnp.any(state[0])

    def body(state):
        (active, current, sp, stack, t_best, found, u_best, v_best, n_best,
         ax_best, id_best) = state
        node_lo, node_hi, roff, nprim, axis = bvh_mod._unpack_node(
            nodes[current])
        box_hit, _ = vm.ray_bounds_intersect_p(o, inv_d, t_best, node_lo,
                                               node_hi)
        box_hit = box_hit & active
        is_leaf = nprim > 0
        leaf_hit = box_hit & is_leaf
        for k in range(MAX_LEAF):
            pk = jnp.clip(roff + k, 0, seg_rows_ordered.shape[0] - 1)
            seg = seg_rows_ordered[pk]
            do_test = leaf_hit & (k < nprim)
            r = _segment_test(o, d, t_best, seg)
            better = do_test & r["hit"] & (r["t"] < t_best)
            t_best = jnp.where(better, r["t"], t_best)
            found = found | better
            u_best = jnp.where(better, r["u"], u_best)
            v_best = jnp.where(better, r["v"], v_best)
            n_best = jnp.where(better[:, None], r["n"], n_best)
            ax_best = jnp.where(better[:, None],
                                vm.normalize(seg[:, 3:6] - seg[:, 0:3]),
                                ax_best)
            id_best = jnp.where(better, f32_to_i32(seg[:, 14]), id_best)
        if any_hit:
            active = active & ~found
        neg = pick3(dir_neg, axis)
        near = jnp.where(neg, roff, current + 1)
        far = jnp.where(neg, current + 1, roff)
        descend = box_hit & ~is_leaf & active
        stack = stack.at[rows_i, jnp.clip(sp, 0, STACK_DEPTH - 1)].set(
            jnp.where(descend, far,
                      stack[rows_i, jnp.clip(sp, 0, STACK_DEPTH - 1)]))
        sp = jnp.where(descend, sp + 1, sp)
        current = jnp.where(descend, near, current)
        pop = active & ~descend
        exhausted = pop & (sp <= 0)
        active = active & ~exhausted
        do_pop = pop & (sp > 0)
        sp = jnp.where(do_pop, sp - 1, sp)
        current = jnp.where(
            do_pop, stack[rows_i, jnp.clip(sp, 0, STACK_DEPTH - 1)], current)
        return (active, current, sp, stack, t_best, found, u_best, v_best,
                n_best, ax_best, id_best)

    state = (active, current, sp, stack, t_best, found, u_best, v_best,
             n_best, ax_best, id_best)
    state = jax.lax.while_loop(cond, body, state)
    (_, _, _, _, t_best, found, u_best, v_best, n_best, ax_best,
     id_best) = state
    return dict(hit=found, t=jnp.where(found, t_best, jnp.inf), u=u_best,
                v=v_best, n=n_best, axis=ax_best, curve_id=id_best)


