"""SAH kd-tree aggregate.

Role model: the reference's ``KdTreeAggregate`` (cpu/aggregates.h:76,
aggregates.cpp:~700-1180): exact-SAH edge-sweep build with empty-space
bonus, depth-first node array, and a todo-stack traversal that advances
the (tMin, tMax) ray interval through split planes.

Shape: host numpy build -> flat (M, 4) f32 node rows; traversal is a
jnp while_loop with a per-lane interval stack, one node row gather per
iteration and a bounded leaf scan (the XLA alternative accelerator to the
BVH backends; selectable via ``Accelerator "kdtree"``).

Node row: [axis_or_leaf, split_or_offset, above_child_or_count, pad]
  axis_or_leaf: 0/1/2 = interior split axis; 3 = leaf
  interior: split position; above-child node index (below child = i+1)
  leaf: first index into prim_ids; primitive count
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from ..utils import struct

from ..utils import vecmath as vm
from . import intersect as isect
from .gather import f32_to_i32

MAX_LEAF_PRIMS = 16
STACK_DEPTH = 64

_ISECT_COST = 5.0
_TRAV_COST = 1.0
_EMPTY_BONUS = 0.5


@struct.dataclass
class KdTree:
    nodes: jnp.ndarray      # (M, 4) f32
    prim_ids: jnp.ndarray   # (P,) i32 indices into the ORIGINAL pool
    lo: jnp.ndarray         # (3,) world bounds
    hi: jnp.ndarray
    max_leaf: int = struct.field(pytree_node=False, default=MAX_LEAF_PRIMS)


def build_kdtree(prim_lo, prim_hi, isect_cost=_ISECT_COST,
                 traversal_cost=_TRAV_COST, empty_bonus=_EMPTY_BONUS,
                 max_prims=4, max_depth=None) -> KdTree:
    """Exact-SAH sweep build (aggregates.cpp KdTreeAggregate::buildTree)."""
    prim_lo = np.asarray(prim_lo, np.float64)
    prim_hi = np.asarray(prim_hi, np.float64)
    n = len(prim_lo)
    if max_depth is None:
        max_depth = int(round(8 + 1.3 * np.log2(max(n, 2))))
    world_lo = prim_lo.min(axis=0)
    world_hi = prim_hi.max(axis=0)

    nodes = []      # rows [axis, split/offset, above/count, 0]
    prim_ids = []

    def make_leaf(ids):
        nodes.append([3.0, float(len(prim_ids)), float(len(ids)), 0.0])
        prim_ids.extend(int(i) for i in ids)

    def build(ids, lo, hi, depth, bad_refines):
        if len(ids) <= max_prims or depth == 0:
            make_leaf(ids)
            return
        d_ext = hi - lo
        inv_total_sa = 1.0 / max(
            2 * (d_ext[0] * d_ext[1] + d_ext[1] * d_ext[2]
                 + d_ext[2] * d_ext[0]), 1e-30)
        old_cost = isect_cost * len(ids)
        best = None  # (cost, axis, split_pos)
        idv = np.asarray(ids)
        # vectorized edge sweep per axis (reference walks BoundEdges,
        # aggregates.cpp ~Kd build; here numpy cumsums do the counting):
        # try axes in order of extent, keep the first axis with a winner
        for axis in (int(a) for a in np.argsort(-d_ext)):
            los = prim_lo[idv, axis]
            his = prim_hi[idv, axis]
            pos_all = np.concatenate([los, his])
            is_start = np.concatenate([np.ones_like(los, bool),
                                       np.zeros_like(his, bool)])
            order = np.lexsort((~is_start, pos_all))  # starts first at ties
            pos_all = pos_all[order]
            is_start = is_start[order]
            is_end = ~is_start
            # counts at each candidate (cost evaluated AFTER closing ends,
            # BEFORE opening starts at this edge)
            n_above = len(ids) - np.cumsum(is_end)
            n_below = np.cumsum(is_start) - is_start
            o_axes = [a for a in range(3) if a != axis]
            d0, d1 = d_ext[o_axes[0]], d_ext[o_axes[1]]
            below_sa = 2 * (d0 * d1 + (pos_all - lo[axis]) * (d0 + d1))
            above_sa = 2 * (d0 * d1 + (hi[axis] - pos_all) * (d0 + d1))
            eb = np.where((n_above == 0) | (n_below == 0), empty_bonus, 0.0)
            cost = (traversal_cost + isect_cost * (1 - eb) * inv_total_sa
                    * (below_sa * n_below + above_sa * n_above))
            valid = (pos_all > lo[axis]) & (pos_all < hi[axis])
            if not valid.any():
                continue
            cost = np.where(valid, cost, np.inf)
            k = int(np.argmin(cost))
            if best is None or cost[k] < best[0]:
                best = (float(cost[k]), axis, float(pos_all[k]))
            if best is not None and best[1] == axis:
                break  # good split on the preferred axis
        give_up = best is None or (best[0] > old_cost and
                                   (best[0] > 4 * old_cost
                                    or bad_refines >= 3))
        if give_up:
            if len(ids) > MAX_LEAF_PRIMS:
                # leaf would overflow the preferred scan bound: median-plane
                # split on the widest axis (plane assignment keeps
                # straddling prims on both sides)
                axis = int(np.argmax(d_ext))
                cent = 0.5 * (prim_lo[idv, axis] + prim_hi[idv, axis])
                pos = float(np.median(cent))
                below_ids = idv[prim_lo[idv, axis] < pos]
                above_ids = idv[prim_hi[idv, axis] > pos]
                if 0 < len(below_ids) < len(ids) and \
                        0 < len(above_ids) < len(ids):
                    me = len(nodes)
                    nodes.append([float(axis), pos, 0.0, 0.0])
                    lo_b, hi_b = lo.copy(), hi.copy()
                    hi_b[axis] = pos
                    build(below_ids, lo_b, hi_b, depth - 1, bad_refines)
                    nodes[me][2] = float(len(nodes))
                    lo_a, hi_a = lo.copy(), hi.copy()
                    lo_a[axis] = pos
                    build(above_ids, lo_a, hi_a, depth - 1, bad_refines)
                    return
            make_leaf(ids)
            return
        if best[0] > old_cost:
            bad_refines += 1
        _c, axis, pos = best
        below_ids = idv[prim_lo[idv, axis] < pos]
        above_ids = idv[prim_hi[idv, axis] > pos]
        # empty children are FINE (that's the empty-space bonus working);
        # only a split that duplicates the whole set on both sides makes no
        # progress
        if len(below_ids) == len(ids) and len(above_ids) == len(ids):
            make_leaf(ids)
            return
        me = len(nodes)
        nodes.append([float(axis), float(pos), 0.0, 0.0])  # patched below
        lo_b, hi_b = lo.copy(), hi.copy()
        hi_b[axis] = pos
        build(below_ids, lo_b, hi_b, depth - 1, bad_refines)
        nodes[me][2] = float(len(nodes))
        lo_a, hi_a = lo.copy(), hi.copy()
        lo_a[axis] = pos
        build(above_ids, lo_a, hi_a, depth - 1, bad_refines)

    import sys
    old_lim = sys.getrecursionlimit()
    sys.setrecursionlimit(20000)
    try:
        build(list(range(n)), world_lo.copy(), world_hi.copy(), max_depth, 0)
    finally:
        sys.setrecursionlimit(old_lim)
    arr = np.asarray(nodes, np.float32)
    leaf_rows = arr[:, 0] == 3.0
    max_leaf = int(arr[leaf_rows, 2].max()) if leaf_rows.any() else 1
    return KdTree(nodes=jnp.asarray(arr),
                  prim_ids=jnp.asarray(np.asarray(prim_ids, np.int32)),
                  lo=jnp.asarray(world_lo, jnp.float32),
                  hi=jnp.asarray(world_hi, jnp.float32),
                  max_leaf=max(max_leaf, 1))


def kdtree_intersect_triangles(kd: KdTree, tri_geo, o, d, t_max,
                               any_hit=False):
    """Closest-hit traversal (aggregates.cpp KdTreeAggregate::Intersect):
    interval descent with a (node, tMin, tMax) todo stack.

    tri_geo: (T, 10) packed triangles in ORIGINAL order (prim_ids index it).
    Returns dict(hit, t, prim, b0, b1, b2) like the BVH backends."""
    N = o.shape[0]
    inv_d = 1.0 / jnp.where(d == 0.0, 1e-20, d)
    # clip ray to the world bounds
    t0w = (kd.lo - o) * inv_d
    t1w = (kd.hi - o) * inv_d
    t_near = jnp.max(jnp.minimum(t0w, t1w), axis=-1)
    t_far0 = jnp.min(jnp.maximum(t0w, t1w), axis=-1)
    tb = jnp.asarray(t_max, jnp.float32) + jnp.zeros((N,), jnp.float32)
    t_lo = jnp.maximum(t_near, 0.0)
    t_hi0 = jnp.minimum(t_far0, tb)

    rows = jnp.arange(N)
    stack_node = jnp.zeros((N, STACK_DEPTH), jnp.int32)
    stack_tlo = jnp.zeros((N, STACK_DEPTH), jnp.float32)
    stack_thi = jnp.zeros((N, STACK_DEPTH), jnp.float32)
    sp = jnp.zeros((N,), jnp.int32)
    current = jnp.zeros((N,), jnp.int32)
    active = (t_lo <= t_hi0)
    t_best = tb
    prim_best = jnp.full((N,), -1, jnp.int32)
    b_best = jnp.zeros((N, 3), jnp.float32)

    def cond(st):
        return jnp.any(st[0])

    def body(st):
        (active, current, sp, stack_node, stack_tlo, stack_thi, t_lo, t_hi,
         t_best, prim_best, b_best) = st
        row = kd.nodes[current]                       # one gather
        axis = f32_to_i32(row[:, 0])
        is_leaf = axis == 3
        # prune: interval start beyond best hit
        dead_iv = t_lo > jnp.minimum(t_best, t_hi)

        # --- leaf: bounded prim scan ---
        offset = f32_to_i32(row[:, 1])
        count = f32_to_i32(row[:, 2])
        leaf_go = active & is_leaf & ~dead_iv
        for k in range(kd.max_leaf):
            pk = jnp.clip(offset + k, 0, kd.prim_ids.shape[0] - 1)
            tri = kd.prim_ids[pk]
            geo = tri_geo[jnp.clip(tri, 0, tri_geo.shape[0] - 1)]
            do = leaf_go & (k < count)
            r = isect.ray_triangle(o, d, t_best, geo[:, 0:3], geo[:, 3:6],
                                   geo[:, 6:9])
            better = do & r["hit"] & (r["t"] < t_best)
            t_best = jnp.where(better, r["t"], t_best)
            prim_best = jnp.where(better, f32_to_i32(geo[:, 9]), prim_best)
            b_best = jnp.where(better[:, None],
                               jnp.stack([r["b0"], r["b1"], r["b2"]], -1),
                               b_best)
        if any_hit:
            active = active & (prim_best < 0)

        # --- interior: split-plane interval logic ---
        split = row[:, 1]
        above = f32_to_i32(row[:, 2])
        ax_o = jnp.take_along_axis(o, jnp.clip(axis, 0, 2)[:, None],
                                   1)[:, 0]
        ax_inv = jnp.take_along_axis(inv_d, jnp.clip(axis, 0, 2)[:, None],
                                     1)[:, 0]
        t_plane = (split - ax_o) * ax_inv
        below_first = (ax_o < split) | ((ax_o == split) & (ax_inv <= 0))
        first = jnp.where(below_first, current + 1, above)
        second = jnp.where(below_first, above, current + 1)
        # which children does the interval reach?
        only_first = (t_plane > t_hi) | (t_plane <= 0)
        # else-if in the reference: the first-only test has priority
        # (t_plane <= 0 satisfies both conditions)
        only_second = (t_plane < t_lo) & ~only_first
        interior_go = active & ~is_leaf & ~dead_iv
        both = interior_go & ~only_first & ~only_second

        # push second child with [t_plane, t_hi]
        spc = jnp.clip(sp, 0, STACK_DEPTH - 1)
        stack_node = stack_node.at[rows, spc].set(
            jnp.where(both, second, stack_node[rows, spc]))
        stack_tlo = stack_tlo.at[rows, spc].set(
            jnp.where(both, t_plane, stack_tlo[rows, spc]))
        stack_thi = stack_thi.at[rows, spc].set(
            jnp.where(both, t_hi, stack_thi[rows, spc]))
        sp = jnp.where(both, sp + 1, sp)

        nxt = jnp.where(only_second, second, first)
        descend = interior_go
        current = jnp.where(descend, nxt, current)
        t_hi = jnp.where(both, jnp.minimum(t_plane, t_hi), t_hi)

        # --- pop for leaf / dead-interval lanes ---
        pop = active & (is_leaf | dead_iv)
        exhausted = pop & (sp <= 0)
        active = active & ~exhausted
        do_pop = pop & (sp > 0)
        sp = jnp.where(do_pop, sp - 1, sp)
        spc = jnp.clip(sp, 0, STACK_DEPTH - 1)
        current = jnp.where(do_pop, stack_node[rows, spc], current)
        t_lo = jnp.where(do_pop, stack_tlo[rows, spc], t_lo)
        t_hi = jnp.where(do_pop, stack_thi[rows, spc], t_hi)
        # early out: a hit before the popped interval ends the lane
        done = active & (t_best < t_lo) & ~do_pop
        return (active, current, sp, stack_node, stack_tlo, stack_thi,
                t_lo, t_hi, t_best, prim_best, b_best)

    st = (active, current, sp, stack_node, stack_tlo, stack_thi, t_lo,
          t_hi0, t_best, prim_best, b_best)
    st = jax.lax.while_loop(cond, body, st)
    t_best, prim_best, b_best = st[8], st[9], st[10]
    hit = prim_best >= 0
    return dict(hit=hit, t=jnp.where(hit, t_best, jnp.inf), prim=prim_best,
                b0=b_best[:, 0], b1=b_best[:, 1], b2=b_best[:, 2])
