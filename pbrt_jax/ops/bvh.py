"""BVH: host SAH build -> flat node arrays -> batched device traversal.

Rebuilds the reference's BVHAggregate (cpu/aggregates.cpp:140-605) as
arrays: the binned-SAH build runs on host in numpy producing the same
depth-first flattened node layout as the reference's LinearBVHNode
(aggregates.cpp:128, flattenBVH:505); traversal is a batched
`lax.while_loop` where every ray advances one node per iteration with a
per-ray traversal stack held in device arrays — the reference's 64-deep
local stack with front-to-back child ordering by direction sign
(aggregates.cpp:529-579), vectorized over the whole ray batch.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from ..utils import struct

from ..utils import vecmath as vm
from . import intersect as isect
from .gather import f32_to_i32, pick3, pool_lookup

MAX_LEAF_PRIMS = 4
N_BUCKETS = 12
STACK_DEPTH = 40


@struct.dataclass
class BVH:
    """Flattened depth-first nodes, PACKED into one row matrix so traversal
    costs ONE gather per visited node.

    nodes columns: [lo.x, lo.y, lo.z, hi.x, hi.y, hi.z,
                    bits(right_child | prim_offset), bits(n_prims << 2 | axis)]
    """
    nodes: jnp.ndarray       # (M, 8) f32 (2 int columns bitcast)
    prim_indices: jnp.ndarray  # (P,) int32 permutation into original prims


def to_device(b: "BVH") -> "BVH":
    """Host (numpy) BVH -> device arrays. build_bvh returns NUMPY leaves so
    host consumers (TLAS packing) never pull device arrays back; convert
    once here when storing into the Scene pytree."""
    return BVH(nodes=jnp.asarray(b.nodes),
               prim_indices=jnp.asarray(b.prim_indices))


def build_bvh(prim_lo: np.ndarray, prim_hi: np.ndarray,
              max_leaf=MAX_LEAF_PRIMS) -> BVH:
    """Binned SAH build (reference aggregates.cpp:192-387, 12 buckets).

    Uses the native C++ builder (pbrt_jax/native) when available; the Python
    path below is the reference implementation + fallback."""
    n = len(prim_lo)
    assert n > 0
    try:
        from ..native import build_bvh_native
        res = build_bvh_native(np.asarray(prim_lo, np.float32),
                               np.asarray(prim_hi, np.float32), max_leaf)
    except Exception:
        res = None
    if res is not None:
        nodes, order = res
        return BVH(nodes=np.asarray(nodes, np.float32),
                   prim_indices=np.asarray(order, np.int32))
    prim_lo = np.asarray(prim_lo, np.float64)
    prim_hi = np.asarray(prim_hi, np.float64)
    centroids = 0.5 * (prim_lo + prim_hi)

    nodes = []  # dicts: lo, hi, axis, (leaf: offset, n) | (interior: left, right)
    ordered = np.empty(n, np.int64)
    ordered_count = [0]

    def leaf_node(idxs, lo, hi):
        off = ordered_count[0]
        ordered[off:off + len(idxs)] = idxs
        ordered_count[0] += len(idxs)
        nodes.append(dict(lo=lo, hi=hi, axis=0, leaf=True, offset=off, n=len(idxs)))
        return len(nodes) - 1

    def build(idxs):
        lo = prim_lo[idxs].min(axis=0)
        hi = prim_hi[idxs].max(axis=0)
        if len(idxs) <= 2:
            return leaf_node(idxs, lo, hi)
        c = centroids[idxs]
        c_lo, c_hi = c.min(axis=0), c.max(axis=0)
        dim = int(np.argmax(c_hi - c_lo))
        if c_hi[dim] == c_lo[dim]:
            if len(idxs) <= max_leaf:
                return leaf_node(idxs, lo, hi)
            mid = len(idxs) // 2
            node_i = len(nodes)
            nodes.append(dict(lo=lo, hi=hi, axis=dim, leaf=False, left=-1, right=-1))
            nodes[node_i]["left"] = build(idxs[:mid])
            nodes[node_i]["right"] = build(idxs[mid:])
            return node_i
        # binned SAH
        b = np.minimum((N_BUCKETS * (c[:, dim] - c_lo[dim]) /
                        (c_hi[dim] - c_lo[dim])).astype(np.int64), N_BUCKETS - 1)
        bucket_lo = np.full((N_BUCKETS, 3), np.inf)
        bucket_hi = np.full((N_BUCKETS, 3), -np.inf)
        counts = np.zeros(N_BUCKETS, np.int64)
        for k in range(N_BUCKETS):
            m = b == k
            counts[k] = m.sum()
            if counts[k]:
                bucket_lo[k] = prim_lo[idxs[m]].min(axis=0)
                bucket_hi[k] = prim_hi[idxs[m]].max(axis=0)
        # prefix/suffix areas
        def area(lo_, hi_):
            d = np.maximum(hi_ - lo_, 0)
            return 2 * (d[..., 0] * d[..., 1] + d[..., 0] * d[..., 2] + d[..., 1] * d[..., 2])
        cum_lo_f = np.minimum.accumulate(bucket_lo, axis=0)
        cum_hi_f = np.maximum.accumulate(bucket_hi, axis=0)
        cum_lo_b = np.minimum.accumulate(bucket_lo[::-1], axis=0)[::-1]
        cum_hi_b = np.maximum.accumulate(bucket_hi[::-1], axis=0)[::-1]
        cnt_f = np.cumsum(counts)
        cnt_b = np.cumsum(counts[::-1])[::-1]
        costs = np.full(N_BUCKETS - 1, np.inf)
        for k in range(N_BUCKETS - 1):
            if cnt_f[k] == 0 or cnt_b[k + 1] == 0:
                continue
            costs[k] = (cnt_f[k] * area(cum_lo_f[k], cum_hi_f[k]) +
                        cnt_b[k + 1] * area(cum_lo_b[k + 1], cum_hi_b[k + 1]))
        best = int(np.argmin(costs))
        leaf_cost = len(idxs)
        split_cost = 0.5 + costs[best] / max(area(lo, hi), 1e-12)
        if len(idxs) > max_leaf or split_cost < leaf_cost:
            if not np.isfinite(costs[best]):
                mid = len(idxs) // 2
                order = np.argsort(c[:, dim], kind="stable")
                left_idx, right_idx = idxs[order[:mid]], idxs[order[mid:]]
            else:
                m = b <= best
                left_idx, right_idx = idxs[m], idxs[~m]
            node_i = len(nodes)
            nodes.append(dict(lo=lo, hi=hi, axis=dim, leaf=False, left=-1, right=-1))
            nodes[node_i]["left"] = build(left_idx)
            nodes[node_i]["right"] = build(right_idx)
            return node_i
        return leaf_node(idxs, lo, hi)

    import sys
    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(10000, old_limit))
    try:
        build(np.arange(n))
    finally:
        sys.setrecursionlimit(old_limit)

    # flatten: depth-first, left child immediately follows parent
    m = len(nodes)
    lo = np.zeros((m, 3), np.float32)
    hi = np.zeros((m, 3), np.float32)
    right_or_offset = np.zeros(m, np.int32)
    n_prims = np.zeros(m, np.int32)
    axis = np.zeros(m, np.int32)
    flat_index = {}
    order = []

    def dfs(i):
        flat_index[i] = len(order)
        order.append(i)
        nd = nodes[i]
        if not nd["leaf"]:
            dfs(nd["left"])
            dfs(nd["right"])

    sys.setrecursionlimit(max(100000, old_limit))
    try:
        dfs(len_root := 0)
    finally:
        sys.setrecursionlimit(old_limit)

    for i, ni in enumerate(order):
        nd = nodes[ni]
        lo[i] = nd["lo"]
        hi[i] = nd["hi"]
        axis[i] = nd["axis"]
        if nd["leaf"]:
            right_or_offset[i] = nd["offset"]
            n_prims[i] = nd["n"]
        else:
            right_or_offset[i] = flat_index[nd["right"]]
            n_prims[i] = 0

    packed = np.concatenate([
        lo, hi,
        right_or_offset[:, None].astype(np.float32),      # value-encoded int
        ((n_prims << 2) | axis)[:, None].astype(np.float32)], axis=1)
    return BVH(nodes=np.asarray(packed, np.float32),
               prim_indices=ordered.astype(np.int32))


# ---------------------------------------------------------------------------
# Device traversal over a triangle pool

def pack_tri_geo(tri_p0, tri_p1, tri_p2, order=None):
    """Pack triangle vertices (+ original index) into one (T, 10) row matrix:
    [p0(3), p1(3), p2(3), bits(orig_index)]. If `order` is given, rows are
    permuted into that order (BVH leaf order) so leaf tests index directly."""
    p0 = np.asarray(tri_p0, np.float32)
    p1 = np.asarray(tri_p1, np.float32)
    p2 = np.asarray(tri_p2, np.float32)
    t = len(p0)
    orig = np.arange(t, dtype=np.int32)
    if order is not None:
        order = np.asarray(order)
        p0, p1, p2, orig = p0[order], p1[order], p2[order], orig[order]
    packed = np.concatenate([p0, p1, p2, orig[:, None].astype(np.float32)], axis=1)
    return packed


def _unpack_node(rows):
    """rows: (N, 8) packed node rows -> (lo, hi, roff, nprims, axis)."""
    lo = rows[:, 0:3]
    hi = rows[:, 3:6]
    roff = f32_to_i32(rows[:, 6])
    meta = f32_to_i32(rows[:, 7])
    return lo, hi, roff, meta >> 2, meta & 3


def bvh_intersect_triangles(bvh: BVH, tri_geo_ordered, o, d, t_max,
                            any_hit=False):
    """Closest-hit (or any-hit) traversal of rays against BVH'd triangles.

    tri_geo_ordered: (T, 10) packed triangles in BVH leaf order (from
    pack_tri_geo(..., order=bvh.prim_indices)); o, d: (N, 3); t_max: (N,).
    Returns dict(hit, t, prim (ORIGINAL triangle index), b0, b1, b2).

    Gather budget per loop iteration: 1 node row + MAX_LEAF_PRIMS triangle
    rows (leaf lanes only) + stack push/pop. Every lane steps once per loop
    iteration, so the wave runs until its deepest ray finishes; on NVIDIA
    GPUs ops/bvh_cuda.py runs the same algorithm one thread per ray.
    """
    bvh = to_device(bvh)  # no-op if already device arrays
    tri_geo_ordered = jnp.asarray(tri_geo_ordered)
    N = o.shape[0]
    inv_d = 1.0 / jnp.where(d == 0.0, 1e-20, d)
    dir_neg = (inv_d < 0.0)  # (N, 3)

    stack = jnp.zeros((N, STACK_DEPTH), jnp.int32)
    sp = jnp.zeros((N,), jnp.int32)          # stack size
    current = jnp.zeros((N,), jnp.int32)     # node being visited
    active = jnp.ones((N,), bool)
    t_best = jnp.asarray(t_max, jnp.float32) + jnp.zeros((N,), jnp.float32)
    prim_best = jnp.full((N,), -1, jnp.int32)
    b_best = jnp.zeros((N, 3), jnp.float32)
    rows = jnp.arange(N)

    from .gather import pick3

    def cond(state):
        return jnp.any(state[0])

    def body(state):
        active, current, sp, stack, t_best, prim_best, b_best = state
        node_lo, node_hi, roff, nprim, axis = _unpack_node(bvh.nodes[current])

        box_hit, _ = vm.ray_bounds_intersect_p(o, inv_d, t_best, node_lo, node_hi)
        box_hit = box_hit & active
        is_leaf = nprim > 0

        # --- leaf: test up to MAX_LEAF_PRIMS triangles ---
        leaf_hit = box_hit & is_leaf
        for k in range(MAX_LEAF_PRIMS):
            pk = jnp.clip(roff + k, 0, tri_geo_ordered.shape[0] - 1)
            geo = tri_geo_ordered[pk]  # one packed gather
            do_test = leaf_hit & (k < nprim)
            r = isect.ray_triangle(o, d, t_best, geo[:, 0:3], geo[:, 3:6],
                                   geo[:, 6:9])
            better = do_test & r["hit"] & (r["t"] < t_best)
            t_best = jnp.where(better, r["t"], t_best)
            tri = f32_to_i32(geo[:, 9])
            prim_best = jnp.where(better, tri, prim_best)
            b_best = jnp.where(better[:, None],
                               jnp.stack([r["b0"], r["b1"], r["b2"]], axis=-1), b_best)

        if any_hit:
            active = active & (prim_best < 0)

        # --- interior: descend near child, push far child ---
        neg = pick3(dir_neg, axis)
        near = jnp.where(neg, roff, current + 1)
        far = jnp.where(neg, current + 1, roff)
        descend = box_hit & ~is_leaf & active
        # push far child
        stack = stack.at[rows, jnp.clip(sp, 0, STACK_DEPTH - 1)].set(
            jnp.where(descend, far, stack[rows, jnp.clip(sp, 0, STACK_DEPTH - 1)]))
        sp = jnp.where(descend, sp + 1, sp)
        current = jnp.where(descend, near, current)

        # --- pop for lanes that didn't descend ---
        pop = active & ~descend
        exhausted = pop & (sp <= 0)
        active = active & ~exhausted
        do_pop = pop & (sp > 0)
        sp = jnp.where(do_pop, sp - 1, sp)
        current = jnp.where(do_pop, stack[rows, jnp.clip(sp, 0, STACK_DEPTH - 1)], current)
        return (active, current, sp, stack, t_best, prim_best, b_best)

    state = (active, current, sp, stack, t_best, prim_best, b_best)
    state = jax.lax.while_loop(cond, body, state)
    _, _, _, _, t_best, prim_best, b_best = state
    hit = prim_best >= 0
    return dict(hit=hit, t=jnp.where(hit, t_best, jnp.inf), prim=prim_best,
                b0=b_best[:, 0], b1=b_best[:, 1], b2=b_best[:, 2])


def brute_force_intersect_triangles(tri_p0, tri_p1, tri_p2, o, d, t_max,
                                    chunk=512):
    """All-pairs closest hit: rays (N,3) x triangles (T,3). Used for small
    scenes and as a traversal oracle in tests. Fully batched."""
    N = o.shape[0]
    T = tri_p0.shape[0]
    t_best = jnp.asarray(t_max, jnp.float32) + jnp.zeros((N,), jnp.float32)
    prim_best = jnp.full((N,), -1, jnp.int32)
    b_best = jnp.zeros((N, 3), jnp.float32)
    for s in range(0, T, chunk):
        e = min(s + chunk, T)
        r = isect.ray_triangle(o[:, None, :], d[:, None, :], t_best[:, None],
                               tri_p0[None, s:e], tri_p1[None, s:e], tri_p2[None, s:e])
        t = jnp.where(r["hit"], r["t"], jnp.inf)  # (N, chunk)
        tk = jnp.min(t, axis=1)
        # one-hot argmin extraction (no take_along_axis -> no gather);
        # first-minimum tie-break via min-iota
        oh = (t == tk[:, None]) & jnp.isfinite(t)
        iota = jnp.arange(e - s, dtype=jnp.int32)[None, :]
        kmin = jnp.min(jnp.where(oh, iota, e - s), axis=1)
        oh = (iota == kmin[:, None]).astype(jnp.float32)
        k = kmin.astype(jnp.float32)
        better = tk < t_best
        t_best = jnp.where(better, tk, t_best)
        prim_best = jnp.where(better, s + k.astype(jnp.int32), prim_best)
        bk = jnp.stack([jnp.sum(r["b0"] * oh, axis=1),
                        jnp.sum(r["b1"] * oh, axis=1),
                        jnp.sum(r["b2"] * oh, axis=1)], axis=-1)
        b_best = jnp.where(better[:, None], bk, b_best)
    hit = prim_best >= 0
    return dict(hit=hit, t=jnp.where(hit, t_best, jnp.inf), prim=prim_best,
                b0=b_best[:, 0], b1=b_best[:, 1], b2=b_best[:, 2])


def bvh_max_depth(nodes) -> int:
    """Host-side max tree depth of a flattened node array (depth-first
    layout: left child = i+1, right child = roff)."""
    import numpy as np
    arr = np.asarray(nodes)
    roff = arr[:, 6].astype(np.int64)
    nprim = (arr[:, 7].astype(np.int64).astype(np.int64)) >> 2
    n = len(arr)
    depth = np.zeros(n, np.int64)
    best = 0
    # iterative DFS matching the flattened layout
    stack = [(0, 1)]
    while stack:
        i, d = stack.pop()
        if i < 0 or i >= n:
            continue
        best = max(best, d)
        if nprim[i] == 0:  # interior
            stack.append((i + 1, d + 1))
            stack.append((int(round(arr[i, 6])), d + 1))
    return best
