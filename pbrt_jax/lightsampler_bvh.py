"""Many-light BVH sampler (reference lightsamplers.h:260 BVHLightSampler,
Conty & Kulla 2018).

Host: SAOH-ish binary BVH over LightBounds (bounds + orientation cone +
power). Device: stochastic top-down traversal — at each level ONE packed
gather fetches a node row carrying BOTH children's summaries; the child is
picked with probability proportional to its importance from the shading
point, and the running pmf is the product of choices. PMF queries for MIS
walk the same tree guided by a per-light bit trail (reference
lightToBitTrail), so sample and pmf agree exactly.

Infinite/distant lights live outside the tree and are selected first with
probability n_inf / (n_inf + 1) (reference BVHLightSampler::Sample).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from .utils import struct

from .utils import vecmath as vm
from .utils.math import safe_div
from .ops.gather import f32_to_i32

# node row: child0: [lo(3) hi(3) w(3) cos_o cos_e phi idx_or_light leaf] = 14
# child1: same = 14 -> 28 columns
_C = 14


@struct.dataclass
class BVHLightSampler:
    nodes: jnp.ndarray       # (M, 28) packed two-child rows
    bit_trail: jnp.ndarray   # (L,) int32 path bits for pmf queries
    trail_len: jnp.ndarray   # (L,) int32 tree depth of each light
    outside: jnp.ndarray     # (L,) bool: light outside the tree (infinite)
    pmf_outside: jnp.ndarray  # (L,) pmf for outside lights
    n_lights: int = struct.field(pytree_node=False, default=0)
    max_depth: int = struct.field(pytree_node=False, default=0)
    p_outside: float = struct.field(pytree_node=False, default=0.0)
    kind: int = struct.field(pytree_node=False, default=2)  # LS_BVH


def build_bvh_light_sampler(bounds_lo, bounds_hi, axis_w, cos_theta_o,
                            cos_theta_e, power, is_infinite) -> BVHLightSampler:
    """All args: (L,) or (L,3) numpy arrays describing each light's
    LightBounds (reference lights.h:104)."""
    L = len(power)
    power = np.asarray(power, np.float64)
    is_infinite = np.asarray(is_infinite, bool)
    tree_ids = np.nonzero(~is_infinite & (power > 0))[0]
    out_ids = np.nonzero(is_infinite & (power > 0))[0]
    n_out = len(out_ids)
    p_outside = n_out / (n_out + (1 if len(tree_ids) else 0)) if (n_out or len(tree_ids)) else 0.0
    pmf_out = np.zeros(L, np.float64)
    if n_out:
        pmf_out[out_ids] = p_outside / n_out

    nodes = []
    bit_trail = np.zeros(L, np.int64)
    trail_len = np.zeros(L, np.int64)

    def light_cols(i):
        return np.concatenate([
            bounds_lo[i], bounds_hi[i], axis_w[i],
            [cos_theta_o[i], cos_theta_e[i], power[i], float(i), 1.0]])

    def subtree_cols(ids, child_index):
        lo = bounds_lo[ids].min(0)
        hi = bounds_hi[ids].max(0)
        # conservative cone: average axis, widest angle (simplified vs the
        # reference's DirectionCone::Union)
        w = axis_w[ids].mean(0)
        n = np.linalg.norm(w)
        w = w / n if n > 1e-9 else np.array([0, 0, 1.0])
        co = float(np.min(cos_theta_o[ids])) if n > 1e-9 else -1.0
        ce = float(np.max(cos_theta_e[ids]))
        return np.concatenate([lo, hi, w, [min(co, 0.0) if len(ids) > 8 else co,
                                           ce, power[ids].sum(),
                                           float(child_index), 0.0]])

    max_depth = 0
    if len(tree_ids) > 1:
        import sys
        old = sys.getrecursionlimit()
        sys.setrecursionlimit(10000)
        try:
            # post-order emit: a child's node row exists before its parent
            # references it, so interior-child index columns are final
            def build(ids, depth, trail):
                if len(ids) == 1:
                    i = ids[0]
                    bit_trail[i] = trail
                    trail_len[i] = depth
                    return light_cols(i)
                c = 0.5 * (bounds_lo[ids] + bounds_hi[ids])
                dim = int(np.argmax(c.max(0) - c.min(0)))
                order = np.argsort(c[:, dim], kind="stable")
                mid = len(ids) // 2
                lid, rid = ids[order[:mid]], ids[order[mid:]]
                col_l = build(lid, depth + 1, trail)
                col_r = build(rid, depth + 1, trail | (1 << depth))
                idx = len(nodes)
                nodes.append(np.concatenate([col_l, col_r]))
                return subtree_cols(ids, idx)

            build(tree_ids, 0, 0)
        finally:
            sys.setrecursionlimit(old)
        max_depth = int(trail_len[tree_ids].max())
    elif len(tree_ids) == 1:
        i = tree_ids[0]
        nodes.append(np.concatenate([light_cols(i), light_cols(i)]))
        bit_trail[i] = 0
        trail_len[i] = 1
        max_depth = 1

    node_arr = (np.stack(nodes) if nodes else np.zeros((1, 2 * _C))).astype(np.float32)
    root = len(nodes) - 1 if nodes else 0
    # reorder so the root is row 0 (traversal starts at 0)
    if len(nodes) > 1:
        perm = np.arange(len(nodes))
        perm[[0, root]] = perm[[root, 0]]
        remap = np.empty(len(nodes), np.int64)
        remap[perm] = np.arange(len(nodes))
        node_arr = node_arr[perm]
        # fix child node-index columns for interior children
        for col, leaf_flag_col in ((12, 13), (_C + 12, _C + 13)):
            interior = node_arr[:, leaf_flag_col] < 0.5
            node_arr[interior, col] = remap[
                node_arr[interior, col].astype(np.int64)].astype(np.float32)

    return BVHLightSampler(
        nodes=jnp.asarray(node_arr),
        bit_trail=jnp.asarray(bit_trail.astype(np.int32)),
        trail_len=jnp.asarray(trail_len.astype(np.int32)),
        outside=jnp.asarray(is_infinite),
        pmf_outside=jnp.asarray(pmf_out.astype(np.float32)),
        n_lights=L, max_depth=max_depth, p_outside=float(p_outside))


def _child_importance(cols, p, n_ref):
    """Conty-Kulla importance of a child summary for shading point p
    (reference CompactLightBounds::Importance, lightsamplers.h:102)."""
    lo = cols[..., 0:3]
    hi = cols[..., 3:6]
    w = cols[..., 6:9]
    cos_o = cols[..., 9]
    cos_e = cols[..., 10]
    phi = cols[..., 11]
    center = 0.5 * (lo + hi)
    d = center - p
    dist2 = jnp.maximum(vm.length_squared(d), 1e-12)
    half_diag2 = 0.25 * vm.length_squared(hi - lo)
    dist2 = jnp.maximum(dist2, half_diag2)
    wi = d / jnp.sqrt(dist2)[..., None]
    # angle between cone axis and direction to shading point
    cos_theta_w = vm.dot(w, -wi)
    # subtended half-angle of the bounds
    sin2_u = jnp.clip(half_diag2 / dist2, 0.0, 1.0)
    cos_u = jnp.sqrt(1.0 - sin2_u)
    # theta' = max(0, theta_w - theta_o - theta_u) via cos subtraction bounds
    theta_w = jnp.arccos(jnp.clip(cos_theta_w, -1, 1))
    theta_o = jnp.arccos(jnp.clip(cos_o, -1, 1))
    theta_u = jnp.arccos(jnp.clip(cos_u, -1, 1))
    theta_p = jnp.maximum(theta_w - theta_o - theta_u, 0.0)
    cos_theta_p = jnp.cos(theta_p)
    theta_e = jnp.arccos(jnp.clip(cos_e, -1, 1))
    visible = theta_p < theta_e
    imp = phi * jnp.maximum(cos_theta_p, 0.0) / dist2
    # incident-cosine bound at the receiver (optional improvement)
    if n_ref is not None:
        cos_r = jnp.abs(vm.dot(n_ref, wi))
        theta_r = jnp.arccos(jnp.clip(cos_r, -1, 1))
        cos_bound = jnp.cos(jnp.maximum(theta_r - theta_u, 0.0))
        imp = imp * jnp.maximum(cos_bound, 0.05)
    return jnp.where(visible & (phi > 0), jnp.maximum(imp, 0.0), 0.0)


def sample_bvh_light(ls: BVHLightSampler, p, n_ref, u):
    """Returns (light_idx (N,), pmf (N,), u_remapped (N,))."""
    N = u.shape[0]
    # outside (infinite) branch
    use_out = u < ls.p_outside
    n_out_total = jnp.maximum(jnp.sum(ls.pmf_outside > 0), 1)
    u_out = jnp.clip(u / jnp.maximum(ls.p_outside, 1e-9), 0, 1 - 1e-7)
    # pick uniformly among outside lights: index by rank (host precompute easier:
    # pmf_outside>0 rows are few; use cumulative trick via searchsorted on device)
    out_rows = jnp.cumsum((ls.pmf_outside > 0).astype(jnp.int32)) - 1
    target = (u_out * n_out_total.astype(jnp.float32)).astype(jnp.int32)
    # light whose rank == target
    idx_out = jnp.searchsorted(out_rows, target, side="left").astype(jnp.int32)
    pmf_out = ls.p_outside / n_out_total.astype(jnp.float32)

    u_tree = jnp.clip((u - ls.p_outside) / jnp.maximum(1 - ls.p_outside, 1e-9),
                      0, 1 - 1e-7)
    cur = jnp.zeros((N,), jnp.int32)
    pmf = jnp.full((N,), 1.0 - ls.p_outside, jnp.float32)
    light = jnp.zeros((N,), jnp.int32)
    done = jnp.zeros((N,), bool)
    uu = u_tree

    def body(_, state):
        cur, pmf, light, done, uu = state
        rows = ls.nodes[cur]  # ONE gather (N, 28)
        imp0 = _child_importance(rows[..., :_C], p, n_ref)
        imp1 = _child_importance(rows[..., _C:], p, n_ref)
        tot = imp0 + imp1
        p0 = jnp.where(tot > 0, imp0 / jnp.maximum(tot, 1e-12), 0.5)
        go0 = uu < p0
        pc = jnp.where(go0, p0, 1 - p0)
        uu_new = jnp.clip(jnp.where(go0, uu / jnp.maximum(p0, 1e-9),
                                    (uu - p0) / jnp.maximum(1 - p0, 1e-9)),
                          0, 1 - 1e-7)
        child = jnp.where(go0[:, None], rows[..., :_C], rows[..., _C:])
        is_leaf = child[..., 13] > 0.5
        idx = f32_to_i32(child[..., 12])
        new_pmf = pmf * jnp.where(done, 1.0, pc)
        pmf = jnp.where(done, pmf, new_pmf)
        light = jnp.where(~done & is_leaf, idx, light)
        cur = jnp.where(~done & ~is_leaf, idx, cur)
        uu = jnp.where(done, uu, uu_new)
        # NOTE: zero-importance subtrees still descend 50/50 so the walk stays
        # structurally identical to pmf_bvh_light (a pick with zero importance
        # contributes 0 radiance anyway — NEE masks it by L == 0)
        done = done | is_leaf
        return (cur, pmf, light, done, uu)

    if ls.max_depth > 0:
        state = jax.lax.fori_loop(0, ls.max_depth + 1, body,
                                  (cur, pmf, light, done, uu))
        cur, pmf, light, done, uu = state
    li = jnp.where(use_out, idx_out, light)
    pm = jnp.where(use_out, pmf_out, pmf)
    ur = jnp.where(use_out, u_out * 0 + 0.5, uu)
    return li, pm, ur


def pmf_bvh_light(ls: BVHLightSampler, p, n_ref, light_idx):
    """PMF that sample_bvh_light picks light_idx from p (for MIS)."""
    li = jnp.clip(light_idx, 0, ls.n_lights - 1)
    outside = ls.outside[li]
    pmf_out = ls.pmf_outside[li]
    trail = ls.bit_trail[li]
    tlen = ls.trail_len[li]
    N = light_idx.shape[0]
    cur = jnp.zeros((N,), jnp.int32)
    pmf = jnp.full((N,), 1.0 - ls.p_outside, jnp.float32)

    def body(d, state):
        cur, pmf = state
        rows = ls.nodes[cur]
        imp0 = _child_importance(rows[..., :_C], p, n_ref)
        imp1 = _child_importance(rows[..., _C:], p, n_ref)
        tot = imp0 + imp1
        go0 = ((trail >> d) & 1) == 0
        p0 = jnp.where(tot > 0, imp0 / jnp.maximum(tot, 1e-12), 0.5)
        pc = jnp.where(go0, p0, 1 - p0)
        active = d < tlen
        pmf = pmf * jnp.where(active, pc, 1.0)
        child = jnp.where(go0[:, None], rows[..., :_C], rows[..., _C:])
        nxt = f32_to_i32(child[..., 12])
        is_leaf = child[..., 13] > 0.5
        cur = jnp.where(active & ~is_leaf, nxt, cur)
        return (cur, pmf)

    if ls.max_depth > 0:
        cur, pmf = jax.lax.fori_loop(0, ls.max_depth, body, (cur, pmf))
    return jnp.where(outside, pmf_out, pmf)