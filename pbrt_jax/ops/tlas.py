"""Two-level BVH traversal for object instancing (reference
cpu/primitive.h:83 TransformedPrimitive + scene.cpp object instances).

Memory is O(prototype): each ObjectBegin/End block compiles ONCE into a
BLAS (bottom-level BVH over its triangles); instances are 12-float
world-to-object transforms in a table, and a TLAS (top-level BVH) is built
over instance world bounds. The static (non-instanced) scene geometry is
itself instance 0 with the identity transform, so one traversal serves
both.

Traversal is a single masked while-loop state machine (the standard GPU
two-level scheme, expressed with lane masks instead of threads):
- All BVH node arrays are concatenated; child/prim offsets are rebased at
  concat time, so a node index is global.
- The per-lane stack holds node indices >= 0, or coded entries:
  ENTER(-2 - inst_idx) switches the lane into that instance's BLAS
  (transform the ray by w2o, jump to the BLAS root, push RETURN), and
  RETURN(-1) restores the world-space ray.
- t is parameterized on the WORLD ray; object-space rays use the
  un-normalized transformed direction, which preserves t across spaces
  (affine invariance — same trick as the quadric pipeline).

Instance table rows (I, 40): [w2o0 3x4 row-major (12), o2w0 3x4 (12),
bits(proto_root), bits(inst_id), has_motion, pad, o2w1 3x4 (12)] — o2w
transforms object-space tangents/normals of the hit back to world.
Animated instances (reference AnimatedTransform transform.h:444 +
AnimatedPrimitive cpu/primitive.h:103) carry a second end-of-shutter
transform. Round 4: rays interpolate via the reference's TRS
decomposition — translation lerp, rotation quaternion SLERP, stretch
lerp (transform.cpp Decompose: polar iteration M -> R, S = R^-1 M) —
so large rotations stay rigid instead of shrinking through the linear
matrix blend. Decomposed components ride in row cols 40:66.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..utils import vecmath as vm
from .gather import f32_to_i32, pick3
from . import bvh as bvh_mod
from . import intersect as isect

INST_COLS = 66   # 40 base + [q0(4), q1(4), S0(9), S1(9)] TRS payload
RETURN_TOKEN = -1


def _decompose_trs(A):
    """(3, 4) affine -> (q (4,), S (3, 3)): polar decomposition of the
    3x3 part (reference Transform Decompose, transform.cpp — iterate
    R <- (R + R^-T)/2), quaternion from R, stretch S = R^-1 M."""
    M = np.asarray(A, np.float64)[:, :3]
    R = M.copy()
    for _ in range(100):
        Rn = 0.5 * (R + np.linalg.inv(R.T))
        if np.abs(Rn - R).sum() < 1e-12:
            R = Rn
            break
        R = Rn
    S = np.linalg.inv(R) @ M
    # rotation matrix -> quaternion (w, x, y, z)
    tr = R[0, 0] + R[1, 1] + R[2, 2]
    if tr > 0:
        w = np.sqrt(1.0 + tr) / 2.0
        s4 = 4.0 * w
        q = np.asarray([w, (R[2, 1] - R[1, 2]) / s4,
                        (R[0, 2] - R[2, 0]) / s4,
                        (R[1, 0] - R[0, 1]) / s4])
    else:
        i = int(np.argmax([R[0, 0], R[1, 1], R[2, 2]]))
        j, k = (i + 1) % 3, (i + 2) % 3
        s4 = 2.0 * np.sqrt(max(1.0 + R[i, i] - R[j, j] - R[k, k], 1e-12))
        q = np.zeros(4)
        q[1 + i] = s4 / 4.0
        q[0] = (R[k, j] - R[j, k]) / s4
        q[1 + j] = (R[j, i] + R[i, j]) / s4
        q[1 + k] = (R[k, i] + R[i, k]) / s4
    q = q / np.linalg.norm(q)
    return q.astype(np.float32), S.astype(np.float32)


def build_two_level(blas_list, instances):
    """Host-side: concatenate BLASes + build the TLAS.

    blas_list: list of (nodes (Nn, 8) np, prim_indices (T,) np, tri_lo,
    tri_hi) per prototype — nodes from ops/bvh.build_bvh over the
    prototype's triangles, with prim offsets into ITS ordered array.
    instances: list of dicts(proto, w2o (3,4) np, o2w (3,4) np).

    Returns (nodes_all (M, 8) f32, inst_rows (I, INST_COLS) f32,
    prim_base (P,) int: per-proto offset into the concatenated ordered
    triangle pool, tlas_root: int index of the TLAS root in nodes_all)."""
    # 1. concat BLAS nodes with rebasing
    node_arrays = []
    node_base = []
    prim_base = []
    nb = 0
    pb = 0
    for (nodes, order, _, _) in blas_list:
        nodes = np.array(nodes, np.float32)
        # our packing stores roff in col 6 and meta in col 7 as f32-coded ints
        roff = _f2i(nodes[:, 6])
        nprim = _f2i(nodes[:, 7]) >> 2
        is_leaf = nprim > 0
        roff = np.where(is_leaf, roff + pb, roff + nb)
        nodes[:, 6] = _i2f(roff)
        node_base.append(nb)
        prim_base.append(pb)
        node_arrays.append(nodes)
        nb += nodes.shape[0]
        pb += len(order)
    # 2. instance rows + world bounds
    inst_rows = np.zeros((len(instances), INST_COLS), np.float32)
    ilo = np.zeros((len(instances), 3), np.float32)
    ihi = np.zeros((len(instances), 3), np.float32)
    for i, inst in enumerate(instances):
        proto = inst["proto"]
        w2o = np.asarray(inst["w2o"], np.float32).reshape(3, 4)
        o2w = np.asarray(inst["o2w"], np.float32).reshape(3, 4)
        inst_rows[i, 0:12] = w2o.reshape(-1)
        inst_rows[i, 12:24] = o2w.reshape(-1)
        inst_rows[i, 24] = float(node_base[proto])
        inst_rows[i, 25] = float(i)
        o2w1 = inst.get("o2w_end")
        inst_rows[i, 26] = 0.0 if o2w1 is None else 1.0
        inst_rows[i, 28:40] = (o2w if o2w1 is None else
                               np.asarray(o2w1, np.float32)).reshape(-1)
        if o2w1 is not None:
            q0, S0 = _decompose_trs(o2w)
            q1, S1 = _decompose_trs(np.asarray(o2w1,
                                               np.float32).reshape(3, 4))
            if np.dot(q0, q1) < 0:   # shortest arc
                q1 = -q1
            inst_rows[i, 40:44] = q0
            inst_rows[i, 44:48] = q1
            inst_rows[i, 48:57] = S0.reshape(-1)
            inst_rows[i, 57:66] = S1.reshape(-1)
        # world bounds: transform the proto bbox corners
        _, _, lo, hi = blas_list[proto]
        plo, phi = lo.min(axis=0), hi.max(axis=0)
        corners = np.stack(np.meshgrid(*zip(plo, phi), indexing="ij"),
                           -1).reshape(-1, 3)
        wc = corners @ o2w[:, :3].T + o2w[:, 3]
        if o2w1 is not None:
            o2w1m = np.asarray(o2w1, np.float32).reshape(3, 4)
            wc = np.concatenate([wc, corners @ o2w1m[:, :3].T + o2w1m[:, 3]])
        ilo[i] = wc.min(axis=0)
        ihi[i] = wc.max(axis=0)
    # 3. TLAS over instance bounds, appended after all BLAS nodes
    tlas = bvh_mod.build_bvh(ilo, ihi)
    tnodes = np.array(tlas.nodes, np.float32)
    troff = _f2i(tnodes[:, 6])
    tnprim = _f2i(tnodes[:, 7]) >> 2
    tleaf = tnprim > 0
    # TLAS leaf roff indexes the TLAS-ordered instance list: bake the
    # reordering into the instance rows, and re-id them so the recorded
    # inst id indexes the REORDERED table (what the scene gathers from)
    inst_rows = inst_rows[np.asarray(tlas.prim_indices)]
    inst_rows[:, 25] = np.arange(inst_rows.shape[0], dtype=np.float32)
    troff = np.where(tleaf, troff, troff + nb)
    tnodes[:, 6] = _i2f(troff)
    nodes_all = np.concatenate(node_arrays + [tnodes])
    tlas_root = nb
    return (jnp.asarray(nodes_all), jnp.asarray(inst_rows),
            np.asarray(prim_base), tlas_root)


def _f2i(f):
    """Node/instance int columns are VALUE-encoded floats (matches
    ops/gather.f32_to_i32's rounding decode)."""
    return np.round(np.asarray(f, np.float64)).astype(np.int64)


def _i2f(i):
    return np.asarray(i, np.float64).astype(np.float32)


def lerp_inst_o2w(irow, time):
    """Per-lane o2w(t): TRS interpolation (reference AnimatedTransform::
    Interpolate, transform.h:444) — translation lerp + rotation SLERP +
    stretch lerp, recomposed as [R(q(t)) @ S(t) | T(t)]."""
    A0 = irow[..., 12:24].reshape(irow.shape[:-1] + (3, 4))
    A1 = irow[..., 28:40].reshape(irow.shape[:-1] + (3, 4))
    has_m = irow[..., 26:27, None] > 0.5
    t = time[..., None]
    T = A0[..., 3] * (1.0 - t) + A1[..., 3] * t
    q0 = irow[..., 40:44]
    q1 = irow[..., 44:48]
    # slerp with lerp fallback at small angle (q0.q1 already >= 0)
    cos_t = jnp.clip(jnp.sum(q0 * q1, -1, keepdims=True), -1.0, 1.0)
    theta = jnp.arccos(jnp.clip(cos_t, -1.0, 1.0))
    sin_t = jnp.sin(theta)
    small = sin_t < 1e-4
    w0 = jnp.where(small, 1.0 - t, jnp.sin((1.0 - t) * theta)
                   / jnp.where(small, 1.0, sin_t))
    w1 = jnp.where(small, t, jnp.sin(t * theta)
                   / jnp.where(small, 1.0, sin_t))
    q = q0 * w0 + q1 * w1
    q = q / jnp.maximum(jnp.linalg.norm(q, axis=-1, keepdims=True), 1e-12)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = jnp.stack([
        jnp.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                   2 * (x * z + y * w)], -1),
        jnp.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                   2 * (y * z - x * w)], -1),
        jnp.stack([2 * (x * z - y * w), 2 * (y * z + x * w),
                   1 - 2 * (x * x + y * y)], -1)], -2)
    S0 = irow[..., 48:57].reshape(irow.shape[:-1] + (3, 3))
    S1 = irow[..., 57:66].reshape(irow.shape[:-1] + (3, 3))
    S = S0 * (1.0 - t[..., None]) + S1 * t[..., None]
    M = jnp.einsum("...ij,...jk->...ik", R, S, precision=jax.lax.Precision.HIGHEST)
    A_trs = jnp.concatenate([M, T[..., None]], -1)
    return jnp.where(has_m, A_trs, A0)


def _invert_affine(A):
    """Per-lane inverse of (..., 3, 4) affine maps (adjugate 3x3)."""
    M = A[..., :3]
    t = A[..., 3]
    c00 = M[..., 1, 1] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 1]
    c01 = M[..., 1, 2] * M[..., 2, 0] - M[..., 1, 0] * M[..., 2, 2]
    c02 = M[..., 1, 0] * M[..., 2, 1] - M[..., 1, 1] * M[..., 2, 0]
    det = M[..., 0, 0] * c00 + M[..., 0, 1] * c01 + M[..., 0, 2] * c02
    inv_det = 1.0 / jnp.where(jnp.abs(det) < 1e-20, 1.0, det)
    adj = jnp.stack([
        jnp.stack([c00,
                   M[..., 0, 2] * M[..., 2, 1] - M[..., 0, 1] * M[..., 2, 2],
                   M[..., 0, 1] * M[..., 1, 2] - M[..., 0, 2] * M[..., 1, 1]],
                  -1),
        jnp.stack([c01,
                   M[..., 0, 0] * M[..., 2, 2] - M[..., 0, 2] * M[..., 2, 0],
                   M[..., 0, 2] * M[..., 1, 0] - M[..., 0, 0] * M[..., 1, 2]],
                  -1),
        jnp.stack([c02,
                   M[..., 0, 1] * M[..., 2, 0] - M[..., 0, 0] * M[..., 2, 1],
                   M[..., 0, 0] * M[..., 1, 1] - M[..., 0, 1] * M[..., 1, 0]],
                  -1)], -2)
    Minv = adj * inv_det[..., None, None]
    tinv = -jnp.einsum("...ij,...j->...i", Minv, t, precision=jax.lax.Precision.HIGHEST)
    return jnp.concatenate([Minv, tinv[..., None]], -1)


def two_level_intersect(nodes_all, inst_rows, tri_geo_ordered, tlas_root,
                        o, d, t_max, any_hit=False, time=None):
    """Masked two-level traversal. o, d: (N, 3) WORLD rays.

    tri_geo_ordered: concatenated BLAS-ordered triangle rows (T, 10) whose
    column 9 codes the GLOBAL original triangle id.
    Returns dict(hit, t, prim, b0, b1, b2, inst (instance id, -1 = none)).
    """
    N = o.shape[0]
    STACK_DEPTH = bvh_mod.STACK_DEPTH
    MAX_LEAF = bvh_mod.MAX_LEAF_PRIMS

    stack = jnp.zeros((N, STACK_DEPTH), jnp.int32)
    sp = jnp.zeros((N,), jnp.int32)
    current = jnp.full((N,), tlas_root, jnp.int32)
    active = jnp.ones((N,), bool)
    # current-space ray (starts = world ray)
    co = o
    cd = d
    cur_inst = jnp.full((N,), -1, jnp.int32)
    t_best = jnp.asarray(t_max, jnp.float32) + jnp.zeros((N,), jnp.float32)
    prim_best = jnp.full((N,), -1, jnp.int32)
    inst_best = jnp.full((N,), -1, jnp.int32)
    b_best = jnp.zeros((N, 3), jnp.float32)
    rows_i = jnp.arange(N)

    in_tlas_root_zero = tlas_root  # static

    def cond(state):
        return jnp.any(state[0])

    def body(state):
        (active, current, sp, stack, co, cd, cur_inst, t_best, prim_best,
         inst_best, b_best) = state
        inv_d = 1.0 / jnp.where(cd == 0.0, 1e-20, cd)
        dir_neg = inv_d < 0.0
        node_lo, node_hi, roff, nprim, axis = bvh_mod._unpack_node(
            nodes_all[current])
        box_hit, _ = vm.ray_bounds_intersect_p(co, inv_d, t_best, node_lo,
                                               node_hi)
        box_hit = box_hit & active
        is_leaf = nprim > 0
        in_tlas = current >= in_tlas_root_zero

        # --- BLAS leaf: triangle tests in the current (object) space ---
        leaf_tri = box_hit & is_leaf & ~in_tlas
        for k in range(MAX_LEAF):
            pk = jnp.clip(roff + k, 0, tri_geo_ordered.shape[0] - 1)
            geo = tri_geo_ordered[pk]
            do_test = leaf_tri & (k < nprim)
            r = isect.ray_triangle(co, cd, t_best, geo[:, 0:3], geo[:, 3:6],
                                   geo[:, 6:9])
            better = do_test & r["hit"] & (r["t"] < t_best)
            t_best = jnp.where(better, r["t"], t_best)
            prim_best = jnp.where(better, f32_to_i32(geo[:, 9]), prim_best)
            inst_best = jnp.where(better, cur_inst, inst_best)
            b_best = jnp.where(
                better[:, None],
                jnp.stack([r["b0"], r["b1"], r["b2"]], -1), b_best)
        if any_hit:
            active = active & (prim_best < 0)

        # --- TLAS leaf: push ENTER tokens for its instances ---
        leaf_inst = box_hit & is_leaf & in_tlas & active
        for k in range(MAX_LEAF):
            tok = -2 - jnp.clip(roff + k, 0, inst_rows.shape[0] - 1)
            do_push = leaf_inst & (k < nprim)
            slot = jnp.clip(sp, 0, STACK_DEPTH - 1)
            stack = stack.at[rows_i, slot].set(
                jnp.where(do_push, tok, stack[rows_i, slot]))
            sp = jnp.where(do_push, sp + 1, sp)

        # --- interior: descend near, push far ---
        neg = pick3(dir_neg, axis)
        near = jnp.where(neg, roff, current + 1)
        far = jnp.where(neg, current + 1, roff)
        descend = box_hit & ~is_leaf & active
        slot = jnp.clip(sp, 0, STACK_DEPTH - 1)
        stack = stack.at[rows_i, slot].set(
            jnp.where(descend, far, stack[rows_i, slot]))
        sp = jnp.where(descend, sp + 1, sp)
        current = jnp.where(descend, near, current)

        # --- pop (with token handling) for lanes that didn't descend ---
        pop = active & ~descend
        exhausted = pop & (sp <= 0)
        active = active & ~exhausted
        do_pop = pop & (sp > 0)
        sp = jnp.where(do_pop, sp - 1, sp)
        tok = stack[rows_i, jnp.clip(sp, 0, STACK_DEPTH - 1)]
        # RETURN: restore the world ray, then pop again next iteration by
        # setting current to a node that's a no-op... instead: restore and
        # treat as an immediate no-descend (current = large leaf-less)?
        # Simplest: RETURN restores the ray and re-pops by looping — encode
        # by keeping current unchanged and clearing box via active mask is
        # racy; so RETURN directly performs the *next* pop inline:
        is_ret = do_pop & (tok == RETURN_TOKEN)
        co = jnp.where(is_ret[:, None], o, co)
        cd = jnp.where(is_ret[:, None], d, cd)
        cur_inst = jnp.where(is_ret, -1, cur_inst)
        # inline second pop for RETURN lanes
        exhausted2 = is_ret & (sp <= 0)
        active = active & ~exhausted2
        pop2 = is_ret & (sp > 0)
        sp = jnp.where(pop2, sp - 1, sp)
        tok = jnp.where(pop2,
                        stack[rows_i, jnp.clip(sp, 0, STACK_DEPTH - 1)], tok)
        # (a RETURN directly under another RETURN cannot happen: ENTER
        # always sits between them)
        # ENTER: switch into an instance BLAS
        is_enter = (do_pop | pop2) & (tok <= -2) & active
        ii = jnp.clip(-2 - tok, 0, inst_rows.shape[0] - 1)
        irow = inst_rows[ii]
        if time is None:
            A = irow[:, 0:12].reshape(-1, 3, 4)
        else:
            # animated instance: invert the time-blended o2w per lane
            # (static instances reduce to the stored exact w2o)
            A_dyn = _invert_affine(lerp_inst_o2w(irow, time))
            A_sta = irow[:, 0:12].reshape(-1, 3, 4)
            A = jnp.where((irow[:, 26] > 0.5)[:, None, None], A_dyn, A_sta)
        # full f32 products: TF32 would break watertight instance hits
        o_obj = jnp.einsum("nij,nj->ni", A[:, :, :3], o,
                           precision=jax.lax.Precision.HIGHEST) + A[:, :, 3]
        d_obj = jnp.einsum("nij,nj->ni", A[:, :, :3], d,
                           precision=jax.lax.Precision.HIGHEST)
        co = jnp.where(is_enter[:, None], o_obj, co)
        cd = jnp.where(is_enter[:, None], d_obj, cd)
        cur_inst = jnp.where(is_enter, f32_to_i32(irow[:, 25]), cur_inst)
        # push RETURN, jump to the BLAS root
        slot = jnp.clip(sp, 0, STACK_DEPTH - 1)
        stack = stack.at[rows_i, slot].set(
            jnp.where(is_enter, RETURN_TOKEN, stack[rows_i, slot]))
        sp = jnp.where(is_enter, sp + 1, sp)
        # normal node pop
        is_node = (do_pop | pop2) & (tok >= 0) & active
        current = jnp.where(is_enter, f32_to_i32(irow[:, 24]),
                            jnp.where(is_node, tok, current))
        return (active, current, sp, stack, co, cd, cur_inst, t_best,
                prim_best, inst_best, b_best)

    state = (active, current, sp, stack, co, cd, cur_inst, t_best,
             prim_best, inst_best, b_best)
    state = jax.lax.while_loop(cond, body, state)
    (_, _, _, _, _, _, _, t_best, prim_best, inst_best, b_best) = state
    hit = prim_best >= 0
    return dict(hit=hit, t=jnp.where(hit, t_best, jnp.inf), prim=prim_best,
                b0=b_best[:, 0], b1=b_best[:, 1], b2=b_best[:, 2],
                inst=inst_best)
