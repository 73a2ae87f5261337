"""Light samplers (reference lightsamplers.{h,cpp}; base/lightsampler.h:23:
Uniform, Power, BVH, Exhaustive).

Round 1: Uniform + Power (alias-table). The alias table is packed into one
row matrix so a light pick costs ONE gather.
The many-light BVH sampler (Conty-Kulla) follows once large scenes land.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from .utils import struct

from .utils import sampling as sp

LS_UNIFORM = 0
LS_POWER = 1
LS_BVH = 2
LS_EXHAUSTIVE = 3


@struct.dataclass
class ExhaustiveLightSampler:
    """Position-aware sampler that evaluates the Conty-Kulla importance of
    EVERY bounded light per shading point (reference
    lightsamplers.h:407 ExhaustiveLightSampler; debug/ground-truth tool for
    validating the BVH sampler's stochastic traversal).

    Shape: a dense (lanes, L) importance matrix + inverse-CDF pick —
    O(L) per lane but fully vectorized, no traversal loop."""
    cols: jnp.ndarray = None       # (L, 12) lo(3) hi(3) axis(3) cos_o cos_e phi
    is_inf: jnp.ndarray = None     # (L,) f32, 1.0 for infinite lights
    n_lights: int = struct.field(pytree_node=False, default=0)
    p_infinite: float = struct.field(pytree_node=False, default=0.0)
    kind: int = struct.field(pytree_node=False, default=LS_EXHAUSTIVE)


@struct.dataclass
class LightSampler:
    kind: int = struct.field(pytree_node=False, default=LS_UNIFORM)
    n_lights: int = struct.field(pytree_node=False, default=0)
    # packed alias rows: [q, bits(alias), pmf_self, pmf_alias]
    rows: jnp.ndarray = None      # (L, 4) f32
    pmf_table: jnp.ndarray = None  # (L,) host/reference use


def make_light_sampler(kind: str, light_powers: np.ndarray,
                       light_bounds=None) -> LightSampler:
    """kind: uniform | power | bvh. For 'bvh', light_bounds is the dict of
    per-light LightBounds arrays (see scene_core)."""
    n = len(light_powers)
    if kind == "bvh" and n > 0 and light_bounds is not None and \
            np.sum(light_powers) > 0:
        from .lightsampler_bvh import build_bvh_light_sampler
        return build_bvh_light_sampler(**light_bounds)
    if kind == "exhaustive" and n > 0 and light_bounds is not None and \
            np.sum(light_powers) > 0:
        lb = light_bounds
        cols = np.concatenate([
            np.asarray(lb["bounds_lo"], np.float32),
            np.asarray(lb["bounds_hi"], np.float32),
            np.asarray(lb["axis_w"], np.float32),
            np.asarray(lb["cos_theta_o"], np.float32)[:, None],
            np.asarray(lb["cos_theta_e"], np.float32)[:, None],
            np.asarray(lb["power"], np.float32)[:, None]], axis=1)
        is_inf = np.asarray(lb["is_infinite"], bool)
        n_inf = int(is_inf.sum())
        n_bounded = int((~is_inf).sum())
        p_inf = n_inf / (n_inf + (1 if n_bounded else 0)) \
            if (n_inf or n_bounded) else 0.0
        return ExhaustiveLightSampler(
            cols=jnp.asarray(cols), is_inf=jnp.asarray(is_inf, jnp.float32),
            n_lights=n, p_infinite=float(p_inf))
    if kind == "power" and n > 0 and np.sum(light_powers) > 0:
        at = sp.AliasTable.build(light_powers)
        q = np.asarray(at.q, np.float32)
        alias = np.asarray(at.alias, np.int32)
        pmf = np.asarray(at.pmf, np.float32)
        rows = np.concatenate([
            q[:, None], alias[:, None].astype(np.float32),
            pmf[:, None], pmf[alias][:, None]], axis=1)
        return LightSampler(kind=LS_POWER, n_lights=n,
                            rows=jnp.asarray(rows), pmf_table=jnp.asarray(pmf))
    pmf = jnp.full((max(n, 1),), 1.0 / max(n, 1), jnp.float32)
    return LightSampler(kind=LS_UNIFORM, n_lights=n, pmf_table=pmf)


def sample_light(ls, u, p=None, n_ref=None):
    """u: (N,) -> (light_idx (N,), pmf (N,), u_remapped (N,)).

    Power sampler: one packed lookup (alias O(1) sampling, reference
    sampling.h:804). BVH sampler: position-aware stochastic traversal."""
    if getattr(ls, "kind", 0) == LS_BVH:
        from .lightsampler_bvh import sample_bvh_light
        return sample_bvh_light(ls, p, None, u)
    if getattr(ls, "kind", 0) == LS_EXHAUSTIVE:
        return _sample_exhaustive(ls, u, p, n_ref)
    if ls.n_lights == 0:
        z = jnp.zeros_like(u)
        return jnp.full(u.shape, -1, jnp.int32), z, u
    n = ls.n_lights
    if ls.kind == LS_POWER:
        up = u * n
        i = jnp.clip(up.astype(jnp.int32), 0, n - 1)
        frac = up - i.astype(jnp.float32)
        from .ops.gather import pool_lookup
        rows = pool_lookup(ls.rows, i)
        q = rows[..., 0]
        from .ops.gather import f32_to_i32
        alias = f32_to_i32(rows[..., 1])
        take_primary = frac < q
        idx = jnp.where(take_primary, i, alias)
        pmf = jnp.where(take_primary, rows[..., 2], rows[..., 3])
        u_new = jnp.where(take_primary,
                          frac / jnp.maximum(q, 1e-9),
                          (frac - q) / jnp.maximum(1.0 - q, 1e-9))
        return idx, pmf, jnp.clip(u_new, 0.0, 1.0 - 1e-7)
    idx = jnp.clip((u * n).astype(jnp.int32), 0, n - 1)
    u_new = jnp.clip(u * n - idx.astype(jnp.float32), 0.0, 1.0 - 1e-7)
    return idx, jnp.full(u.shape, 1.0 / n, jnp.float32), u_new


def light_pmf(ls, light_idx=None, light_row=None, p=None, n_ref=None):
    """PMF of picking a light (for MIS on BSDF-sampled light hits).

    Prefer passing a pre-gathered lights.LightRow (its pmf column) to avoid
    a gather; falls back to a table gather given indices. The BVH sampler's
    pmf depends on the shading point p."""
    if getattr(ls, "kind", 0) == LS_BVH:
        from .lightsampler_bvh import pmf_bvh_light
        return pmf_bvh_light(ls, p, None, light_idx)
    if getattr(ls, "kind", 0) == LS_EXHAUSTIVE:
        pmf_all = _exhaustive_pmf_matrix(ls, p, n_ref)       # (N, L)
        idx = jnp.clip(light_idx, 0, ls.n_lights - 1)
        return jnp.take_along_axis(pmf_all, idx[:, None], 1)[:, 0]
    if ls.n_lights == 0:
        shape = light_idx.shape if light_idx is not None else light_row.pmf.shape
        return jnp.zeros(shape, jnp.float32)
    if light_row is not None:
        return light_row.pmf
    if ls.kind == LS_UNIFORM:
        return jnp.full(light_idx.shape, 1.0 / ls.n_lights, jnp.float32)
    return ls.pmf_table[jnp.clip(light_idx, 0, ls.n_lights - 1)]

# ---------------------------------------------------------------------------
# Exhaustive sampler internals

def _exhaustive_pmf_matrix(ls: "ExhaustiveLightSampler", p, n_ref):
    """Full per-light pick probability (N, L): uniform among infinite lights
    weighted p_infinite; importance-proportional among bounded lights."""
    from .lightsampler_bvh import _child_importance
    N = p.shape[0]
    cols = ls.cols[None, :, :]                       # (1, L, 12)
    imp = _child_importance(cols, p[:, None, :],
                            None if n_ref is None else n_ref[:, None, :])
    imp = imp * (1.0 - ls.is_inf)[None, :]           # (N, L)
    tot = jnp.sum(imp, axis=1, keepdims=True)
    pmf_bounded = jnp.where(tot > 0, imp / jnp.maximum(tot, 1e-30), 0.0)
    n_inf = jnp.maximum(jnp.sum(ls.is_inf), 1.0)
    pmf_inf = ls.is_inf[None, :] * (ls.p_infinite / n_inf)
    return (1.0 - ls.p_infinite) * pmf_bounded + pmf_inf


def _sample_exhaustive(ls: "ExhaustiveLightSampler", u, p, n_ref):
    """Inverse-CDF pick over the dense pmf (reference
    ExhaustiveLightSampler::Sample, lightsamplers.cpp — which reservoir-samples
    the same importance distribution)."""
    pmf_all = _exhaustive_pmf_matrix(ls, p, n_ref)   # (N, L)
    cdf = jnp.cumsum(pmf_all, axis=1)
    total = cdf[:, -1:]
    # normalize (p_infinite + bounded mass may be < 1 when all importance = 0)
    target = jnp.clip(u[:, None], 0.0, 1.0 - 1e-7) * total
    idx = jnp.sum((cdf < target).astype(jnp.int32), axis=1)
    idx = jnp.clip(idx, 0, ls.n_lights - 1)
    pmf = jnp.take_along_axis(pmf_all, idx[:, None], 1)[:, 0]
    # remap u within the picked cell
    lo = jnp.take_along_axis(cdf, idx[:, None], 1)[:, 0] - pmf
    u_new = jnp.where(pmf > 0, (target[:, 0] - lo) / jnp.maximum(pmf, 1e-30), 0.5)
    pmf = jnp.where(total[:, 0] > 0, pmf, 0.0)
    return idx.astype(jnp.int32), pmf, jnp.clip(u_new, 0.0, 1.0 - 1e-7)
