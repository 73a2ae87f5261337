"""Gather-avoidance primitives.

Design rules encoded here:

- small pools (<= ONEHOT_MAX_ROWS rows): one-hot f32 matmul, no gather
- per-entity attribute pools: pack ALL attributes into one (n, C) row matrix
  so each entity lookup is ONE gather, with int fields value-encoded in f32
- component picks (xyz by index): arithmetic select, never take_along_axis

On an H100 (700 W limit), routing every lookup through a real gather
(_FORCE_GATHER) measured 50.1M vs 43.1M paths/s on cornell and no
difference on meshfield (~144M paths/s either way), so the one-hot path
stays the default until gathers win on both.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


ONEHOT_MAX_ROWS = 512  # pools up to this many rows use the one-hot matmul

# Trace-time switches for A/B runs: a module global is read when a program
# is traced, so clear JAX's caches (jax.clear_caches()) after flipping one.
_ONEHOT_IMPL = "arith"   # "arith" (f32 clamp ramp) | "cmp" (int compare);
#                          bit-exact with each other
_FORCE_GATHER = False    # route every pool_lookup through a real gather


def pool_lookup(table, idx):
    """Row lookup from an entity pool: one-hot matmul for small pools,
    gather for large ones.

    table: (K, C) f32 — int columns must be VALUE-encoded f32 (ints < 2^24),
    never bitcast (0 * NaN-pattern would poison the one-hot sum).
    idx: (...,) int32, already clipped to [0, K).
    """
    if not _FORCE_GATHER and table.shape[0] <= ONEHOT_MAX_ROWS:
        return onehot_lookup(table, idx)
    return table[idx]


SELECT_MAX_ROWS = 2


def onehot_lookup(table, idx, axis_size=None):
    """Gather-free lookup for small tables.

    table: (K,) or (K, C) f32/int32-safe-in-f32; idx: (...) int32.
    Returns (...,) or (..., C).

    K<=2 uses a select chain; larger tables an exact-f32 one-hot matmul.
    """
    table = jnp.asarray(table, jnp.float32)
    K = table.shape[0] if axis_size is None else axis_size
    if K <= SELECT_MAX_ROWS:
        expand = table.ndim > 1
        acc = jnp.zeros(idx.shape + ((table.shape[1],) if expand else ()),
                        jnp.float32)
        for k in range(K):
            mask = idx == k
            row = table[k]
            acc = jnp.where(mask[..., None] if expand else mask, row, acc)
        return acc
    if _ONEHOT_IMPL == "arith":
        # pure-f32 ramp (exact for int-valued idx): |idx - k| >= 1 -> 0,
        # == 0 -> 1
        oh = jnp.maximum(0.0, 1.0 - jnp.abs(
            idx.astype(jnp.float32)[..., None]
            - jnp.arange(K, dtype=jnp.float32)))
    else:
        oh = (idx[..., None] == jnp.arange(K, dtype=jnp.int32)) \
            .astype(jnp.float32)
    # HIGHEST precision: a TF32 or bf16 pass would corrupt value-encoded
    # int columns above 2^10
    if table.ndim == 1:
        return jnp.matmul(oh, table, precision=jax.lax.Precision.HIGHEST)
    return jnp.tensordot(oh, table, axes=([-1], [0]),
                         precision=jax.lax.Precision.HIGHEST)


def f32_to_i32(v):
    """Decode a value-encoded int column (exact for |v| < 2^24; round guards
    against last-bit error in the matmul recovery)."""
    return jnp.round(v).astype(jnp.int32)


def pick3(v, k):
    """v[..., k] for k in {0,1,2} without a gather. v: (..., 3); k: (...)."""
    return jnp.where(k == 0, v[..., 0], jnp.where(k == 1, v[..., 1], v[..., 2]))


def f32_bits(i):
    """int32 -> f32 bit pattern (for packing int columns in f32 row matrices)."""
    return jax.lax.bitcast_convert_type(jnp.asarray(i, jnp.int32), jnp.float32)


def i32_bits(f):
    return jax.lax.bitcast_convert_type(jnp.asarray(f, jnp.float32), jnp.int32)


def pack_rows(*cols):
    """Pack columns (each (n,) f32/int32 or (n, k)) into one (n, C) f32 matrix.
    Int columns are bitcast. Returns (matrix, unpack_spec) where unpack_spec
    records (offset, width, is_int) per column for unpack_row."""
    parts = []
    spec = []
    off = 0
    for c in cols:
        c = np.asarray(c)
        is_int = np.issubdtype(c.dtype, np.integer) or c.dtype == bool
        if c.ndim == 1:
            c = c[:, None]
        w = c.shape[1]
        if is_int:
            parts.append(c.astype(np.int32).view(np.float32))
        else:
            parts.append(c.astype(np.float32))
        spec.append((off, w, bool(is_int)))
        off += w
    return np.concatenate(parts, axis=1), tuple(spec)


def unpack_col(rows, spec_entry):
    """rows: (..., C) gathered packed rows; spec_entry from pack_rows."""
    off, w, is_int = spec_entry
    v = rows[..., off:off + w]
    if is_int:
        v = i32_bits(v)
    if w == 1:
        v = v[..., 0]
    return v
