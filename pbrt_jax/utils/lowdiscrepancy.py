"""Low-discrepancy sequences: Sobol', radical inverse, scramblers
(reference util/lowdiscrepancy.{h,cpp}, util/sobolmatrices.{h,cpp}).

Sobol' generator matrices are the Joe & Kuo (2008) direction numbers
(public dataset), packed as a (1024, 52) uint32 array. Sample generation is
bit-exact with the reference for the unscrambled and binary-permuted cases;
Owen-style scrambling uses the same FastOwenScrambler bit mixer.
"""
from __future__ import annotations

import functools
from pathlib import Path

import jax.numpy as jnp
import numpy as np

from .rng import reverse_bits_32, fmix32, _u32

N_SOBOL_DIMENSIONS = 1024
SOBOL_MATRIX_SIZE = 52
_DATA = Path(__file__).resolve().parent.parent / "data"

_F32_SCALE = np.float32(2.0 ** -32)
_ONE_MINUS_EPS = np.float32(np.nextafter(np.float32(1.0), np.float32(0.0)))


@functools.lru_cache(maxsize=1)
def sobol_matrices() -> np.ndarray:
    """(1024, 52) uint32 generator matrices (columns, MSB-first like reference)."""
    d = np.load(_DATA / "sobolmatrices.npz")
    return d["SobolMatrices32"].reshape(N_SOBOL_DIMENSIONS, SOBOL_MATRIX_SIZE)


def sobol_sample_u32(a, dimension, matrices=None):
    """Raw 32-bit Sobol' value for index a (uint32/arrays) and dimension.

    (reference lowdiscrepancy.h:168 SobolSample; we support 32-bit indices —
    up to 2^32 samples total — vs the reference's 64-bit.)

    a: (...,) uint32 sample indices; dimension: scalar int or (...) int32.
    """
    if matrices is None:
        matrices = jnp.asarray(sobol_matrices())
    a = _u32(a)
    dim_mats = matrices[dimension]  # (..., 52) or (52,)
    v = jnp.zeros_like(a)
    for i in range(32):
        bit = (a >> np.uint32(i)) & np.uint32(1)
        col = dim_mats[..., i] if dim_mats.ndim > 1 else dim_mats[i]
        v = v ^ jnp.where(bit.astype(bool), _u32(col), np.uint32(0))
    return v


def u32_to_sample(v):
    """uint32 -> float in [0,1) (matches reference's *0x1p-32 + clamp)."""
    return jnp.minimum(v.astype(jnp.float32) * _F32_SCALE, _ONE_MINUS_EPS)


# --- Scramblers (reference lowdiscrepancy.h:204-260) ---

def binary_permute_scramble(v, permutation):
    return _u32(permutation) ^ _u32(v)


def fast_owen_scramble(v, seed):
    """Laine-Karras style hash-based Owen scramble (reference
    FastOwenScrambler, lowdiscrepancy.h:227)."""
    v = reverse_bits_32(v)
    seed = _u32(seed)
    v = v ^ (v * np.uint32(0x3D20ADEA))
    v = v + seed
    v = v * ((seed >> 16) | np.uint32(1))
    v = v ^ (v * np.uint32(0x05526C56))
    v = v ^ (v * np.uint32(0x53A22864))
    return reverse_bits_32(v)


def owen_scramble(v, seed):
    """Full per-bit Owen scramble (reference OwenScrambler, :239)."""
    v = _u32(v)
    seed = _u32(seed)
    out = jnp.where((seed & np.uint32(1)).astype(bool), v ^ np.uint32(1 << 31), v)
    for b in range(1, 32):
        mask = (np.uint32(0xFFFFFFFF) << np.uint32(32 - b)).astype(jnp.uint32) \
            if not np.isscalar(b) else np.uint32((0xFFFFFFFF << (32 - b)) & 0xFFFFFFFF)
        h = fmix32((out & mask) ^ fmix32(_u32(b) ^ seed))
        out = out ^ jnp.where((h & np.uint32(1 << (31 - b))).astype(bool),
                              np.uint32(1 << (31 - b)), np.uint32(0))
    return out


# --- Radical inverse / Halton (reference lowdiscrepancy.h:86) ---

@functools.lru_cache(maxsize=1)
def primes_table(n=256):
    """First n primes."""
    primes = []
    c = 2
    while len(primes) < n:
        if all(c % p for p in primes if p * p <= c):
            primes.append(c)
        c += 1
    return np.array(primes, np.int64)


def radical_inverse_host(prime_index: int, a) -> np.ndarray:
    """Host (numpy, exact) radical inverse for testing/tables."""
    base = int(primes_table()[prime_index])
    a = np.asarray(a, np.uint64)
    inv_base = 1.0 / base
    reversed_digits = np.zeros_like(a)
    inv_mult = np.ones(a.shape)
    while (a > 0).any():
        next_a = a // base
        digit = a - next_a * base
        reversed_digits = reversed_digits * base + digit
        inv_mult *= inv_base
        a = next_a
    return np.minimum(reversed_digits * inv_mult, 1.0 - 1e-7)


def radical_inverse(prime_index_static: int, a, max_digits=None):
    """Device radical inverse, base = primes[prime_index_static] (static int).

    a: int32/uint32 arrays. Accumulates in float32 (digit i gets weight
    base^-(i+1)); digits beyond float32 precision are sub-ULP and skipped
    (the reference accumulates in uint64+double, util/lowdiscrepancy.h:86 —
    JAX runs without 64-bit ints, and the output is float32 regardless).
    """
    base = int(primes_table()[prime_index_static])
    if max_digits is None:
        max_digits = int(np.ceil(26 / np.log2(base))) + 1
    a = jnp.asarray(a).astype(jnp.uint32)
    v = jnp.zeros(a.shape, jnp.float32)
    mult = np.float32(1.0 / base)
    for _ in range(max_digits):
        next_a = a // np.uint32(base)
        digit = a - next_a * np.uint32(base)
        v = v + digit.astype(jnp.float32) * mult
        mult = np.float32(mult / base)
        a = next_a
    return jnp.minimum(v, _ONE_MINUS_EPS)


def radical_inverse_dynamic(base, a, max_digits=32):
    """Radical inverse with a TRACED base (for Halton's per-dimension primes).

    base: (...,) int32/uint32; a: (...,) uint32. Fixed 32 digit iterations —
    for bases > 2 the surplus iterations contribute zero digits; float32
    accumulation keeps everything within output precision."""
    base = jnp.asarray(base).astype(jnp.uint32)
    a = jnp.asarray(a).astype(jnp.uint32)
    v = jnp.zeros(jnp.broadcast_shapes(base.shape, a.shape), jnp.float32)
    inv_base = 1.0 / base.astype(jnp.float32)
    mult = inv_base
    for _ in range(max_digits):
        next_a = a // base
        digit = a - next_a * base
        v = v + digit.astype(jnp.float32) * mult
        mult = mult * inv_base
        a = next_a
    return jnp.minimum(v, _ONE_MINUS_EPS)


def scrambled_radical_inverse(prime_index_static: int, a, perm):
    """Digit-permuted radical inverse; perm is (base,) int32 permutation array
    applied per digit (reference uses per-digit DigitPermutation; we use one
    permutation for all digit positions + per-digit xor of position hash is
    left to the Halton sampler)."""
    base = int(primes_table()[prime_index_static])
    max_digits = int(np.ceil(26 / np.log2(base))) + 1
    a = jnp.asarray(a).astype(jnp.uint32)
    v = jnp.zeros(a.shape, jnp.float32)
    mult = np.float32(1.0 / base)
    for _ in range(max_digits):
        next_a = a // np.uint32(base)
        digit = (a - next_a * np.uint32(base)).astype(jnp.int32)
        pdigit = perm[digit].astype(jnp.float32)
        v = v + pdigit * mult
        mult = np.float32(mult / base)
        a = next_a
    return jnp.minimum(v, _ONE_MINUS_EPS)


def compute_radical_inverse_permutations(seed: int) -> list[np.ndarray]:
    """Per-prime random digit permutations (reference DigitPermutation)."""
    rng = np.random.RandomState(seed & 0x7FFFFFFF)
    perms = []
    for p in primes_table():
        perms.append(rng.permutation(int(p)).astype(np.int32))
    return perms
