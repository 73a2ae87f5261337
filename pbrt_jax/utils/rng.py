"""Counter-based RNG + hashing in pure uint32 ops (reference util/rng.h, util/hash.h).

The reference uses stateful PCG32 (64-bit state) plus MurmurHash64A for seed
decorrelation. We avoid 64-bit integers (JAX runs without x64) and use
stateless counter-based 32-bit mixers instead: every random number is a pure
function of (seed, counter...) words, which is exactly what a jit/vmap pipeline
wants. Statistical quality: PCG-RXS-M-XS output permutation + murmur3-style
avalanche rounds — ample for Monte Carlo decorrelation.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

U32 = jnp.uint32
_M1 = np.uint32(0x85EBCA6B)
_M2 = np.uint32(0xC2B2AE35)
_PCG_MULT = np.uint32(747796405)
_PCG_INC = np.uint32(2891336453)


def _u32(x):
    return jnp.asarray(x).astype(U32)


def fmix32(h):
    """murmur3 finalizer: full avalanche on 32 bits."""
    h = _u32(h)
    h = h ^ (h >> 16)
    h = h * _M1
    h = h ^ (h >> 13)
    h = h * _M2
    h = h ^ (h >> 16)
    return h


def pcg_hash(x):
    """PCG-RXS-M-XS 32-bit hash (O'Neill)."""
    state = _u32(x) * _PCG_MULT + _PCG_INC
    word = ((state >> ((state >> 28) + np.uint32(4))) ^ state) * np.uint32(277803737)
    return (word >> 22) ^ word


def hash_u32(*words):
    """Combine any number of uint32 words/arrays into one decorrelated uint32.

    Replaces the reference's MurmurHash64A-based Hash(...) (util/hash.h:116).
    Not bit-identical to the reference (which is 64-bit); serves the same role
    of per-pixel/per-dimension seed decorrelation.
    """
    with np.errstate(over="ignore"):
        h = np.uint32(0x9E3779B9)
        for w in words:
            h = fmix32(_u32(w) ^ (h * np.uint32(0x01000193) + np.uint32(0x517CC1B7)))
    return h


def hash_float(*words):
    return u32_to_float01(hash_u32(*words))


def u32_to_float01(u):
    """uint32 -> float32 in [0, 1): top 24 bits * 2^-24."""
    return (_u32(u) >> 8).astype(jnp.float32) * np.float32(2.0**-24)


def uniform_u32(seed, *counters):
    return hash_u32(seed, *counters)


def uniform_float(seed, *counters):
    return u32_to_float01(hash_u32(seed, *counters))


def uniform_float2(seed, *counters):
    u = hash_u32(seed, *counters)
    # second stream by one extra mixing round with distinct constant
    v = fmix32(u ^ np.uint32(0x6C078965))
    return jnp.stack([u32_to_float01(u), u32_to_float01(v)], axis=-1)


def reverse_bits_32(n):
    """Bit reversal (reference util/lowdiscrepancy.h ReverseBits32)."""
    n = _u32(n)
    n = ((n << 16) | (n >> 16))
    n = ((n & np.uint32(0x00FF00FF)) << 8) | ((n & np.uint32(0xFF00FF00)) >> 8)
    n = ((n & np.uint32(0x0F0F0F0F)) << 4) | ((n & np.uint32(0xF0F0F0F0)) >> 4)
    n = ((n & np.uint32(0x33333333)) << 2) | ((n & np.uint32(0xCCCCCCCC)) >> 2)
    n = ((n & np.uint32(0x55555555)) << 1) | ((n & np.uint32(0xAAAAAAAA)) >> 1)
    return n


def left_shift_2(x):
    """Spread bits of low 16 bits into even positions (Morton helper,
    reference util/math.h LeftShift2 / EncodeMorton2)."""
    x = _u32(x)
    x = (x ^ (x << 8)) & np.uint32(0x00FF00FF)
    x = (x ^ (x << 4)) & np.uint32(0x0F0F0F0F)
    x = (x ^ (x << 2)) & np.uint32(0x33333333)
    x = (x ^ (x << 1)) & np.uint32(0x55555555)
    return x


def encode_morton_2(x, y):
    return (left_shift_2(y) << 1) | left_shift_2(x)


class PCG32:
    """Host-side PCG32 (numpy uint64) for scene-build randomness.

    Matches the reference's PCG32 (util/rng.h:30) including the default
    state/sequence constants, so host-side shuffles (e.g. Halton digit
    permutations, BVH sampling) can be made reproducible.
    """
    PCG32_DEFAULT_STATE = np.uint64(0x853C49E6748FEA9B)
    PCG32_DEFAULT_STREAM = np.uint64(0xDA3E39CB94B95BDB)
    PCG32_MULT = np.uint64(0x5851F42D4C957F2D)

    def __init__(self, seq_index=None, offset=None):
        self.state = self.PCG32_DEFAULT_STATE
        self.inc = self.PCG32_DEFAULT_STREAM
        if seq_index is not None:
            self.set_sequence(np.uint64(seq_index),
                              np.uint64(offset) if offset is not None else None)

    def set_sequence(self, seq, offset=None):
        with np.errstate(over="ignore"):
            self.state = np.uint64(0)
            self.inc = (np.uint64(seq) << np.uint64(1)) | np.uint64(1)
            self.uniform_u32()
            if offset is None:
                offset = np.uint64(0x5D835D3B9C229B65)  # mix-in like Hash(seq)
            self.state += np.uint64(offset)
            self.uniform_u32()

    def uniform_u32(self):
        with np.errstate(over="ignore"):
            old = self.state
            self.state = old * self.PCG32_MULT + self.inc
            xorshifted = np.uint32(((old >> np.uint64(18)) ^ old) >> np.uint64(27))
            rot = np.uint32(old >> np.uint64(59))
            return np.uint32((xorshifted >> rot) | (xorshifted << ((~rot + np.uint32(1)) & np.uint32(31))))

    def uniform_float(self):
        return min(float(self.uniform_u32()) * 2.0**-32, 1.0 - 2.0**-24)

    def uniform_u32_bounded(self, b):
        threshold = np.uint32((2**32 - b) % b)
        while True:
            r = self.uniform_u32()
            if r >= threshold:
                return np.uint32(r % np.uint32(b))


# ---------------------------------------------------------------------------
# 64-bit hash emulation on (hi, lo) uint32 pairs — used by the bit-exact
# ZSobol sampler path (reference util/hash.h MixBits + MurmurHash64A).
# JAX runs without x64, so uint64 is emulated with u32 pairs (a 64-bit
# multiply costs ~5 vector ops).

def _u32c(x):
    return jnp.asarray(x, jnp.uint32)


def _mulhi_u32(a, b):
    """High 32 bits of the 32x32 product (u32 arrays)."""
    a0 = a & jnp.uint32(0xFFFF)
    a1 = a >> jnp.uint32(16)
    b0 = b & jnp.uint32(0xFFFF)
    b1 = b >> jnp.uint32(16)
    x0 = a0 * b0
    x1 = a1 * b0
    x2 = a0 * b1
    x3 = a1 * b1
    t = (x0 >> jnp.uint32(16)) + (x1 & jnp.uint32(0xFFFF)) + \
        (x2 & jnp.uint32(0xFFFF))
    return x3 + (x1 >> jnp.uint32(16)) + (x2 >> jnp.uint32(16)) + \
        (t >> jnp.uint32(16))


def mul64(ah, al, bh, bl):
    """(ah:al) * (bh:bl) mod 2^64 -> (hi, lo)."""
    lo = al * bl
    hi = _mulhi_u32(al, bl) + al * bh + ah * bl
    return hi, lo


def shr64(h, l, s: int):
    s = int(s)
    if s == 0:
        return h, l
    if s < 32:
        return h >> jnp.uint32(s), (l >> jnp.uint32(s)) | \
            (h << jnp.uint32(32 - s))
    return jnp.zeros_like(h), h >> jnp.uint32(s - 32)


def mixbits64(h, l):
    """Reference MixBits (util/hash.h:70), on a (hi, lo) u32 pair."""
    sh, sl = shr64(h, l, 31)
    h, l = h ^ sh, l ^ sl
    h, l = mul64(h, l, _u32c(0x7FB5D329), _u32c(0x728EA185))
    sh, sl = shr64(h, l, 27)
    h, l = h ^ sh, l ^ sl
    h, l = mul64(h, l, _u32c(0x81DADEF4), _u32c(0xBC2DD44D))
    sh, sl = shr64(h, l, 33)
    return h ^ sh, l ^ sl


_MURMUR_M = (0xC6A4A793, 0x5BD1E995)   # 0xc6a4a7935bd1e995
_MURMUR_R = 47


def murmur64_u64(kh, kl):
    """Reference MurmurHash64A over ONE 8-byte block, seed 0 (the form
    Hash(int, int) takes, util/hash.h:100): returns (hi, lo)."""
    mh, ml = _u32c(_MURMUR_M[0]), _u32c(_MURMUR_M[1])
    # h = 0 ^ (len * m) with len = 8
    hh, hl = mul64(jnp.zeros_like(kh), jnp.full_like(kl, 8), mh, ml)
    kh, kl = mul64(kh, kl, mh, ml)
    sh, sl = shr64(kh, kl, _MURMUR_R)
    kh, kl = kh ^ sh, kl ^ sl
    kh, kl = mul64(kh, kl, mh, ml)
    hh, hl = hh ^ kh, hl ^ kl
    hh, hl = mul64(hh, hl, mh, ml)
    sh, sl = shr64(hh, hl, _MURMUR_R)
    hh, hl = hh ^ sh, hl ^ sl
    hh, hl = mul64(hh, hl, mh, ml)
    sh, sl = shr64(hh, hl, _MURMUR_R)
    return hh ^ sh, hl ^ sl
