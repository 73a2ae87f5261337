"""Samplers as stateless functions (reference samplers.{h,cpp}, base/sampler.h:28).

Closed world: {Independent, Stratified, Halton, Sobol, PaddedSobol, ZSobol}
— each sampler computes sample dimension d for (pixel, sample_index)
as a pure function, which is the array-native form of the reference's stateful
Get1D/Get2D with an internal dimension counter: the integrator carries an
int32 dimension counter in its loop state and calls `sample_1d/sample_2d`.

ZSobol (reference samplers.h:225, Ahmed & Wonka 2020 blue-noise Sobol') is
the default high-quality sampler, matching the reference's recommendation.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
from .utils import struct

from .utils import rng as prng
from .utils import lowdiscrepancy as ld

SAMPLER_INDEPENDENT = 0
SAMPLER_STRATIFIED = 1
SAMPLER_ZSOBOL = 2
SAMPLER_SOBOL = 3
SAMPLER_PADDED_SOBOL = 4
SAMPLER_HALTON = 5
SAMPLER_PMJ02BN = 6
SAMPLER_TABLE = 7   # per-lane primary-sample-space table (MLT chains)
SAMPLER_ZSOBOL_EXACT = 8  # bit-exact reference ZSobol (64-bit hashes)

_U32 = jnp.uint32

_ONE_MINUS_EPS = np.float32(np.nextafter(np.float32(1.0), np.float32(0.0)))


import functools  # noqa: E402


@functools.lru_cache(maxsize=1)
def _pmj02_tables() -> np.ndarray:
    """(5, 65536, 2) uint32 pmj02 sample tables (tools/gen_pmj02.py;
    reference pmj02tables.h)."""
    from pathlib import Path
    p = Path(__file__).resolve().parent / "data" / "pmj02bn.npz"
    return np.load(p)["samples"]


@functools.lru_cache(maxsize=1)
def _bluenoise_masks():
    """(K, 128, 128) uint16 toroidal blue-noise ranking masks
    (tools/gen_bluenoise.py; reference util/bluenoise.h)."""
    from pathlib import Path
    p = Path(__file__).resolve().parent / "data" / "bluenoise.npz"
    return np.load(p)["masks"]


def blue_noise(table_index, px, py):
    """BlueNoise(tableIndex, pixel) in [0,1) (reference bluenoise.h:25)."""
    masks = jnp.asarray(_bluenoise_masks())
    k, res, _ = masks.shape
    ti = jnp.asarray(table_index, jnp.int32) % k
    x = px.astype(jnp.int32) % res
    y = py.astype(jnp.int32) % res
    flat = masks.reshape(-1)
    v = flat[(ti * res + y) * res + x]
    return v.astype(jnp.float32) / 65535.0


@struct.dataclass
class SamplerParams:
    kind: int = struct.field(pytree_node=False, default=SAMPLER_ZSOBOL)
    spp: int = struct.field(pytree_node=False, default=16)
    seed: int = struct.field(pytree_node=False, default=0)
    # zsobol: derived index bit counts
    log2_spp: int = struct.field(pytree_node=False, default=4)
    n_base4_digits: int = struct.field(pytree_node=False, default=16)
    # stratified
    x_strata: int = struct.field(pytree_node=False, default=4)
    y_strata: int = struct.field(pytree_node=False, default=4)
    jitter: bool = struct.field(pytree_node=False, default=True)
    # SAMPLER_TABLE: (N_lanes, D) primary-sample values; px indexes the lane
    # (the MLTSampler PSS vector, reference samplers.h:634)
    table: jnp.ndarray = None


_KIND_NAMES = {"independent": SAMPLER_INDEPENDENT,
               "stratified": SAMPLER_STRATIFIED,
               "zsobol": SAMPLER_ZSOBOL, "sobol": SAMPLER_SOBOL,
               "paddedsobol": SAMPLER_PADDED_SOBOL, "halton": SAMPLER_HALTON,
               "pmj02bn": SAMPLER_PMJ02BN,
               "zsobol-exact": SAMPLER_ZSOBOL_EXACT}


def kind_name(params: "SamplerParams") -> str:
    return {v: k for k, v in _KIND_NAMES.items()}[params.kind]


def make_sampler(kind="zsobol", spp=16, seed=0, full_resolution=(1024, 1024),
                 jitter=True) -> SamplerParams:
    kinds = _KIND_NAMES
    k = kinds[kind]
    if k in (SAMPLER_ZSOBOL, SAMPLER_ZSOBOL_EXACT, SAMPLER_SOBOL,
             SAMPLER_PADDED_SOBOL, SAMPLER_PMJ02BN):
        # round spp to power of 2 (reference warns and rounds, samplers.h:243)
        log2_spp = max(0, int(np.ceil(np.log2(max(spp, 1)))))
        spp = 1 << log2_spp
    else:
        log2_spp = 0
    res = max(full_resolution[0], full_resolution[1])
    log4_spp = (log2_spp + 1) // 2
    # Log2Int(RoundUpPow2(res)) like the reference (samplers.h:236)
    n_base4 = int(np.ceil(np.log2(max(res, 2)))) + log4_spp
    xs = int(np.sqrt(spp))
    while xs > 1 and spp % xs:
        xs -= 1
    return SamplerParams(kind=k, spp=spp, seed=seed, log2_spp=log2_spp,
                         n_base4_digits=n_base4, x_strata=xs,
                         y_strata=max(spp // xs, 1), jitter=jitter)


# ---------------------------------------------------------------------------
# ZSobol index shuffling (reference samplers.h ZSobolSampler::GetSampleIndex)

_PERMUTATIONS = np.array([
    [0, 1, 2, 3], [0, 1, 3, 2], [0, 2, 1, 3], [0, 2, 3, 1],
    [0, 3, 2, 1], [0, 3, 1, 2], [1, 0, 2, 3], [1, 0, 3, 2],
    [1, 2, 0, 3], [1, 2, 3, 0], [1, 3, 2, 0], [1, 3, 0, 2],
    [2, 1, 0, 3], [2, 1, 3, 0], [2, 0, 1, 3], [2, 0, 3, 1],
    [2, 3, 0, 1], [2, 3, 1, 0], [3, 1, 2, 0], [3, 1, 0, 2],
    [3, 2, 1, 0], [3, 2, 0, 1], [3, 0, 2, 1], [3, 0, 1, 2]], np.int32)


# permutation rows bit-packed as 2-bit fields so the per-digit lookup is a
# gather-free one-hot (see ops/gather.py)
_PERMS_PACKED = np.asarray(
    [p[0] | (p[1] << 2) | (p[2] << 4) | (p[3] << 6) for p in _PERMUTATIONS],
    np.float32)


def _zsobol_index_bits(params: SamplerParams):
    """Meaningful bit count of the z-curve morton|spp index."""
    return 2 * params.n_base4_digits - (params.log2_spp & 1)


def _zsobol_sample_index_fast(params: SamplerParams, px, py, sample_index,
                              dim_pair):
    """Nested-uniform shuffled sample index, arithmetic form.

    The reference (samplers.h:258-316) walks the base-4 digits of the
    morton|spp index and permutes each through a hashed pick of the 24
    digit permutations, 12 hash+one-hot-table rounds per dimension pair.
    This
    variant applies a base-2 Owen shuffle of the SAME index instead: align
    the B meaningful bits to the top, bit-reverse, Laine-Karras multiply
    mix (each bit perturbed by the bits above it in the tree = its z-curve
    prefix), reverse back. Base-2 nested scrambles are a subgroup of the
    base-4 ones (every power-of-4 block is a power-of-2 block), so the
    shuffle remains a valid nested uniform permutation — same blue-noise
    mechanism, ~30x fewer vector ops."""
    morton = prng.encode_morton_2(px.astype(_U32), py.astype(_U32))
    morton_index = (morton << np.uint32(params.log2_spp)) | \
        sample_index.astype(_U32)
    B = _zsobol_index_bits(params)
    seed = prng.hash_u32(jnp.asarray(dim_pair, _U32),
                         _U32(np.uint32(params.seed)),
                         np.uint32(0x9dbf6d7c))
    v = morton_index << np.uint32(32 - B)
    v = ld.fast_owen_scramble(v, seed)
    return v >> np.uint32(32 - B)


def _zsobol_sample_index(params: SamplerParams, px, py, sample_index, dim_pair):
    """Blue-noise shuffled sample index (reference samplers.h:258-316)."""
    from .ops.gather import onehot_lookup
    packed_perms = jnp.asarray(_PERMS_PACKED)
    morton = prng.encode_morton_2(px.astype(_U32), py.astype(_U32))
    morton_index = (morton << np.uint32(params.log2_spp)) | sample_index.astype(_U32)

    n_digits = params.n_base4_digits
    pow2_spp = (params.log2_spp & 1) == 1
    last_digit = 1 if pow2_spp else 0
    sample_idx = jnp.zeros_like(morton_index)
    for i in range(n_digits - 1, last_digit - 1, -1):
        digit_shift = np.uint32(2 * i - (1 if pow2_spp else 0))
        digit = (morton_index >> digit_shift) & np.uint32(3)
        higher = (morton_index >> (digit_shift + np.uint32(2))).astype(_U32)
        p = (prng.hash_u32(higher, jnp.asarray(dim_pair, _U32),
                           _U32(np.uint32(params.seed)),
                           np.uint32(0x9dbf6d7c)) >> 24) % np.uint32(24)
        packed = onehot_lookup(packed_perms, p.astype(jnp.int32)).astype(jnp.uint32)
        digit = (packed >> (np.uint32(2) * digit)) & np.uint32(3)
        sample_idx = sample_idx | (digit << digit_shift)
    if pow2_spp:
        digit = morton_index & np.uint32(1)
        flip = prng.hash_u32((morton_index >> np.uint32(1)).astype(_U32),
                             jnp.asarray(dim_pair, _U32),
                             _U32(np.uint32(params.seed))) & np.uint32(1)
        sample_idx = sample_idx | (digit ^ flip)
    return sample_idx


def _zsobol_sample_index_exact(params: SamplerParams, px, py,
                               sample_index, dim):
    """BIT-EXACT reference ZSobolSampler::GetSampleIndex (samplers.h:302):
    base-4 digit permutations picked by the 64-bit MixBits hash of the
    higher digits xor 0x55555555 * dimension. dim is the PRE-CALL
    dimension value (the reference reads `dimension` before advancing
    it). 64-bit hashes run on emulated (hi, lo) u32 pairs."""
    from .ops.gather import onehot_lookup
    packed_perms = jnp.asarray(_PERMS_PACKED)
    morton = prng.encode_morton_2(px.astype(_U32), py.astype(_U32))
    morton_index = (morton << np.uint32(params.log2_spp)) | \
        sample_index.astype(_U32)
    dim_u = jnp.asarray(dim, _U32)
    mix_in = _U32(np.uint32(0x55555555)) * dim_u
    n_digits = params.n_base4_digits
    pow2_spp = (params.log2_spp & 1) == 1
    last_digit = 1 if pow2_spp else 0
    sample_idx = jnp.zeros_like(morton_index)
    zero = jnp.zeros_like(morton_index)
    for i in range(n_digits - 1, last_digit - 1, -1):
        digit_shift = np.uint32(2 * i - (1 if pow2_spp else 0))
        digit = (morton_index >> digit_shift) & np.uint32(3)
        higher = (morton_index >> (digit_shift + np.uint32(2)))
        mh, ml = prng.mixbits64(zero, higher ^ mix_in)
        # ((hi:lo) >> 24) % 24 with 2^32 % 24 == 16
        a = mh >> np.uint32(24)
        b = (mh << np.uint32(8)) | (ml >> np.uint32(24))
        p = ((a % np.uint32(24)) * np.uint32(16)
             + b % np.uint32(24)) % np.uint32(24)
        packed = onehot_lookup(packed_perms,
                               p.astype(jnp.int32)).astype(jnp.uint32)
        digit = (packed >> (np.uint32(2) * digit)) & np.uint32(3)
        sample_idx = sample_idx | (digit << digit_shift)
    if pow2_spp:
        digit = morton_index & np.uint32(1)
        mh, ml = prng.mixbits64(zero,
                                (morton_index >> np.uint32(1)) ^ mix_in)
        sample_idx = sample_idx | (digit ^ (ml & np.uint32(1)))
    return sample_idx


def _zsobol_exact_hash(dim_plus, seed):
    """(hi, lo) of reference Hash(dimension, seed) — MurmurHash64A over
    the 8-byte (int32 dimension, int32 seed) buffer (util/hash.h:100)."""
    kh = jnp.full_like(dim_plus, np.uint32(np.uint32(seed)))
    return prng.murmur64_u64(kh, dim_plus)


def _halton_1d(params: SamplerParams, px, py, sample_index, dim):
    """Halton sample: radical inverse in the dim-th prime base with a
    per-(pixel, dimension) Cranley-Patterson rotation.

    The reference HaltonSampler (samplers.h:33) assigns pixels distinct
    subsequences via CRT index remapping over the first two bases; the
    vectorized substitution is a CP rotation, which keeps the per-dimension
    low-discrepancy structure and decorrelates pixels without 64-bit index
    arithmetic."""
    primes = jnp.asarray(ld.primes_table().astype(np.int32))
    base = primes[jnp.clip(dim, 0, primes.shape[0] - 1)]
    v = ld.radical_inverse_dynamic(base, sample_index)
    rot = prng.uniform_float(np.uint32(params.seed), px.astype(_U32),
                             py.astype(_U32), dim.astype(_U32),
                             np.uint32(0x42c7ee6d))
    u = v + rot
    u = u - jnp.floor(u)
    return jnp.minimum(u, np.float32(np.nextafter(np.float32(1.0),
                                                  np.float32(0.0))))


def _sobol_01(index, scramble_seed_a, scramble_seed_b):
    m = jnp.asarray(ld.sobol_matrices())
    va = ld.sobol_sample_u32(index, 0, m)
    vb = ld.sobol_sample_u32(index, 1, m)
    ua = ld.u32_to_sample(ld.fast_owen_scramble(va, scramble_seed_a))
    ub = ld.u32_to_sample(ld.fast_owen_scramble(vb, scramble_seed_b))
    return ua, ub


# ---------------------------------------------------------------------------
# Public sampling entry points

def sample_1d(params: SamplerParams, px, py, sample_index, dim):
    """dim: int32 array or scalar — the dimension counter."""
    px = jnp.asarray(px)
    py = jnp.asarray(py)
    sample_index = jnp.asarray(sample_index)
    dim = jnp.asarray(dim, jnp.int32) + jnp.zeros_like(px, jnp.int32)
    if params.kind == SAMPLER_TABLE:
        d = jnp.clip(dim, 0, params.table.shape[1] - 1)
        return params.table[px.astype(jnp.int32), d]
    if params.kind == SAMPLER_INDEPENDENT:
        return prng.uniform_float(np.uint32(params.seed), px.astype(_U32),
                                  py.astype(_U32), sample_index.astype(_U32),
                                  dim.astype(_U32))
    if params.kind == SAMPLER_STRATIFIED:
        # 1D stratification over spp with per-dimension permutation
        h = prng.hash_u32(px.astype(_U32), py.astype(_U32), dim.astype(_U32),
                          np.uint32(params.seed))
        stratum = _permutation_element(sample_index.astype(_U32),
                                       np.uint32(params.spp), h)
        delta = prng.uniform_float(h, sample_index.astype(_U32),
                                   np.uint32(0x55aa55aa)) if params.jitter else 0.5
        return (stratum.astype(jnp.float32) + delta) / params.spp
    if params.kind == SAMPLER_ZSOBOL:
        idx = _zsobol_sample_index_fast(params, px, py, sample_index, dim)
        h = prng.hash_u32(dim.astype(_U32), np.uint32(params.seed))
        m = jnp.asarray(ld.sobol_matrices())
        v = ld.sobol_sample_u32(idx, 0, m)
        return ld.u32_to_sample(ld.fast_owen_scramble(v, h))
    if params.kind == SAMPLER_ZSOBOL_EXACT:
        idx = _zsobol_sample_index_exact(params, px, py, sample_index, dim)
        # reference Get1D: ++dimension BEFORE Hash(dimension, seed)
        _hh, hl = _zsobol_exact_hash((dim + 1).astype(_U32), params.seed)
        m = jnp.asarray(ld.sobol_matrices())
        v = ld.sobol_sample_u32(idx, 0, m)
        return ld.u32_to_sample(ld.fast_owen_scramble(v, hl))
    if params.kind == SAMPLER_HALTON:
        return _halton_1d(params, px, py, sample_index, dim)
    if params.kind == SAMPLER_PMJ02BN:
        # permuted stratum + blue-noise offset (reference samplers.h:388)
        h = prng.hash_u32(px.astype(_U32), py.astype(_U32), dim.astype(_U32),
                          np.uint32(params.seed))
        idx = _permutation_element(sample_index.astype(_U32),
                                   np.uint32(params.spp), h)
        delta = blue_noise(dim, px, py)
        return jnp.minimum((idx.astype(jnp.float32) + delta) / params.spp,
                           _ONE_MINUS_EPS)
    # Sobol/padded-sobol fall back to per-dimension padded Sobol'
    idx = _padded_index(params, px, py, sample_index, dim)
    h = prng.hash_u32(dim.astype(_U32), np.uint32(params.seed), np.uint32(0x7fb1))
    m = jnp.asarray(ld.sobol_matrices())
    v = ld.sobol_sample_u32(idx, 0, m)
    return ld.u32_to_sample(ld.fast_owen_scramble(v, h))


def sample_2d(params: SamplerParams, px, py, sample_index, dim):
    """Returns (..., 2). Consumes 2 dimensions (caller advances dim by 2)."""
    px = jnp.asarray(px)
    py = jnp.asarray(py)
    sample_index = jnp.asarray(sample_index)
    dim = jnp.asarray(dim, jnp.int32) + jnp.zeros_like(px, jnp.int32)
    if params.kind == SAMPLER_TABLE:
        d = jnp.clip(dim, 0, params.table.shape[1] - 2)
        lane = px.astype(jnp.int32)
        return jnp.stack([params.table[lane, d],
                          params.table[lane, d + 1]], axis=-1)
    if params.kind == SAMPLER_INDEPENDENT:
        u = prng.uniform_float(np.uint32(params.seed), px.astype(_U32),
                               py.astype(_U32), sample_index.astype(_U32),
                               dim.astype(_U32))
        v = prng.uniform_float(np.uint32(params.seed ^ 0x94d049bb),
                               px.astype(_U32), py.astype(_U32),
                               sample_index.astype(_U32), dim.astype(_U32))
        return jnp.stack([u, v], axis=-1)
    if params.kind == SAMPLER_STRATIFIED:
        h = prng.hash_u32(px.astype(_U32), py.astype(_U32), dim.astype(_U32),
                          np.uint32(params.seed))
        stratum = _permutation_element(sample_index.astype(_U32),
                                       np.uint32(params.spp), h)
        xs = np.uint32(params.x_strata)
        sx = (stratum % xs).astype(jnp.float32)
        sy = (stratum // xs).astype(jnp.float32)
        if params.jitter:
            dx = prng.uniform_float(h, np.uint32(1), sample_index.astype(_U32))
            dy = prng.uniform_float(h, np.uint32(2), sample_index.astype(_U32))
        else:
            dx = dy = 0.5
        return jnp.stack([(sx + dx) / params.x_strata,
                          (sy + dy) / params.y_strata], axis=-1)
    if params.kind == SAMPLER_ZSOBOL:
        idx = _zsobol_sample_index_fast(params, px, py, sample_index, dim)
        ha = prng.hash_u32(dim.astype(_U32), np.uint32(params.seed))
        hb = prng.hash_u32(dim.astype(_U32), np.uint32(params.seed), np.uint32(0x4df5))
        ua, ub = _sobol_01(idx, ha, hb)
        return jnp.stack([ua, ub], axis=-1)
    if params.kind == SAMPLER_ZSOBOL_EXACT:
        idx = _zsobol_sample_index_exact(params, px, py, sample_index, dim)
        # reference Get2D: dimension += 2, then the 64-bit Hash provides
        # both component scramble seeds (lo -> x, hi -> y)
        hh, hl = _zsobol_exact_hash((dim + 2).astype(_U32), params.seed)
        ua, ub = _sobol_01(idx, hl, hh)
        return jnp.stack([ua, ub], axis=-1)
    if params.kind == SAMPLER_HALTON:
        return jnp.stack([_halton_1d(params, px, py, sample_index, dim),
                          _halton_1d(params, px, py, sample_index, dim + 1)],
                         axis=-1)
    if params.kind == SAMPLER_PMJ02BN:
        return _pmj02bn_2d(params, px, py, sample_index, dim)
    idx = _padded_index(params, px, py, sample_index, dim)
    ha = prng.hash_u32(dim.astype(_U32), np.uint32(params.seed), np.uint32(0x7fb1))
    hb = prng.hash_u32(dim.astype(_U32), np.uint32(params.seed), np.uint32(0x9f3a))
    ua, ub = _sobol_01(idx, ha, hb)
    return jnp.stack([ua, ub], axis=-1)


def _pmj02bn_2d(params: SamplerParams, px, py, sample_index, dim):
    """pmj02 table sample with blue-noise Cranley-Patterson rotation
    (reference PMJ02BNSampler::Get2D, samplers.h:406-428)."""
    tables = jnp.asarray(_pmj02_tables())  # (5, 65536, 2) u32
    n_sets, n_samples, _ = tables.shape
    instance = (dim // 2) % n_sets
    beyond = (dim // 2) >= n_sets
    h = prng.hash_u32(px.astype(_U32), py.astype(_U32), dim.astype(_U32),
                      np.uint32(params.seed), np.uint32(0x9d7f))
    permuted = _permutation_element(sample_index.astype(_U32),
                                    np.uint32(params.spp), h)
    idx = jnp.where(beyond, permuted.astype(jnp.int32),
                    sample_index.astype(jnp.int32)) % n_samples
    flat = tables.reshape(-1, 2)
    s = flat[instance * n_samples + idx]  # one fused gather (N, 2)
    u = s.astype(jnp.float32) * np.float32(2.0 ** -32)
    rot = jnp.stack([blue_noise(dim, px, py),
                     blue_noise(dim + 1, px, py)], axis=-1)
    u = u + rot
    u = jnp.where(u >= 1.0, u - 1.0, u)
    return jnp.minimum(u, _ONE_MINUS_EPS)


def sample_pixel_2d(params: SamplerParams, px, py, sample_index, dim):
    """Pixel-position sample (GetPixel2D): same as sample_2d for our samplers."""
    return sample_2d(params, px, py, sample_index, dim)


def _padded_index(params: SamplerParams, px, py, sample_index, dim):
    """Per-(pixel, dimension) shuffled sample index (PaddedSobol-style)."""
    h = prng.hash_u32(px.astype(_U32), py.astype(_U32), dim.astype(_U32),
                      np.uint32(params.seed), np.uint32(0x51a33))
    return _permutation_element(sample_index.astype(_U32),
                                np.uint32(max(params.spp, 1)), h)


def _permutation_element(i, n, seed):
    """Stateless in-place random permutation of [0, n) (Andrew Kensler's hash
    permutation; reference util/hash.h PermutationElement)."""
    i = i.astype(_U32)
    w = n - np.uint32(1)
    w = w | (w >> 1)
    w = w | (w >> 2)
    w = w | (w >> 4)
    w = w | (w >> 8)
    w = w | (w >> 16)

    def mix(x):
        x = x ^ seed
        x = x * np.uint32(0xe170893d)
        x = x ^ (seed >> 16)
        x = x ^ ((x & w) >> 4)
        x = x ^ (seed >> 8)
        x = x * np.uint32(0x0929eb3f)
        x = x ^ (seed >> 23)
        x = x ^ ((x & w) >> 1)
        x = x * (np.uint32(1) | (seed >> 27))
        x = x * np.uint32(0x6935fa69)
        x = x ^ ((x & w) >> 11)
        x = x * np.uint32(0x74dcb303)
        x = x ^ ((x & w) >> 2)
        x = x * np.uint32(0x9e501cc3)
        x = x ^ ((x & w) >> 2)
        x = x * np.uint32(0xc860a3df)
        return x & w

    # "cycle-walk until < n": since w+1 is the next pow2 >= n, each round
    # succeeds w.p. >= 1/2; 8 static rounds leave < 0.4% needing the modulo
    # fallback (bias negligible for MC decorrelation).
    x = mix(i)
    for _ in range(7):
        x = jnp.where(x >= n, mix(x), x)
    x = jnp.where(x >= n, x % jnp.maximum(n, np.uint32(1)), x)
    return (x + seed) % n
