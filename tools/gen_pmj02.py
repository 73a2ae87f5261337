#!/usr/bin/env python3
"""Generate pmj02 sample tables (5 sets x 65536 2D samples, u32 fixed point).

Construction: Owen-scrambled (0,2) Sobol' pairs. A fully Owen-scrambled
Sobol' (0,2)-sequence has exactly the pmj02 elementary-interval
stratification (every base-2 elementary interval of area 1/N contains one
of each N-sample prefix aligned to powers of 4 — Christensen et al. 2018
§7 note the equivalence); distinct random seeds give the independent sets.
The blue-noise candidate optimization of pbrt's tables (pmj02bn) is not
reproduced — these tables have the same variance behavior, without the
perceptual dither property.

Output: pbrt_jax/data/pmj02bn.npz with array "samples" (5, 65536, 2) uint32.
"""
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def sobol_u32_host(indices, dim, matrices):
    """Host Sobol' evaluation: indices (N,) uint64, dim int."""
    v = np.zeros(len(indices), np.uint32)
    a = indices.copy()
    col = 0
    m = matrices[dim]
    while a.any():
        bit = (a & 1).astype(bool)
        v[bit] ^= m[col]
        a >>= 1
        col += 1
    return v


def owen_scramble_host(v, seed):
    """Full per-bit Owen scramble on uint32 values (host, vectorized over
    samples; mirrors utils/lowdiscrepancy.owen_scramble)."""
    v = v.copy()
    out = np.zeros_like(v)
    # process from the most significant bit down; the permutation of bit i
    # depends on the (i) higher-order bits
    for bit in range(31, -1, -1):
        prefix = (v >> np.uint32(bit + 1)) if bit < 31 else \
            np.zeros_like(v)
        h = (prefix ^ np.uint32(seed)) * np.uint32(0x9e3779b1)
        h ^= h >> np.uint32(16)
        h *= np.uint32(0x21f0aaad)
        h ^= h >> np.uint32(15)
        h *= np.uint32(0x735a2d97)
        h ^= h >> np.uint32(15)
        h ^= np.uint32((bit * 0x68bc21eb) & 0xFFFFFFFF)
        flip = (h >> np.uint32(31)) & np.uint32(1)
        out |= (((v >> np.uint32(bit)) & np.uint32(1)) ^ flip) << \
            np.uint32(bit)
    return out


def main():
    from pbrt_jax.utils import lowdiscrepancy as ld
    matrices = ld.sobol_matrices()
    n = 65536
    idx = np.arange(n, dtype=np.uint64)
    sets = []
    rng = np.random.RandomState(20260816)
    for s in range(5):
        seed0 = rng.randint(0, 1 << 31)
        seed1 = rng.randint(0, 1 << 31)
        v0 = sobol_u32_host(idx, 0, matrices)
        v1 = sobol_u32_host(idx, 1, matrices)
        sets.append(np.stack([owen_scramble_host(v0, seed0),
                              owen_scramble_host(v1, seed1)], axis=1))
    samples = np.stack(sets).astype(np.uint32)
    out = ROOT / "pbrt_jax" / "data" / "pmj02bn.npz"
    np.savez_compressed(out, samples=samples)
    print(f"wrote {out} shape {samples.shape}")


if __name__ == "__main__":
    main()
