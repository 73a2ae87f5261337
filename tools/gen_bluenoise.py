#!/usr/bin/env python3
"""Generate toroidal blue-noise ranking masks (void-and-cluster, Ulichney
1993) — the analogue of the reference's 48 precomputed 128x128 uint16 blue
noise textures (util/bluenoise.h).

We generate N_MASKS independent 128^2 masks; each mask is a dither ranking
scaled to uint16. FFT-based Gaussian energy updates keep the build fast.

Output: pbrt_jax/data/bluenoise.npz, array "masks" (N, 128, 128) uint16.
"""
from pathlib import Path

import numpy as np

RES = 128
SIGMA = 1.9
N_MASKS = 8  # cycled to cover the reference's 48 slots

ROOT = Path(__file__).resolve().parent.parent


def _energy_kernel():
    x = np.arange(RES)
    d = np.minimum(x, RES - x).astype(np.float64)
    dx, dy = np.meshgrid(d, d, indexing="ij")
    return np.exp(-(dx ** 2 + dy ** 2) / (2 * SIGMA ** 2))


def _toroidal_filter(binary, kf):
    return np.real(np.fft.ifft2(np.fft.fft2(binary) * kf))


def make_mask(seed):
    rng = np.random.RandomState(seed)
    n = RES * RES
    # the toroidal kernel is already origin-centered; no shift needed
    kf = np.fft.fft2(_energy_kernel())

    # initial binary pattern: 10% random points, relaxed to blue noise by
    # swapping tightest cluster with largest void until stable
    binary = np.zeros((RES, RES), bool)
    init = rng.choice(n, n // 10, replace=False)
    binary.reshape(-1)[init] = True
    for _ in range(n):
        e = _toroidal_filter(binary, kf)
        cluster = np.unravel_index(np.argmax(np.where(binary, e, -np.inf)),
                                   binary.shape)
        binary[cluster] = False
        e = _toroidal_filter(binary, kf)
        void = np.unravel_index(np.argmin(np.where(binary, np.inf, e)),
                                binary.shape)
        if void == cluster:
            binary[cluster] = True
            break
        binary[void] = True

    rank = np.zeros((RES, RES), np.int32)
    # Phase 1: remove points from the prototype, ranking down
    work = binary.copy()
    for r in range(work.sum() - 1, -1, -1):
        e = _toroidal_filter(work, kf)
        cluster = np.unravel_index(np.argmax(np.where(work, e, -np.inf)),
                                   work.shape)
        work[cluster] = False
        rank[cluster] = r
    # Phase 2: add points into the voids, ranking up
    work = binary.copy()
    for r in range(binary.sum(), n):
        e = _toroidal_filter(work, kf)
        void = np.unravel_index(np.argmin(np.where(work, np.inf, e)),
                                work.shape)
        work[void] = True
        rank[void] = r
    return (rank.astype(np.float64) * 65535.0 / (n - 1)).astype(np.uint16)


def main():
    masks = np.stack([make_mask(1000 + i) for i in range(N_MASKS)])
    out = ROOT / "pbrt_jax" / "data" / "bluenoise.npz"
    np.savez_compressed(out, masks=masks)
    print(f"wrote {out} shape {masks.shape}")


if __name__ == "__main__":
    main()
