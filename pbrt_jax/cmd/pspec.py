"""Sampler power-spectrum analysis (reference cmd/pspec.cpp:260): average
periodogram of a sampler's 2D sample sets, the standard diagnostic for
low-discrepancy structure (blue-noise samplers show a dark ring around DC).

Usage:
  python -m pbrt_jax.cmd.pspec --sampler zsobol --spp 256 --runs 64 \
      --res 257 --outfile spec.exr
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def power_spectrum(points_sets, res=257):
    """points_sets: (K, n, 2) in [0,1)^2 -> (res, res) average
    periodogram, DC at the center (reference pspec.cpp direct Fourier
    sum; evaluated by FFT of the continuous sum via direct matrix — n is
    small so the direct sum is exact, no binning bias)."""
    K, n, _ = points_sets.shape
    fx = np.arange(res) - res // 2
    acc = np.zeros((res, res))
    for k in range(K):
        x = points_sets[k, :, 0]
        y = points_sets[k, :, 1]
        # separable complex exponentials: (res, n) each
        ex = np.exp(-2j * np.pi * fx[:, None] * x[None, :])   # (res, n)
        ey = np.exp(-2j * np.pi * fx[:, None] * y[None, :])
        F = ey @ ex.T                                          # (res, res)
        acc += (F.real ** 2 + F.imag ** 2) / n
    return acc / K


def sampler_points(kind, spp, runs, seed0=0):
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from .. import samplers as smp
    sets = []
    for r in range(runs):
        params = smp.make_sampler(kind, spp=spp, seed=seed0 + r,
                                  full_resolution=(1, 1))
        si = jnp.arange(params.spp, dtype=jnp.int32)
        z = jnp.zeros((params.spp,), jnp.int32)
        u = np.asarray(smp.sample_2d(params, z, z, si, jnp.int32(0)))
        sets.append(u)
    return np.stack(sets)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="pspec")
    ap.add_argument("--sampler", default="zsobol")
    ap.add_argument("--spp", type=int, default=256)
    ap.add_argument("--runs", type=int, default=16)
    ap.add_argument("--res", type=int, default=129)
    ap.add_argument("--outfile", default=None)
    args = ap.parse_args(argv)
    pts = sampler_points(args.sampler, args.spp, args.runs)
    spec = power_spectrum(pts, args.res)
    c = args.res // 2
    # radial summary: energy near DC (r < spp^.5/2 ring) vs white-noise
    yy, xx = np.meshgrid(np.arange(args.res) - c, np.arange(args.res) - c,
                         indexing="ij")
    r = np.sqrt(xx ** 2 + yy ** 2)
    ring = (r > 1) & (r < np.sqrt(args.spp) / 2)
    print(json.dumps(dict(sampler=args.sampler, spp=args.spp,
                          dc=float(spec[c, c]),
                          low_freq_mean=float(spec[ring].mean()))))
    if args.outfile:
        from ..utils import image as pimg
        out = np.repeat(spec[..., None], 3, -1).astype(np.float32)
        if args.outfile.endswith(".exr"):
            pimg.write_exr(args.outfile, out)
        else:
            pimg.write_png(args.outfile,
                           np.clip(out / max(out.max(), 1e-9), 0, 1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
