#!/usr/bin/env python3
"""Generate RGB -> sigmoid-polynomial spectrum coefficient tables.

Re-implements the role of the reference's offline optimizer
(cmd/rgb2spec_opt.cpp, Jakob & Hanika 2019 "A Low-Dimensional Function Space
for Efficient Spectral Upsampling") as a vectorized Gauss-Newton/Levenberg-
Marquardt fit in numpy float64. For every RGB on a res^3 grid (sliced by max
component like the reference table layout) we fit coefficients (c0, c1, c2)
such that the round-trip RGB of sigmoid(c0 l^2 + c1 l + c2) under the color
space's illuminant matches the target.

Usage: python tools/gen_rgb2spec.py [srgb|rec2020|dci-p3|aces2065-1 ...] [--res 64]
"""
import argparse
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from pbrt_jax.utils import color, spectrum as spc  # noqa: E402

OUT = Path(__file__).resolve().parent.parent / "pbrt_jax" / "data"

LAM = np.arange(360.0, 831.0, 5.0)  # 95 wavelengths
NL = len(LAM)


def sigmoid(x):
    return 0.5 + x / (2.0 * np.sqrt(1.0 + x * x))


def sigmoid_deriv(x):
    return 1.0 / (2.0 * np.power(1.0 + x * x, 1.5))


def make_projection(cs: color.RGBColorSpace):
    """A (3, NL): reflectance samples -> linear RGB under cs illuminant."""
    t = spc.cie_tables().astype(np.float64)  # (3, 471) at 1nm
    idx = (LAM - 360.0).astype(int)
    cmf = t[:, idx]                              # (3, NL)
    illum = cs.illuminant(LAM)                   # (NL,)
    xyz_proj = cmf * illum[None, :]
    # Normalize on the same 5nm grid so reflectance==1 -> whitepoint exactly.
    norm = np.sum(cmf[1] * illum)
    xyz_proj = xyz_proj / norm
    return cs.rgb_from_xyz @ xyz_proj            # (3, NL)


# Fit in normalized lambda_n = (lam - 360) / 470 for conditioning; convert to
# raw-lambda coefficients (what the device eval expects) at save time.
LAM_N = (LAM - 360.0) / 470.0
V = np.stack([LAM_N * LAM_N, LAM_N, np.ones_like(LAM_N)], axis=1)  # (NL, 3)


def coeffs_normalized_to_raw(cn):
    """x = c0n ln^2 + c1n ln + c2n with ln=(l-b)/a  ->  raw-lambda quadratic."""
    a, b = 470.0, 360.0
    c0 = cn[..., 0] / (a * a)
    c1 = cn[..., 1] / a - 2.0 * b * cn[..., 0] / (a * a)
    c2 = cn[..., 0] * b * b / (a * a) - cn[..., 1] * b / a + cn[..., 2]
    return np.stack([c0, c1, c2], axis=-1)


def _eval_err(c, targets, A):
    s = sigmoid(c @ V.T)
    r = s @ A.T - targets
    return r, np.sum(r * r, axis=1)


def fit_batch(targets, c_init, A, iters=60):
    """Levenberg-Marquardt fit with vectorized accept/reject.

    targets: (B, 3); c_init: (B, 3) normalized-lambda coeffs. Returns (coeffs, sq_err).
    """
    c = c_init.copy()
    damp = np.full(len(targets), 1e-2)
    r, err = _eval_err(c, targets, A)
    for _ in range(iters):
        x = c @ V.T
        sp = sigmoid_deriv(x)            # (B, NL)
        J = np.einsum("cl,bl,lk->bck", A, sp, V, optimize=True)
        JTJ = np.einsum("bck,bcm->bkm", J, J)
        JTr = np.einsum("bck,bc->bk", J, r)
        JTJ = JTJ + (damp[:, None, None] *
                     np.maximum(np.einsum("bkk->bk", JTJ), 1e-10)[:, None, :] *
                     np.eye(3)[None])
        delta = np.linalg.solve(JTJ, JTr[..., None])[..., 0]
        c_new = c - delta
        _, err_new = _eval_err(c_new, targets, A)
        accept = err_new <= err
        c = np.where(accept[:, None], c_new, c)
        damp = np.where(accept, np.maximum(damp * 0.25, 1e-8),
                        np.minimum(damp * 8.0, 1e6))
        r, err = _eval_err(c, targets, A)
    return c, err


def generate(cs_name: str, res: int):
    cs = color.get_colorspace(cs_name)
    A = make_projection(cs)
    coeffs = np.zeros((3, res, res, res, 3), np.float64)
    grid = (np.arange(res) + 0.0) / (res - 1)
    t0 = time.time()
    worst = 0.0
    for maxc in range(3):
        c_prev = None
        for zi in range(res - 1, -1, -1):
            z = max(grid[zi], 1e-4)  # max component value
            xs, ys = np.meshgrid(grid, grid, indexing="xy")
            rgb = np.zeros((res, res, 3))
            rgb[..., maxc] = z
            rgb[..., (maxc + 1) % 3] = xs * z
            rgb[..., (maxc + 2) % 3] = ys * z
            targets = rgb.reshape(-1, 3)
            c_init = c_prev if c_prev is not None else np.zeros((res * res, 3))
            c, err = fit_batch(targets, c_init, A, iters=40 if c_prev is None else 20)
            # Warm starts from a saturated-sigmoid slice can be stuck on a
            # zero-gradient plateau; refit the stragglers from scratch.
            bad = err > 1e-8
            if bad.any():
                c2, err2 = fit_batch(targets[bad], np.zeros((bad.sum(), 3)), A, iters=60)
                better = err2 < err[bad]
                idx = np.where(bad)[0][better]
                c[idx] = c2[better]
                err[idx] = err2[better]
            worst = max(worst, float(np.sqrt(err.max())))
            coeffs[maxc, zi] = coeffs_normalized_to_raw(c).reshape(res, res, 3)
            c_prev = c
    print(f"{cs_name}: res={res} fit in {time.time()-t0:.1f}s, worst rgb err={worst:.2e}")
    np.savez_compressed(OUT / f"rgb2spec_{cs_name}.npz", coeffs=coeffs.astype(np.float32))


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("spaces", nargs="*", default=["srgb"])
    p.add_argument("--res", type=int, default=64)
    args = p.parse_args()
    for name in (args.spaces or ["srgb"]):
        generate(name, args.res)
