"""AOV-guided image denoiser.

Role model: the reference's OptiX AI denoiser (gpu/optix/denoiser.h:23,
``Denoiser::Denoise`` with albedo + normal guide layers; exposed offline as
``imgtool denoise-optix``, imgtool.cpp:146).  The array-native equivalent is a
deterministic edge-avoiding A-Trous wavelet filter (Dammertz et al., HPG
2010) with SVGF-style variance modulation — pure stencil arithmetic that XLA
fuses into a handful of elementwise kernels, no neural network needed.

Guide layers come from the GBufferFilm AOVs (integrators/aov.py: N, P,
Albedo, Variance); all are optional — missing guides degrade gracefully to
a plain a-trous smoothing of the color image.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from functools import partial

# 5-tap B3-spline kernel, separable
_B3 = np.asarray([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0
_OFFS = [-2, -1, 0, 1, 2]


def _shift2(img, dy, dx):
    """Clamp-to-edge shift of (H, W, C) by (dy, dx)."""
    H, W = img.shape[:2]
    ys = jnp.clip(jnp.arange(H) + dy, 0, H - 1)
    xs = jnp.clip(jnp.arange(W) + dx, 0, W - 1)
    return img[ys][:, xs]


@partial(jax.jit, static_argnames=("iterations",))
def _atrous(color, albedo, normal, position, variance, iterations,
            sigma_color, sigma_normal, sigma_position):
    lum = color @ jnp.asarray([0.2126, 0.7152, 0.0722], color.dtype)
    out = color
    var = variance
    for it in range(iterations):
        step = 1 << it
        acc = jnp.zeros_like(out)
        acc_var = jnp.zeros_like(lum)
        wsum = jnp.zeros_like(lum)
        lum_c = out @ jnp.asarray([0.2126, 0.7152, 0.0722], out.dtype)
        # variance-adaptive color sigma (SVGF): normalize the luminance
        # difference by the local noise level
        sig_l = sigma_color * jnp.sqrt(jnp.maximum(var, 1e-10)) + 1e-6
        for dy in _OFFS:
            for dx in _OFFS:
                k = _B3[dy + 2] * _B3[dx + 2]
                c_q = _shift2(out, dy * step, dx * step)
                lum_q = c_q @ jnp.asarray([0.2126, 0.7152, 0.0722], out.dtype)
                w = jnp.full_like(lum, k)
                w = w * jnp.exp(-jnp.abs(lum_c - lum_q) / sig_l)
                if normal is not None:
                    n_q = _shift2(normal, dy * step, dx * step)
                    ndot = jnp.sum(normal * n_q, -1)
                    w = w * jnp.maximum(ndot, 0.0) ** sigma_normal
                if position is not None:
                    p_q = _shift2(position, dy * step, dx * step)
                    d2 = jnp.sum((position - p_q) ** 2, -1)
                    w = w * jnp.exp(-d2 / (2.0 * sigma_position ** 2))
                if albedo is not None:
                    a_q = _shift2(albedo, dy * step, dx * step)
                    da = jnp.sum(jnp.abs(albedo - a_q), -1)
                    w = w * jnp.exp(-da / 0.2)
                acc = acc + w[..., None] * c_q
                if var is not None:
                    acc_var = acc_var + w * w * _shift2(
                        var[..., None], dy * step, dx * step)[..., 0]
                wsum = wsum + w
        out = acc / jnp.maximum(wsum, 1e-10)[..., None]
        if var is not None:
            var = acc_var / jnp.maximum(wsum * wsum, 1e-10)
    return out


def denoise(color, albedo=None, normal=None, position=None, variance=None,
            iterations=5, sigma_color=4.0, sigma_normal=128.0,
            sigma_position=1.0):
    """Denoise an (H, W, 3) radiance image.

    albedo: (H, W, 3) first-hit albedo; normal: (H, W, 3) shading normals
    (unnormalized ok); position: (H, W, 3) world hit positions (or a depth
    map (H, W)); variance: (H, W) per-pixel sample variance of luminance.
    Returns (H, W, 3) float32.
    """
    color = jnp.asarray(color, jnp.float32)
    H, W = color.shape[:2]
    if variance is None:
        variance = jnp.ones((H, W), jnp.float32)
    else:
        variance = jnp.asarray(variance, jnp.float32).reshape(H, W)
    if normal is not None:
        normal = jnp.asarray(normal, jnp.float32)
        nrm = jnp.linalg.norm(normal, axis=-1, keepdims=True)
        normal = normal / jnp.maximum(nrm, 1e-9)
    if position is not None:
        position = jnp.asarray(position, jnp.float32)
        if position.ndim == 2:
            position = position[..., None]
        # scale positions so sigma_position acts on the local pixel footprint
        med = jnp.median(jnp.abs(jnp.diff(position, axis=0)).sum(-1)) + \
            jnp.median(jnp.abs(jnp.diff(position, axis=1)).sum(-1))
        position = position / jnp.maximum(med, 1e-6)
    if albedo is not None:
        albedo = jnp.asarray(albedo, jnp.float32)
    out = _atrous(color, albedo, normal, position, variance,
                  int(iterations), float(sigma_color), float(sigma_normal),
                  float(sigma_position))
    return np.asarray(out)


def denoise_gbuffer_exr(in_path, out_path, **kw):
    """Denoise a GBuffer AOV EXR written by integrators/aov.write_gbuffer_exr
    (channels R/G/B + N.*/P.*/Albedo.*/Variance)."""
    from .utils import image as pimg
    ch = pimg.read_exr_channels(in_path)

    def stack(prefix):
        names = [f"{prefix}.{c}" for c in
                 (("R", "G", "B") if f"{prefix}.R" in ch else ("x", "y", "z"))]
        if all(n in ch for n in names):
            return np.stack([ch[n] for n in names], -1)
        return None

    if not all(c in ch for c in "RGB"):
        raise ValueError(f"{in_path}: no R/G/B color channels")
    color = np.stack([ch["R"], ch["G"], ch["B"]], -1)
    out = denoise(color,
                  albedo=stack("Albedo"),
                  normal=stack("N") if stack("N") is not None else stack("Ns"),
                  position=stack("P"),
                  variance=ch.get("Variance"), **kw)
    pimg.write_exr(out_path, out)
    return out
