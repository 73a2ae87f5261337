"""A-Trous AOV-guided denoiser (role of the reference OptiX denoiser,
gpu/optix/denoiser.h:23 + imgtool denoise-optix)."""
import numpy as np
import pytest

from pbrt_jax import denoise as dn
from pbrt_jax.utils import image as pimg


def _synthetic(noise=0.3, seed=0):
    """Two flat regions split vertically, distinct albedo + normals."""
    rng = np.random.RandomState(seed)
    H = W = 64
    clean = np.zeros((H, W, 3), np.float32)
    clean[:, :32] = [0.9, 0.2, 0.1]
    clean[:, 32:] = [0.1, 0.3, 0.8]
    noisy = clean + rng.normal(0, noise, clean.shape).astype(np.float32)
    albedo = clean.copy()
    normal = np.zeros((H, W, 3), np.float32)
    normal[:, :32] = [0, 0, 1]
    normal[:, 32:] = [0, 1, 0]
    gx, gy = np.meshgrid(np.arange(W), np.arange(H))
    pos = np.stack([gx, gy, np.zeros((H, W))], -1).astype(np.float32)
    var = np.full((H, W), noise * noise, np.float32)
    return clean, noisy, albedo, normal, pos, var


def test_denoise_reduces_mse():
    clean, noisy, albedo, normal, pos, var = _synthetic()
    out = dn.denoise(noisy, albedo=albedo, normal=normal, position=pos,
                     variance=var)
    assert pimg.image_mse(out, clean) < 0.2 * pimg.image_mse(noisy, clean)


def test_denoise_preserves_guided_edges():
    clean, noisy, albedo, normal, pos, var = _synthetic()
    out = dn.denoise(noisy, albedo=albedo, normal=normal, position=pos,
                     variance=var)
    # the two sides must not bleed into each other: region means stay apart
    left, right = out[:, :30].mean(axis=(0, 1)), out[:, 34:].mean(axis=(0, 1))
    np.testing.assert_allclose(left, [0.9, 0.2, 0.1], atol=0.08)
    np.testing.assert_allclose(right, [0.1, 0.3, 0.8], atol=0.08)


def test_denoise_without_guides_runs():
    clean, noisy, *_ = _synthetic()
    out = dn.denoise(noisy, iterations=3)
    assert out.shape == clean.shape
    assert pimg.image_mse(out, clean) < pimg.image_mse(noisy, clean)


def test_denoise_gbuffer_exr_roundtrip(tmp_path):
    clean, noisy, albedo, normal, pos, var = _synthetic()
    p_in = str(tmp_path / "g.exr")
    ch = {"R": noisy[..., 0], "G": noisy[..., 1], "B": noisy[..., 2],
          "Variance": var}
    for i, c in enumerate("xyz"):
        ch[f"N.{c}"] = normal[..., i]
        ch[f"P.{c}"] = pos[..., i]
    for i, c in enumerate("RGB"):
        ch[f"Albedo.{c}"] = albedo[..., i]
    pimg.write_exr_channels(p_in, ch)
    # channel reader round-trips
    back = pimg.read_exr_channels(p_in)
    np.testing.assert_allclose(back["N.y"], normal[..., 1], atol=1e-3)
    p_out = str(tmp_path / "d.exr")
    from pbrt_jax.cmd import imgtool
    assert imgtool.main(["denoise", p_in, "--outfile", p_out]) == 0
    out = pimg.read_exr(p_out)
    assert pimg.image_mse(out, clean) < 0.3 * pimg.image_mse(noisy, clean)
