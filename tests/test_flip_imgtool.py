"""FLIP metric + imgtool subcommands (reference imgtool.cpp:1101-1180)."""
import json

import numpy as np
import pytest

from pbrt_jax.utils.flip import flip


def test_flip_identical_is_zero():
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 1, (32, 32, 3)).astype(np.float32)
    emap, mean = flip(img, img)
    assert mean < 1e-6 and emap.max() < 1e-5


def test_flip_orders_perturbations():
    """Bigger perturbations -> bigger FLIP; noise visible but small."""
    rng = np.random.default_rng(1)
    img = rng.uniform(0.2, 0.8, (48, 48, 3)).astype(np.float32)
    small = np.clip(img + rng.normal(0, 0.01, img.shape), 0, 1)
    big = np.clip(img + rng.normal(0, 0.2, img.shape), 0, 1)
    _, e_small = flip(img, small)
    _, e_big = flip(img, big)
    assert 0 < e_small < e_big < 1.0


def test_flip_detects_hue_shift_more_than_luminance_preserving():
    base = np.full((32, 32, 3), 0.5, np.float32)
    shifted = base.copy()
    shifted[..., 0] = 0.8   # push toward red
    shifted[..., 1] = 0.35  # keep rough luminance
    _, e = flip(base, shifted)
    assert e > 0.05


def test_imgtool_diff_flip_and_falsecolor(tmp_path, capsys):
    from pbrt_jax.cmd import imgtool
    rng = np.random.default_rng(2)
    a = rng.uniform(0, 1, (16, 16, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    from pbrt_jax.utils import image as pimg
    pa, pb = str(tmp_path / "a.pfm"), str(tmp_path / "b.pfm")
    pimg.write_pfm(pa, a)
    pimg.write_pfm(pb, b)
    assert imgtool.main(["diff", pa, pb, "--metric", "flip"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert 0 < out["flip"] < 1
    fc = str(tmp_path / "fc.png")
    assert imgtool.main(["falsecolor", pa, fc]) == 0
    import os
    assert os.path.exists(fc)


def test_imgtool_assemble_sums_partials(tmp_path, capsys):
    from pbrt_jax.cmd import imgtool
    from pbrt_jax.utils import image as pimg
    a = np.zeros((8, 8, 3), np.float32)
    b = np.zeros((8, 8, 3), np.float32)
    a[:4] = 1.0
    b[4:] = 2.0
    pimg.write_pfm(str(tmp_path / "p0.pfm"), a)
    pimg.write_pfm(str(tmp_path / "p1.pfm"), b)
    out = str(tmp_path / "full.pfm")
    assert imgtool.main(["assemble", str(tmp_path / "p0.pfm"),
                         str(tmp_path / "p1.pfm"), "--outfile", out]) == 0
    full = pimg.read_pfm(out)
    assert np.allclose(full[:4], 1.0) and np.allclose(full[4:], 2.0)
