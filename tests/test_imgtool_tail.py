"""imgtool tail subcommands (reference imgtool.cpp: bloom, cat, makesky,
makeemitters, splitn, scalenormalmap, whitebalance)."""
import numpy as np
import pytest

from pbrt_jax.cmd import imgtool
from pbrt_jax.utils import image as pimg


def _write_exr(tmp_path, name, img):
    p = str(tmp_path / name)
    pimg.write_exr(p, np.asarray(img, np.float32))
    return p


def test_bloom_spreads_bright_pixels(tmp_path):
    img = np.zeros((32, 32, 3), np.float32)
    img[16, 16] = 100.0
    p = _write_exr(tmp_path, "in.exr", img)
    out = str(tmp_path / "out.exr")
    assert imgtool.main(["bloom", p, "--outfile", out, "--level", "1.0"]) == 0
    res = pimg.read_exr(out)
    # energy added around, original still brightest
    assert res[16, 20].sum() > 0.0
    assert res[16, 16].sum() > res[16, 20].sum()
    # below-threshold image errors out like the reference (returns 1)
    dark = _write_exr(tmp_path, "dark.exr", np.zeros((8, 8, 3), np.float32))
    assert imgtool.main(["bloom", dark, "--outfile", out,
                         "--level", "5.0"]) == 1


def test_cat_prints_pixels(tmp_path, capsys):
    img = np.arange(12, dtype=np.float32).reshape(2, 2, 3)
    p = _write_exr(tmp_path, "in.exr", img)
    assert imgtool.main(["cat", p]) == 0
    out = capsys.readouterr().out
    assert "(0, 0): 0.000000,1.000000,2.000000" in out
    assert imgtool.main(["cat", p, "--csv"]) == 0
    assert capsys.readouterr().out.splitlines()[0] == "0.000000,1.000000,2.000000"
    assert imgtool.main(["cat", p, "--sort"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("(0, 0)") and lines[-1].startswith("(1, 1)")


def test_makesky_writes_envmap(tmp_path):
    out = str(tmp_path / "sky.exr")
    assert imgtool.main(["makesky", "--outfile", out, "--resolution", "32",
                         "--elevation", "20"]) == 0
    img = pimg.read_exr(out)
    assert img.shape == (32, 32, 3)
    assert img.max() > 0.0 and np.all(np.isfinite(img))
    # bad args are rejected
    assert imgtool.main(["makesky", "--outfile", out,
                         "--turbidity", "0.5"]) == 1


def test_makeemitters_emits_pbrt(tmp_path, capsys):
    img = np.full((2, 2, 3), 0.5, np.float32)
    p = _write_exr(tmp_path, "in.exr", img)
    assert imgtool.main(["makeemitters", p]) == 0
    out = capsys.readouterr().out
    assert out.count('AreaLightSource "diffuse"') == 4
    assert out.count('Shape "bilinear"') == 4
    assert out.startswith("AttributeBegin")
    assert imgtool.main(["makeemitters", p, "--downsample", "2"]) == 0
    assert capsys.readouterr().out.count("AreaLightSource") == 1


def test_splitn_combines_and_crops(tmp_path):
    a = np.zeros((64, 64, 3), np.float32)
    b = np.ones((64, 64, 3), np.float32)
    pa, pb = _write_exr(tmp_path, "a.exr", a), _write_exr(tmp_path, "b.exr", b)
    import os
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        assert imgtool.main(["splitn", pa, pb, "--outfile", "out.exr",
                             "--cropsize", "8", "--crop", "4,4"]) == 0
        res = pimg.read_exr(str(tmp_path / "out.exr"))
        assert res[32, 2].sum() == 0.0      # left side from a
        assert res[32, 60].sum() == 3.0     # right side from b
        crops = pimg.read_exr(str(tmp_path / "crops-out.exr"))
        assert crops.shape[0] == 8 + 10     # one crop row + borders
    finally:
        os.chdir(cwd)


def test_scalenormalmap_flattens(tmp_path):
    # a 45-degree normal scaled by 0 becomes straight up
    n = np.array([[[np.sqrt(0.5), 0.0, np.sqrt(0.5)]]], np.float32)
    img = (n + 1.0) / 2.0
    p = _write_exr(tmp_path, "n.exr", img)
    out = str(tmp_path / "out.exr")
    assert imgtool.main(["scalenormalmap", p, "--outfile", out,
                         "--scale", "0"]) == 0
    res = pimg.read_exr(out) * 2.0 - 1.0
    np.testing.assert_allclose(res[0, 0], [0, 0, 1], atol=1e-5)


def test_whitebalance_neutralizes_tint(tmp_path):
    img = np.full((4, 4, 3), 0.5, np.float32)
    p = _write_exr(tmp_path, "in.exr", img)
    out = str(tmp_path / "out.exr")
    # balancing from a warm illuminant cools the image: blue gains vs red
    assert imgtool.main(["whitebalance", p, "--outfile", out,
                         "--illuminant", "A"]) == 0
    res = pimg.read_exr(out)
    assert res[0, 0, 2] > res[0, 0, 0]
    # temperature route runs
    assert imgtool.main(["whitebalance", p, "--outfile", out,
                         "--temperature", "6500"]) == 0
    res2 = pimg.read_exr(out)
    # D6500 ~ sRGB white: nearly no change
    np.testing.assert_allclose(res2[0, 0], 0.5, atol=0.03)
    # arg validation: exactly one source
    assert imgtool.main(["whitebalance", p, "--outfile", out]) == 1
