"""Image I/O round-trips (reference image_test.cpp pattern)."""
import numpy as np

from pbrt_jax.utils import image as pimg


def test_pfm_roundtrip(tmp_path):
    img = np.random.RandomState(0).randn(13, 21, 3).astype(np.float32)
    p = tmp_path / "t.pfm"
    pimg.write_pfm(p, img)
    back = pimg.read_pfm(p)
    np.testing.assert_array_equal(back, img)


def test_exr_roundtrip(tmp_path):
    img = (np.random.RandomState(1).rand(17, 23, 3) * 100).astype(np.float32)
    p = tmp_path / "t.exr"
    pimg.write_exr(p, img)
    back = pimg.read_exr(p)
    np.testing.assert_array_equal(back, img)


def test_png_roundtrip(tmp_path):
    img = np.random.RandomState(2).randint(0, 256, (9, 11, 3)).astype(np.uint8)
    p = tmp_path / "t.png"
    pimg.write_png(p, img)
    back = pimg.read_png(p)
    np.testing.assert_array_equal(back, img)


def test_png_16bit_roundtrip(tmp_path):
    img = np.random.RandomState(3).randint(0, 65536, (5, 7, 3)).astype(np.uint16)
    p = tmp_path / "t16.png"
    pimg.write_png(p, img)
    back = pimg.read_png(p)
    np.testing.assert_array_equal(back, img)


def test_metrics():
    a = np.zeros((4, 4, 3))
    b = np.ones((4, 4, 3)) * 2
    assert pimg.image_mae(a, b) == 2.0
    assert pimg.image_mse(a, b) == 4.0
    assert pimg.image_mrse(a, b) == 4.0 / 4.01


def test_qoi_roundtrip(tmp_path):
    """QOI codec (qoiformat.org; reference util/image.cpp QOI read/write)."""
    rng = np.random.RandomState(0)
    img = np.zeros((40, 50, 3), np.uint8)
    img[:10] = 7                                       # QOI_OP_RUN
    img[10:20] = rng.randint(0, 255, (10, 50, 3))      # RGB/INDEX ops
    img[20:] = (np.cumsum(rng.randint(-2, 2, (20, 50, 3)), axis=1)
                % 256).astype(np.uint8)                # DIFF/LUMA ops
    p = str(tmp_path / "t.qoi")
    pimg.write_qoi(p, img)
    np.testing.assert_array_equal(pimg.read_qoi(p), img)
    img4 = rng.randint(0, 255, (16, 16, 4)).astype(np.uint8)
    pimg.write_qoi(p, img4)
    np.testing.assert_array_equal(pimg.read_qoi(p), img4)
