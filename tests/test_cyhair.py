"""cyhair2pbrt converter (reference cmd/cyhair2pbrt.cpp)."""
import io
import struct

import numpy as np

from pbrt_jax.cmd import cyhair2pbrt as ch


def _write_hair(path, strands, default_thickness=0.1, segments=None):
    """Minimal CyHair writer for tests."""
    num_strands = len(strands)
    total_points = sum(len(s) for s in strands)
    flags = 0x2  # points
    if segments is not None:
        flags |= 0x1
        default_segments = 0
    else:
        lens = {len(s) for s in strands}
        assert len(lens) == 1, "uniform strands needed without segments array"
        default_segments = len(strands[0]) - 1
    with open(path, "wb") as f:
        hdr = b"HAIR" + struct.pack("<IIIIff", num_strands, total_points,
                                    flags, default_segments,
                                    default_thickness, 1.0)
        hdr += struct.pack("<fff", 0.5, 0.5, 0.5)
        hdr += b"\0" * (128 - len(hdr))
        f.write(hdr)
        if segments is not None:
            f.write(np.asarray(segments, "<u2").tobytes())
        f.write(np.concatenate([np.asarray(s, "<f4").reshape(-1)
                                for s in strands]).tobytes())


def test_roundtrip_uniform(tmp_path):
    strands = [np.array([[0, 0, 0], [1, 0, 0], [2, 1, 0], [3, 1, 1]], float),
               np.array([[0, 5, 0], [1, 5, 0], [2, 5, 1], [3, 5, 1]], float)]
    p = tmp_path / "t.hair"
    _write_hair(p, strands)
    loaded, thick = ch.load_cyhair(p)
    assert len(loaded) == 2 and thick == np.float32(0.1)
    np.testing.assert_allclose(loaded[0], strands[0])

    out = io.StringIO()
    n = ch.convert(str(p), out, max_strands=-1, user_thickness=0.05)
    assert n == 2 * 3  # 3 segments per 4-point strand
    text = out.getvalue()
    assert text.count('Shape "curve"') == 6
    assert '"float width0" [ 0.050000 ]' in text


def test_segments_array_and_max_strands(tmp_path):
    strands = [np.array([[0, 0, 0], [1, 0, 0]], float),
               np.array([[0, 1, 0], [1, 1, 0], [2, 1, 0]], float)]
    p = tmp_path / "t.hair"
    _write_hair(p, strands, segments=[1, 2])
    out = io.StringIO()
    n = ch.convert(str(p), out, max_strands=1)
    assert n == 1  # only first strand, one straight segment


def test_bezier_interpolates_endpoints_and_c1():
    cps = np.array([[0, 0, 0], [1, 0, 0], [2, 1, 0], [4, 1, 2]], float)
    q = ch.catmullrom_strand_to_beziers(cps)
    assert q.shape == (3, 4, 3)
    # endpoint interpolation
    np.testing.assert_allclose(q[0, 0], cps[0])
    np.testing.assert_allclose(q[-1, 3], cps[-1])
    for i in range(2):
        np.testing.assert_allclose(q[i, 3], q[i + 1, 0])
        # C1: tangent across the join matches (Catmull-Rom property)
        np.testing.assert_allclose(q[i, 3] - q[i, 2], q[i + 1, 1] - q[i + 1, 0],
                                   atol=1e-12)
    # interior tangent equals (p[i+1] - p[i-1]) / 6
    np.testing.assert_allclose(q[1, 1] - q[1, 0], (cps[2] - cps[0]) / 6.0)


def test_output_parses_as_scene(tmp_path):
    strands = [np.array([[0, 0, 0], [0.5, 0.2, 0], [1, 0, 0.3],
                         [1.5, -0.2, 0]], float)]
    p = tmp_path / "t.hair"
    _write_hair(p, strands)
    pbrt = tmp_path / "hair.pbrt"
    with open(pbrt, "w") as f:
        f.write('Camera "perspective"\nFilm "rgb" "integer xresolution" [16] '
                '"integer yresolution" [16]\nWorldBegin\n'
                'LightSource "infinite" "rgb L" [1 1 1]\n')
        ch.convert(str(p), f)

    from pbrt_jax.scene.parser import parse_file
    desc = parse_file(str(pbrt))
    assert desc.scene.has_curves
