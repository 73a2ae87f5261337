"""nanovdb2pbrt converter: round-trip against a synthetic NanoVDB writer
that follows the public v32.x serialization layout (FileHeader/FileMetaData/
GridData/TreeData/LeafData)."""
import struct
import zlib

import numpy as np
import pytest

from pbrt_jax.cmd import nanovdb2pbrt as nv


def _make_leaf(origin, block_xyz):
    """LeafData<float,3>: origin(3i32) bboxdif(3u8) flags(u8) mask(64B)
    min/max/avg/std(4f32) -> 96 bytes header, then 512 f32 x-major values."""
    buf = bytearray(nv._LEAF_SIZE)
    struct.pack_into("<3i", buf, 0, *origin)
    struct.pack_into("<3B", buf, 12, 7, 7, 7)
    mask = np.packbits(np.ones(512, np.uint8), bitorder="little")
    buf[16:16 + 64] = mask.tobytes()
    struct.pack_into("<4f", buf, 80, float(block_xyz.min()),
                     float(block_xyz.max()), float(block_xyz.mean()), 0.0)
    buf[96:96 + 2048] = np.asarray(block_xyz, "<f4").reshape(-1).tobytes()
    return bytes(buf)


def _write_nvdb(path, dense_zyx, name="density", voxel_size=0.5, codec=0):
    """dense (nz, ny, nx) with dims multiple of 8; origin at index 0."""
    nz, ny, nx = dense_zyx.shape
    assert nx % 8 == 0 and ny % 8 == 0 and nz % 8 == 0
    leaves = []
    for oz in range(0, nz, 8):
        for oy in range(0, ny, 8):
            for ox in range(0, nx, 8):
                block = np.transpose(
                    dense_zyx[oz:oz + 8, oy:oy + 8, ox:ox + 8], (2, 1, 0))
                leaves.append(_make_leaf((ox, oy, oz), block))
    n_leaf = len(leaves)

    grid_data = bytearray(nv._GRIDDATA_SIZE)
    struct.pack_into("<Q", grid_data, 0, nv.MAGIC)
    tree_data = bytearray(nv._TREEDATA_SIZE)
    # node offsets rel. to tree start: leaves directly after TreeData
    struct.pack_into("<4Q", tree_data, 0, nv._TREEDATA_SIZE, 0, 0, 0)
    struct.pack_into("<3I", tree_data, 32, n_leaf, 0, 0)
    struct.pack_into("<3I", tree_data, 44, 0, 0, 0)
    blob = bytes(grid_data) + bytes(tree_data) + b"".join(leaves)

    if codec == nv._CODEC_ZIP:
        comp = struct.pack("<Q", len(blob)) + zlib.compress(blob)
    else:
        comp = blob

    nm = name.encode() + b"\0"
    meta = bytearray(176)
    struct.pack_into("<QQQQII", meta, 0, len(blob), len(comp), 0,
                     dense_zyx.size, nv._GRIDTYPE_FLOAT, 1)
    struct.pack_into("<6d", meta, 40, 0, 0, 0, nx * voxel_size,
                     ny * voxel_size, nz * voxel_size)
    struct.pack_into("<6i", meta, 88, 0, 0, 0, nx - 1, ny - 1, nz - 1)
    struct.pack_into("<3d", meta, 112, voxel_size, voxel_size, voxel_size)
    struct.pack_into("<I", meta, 136, len(nm))
    struct.pack_into("<4I", meta, 140, n_leaf, 0, 0, 1)
    struct.pack_into("<H", meta, 168, codec)

    with open(path, "wb") as f:
        f.write(struct.pack("<QIHH", nv.MAGIC, 32 << 21, 1, codec))
        f.write(bytes(meta))
        f.write(nm)
        f.write(comp)


@pytest.mark.parametrize("codec", [0, 1])
def test_roundtrip(tmp_path, codec):
    rng = np.random.RandomState(3)
    dense = rng.rand(8, 16, 8).astype(np.float32)
    p = str(tmp_path / "t.nvdb")
    _write_nvdb(p, dense, codec=codec)
    g = nv.read_nanovdb(p)
    assert g.name == "density"
    np.testing.assert_allclose(g.values, dense)
    assert g.world_bbox[1] == (4.0, 8.0, 4.0)


def test_missing_grid_and_bad_magic(tmp_path):
    dense = np.zeros((8, 8, 8), np.float32)
    p = str(tmp_path / "t.nvdb")
    _write_nvdb(p, dense)
    with pytest.raises(ValueError, match="not found"):
        nv.read_nanovdb(p, "temperature")
    bad = tmp_path / "bad.nvdb"
    bad.write_bytes(b"not a vdb file....")
    with pytest.raises(ValueError, match="magic"):
        nv.read_nanovdb(str(bad))


def test_downsample():
    v = np.arange(64, dtype=np.float32).reshape(4, 4, 4)
    d = nv.downsample(v, 2)
    assert d.shape == (2, 2, 2)
    np.testing.assert_allclose(d[0, 0, 0], v[:2, :2, :2].mean())


def test_cli_pbrt_output(tmp_path, capsys):
    dense = np.full((8, 8, 8), 0.25, np.float32)
    p = str(tmp_path / "t.nvdb")
    _write_nvdb(p, dense)
    assert nv.main([p]) == 0
    out = capsys.readouterr().out
    assert '"integer nx" 8' in out and '"float density"' in out
    # output parses as a pbrt grid medium parameter block
    from pbrt_jax.scene.parser import parse_string
    scene_text = (
        'Camera "perspective"\nWorldBegin\n'
        'LightSource "infinite" "rgb L" [1 1 1]\n'
        'MakeNamedMedium "cl" "string type" "uniformgrid" ' + out.replace("\n", " ")
        + '\nAttributeBegin\nMediumInterface "cl" ""\n'
        'Shape "sphere" "float radius" [1]\nAttributeEnd\n')
    desc = parse_string(scene_text)
    assert desc.scene is not None
