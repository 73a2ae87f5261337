"""NanoVDB (.nvdb) -> dense-grid converter.

Role model: the reference's ``nanovdb2pbrt`` (cmd/nanovdb2pbrt.cpp:59),
which extracts a sparse NanoVDB FogVolume float grid into the dense
``"integer nx/ny/nz" + "float density"`` parameter block consumed by pbrt's
GridMedium.  Offline dense conversion is the sanctioned ingestion route
(SURVEY.md §7): device media sampling runs on dense jnp arrays + majorant
super-grids, so sparse VDB trees are flattened here on the host.

This is a self-contained parser of the public NanoVDB serialization format
(magic "NanoVDB0", version 32.x, as vendored by pbrt-v4 via openvdb/nanovdb;
layout documented in NanoVDB.h / util/IO.h upstream):

  FileHeader  (16 B): u64 magic | u32 version | u16 gridCount | u16 codec
  FileMetaData(176 B) per grid + grid name, then the grid blob
  Grid blob: GridData(672 B) | TreeData(64 B) | root/internal/leaf nodes.

We walk LEAF nodes only (LeafData<float>: 2144 B = origin + masks + stats +
512 voxel values); constant internal-node tiles above leaf level are not
expanded (rare for fog volumes, where the background/tile value is 0) —
a warning is printed when upper-level tiles exist.  Codecs: NONE and ZIP
(zlib); BLOSC is not supported.

Usage:
  python -m pbrt_jax.cmd.nanovdb2pbrt volume.nvdb [--grid density]
      [--downsample N] [--npz out.npz]
"""
from __future__ import annotations

import struct
import sys
import zlib

import numpy as np

MAGIC = 0x304244566F6E614E  # "NanoVDB0"
_GRIDDATA_SIZE = 672
_TREEDATA_SIZE = 64
_LEAF_SIZE = 2144           # LeafData<float, 3>
_GRIDTYPE_FLOAT = 1
_CODEC_NONE, _CODEC_ZIP, _CODEC_BLOSC = 0, 1, 2


class NvdbGrid:
    def __init__(self, name, index_bbox, world_bbox, voxel_size, values):
        self.name = name
        self.index_bbox = index_bbox      # ((x0,y0,z0), (x1,y1,z1)) inclusive
        self.world_bbox = world_bbox      # ((x,y,z) min, max) in world space
        self.voxel_size = voxel_size
        self.values = values              # dense (nz, ny, nx) float32


def _read_file_meta(buf, off):
    (grid_size, file_size, _name_key, _voxel_count, grid_type, grid_class) = \
        struct.unpack_from("<QQQQII", buf, off)
    world_bbox = struct.unpack_from("<6d", buf, off + 40)
    index_bbox = struct.unpack_from("<6i", buf, off + 88)
    voxel_size = struct.unpack_from("<3d", buf, off + 112)
    (name_size,) = struct.unpack_from("<I", buf, off + 136)
    node_count = struct.unpack_from("<4I", buf, off + 140)
    tile_count = struct.unpack_from("<3I", buf, off + 156)
    (codec,) = struct.unpack_from("<H", buf, off + 168)
    off += 176
    name = buf[off:off + name_size].split(b"\0")[0].decode()
    off += name_size
    return dict(grid_size=grid_size, file_size=file_size, grid_type=grid_type,
                grid_class=grid_class, world_bbox=world_bbox,
                index_bbox=index_bbox, voxel_size=voxel_size, name=name,
                node_count=node_count, tile_count=tile_count,
                codec=codec), off


def read_nanovdb(path, grid_name="density"):
    """Parse a .nvdb file; returns the named NvdbGrid with dense values."""
    with open(path, "rb") as f:
        buf = f.read()
    magic, _version, grid_count, codec = struct.unpack_from("<QIHH", buf, 0)
    if magic != MAGIC:
        raise ValueError(f"{path}: not a NanoVDB file (bad magic)")
    off = 16
    for _ in range(grid_count):
        meta, off = _read_file_meta(buf, off)
        blob = buf[off:off + meta["file_size"]]
        off += meta["file_size"]
        if meta["name"] != grid_name:
            continue
        if meta["grid_type"] != _GRIDTYPE_FLOAT:
            raise ValueError(f"{path}: grid {grid_name!r} is not a float grid "
                             f"(type {meta['grid_type']})")
        use_codec = meta["codec"] if meta["codec"] else codec
        if use_codec == _CODEC_ZIP:
            # zip blob: u64 uncompressed size | zlib stream
            (usize,) = struct.unpack_from("<Q", blob, 0)
            blob = zlib.decompress(blob[8:])
            assert len(blob) == usize
        elif use_codec != _CODEC_NONE:
            raise ValueError(f"{path}: unsupported codec {use_codec} "
                             "(only NONE/ZIP)")
        return _parse_grid_blob(blob, meta)
    raise ValueError(f"{path}: grid {grid_name!r} not found")


def _parse_grid_blob(blob, meta):
    gmagic, = struct.unpack_from("<Q", blob, 0)
    if gmagic != MAGIC:
        raise ValueError("grid blob: bad GridData magic")
    tree_off = _GRIDDATA_SIZE
    node_offset = struct.unpack_from("<4Q", blob, tree_off)       # leaf,lower,upper,root
    node_count = struct.unpack_from("<3I", blob, tree_off + 32)   # leaf,lower,upper
    tile_count = struct.unpack_from("<3I", blob, tree_off + 44)
    if any(tile_count):
        print("nanovdb2pbrt: warning: grid has internal-node tiles; "
              "tile regions are filled with 0", file=sys.stderr)

    (x0, y0, z0, x1, y1, z1) = meta["index_bbox"]
    nx, ny, nz = x1 - x0 + 1, y1 - y0 + 1, z1 - z0 + 1
    dense = np.zeros((nz, ny, nx), np.float32)

    n_leaf = node_count[0]
    leaf_base = tree_off + node_offset[0]
    # vectorized leaf parse: origin at +0 (3x i32), values at +96 (512 f32)
    raw = np.frombuffer(blob, np.uint8,
                        count=n_leaf * _LEAF_SIZE, offset=leaf_base)
    raw = raw.reshape(n_leaf, _LEAF_SIZE)
    origins = raw[:, :12].copy().view("<i4").reshape(n_leaf, 3)
    values = raw[:, 96:96 + 512 * 4].copy().view("<f4").reshape(n_leaf, 8, 8, 8)
    for i in range(n_leaf):
        ox, oy, oz = (int(v) for v in origins[i])
        # leaf-local storage order is x-major: v[((x<<3)+y)<<3 + z]
        block = values[i]                      # indexed [x][y][z]
        zs, ys, xs = oz - z0, oy - y0, ox - x0
        ze, ye, xe = min(zs + 8, nz), min(ys + 8, ny), min(xs + 8, nx)
        if zs >= nz or ys >= ny or xs >= nx or ze <= 0 or ye <= 0 or xe <= 0:
            continue
        czs, cys, cxs = max(zs, 0), max(ys, 0), max(xs, 0)
        dense[czs:ze, cys:ye, cxs:xe] = np.transpose(block, (2, 1, 0))[
            czs - zs:ze - zs, cys - ys:ye - ys, cxs - xs:xe - xs]
    return NvdbGrid(meta["name"], ((x0, y0, z0), (x1, y1, z1)),
                    (tuple(meta["world_bbox"][:3]), tuple(meta["world_bbox"][3:])),
                    tuple(meta["voxel_size"]), dense)


def downsample(values, rate):
    """Box-average downsample by an integer rate per axis."""
    if rate <= 1:
        return values
    nz, ny, nx = values.shape
    pz, py, px = (-nz) % rate, (-ny) % rate, (-nx) % rate
    v = np.pad(values, ((0, pz), (0, py), (0, px)))
    v = v.reshape(v.shape[0] // rate, rate, v.shape[1] // rate, rate,
                  v.shape[2] // rate, rate)
    return v.mean(axis=(1, 3, 5))


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    import argparse
    ap = argparse.ArgumentParser(prog="nanovdb2pbrt")
    ap.add_argument("infile")
    ap.add_argument("--grid", default="density")
    ap.add_argument("--downsample", type=int, default=0)
    ap.add_argument("--npz", default=None,
                    help="write a dense .npz (density, p0, p1) instead of "
                         "printing pbrt parameters")
    args = ap.parse_args(argv)

    g = read_nanovdb(args.infile, args.grid)
    vals = downsample(g.values, args.downsample) if args.downsample > 1 \
        else g.values
    (wx0, wy0, wz0), (wx1, wy1, wz1) = g.world_bbox
    if args.npz:
        np.savez_compressed(args.npz, density=vals.astype(np.float32),
                            p0=np.asarray([wx0, wy0, wz0], np.float32),
                            p1=np.asarray([wx1, wy1, wz1], np.float32))
        print(f"wrote {args.npz}: {vals.shape[::-1]} voxels", file=sys.stderr)
        return 0
    nz, ny, nx = vals.shape
    print(f'"integer nx" {nx} "integer ny" {ny}  "integer nz" {nz}')
    print(f'\t"point3 p0" [ {wx0:f} {wy0:f} {wz0:f} ] '
          f'"point3 p1" [ {wx1:f} {wy1:f} {wz1:f} ]')
    print(f'\t"float {args.grid}" [')
    flat = vals.reshape(-1)
    out = []
    for i, d in enumerate(flat):
        out.append("0" if d == 0 else f"{d:f}")
        if (i % 20) == 19:
            out.append("\n")
        else:
            out.append(" ")
    sys.stdout.write("".join(out))
    print("]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
