"""CyHair (.hair) to .pbrt curve converter.

Role model: the reference's standalone ``cyhair2pbrt`` tool
(/root/reference/src/pbrt/cmd/cyhair2pbrt.cpp:406): hair vertices are
Catmull-Rom spline control points; each spline segment is converted to a
cubic Bezier and emitted as a ``Shape "curve" "string type" ["cylinder"]``.

The CyHair binary format (Cem Yuksel's public hair model format):
  128-byte header:
    magic "HAIR" | u32 num_strands | u32 total_points | u32 flags
    | u32 default_segments | f32 default_thickness | f32 default_transparency
    | 3x f32 default_color | 88-byte info string
  then optional arrays by flags bit:
    0x1 segments (u16 x num_strands), 0x2 points (f32 x 3 x total_points),
    0x4 thickness (f32 x total_points), 0x8 transparency, 0x10 color.

Usage:
  python -m pbrt_jax.cmd.cyhair2pbrt input.hair output.pbrt [max_strands] [thickness]
"""
from __future__ import annotations

import struct
import sys

import numpy as np


def load_cyhair(path):
    """Read a .hair file -> (list of (n_pts, 3) strand arrays, default_thickness)."""
    with open(path, "rb") as f:
        header = f.read(128)
        if len(header) != 128 or header[:4] != b"HAIR":
            raise ValueError(f"{path}: not a CyHair file")
        (num_strands, total_points, flags, default_segments,
         default_thickness, _transparency) = struct.unpack_from("<IIIIff", header, 4)
        has_segments = bool(flags & 0x1)
        has_points = bool(flags & 0x2)
        # thickness/transparency/color arrays are skipped (the reference
        # converter ignores per-point thickness too, cyhair2pbrt.cpp:381)
        if not has_points:
            raise ValueError(f"{path}: no points array")
        if not has_segments and default_segments < 1:
            raise ValueError(f"{path}: no segment counts and no default")
        if has_segments:
            segments = np.fromfile(f, dtype="<u2", count=num_strands).astype(np.int64)
        else:
            segments = np.full(num_strands, default_segments, np.int64)
        pts = np.fromfile(f, dtype="<f4", count=3 * total_points).reshape(-1, 3)
    counts = segments + 1
    offsets = np.concatenate([[0], np.cumsum(counts)])
    if offsets[-1] != total_points:
        raise ValueError(f"{path}: segment counts inconsistent with points "
                         f"({offsets[-1]} vs {total_points})")
    strands = [pts[offsets[i]:offsets[i + 1]] for i in range(num_strands)]
    return strands, float(default_thickness)


def catmullrom_strand_to_beziers(cps):
    """(n, 3) Catmull-Rom control points -> (n-1, 4, 3) cubic Bezier segments.

    Interior segments use the uniform Catmull-Rom tangent (p[i+1]-p[i-1])/6;
    the first/last segments use one-sided differences (the toC2B0/toC2B1
    endpoint rules); a 2-point strand degenerates to a straight line.
    """
    cps = np.asarray(cps, np.float64)
    n = len(cps)
    if n < 2:
        return np.zeros((0, 4, 3))
    if n == 2:
        seg = np.stack([cps[0], (2 * cps[0] + cps[1]) / 3,
                        (cps[0] + 2 * cps[1]) / 3, cps[1]])
        return seg[None]
    p0, p1 = cps[:-1], cps[1:]
    # tangents at each control point (one-sided at the ends)
    tan = np.empty_like(cps)
    tan[1:-1] = (cps[2:] - cps[:-2]) / 6.0
    tan[0] = (-3 * cps[0] + 4 * cps[1] - cps[2]) / 6.0
    tan[-1] = (3 * cps[-1] - 4 * cps[-2] + cps[-3]) / 6.0
    q = np.stack([p0, p0 + tan[:-1], p1 - tan[1:], p1], axis=1)
    return q


def convert(in_path, out, max_strands=-1, user_thickness=1.0):
    """Convert; ``out`` is a writable text file object. Returns #curves."""
    strands, default_thickness = load_cyhair(in_path)
    if max_strands > 0:
        strands = strands[:max_strands]
    thickness = user_thickness if user_thickness > 0 else default_thickness

    all_segs = [catmullrom_strand_to_beziers(s) for s in strands]
    segs = np.concatenate([s for s in all_segs if len(s)], axis=0) \
        if any(len(s) for s in all_segs) else np.zeros((0, 4, 3))
    lo = (segs - thickness).reshape(-1, 3).min(axis=0) if len(segs) else np.zeros(3)
    hi = (segs + thickness).reshape(-1, 3).max(axis=0) if len(segs) else np.zeros(3)

    out.write(f'# Converted from "{in_path}" by cyhair2pbrt\n')
    out.write(f"# The number of strands = {len(strands)}. "
              f"user_thickness = {thickness:f}\n")
    out.write(f"# Scene bounds: ({lo[0]:f}, {lo[1]:f}, {lo[2]:f}) - "
              f"({hi[0]:f}, {hi[1]:f}, {hi[2]:f})\n\n\n")
    for q in segs:
        pts = " ".join(f"{v:f}" for v in q.reshape(-1))
        out.write(f'Shape "curve" "string type" [ "cylinder" ] '
                  f'"point3 P" [ {pts} ] '
                  f'"float width0" [ {thickness:f} ] '
                  f'"float width1" [ {thickness:f} ]\n')
    return len(segs)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2 or argv[0] in ("-h", "--help"):
        print("usage: cyhair2pbrt <input.hair> <output.pbrt|-> "
              "(max strands) (thickness)", file=sys.stderr)
        return 1
    max_strands = int(argv[2]) if len(argv) > 2 else -1
    thickness = float(argv[3]) if len(argv) > 3 else 1.0
    out = sys.stdout if argv[1] == "-" else open(argv[1], "w")
    try:
        n = convert(argv[0], out, max_strands, thickness)
    finally:
        if out is not sys.stdout:
            out.close()
    print(f"wrote {n} curves", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
