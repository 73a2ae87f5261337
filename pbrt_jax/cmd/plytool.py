"""PLY mesh utility CLI.

Role model: the reference's ``plytool`` (cmd/plytool.cpp:303) — subcommands
cat / info / displace / split — and ``TriQuadMesh::Displace`` adaptive
refinement (util/mesh.h:92-200).

Usage:
  python -m pbrt_jax.cmd.plytool info mesh.ply [...]
  python -m pbrt_jax.cmd.plytool cat mesh.ply
  python -m pbrt_jax.cmd.plytool displace mesh.ply --image d.exr \\
      --outfile out.ply [--scale S] [--uvscale S] [--edge-length L]
  python -m pbrt_jax.cmd.plytool split mesh.ply [--maxfaces N] [--outbase B]
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from ..scene import plyio


def compute_normals(p, tri):
    """Face-cross-product accumulated vertex normals
    (util/mesh.cpp TriQuadMesh::ComputeNormals)."""
    n = np.zeros_like(p, np.float64)
    e1 = p[tri[:, 1]] - p[tri[:, 0]]
    e2 = p[tri[:, 2]] - p[tri[:, 0]]
    fc = np.cross(e1, e2)
    for k in range(3):
        np.add.at(n, tri[:, k], fc)
    ln = np.linalg.norm(n, axis=1, keepdims=True)
    return (n / np.maximum(ln, 1e-30)).astype(np.float32)


def refine(p, n, uv, tri, max_edge):
    """Adaptively split triangles until every edge is shorter than max_edge,
    sharing split-edge midpoints (TriQuadMesh::Refine, util/mesh.h:128-180).

    Returns (p, n, uv, tri) with appended midpoint vertices.
    """
    p = [np.asarray(v, np.float64) for v in p]
    n = None if n is None else [np.asarray(v, np.float64) for v in n]
    uv = None if uv is None else [np.asarray(v, np.float64) for v in uv]
    edge_split = {}
    out = []
    stack = [tuple(t) for t in reversed(tri.tolist())]
    while stack:
        v0, v1, v2 = stack.pop()
        d01 = np.linalg.norm(p[v0] - p[v1])
        d12 = np.linalg.norm(p[v1] - p[v2])
        d20 = np.linalg.norm(p[v2] - p[v0])
        if d01 < max_edge and d12 < max_edge and d20 < max_edge:
            out.append((v0, v1, v2))
            continue
        # rotate so the longest edge is (a, b)
        if d01 > d12:
            a, b, c = (v0, v1, v2) if d01 > d20 else (v2, v0, v1)
        else:
            a, b, c = (v1, v2, v0) if d12 > d20 else (v2, v0, v1)
        key = (a, b) if a < b else (b, a)
        vmid = edge_split.get(key)
        if vmid is None:
            vmid = len(p)
            edge_split[key] = vmid
            p.append((p[a] + p[b]) / 2.0)
            if n is not None:
                nn = n[a] + n[b]
                l = np.linalg.norm(nn)
                n.append(nn / l if l > 0 else nn)
            if uv is not None:
                uv.append((uv[a] + uv[b]) / 2.0)
        stack.append((vmid, b, c))
        stack.append((a, vmid, c))
    return (np.asarray(p, np.float32),
            None if n is None else np.asarray(n, np.float32),
            None if uv is None else np.asarray(uv, np.float32),
            np.asarray(out, np.int64))


def _bilerp_repeat(img, u, v):
    """Bilinear lookup with repeat wrap, averaged over channels
    (Image::Bilerp WrapMode::Repeat role)."""
    h, w = img.shape[:2]
    x = u * w - 0.5
    y = v * h - 0.5
    x0, y0 = np.floor(x).astype(np.int64), np.floor(y).astype(np.int64)
    fx, fy = x - x0, y - y0
    lum = img.reshape(h, w, -1).mean(axis=-1)
    def at(xi, yi):
        return lum[np.mod(yi, h), np.mod(xi, w)]
    return ((1 - fx) * (1 - fy) * at(x0, y0) + fx * (1 - fy) * at(x0 + 1, y0)
            + (1 - fx) * fy * at(x0, y0 + 1) + fx * fy * at(x0 + 1, y0 + 1))


def displace_mesh(mesh, img, scale=1.0, uvscale=1.0, edge_length=1.0):
    """Refine + displace along normals by the image map
    (plytool.cpp displace:194-209)."""
    if mesh["uvs"] is None:
        raise ValueError("vertex uvs are required by displace")
    p, tri = mesh["vertices"], mesh["indices"]
    nrm = mesh["normals"]
    if nrm is None:
        nrm = compute_normals(np.asarray(p, np.float64), tri)
    p, nrm, uv, tri = refine(p, nrm, mesh["uvs"], tri, edge_length)
    d = _bilerp_repeat(img, uvscale * uv[:, 0], 1.0 - uvscale * uv[:, 1])
    p = p + (d * scale)[:, None] * nrm
    nrm = compute_normals(np.asarray(p, np.float64), tri)
    return dict(vertices=p.astype(np.float32), indices=tri,
                normals=nrm, uvs=uv)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="plytool")
    sub = ap.add_subparsers(dest="cmd", required=True)
    i = sub.add_parser("info")
    i.add_argument("infiles", nargs="+")
    c = sub.add_parser("cat")
    c.add_argument("infile")
    d = sub.add_parser("displace")
    d.add_argument("infile")
    d.add_argument("--image", required=True)
    d.add_argument("--outfile", required=True)
    d.add_argument("--scale", type=float, default=1.0)
    d.add_argument("--uvscale", type=float, default=1.0)
    d.add_argument("--edge-length", type=float, default=1.0)
    s = sub.add_parser("split")
    s.add_argument("infile")
    s.add_argument("--maxfaces", type=int, default=1000000)
    s.add_argument("--outbase", default=None)
    args = ap.parse_args(argv)

    if args.cmd == "info":
        for f in args.infiles:
            m = plyio.read_ply(f)
            print(f"{f}:")
            print(f"\tTriangles: {len(m['indices'])}")
            print(f"\tVertex positions: {len(m['vertices'])}")
            print("\tVertex normals: "
                  f"{0 if m['normals'] is None else len(m['normals'])}")
            print(f"\tVertex uvs: {0 if m['uvs'] is None else len(m['uvs'])}")
            used = np.zeros(len(m["vertices"]), bool)
            used[m["indices"].reshape(-1)] = True
            for vi in np.nonzero(~used)[0]:
                print(f"Notice: vertex {vi} is not used.")
            lo = m["vertices"].min(axis=0)
            hi = m["vertices"].max(axis=0)
            print(f"\tBounding box: [ {lo.tolist()} - {hi.tolist()} ]")
        return 0
    if args.cmd == "cat":
        m = plyio.read_ply(args.infile)
        for t in m["indices"]:
            print(f"Triangle: {t[0]} {t[1]} {t[2]}")
        for i_, v in enumerate(m["vertices"]):
            print(f"Vertex position {i_}: [ {v[0]}, {v[1]}, {v[2]} ]")
        if m["normals"] is not None:
            for i_, v in enumerate(m["normals"]):
                print(f"Vertex normal {i_}: [ {v[0]}, {v[1]}, {v[2]} ]")
        if m["uvs"] is not None:
            for i_, v in enumerate(m["uvs"]):
                print(f"Vertex uv {i_}: [ {v[0]}, {v[1]} ]")
        return 0
    if args.cmd == "displace":
        from . import imgtool
        mesh = plyio.read_ply(args.infile)
        img = imgtool._read(args.image)
        out = displace_mesh(mesh, img, args.scale, args.uvscale,
                            args.edge_length)
        plyio.write_ply(args.outfile, out["vertices"], out["indices"],
                        normals=out["normals"], uvs=out["uvs"])
        return 0
    if args.cmd == "split":
        m = plyio.read_ply(args.infile)
        nfaces = len(m["indices"])
        if nfaces <= args.maxfaces:
            print(f"{args.infile}: mesh has {nfaces} faces and so has not "
                  "been split up.", file=sys.stderr)
            return 0
        base = args.outbase or args.infile.rsplit(".", 1)[0]
        nmeshes = (nfaces + args.maxfaces - 1) // args.maxfaces
        for k in range(nmeshes):
            tri = m["indices"][k * args.maxfaces:(k + 1) * args.maxfaces]
            # compact vertices used by this chunk
            uniq, inv = np.unique(tri.reshape(-1), return_inverse=True)
            plyio.write_ply(
                f"{base}-{k}.ply", m["vertices"][uniq], inv.reshape(-1, 3),
                normals=None if m["normals"] is None else m["normals"][uniq],
                uvs=None if m["uvs"] is None else m["uvs"][uniq])
        print(f"{args.infile}: split into {nmeshes} meshes.", file=sys.stderr)
        return 0
    return 1


if __name__ == "__main__":
    sys.exit(main())
