"""Image utility CLI (reference cmd/imgtool.cpp:57-249 subcommand set).

Usage:
  python -m pbrt_jax.cmd.imgtool diff a.exr b.exr [--metric mse|mae|mrse|flip]
  python -m pbrt_jax.cmd.imgtool convert in.exr out.png [--tonemap] [--scale S]
  python -m pbrt_jax.cmd.imgtool info img.exr
  python -m pbrt_jax.cmd.imgtool makeequiarea latlong.exr out.exr [--res N]
  python -m pbrt_jax.cmd.imgtool average *.exr --outfile avg.exr
  python -m pbrt_jax.cmd.imgtool falsecolor img.exr out.png [--max M]
  python -m pbrt_jax.cmd.imgtool error noisy.exr --reference ref.exr
  python -m pbrt_jax.cmd.imgtool assemble crop*.exr --outfile full.exr
  python -m pbrt_jax.cmd.imgtool denoise gbuffer.exr --outfile out.exr
  python -m pbrt_jax.cmd.imgtool bloom in.exr --outfile out.exr --level L
  python -m pbrt_jax.cmd.imgtool cat img.exr [--csv|--sort|--list]
  python -m pbrt_jax.cmd.imgtool makesky --outfile sky.exr [--elevation E]
      [--turbidity T] [--albedo A] [--resolution N]
  python -m pbrt_jax.cmd.imgtool makeemitters img.exr [--downsample N]
  python -m pbrt_jax.cmd.imgtool splitn a.exr b.exr --outfile cmp.exr
      [--crop x,y --cropsize N]
  python -m pbrt_jax.cmd.imgtool scalenormalmap n.exr --outfile out.exr
      [--scale S]
  python -m pbrt_jax.cmd.imgtool whitebalance in.exr --outfile out.exr
      (--illuminant A|D50|D65|F1..F12 | --temperature K | --primaries x,y)
Formats: .exr (multi-channel), .png, .pfm, .qoi.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _read(path):
    from ..utils import image as pimg
    p = str(path)
    if p.endswith(".exr"):
        return pimg.read_exr(p)
    if p.endswith(".pfm"):
        return pimg.read_pfm(p)
    if p.endswith(".qoi"):
        return pimg.read_qoi(p).astype(np.float32) / 255.0
    img = pimg.read_png(p)
    return img.astype(np.float32) / (65535.0 if img.dtype == np.uint16 else 255.0)


def _write(path, img):
    from ..utils import image as pimg
    p = str(path)
    if p.endswith(".exr"):
        pimg.write_exr(p, img)
    elif p.endswith(".pfm"):
        pimg.write_pfm(p, img)
    elif p.endswith(".qoi"):
        pimg.write_qoi(p, np.clip(img, 0, 1))
    else:
        pimg.write_png(p, np.clip(img, 0, 1))


def main(argv=None):
    ap = argparse.ArgumentParser(prog="imgtool")
    sub = ap.add_subparsers(dest="cmd", required=True)

    d = sub.add_parser("diff")
    d.add_argument("a")
    d.add_argument("b")
    d.add_argument("--metric", default="mse",
                   choices=["mse", "mae", "mrse", "flip"])
    d.add_argument("--ppd", type=float, default=67.0,
                   help="pixels per degree for FLIP")
    d.add_argument("--outfile", default=None, help="write difference image")

    c = sub.add_parser("convert")
    c.add_argument("infile")
    c.add_argument("outfile")
    c.add_argument("--tonemap", action="store_true", help="sRGB transfer")
    c.add_argument("--scale", type=float, default=1.0)

    i = sub.add_parser("info")
    i.add_argument("infile")

    m = sub.add_parser("makeequiarea")
    m.add_argument("infile")
    m.add_argument("outfile")
    m.add_argument("--res", type=int, default=None)

    a = sub.add_parser("average")
    a.add_argument("infiles", nargs="+")
    a.add_argument("--outfile", required=True)

    fc = sub.add_parser("falsecolor",
                        help="viridis-map luminance (imgtool.cpp falsecolor)")
    fc.add_argument("infile")
    fc.add_argument("outfile")
    fc.add_argument("--max", type=float, default=None)
    fc.add_argument("--log", action="store_true")

    er = sub.add_parser("error",
                        help="per-image MSE/MRSE/FLIP vs a reference")
    er.add_argument("infiles", nargs="+")
    er.add_argument("--reference", required=True)

    asm = sub.add_parser("assemble",
                         help="sum partial images (crops rendered "
                              "separately; imgtool.cpp assemble)")
    asm.add_argument("infiles", nargs="+")
    asm.add_argument("--outfile", required=True)

    dn = sub.add_parser("denoise",
                        help="AOV-guided a-trous denoise (role of imgtool "
                             "denoise-optix; input: GBuffer EXR)")
    dn.add_argument("infile")
    dn.add_argument("--outfile", required=True)
    dn.add_argument("--iterations", type=int, default=5)
    dn.add_argument("--sigma-color", type=float, default=4.0)

    bl = sub.add_parser("bloom", help="bloom effect (imgtool.cpp bloom)")
    bl.add_argument("infile")
    bl.add_argument("--outfile", required=True)
    bl.add_argument("--level", type=float, default=float("inf"),
                    help="min RGB value for a pixel to contribute")
    bl.add_argument("--width", type=int, default=15)
    bl.add_argument("--iterations", type=int, default=5)
    bl.add_argument("--scale", type=float, default=0.3)

    ct = sub.add_parser("cat", help="print pixel values (imgtool.cpp cat)")
    ct.add_argument("infiles", nargs="+")
    ct.add_argument("--sort", action="store_true")
    ct.add_argument("--csv", action="store_true")
    ct.add_argument("--list", action="store_true", dest="aslist")

    sky = sub.add_parser("makesky",
                         help="Hosek-Wilkie sky env map (imgtool.cpp makesky)")
    sky.add_argument("--outfile", required=True)
    sky.add_argument("--albedo", type=float, default=0.5)
    sky.add_argument("--turbidity", type=float, default=3.0)
    sky.add_argument("--elevation", type=float, default=10.0,
                     help="solar elevation above the horizon, degrees")
    sky.add_argument("--resolution", type=int, default=2048)

    me = sub.add_parser("makeemitters",
                        help="emit a .pbrt area-light grid from an image "
                             "(imgtool.cpp makeemitters)")
    me.add_argument("infile")
    me.add_argument("--downsample", type=int, default=1)

    sp = sub.add_parser("splitn",
                        help="diagonal split-screen comparison of n images "
                             "(imgtool.cpp splitn)")
    sp.add_argument("infiles", nargs="+")
    sp.add_argument("--outfile", required=True)
    sp.add_argument("--cropsize", type=int, default=96)
    sp.add_argument("--crop", action="append", default=[],
                    help="x,y of a cropsize crop to extract (repeatable)")

    sn = sub.add_parser("scalenormalmap",
                        help="scale tangent-space normal map strength "
                             "(imgtool.cpp scalenormalmap)")
    sn.add_argument("infile")
    sn.add_argument("--outfile", required=True)
    sn.add_argument("--scale", type=float, default=1.0)

    wb = sub.add_parser("whitebalance",
                        help="white-balance via von Kries LMS adaptation "
                             "(imgtool.cpp whitebalance)")
    wb.add_argument("infile")
    wb.add_argument("--outfile", required=True)
    wb.add_argument("--illuminant", default=None,
                    help="named std illuminant, e.g. A, D50, D65, F1..F12")
    wb.add_argument("--temperature", type=float, default=0.0)
    wb.add_argument("--primaries", default=None, help="source white x,y")

    args = ap.parse_args(argv)

    if args.cmd == "diff":
        from ..utils import image as pimg
        ia, ib = _read(args.a), _read(args.b)
        if ia.shape != ib.shape:
            print(f"size mismatch {ia.shape} vs {ib.shape}", file=sys.stderr)
            return 1
        if args.metric == "flip":
            from ..utils.flip import flip
            emap, mean = flip(ia, ib, ppd=args.ppd)
            print(json.dumps({"flip": mean}))
            if args.outfile:
                _write(args.outfile, np.repeat(emap[..., None], 3, -1))
            return 0
        metric = {"mse": pimg.image_mse, "mae": pimg.image_mae,
                  "mrse": pimg.image_mrse}[args.metric]
        print(json.dumps({args.metric: metric(ia, ib)}))
        if args.outfile:
            _write(args.outfile, np.abs(ia - ib))
        return 0
    if args.cmd == "convert":
        img = _read(args.infile) * args.scale
        if args.tonemap:
            import jax
            jax.config.update("jax_platforms", "cpu")
            import jax.numpy as jnp
            from ..utils.color import linear_to_srgb
            img = np.asarray(linear_to_srgb(jnp.asarray(img)))
        _write(args.outfile, img)
        return 0
    if args.cmd == "info":
        img = _read(args.infile)
        print(json.dumps(dict(shape=list(img.shape),
                              min=float(img.min()), max=float(img.max()),
                              mean=float(img.mean()))))
        return 0
    if args.cmd == "makeequiarea":
        import jax
        jax.config.update("jax_platforms", "cpu")
        from ..utils import image_env
        img = _read(args.infile)
        _write(args.outfile, image_env.equalarea_from_latlong(img, args.res))
        return 0
    if args.cmd == "average":
        imgs = [_read(f) for f in args.infiles]
        _write(args.outfile, np.mean(imgs, axis=0))
        return 0
    if args.cmd == "falsecolor":
        img = _read(args.infile)
        lum = img @ np.asarray([0.2126, 0.7152, 0.0722]) \
            if img.ndim == 3 else img
        if args.log:
            lum = np.log2(np.maximum(lum, 1e-12))
        mx = args.max if args.max is not None else float(lum.max())
        t = np.clip(lum / max(mx, 1e-12), 0.0, 1.0)
        # compact viridis-ish ramp
        stops = np.asarray([[0.267, 0.005, 0.329], [0.283, 0.141, 0.458],
                            [0.254, 0.265, 0.530], [0.207, 0.372, 0.553],
                            [0.164, 0.471, 0.558], [0.128, 0.567, 0.551],
                            [0.135, 0.659, 0.518], [0.267, 0.749, 0.441],
                            [0.478, 0.821, 0.318], [0.741, 0.873, 0.150],
                            [0.993, 0.906, 0.144]])
        x = t * (len(stops) - 1)
        i0 = np.clip(x.astype(int), 0, len(stops) - 2)
        f = (x - i0)[..., None]
        out = stops[i0] * (1 - f) + stops[i0 + 1] * f
        _write(args.outfile, out.astype(np.float32))
        return 0
    if args.cmd == "error":
        from ..utils import image as pimg
        from ..utils.flip import flip
        ref = _read(args.reference)
        for f in args.infiles:
            img = _read(f)
            if img.shape != ref.shape:
                print(f"{f}: size mismatch", file=sys.stderr)
                continue
            print(json.dumps({
                "file": f,
                "mse": pimg.image_mse(img, ref),
                "mrse": pimg.image_mrse(img, ref),
                "flip": flip(ref, img)[1]}))
        return 0
    if args.cmd == "assemble":
        total = None
        for f in args.infiles:
            img = _read(f)
            total = img if total is None else total + img
        _write(args.outfile, total)
        return 0
    if args.cmd == "denoise":
        import jax
        jax.config.update("jax_platforms", "cpu")
        from ..denoise import denoise_gbuffer_exr
        denoise_gbuffer_exr(args.infile, args.outfile,
                            iterations=args.iterations,
                            sigma_color=args.sigma_color)
        return 0
    if args.cmd == "bloom":
        return _cmd_bloom(args)
    if args.cmd == "cat":
        return _cmd_cat(args)
    if args.cmd == "makesky":
        from ..utils.skymodel import make_sky_image
        if not (0.0 <= args.albedo <= 1.0):
            print("--albedo must be between 0 and 1", file=sys.stderr)
            return 1
        if not (1.7 <= args.turbidity <= 10.0):
            print("--turbidity must be between 1.7 and 10", file=sys.stderr)
            return 1
        if not (0.0 <= args.elevation <= 90.0):
            print("--elevation must be between 0 and 90", file=sys.stderr)
            return 1
        img = make_sky_image(resolution=args.resolution,
                             elevation_deg=args.elevation,
                             turbidity=args.turbidity, albedo=args.albedo)
        _write(args.outfile, img)
        return 0
    if args.cmd == "makeemitters":
        return _cmd_makeemitters(args)
    if args.cmd == "splitn":
        return _cmd_splitn(args)
    if args.cmd == "scalenormalmap":
        img = _read(args.infile)
        n = 2.0 * img[..., :3] - 1.0
        n[..., 0] *= args.scale
        n[..., 1] *= args.scale
        n[..., 2] = np.sqrt(np.maximum(
            1.0 - n[..., 0] ** 2 - n[..., 1] ** 2, 0.0))
        out = img.copy()
        out[..., :3] = (n + 1.0) / 2.0
        _write(args.outfile, out)
        return 0
    if args.cmd == "whitebalance":
        return _cmd_whitebalance(args)
    return 1


def _gaussian_blur(img, radius, sigma):
    """Separable Gaussian filter with zero-padding edges (role of
    Image::GaussianFilter, util/image.cpp)."""
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-x * x / (2.0 * sigma * sigma))
    k /= k.sum()
    out = np.apply_along_axis(
        lambda row: np.convolve(row, k, mode="same"), 1, img.astype(np.float64))
    out = np.apply_along_axis(
        lambda col: np.convolve(col, k, mode="same"), 0, out)
    return out


def _cmd_bloom(args):
    """Threshold -> iterated Gaussian blur -> scaled add (imgtool.cpp bloom)."""
    img = _read(args.infile)
    width = args.width + (1 - args.width % 2)  # round up to odd
    radius = width // 2
    sigma = radius / 2.0
    over = np.any(img > args.level, axis=-1, keepdims=True)
    if not over.any():
        print(f"No pixels were above bloom threshold {args.level}",
              file=sys.stderr)
        return 1
    thresholded = np.where(over, img, 0.0)
    blurred_sum = np.zeros_like(img, dtype=np.float64)
    cur = thresholded
    for _ in range(args.iterations):
        cur = _gaussian_blur(cur, radius, sigma)
        blurred_sum += cur
    out = img + (args.scale / args.iterations) * blurred_sum
    _write(args.outfile, out.astype(np.float32))
    return 0


def _cmd_cat(args):
    if args.sort and (args.csv or args.aslist):
        print("imgtool: --sort doesn't combine with --csv/--list",
              file=sys.stderr)
        return 1
    for f in args.infiles:
        img = _read(f)
        if img.ndim == 2:
            img = img[..., None]
        h, w, nc = img.shape
        if args.aslist:
            for y in range(h):
                print(" ".join(f"{img[y, x, 0]:f}" for x in range(w)), "")
        elif args.sort:
            flat = img.reshape(-1, nc)
            order = np.argsort(flat.mean(axis=1))
            for i in order:
                y, x = divmod(int(i), w)
                print(f"({x}, {y}): " + ",".join(f"{v:f}" for v in flat[i]))
        else:
            for y in range(h):
                for x in range(w):
                    vals = ",".join(f"{v:f}" for v in img[y, x])
                    print(vals if args.csv else f"({x}, {y}): {vals}")
    return 0


def _cmd_makeemitters(args):
    """Print a .pbrt snippet of one area-light bilinear patch per
    (downsampled) pixel (imgtool.cpp makeemitters:2069)."""
    img = _read(args.infile)
    h, w = img.shape[:2]
    ds = args.downsample
    aspect = w / h
    print("AttributeBegin")
    print('Material "diffuse" "rgb reflectance" [0 0 0]')
    for y in range(0, h, ds):
        for x in range(0, w, ds):
            block = img[y:y + ds, x:x + ds, :3]
            rgb = block.reshape(-1, 3).sum(axis=0) / (ds * ds)
            print(f'AreaLightSource "diffuse" "rgb L" '
                  f'[ {rgb[0]:f} {rgb[1]:f} {rgb[2]:f} ]')
            x0 = aspect * (1 - x / w) - aspect / 2
            x1 = aspect * (1 - min(x + ds, w) / w) - aspect / 2
            y0 = 1 - y / h
            y1 = 1 - min(y + ds, h) / h
            print(f'Shape "bilinear" "point3 P" [ {x0:f} {y0:f} 0 '
                  f'{x1:f} {y0:f} 0 {x0:f} {y1:f} 0 {x1:f} {y1:f} 0 ]')
    print("AttributeEnd")
    return 0


def _cmd_splitn(args):
    """Assemble n images into one with slanted divider bars; optionally
    emit a crops-<outfile> strip of outlined crops (imgtool.cpp splitn)."""
    images = [_read(f) for f in args.infiles]
    if any(im.shape != images[0].shape for im in images):
        print("splitn: image sizes differ", file=sys.stderr)
        return 1
    h, w = images[0].shape[:2]
    n = len(images)
    m, pad = 15.0, 6
    yy = np.arange(h)
    # per-row split columns for each divider (slant ±w/m across the height);
    # fill left-to-right, each image claiming up to its divider bar
    result = images[-1].copy()
    claimed = np.zeros((h, w), bool)
    for im in range(n - 1):
        x1 = ((im + 1) / n * w + (2.0 * (yy / h) - 1.0) * w / -m).astype(int)
        xs = np.arange(w)[None, :]
        mine = (xs < (x1[:, None] - pad // 2)) & ~claimed
        bar = (xs >= (x1[:, None] - pad // 2)) & (xs < (x1[:, None] + pad // 2))
        result = np.where(mine[..., None], images[im], result)
        result = np.where((bar & ~claimed)[..., None], 0.0, result)
        claimed |= mine | bar
    _write(args.outfile, result)

    crops = []
    for c in args.crop:
        cx, cy = (int(v) for v in c.split(","))
        crops.append((cx, cy))
    if crops:
        cs, bw = args.cropsize, 5
        edges = np.asarray([[0.8, .15, .15], [.15, 0.8, .15], [.15, .15, 0.8]])
        xres = (cs + 2 * bw) * n + pad * (n - 1)
        yres = (cs + 2 * bw) * len(crops) + pad * (len(crops) - 1)
        strip = np.ones((yres, xres, 3), np.float32)
        for ci, (cx, cy) in enumerate(crops):
            color = edges[ci % 3]
            for ii, im in enumerate(images):
                y0 = ci * (cs + 2 * bw + pad)
                x0 = ii * (cs + 2 * bw + pad)
                strip[y0:y0 + cs + 2 * bw, x0:x0 + cs + 2 * bw] = color
                strip[y0 + bw:y0 + bw + cs, x0 + bw:x0 + bw + cs] = \
                    im[cy:cy + cs, cx:cx + cs, :3]
        _write("crops-" + args.outfile, strip)
    return 0


def _cmd_whitebalance(args):
    import jax
    jax.config.update("jax_platforms", "cpu")
    from ..utils import color as col
    from ..utils import spectrum as spc
    n_given = sum([args.illuminant is not None, args.temperature > 0,
                   args.primaries is not None])
    if n_given != 1:
        print("provide exactly one of --illuminant, --temperature, "
              "--primaries", file=sys.stderr)
        return 1
    cs = col.srgb()
    if args.illuminant is not None:
        illum = spc.get_named_spectrum("stdillum-" + args.illuminant)
        if illum is None:
            print(f"stdillum-{args.illuminant}: unknown illuminant",
                  file=sys.stderr)
            return 1
        xyz = illum.to_xyz()
        src_xy = (xyz[0] / xyz.sum(), xyz[1] / xyz.sum())
    elif args.temperature > 0:
        xyz = spc.cie_d_illuminant(args.temperature).to_xyz()
        src_xy = (xyz[0] / xyz.sum(), xyz[1] / xyz.sum())
    else:
        src_xy = tuple(float(v) for v in args.primaries.split(","))
    wb = col.white_balance_matrix(src_xy, cs.w_xy)
    cc = cs.rgb_from_xyz @ wb @ cs.xyz_from_rgb
    img = _read(args.infile)
    out = img.copy()
    out[..., :3] = img[..., :3] @ cc.T
    _write(args.outfile, out.astype(np.float32))
    return 0


if __name__ == "__main__":
    sys.exit(main())
