"""pbrt_jax renderer CLI (reference cmd/pbrt.cpp:105).

Usage: python -m pbrt_jax.cmd.main scene.pbrt [--outfile out.exr] [--spp N]
       [--maxdepth N] [--resolution WxH] [--cpu] [--stats] [--quiet]
       [--log-level LEVEL] [--log-file F] [--checkpoint F] [--seed N]
       [--pixelbounds X0,X1,Y0,Y1] [--mse-reference-image F]
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None):
    """CLI entry: the crash-context scene scope wraps the real driver so
    the registry never leaks into long-lived embedding processes."""
    from ..utils.check import CheckCallbackScope
    scene_name = [None]
    with CheckCallbackScope("scene", lambda: scene_name[0] or "<args>"):
        return _main(argv, scene_name)


def _main(argv=None, scene_name=None):
    ap = argparse.ArgumentParser(prog="pbrt_jax",
                                 description="spectral path tracer")
    ap.add_argument("scene", help=".pbrt scene file")
    ap.add_argument("--outfile", default=None, help="override Film filename")
    ap.add_argument("--spp", type=int, default=None, help="override samples/pixel")
    ap.add_argument("--maxdepth", type=int, default=None)
    ap.add_argument("--resolution", default=None, help="WxH override")
    ap.add_argument("--cpu", action="store_true", help="force CPU backend")
    ap.add_argument("--stats", action="store_true",
                    help="print render statistics report")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--png", action="store_true", help="also write .png preview")
    ap.add_argument("--seed", type=int, default=0, help="sampler seed")
    ap.add_argument("--log-level", default="warning",
                    help="error|warning|info|verbose (reference --log-level)")
    ap.add_argument("--log-file", default=None,
                    help="write log output to a file")
    ap.add_argument("--checkpoint", default=None,
                    help="film checkpoint file: resume if it exists, save "
                         "every --checkpoint-every waves")
    ap.add_argument("--checkpoint-every", type=int, default=8)
    ap.add_argument("--display-server", default=None,
                    help="host[:port] of a running tev viewer "
                         "(reference --display-server)")
    ap.add_argument("--mse-reference-image", default=None,
                    help="compute MSE vs this EXR after rendering "
                         "(reference --mse-reference-image)")
    ap.add_argument("--mse-reference-out", default=None,
                    help="record per-wave 'spp mse' lines vs the reference "
                         "image (reference --mse-reference-out)")
    ap.add_argument("--write-partial-images", action="store_true",
                    help="write the in-progress EXR every "
                         "--checkpoint-every waves (reference "
                         "--write-partial-images)")
    ap.add_argument("--chips", type=int, default=0,
                    help="shard pixels over this many devices "
                         "(0 = single device; parallel/mesh.py DP)")
    ap.add_argument("--pixelstats", action="store_true",
                    help="write per-pixel statistic images (variance, "
                         "relative variance, samples; reference "
                         "--pixelstats)")
    ap.add_argument("--format", action="store_true",
                    help="re-emit the scene canonically formatted and exit "
                         "(reference --format)")
    ap.add_argument("--upgrade", action="store_true",
                    help="re-emit the scene upgraded from pbrt-v3 syntax "
                         "and exit (reference --upgrade)")
    ap.add_argument("--toply", action="store_true",
                    help="with --format/--upgrade: extract large triangle "
                         "meshes to .ply files (reference --toply)")
    args = ap.parse_args(argv)

    if args.format or args.upgrade or args.toply:
        from ..scene.format import format_file
        f = format_file(args.scene,
                        out=open(args.outfile, "w") if args.outfile else None,
                        upgrade=args.upgrade, toply=args.toply)
        return 1 if f.warnings else 0

    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")
    from ..utils.compile_cache import setup_compile_cache
    setup_compile_cache()

    from ..utils import log
    from ..utils.check import install_crash_handler
    install_crash_handler()
    if scene_name is not None:
        scene_name[0] = getattr(args, "scene", None)
    log.set_log_level(args.log_level)
    if args.log_file:
        log.set_log_file(args.log_file)

    from ..scene import parser as pparser
    from ..integrators import render as rdr
    from ..integrators.path import PathOptions
    from .. import samplers as smp
    from ..utils import image as pimg
    from ..utils.stats import StatsAccumulator

    t0 = time.time()
    desc = pparser.parse_file(args.scene)
    log.info("parsed + compiled scene in %.2fs (%d triangles, %d lights)",
             time.time() - t0, desc.scene.tri_p0.shape[0],
             desc.scene.lights.packed.shape[0])

    if desc.integrator.get("name") == "function":
        # sampler-convergence mode, no rendering (integrators.h:481)
        from ..integrators import function as fnint
        rows, avg = fnint.run(
            function=desc.integrator.get("function", "step"),
            sampler=smp.kind_name(desc.sampler),
            spp=args.spp or desc.sampler.spp,
            resolution=(desc.film_params["xres"], desc.film_params["yres"]))
        text = "".join(f"{n} {mse:f}\n" for n, mse in rows)
        outname = desc.integrator.get("filename") or \
            f"{desc.integrator.get('function', 'step')}-mse.txt"
        with open(outname, "w") as f:
            f.write(text)
        log.info("function integrator: wrote %s (avg estimate %.5f)",
                 outname, avg)
        return 0

    cam = desc.camera
    if args.resolution:
        w, h = map(int, args.resolution.lower().split("x"))
        cam = cam.replace(width=w, height=h)
        desc.film_params["xres"], desc.film_params["yres"] = w, h
    sampler = desc.sampler
    if args.spp or args.seed:
        sampler = smp.make_sampler("zsobol",
                                   spp=args.spp or sampler.spp,
                                   seed=args.seed,
                                   full_resolution=(cam.width, cam.height))
    opts = PathOptions(max_depth=args.maxdepth or desc.integrator["max_depth"])

    acc = StatsAccumulator() if args.stats else None
    display = None
    if args.display_server:
        from ..utils.display import DisplayServer
        hp = args.display_server.split(":")
        display = DisplayServer(hp[0], int(hp[1]) if len(hp) > 1 else 14158)
        if not display.connected:
            log.warning("could not connect to display server %s",
                        args.display_server)
    if args.chips > 0:
        import jax
        from ..parallel import mesh as pmesh
        devs = jax.devices()
        if len(devs) < args.chips:
            log.error("--chips %d but only %d devices visible",
                      args.chips, len(devs))
            return 1
        mesh = pmesh.make_mesh(devs[:args.chips])
        img, stats = pmesh.render_multichip(desc.scene, cam,
                                            sampler=sampler, opts=opts,
                                            mesh=mesh)
    else:
        integ = desc.integrator.get("name")
        integ = integ if integ in ("ao", "ambientocclusion", "lightpath",
                                   "bdpt", "simplepath", "randomwalk",
                                   "mlt", "sppm", "simplevolpath") else None
        img, stats = rdr.render(desc.scene, cam, sampler=sampler, opts=opts,
                                progress=not args.quiet, stats=acc,
                                checkpoint_path=args.checkpoint,
                                checkpoint_every=args.checkpoint_every,
                                display=display, integrator=integ,
                                return_film=args.pixelstats,
                                mse_reference=(pimg.read_exr(
                                    args.mse_reference_image)
                                    if args.mse_reference_image
                                    and args.mse_reference_out else None),
                                mse_reference_out=args.mse_reference_out,
                                partial_image_path=(
                                    (args.outfile
                                     or desc.film_params["filename"])
                                    if args.write_partial_images else None))
    if args.pixelstats and "film" in stats:
        from ..utils.stats import PixelStats
        from .. import film as film_mod
        fl = stats.pop("film")
        pstats = PixelStats(cam.width, cam.height)
        pstats.set_image("variance", film_mod.get_variance_image(fl))
        pstats.set_image("relative_variance",
                         film_mod.get_relative_variance_image(fl))
        import numpy as _np
        pstats.set_image("samples", _np.asarray(fl.n_samples))
        base = (args.outfile or desc.film_params["filename"]).rsplit(".", 1)[0]
        for pth in pstats.write(base):
            log.info("wrote %s", pth)
    stats.pop("film", None)
    out = args.outfile or desc.film_params["filename"]
    if out.endswith(".pfm"):
        pimg.write_pfm(out, img)
    elif out.endswith(".png"):
        from ..utils.color import linear_to_srgb
        import jax.numpy as jnp
        import numpy as np
        pimg.write_png(out, np.asarray(linear_to_srgb(jnp.asarray(img))))
    else:
        pimg.write_exr(out, img)
    if args.png and not out.endswith(".png"):
        from ..utils.color import linear_to_srgb
        import jax.numpy as jnp
        import numpy as np
        pimg.write_png(out.rsplit(".", 1)[0] + ".png",
                       np.asarray(linear_to_srgb(jnp.asarray(img))))
    log.info("wrote %s", out)
    if args.mse_reference_image:
        import numpy as np
        ref = pimg.read_exr(args.mse_reference_image)
        if ref.shape == img.shape:
            mse = float(np.mean((np.asarray(img) - ref) ** 2))
            print(json.dumps({"mse": mse, "spp": stats["spp"]}))
        else:
            log.error("MSE reference resolution %s != render %s",
                      ref.shape, img.shape)
    if args.stats:
        acc.count("render/paths", int(stats["paths_per_sec"] * stats["seconds"]))
        print(acc.report())
        print(json.dumps(stats))
    return 0


if __name__ == "__main__":
    sys.exit(main())
