#!/usr/bin/env python3
"""Golden-image gate: render scenes with pbrt_jax and compare against
committed reference-pbrt CPU renders (goldens/*.exr) at matched spp.
ALL goldens are reference-oracle renders (recipe: goldens/README.md).

The oracle images were rendered by the reference binary built from
/root/reference (CPU-only, see BASELINE.md). Because both images are
independent Monte Carlo estimates at the same spp, the gate bounds the
MRSE (relative MSE, imgtool.cpp:1101) and the mean-luminance ratio rather
than demanding pixel equality.

Usage: python tools/golden.py [--spp N] [--update-out DIR]
Exits non-zero on regression. One line of JSON per scene.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def mrse(img, ref, trim=0.0):
    """Relative MSE (imgtool.cpp:1101). trim: drop this fraction of the
    largest per-pixel errors first — specular-caustic scenes at matched
    low spp put fireflies in DIFFERENT pixels in the two independent
    renders, and a handful of 30x-radiance sparkles otherwise dominates
    an image-wide mean (the reference's own MSE tooling deals with the
    same issue by comparing against long converged references)."""
    import numpy as np
    d = (img - ref)
    e = (d * d / (ref * ref + 0.01)).mean(axis=-1).reshape(-1)
    if trim > 0:
        k = max(1, int(len(e) * (1.0 - trim)))
        e = np.sort(e)[:k]
    return float(e.mean())


def mse(img, ref):
    import numpy as np
    d = img - ref
    return float((d * d).mean())


CONFIGS = [
    # name, golden file, spp, max_depth, mrse gate, mean-ratio gate
    # ALL goldens are REFERENCE-ORACLE renders by the reference binary
    # (tools/refbuild/build_reference.sh; commands in goldens/README.md).
    # cornell is built through the Python scene API; the others parse the
    # same generated .pbrt files (tools/gen_golden_scenes.py) the oracle
    # rendered, so both renderers consume byte-identical scene data.
    ("cornell", "cornell_400_64spp.exr", 64, 5, 0.08, 0.02),
    ("meshfield", "meshfield_200_32spp.exr", 32, 4, 0.05, 0.02),
    ("instances", "instances_200_32spp.exr", 32, 3, 0.05, 0.02),
    ("envlit", "envlit_200_64spp.exr", 64, 5, 0.06, 0.02),
    ("volume", "volume_200_32spp.exr", 32, 6, 0.10, 0.03),
    ("patches", "patches_200_32spp.exr", 32, 3, 0.05, 0.02),
    # round 4 (VERDICT r3 #6): many-light (1152 emissive tris, light-BVH
    # sampler) and killeroo-class asset mix (PLY mesh + conductor +
    # dielectric + PNG image texture)
    ("manylight", "manylight_200_32spp.exr", 32, 3, 0.08, 0.03),
    # plytex: trimmed MRSE (0.2% hottest pixels dropped) — the conductor/
    # dielectric caustics put fireflies in different pixels per realization
    ("plytex", "plytex_200_64spp.exr", 64, 5, 0.05, 0.03, 0.002),
    # round 5 (VERDICT r4 #4): BASELINE scale points — 16,928 emissive
    # triangles through the light BVH (zero-day-class many-light regime),
    # and a window-portal-lit interior (PortalImageInfiniteLight role)
    # whose AOV/GBuffer pass is sanity-gated below
    ("manylight16k", "manylight16k_200_32spp.exr", 32, 3, 0.08, 0.03),
    ("portalbox", "portalbox_200_64spp.exr", 64, 5, 0.10, 0.04),
    # killeroo-class scale point (BASELINE config 2): 163,840 PLY
    # triangles in one flat BVH; trimmed MRSE for the conductor/dielectric
    # fireflies (same rationale as plytex)
    ("killeroo", "killeroo_200_32spp.exr", 32, 5, 0.06, 0.03, 0.002),
]


def gbuffer_check(name):
    """GBuffer AOV pass on a golden scene (reference GBufferFilm,
    film.h:319): unit shading normals at hits, positive depth, albedo in
    [0,1]. Returns (ok, dict of stats)."""
    import numpy as np
    from pbrt_jax.scene import parser as pparser
    from pbrt_jax.integrators import aov
    desc = pparser.parse_file(ROOT / "scenes" / f"{name}.pbrt")
    out = aov.render_aovs(desc.scene, desc.camera, spp=1)
    ns = out["ns"].reshape(-1, 3)
    z = out["z"].reshape(-1)
    alb = out["albedo"].reshape(-1, 3)
    hit = z > 0
    nlen = np.linalg.norm(ns[hit], axis=1)
    stats = dict(hit_frac=round(float(hit.mean()), 4),
                 ns_len_err=round(float(np.abs(nlen - 1.0).max()), 5),
                 albedo_min=round(float(alb.min()), 4),
                 albedo_max=round(float(alb.max()), 4))
    ok = (hit.mean() > 0.5 and float(np.abs(nlen - 1.0).max()) < 1e-3
          and alb.min() >= -1e-6 and alb.max() <= 1.0 + 1e-6
          and np.isfinite(out["p"]).all())
    return bool(ok), stats


def render_config(name, spp, max_depth):
    from pbrt_jax import scenes
    from pbrt_jax import samplers as smp
    from pbrt_jax.integrators import render as rdr
    from pbrt_jax.integrators.path import PathOptions
    import numpy as np
    if name == "cornell":
        scene, cam = scenes.make_cornell_box(width=400, height=400)
        sampler = smp.make_sampler("zsobol", spp=spp,
                                   full_resolution=(cam.width, cam.height))
    else:
        from pbrt_jax.scene import parser as pparser
        desc = pparser.parse_file(ROOT / "scenes" / f"{name}.pbrt")
        scene, cam = desc.scene, desc.camera
        sampler = desc.sampler
        assert sampler.spp == spp, f"{name}: scene spp {sampler.spp} != {spp}"
    img, stats = rdr.render(scene, cam, spp=spp, sampler=sampler,
                            opts=PathOptions(max_depth=max_depth))
    return np.asarray(img), stats


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None,
                    help="write rendered images to this dir")
    ap.add_argument("--scene", default=None,
                    help="only run this scene (comma-separated names)")
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend")
    args = ap.parse_args()
    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")
    from pbrt_jax.utils.compile_cache import setup_compile_cache
    setup_compile_cache()
    from pbrt_jax.utils import image as pimg
    import numpy as np
    failed = False
    only = set(args.scene.split(",")) if args.scene else None
    for cfg in CONFIGS:
        name, golden, spp, max_depth, gate_mrse, gate_mean = cfg[:6]
        if only is not None and name not in only:
            continue
        trim = cfg[6] if len(cfg) > 6 else 0.0
        gpath = ROOT / "goldens" / golden
        if not gpath.exists():
            print(json.dumps(dict(scene=name, skipped="no golden")))
            continue
        ref = pimg.read_exr(gpath)
        img, stats = render_config(name, spp, max_depth)
        m = mrse(img, ref, trim=trim)
        mean_ratio = float(abs(img.mean() / max(float(ref.mean()), 1e-9)
                               - 1.0))
        ok = (m <= gate_mrse) and (mean_ratio <= gate_mean)
        failed |= not ok
        print(json.dumps(dict(
            scene=name, spp=spp, mrse=round(m, 5), mse=round(mse(img, ref), 6),
            mean_ratio_err=round(mean_ratio, 5),
            paths_per_sec=round(stats["paths_per_sec"]),
            ok=bool(ok))))
        if args.out:
            outdir = Path(args.out)
            outdir.mkdir(parents=True, exist_ok=True)
            pimg.write_exr(outdir / f"{name}_{spp}spp.exr", img)
        if name == "portalbox":
            gok, gstats = gbuffer_check(name)
            failed |= not gok
            print(json.dumps(dict(scene="portalbox_gbuffer", ok=gok,
                                  **gstats)))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
