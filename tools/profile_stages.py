#!/usr/bin/env python3
"""Per-stage timing table for the render pipeline (the reference prints a
per-kernel ms table via cudaEvent pairs, gpu/util.cpp:136-183; here each
stage is jitted separately and timed with block_until_ready).

Numbers are *upper bounds* on fused cost: in the production integrator the
stages are fused into one XLA program, so per-stage dispatch overhead and
lost fusion make the sum exceed the fused wave time. Use this to rank
stages, not to add them.

Usage: python tools/profile_stages.py [--scene cornell|mesh] [--n 1048576]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np


def timeit(fn, *args, reps=5):
    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps * 1e3  # ms


def collect(scene_name="cornell", n=400 * 400, depth=5, reps=5):
    """Per-stage ms rows [(name, ms), ...] — reused by bench.py extras
    (VERDICT r4 #10: emit the per-stage table into BENCH extras)."""
    import types
    args = types.SimpleNamespace(scene=scene_name, n=n, depth=depth)

    from pbrt_jax import scenes, scene_core as sc, samplers as smp
    from pbrt_jax import bxdfs, materials as mtl, lights as lgt
    from pbrt_jax import lightsamplers as lsamp, cameras as cam_mod
    from pbrt_jax import filters as flt, film as film_mod
    from pbrt_jax.integrators import path as path_mod, render as rdr
    from pbrt_jax.utils import spectrum as spc

    N = args.n
    if args.scene == "cornell":
        scene, cam = scenes.make_cornell_box(width=400, height=400)
    elif args.scene == "mesh":
        # the SAME scene as the bench secondary metric (scenes/meshfield.pbrt)
        from pbrt_jax.scene import parser as pparser
        desc = pparser.parse_file("scenes/meshfield.pbrt")
        scene, cam = desc.scene, desc.camera
    else:
        raise SystemExit(f"unknown scene {args.scene}")

    sampler = smp.make_sampler("zsobol", spp=64, full_resolution=(1024, 1024))
    filt = flt.make_filter("gaussian")
    sensor = film_mod.make_pixel_sensor()
    opts = path_mod.PathOptions(max_depth=args.depth)

    pix = jnp.arange(N, dtype=jnp.int32) % (cam.width * cam.height)
    px = pix % cam.width
    py = pix // cam.width
    sidx = jnp.zeros((N,), jnp.int32)

    # camera rays
    u_pix = smp.sample_pixel_2d(sampler, px, py, sidx, 0)
    u_lens = smp.sample_2d(sampler, px, py, sidx, 3)
    f_off, _w = flt.sample(filt, u_pix)
    p_film = jnp.stack([px + 0.5 + f_off[..., 0], py + 0.5 + f_off[..., 1]], -1)
    o, d, _t = cam_mod.generate_ray(cam, p_film, u_lens,
                                    jnp.zeros((N,), jnp.float32))
    o, d = jax.block_until_ready((o, d))
    tmax = jnp.full((N,), 1e30, jnp.float32)
    u_lam = smp.sample_1d(sampler, px, py, sidx, 5)
    swl = spc.sample_visible_wavelengths(u_lam)
    lam = swl.lam

    rows = []

    def stage(name, fn, *a, **kw):
        ms = timeit(jax.jit(fn), *a, reps=reps, **kw)
        rows.append((name, ms))
        return ms

    # --- intersect stages ---
    stage("intersect_closest", lambda o, d, t: sc.intersect(scene, o, d, t),
          o, d, tmax)
    stage("intersect_shadow", lambda o, d, t: sc.intersect_p(scene, o, d, t),
          o, d, tmax)

    isect = jax.jit(lambda o, d, t: sc.intersect(scene, o, d, t))(o, d, tmax)
    isect = jax.block_until_ready(isect)

    # --- sampler ---
    def draw_dims(px, py, sidx):
        vals = []
        for dim in range(6 + args.depth * 7):
            vals.append(smp.sample_1d(sampler, px, py, sidx, dim))
        return jnp.stack(vals)
    stage("sampler_all_dims", draw_dims, px, py, sidx)

    # --- material/BSDF ---
    from pbrt_jax.utils import vecmath as vm

    def shade_only(isect, swl_lam, u1, u2v):
        mat_res = mtl.resolve_mix(scene.materials, isect["mat"], isect["p"])
        ns = mtl.apply_normal_mapping(scene.materials, scene.textures,
                                      mat_res, isect)
        t1, t2 = vm.coordinate_system(ns)
        wo_local = jnp.stack([vm.dot(isect["wo"], t1), vm.dot(isect["wo"], t2),
                              vm.dot(isect["wo"], ns)], -1)
        bp = mtl.get_bsdf_params(scene.materials, mat_res, swl_lam,
                                 scene.spectra_pool, textures=scene.textures,
                                 uv=isect["uv"], p_world=isect["p"])
        bs = bxdfs.bsdf_sample(bp, wo_local, u1, u2v)
        return bs["f"], bs["pdf"], bs["wi"]
    u1 = smp.sample_1d(sampler, px, py, sidx, 9)
    u2v = smp.sample_2d(sampler, px, py, sidx, 10)
    stage("material+bsdf_sample", shade_only, isect, lam, u1, u2v)

    # --- light sampling (NEE w/o the shadow ray) ---
    def nee_only(isect, swl_lam, u1, u2v):
        li_idx, pmf, _ = lsamp.sample_light(scene.light_sampler, u1,
                                            p=isect["p"])
        li_idx = jnp.maximum(li_idx, 0)
        ls = lgt.sample_li(scene.lights, li_idx, isect["p"], isect["ns"], u2v,
                           swl_lam, scene.spectra_pool, scene.tri_geo,
                           scene.scene_radius, env=scene.env)
        return ls["L"], ls["pdf"], ls["wi"]
    stage("light_sample", nee_only, isect, lam, u1, u2v)

    # --- full fused wave (1 spp over N pixels) ---
    def full_wave(pix, sidx):
        L, swl, fw = path_mod.render_wave(scene, cam, sampler, filt, pix, sidx,
                                          opts)
        return L
    ms_wave = stage(f"FULL_WAVE depth={args.depth}", full_wave, pix, sidx)
    return rows, dict(N=N, scene=args.scene, wave_ms=ms_wave)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="cornell")
    ap.add_argument("--n", type=int, default=400 * 400)
    ap.add_argument("--depth", type=int, default=5)
    args = ap.parse_args()
    import jax
    from pbrt_jax import scenes
    rows, info = collect(args.scene, args.n, args.depth)
    N, ms_wave = info["N"], info["wave_ms"]
    if args.scene == "cornell":
        scene, _cam = scenes.make_cornell_box(width=400, height=400)
    else:
        from pbrt_jax.scene import parser as pparser
        scene = pparser.parse_file("scenes/meshfield.pbrt").scene

    print(f"\ndevice={jax.devices()[0].device_kind}  scene={args.scene}  "
          f"N={N}  traversal={scene.traversal}  T={scene.tri_geo.shape[0]}")
    print(f"{'stage':>28} {'ms':>10} {'Mray/s or Mpath/s':>18}")
    for name, ms in rows:
        print(f"{name:>28} {ms:10.2f} {N / ms / 1e3:18.2f}")
    print(f"\npaths/s (fused wave): {N / ms_wave * 1e3 / 1e6:.3f} M")


if __name__ == "__main__":
    main()
