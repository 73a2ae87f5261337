#!/usr/bin/env python3
"""Benchmark: path-tracing throughput on the attached GPU.

    python bench.py          # needs a GPU; exits non-zero without one
    python bench.py --cpu    # explicit CPU run (numbers are not GPU numbers)

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "device",
...extras}; "device" holds platform, device_kind, device count and the
card's name and power limit. Any phase that fails fails the run.

Primary metric: cornell 400x400x64spp depth 5 (scenes/cornell.pbrt ==
make_cornell_box) wavefront paths/s.  Baseline (MEASURED, BASELINE.md): the
reference pbrt-v4 built CPU-only renders this scene at 139,121 paths/s on
one core of this machine; the 64-core baseline is the linear extrapolation
8.90 Mpaths/s.  vs_baseline = value / 8.903751e6.

Secondary metric (VERDICT r2 #10: "extend the bench matrix"): the
meshfield golden scene (~20k-triangle BVH path, scenes/meshfield.pbrt) at
200x200x32spp, reported as extras.mesh_paths_per_sec.
"""
import argparse
import json
import os
import subprocess
import sys
import time


def device_record(cpu):
    """platform, device_kind, count and (on a GPU) the card's name and power
    limit; exits 2 when a GPU run finds no GPU."""
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu" and not cpu:
        print("bench.py: no GPU found (pass --cpu for a CPU run)",
              file=sys.stderr)
        sys.exit(2)
    rec = dict(platform=devs[0].platform, device_kind=devs[0].device_kind,
               count=len(devs))
    if devs[0].platform == "gpu":
        rec["cards"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU backend instead of a GPU")
    args = ap.parse_args(argv)
    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")
    device = device_record(args.cpu)
    from pbrt_jax.utils.compile_cache import setup_compile_cache
    setup_compile_cache()
    import jax
    from pbrt_jax import scenes
    from pbrt_jax import samplers as smp
    from pbrt_jax.integrators import render as rdr
    from pbrt_jax.integrators.path import PathOptions

    t_start = time.time()

    def budget_left(extras, label, limit_s=1500):
        """Skip optional extras once the run gets long — the driver
        records NOTHING if bench.py is killed before the JSON line."""
        if time.time() - t_start > limit_s:
            extras[f"{label}_skipped"] = "bench time budget"
            return False
        return True

    width = height = 400
    spp = 64
    scene, cam = scenes.make_cornell_box(width=width, height=height)
    sampler = smp.make_sampler("zsobol", spp=spp, full_resolution=(width, height))
    opts = PathOptions(max_depth=5)

    # warmup (compile) with the IDENTICAL static config as the timed run:
    # 32 waves picks the same (m, k) static pair as the full 64-spp loop
    # (m divides 32 and 64 equally for every m the driver can choose)
    rdr.render(scene, cam, sampler=sampler, opts=opts, max_waves=32)
    # timed run
    img, stats = rdr.render(scene, cam, spp=spp, sampler=sampler, opts=opts)
    value = stats["paths_per_sec"]
    baseline = 8.903751e6  # measured 64-core-extrapolated reference (BASELINE.md)

    # --- secondary: meshfield (~20k-tri BVH scene) ------------------------
    extras = {}
    from pbrt_jax.scene import parser as pparser
    desc = pparser.parse_file("scenes/meshfield.pbrt")
    msampler = smp.make_sampler("zsobol", spp=32,
                                full_resolution=(200, 200))
    mopts = PathOptions(max_depth=4)
    rdr.render(desc.scene, desc.camera, sampler=msampler, opts=mopts,
               max_waves=32)
    _img, mstats = rdr.render(desc.scene, desc.camera, spp=32,
                              sampler=msampler, opts=mopts)
    extras["mesh_paths_per_sec"] = mstats["paths_per_sec"]
    extras["mesh_scene"] = "meshfield 200x200x32spp ~20k tris"

    # --- 1080p time-to-64spp (BASELINE.json config 5 scale point):
    # transparent-machines-class frame — layered (coated) + subsurface +
    # smooth/rough dielectric + conductor meshes, full wavefront pipeline
    w1, h1 = 1920, 1080
    scene1, cam1 = scenes.make_machines_frame(width=w1, height=h1)
    s1 = smp.make_sampler("zsobol", spp=64, full_resolution=(w1, h1))
    o1 = PathOptions(max_depth=5)
    rdr.render(scene1, cam1, sampler=s1, opts=o1, max_waves=8)
    _img, st1 = rdr.render(scene1, cam1, spp=64, sampler=s1, opts=o1)
    extras["time_to_64spp_1080p_s"] = round(st1["seconds"], 3)
    extras["paths_per_sec_1080p"] = st1["paths_per_sec"]
    extras["scene_1080p"] = "machines-frame (coated+subsurface+dielectric+conductor)"

    # --- compaction A/B on meshfield ------------------------------------
    if budget_left(extras, "compaction_ab"):
        for label, comp in (("on", True), ("off", False)):
            oc = PathOptions(max_depth=4, compaction=comp)
            rdr.render(desc.scene, desc.camera, sampler=msampler,
                       opts=oc, max_waves=32)
            _i, cst = rdr.render(desc.scene, desc.camera, spp=32,
                                 sampler=msampler, opts=oc)
            extras[f"compaction_{label}_paths_per_sec"] = round(
                cst["paths_per_sec"])

    # --- per-stage ms table (separately jitted stages: upper bounds) -----
    if budget_left(extras, "stage_ms"):
        sys.path.insert(0, os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "tools"))
        import profile_stages as pstages
        rows, info = pstages.collect("cornell", n=160 * 1024, depth=5,
                                     reps=3)
        extras["stage_ms_cornell_160k"] = {k: round(v, 2) for k, v in rows}

    # --- Mrays/s (closest + shadow) on the meshfield BVH ------------------
    import numpy as _np
    import jax.numpy as jnp
    from pbrt_jax import scene_core as sc
    sc_m = desc.scene
    N = 1 << 20
    rng = _np.random.default_rng(0)
    lo = _np.asarray(sc_m.world_lo)
    hi = _np.asarray(sc_m.world_hi)
    o = jnp.asarray(rng.uniform(lo - 1, hi + 1, (N, 3)).astype(_np.float32))
    d = jnp.asarray(rng.normal(size=(N, 3)).astype(_np.float32))
    d = d / jnp.linalg.norm(d, axis=1, keepdims=True)
    tm = jnp.full((N,), 1e30, jnp.float32)

    def pair(o, d, tm):
        r = sc.intersect(sc_m, o, d, tm)
        occ = sc.intersect_p(sc_m, o, d, jnp.full((N,), 30.0))
        return r["t"], occ
    f = jax.jit(pair)
    jax.block_until_ready(f(o, d, tm))
    t0 = time.perf_counter()
    reps = 5
    for _ in range(reps):
        out = f(o, d, tm)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / reps
    extras["mrays_per_sec"] = round(2 * N / dt / 1e6, 2)

    print(json.dumps({"metric": "wavefront_paths_per_sec", "value": value,
                      "unit": "paths/s", "vs_baseline": value / baseline,
                      "device": device, **extras}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
