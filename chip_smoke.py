#!/usr/bin/env python3
"""On-device smoke run of the renderer on NVIDIA GPUs.

    python chip_smoke.py             # one GPU, phases 1-7
    python chip_smoke.py --cards 4   # four GPUs: the sharded-render path only

Runs the main path through the entry points users call, at the sizes they
render, in one process. Prints one JSON line per phase (seconds split into
compile and steady state, paths/s, MRSE and mean-ratio error against the
reference-oracle golden, the traversal route), the card's name and power
limit as nvidia-smi reports them, and as the last line

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

It exits non-zero and prints no such line when JAX finds no GPU (there is
no CPU fallback) or when any phase fails.

Phases (one card):
  1 device     GPU devices, card name and power limit, jax/jaxlib versions
  2 cornell    `python -m pbrt_jax.cmd.main scenes/cornell.pbrt` in-process
               (400x400, 64 spp, depth 5), gated against its golden
  3 meshfield  scenes/meshfield.pbrt (~20k triangles, 200x200, 32 spp)
  4 killeroo   scenes/killeroo.pbrt (163,840 PLY triangles, one flat BVH)
  5 instances  scenes/instances.pbrt (two-level traversal, object-space
               transforms at full f32 precision)
  6 traversal  the traversal kernel against the XLA reference on real rays
  7 frame1080  scenes.make_machines_frame(1920, 1080) at 8 spp: finite and
               not black (no golden yet)
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
_FAILED = []


def emit(rec):
    print(json.dumps(rec), flush=True)


def run_phase(name, fn, *args):
    """Run one phase and print its line. A failure is recorded and makes
    the script exit non-zero after the remaining phases have run."""
    t0 = time.perf_counter()
    try:
        rec = dict(phase=name, **fn(*args))
    except Exception as e:  # recorded, never swallowed: exit code is 1
        import traceback
        traceback.print_exc()
        rec = dict(phase=name, ok=False, error=f"{type(e).__name__}: {e}")
    rec["wall_s"] = time.perf_counter() - t0
    if not rec.get("ok", False):
        _FAILED.append(name)
    emit(rec)
    return rec


def require_gpus(n):
    """The GPU devices, or exit 2 (no CPU fallback)."""
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu" or len(devs) < n:
        print(f"chip_smoke: needs {n} GPU device(s); JAX found "
              f"{[d.platform for d in devs]}", file=sys.stderr)
        sys.exit(2)
    return devs[:n]


def card_lines():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


def load_golden_tool():
    """tools/golden.py: the gate table (CONFIGS) and the MRSE metric."""
    spec = importlib.util.spec_from_file_location(
        "golden_tool", ROOT / "tools" / "golden.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


GOLDEN = None


def gate(name, img):
    """MRSE and mean-ratio error against the scene's golden, with the gates
    of tools/golden.py CONFIGS (trimmed MRSE where the table says so)."""
    import numpy as np
    from pbrt_jax.utils import image as pimg
    cfg = next(c for c in GOLDEN.CONFIGS if c[0] == name)
    _, golden, _spp, _depth, gate_mrse, gate_mean = cfg[:6]
    trim = cfg[6] if len(cfg) > 6 else 0.0
    ref = pimg.read_exr(ROOT / "goldens" / golden)
    img = np.asarray(img)
    m = GOLDEN.mrse(img, ref, trim=trim)
    mean_err = float(abs(img.mean() / max(float(ref.mean()), 1e-9) - 1.0))
    return dict(mrse=m, mrse_gate=gate_mrse, trim=trim,
                mean_ratio_err=mean_err, mean_gate=gate_mean,
                ok=bool(np.isfinite(img).all() and m <= gate_mrse
                        and mean_err <= gate_mean))


def timed_render(scene, cam, sampler, depth, warm_waves):
    """Warm up with the same static configuration (same waves per dispatch
    and lane batching), then time the full render."""
    from pbrt_jax.integrators import render as rdr
    from pbrt_jax.integrators.path import PathOptions
    opts = PathOptions(max_depth=depth)
    t0 = time.perf_counter()
    rdr.render(scene, cam, sampler=sampler, opts=opts, max_waves=warm_waves)
    warm_s = time.perf_counter() - t0
    img, st = rdr.render(scene, cam, sampler=sampler, opts=opts)
    return img, dict(compile_and_first_s=warm_s, seconds=st["seconds"],
                     paths_per_sec=st["paths_per_sec"],
                     traversal=scene.traversal)


def phase_device(devs):
    import jax
    import jaxlib
    return dict(ok=True, platform=devs[0].platform,
                kind=devs[0].device_kind, count=len(devs),
                cards=card_lines(), jax=jax.__version__,
                jaxlib=jaxlib.__version__)


def cli_render(scene_file, extra=()):
    """Render through the CLI entry point in-process; returns (image, the
    CLI's --stats JSON line)."""
    import contextlib
    import io
    from pbrt_jax.cmd import main as cli
    from pbrt_jax.utils import image as pimg
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "out.exr"
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main([str(ROOT / scene_file), "--outfile", str(out),
                           "--quiet", "--stats", *extra])
        if rc != 0:
            raise RuntimeError(f"cmd.main returned {rc}")
        stats = json.loads(buf.getvalue().strip().splitlines()[-1])
        return pimg.read_exr(out), stats


def phase_cornell():
    # the same command twice: the first compiles, the second is steady
    t0 = time.perf_counter()
    cli_render("scenes/cornell.pbrt")
    first_s = time.perf_counter() - t0
    img, st = cli_render("scenes/cornell.pbrt")
    from pbrt_jax.scene import parser as pparser
    route = pparser.parse_file(ROOT / "scenes/cornell.pbrt").scene.traversal
    return dict(compile_and_first_s=first_s, seconds=st["seconds"],
                paths_per_sec=st["paths_per_sec"], traversal=route,
                **gate("cornell", img))


def phase_golden_scene(name, depth):
    from pbrt_jax.scene import parser as pparser
    t0 = time.perf_counter()
    desc = pparser.parse_file(ROOT / "scenes" / f"{name}.pbrt")
    build_s = time.perf_counter() - t0
    img, rec = timed_render(desc.scene, desc.camera, desc.sampler, depth,
                            warm_waves=desc.sampler.spp)
    return dict(scene_build_s=build_s, n_tris=int(desc.scene.tri_geo.shape[0]),
                **rec, **gate(name, img))


# --- phase 6: traversal kernel against the XLA reference ------------------

def capture_wave_rays(scene, cam, sampler, m=4):
    """The rays of one real render wave of `scene` at its render lane count
    (the image tiled m times, as render() batches a 200x200 image): the
    depth-1 bounce rays and the depth-0/1 shadow rays, with their t_max."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from pbrt_jax import filters as flt
    from pbrt_jax import scene_core as sc
    from pbrt_jax.integrators import path as path_mod
    n_pix = cam.width * cam.height
    pix = jnp.asarray(np.tile(np.arange(n_pix, dtype=np.int32), m))
    si = jnp.arange(n_pix * m, dtype=jnp.int32) // n_pix
    # compaction on from a depth past the end: the depth loop unrolls in
    # Python with no lane sort, so each query's rays are plain values
    opts = path_mod.PathOptions(max_depth=2, compaction=True,
                                compaction_start=2)
    recs, kinds = [], []
    orig = (sc.intersect, sc.intersect_p)

    def recorder(kind, fn):
        def f(scene, o, d, t_max, time=None):
            kinds.append(kind)
            recs.append((o, d, jnp.broadcast_to(
                jnp.asarray(t_max, jnp.float32), o.shape[:1])))
            return fn(scene, o, d, t_max, time=time)
        return f

    def wave(pix, si):
        recs.clear()
        kinds.clear()
        path_mod.render_wave(scene, cam, sampler, flt.make_filter("gaussian"),
                             pix, si, opts)
        return list(recs)

    sc.intersect = recorder("closest", orig[0])
    sc.intersect_p = recorder("shadow", orig[1])
    try:
        rays = jax.jit(wave)(pix, si)
    finally:
        sc.intersect, sc.intersect_p = orig
    closest = [r for r, k in zip(rays, kinds) if k == "closest"]
    shadow = [r for r, k in zip(rays, kinds) if k == "shadow"]
    bounce = tuple(closest[1])
    shadow = tuple(jnp.concatenate(parts) for parts in zip(*shadow))
    return bounce, shadow


def box_rays(scene, n, seed=0):
    """n rays with origins uniform in the scene box (grown by 1) and
    uniformly distributed directions, from a seed."""
    import jax.numpy as jnp
    import numpy as np
    rng = np.random.default_rng(seed)
    lo = np.asarray(scene.world_lo)
    hi = np.asarray(scene.world_hi)
    o = rng.uniform(lo - 1, hi + 1, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


def time_query(fn, *args, reps=5):
    import jax
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return ts[len(ts) // 2] * 1e3


def _watertight_f64(scene, prim, o, d):
    """The watertight test of ops/intersect.py in float64 for rays against
    given triangles: the exact t and barycentrics, and the test's own
    conservative bounds on their float32 error (pbrt's deltaT for t;
    delta_e (1 + 3|b|) / |det| for each barycentric b = e / det)."""
    import numpy as np
    from pbrt_jax.utils.math import gamma_bound
    g2, g3, g5 = (float(gamma_bound(n)) for n in (2, 3, 5))
    tri = np.asarray(scene.tri_geo, np.float64)[prim]
    o = np.asarray(o, np.float64)
    d = np.asarray(d, np.float64)
    kz = np.argmax(np.abs(d), -1)
    kx = (kz + 1) % 3
    ky = (kx + 1) % 3

    def pick(v, k):
        return np.take_along_axis(v, k[:, None], -1)[:, 0]
    dz = pick(d, kz)
    sx, sy, sz = -pick(d, kx) / dz, -pick(d, ky) / dz, 1.0 / dz
    xs, ys, zs = [], [], []
    for i in range(3):
        p = tri[:, 3 * i:3 * i + 3] - o
        xs.append(pick(p, kx) + sx * pick(p, kz))
        ys.append(pick(p, ky) + sy * pick(p, kz))
        zs.append(pick(p, kz) * sz)
    e = np.stack([xs[1] * ys[2] - ys[1] * xs[2], xs[2] * ys[0] - ys[2] * xs[0],
                  xs[0] * ys[1] - ys[0] * xs[1]], -1)
    det = e.sum(-1)
    t = (e * np.stack(zs, -1)).sum(-1) / det
    b = e / det[:, None]
    max_x = np.max(np.abs(xs), 0)
    max_y = np.max(np.abs(ys), 0)
    max_z = np.max(np.abs(zs), 0)
    dx, dy, dz_ = g5 * (max_x + max_z), g5 * (max_y + max_z), g3 * max_z
    de = 2 * (g2 * max_x * max_y + dy * max_x + dx * max_y)
    max_e = np.abs(e).max(-1)
    dt = 3 * (g3 * max_e * max_z + de * max_z + dz_ * max_e) / np.abs(det)
    bound_b = de[:, None] * (1 + 3 * np.abs(b)) / np.abs(det)[:, None]
    return t, b, dt, bound_b


def compare_queries(scene, o, d, t_max, any_hit):
    """Kernel vs XLA reference on one ray set (float32 both). Tolerances:
    - closest hit: hit and prim agree on >= 99.99% of rays, and every
      disagreement is a near-tie (both hit, t within 1e-5 relative: two
      triangles met at the same distance, e.g. across a shared edge);
    - on agreeing hits, t within 1e-5 relative and barycentrics within
      1e-4 of the reference, or, for ill-conditioned (grazing) hits where
      two float32 evaluations round differently (XLA may contract
      products into FMAs, the kernel does not), within the watertight
      test's own float32 error bounds of a float64 evaluation;
    - any hit: occlusion agrees exactly, except near-tie rays whose
      closest hit lies within 1e-5 relative of t_max."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from pbrt_jax.ops import bvh as bvh_mod
    from pbrt_jax.ops import bvh_cuda
    nodes, tris = scene.bvh.nodes, scene.tri_geo_bvh
    kern = jax.jit(lambda o, d, t: bvh_cuda.intersect(
        nodes, tris, o, d, t, any_hit=any_hit))
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(lambda o, d, t: bvh_mod.bvh_intersect_triangles(
            scene.bvh, tris, o, d, t, any_hit=any_hit))
        ms_ref = time_query(ref, o, d, t_max)
        rr = {k: np.asarray(v) for k, v in ref(o, d, t_max).items()}
        ms_kern = time_query(kern, o, d, t_max)
        rk = {k: np.asarray(v) for k, v in kern(o, d, t_max).items()}
        n = o.shape[0]
        rec = dict(rays=n, kernel_ms=ms_kern, xla_ms=ms_ref,
                   kernel_mrays_per_s=n / ms_kern / 1e3,
                   xla_mrays_per_s=n / ms_ref / 1e3)
        if any_hit:
            dis = rk["hit"] != rr["hit"]
            near = np.zeros_like(dis)
            if dis.any():
                idx = np.nonzero(dis)[0]
                full = bvh_mod.bvh_intersect_triangles(
                    scene.bvh, tris, o[idx], d[idx],
                    jnp.full((len(idx),), 1e30, jnp.float32))
                tm = np.asarray(t_max)[idx]
                near[idx] = np.abs(np.asarray(full["t"]) - tm) <= 1e-5 * tm
            rec.update(occluded=int(rr["hit"].sum()),
                       disagree=int(dis.sum()),
                       non_near_tie=int((dis & ~near).sum()),
                       ok=bool((dis & ~near).sum() == 0))
            return rec
    both = rk["hit"] & rr["hit"]
    agree = (rk["hit"] == rr["hit"]) & (~both | (rk["prim"] == rr["prim"]))
    dis = ~agree
    with np.errstate(invalid="ignore"):
        t_rel = np.abs(rk["t"] - rr["t"]) / np.abs(rr["t"])
    b_k = np.stack([rk["b0"], rk["b1"], rk["b2"]], -1)
    b_r = np.stack([rr["b0"], rr["b1"], rr["b2"]], -1)
    b_diff = np.abs(b_k - b_r).max(-1)
    near = both & (t_rel <= 1e-5)
    same = agree & both
    out = same & ((t_rel > 1e-5) | (b_diff > 1e-4))
    idx = np.nonzero(out)[0]
    outliers_ok = True
    if len(idx):
        t64, b64, dt, db = _watertight_f64(
            scene, rr["prim"][idx], np.asarray(o)[idx], np.asarray(d)[idx])
        kt = np.abs(rk["t"][idx] - t64)
        kb = np.abs(b_k[idx] - b64)
        outliers_ok = bool(np.all(kt <= dt) and np.all(kb <= db))
        rec.update(ill_cond_t_err_over_bound_max=float(np.max(kt / dt)),
                   ill_cond_bary_err_over_bound_max=float(np.max(kb / db)),
                   ill_cond_xla_t_err_over_bound_max=float(np.max(
                       np.abs(rr["t"][idx] - t64) / dt)))
    frac = float(agree.mean())
    rec.update(hits=int(rr["hit"].sum()), agree_frac=frac,
               disagree=int(dis.sum()), non_near_tie=int((dis & ~near).sum()),
               t_rel_err_max=float(t_rel[same].max()) if same.any() else 0.0,
               bary_err_max=float(b_diff[same].max()) if same.any() else 0.0,
               ill_conditioned=len(idx),
               ok=bool(frac >= 0.9999 and (dis & ~near).sum() == 0
                       and outliers_ok))
    return rec


def phase_traversal():
    import jax.numpy as jnp
    from pbrt_jax.scene import parser as pparser
    desc = pparser.parse_file(ROOT / "scenes/meshfield.pbrt")
    scene = desc.scene
    if scene.traversal != "bvh_cuda":
        return dict(ok=False, error=f"meshfield routes to {scene.traversal}")
    bounce, shadow = capture_wave_rays(scene, desc.camera, desc.sampler)
    o_box, d_box = box_rays(scene, 1 << 20)
    diag = float(jnp.linalg.norm(scene.world_hi - scene.world_lo))
    t_inf = jnp.full((o_box.shape[0],), 1e30, jnp.float32)
    t_seg = jnp.full((o_box.shape[0],), 0.5 * diag, jnp.float32)
    sets = dict(
        bounce_closest=compare_queries(scene, *bounce, any_hit=False),
        shadow_any=compare_queries(scene, *shadow, any_hit=True),
        box_closest=compare_queries(scene, o_box, d_box, t_inf, False),
        box_any=compare_queries(scene, o_box, d_box, t_seg, True))
    return dict(ok=all(s["ok"] for s in sets.values()), **sets)


def phase_frame1080():
    import numpy as np
    from pbrt_jax import scenes
    from pbrt_jax import samplers as smp
    scene, cam = scenes.make_machines_frame(width=1920, height=1080)
    sampler = smp.make_sampler("zsobol", spp=8, full_resolution=(1920, 1080))
    img, rec = timed_render(scene, cam, sampler, 5, warm_waves=8)
    img = np.asarray(img)
    return dict(**rec, finite=bool(np.isfinite(img).all()),
                mean=float(img.mean()),
                ok=bool(np.isfinite(img).all() and img.mean() > 1e-4))


# --- four cards ------------------------------------------------------------

def phase_sharded(name, n_cards, overrides=(), golden=True):
    """`--chips n` through the CLI, against the same samples rendered on
    one card by the same CLI in this process (rtol 2e-4, atol 2e-5: the
    film sums are taken in another order), and against the golden; the
    pixel ids and the film must sit on n distinct devices."""
    import numpy as np
    from pbrt_jax.parallel import mesh as pmesh
    seen = {}
    orig = pmesh.render_multichip

    def spy(*a, **kw):
        img, st = orig(*a, **kw)
        seen.update(st)
        return img, st
    scene_file = f"scenes/{name}.pbrt"
    sharded = (*overrides, "--chips", str(n_cards))
    pmesh.render_multichip = spy
    try:
        t0 = time.perf_counter()
        cli_render(scene_file, sharded)
        first_s = time.perf_counter() - t0
        img_n, st = cli_render(scene_file, sharded)
    finally:
        pmesh.render_multichip = orig
    img_1, _ = cli_render(scene_file, overrides)
    same = bool(np.all(np.abs(img_n - img_1) <= 2e-5 + 2e-4 * np.abs(img_1)))
    placed = (len(set(seen["pixel_devices"])) == n_cards
              and len(set(seen["film_devices"])) == n_cards)
    rec = dict(compile_and_first_s=first_s, seconds=st["seconds"],
               paths_per_sec=st["paths_per_sec"],
               pixel_devices=seen["pixel_devices"],
               film_devices=seen["film_devices"],
               max_abs_diff_vs_one_card=float(np.abs(img_n - img_1).max()),
               equal_to_one_card=same, on_distinct_devices=placed,
               ok=same and placed)
    if golden:
        g = gate(name, img_n)
        rec.update(g, ok=rec["ok"] and g["ok"])
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4),
                    help="4: run only the four-card sharded-render path")
    ap.add_argument("--only", default=None,
                    help="comma-separated phase names to run (debugging)")
    args = ap.parse_args(argv)
    devs = require_gpus(args.cards)
    global GOLDEN
    sys.path.insert(0, str(ROOT))
    from pbrt_jax.utils.compile_cache import setup_compile_cache
    setup_compile_cache()
    GOLDEN = load_golden_tool()
    only = set(args.only.split(",")) if args.only else None

    def want(name):
        return only is None or name in only

    dev = run_phase("device", phase_device, devs)
    if args.cards == 1:
        phases = [("cornell", phase_cornell, ()),
                  ("meshfield", phase_golden_scene, ("meshfield", 4)),
                  ("killeroo", phase_golden_scene, ("killeroo", 5)),
                  ("instances", phase_golden_scene, ("instances", 3)),
                  ("traversal", phase_traversal, ()),
                  ("frame1080", phase_frame1080, ())]
    else:
        phases = [(f"{n}_x{args.cards}", phase_sharded, (n, args.cards))
                  for n in ("cornell", "meshfield")]
    for name, fn, fargs in phases:
        if want(name):
            run_phase(name, fn, *fargs)
    for line in dev.get("cards", []):
        print(line)
    if _FAILED:
        print(f"chip_smoke: failed phases: {', '.join(_FAILED)}",
              file=sys.stderr)
        return 1
    import jax
    emit({"ok": True, "device": {"platform": devs[0].platform,
                                 "kind": devs[0].device_kind,
                                 "count": len(jax.devices())}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
