#!/usr/bin/env python3
"""Where one dispatch of a scene's render spends device time (GPU).

    python tools/trace_wave.py [--scene cornell] [--out DIR]

Compiles the scene's render step, traces ONE dispatch (8 sample waves,
with render()'s own lane batching) under jax.profiler, and reduces the
device events of the step's module: the traced window, the union of busy
intervals (busy share), device ms per wave, and device ms per wave inside
the traversal scope (`traverse_<route>`, scene_core._tri_dispatch).
Kernel names are mapped to their scopes through the op_name metadata of
the compiled HLO (the trace itself carries no scope names); the CUDA
traversal kernel is matched by its symbol. Prints one JSON line.
"""
import argparse
import glob
import gzip
import json
import os
import re
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def kernel_scopes(hlo_text):
    """{kernel name: op_name} for the fusions and custom calls of a
    compiled HLO module (kernel names use '_' where HLO uses '.')."""
    out = {}
    for m in re.finditer(r"^\s*(?:ROOT\s+)?%?([\w.\-]+) = .*?"
                         r"metadata=\{[^}]*op_name=\"([^\"]*)\"",
                         hlo_text, re.M):
        out[m.group(1).replace(".", "_").replace("-", "_")] = m.group(2)
    return out


def busy_union(intervals):
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (cur_e - cur_s if cur_e is not None else 0.0)


def reduce_trace(events, module, scopes, waves):
    """Device time of `module`'s events: window, busy share, per wave,
    and per wave inside a traverse_* scope."""
    pname = {e["pid"]: e["args"]["name"] for e in events
             if e.get("ph") == "M" and e.get("name") == "process_name"}
    dev = [e for e in events if e.get("ph") == "X"
           and "GPU" in pname.get(e.get("pid"), "")
           and e.get("args", {}).get("hlo_module") == module]
    if not dev:
        raise RuntimeError(f"no device events of module {module}")
    t0 = min(e["ts"] for e in dev)
    t1 = max(e["ts"] + e["dur"] for e in dev)
    busy = busy_union((e["ts"], e["ts"] + e["dur"]) for e in dev)

    def in_traversal(e):
        return ("traverse_kernel" in e["name"]
                or "traverse_" in scopes.get(e["name"], ""))
    trav = sum(e["dur"] for e in dev if in_traversal(e))
    by_name = {}
    for e in dev:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return dict(window_ms=(t1 - t0) / 1e3, busy_ms=busy / 1e3,
                busy_share=busy / (t1 - t0), waves=waves,
                device_ms_per_wave=busy / waves / 1e3,
                traversal_ms_per_wave=trav / waves / 1e3,
                traversal_share=trav / busy,
                top_kernels_ms=[(n, d / 1e3, scopes.get(n, ""))
                                for n, d in top])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="cornell")
    ap.add_argument("--out", default=None,
                    help="keep the trace here (default: a temp dir)")
    args = ap.parse_args(argv)
    import jax
    import jax.numpy as jnp
    import numpy as np
    if jax.devices()[0].platform != "gpu":
        print("trace_wave.py: needs a GPU", file=sys.stderr)
        return 2
    from pbrt_jax.utils.compile_cache import setup_compile_cache
    setup_compile_cache()
    from pbrt_jax import film as film_mod
    from pbrt_jax import filters as flt
    from pbrt_jax.integrators import render as rdr
    from pbrt_jax.integrators.path import PathOptions
    from pbrt_jax.scene import parser as pparser

    desc = pparser.parse_file(ROOT / "scenes" / f"{args.scene}.pbrt")
    scene, cam, sampler = desc.scene, desc.camera, desc.sampler
    opts = PathOptions(max_depth=desc.integrator["max_depth"])
    # render()'s batching for a whole-image wave: m sample indices per wave
    # (lanes capped at 2^18), 8 waves per dispatch -> one dispatch
    n_pix = cam.width * cam.height
    cap = max(1, (1 << 18) // n_pix)
    m = 1
    while m * 2 <= cap and sampler.spp % (m * 2) == 0:
        m *= 2
    waves = 8 * m
    pix = jnp.asarray(np.tile(np.arange(n_pix, dtype=np.int32), m))
    hlo = rdr._render_steps_k.lower(
        scene, cam, sampler, flt.make_filter("gaussian"),
        film_mod.make_pixel_sensor(None), film_mod.make_film(cam.width,
                                                             cam.height),
        pix, jnp.asarray(0, jnp.int32), opts, 8, m=m, integrator=None,
        identity_pix=True).compile().as_text()
    scopes = kernel_scopes(hlo)
    rdr.render(scene, cam, sampler=sampler, opts=opts, max_waves=waves)
    out = args.out or tempfile.mkdtemp()
    with jax.profiler.trace(out, create_perfetto_trace=True):
        _, st = rdr.render(scene, cam, sampler=sampler, opts=opts,
                           max_waves=waves)
    f = sorted(glob.glob(os.path.join(
        out, "plugins/profile/*/perfetto_trace.json.gz")))[-1]
    ev = json.load(gzip.open(f))
    events = ev["traceEvents"] if isinstance(ev, dict) else ev
    rec = reduce_trace(events, "jit__render_steps_k_impl", scopes,
                       waves // m)
    print(json.dumps(dict(scene=args.scene, traversal=scene.traversal,
                          lanes_per_wave=n_pix * m,
                          traced_render_s=st["seconds"], **rec)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
