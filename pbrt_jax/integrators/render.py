"""Render driver: wave loop over samples + pixel chunks (reference
cpu/integrators.cpp ImageTileIntegrator::Render wave loop :66-225 /
wavefront scanlinesPerPass sizing, wavefront/integrator.cpp:231).

The device-side step (one sample wave over a pixel chunk) is one jitted
function; the host loops over (sample_index, chunk) and scatter-adds into
the film. Multi-chip: shard the pixel axis across the mesh (parallel/mesh.py).
"""
from __future__ import annotations

import functools
import time

import jax
import jax.numpy as jnp
import numpy as np

from .. import scene_core as sc
from .. import samplers as smp
from .. import cameras as cam_mod
from .. import filters as flt
from .. import film as film_mod
from . import path as path_mod
from . import volpath as volpath_mod


def wave_module(scene, integrator=None):
    """Pick the integrator for a scene: VolPath when media are present
    (reference: RenderCPU picks VolPathIntegrator for scenes with media,
    cpu/render.cpp; PathIntegrator otherwise). `integrator` overrides:
    "path" | "volpath" | "ao" (reference AOIntegrator, integrators.h:296)."""
    if integrator in ("ao", "ambientocclusion"):
        from . import ao as ao_mod
        return ao_mod
    if integrator == "lightpath":
        from . import lightpath as lp_mod
        return lp_mod
    if integrator == "bdpt":
        from . import bdpt as bdpt_mod
        if not bdpt_mod.bdpt_supports_media(scene):
            from ..utils import log
            log.warning(
                "BDPT medium vertices cover homogeneous media only; this "
                "scene has grid/heterogeneous media - rendering with "
                "volpath instead (see PARITY.md declared divergences)")
            return volpath_mod
        return bdpt_mod
    if integrator in ("simplepath", "randomwalk"):
        from . import simple as simple_mod
        import types
        kind = integrator

        def rw(scene, camera, sampler, filt, pixel_idx, sample_index, opts):
            if not isinstance(opts, simple_mod.SimpleOptions) or \
                    opts.kind != kind:
                opts = simple_mod.SimpleOptions(max_depth=opts.max_depth,
                                                kind=kind)
            return simple_mod.render_wave(scene, camera, sampler, filt,
                                          pixel_idx, sample_index, opts)
        return types.SimpleNamespace(render_wave=rw)
    if integrator == "simplevolpath":
        from . import simple as simple_mod
        import types
        return types.SimpleNamespace(
            render_wave=simple_mod.render_wave_simplevol)
    if integrator == "path":
        return path_mod
    if integrator == "volpath":
        return volpath_mod
    return volpath_mod if scene.has_media else path_mod


@functools.partial(jax.jit, static_argnames=("opts", "integrator"),
                   donate_argnums=(5,))
def _render_step(scene, camera, sampler, filt, sensor, film, pixel_idx,
                 sample_index, opts, integrator=None):
    L, swl, f_weight = wave_module(scene, integrator).render_wave(
        scene, camera, sampler, filt, pixel_idx, sample_index, opts)
    rgb = film_mod.sensor_to_sensor_rgb(sensor, L, swl)
    return film_mod.add_samples(film, pixel_idx, rgb, f_weight)


def _render_steps_k_impl(scene, camera, sampler, filt, sensor, film,
                         pixel_idx, s0, opts, k, m=1, integrator=None,
                         identity_pix=False):
    """k sample waves in ONE dispatch (amortizes the per-program launch
    overhead).

    m > 1 batches m consecutive sample indices into ONE wave: pixel_idx is
    the image tiled m times and lane j gets sample index s0 + i*m + j//n_pix.
    Small images (e.g. 200x200 = 40k lanes) underfill the device; the tiled
    wave keeps dispatches wide (the reference fills its GPU with
    maxQueueSize ray batches the same way, gpu/launch.h).

    identity_pix: static promise that pixel_idx is arange(W*H) tiled m
    times — lets the film use a dense add instead of the scatter."""
    mod = wave_module(scene, integrator)
    lane_s = jnp.arange(pixel_idx.shape[0], dtype=jnp.int32) // \
        (pixel_idx.shape[0] // m)

    if hasattr(mod, "render_wave_film"):
        # splat-style integrators (lightpath) update the film directly
        def body(i, film):
            sample_index = jnp.full(pixel_idx.shape, s0 + i, jnp.int32)
            return mod.render_wave_film(scene, camera, sampler, filt, sensor,
                                        film, pixel_idx, sample_index, opts)
        return jax.lax.fori_loop(0, k, body, film)

    def body(i, film):
        sample_index = s0 + i * m + lane_s
        L, swl, f_weight = mod.render_wave(scene, camera, sampler, filt,
                                           pixel_idx, sample_index, opts)
        rgb = film_mod.sensor_to_sensor_rgb(sensor, L, swl)
        return film_mod.add_samples(film, pixel_idx, rgb, f_weight,
                                    identity=identity_pix)

    return jax.lax.fori_loop(0, k, body, film)


_render_steps_k = functools.partial(jax.jit, static_argnames=(
    "opts", "k", "m", "integrator", "identity_pix"),
    donate_argnums=(5,))(_render_steps_k_impl)


def render(scene: sc.Scene, camera: cam_mod.Camera, spp=16,
           sampler: smp.SamplerParams = None, filt: flt.Filter = None,
           sensor=None, opts: path_mod.PathOptions = None,
           max_rays_per_wave=1 << 20, verbose=False, colorspace=None,
           max_waves=None, progress=False, checkpoint_path=None,
           checkpoint_every=0, stats=None, display=None,
           display_name="pbrt_jax", waves_per_dispatch=None,
           integrator=None, return_film=False, mse_reference=None,
           mse_reference_out=None, partial_image_path=None):
    """Render and return (image (H, W, 3) linear RGB, stats dict).

    max_waves: stop after this many sample waves (warmup/benchmark use).
    progress: draw a terminal progress bar (reference ProgressReporter).
    checkpoint_path/checkpoint_every: persist film accumulators every N
    waves and resume from an existing checkpoint (reference partial-image
    recovery, options.h:42).
    stats: optional utils.stats.StatsAccumulator to fill with per-wave
    counters (reference --stats report, util/stats.h).
    display: optional utils.display.DisplayServer — streams the partial
    image to a tev viewer after every fused dispatch (display.h:23).
    mse_reference/mse_reference_out: converged reference image (H, W, 3)
    + output path — records "spp mse" per wave (reference
    --mse-reference-image/--mse-reference-out, cpu/integrators.cpp:113-141).
    partial_image_path: write the partial EXR at every checkpoint interval
    (reference --write-partial-images, options.h:42)."""
    W, H = camera.width, camera.height
    if integrator == "sppm":
        from . import sppm as sppm_mod
        mpp = spp if sampler is None else sampler.spp
        md = opts.max_depth if opts is not None else 5
        return sppm_mod.render_sppm(scene, camera, n_iterations=mpp,
                                    max_depth=md, colorspace=colorspace,
                                    verbose=verbose)
    if integrator == "mlt":
        # Markov chains, not sample waves — separate driver (integrators/mlt.py)
        from . import mlt as mlt_mod
        mpp = spp if sampler is None else sampler.spp
        md = opts.max_depth if opts is not None else 5
        return mlt_mod.render_mlt(scene, camera, max_depth=md,
                                  mutations_per_pixel=4 * mpp,
                                  colorspace=colorspace, verbose=verbose)
    if sampler is None:
        sampler = smp.make_sampler("zsobol", spp=spp, full_resolution=(W, H))
    if filt is None:
        filt = flt.make_filter("gaussian")
    if sensor is None:
        sensor = film_mod.make_pixel_sensor(colorspace)
    if opts is None:
        opts = path_mod.PathOptions()
    film = film_mod.make_film(W, H)
    s = 0
    n_waves = sampler.spp if max_waves is None else min(max_waves, sampler.spp)
    if checkpoint_path:
        import os
        if os.path.exists(checkpoint_path):
            ck_film, s = film_mod.load_checkpoint(checkpoint_path)
            if (ck_film.width, ck_film.height) == (W, H) and s <= n_waves:
                film = ck_film
                from ..utils import log
                log.info("resumed from %s at wave %d", checkpoint_path, s)
            else:
                s = 0
    n_pix = W * H
    chunk = min(n_pix, max_rays_per_wave)
    all_pix = np.arange(n_pix, dtype=np.int32)
    t0 = time.time()
    n_paths = 0
    if waves_per_dispatch is None:
        # fuse waves per dispatch to amortize the launch cost — but a
        # single dispatch must stay short, so scenes leaning on the XLA
        # while-loop curve and two-level traversals fuse less
        slow_traversal = scene.has_curves or scene.has_instances
        waves_per_dispatch = 1 if slow_traversal else 8
    k = min(waves_per_dispatch, n_waves)
    # batch m sample indices per wave when the whole image fits in one chunk
    # but underfills the device (meshfield at 200x200 is 40k lanes)
    m = 1
    mod0 = wave_module(scene, integrator)
    if chunk == n_pix and not hasattr(mod0, "render_wave_film"):
        # waves are capped at 256k lanes (a constant carried over
        # unmeasured on the GPU; ROADMAP queue 1)
        cap = max(1, min(max_rays_per_wave, 1 << 18) // n_pix)
        while m * 2 <= cap and (n_waves - s) % (m * 2) == 0:
            m *= 2
    tiled_pix = np.tile(all_pix, m) if m > 1 else None
    from ..utils.progress import ProgressReporter
    from ..utils.check import CheckCallbackScope
    prog = ProgressReporter(n_waves - s, enabled=bool(progress))
    _wave_box = [s]
    _ctx = CheckCallbackScope(
        "render", lambda: (f"wave {_wave_box[0]}/{n_waves}; resume with "
                           f"--checkpoint (reference --debugstart role)"))
    _ctx.__enter__()
    try:
        while s < n_waves:
            kk = max(1, min(k, (n_waves - s) // m))
            if m > 1:
                film = _render_steps_k(scene, camera, sampler, filt, sensor, film,
                                       jnp.asarray(tiled_pix),
                                       jnp.asarray(s, jnp.int32), opts,
                                       kk, m=m, integrator=integrator,
                                       identity_pix=True)
                n_paths += n_pix * m * kk
            else:
                for c0 in range(0, n_pix, chunk):
                    ids = all_pix[c0:c0 + chunk]
                    if len(ids) < chunk:  # pad to static shape
                        ids = np.concatenate(
                            [ids, np.full(chunk - len(ids), ids[-1], np.int32)])
                    pixel_idx = jnp.asarray(ids)
                    film = _render_steps_k(scene, camera, sampler, filt, sensor,
                                           film, pixel_idx,
                                           jnp.asarray(s, jnp.int32), opts,
                                           kk, integrator=integrator,
                                           identity_pix=(chunk == n_pix))
                    n_paths += chunk * kk
            kk = kk * m
            s += kk
            _wave_box[0] = s
            if verbose:
                print(f"wave {s}/{n_waves}  {time.time() - t0:.2f}s")
            prog.update(kk)
            if display is not None and display.connected:
                if s == kk:
                    display.create_image(display_name, W, H)
                display.update_image(display_name,
                                     film_mod.get_image(film, sensor,
                                                        colorspace))
            if stats is not None:
                stats.count("render/camera rays", chunk * kk)
                stats.count("render/waves", kk)
            if mse_reference is not None and mse_reference_out is not None:
                cur = film_mod.get_image(film, sensor, colorspace)
                mse = float(np.mean((cur - np.asarray(mse_reference)) ** 2))
                with open(mse_reference_out, "a") as f:
                    f.write(f"{s} {mse:.8g}\n")
            if partial_image_path and checkpoint_every and \
                    (s % checkpoint_every == 0 or s >= n_waves):
                from ..utils import image as pimg
                pimg.write_exr(partial_image_path,
                               film_mod.get_image(film, sensor, colorspace))
            if checkpoint_path and checkpoint_every and \
                    (s % checkpoint_every == 0 or s >= n_waves):
                jax.block_until_ready(film.rgb_sum)
                film_mod.save_checkpoint(film, checkpoint_path, s)
        jax.block_until_ready(film.rgb_sum)
    finally:
        # unregister even on mid-render failure so the crash-context
        # registry never leaks across renders
        _ctx.__exit__()
    prog.finish()
    dt = time.time() - t0
    if stats is not None:
        stats.add_time("render/wave loop", dt)
    splat_scale = 1.0 / max(s, 1) if integrator in ("lightpath", "bdpt") else 1.0
    img = film_mod.get_image(film, sensor, colorspace,
                             splat_scale=splat_scale)
    out_stats = dict(seconds=dt, paths_per_sec=n_paths / max(dt, 1e-9),
                     spp=sampler.spp)
    if return_film:
        out_stats["film"] = film
    return img, out_stats
