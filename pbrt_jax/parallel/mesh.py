"""Multi-device rendering: pixel-sharded waves over a jax.sharding.Mesh.

Radiance estimation is embarrassingly parallel over pixels (SURVEY.md §2.9):
we shard the pixel batch across the mesh 'px' axis, replicate the scene
arrays, and reduce the film with a psum at wave end — the only cross-device
traffic is the film reduction (and scene broadcast at startup). This
replaces the reference's ThreadPool/ParallelFor2D tile loop
(cpu/integrators.cpp:163) as the scale-out axis.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .. import scene_core as sc
from .. import samplers as smp
from .. import cameras as cam_mod
from .. import filters as flt
from .. import film as film_mod
from ..integrators import path as path_mod


def make_mesh(devices=None, axis_name="px") -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (axis_name,))


def render_wave_sharded(scene, camera, sampler, filt, sensor, film,
                        pixel_idx, sample_index, opts, mesh: Mesh,
                        axis_name="px"):
    """One sample wave with pixels sharded across the mesh.

    pixel_idx/sample_index: (N,) with N divisible by mesh size. Returns
    updated (replicated) film.
    """

    def shard_fn(scene, camera, sampler_, filt_, sensor_, accum,
                 pixel_idx, sample_index):
        from ..integrators.render import wave_module
        L, swl, f_weight = wave_module(scene).render_wave(
            scene, camera, sampler_, filt_, pixel_idx, sample_index, opts)
        rgb = film_mod.sensor_to_sensor_rgb(sensor_, L, swl)
        rgb = jnp.where(jnp.isfinite(rgb), rgb, 0.0)
        lum = 0.2126 * rgb[:, 0] + 0.7152 * rgb[:, 1] + 0.0722 * rgb[:, 2]
        row = jnp.concatenate([
            rgb * f_weight[:, None], f_weight[:, None], lum[:, None],
            (lum * lum)[:, None], jnp.ones_like(lum)[:, None],
            jnp.zeros_like(lum)[:, None]], axis=1)
        d_acc = jnp.zeros_like(accum).at[pixel_idx].add(row)
        d_acc = jax.lax.psum(d_acc, axis_name)
        return accum + d_acc

    fn = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(), P(), P(axis_name), P(axis_name)),
        out_specs=P(),
        check_vma=False)
    accum = fn(scene, camera, sampler, filt, sensor,
               film.accum, pixel_idx, sample_index)
    return film.replace(accum=accum)


def render_multichip(scene: sc.Scene, camera: cam_mod.Camera, spp=16,
                     sampler: smp.SamplerParams = None,
                     filt: flt.Filter = None, sensor=None, opts=None,
                     mesh: Mesh = None, rays_per_wave=None, colorspace=None):
    """Full multi-chip render: loops sample waves, pixels sharded over mesh."""
    import time
    W, H = camera.width, camera.height
    if mesh is None:
        mesh = make_mesh()
    n_dev = mesh.devices.size
    if sampler is None:
        sampler = smp.make_sampler("zsobol", spp=spp, full_resolution=(W, H))
    if filt is None:
        filt = flt.make_filter("gaussian")
    if sensor is None:
        sensor = film_mod.make_pixel_sensor(colorspace)
    if opts is None:
        opts = path_mod.PathOptions()
    film = film_mod.make_film(W, H)
    n_pix = W * H
    chunk = rays_per_wave or n_pix
    chunk = ((chunk + n_dev - 1) // n_dev) * n_dev  # divisible by mesh

    step = jax.jit(functools.partial(render_wave_sharded, opts=opts, mesh=mesh),
                   static_argnames=(), donate_argnums=(5,))
    px_sharding = NamedSharding(mesh, P(mesh.axis_names[0]))
    # replicate the scene and the film once: an argument committed to one
    # device would be copied to every device on every wave
    scene, camera, sampler, filt, sensor, film = jax.device_put(
        (scene, camera, sampler, filt, sensor, film),
        NamedSharding(mesh, P()))
    all_pix = np.arange(n_pix, dtype=np.int32)
    t0 = time.time()
    n_paths = 0
    for s in range(sampler.spp):
        for c0 in range(0, n_pix, chunk):
            ids = all_pix[c0:c0 + chunk]
            if len(ids) < chunk:
                ids = np.concatenate([ids, np.full(chunk - len(ids), ids[-1], np.int32)])
            ids = jax.device_put(ids, px_sharding)
            film = step(scene, camera, sampler, filt, sensor, film, ids,
                        jax.device_put(np.full((chunk,), s, np.int32),
                                       px_sharding))
            n_paths += chunk
    jax.block_until_ready(film.rgb_sum)
    dt = time.time() - t0
    img = film_mod.get_image(film, sensor, colorspace)
    return img, dict(seconds=dt, paths_per_sec=n_paths / max(dt, 1e-9),
                     n_devices=n_dev, spp=sampler.spp,
                     pixel_devices=sorted(
                         d.id for d in ids.sharding.device_set),
                     film_devices=sorted(
                         d.id for d in film.accum.sharding.device_set))
