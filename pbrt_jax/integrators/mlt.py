"""Metropolis light transport (PSSMLT over BDPT).

Role model: the reference's ``MLTIntegrator`` (cpu/integrators.h:384;
integrators.cpp MLTIntegrator::L / ::Render — Kelemen-style primary-sample-
space Metropolis on top of the BDPT path machinery, bootstrap + large/small
mutations + expected-value splatting) and ``MLTSampler`` (samplers.h:634).

Shape: thousands of independent Markov chains run as lanes; each
chain's primary-sample vector is a row of an (N, D) table consumed by the
SAMPLER_TABLE sampler kind, so one jitted step proposes + evaluates +
accepts for every chain at once.  Each chain has a fixed path depth
(inherited from its bootstrap sample, like the reference); the BDPT
strategy (s, t) is re-picked per mutation from the vector's last dimension.

Divergences from the reference (documented): eager (non-lazy) mutation of
all PSS dimensions — unused dimensions don't affect the path, so the chain
distribution is identical; single-Gaussian small-step perturbation.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .. import scene_core as sc
from .. import samplers as smp
from .. import film as film_mod
from ..utils import spectrum as spc
from .path import PathOptions
from . import bdpt as bdpt_mod
from .lightpath import _positionless_sampler

_LUM = np.asarray([0.2126, 0.7152, 0.0722], np.float32)


def _table_width(max_depth):
    """PSS vector width covering every dim trace_bdpt reads, plus one
    strategy-pick dim at the end."""
    cbase = 6 + 3 * (max_depth + 1) + 5 + 3 * max_depth
    n_connect = 0
    for t in range(2, max_depth + 3):
        for s in range(0, max_depth + 3 - t):
            if s + t - 2 <= max_depth:
                n_connect += 1
    n_connect += max_depth  # t==1 strategies
    return cbase + 3 * n_connect + 1


def _eval_chains(scene, camera, sensor, table, depth_lane, max_depth,
                 ls_power):
    """Evaluate the BDPT contribution each chain's PSS vector describes.

    Returns (y luminance (N,), rgb (N, 3), p_raster (N, 2))."""
    N = table.shape[0]
    W, H = camera.width, camera.height
    sampler = smp.SamplerParams(kind=smp.SAMPLER_TABLE, table=table)
    lane = jnp.arange(N, dtype=jnp.int32)
    py0 = jnp.zeros((N,), jnp.int32)
    u_lam = table[:, 5]
    swl = spc.sample_visible_wavelengths(u_lam)
    p_film = jnp.stack([table[:, 0] * W, table[:, 1] * H], -1)
    opts = PathOptions(max_depth=max_depth, sample_visible_wavelengths=True)
    dummy_splat = jnp.zeros((1, 3), jnp.float32)
    strategies, _ = bdpt_mod.trace_bdpt(
        scene, camera, sensor, sampler, lane, py0,
        jnp.zeros((N,), jnp.int32), swl, opts, dummy_splat,
        ls_power=ls_power, p_film=p_film, collect=True)

    # strategy pick: nStrategies = depth + 2; s in [0, nStrategies-1],
    # t = nStrategies - s; depth==0 forces (s, t) = (0, 2)
    # (reference MLTIntegrator::L, integrators.cpp:2486)
    n_str = jnp.where(depth_lane == 0, 1, depth_lane + 2)
    u_s = table[:, -1]
    s_lane = jnp.clip((u_s * n_str).astype(jnp.int32), 0, n_str - 1)
    s_lane = jnp.where(depth_lane == 0, 0, s_lane)
    t_lane = depth_lane + 2 - s_lane

    rgb = jnp.zeros((N, 3), jnp.float32)
    p_raster = p_film
    for st in strategies:
        sel = (s_lane == st["s"]) & (t_lane == st["t"])
        r = film_mod.sensor_to_sensor_rgb(sensor, st["L"], swl)
        rgb = rgb + jnp.where(sel[:, None], r * n_str[:, None], 0.0)
        if st["p_raster"] is not None:
            p_raster = jnp.where(sel[:, None], st["p_raster"], p_raster)
    rgb = jnp.where(jnp.isfinite(rgb), rgb, 0.0)
    y = jnp.maximum(rgb @ jnp.asarray(_LUM), 0.0)
    return y, rgb, p_raster


def render_mlt(scene: sc.Scene, camera, max_depth=5, n_chains=16384,
               n_bootstrap=131072, mutations_per_pixel=32, sigma=0.01,
               p_large=0.3, sensor=None, colorspace=None, seed=0,
               verbose=False):
    """Render with MLT; returns ((H, W, 3) image, stats dict)."""
    W, H = camera.width, camera.height
    if sensor is None:
        sensor = film_mod.make_pixel_sensor(colorspace)
    ls_power = _positionless_sampler(scene)
    D = _table_width(max_depth)
    key = jax.random.PRNGKey(seed)
    n_depths = max_depth + 1

    eval_j = jax.jit(lambda tbl, dep: _eval_chains(
        scene, camera, sensor, tbl, dep, max_depth, ls_power))

    # ---- bootstrap: estimate b and draw chain starting states ------------
    # heavy-tailed y (direct light hits dominate) makes b the main bias
    # risk — use a large sample like the reference (nBootstrap=100k default)
    batch = min(n_bootstrap, 16384)
    tables_np, y_list, dep_list = [], [], []
    done = 0
    while done < n_bootstrap:
        key, k1 = jax.random.split(key)
        bt = jax.random.uniform(k1, (batch, D), jnp.float32)
        bd = (done + jnp.arange(batch, dtype=jnp.int32)) % n_depths
        y_b, _, _ = eval_j(bt, bd)
        tables_np.append(np.asarray(bt))
        dep_list.append(np.asarray(bd))
        y_list.append(np.asarray(y_b, np.float64))
        done += batch
    y_np = np.concatenate(y_list)
    boot_tables = np.concatenate(tables_np)
    boot_depth = np.concatenate(dep_list)
    b = float(y_np.mean()) * n_depths
    if b <= 0:
        return np.zeros((H, W, 3), np.float32), dict(b=0.0, seconds=0.0)
    # resample chain seeds proportional to bootstrap luminance
    cdf = np.cumsum(y_np)
    cdf /= cdf[-1]
    rng = np.random.RandomState(seed)
    picks = np.searchsorted(cdf, rng.rand(n_chains))
    table = jnp.asarray(boot_tables[picks])
    depth = jnp.asarray(boot_depth[picks])
    y_cur, rgb_cur, pr_cur = eval_j(table, depth)

    total_mutations = mutations_per_pixel * W * H
    n_iters = max(1, total_mutations // n_chains)

    @jax.jit
    def step(state, key):
        table, y_cur, rgb_cur, pr_cur, splat = state
        k1, k2, k3, k4 = jax.random.split(key, 4)
        is_large = jax.random.uniform(k1, (n_chains,)) < p_large
        large = jax.random.uniform(k2, (n_chains, D))
        # small step: Gaussian perturbation wrapped to [0,1)
        # (MLTSampler::EnsureReady small-step mutation, samplers.cpp)
        small = table + sigma * jax.random.normal(k3, (n_chains, D))
        small = small - jnp.floor(small)
        prop = jnp.where(is_large[:, None], large, small)
        prop = jnp.clip(prop, 0.0, 1.0 - 1e-7)
        y_p, rgb_p, pr_p = _eval_chains(scene, camera, sensor, prop, depth,
                                        max_depth, ls_power)
        a = jnp.where(y_cur > 0, jnp.minimum(1.0, y_p / jnp.maximum(y_cur,
                                                                    1e-20)),
                      1.0)
        # expected-value splatting (Veach): both states, weighted
        w_p = jnp.where(y_p > 0, a / jnp.maximum(y_p, 1e-20), 0.0)
        w_c = jnp.where(y_cur > 0, (1.0 - a) / jnp.maximum(y_cur, 1e-20),
                        0.0)

        def add(splat, pr, rgb, w):
            px = jnp.clip(pr[:, 0].astype(jnp.int32), 0, W - 1)
            py = jnp.clip(pr[:, 1].astype(jnp.int32), 0, H - 1)
            return splat.at[py * W + px].add(rgb * w[:, None])

        splat = add(splat, pr_p, rgb_p, w_p)
        splat = add(splat, pr_cur, rgb_cur, w_c)
        accept = jax.random.uniform(k4, (n_chains,)) < a
        table = jnp.where(accept[:, None], prop, table)
        y_cur = jnp.where(accept, y_p, y_cur)
        rgb_cur = jnp.where(accept[:, None], rgb_p, rgb_cur)
        pr_cur = jnp.where(accept[:, None], pr_p, pr_cur)
        n_acc = jnp.sum(accept)
        return (table, y_cur, rgb_cur, pr_cur, splat), n_acc

    import time
    t0 = time.time()
    splat = jnp.zeros((W * H, 3), jnp.float32)
    state = (table, y_cur, rgb_cur, pr_cur, splat)
    n_accepted = 0
    for it in range(n_iters):
        key, k = jax.random.split(key)
        state, n_acc = step(state, k)
        n_accepted += int(n_acc)
        if verbose and (it % 16 == 0):
            print(f"mlt iter {it}/{n_iters}")
    splat = state[4]
    total = n_iters * n_chains
    img = np.asarray(splat).reshape(H, W, 3) * (b * W * H / total)
    # to output colorspace like film.get_image
    from ..utils import color as pcolor
    cs = pcolor.srgb() if colorspace is None else colorspace
    xyz = img @ np.asarray(sensor.xyz_from_sensor_rgb).T
    img = (xyz @ np.asarray(cs.rgb_from_xyz).T).astype(np.float32)
    dt = time.time() - t0
    return img, dict(b=b, seconds=dt, acceptance=n_accepted / max(total, 1),
                     mutations=total)


def replay(scene, camera, pss_values, max_depth=5, depth=None,
           sensor=None, colorspace=None, ls_power=None):
    """Deterministic MLT path replay (the reference's DebugMLTSampler role,
    base/sampler.h:36 + --debugstart): re-evaluate the BDPT contribution a
    specific primary-sample-space vector describes, without running any
    chains. Feed it the PSS vector of a misbehaving chain state (e.g.
    dumped from a bootstrap or an acceptance trace) and inspect the
    resulting (luminance, rgb, raster position) directly.

    pss_values: sequence of floats in [0, 1); shorter vectors are padded
    with 0.5. depth: path depth the vector was drawn for (defaults to
    max_depth). Returns dict(y, rgb (3,), p_raster (2,), table_width).
    """
    import numpy as _np
    from .. import film as _film
    from .lightpath import _positionless_sampler
    if sensor is None:
        sensor = _film.make_pixel_sensor(colorspace)
    if ls_power is None:
        ls_power = _positionless_sampler(scene)
    wfull = _table_width(max_depth)
    vec = _np.full((1, wfull), 0.5, _np.float32)
    vals = _np.asarray(list(pss_values), _np.float32).reshape(-1)
    vec[0, :min(len(vals), wfull)] = vals[:wfull]
    table = jnp.asarray(vec)
    depth_lane = jnp.asarray([max_depth if depth is None else depth],
                             jnp.int32)
    y, rgb, p_raster = _eval_chains(scene, camera, sensor, table,
                                    depth_lane, max_depth, ls_power)
    return dict(y=float(y[0]), rgb=np.asarray(rgb[0]),
                p_raster=np.asarray(p_raster[0]), table_width=wfull)
