"""Volumetric path integrator: null-scattering path integral with rescaled
path probabilities and spectral MIS (reference VolPathIntegrator,
cpu/integrators.cpp:953-1400, SampleT_maj media.h:725, MajorantGrid
media.h:105, DDAMajorantIterator media.h:136).

Architecture: one fused wavefront program; the free-flight sampler is a
vectorized 3D-DDA over the scene-level majorant super-grid (media.py) folded
into a single masked `lax.while_loop` — each iteration either advances a
lane to its next grid cell or processes one null/scatter/absorb event.
Because cell majorants are spectrally constant scalars, every T_maj factor
of the reference's estimator cancels out of the beta/r_u/r_l ratios, so the
loop does no exponentials and carries no spectral majorant state.

Estimator bookkeeping (matching integrators.cpp:953-1050):
  beta — path throughput numerator
  r_u  — rescaled unidirectional path pdf (per wavelength / hero pdf)
  r_l  — rescaled light-path pdf (for MIS with NEE)
Contributions divide by averages over the 4 wavelengths: spectral MIS.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .. import scene_core as sc
from .. import samplers as smp
from .. import bxdfs
from .. import materials as mtl
from .. import lights as lgt
from .. import lightsamplers as lsamp
from .. import cameras as cam_mod
from .. import filters as flt
from .. import media as med_mod
from ..utils import vecmath as vm
from ..utils import spectrum as spc
from ..utils import rng as prng
from ..utils import sampling as usamp
from ..utils.math import safe_div
from .path import PathOptions, _to_local, _to_world, _CAM_DIMS, \
    _DIMS_PER_BOUNCE

_MAX_FLIGHT_EVENTS = 512
EV_REACH, EV_SCATTER, EV_ABSORB = 0, 1, 2

_EPS = 1e-9


def _avg(x):
    return jnp.mean(x, axis=-1)


def medium_index_at(pool: med_mod.MediumPool, p):
    """First medium whose world box contains p (static unroll; -1 if none)."""
    M = pool.desc.shape[0]
    idx = jnp.full(p.shape[:-1], -1, jnp.int32)
    for m in range(M - 1, -1, -1):
        row = pool.desc[m]
        lo, hi = row[15:18], row[18:21]
        # a dummy/empty medium row has lo == hi == 0: the strict-extent test
        # keeps it from claiming points
        inside = jnp.all((p >= lo) & (p <= hi) & (hi > lo), axis=-1)
        idx = jnp.where(inside, m, idx)
    return idx


def _dda_init(pool: med_mod.MediumPool, o, d, t_start, t_seg_end):
    """Per-lane 3D-DDA setup over the majorant super-grid (reference
    DDAMajorantIterator ctor, media.h:141-176). Returns dict of DDA state."""
    lo = pool.maj_lo
    hi = pool.maj_hi
    res = jnp.asarray(pool.maj_res, jnp.float32)  # (3,) mx,my,mz
    diag = jnp.maximum(hi - lo, _EPS)
    og = (o - lo) / diag
    dg = d / diag
    gi = og + dg * t_start[..., None]
    voxel = jnp.clip(jnp.floor(gi * res).astype(jnp.int32), 0,
                     jnp.asarray(pool.maj_res, jnp.int32) - 1)
    dg_safe = jnp.where(jnp.abs(dg) < _EPS, _EPS, dg)
    delta_t = 1.0 / (jnp.abs(dg_safe) * res)
    pos = dg >= 0
    next_voxel_pos = jnp.where(pos, (voxel + 1).astype(jnp.float32) / res,
                               voxel.astype(jnp.float32) / res)
    next_crossing = t_start[..., None] + (next_voxel_pos - gi) / dg_safe
    next_crossing = jnp.where(jnp.abs(dg) < _EPS, jnp.inf, next_crossing)
    step = jnp.where(pos, 1, -1).astype(jnp.int32)
    limit = jnp.where(pos, jnp.asarray(pool.maj_res, jnp.int32), -1)
    return dict(voxel=voxel, next_crossing=next_crossing, delta_t=delta_t,
                step=step, limit=limit, t_seg_end=t_seg_end)


def _grid_span(pool: med_mod.MediumPool, o, d, t_max):
    """Ray overlap [t0, t1] with the majorant super-grid box, clipped to
    [0, t_max]. Lanes with no overlap return t0 >= t1."""
    lo, hi = pool.maj_lo, pool.maj_hi
    inv_d = 1.0 / jnp.where(jnp.abs(d) < _EPS, _EPS, d)
    ta = (lo - o) * inv_d
    tb = (hi - o) * inv_d
    t0 = jnp.maximum(jnp.max(jnp.minimum(ta, tb), axis=-1), 0.0)
    t1 = jnp.minimum(jnp.min(jnp.maximum(ta, tb), axis=-1), t_max)
    return t0, t1


def _maj_lookup(pool: med_mod.MediumPool, voxel):
    mx, my, _mz = pool.maj_res
    flat = (voxel[..., 2] * my + voxel[..., 1]) * mx + voxel[..., 0]
    flat = jnp.clip(flat, 0, pool.maj_grid.shape[0] - 1)
    return pool.maj_grid[flat]


def sample_t_maj(scene, o, d, t_max, lam, seed, active, beta, r_u, r_l,
                 cur_med=None):
    """Fused SampleT_maj + VolPath event callback (integrators.cpp:979-1110):
    delta-track through the majorant super-grid, performing null events
    inline and stopping at scatter/absorb events or segment end.

    cur_med: optional (N,) int32 RAY-CARRIED medium index (geometry-attached
    MediumInterface mode, cpu/primitive.h:48) — when given, sigma is
    evaluated from that medium instead of the legacy point-in-box lookup,
    and vacuum lanes (cur_med < 0) skip the flight entirely.

    Returns dict(status (N,), t_event (N,), p_event (N,3), beta, r_u, r_l,
    g (N,), sigma_s_ratio-folded state). Lanes not `active` pass through
    with status REACH and untouched state."""
    pool = scene.media
    N = o.shape[0]
    t0, t1 = _grid_span(pool, o, d, t_max)
    dda = _dda_init(pool, o, d, t0, t1)
    in_grid = active & (t1 > t0)
    if cur_med is not None:
        in_grid = in_grid & (cur_med >= 0)

    status0 = jnp.where(in_grid, -1, EV_REACH)  # -1 == flying

    def cond(state):
        status = state[0]
        it = state[-1]
        return jnp.any(status == -1) & (it < _MAX_FLIGHT_EVENTS)

    def body(state):
        (status, t_lo, voxel, next_crossing, beta, r_u, r_l, t_ev, g_ev,
         em, it) = state
        flying = status == -1
        sigma_bar = _maj_lookup(pool, voxel)
        u1 = prng.uniform_float(seed, jnp.uint32(it), jnp.uint32(0x51a7))
        u2 = prng.uniform_float(seed, jnp.uint32(it), jnp.uint32(0x9bd3))
        dt = jnp.where(sigma_bar > 0,
                       -jnp.log1p(-u1) / jnp.maximum(sigma_bar, _EPS),
                       jnp.inf)
        t = t_lo + dt
        t_exit_cell = jnp.minimum(jnp.min(next_crossing, axis=-1), t1)
        has_event = flying & (t < t_exit_cell)

        # --- event lanes: classify null / scatter / absorb ---
        p_ev = o + d * t[..., None]
        med_idx = medium_index_at(pool, p_ev) if cur_med is None else cur_med
        row = med_mod.medium_row(pool, med_idx)
        sa, ss = med_mod.sigma_at(pool, row, p_ev, lam)
        no_medium = med_idx < 0
        sa = jnp.where(no_medium[..., None], 0.0, sa)
        ss = jnp.where(no_medium[..., None], 0.0, ss)
        pa = sa[..., 0] / jnp.maximum(sigma_bar, _EPS)
        ps = ss[..., 0] / jnp.maximum(sigma_bar, _EPS)
        absorb = has_event & (u2 < pa)
        scatter = has_event & ~absorb & (u2 < pa + ps)
        null = has_event & ~absorb & ~scatter

        # scalar majorant => every T_maj factor cancels from the ratios
        sn = jnp.maximum(sigma_bar[..., None] - sa - ss, 0.0)
        sn_h = sn[..., 0]
        w_null = sn / jnp.maximum(sn_h, _EPS)[..., None]
        rl_null = sigma_bar / jnp.maximum(sn_h, _EPS)
        ss_h = ss[..., 0]
        w_scat = ss / jnp.maximum(ss_h, _EPS)[..., None]

        # volumetric emission at absorption events (reference: the
        # absorption callback adds beta * Le, integrators.cpp:1006; with
        # scalar majorants the estimator weight is sa/sa_hero)
        if pool.has_emissive:
            Le = med_mod.le_at(pool, row, p_ev, lam)
            w_abs = sa / jnp.maximum(sa[..., 0:1], _EPS)
            em_new = beta * w_abs * Le / \
                jnp.maximum(_avg(r_u), _EPS)[..., None]
            em = em + jnp.where(absorb[..., None], em_new, 0.0)

        beta = jnp.where(null[..., None], beta * w_null,
               jnp.where(scatter[..., None], beta * w_scat, beta))
        r_u = jnp.where(null[..., None], r_u * w_null,
              jnp.where(scatter[..., None], r_u * w_scat, r_u))
        r_l = jnp.where(null[..., None], r_l * rl_null[..., None], r_l)
        dead = null & (sn_h <= 0)

        status = jnp.where(absorb | dead, EV_ABSORB,
                 jnp.where(scatter, EV_SCATTER, status))
        t_ev = jnp.where(scatter, t, t_ev)
        g_ev = jnp.where(scatter, med_mod.hg_g(row), g_ev)
        t_lo = jnp.where(null, t, t_lo)

        # --- no-event lanes: DDA step to the next cell ---
        advance = flying & ~has_event
        # argmin axis of next_crossing
        nc = next_crossing
        ax0 = (nc[..., 0] <= nc[..., 1]) & (nc[..., 0] <= nc[..., 2])
        ax1 = ~ax0 & (nc[..., 1] <= nc[..., 2])
        ax = jnp.where(ax0, 0, jnp.where(ax1, 1, 2))
        onehot = jax.nn.one_hot(ax, 3, dtype=jnp.int32)
        stepped_voxel = voxel + onehot * dda["step"]
        stepped_nc = nc + onehot.astype(jnp.float32) * dda["delta_t"]
        out = jnp.sum(stepped_voxel * onehot, axis=-1) == \
            jnp.sum(dda["limit"] * onehot, axis=-1)
        t_cell = jnp.minimum(jnp.min(nc, axis=-1), t1)
        voxel = jnp.where(advance[..., None], stepped_voxel, voxel)
        next_crossing = jnp.where(advance[..., None], stepped_nc,
                                  next_crossing)
        t_lo = jnp.where(advance, t_cell, t_lo)
        reached = advance & ((t_cell >= t1) | out)
        status = jnp.where(reached, EV_REACH, status)
        return (status, t_lo, voxel, next_crossing, beta, r_u, r_l, t_ev,
                g_ev, em, it + 1)

    state = (status0, t0, dda["voxel"], dda["next_crossing"], beta, r_u, r_l,
             jnp.zeros((N,), jnp.float32), jnp.zeros((N,), jnp.float32),
             jnp.zeros((N, 4), jnp.float32), jnp.asarray(0, jnp.int32))
    (status, _t_lo, _v, _nc, beta, r_u, r_l, t_ev, g_ev, em,
     n_it) = jax.lax.while_loop(cond, body, state)
    status = jnp.where(status == -1, EV_REACH, status)
    return dict(status=status, t=t_ev, g=g_ev, beta=beta, r_u=r_u, r_l=r_l,
                em=em, n_iters=n_it)


def transmittance_ratio(scene, o, d, dist, lam, seed, active):
    """Ratio-tracked shadow transmittance with rescaled pdfs (reference
    VolPathIntegrator::SampleLd inner loop, integrators.cpp:1273-1385).

    Returns (T_ray (N,4), r_l (N,4), r_u (N,4)): per-wavelength transmittance
    numerator and the light/uni rescaled pdfs along the shadow ray."""
    pool = scene.media
    N = o.shape[0]
    t0, t1 = _grid_span(pool, o, d, dist)
    dda = _dda_init(pool, o, d, t0, t1)
    in_grid = active & (t1 > t0)

    def cond(state):
        flying = state[0]
        it = state[-1]
        return jnp.any(flying) & (it < _MAX_FLIGHT_EVENTS)

    def body(state):
        flying, t_lo, voxel, next_crossing, T_ray, r_l, r_u, it = state
        sigma_bar = _maj_lookup(pool, voxel)
        u1 = prng.uniform_float(seed, jnp.uint32(it), jnp.uint32(0x7b55))
        u_rr = prng.uniform_float(seed, jnp.uint32(it), jnp.uint32(0x3d91))
        dt = jnp.where(sigma_bar > 0,
                       -jnp.log1p(-u1) / jnp.maximum(sigma_bar, _EPS),
                       jnp.inf)
        t = t_lo + dt
        t_exit_cell = jnp.minimum(jnp.min(next_crossing, axis=-1), t1)
        has_event = flying & (t < t_exit_cell)

        p_ev = o + d * t[..., None]
        med_idx = medium_index_at(pool, p_ev)
        row = med_mod.medium_row(pool, med_idx)
        sa, ss = med_mod.sigma_at(pool, row, p_ev, lam)
        no_medium = med_idx < 0
        sa = jnp.where(no_medium[..., None], 0.0, sa)
        ss = jnp.where(no_medium[..., None], 0.0, ss)
        sn = jnp.maximum(sigma_bar[..., None] - sa - ss, 0.0)
        # pdf = T_maj[0] * sigma_bar; with scalar majorants T_maj cancels:
        w = sn / jnp.maximum(sigma_bar, _EPS)[..., None]
        T_ray = jnp.where(has_event[..., None], T_ray * w, T_ray)
        r_u = jnp.where(has_event[..., None], r_u * w, r_u)
        # r_l *= T_maj*sigma_bar/pdf == 1 (identity) — kept for clarity
        t_lo = jnp.where(has_event, t, t_lo)

        # Russian roulette on low transmittance (integrators.cpp:1361-1369)
        Tr = T_ray / jnp.maximum(_avg(r_l + r_u), _EPS)[..., None]
        low = has_event & (jnp.max(Tr, axis=-1) < 0.05)
        kill = low & (u_rr < 0.75)
        T_ray = jnp.where(kill[..., None], 0.0,
                jnp.where(low[..., None], T_ray / 0.25, T_ray))
        dead = jnp.all(T_ray <= 0, axis=-1)

        advance = flying & ~has_event
        nc = next_crossing
        ax0 = (nc[..., 0] <= nc[..., 1]) & (nc[..., 0] <= nc[..., 2])
        ax1 = ~ax0 & (nc[..., 1] <= nc[..., 2])
        ax = jnp.where(ax0, 0, jnp.where(ax1, 1, 2))
        onehot = jax.nn.one_hot(ax, 3, dtype=jnp.int32)
        stepped_voxel = voxel + onehot * dda["step"]
        stepped_nc = nc + onehot.astype(jnp.float32) * dda["delta_t"]
        out = jnp.sum(stepped_voxel * onehot, axis=-1) == \
            jnp.sum(dda["limit"] * onehot, axis=-1)
        t_cell = jnp.minimum(jnp.min(nc, axis=-1), t1)
        voxel = jnp.where(advance[..., None], stepped_voxel, voxel)
        next_crossing = jnp.where(advance[..., None], stepped_nc,
                                  next_crossing)
        t_lo = jnp.where(advance, t_cell, t_lo)
        reached = advance & ((t_cell >= t1) | out)
        flying = flying & ~reached & ~dead
        return (flying, t_lo, voxel, next_crossing, T_ray, r_l, r_u, it + 1)

    state = (in_grid, t0, dda["voxel"], dda["next_crossing"],
             jnp.ones((N, 4), jnp.float32), jnp.ones((N, 4), jnp.float32),
             jnp.ones((N, 4), jnp.float32), jnp.asarray(0, jnp.int32))
    _, _, _, _, T_ray, r_l, r_u, _ = jax.lax.while_loop(cond, body, state)
    return T_ray, r_l, r_u


def _shading_frame(ns, dpdu):
    """Orthonormal (t1, t2) with t1 along dpdu projected off ns (reference
    SurfaceInteraction shading frame; required for anisotropic BSDFs and
    the hair BxDF, whose +x axis must be the curve tangent)."""
    t1 = dpdu - vm.dot(dpdu, ns)[..., None] * ns
    bad = vm.length_squared(t1) < 1e-12
    t1f, _ = vm.coordinate_system(ns)
    t1 = jnp.where(bad[..., None], t1f, t1)
    t1 = vm.normalize(t1)
    t2 = vm.cross(ns, t1)
    return t1, t2


def trace_paths(scene: sc.Scene, sampler: smp.SamplerParams, px, py,
                sample_index, o, d, swl: spc.SampledWavelengths,
                opts: PathOptions):
    """Volumetric path trace of one wave (reference VolPathIntegrator::Li).
    Returns L (N,4); film divides by swl.pdf."""
    N = o.shape[0]
    lam = swl.lam

    def sample_ld(p, p_err, ns, ng, t1, t2, wo_local, bp, active, depth,
                  r_p, scattered, wo_world, g_hg, seed):
        """NEE with ratio-tracked shadow transmittance and spectral MIS
        (reference VolPathIntegrator::SampleLd, integrators.cpp:1273)."""
        base = _CAM_DIMS + depth * _DIMS_PER_BOUNCE
        u_pick = smp.sample_1d(sampler, px, py, sample_index, base)
        u_l = smp.sample_2d(sampler, px, py, sample_index, base + 1)
        li_idx, pmf, _ = lsamp.sample_light(scene.light_sampler, u_pick, p=p)
        li_idx = jnp.maximum(li_idx, 0)
        ls = lgt.sample_li(scene.lights, li_idx, p, ns, u_l, lam,
                           scene.spectra_pool, scene.tri_geo,
                           scene.scene_radius, env=scene.env)
        wi = ls["wi"]
        wi_local = _to_local(ns, t1, t2, wi)
        f_hat = bxdfs.bsdf_f(bp, wo_local, wi_local) * \
            jnp.abs(wi_local[..., 2])[..., None]
        scatter_pdf = bxdfs.bsdf_pdf(bp, wo_local, wi_local)
        ph = usamp.henyey_greenstein(vm.dot(wo_world, wi), g_hg)
        f_hat = jnp.where(scattered[..., None], ph[..., None], f_hat)
        scatter_pdf = jnp.where(scattered, ph, scatter_pdf)
        p_l = ls["pdf"] * pmf
        ok = active & ls["valid"] & (p_l > 0) & jnp.any(f_hat > 0, axis=-1)
        o_sh = sc.offset_ray_origin_exact(p, p_err, ng, wi)
        o_sh = jnp.where(scattered[..., None], p + 1e-5 * wi, o_sh)
        dist = vm.length(ls["p_light"] - o_sh)
        occluded = sc.intersect_p(scene, o_sh, wi, dist * 0.999)
        ok = ok & ~occluded
        T_ray, r_l_sh, r_u_sh = transmittance_ratio(
            scene, o_sh, wi, dist, lam, seed, ok)
        r_l_tot = r_l_sh * r_p * p_l[..., None]
        r_u_tot = r_u_sh * r_p * scatter_pdf[..., None]
        denom = jnp.where(ls["is_delta"], _avg(r_l_tot),
                          _avg(r_l_tot + r_u_tot))
        Ld = f_hat * T_ray * ls["L"] / jnp.maximum(denom, _EPS)[..., None]
        return jnp.where((ok & (denom > 0))[..., None], Ld, 0.0)

    has_ifaces = scene.has_medium_interfaces

    def body(it, state):
        (o, d, beta, L, active, spec_bounce, r_u, r_l, eta_scale,
         sec_term, cur_med, depth) = state
        isect = sc.intersect(scene, o, d, jnp.full((N,), 1e30, jnp.float32))

        # --- medium-interface pool: null-material boundary shells kept out
        # of the main BVH (cpu/primitive.h:48); a closer interface hit
        # truncates the segment and pass-throughs below switch the medium
        if has_ifaces:
            ii = sc.intersect_interfaces(scene, o, d, isect["t"])
            iface_first = ii["hit"] & (ii["t"] < isect["t"])
            t_seg = jnp.where(iface_first, ii["t"], isect["t"])
        else:
            iface_first = jnp.zeros((N,), bool)
            t_seg = isect["t"]

        # --- medium flight: DDA delta tracking with inline null events ---
        seed_fl = prng.hash_u32(px.astype(jnp.uint32), py.astype(jnp.uint32),
                                sample_index.astype(jnp.uint32),
                                jnp.asarray(it, jnp.uint32),
                                np.uint32(0x6d3a))
        fl = sample_t_maj(scene, o, d, t_seg, lam, seed_fl, active,
                          beta, r_u, r_l,
                          cur_med=cur_med if has_ifaces else None)
        beta, r_u, r_l = fl["beta"], fl["r_u"], fl["r_l"]
        if scene.media.has_emissive:
            # volumetric emission accumulated at absorption events
            L = L + fl["em"]
        scattered = active & (fl["status"] == EV_SCATTER)
        absorbed = active & (fl["status"] == EV_ABSORB)
        reach = fl["status"] == EV_REACH
        p_med = o + d * fl["t"][..., None]
        active = active & ~absorbed
        passthru = iface_first & active & reach
        hit = isect["hit"] & active & reach & ~passthru

        # --- emitted radiance at hits of emissive triangles ---
        if scene.has_area_lights:
            light_idx = isect["light"]
            is_emitter = hit & (light_idx >= 0)
            li_safe = jnp.maximum(light_idx, 0)
            from ..ops.gather import pool_lookup
            lrow = lgt.LightRow(pool_lookup(scene.lights.packed, li_safe))
            Le = lgt.area_light_radiance(lrow, isect["ng"], isect["wo"], lam,
                                         scene.spectra_pool)
            tri_rows = jnp.concatenate([isect["p0"], isect["p1"],
                                        isect["p2"]], axis=-1)
            if scene.light_sampler.kind in (lsamp.LS_BVH,
                                            lsamp.LS_EXHAUSTIVE):
                pick_pmf = lsamp.light_pmf(scene.light_sampler,
                                           light_idx=li_safe, p=o)
            else:
                pick_pmf = lrow.pmf
            pdf_light = lgt.pdf_li_area_tri(lrow, o, d, isect["p"], tri_rows)
            if scene.n_spheres > 0:
                pdf_light = jnp.where(lrow.tag == lgt.LIGHT_AREA_SPHERE,
                                      lgt.pdf_li_sphere(lrow, o), pdf_light)
            p_l = pdf_light * pick_pmf
            denom_mis = _avg(r_u + r_l * p_l[..., None])
            denom0 = _avg(r_u)
            denom = jnp.where((depth == 0) | spec_bounce, denom0, denom_mis)
            L = L + jnp.where(is_emitter[..., None],
                              beta * Le / jnp.maximum(denom, _EPS)[..., None],
                              0.0)

        # --- escaped rays: image infinite light (env map) ---
        if scene.env is not None:
            escaped = active & reach & ~isect["hit"] & ~passthru
            Le_env = lgt.env_radiance(scene.env, d, lam, p=o)
            pmf_env = scene.light_sampler.pmf_table[scene.env.light_index]
            pdf_env = lgt.env_pdf_li(scene.env, d, p_ref=o) * pmf_env
            denom = jnp.where((depth == 0) | spec_bounce, _avg(r_u),
                              _avg(r_u + r_l * pdf_env[..., None]))
            L = L + jnp.where(escaped[..., None],
                              beta * Le_env /
                              jnp.maximum(denom, _EPS)[..., None], 0.0)

        # --- escaped rays: uniform infinite lights ---
        if scene.n_infinite > 0:
            escaped = active & reach & ~isect["hit"] & ~passthru
            Le_inf = lgt.infinite_light_radiance(scene.lights, lam,
                                                 scene.spectra_pool, d,
                                                 scene.inf_indices)
            inf_idx = scene.inf_indices[0]
            pmf_inf = scene.light_sampler.pmf_table[int(inf_idx)]
            pdf_inf = pmf_inf * (1.0 / (4.0 * np.pi))
            denom = jnp.where((depth == 0) | spec_bounce, _avg(r_u),
                              _avg(r_u + r_l * pdf_inf))
            L = L + jnp.where(escaped[..., None],
                              beta * Le_inf /
                              jnp.maximum(denom, _EPS)[..., None], 0.0)

        real_ev = hit | scattered      # events that consume a path bounce
        active = real_ev | passthru
        # --- shading geometry: Mix resolution + bump/normal mapping ---
        mat_res = mtl.resolve_mix(scene.materials, isect["mat"], isect["p"])
        ns = mtl.apply_normal_mapping(scene.materials, scene.textures,
                                      mat_res, isect)
        ng = isect["ng"]
        t1, t2 = _shading_frame(ns, isect["dpdu"])
        wo_local = _to_local(ns, t1, t2, isect["wo"])
        bp = mtl.get_bsdf_params(scene.materials, mat_res, lam,
                                 scene.spectra_pool, textures=scene.textures,
                                 uv=isect["uv"], p_world=isect["p"],
                                 ns=ns)

        # --- NEE (real events only; pass-throughs don't scatter) ---
        if scene.light_sampler.n_lights > 0:
            p_shade = jnp.where(scattered[..., None], p_med, isect["p"])
            Ld = sample_ld(p_shade, isect["p_err"], ns, ng, t1, t2, wo_local,
                           bp, real_ev, depth, r_u, scattered, -d, fl["g"],
                           seed_fl)
            L = L + beta * Ld

        # --- direction sampling for the next bounce ---
        base = _CAM_DIMS + depth * _DIMS_PER_BOUNCE
        uc = smp.sample_1d(sampler, px, py, sample_index, base + 3)
        u2 = smp.sample_2d(sampler, px, py, sample_index, base + 4)
        bs = bxdfs.bsdf_sample(bp, wo_local, uc, u2)
        wi_world = _to_world(ns, t1, t2, bs["wi"])
        cos_factor = jnp.abs(bs["wi"][..., 2])
        throughput = bs["f"] * safe_div(cos_factor, bs["pdf"])[..., None]
        sel_pdf = bs["pdf"]
        sel_valid = bs["valid"]
        sel_spec = bs["specular"]
        wi_hg, pdf_hg = usamp.sample_henyey_greenstein(u2, fl["g"], -d)
        wi_world = jnp.where(scattered[..., None], wi_hg, wi_world)
        throughput = jnp.where(scattered[..., None], 1.0, throughput)
        sel_pdf = jnp.where(scattered, pdf_hg, sel_pdf)
        sel_valid = jnp.where(scattered, pdf_hg > 0, sel_valid)
        sel_spec = jnp.where(scattered, False, sel_spec)
        # pass-throughs: continue straight, throughput/pdf state untouched,
        # the bounce is NOT consumed (reference: the !material continuation
        # in VolPathIntegrator::Li leaves depth unchanged)
        if has_ifaces:
            wi_world = jnp.where(passthru[..., None], d, wi_world)
            throughput = jnp.where(passthru[..., None], 1.0, throughput)
            sel_valid = sel_valid | passthru
            sel_spec = jnp.where(passthru, spec_bounce, sel_spec)
        beta_new = beta * throughput
        # r_l = r_u / scatter pdf (integrators.cpp:1174/1086)
        r_l_new = r_u / jnp.maximum(sel_pdf, _EPS)[..., None]
        r_l = jnp.where(passthru[..., None], r_l, r_l_new) if has_ifaces \
            else r_l_new
        term = jnp.asarray([4.0, 0.0, 0.0, 0.0], jnp.float32)
        first_disp = bs["dispersed"] & ~sec_term & ~passthru
        beta_new = jnp.where(first_disp[..., None], beta_new * term, beta_new)
        sec_term = sec_term | (bs["dispersed"] & real_ev)
        active = active & sel_valid & jnp.any(beta_new > 0, axis=-1) & \
            jnp.any(r_u > 0, axis=-1)
        beta = jnp.where(active[..., None], beta_new, beta)
        eta_scale = eta_scale * jnp.where(scattered | passthru, 1.0,
                                          bs["eta_scale"])

        # --- Russian roulette on beta*eta_scale/avg(r_u) (:1244) ---
        rr_beta_max = jnp.max(beta, axis=-1) * eta_scale / \
            jnp.maximum(_avg(r_u), _EPS)
        u_rr = smp.sample_1d(sampler, px, py, sample_index, base + 6)
        q = jnp.maximum(0.0, 1.0 - rr_beta_max)
        do_rr = (depth >= opts.rr_start_depth) & (rr_beta_max < 1.0) & \
            ~passthru
        killed = do_rr & (u_rr < q)
        active = active & ~killed
        beta = jnp.where((do_rr & ~killed)[..., None],
                         beta / jnp.maximum(1.0 - q, 1e-6)[..., None], beta)

        o_next = sc.offset_ray_origin_exact(isect["p"], isect["p_err"], ng,
                                            wi_world)
        o_next = jnp.where(scattered[..., None],
                           p_med + 1e-5 * wi_world, o_next)
        if has_ifaces:
            # interface crossing: continue from the interface point and
            # switch the ray's medium by crossing side (med_in behind the
            # geometric normal, med_out in front)
            p_if = o + d * ii["t"][..., None]
            o_if = sc.offset_ray_origin(p_if, ii["ng"], d)
            o_next = jnp.where(passthru[..., None], o_if, o_next)
            entering = vm.dot(d, ii["ng"]) < 0
            med_next = jnp.where(entering, ii["med_in"], ii["med_out"])
            cur_med = jnp.where(passthru, med_next, cur_med)
        depth = depth + jnp.where(real_ev, 1, 0).astype(jnp.int32)
        active = active & (depth < opts.max_depth)
        return (o_next, wi_world, beta, L, active, sel_spec, r_u, r_l,
                eta_scale, sec_term, cur_med, depth)

    # camera medium: point-in-box lookup at the ray origin (the parser
    # mirrors the reference's implicit camera-medium default; interface
    # shells in this framework are box-shaped so the box test is exact)
    cur_med0 = medium_index_at(scene.media, o) if has_ifaces \
        else jnp.full((N,), -1, jnp.int32)
    state = (o, d,
             jnp.ones((N, 4), jnp.float32),       # beta
             jnp.zeros((N, 4), jnp.float32),      # L
             jnp.ones((N,), bool),                # active
             jnp.zeros((N,), bool),               # specular bounce
             jnp.ones((N, 4), jnp.float32),       # r_u
             jnp.ones((N, 4), jnp.float32),       # r_l
             jnp.ones((N,), jnp.float32),         # eta_scale
             jnp.zeros((N,), bool),               # secondaries terminated
             cur_med0,                            # ray-carried medium
             jnp.zeros((N,), jnp.int32))          # per-lane bounce count
    # interface crossings don't consume bounces; give the loop slack to
    # cover enter/exit shells (2 crossings per box, a few boxes deep)
    n_iters = opts.max_depth + (8 if has_ifaces else 0)
    state = jax.lax.fori_loop(0, n_iters, body, state)
    return state[3]


def render_wave(scene: sc.Scene, camera: cam_mod.Camera,
                sampler: smp.SamplerParams, filt: flt.Filter,
                pixel_idx, sample_index, opts: PathOptions):
    """One volumetric sample wave (same front-end as path.render_wave)."""
    px = pixel_idx % camera.width
    py = pixel_idx // camera.width
    u_pix = smp.sample_pixel_2d(sampler, px, py, sample_index, 0)
    u_time = smp.sample_1d(sampler, px, py, sample_index, 2)
    u_lens = smp.sample_2d(sampler, px, py, sample_index, 3)
    u_lam = smp.sample_1d(sampler, px, py, sample_index, 5)
    if opts.sample_visible_wavelengths:
        swl = spc.sample_visible_wavelengths(u_lam)
    else:
        swl = spc.sample_uniform_wavelengths(u_lam)
    f_off, f_weight = flt.sample(filt, u_pix)
    p_film = jnp.stack([px.astype(jnp.float32) + 0.5 + f_off[..., 0],
                        py.astype(jnp.float32) + 0.5 + f_off[..., 1]],
                       axis=-1)
    o, d, _time, cam_wt = cam_mod.generate_ray_weighted(
        camera, p_film, u_lens, u_time)
    L = trace_paths(scene, sampler, px, py, sample_index, o, d, swl, opts)
    return L, swl, f_weight * cam_wt
