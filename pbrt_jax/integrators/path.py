"""Wavefront-style path integrator with NEE + MIS (reference
cpu/integrators.cpp PathIntegrator:628 / wavefront render loop,
wavefront/integrator.cpp).

Array mapping of the wavefront architecture (SURVEY.md §2.6): instead of
atomic-compaction work queues, all rays of a wave stay in fixed SoA arrays
with an active-lane mask; each `fori_loop` iteration is one wavefront depth
(the reference's GenerateRaySamples -> IntersectClosest -> shade -> shadow
pipeline fused into one XLA program). Dimension indexing follows the
reference's pre-drawn per-bounce sampler dimensions (samples.cpp:19).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from ..utils import struct

from .. import scene_core as sc
from .. import samplers as smp
from .. import bxdfs
from .. import materials as mtl
from .. import lights as lgt
from .. import lightsamplers as lsamp
from .. import cameras as cam_mod
from .. import filters as flt
from ..utils import vecmath as vm
from ..utils import spectrum as spc
from ..utils.math import power_heuristic, safe_div, sqr

# sampler dimension layout (camera: 0-4, lambda: 5, then 7 dims per bounce)
_CAM_DIMS = 6
_DIMS_PER_BOUNCE = 11  # +4 dims for the BSSRDF stage (entry, r, phi, ch)


@struct.dataclass
class PathOptions:
    max_depth: int = struct.field(pytree_node=False, default=5)
    rr_start_depth: int = struct.field(pytree_node=False, default=1)
    sample_visible_wavelengths: bool = struct.field(pytree_node=False, default=True)
    # per-depth wavefront counters (reference --stats ray counts,
    # wavefront/integrator.h:143-152): [active lanes, hits, shadow rays]
    collect_stats: bool = struct.field(pytree_node=False, default=False)
    # lane compaction (reference workqueue.h:41-137 compaction-by-
    # construction): from `compaction_start` on, each depth stable-sorts
    # live lanes to the front and dispatches the bounce on a power-of-two
    # bucket (N, N/2, N/4, N/8) picked DEVICE-side by lax.switch — dead
    # lanes past the bucket cost nothing, no host sync. Incompatible with
    # collect_stats.
    # False | True | "auto" (see _resolve_compaction)
    compaction: object = struct.field(pytree_node=False, default="auto")
    compaction_start: int = struct.field(pytree_node=False, default=1)


def _to_local(ns, t1, t2, w):
    return jnp.stack([vm.dot(w, t1), vm.dot(w, t2), vm.dot(w, ns)], axis=-1)


def _to_world(ns, t1, t2, w):
    return w[..., 0:1] * t1 + w[..., 1:2] * t2 + w[..., 2:3] * ns


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


def _resolve_compaction(scene, opts) -> bool:
    """Compaction "auto" resolution: OFF for every traversal route. The
    driver's per-depth lane sort and bucket switch cost more than the dead
    lanes they skip on the routes measured so far (cornell brute force;
    PERF.md); True forces it on."""
    use_comp = opts.compaction
    if use_comp == "auto":
        use_comp = False
    return bool(use_comp)


def _run_compacted(body, state, opts):
    """Compacted wavefront driver (reference workqueue.h:41-137 role):
    the depth loop is unrolled; from opts.compaction_start on, lanes are
    stable-sorted live-first and the bounce dispatches on the smallest
    power-of-two bucket (N, N/2, N/4, N/8) that holds the live set. The
    bucket index is computed on device and selected with lax.switch — no
    host round-trip. Dead lanes past the bucket are untouched (their L is
    final). Lane order is restored at the end."""
    N = state["o"].shape[0]

    def is_lane(k):
        # per-lane arrays (leading dim N, incl. the (N, 4, S) spec_cache)
        # sort/slice with the wavefront; the depth-stat counter table is
        # shared and must pass through untouched
        return k != "dstats"

    state = dict(state, lane=jnp.arange(N, dtype=jnp.int32))
    buckets = [N, max(1, N // 2), max(1, N // 4), max(1, N // 8)]
    for depth in range(opts.max_depth):
        if depth >= opts.compaction_start:
            order = jnp.argsort(~state["active"], stable=True)
            state = {k: (v[order] if is_lane(k) else v)
                     for k, v in state.items()}
            live = jnp.sum(state["active"])

            def make_branch(nb, depth=depth):
                def run(st):
                    sub = {k: (v[:nb] if is_lane(k) else v)
                           for k, v in st.items()}
                    lane_ids = sub.pop("lane")
                    out = body(depth, sub)
                    out["lane"] = lane_ids
                    return {k: (st[k].at[:nb].set(out[k]) if is_lane(k)
                                else out[k]) for k in st}
                return run

            idx = jnp.where(live > buckets[1], 0,
                  jnp.where(live > buckets[2], 1,
                  jnp.where(live > buckets[3], 2, 3)))
            state = jax.lax.switch(idx, [make_branch(nb) for nb in buckets],
                                   state)
        else:
            lane_ids = state.pop("lane")
            state = body(depth, state)
            state["lane"] = lane_ids
    inv = jnp.argsort(state["lane"])
    state = {k: (v[inv] if is_lane(k) else v) for k, v in state.items()}
    state.pop("lane")
    return state


def trace_paths(scene: sc.Scene, sampler: smp.SamplerParams, px, py,
                sample_index, o, d, swl: spc.SampledWavelengths,
                opts: PathOptions, cone_spread=None, time=None):
    """Trace one wave of paths. px/py: (N,) pixel ints; o, d: (N, 3) camera
    rays. Returns L (N, 4) spectral radiance estimates (pdf NOT divided out —
    the film's sensor projection divides by swl.pdf).

    cone_spread: per-ray angular spread (radians/unit-length) of the pixel
    ray cone — the vectorized substitution for the reference's dual
    differential rays (cameras.h:140 Approximate_dp_dxy): texture LOD at a
    hit comes from the cone width divided by the surface's dpdu/dpdv
    lengths."""
    N = o.shape[0]
    lam = swl.lam
    # wavelengths are fixed along a path: evaluate EVERY pool spectrum once
    # per wave (one row gather), then per-depth light/material spectrum
    # lookups are tiny one-hot selects (profiled: the per-depth gathers were
    # 67% of wave time on the cornell bench)
    spec_cache = None
    if scene.spectra_pool.shape[0] <= lgt.SPEC_CACHE_MAX:
        spec_cache = lgt.eval_all_spectra(scene.spectra_pool, lam)

    def body(depth, state):
        # every per-lane array rides in the state dict so the compaction
        # driver can stable-sort + slice the whole wavefront at once
        o, d = state["o"], state["d"]
        beta, L = state["beta"], state["L"]
        active, spec_bounce = state["active"], state["spec"]
        prev_pdf, eta_scale = state["prev_pdf"], state["eta"]
        sec_term = state["sec"]
        cone_w, cone_s = state["cone_w"], state["cone_s"]
        dstats = state["dstats"]
        px, py, sample_index = state["px"], state["py"], state["si"]
        lam = state["lam"]
        spec_cache = state.get("spec_cache")
        time = state.get("time")
        N = o.shape[0]

        def nee(p, p_err, ns, ng, t1, t2, wo_local, bp, active, depth):
            """Next-event estimation (reference SampleLd,
            integrators.cpp:764)."""
            base = _CAM_DIMS + depth * _DIMS_PER_BOUNCE
            u_pick = smp.sample_1d(sampler, px, py, sample_index, base)
            u_l = smp.sample_2d(sampler, px, py, sample_index, base + 1)
            li_idx, pmf, u_pick2 = lsamp.sample_light(scene.light_sampler,
                                                      u_pick, p=p)
            li_idx = jnp.maximum(li_idx, 0)
            ls = lgt.sample_li(scene.lights, li_idx, p, ns, u_l, lam,
                               scene.spectra_pool, scene.tri_geo,
                               scene.scene_radius, env=scene.env,
                               spec_cache=spec_cache)
            wi = ls["wi"]
            wi_local = _to_local(ns, t1, t2, wi)
            f = bxdfs.bsdf_f(bp, wo_local, wi_local) * \
                jnp.abs(wi_local[..., 2])[..., None]
            pdf_b = bxdfs.bsdf_pdf(bp, wo_local, wi_local)
            pdf_l = ls["pdf"] * pmf
            contrib_ok = active & ls["valid"] & (pdf_l > 0) & \
                jnp.any(f > 0, axis=-1)
            o_sh = sc.offset_ray_origin_exact(p, p_err, ng, wi)
            dist = vm.length(ls["p_light"] - o_sh)
            occluded = sc.intersect_p(scene, o_sh, wi, dist * 0.999,
                                      time=time)
            contrib_ok = contrib_ok & ~occluded
            w_mis = jnp.where(ls["is_delta"], 1.0,
                              power_heuristic(1.0, pdf_l, 1.0, pdf_b))
            Ld = f * ls["L"] * safe_div(w_mis, pdf_l)[..., None]
            return jnp.where(contrib_ok[..., None], Ld, 0.0)

        if opts.collect_stats:
            dstats = dstats.at[depth, 0].set(jnp.sum(active))
        isect = sc.intersect(scene, o, d, jnp.full((N,), 1e30, jnp.float32),
                             time=time)
        if opts.collect_stats:
            dstats = dstats.at[depth, 1].set(
                jnp.sum(active & isect["hit"]))
        # ray cone at the hit: width grows linearly with distance
        cone_w = cone_w + cone_s * jnp.where(isect["hit"], isect["t"], 0.0)
        hit = isect["hit"] & active

        # --- emitted radiance at hits of emissive triangles ---
        if scene.has_area_lights:
            light_idx = isect["light"]
            is_emitter = hit & (light_idx >= 0)
            li_safe = jnp.maximum(light_idx, 0)
            from ..ops.gather import pool_lookup
            lrow = lgt.LightRow(pool_lookup(scene.lights.packed, li_safe))
            Le = lgt.area_light_radiance(lrow, isect["ng"], isect["wo"], lam,
                                         scene.spectra_pool,
                                         spec_cache=spec_cache)
            # the hit triangle IS the light's triangle: reuse intersect's verts
            tri_rows = jnp.concatenate([isect["p0"], isect["p1"], isect["p2"]],
                                       axis=-1)
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
            pdf_light = pdf_light * pick_pmf
            w_emit = jnp.where((depth == 0) | spec_bounce, 1.0,
                               power_heuristic(1.0, prev_pdf, 1.0, pdf_light))
            L = L + jnp.where(is_emitter[..., None],
                              beta * Le * w_emit[..., None], 0.0)

        # --- escaped rays: image infinite light (env map) ---
        if scene.env is not None:
            escaped = active & ~isect["hit"]
            Le_env = lgt.env_radiance(scene.env, d, lam, p=o)
            pmf_env = scene.light_sampler.pmf_table[scene.env.light_index]
            pdf_env = lgt.env_pdf_li(scene.env, d, p_ref=o) * pmf_env
            w_env = jnp.where((depth == 0) | spec_bounce, 1.0,
                              power_heuristic(1.0, prev_pdf, 1.0, pdf_env))
            L = L + jnp.where(escaped[..., None],
                              beta * Le_env * w_env[..., None], 0.0)

        # --- escaped rays: uniform infinite lights ---
        if scene.n_infinite > 0:
            escaped = active & ~isect["hit"]
            Le_inf = lgt.infinite_light_radiance(scene.lights, lam,
                                                 scene.spectra_pool, d,
                                                 scene.inf_indices,
                                                 spec_cache=spec_cache)
            # MIS vs uniform-sphere light sampling (static index: no gather)
            inf_idx = scene.inf_indices[0]
            pmf_inf = scene.light_sampler.pmf_table[int(inf_idx)]
            pdf_inf = pmf_inf * (1.0 / (4.0 * np.pi))
            w_inf = jnp.where((depth == 0) | spec_bounce, 1.0,
                              power_heuristic(1.0, prev_pdf, 1.0, pdf_inf))
            L = L + jnp.where(escaped[..., None], beta * Le_inf * w_inf[..., None], 0.0)

        active = hit
        # --- shading geometry: Mix resolution + bump/normal mapping ---
        mat_res = mtl.resolve_mix(scene.materials, isect["mat"], isect["p"])
        ns = mtl.apply_normal_mapping(scene.materials, scene.textures,
                                      mat_res, isect)
        ng = isect["ng"]
        t1, t2 = _shading_frame(ns, isect["dpdu"])
        wo_local = _to_local(ns, t1, t2, isect["wo"])
        # uv-space footprint of the cone (for MIP selection): cone width
        # projected through the parametric derivatives
        inv_dpdu = 1.0 / jnp.maximum(vm.length(isect["dpdu"]), 1e-8)
        inv_dpdv = 1.0 / jnp.maximum(vm.length(isect["dpdv"]), 1e-8)
        footprint = cone_w * jnp.maximum(inv_dpdu, inv_dpdv)
        bp = mtl.get_bsdf_params(scene.materials, mat_res, lam,
                                 scene.spectra_pool, textures=scene.textures,
                                 uv=isect["uv"], p_world=isect["p"],
                                 spec_cache=spec_cache, footprint=footprint,
                                 ns=ns, prim=isect["prim"])


        # --- BSSRDF stage (reference bssrdf.h:105 + wavefront
        # subsurface.cpp): subsurface lanes teleport to a probed exit
        # point, weighted by the Burley normalized-diffusion profile
        # Sp(r)/pdf, then shade as a normalized-Fresnel (diffuse) lobe.
        if scene.materials.has_subsurface:
            is_sss = (bp.tag == bxdfs.BXDF_SUBSURFACE) & active
            base_s = _CAM_DIMS + depth * _DIMS_PER_BOUNCE
            u_ent = smp.sample_1d(sampler, px, py, sample_index, base_s + 7)
            u_ch = smp.sample_1d(sampler, px, py, sample_index, base_s + 8)
            u_rp = smp.sample_2d(sampler, px, py, sample_index, base_s + 9)
            eta_s = bp.eta[..., 0]
            Fr_in = bxdfs.fr_dielectric(wo_local[..., 2], eta_s)
            enter = is_sss & (u_ent >= Fr_in)
            mirror = is_sss & ~enter
            # channel choice (uniform over 4 wavelengths)
            ch = jnp.clip((u_ch * 4.0).astype(jnp.int32), 0, 3)
            oh = (ch[..., None] == jnp.arange(4, dtype=jnp.int32))
            u_r = u_rp[..., 0]
            tabulated = scene.materials.sss_tabulated
            if tabulated:
                # photon-beam-diffusion table (bssrdf.cpp:26-128): rho(λ)
                # rides the albedo slot, sigma_t(λ) the k slot; radius
                # sampled from the tabulated radial CDF of the chosen λ
                from .. import bssrdf as _bs
                tbl = scene.materials.sss_table
                rho4 = jnp.clip(bp.albedo, 0.0, 1.0)
                st4 = jnp.maximum(bp.k, 1e-6)
                rho_c = jnp.sum(rho4 * oh, axis=-1)
                st_c = jnp.sum(st4 * oh, axis=-1)
                r_s, r_max = _bs.sample_r(tbl, rho_c, st_c,
                                          jnp.clip(u_r, 1e-6, 1 - 1e-6))
            else:
                # Burley two-exponential stand-in profile
                d_spec = jnp.maximum(bp.k, 1e-6)
                d_c = jnp.sum(d_spec * oh, axis=-1)
                pick3e = u_r < 0.25
                u_e = jnp.where(pick3e, u_r / 0.25, (u_r - 0.25) / 0.75)
                u_e = jnp.clip(u_e, 1e-6, 1.0 - 1e-6)
                r_s = jnp.where(pick3e, -d_c * jnp.log(1.0 - u_e),
                                -3.0 * d_c * jnp.log(1.0 - u_e))
                r_max = 12.0 * d_c
                r_s = jnp.minimum(r_s, r_max)
            phi_s = 2.0 * np.pi * u_rp[..., 1]
            # probe ray: disk point above the surface, cast along -ns
            h_probe = jnp.sqrt(jnp.maximum(sqr(r_max) - sqr(r_s), 1e-12))
            p_disk = isect["p"] + r_s[..., None] * (
                jnp.cos(phi_s)[..., None] * t1 +
                jnp.sin(phi_s)[..., None] * t2) + h_probe[..., None] * ns
            probe = sc.intersect(scene, p_disk, -ns,
                                 jnp.full((N,), 1.0) * (2.0 * h_probe))
            same_mat = probe["mat"] == mat_res
            found = enter & probe["hit"] & same_mat
            # actual entry->exit distance; profile + combined-channel pdf
            r_hit = vm.length(probe["p"] - isect["p"])
            r_eval = jnp.maximum(r_hit, 1e-6)
            cos_axis = jnp.abs(vm.dot(probe["ng"], ns))
            if tabulated:
                q_r, pdf_r, _re = _bs.radial_profile_pdf(tbl, rho4, st4,
                                                         r_eval)
                # the tabulated profile carries the color: no albedo factor
                w_sp = safe_div(q_r, (pdf_r * jnp.maximum(cos_axis, 0.1)
                                      )[..., None])
            else:
                def _profile(r, dd):
                    # Sr(r) * 2*pi*r (radial density), per channel
                    return 0.25 / dd * (jnp.exp(-r / dd) +
                                        jnp.exp(-r / (3.0 * dd)))

                sp_r = _profile(r_eval[..., None], d_spec)      # (N, 4)
                pdf_r = jnp.mean(sp_r, axis=-1)                 # channel MIS
                w_sp = safe_div(sp_r, (pdf_r * jnp.maximum(cos_axis, 0.1)
                                       )[..., None])
                w_sp = w_sp * bp.albedo  # diffuse albedo of the profile
            beta = jnp.where(found[..., None], beta * w_sp, beta)
            # entry that found no exit terminates (reference: no probe
            # intersection -> path break)
            active = active & ~(enter & ~found)
            # teleport shading point to the exit
            tele = found[..., None]
            p_new = probe["p"]
            ns_new = jnp.where(vm.dot(probe["ns"], ns)[..., None] < 0,
                               -probe["ns"], probe["ns"])
            isect = dict(isect,
                         p=jnp.where(tele, p_new, isect["p"]),
                         ns=jnp.where(tele, ns_new, isect["ns"]),
                         ng=jnp.where(tele, ns_new, isect["ng"]))
            ns = jnp.where(tele, ns_new, ns)
            ng = jnp.where(tele, ns_new, ng)
            t1n, t2n = vm.coordinate_system(ns_new)
            t1 = jnp.where(tele, t1n, t1)
            t2 = jnp.where(tele, t2n, t2)
            # exit lobe: normalized Fresnel ~ diffuse with albedo
            # (1 - 2 c1(1/eta))^-1-normalized transmission; fold the
            # normalization into a white-ish diffuse albedo
            c_norm = jnp.maximum(1.0 - 2.0 *
                                 bxdfs.fresnel_moment1(1.0 / eta_s), 1e-3)
            alb_exit = jnp.clip((1.0 - Fr_in) / c_norm, 0.0, 1.0)
            tag_new = jnp.where(found, bxdfs.BXDF_DIFFUSE,
                       jnp.where(mirror, bxdfs.BXDF_CONDUCTOR, bp.tag))
            bp = bp.replace(
                tag=tag_new,
                albedo=jnp.where(tele, alb_exit[..., None] *
                                 jnp.ones_like(bp.albedo), bp.albedo),
                # mirror lanes: smooth conductor with F ~= 1 (the entry
                # reflection was already selected with probability Fr)
                alpha_x=jnp.where(mirror, 0.0, bp.alpha_x),
                alpha_y=jnp.where(mirror, 0.0, bp.alpha_y),
                eta=jnp.where(mirror[..., None], 1.0, bp.eta),
                k=jnp.where(mirror[..., None], 1e4, bp.k))
            # refresh wo in the exit frame (wo = -probe direction = +ns)
            wo_world = jnp.where(tele, ns, isect["wo"])
            isect = dict(isect, wo=wo_world)
            wo_local = _to_local(ns, t1, t2, wo_world)

        # --- NEE ---
        if scene.light_sampler.n_lights > 0:
            if opts.collect_stats:
                dstats = dstats.at[depth, 2].set(jnp.sum(active))
            Ld = nee(isect["p"], isect["p_err"], ns, ng, t1, t2, wo_local,
                     bp, active, depth)
            L = L + beta * Ld

        # --- BSDF sampling for the next bounce ---
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
        beta_new = beta * throughput
        # dispersion: terminate secondary wavelengths, hero carries 4x weight
        # (reference SampledWavelengths::TerminateSecondary semantics folded
        # into beta; the film divides by the original per-lambda pdfs).
        # TerminateSecondary is idempotent (spectrum.h): reweight only on the
        # FIRST dispersive event — a path refracting through a dispersive
        # dielectric twice must get 4x, not 16x.
        term = jnp.asarray([4.0, 0.0, 0.0, 0.0], jnp.float32)
        first_disp = bs["dispersed"] & ~sec_term
        beta_new = jnp.where(first_disp[..., None], beta_new * term,
                             beta_new)
        sec_term = sec_term | (bs["dispersed"] & active)
        active = active & sel_valid & jnp.any(beta_new > 0, axis=-1)
        beta = jnp.where(active[..., None], beta_new, beta)
        eta_scale = eta_scale * bs["eta_scale"]

        # --- Russian roulette on beta * eta_scale (integrators.cpp:749) ---
        rr_beta_max = jnp.max(beta, axis=-1) * eta_scale
        u_rr = smp.sample_1d(sampler, px, py, sample_index, base + 6)
        q = jnp.maximum(0.0, 1.0 - rr_beta_max)
        do_rr = (depth >= opts.rr_start_depth) & (rr_beta_max < 1.0)
        killed = do_rr & (u_rr < q)
        active = active & ~killed
        beta = jnp.where((do_rr & ~killed)[..., None],
                         beta / jnp.maximum(1.0 - q, 1e-6)[..., None], beta)

        o_next = sc.offset_ray_origin_exact(isect["p"], isect["p_err"], ng,
                                            wi_world)
        # cone spread widens on non-specular bounces (curvature/roughness
        # spread heuristic; reference carries full dual differentials,
        # surfscatter.cpp:75-105 — ray cones are the O(1)-state analog)
        cone_s = cone_s + jnp.where(bs["specular"], 0.0, 0.25)
        return dict(state, o=o_next, d=wi_world, beta=beta, L=L,
                    active=active, spec=sel_spec, prev_pdf=sel_pdf,
                    eta=eta_scale, sec=sec_term, cone_w=cone_w,
                    cone_s=cone_s, dstats=dstats)

    spread0 = jnp.zeros((N,), jnp.float32) if cone_spread is None else \
        jnp.broadcast_to(jnp.asarray(cone_spread, jnp.float32), (N,))
    state = dict(
        o=o, d=d,
        beta=jnp.ones((N, 4), jnp.float32),
        L=jnp.zeros((N, 4), jnp.float32),
        active=jnp.ones((N,), bool),
        spec=jnp.zeros((N,), bool),          # specular bounce
        prev_pdf=jnp.ones((N,), jnp.float32),
        eta=jnp.ones((N,), jnp.float32),
        sec=jnp.zeros((N,), bool),           # secondaries terminated
        cone_w=jnp.zeros((N,), jnp.float32),
        cone_s=spread0,
        dstats=jnp.zeros((opts.max_depth, 3), jnp.int32),
        px=px, py=py, si=sample_index, lam=lam)
    if spec_cache is not None:
        state["spec_cache"] = spec_cache
    if time is not None:
        state["time"] = time
    use_comp = _resolve_compaction(scene, opts)
    if use_comp and not opts.collect_stats:
        state = _run_compacted(body, state, opts)
    else:
        state = jax.lax.fori_loop(0, opts.max_depth, body, state)
    if opts.collect_stats:
        return state["L"], state["dstats"]
    return state["L"]


def render_wave(scene: sc.Scene, camera: cam_mod.Camera,
                sampler: smp.SamplerParams, filt: flt.Filter,
                pixel_idx, sample_index, opts: PathOptions):
    """One sample-per-pixel wave over a batch of pixels.

    pixel_idx: (N,) flat pixel ids; sample_index: (N,) per-pixel sample no.
    Returns (rgb-ready spectral L (N, 4), swl, filter_weight (N,)).
    """
    px = pixel_idx % camera.width
    py = pixel_idx // camera.width
    from ..options import get_options
    _gopts = get_options()
    u_pix = smp.sample_pixel_2d(sampler, px, py, sample_index, 0)
    u_time = smp.sample_1d(sampler, px, py, sample_index, 2)
    u_lens = smp.sample_2d(sampler, px, py, sample_index, 3)
    u_lam = smp.sample_1d(sampler, px, py, sample_index, 5)
    if _gopts.disable_pixel_jitter:
        u_pix = jnp.full_like(u_pix, 0.5)
    if _gopts.disable_wavelength_jitter:
        u_lam = jnp.full_like(u_lam, 0.5)
    if opts.sample_visible_wavelengths:
        swl = spc.sample_visible_wavelengths(u_lam)
    else:
        swl = spc.sample_uniform_wavelengths(u_lam)
    f_off, f_weight = flt.sample(filt, u_pix)
    p_film = jnp.stack([px.astype(jnp.float32) + 0.5 + f_off[..., 0],
                        py.astype(jnp.float32) + 0.5 + f_off[..., 1]], axis=-1)
    o, d, _time, cam_wt = cam_mod.generate_ray_weighted(
        camera, p_film, u_lens, u_time)
    cone_spread = cam_mod.pixel_cone_spread(camera)
    L = trace_paths(scene, sampler, px, py, sample_index, o, d, swl, opts,
                    cone_spread=cone_spread, time=_time)
    if opts.collect_stats:
        # trace_paths returns (L, per-depth counters) in stats mode; the
        # render path only consumes L (use trace_paths directly for stats).
        L, _ = L
    return L, swl, f_weight * cam_wt
