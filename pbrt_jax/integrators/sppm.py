"""Stochastic progressive photon mapping.

Role model: the reference's ``SPPMIntegrator`` (cpu/integrators.h:436,
integrators.cpp:2811+): per iteration a camera pass stores one visible
point per pixel (first diffuse vertex, direct lighting accumulated
separately into Ld), a photon pass traces light paths and deposits power
onto visible points within their search radii via a spatial hash grid, and
the per-pixel statistics follow the progressive update
    n' = n + 2/3 m,  r' = r sqrt(n'/(n+m)),  tau' = (tau + Phi) r'^2/r^2
with the final estimate L = Ld/iters + tau/(N_photons pi r^2)
(integrators.cpp:2856, 3199).

Shape: the camera and photon passes are jitted masked-lane wavefronts;
the photon->visible-point range search runs on a host-rebuilt sorted
hash-cell table per iteration (cells sized to the current max radius, each
VP listed in the up-to-8 cells its disc overlaps), with a bounded K-entry
scan per deposit (overflow entries are counted and reported).

Documented divergences: visible-point BSDFs are evaluated as Lambertian
(albedo/pi with a hemisphere-side check) — the reference evaluates the full
BSDF; VPs are stored at diffuse vertices only (the reference also accepts
glossy vertices at the depth limit).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .. import scene_core as sc
from .. import samplers as smp
from .. import cameras as cam_mod
from .. import lights as lgt
from .. import lightsamplers as lsamp
from .. import materials as mtl
from .. import bxdfs
from .. import film as film_mod
from ..utils import spectrum as spc
from ..utils import vecmath as vm
from ..utils.math import safe_div, power_heuristic
from .path import PathOptions, _to_local, _to_world, _shading_frame
from .lightpath import _positionless_sampler

_CAM = 6
_PER_DEPTH = 8


def _camera_pass(scene, camera, sensor, sampler, pixel_idx, it, swl,
                 max_depth):
    """Trace camera paths; returns per-pixel dict: Ld (N,3) this-iteration
    direct light, vp fields (p, ns, wo_side, beta (N,4), albedo (N,4),
    valid)."""
    N = pixel_idx.shape[0]
    lam = swl.lam
    px = pixel_idx % camera.width
    py = pixel_idx // camera.width
    spec_cache = None
    if scene.spectra_pool.shape[0] <= lgt.SPEC_CACHE_MAX:
        spec_cache = lgt.eval_all_spectra(scene.spectra_pool, lam)
    si = jnp.full((N,), it, jnp.int32)
    u_pix = smp.sample_pixel_2d(sampler, px, py, si, 0)
    u_lens = smp.sample_2d(sampler, px, py, si, 3)
    p_film = jnp.stack([px.astype(jnp.float32) + u_pix[..., 0],
                        py.astype(jnp.float32) + u_pix[..., 1]], -1)
    o, d, _t = cam_mod.generate_ray(camera, p_film, u_lens,
                                    jnp.zeros((N,), jnp.float32))

    def to_rgb(L):
        return film_mod.sensor_to_sensor_rgb(sensor, L, swl)

    state = dict(o=o, d=d, beta=jnp.ones((N, 4), jnp.float32),
                 Ld=jnp.zeros((N, 4), jnp.float32),
                 active=jnp.ones((N,), bool),
                 spec=jnp.ones((N,), bool),
                 prev_pdf=jnp.ones((N,), jnp.float32),
                 vp_p=jnp.zeros((N, 3), jnp.float32),
                 vp_ns=jnp.zeros((N, 3), jnp.float32),
                 vp_t1=jnp.zeros((N, 3), jnp.float32),
                 vp_t2=jnp.zeros((N, 3), jnp.float32),
                 vp_wo=jnp.zeros((N, 3), jnp.float32),
                 vp_wo_up=jnp.zeros((N,), bool),
                 vp_beta=jnp.zeros((N, 4), jnp.float32),
                 # full stored BSDF (reference SPPM stores the VP's BSDF
                 # and evaluates f(wo, wi_photon) per photon,
                 # cpu/integrators.cpp:2763+)
                 vp_tag=jnp.full((N,), -1, jnp.int32),
                 vp_albedo=jnp.zeros((N, 4), jnp.float32),
                 vp_ax=jnp.zeros((N,), jnp.float32),
                 vp_ay=jnp.zeros((N,), jnp.float32),
                 vp_eta=jnp.ones((N, 4), jnp.float32),
                 vp_k=jnp.zeros((N, 4), jnp.float32),
                 vp_valid=jnp.zeros((N,), bool))

    def body(depth, st):
        o, d, beta = st["o"], st["d"], st["beta"]
        active = st["active"]
        isect = sc.intersect(scene, o, d, jnp.full((N,), 1e30, jnp.float32))
        hit = isect["hit"] & active
        # emission (MIS like the path integrator)
        if scene.has_area_lights:
            from ..ops.gather import pool_lookup
            li = isect["light"]
            lrow = lgt.LightRow(pool_lookup(scene.lights.packed,
                                            jnp.maximum(li, 0)))
            Le = lgt.area_light_radiance(lrow, isect["ng"], isect["wo"], lam,
                                         scene.spectra_pool,
                                         spec_cache=spec_cache)
            tri_rows = jnp.concatenate([isect["p0"], isect["p1"],
                                        isect["p2"]], -1)
            pdf_l = lgt.pdf_li_area_tri(lrow, o, d, isect["p"],
                                        tri_rows) * lrow.pmf
            w_e = jnp.where((depth == 0) | st["spec"], 1.0,
                            power_heuristic(1.0, st["prev_pdf"], 1.0, pdf_l))
            st["Ld"] = st["Ld"] + jnp.where(
                (hit & (li >= 0))[..., None], beta * Le * w_e[..., None],
                0.0)
        if scene.env is not None:
            esc = active & ~isect["hit"]
            Le_env = lgt.env_radiance(scene.env, d, lam, p=o)
            pmf_env = scene.light_sampler.pmf_table[scene.env.light_index]
            pdf_env = lgt.env_pdf_li(scene.env, d, p_ref=o) * pmf_env
            w_env = jnp.where((depth == 0) | st["spec"], 1.0,
                              power_heuristic(1.0, st["prev_pdf"], 1.0,
                                              pdf_env))
            st["Ld"] = st["Ld"] + jnp.where(esc[..., None],
                                            beta * Le_env *
                                            w_env[..., None], 0.0)
        active = hit
        mat_res = mtl.resolve_mix(scene.materials, isect["mat"], isect["p"])
        ns = mtl.apply_normal_mapping(scene.materials, scene.textures,
                                      mat_res, isect)
        ng = isect["ng"]
        t1, t2 = _shading_frame(ns, isect["dpdu"])
        wo_local = _to_local(ns, t1, t2, isect["wo"])
        bp = mtl.get_bsdf_params(scene.materials, mat_res, lam,
                                 scene.spectra_pool, textures=scene.textures,
                                 uv=isect["uv"], p_world=isect["p"],
                                 spec_cache=spec_cache, ns=ns)
        # NEE
        base = _CAM + depth * _PER_DEPTH
        if scene.light_sampler.n_lights > 0:
            u_pick = smp.sample_1d(sampler, px, py, si, base)
            u_l = smp.sample_2d(sampler, px, py, si, base + 1)
            li_idx, pmf, _ = lsamp.sample_light(scene.light_sampler, u_pick,
                                                p=isect["p"])
            li_idx = jnp.maximum(li_idx, 0)
            ls = lgt.sample_li(scene.lights, li_idx, isect["p"], ns, u_l,
                               lam, scene.spectra_pool, scene.tri_geo,
                               scene.scene_radius, env=scene.env,
                               spec_cache=spec_cache)
            wi_local = _to_local(ns, t1, t2, ls["wi"])
            f = bxdfs.bsdf_f(bp, wo_local, wi_local) * \
                jnp.abs(wi_local[..., 2])[..., None]
            pdf_b = bxdfs.bsdf_pdf(bp, wo_local, wi_local)
            pdf_l = ls["pdf"] * pmf
            ok = active & ls["valid"] & (pdf_l > 0) & jnp.any(f > 0, -1)
            o_sh = sc.offset_ray_origin(isect["p"], ng, ls["wi"])
            dist = vm.length(ls["p_light"] - o_sh)
            occ = sc.intersect_p(scene, o_sh, ls["wi"], dist * 0.999)
            w_mis = jnp.where(ls["is_delta"], 1.0,
                              power_heuristic(1.0, pdf_l, 1.0, pdf_b))
            Ld1 = f * ls["L"] * safe_div(w_mis, pdf_l)[..., None]
            st["Ld"] = st["Ld"] + jnp.where((ok & ~occ)[..., None],
                                            beta * Ld1, 0.0)
        # store the VP at the first diffuse vertex (stop the lane), or at
        # a glossy vertex on the LAST camera depth (reference
        # SPPM visible-point rule: IsDiffuse || (IsGlossy && depth == max),
        # cpu/integrators.cpp:2763+); the full BSDF is captured so the
        # photon pass evaluates f(wo, wi_photon) instead of albedo/pi
        diffuse_tags = (bxdfs.BXDF_DIFFUSE, bxdfs.BXDF_COATED_DIFFUSE,
                        bxdfs.BXDF_DIFFUSE_TRANSMISSION)
        is_diffuse = jnp.zeros((N,), bool)
        for t_ in diffuse_tags:
            is_diffuse = is_diffuse | (bp.tag == t_)
        rough = jnp.maximum(bp.alpha_x, bp.alpha_y) > 1e-3
        is_glossy = rough & ((bp.tag == bxdfs.BXDF_CONDUCTOR) |
                             (bp.tag == bxdfs.BXDF_DIELECTRIC) |
                             (bp.tag == bxdfs.BXDF_COATED_CONDUCTOR))
        storeable = is_diffuse | (is_glossy & (depth == max_depth - 1))
        store = active & storeable & ~st["vp_valid"]
        st["vp_p"] = jnp.where(store[..., None], isect["p"], st["vp_p"])
        st["vp_ns"] = jnp.where(store[..., None], ns, st["vp_ns"])
        st["vp_t1"] = jnp.where(store[..., None], t1, st["vp_t1"])
        st["vp_t2"] = jnp.where(store[..., None], t2, st["vp_t2"])
        st["vp_wo"] = jnp.where(store[..., None], isect["wo"], st["vp_wo"])
        st["vp_wo_up"] = jnp.where(store,
                                   vm.dot(isect["wo"], ns) > 0,
                                   st["vp_wo_up"])
        st["vp_beta"] = jnp.where(store[..., None], beta, st["vp_beta"])
        st["vp_tag"] = jnp.where(store, bp.tag, st["vp_tag"])
        st["vp_albedo"] = jnp.where(store[..., None], bp.albedo,
                                    st["vp_albedo"])
        st["vp_ax"] = jnp.where(store, bp.alpha_x, st["vp_ax"])
        st["vp_ay"] = jnp.where(store, bp.alpha_y, st["vp_ay"])
        st["vp_eta"] = jnp.where(store[..., None], bp.eta, st["vp_eta"])
        st["vp_k"] = jnp.where(store[..., None], bp.k, st["vp_k"])
        st["vp_valid"] = st["vp_valid"] | store
        active = active & ~store

        # continue through specular/glossy vertices
        uc = smp.sample_1d(sampler, px, py, si, base + 3)
        u2 = smp.sample_2d(sampler, px, py, si, base + 4)
        bs = bxdfs.bsdf_sample(bp, wo_local, uc, u2)
        wi_world = _to_world(ns, t1, t2, bs["wi"])
        beta_new = beta * bs["f"] * safe_div(jnp.abs(bs["wi"][..., 2]),
                                             bs["pdf"])[..., None]
        active = active & bs["valid"] & jnp.any(beta_new > 0, -1)
        beta = jnp.where(active[..., None], beta_new, beta)
        o2 = sc.offset_ray_origin(isect["p"], ng, wi_world)
        return dict(st, o=o2, d=wi_world, beta=beta, active=active,
                    spec=bs["specular"], prev_pdf=bs["pdf"])

    st = jax.lax.fori_loop(0, max_depth, body, state)
    # vp fields stay SPECTRAL: the deposit evaluates the stored BSDF
    # against each photon direction, multiplies by the photon's spectral
    # beta, and converts the product (reference film.ToOutputRGB(vp.beta *
    # Phi, lambda)); both passes share one lambda
    return dict(Ld=to_rgb(st["Ld"]), vp_p=st["vp_p"], vp_ns=st["vp_ns"],
                vp_t1=st["vp_t1"], vp_t2=st["vp_t2"], vp_wo=st["vp_wo"],
                vp_wo_up=st["vp_wo_up"], vp_beta=st["vp_beta"],
                vp_tag=st["vp_tag"], vp_albedo=st["vp_albedo"],
                vp_ax=st["vp_ax"], vp_ay=st["vp_ay"], vp_eta=st["vp_eta"],
                vp_k=st["vp_k"], vp_valid=st["vp_valid"])


def _photon_pass(scene, sensor, sampler, n_photons, it, swl, max_depth,
                 ls_power, vp, grid, K):
    """Trace photons and deposit onto visible points.

    grid: dict(lo (3,), inv_cell (), cells_sorted (E,), vp_sorted (E,),
    n_entries ()); returns (Phi (HW, 3) adds, M (HW,) adds, dropped count).
    """
    N = n_photons
    lam = swl.lam
    # stored-VP BSDF dispatch compiles only the scene's material tags
    vp_tags_present = scene.materials.bxdf_tags_present
    lane = jnp.arange(N, dtype=jnp.int32)
    py0 = jnp.full((N,), 7919, jnp.int32)  # decorrelate from camera pass
    si = jnp.full((N,), it, jnp.int32)
    spec_cache = None
    if scene.spectra_pool.shape[0] <= lgt.SPEC_CACHE_MAX:
        spec_cache = lgt.eval_all_spectra(scene.spectra_pool, lam)
    u_pick = smp.sample_1d(sampler, lane, py0, si, 0)
    u0 = smp.sample_2d(sampler, lane, py0, si, 1)
    u1 = smp.sample_2d(sampler, lane, py0, si, 3)
    li, pmf, _ = lsamp.sample_light(ls_power, u_pick)
    li = jnp.maximum(li, 0)
    les = lgt.sample_le(scene.lights, li, u0, u1, lam, scene.spectra_pool,
                        scene.tri_geo, scene.scene_radius,
                        0.5 * (scene.world_lo + scene.world_hi),
                        env=scene.env, spec_cache=spec_cache)
    cos0 = jnp.where(les["has_area"],
                     jnp.abs(vm.dot(les["n_l"], les["d"])), 1.0)
    beta = les["L"] * safe_div(cos0, pmf * les["pdf_pos"]
                               * les["pdf_dir"])[..., None]
    active = les["valid"] & (pmf > 0) & jnp.any(beta > 0, -1)
    o = jnp.where(les["has_area"][..., None],
                  sc.offset_ray_origin(les["o"], les["n_l"], les["d"]),
                  les["o"])
    d = les["d"]

    cells_sorted = grid["cells_sorted"]
    vp_sorted = grid["vp_sorted"]
    HW = vp["vp_p"].shape[0]

    def cell_hash(ci):
        h = (ci[..., 0].astype(jnp.uint32) * np.uint32(73856093)
             ^ ci[..., 1].astype(jnp.uint32) * np.uint32(19349663)
             ^ ci[..., 2].astype(jnp.uint32) * np.uint32(83492791))
        return h

    def to_rgb(L):
        return film_mod.sensor_to_sensor_rgb(sensor, L, swl)

    def body(depth, st):
        o, d, beta, active = st["o"], st["d"], st["beta"], st["active"]
        Phi, M, dropped = st["Phi"], st["M"], st["dropped"]
        isect = sc.intersect(scene, o, d, jnp.full((N,), 1e30, jnp.float32))
        active = active & isect["hit"]

        # deposit (depth > 0 only: direct light is the camera pass's Ld)
        def deposit(Phi, M, dropped):
            p = isect["p"]
            ci = jnp.floor((p - grid["lo"]) * grid["inv_cell"]).astype(
                jnp.int32)
            h = cell_hash(ci)
            start = jnp.searchsorted(cells_sorted, h)
            for k in range(K):
                idx = jnp.clip(start + k, 0, cells_sorted.shape[0] - 1)
                match_cell = cells_sorted[idx] == h
                vpi = vp_sorted[idx]
                d2 = jnp.sum((vp["vp_p"][vpi] - p) ** 2, -1)
                near = d2 <= st["r2"][vpi]
                side = (vm.dot(-d, vp["vp_ns"][vpi]) > 0) == vp["vp_wo_up"][vpi]
                ok = active & match_cell & near & side & vp["vp_valid"][vpi]
                # FULL stored-BSDF evaluation against the photon direction
                # (reference SPPM: Phi += beta * vp.bsdf.f(vp.wo, wi),
                # cpu/integrators.cpp:2763+)
                nsv = vp["vp_ns"][vpi]
                t1v = vp["vp_t1"][vpi]
                t2v = vp["vp_t2"][vpi]
                wo_l = _to_local(nsv, t1v, t2v, vp["vp_wo"][vpi])
                wi_l = _to_local(nsv, t1v, t2v, -d)
                bp_vp = bxdfs.BSDFParams(
                    tag=vp["vp_tag"][vpi], albedo=vp["vp_albedo"][vpi],
                    alpha_x=vp["vp_ax"][vpi], alpha_y=vp["vp_ay"][vpi],
                    eta=vp["vp_eta"][vpi], k=vp["vp_k"][vpi],
                    tags_present=vp_tags_present)
                f_vp = bxdfs.bsdf_f(bp_vp, wo_l, wi_l)
                contrib = to_rgb(beta * vp["vp_beta"][vpi] * f_vp)
                tgt = jnp.where(ok, vpi, HW)  # HW = scrap row
                Phi = Phi.at[tgt].add(jnp.where(ok[..., None], contrib, 0.0))
                M = M.at[tgt].add(ok.astype(jnp.int32))
            # overflow detection: entry at start+K still matching
            idxK = jnp.clip(start + K, 0, cells_sorted.shape[0] - 1)
            dropped = dropped + jnp.sum(active &
                                        (cells_sorted[idxK] == h))
            return Phi, M, dropped

        if True:
            Phi, M, dropped = jax.lax.cond(
                depth > 0, lambda args: deposit(*args),
                lambda args: args, (Phi, M, dropped))

        # scatter
        mat_res = mtl.resolve_mix(scene.materials, isect["mat"], isect["p"])
        ns = mtl.apply_normal_mapping(scene.materials, scene.textures,
                                      mat_res, isect)
        ng = isect["ng"]
        t1, t2 = _shading_frame(ns, isect["dpdu"])
        wo_local = _to_local(ns, t1, t2, isect["wo"])
        bp = mtl.get_bsdf_params(scene.materials, mat_res, lam,
                                 scene.spectra_pool, textures=scene.textures,
                                 uv=isect["uv"], p_world=isect["p"],
                                 spec_cache=spec_cache, ns=ns)
        base = 5 + depth * 4
        uc = smp.sample_1d(sampler, lane, py0, si, base)
        u2 = smp.sample_2d(sampler, lane, py0, si, base + 1)
        bs = bxdfs.bsdf_sample(bp, wo_local, uc, u2, adjoint=True)
        wi_world = _to_world(ns, t1, t2, bs["wi"])
        beta_new = beta * bs["f"] * safe_div(jnp.abs(bs["wi"][..., 2]),
                                             bs["pdf"])[..., None]
        # Russian roulette on the throughput ratio (integrators.cpp photon RR)
        q = jnp.clip(1.0 - jnp.max(beta_new, -1) /
                     jnp.maximum(jnp.max(beta, -1), 1e-12), 0.0, 1.0)
        u_rr = smp.sample_1d(sampler, lane, py0, si, base + 3)
        survive = u_rr >= q
        beta_new = beta_new / jnp.maximum(1.0 - q, 1e-6)[..., None]
        active = active & bs["valid"] & survive & jnp.any(beta_new > 0, -1)
        beta = jnp.where(active[..., None], beta_new, beta)
        o2 = sc.offset_ray_origin(isect["p"], ng, wi_world)
        return dict(st, o=o2, d=wi_world, beta=beta, active=active,
                    Phi=Phi, M=M, dropped=dropped)

    st = dict(o=o, d=d, beta=beta, active=active,
              Phi=jnp.zeros((HW + 1, 3), jnp.float32),
              M=jnp.zeros((HW + 1,), jnp.int32),
              dropped=jnp.zeros((), jnp.int32), r2=grid["r2"])
    st = jax.lax.fori_loop(0, max_depth, body, st)
    return st["Phi"][:HW], st["M"][:HW], st["dropped"]


def render_sppm(scene: sc.Scene, camera, n_iterations=32, max_depth=5,
                initial_radius=None, photons_per_iteration=None,
                sensor=None, colorspace=None, seed=0, K=64, verbose=False):
    """Render with SPPM; returns ((H, W, 3) image, stats dict)."""
    import time
    t0 = time.time()
    W, H = camera.width, camera.height
    HW = W * H
    if sensor is None:
        sensor = film_mod.make_pixel_sensor(colorspace)
    if photons_per_iteration is None:
        photons_per_iteration = HW
    if initial_radius is None:
        initial_radius = 2.0 * float(scene.scene_radius) / max(W, H)
    ls_power = _positionless_sampler(scene)
    cam_sampler = smp.make_sampler("independent", spp=65536, seed=seed,
                                   full_resolution=(W, H))
    ph_sampler = smp.make_sampler("independent", spp=65536, seed=seed + 101,
                                  full_resolution=(W, H))
    pixel_idx = jnp.arange(HW, dtype=jnp.int32)

    r2 = np.full(HW, initial_radius ** 2, np.float64)
    n_vp = np.zeros(HW, np.float64)
    tau = np.zeros((HW, 3), np.float64)
    Ld_sum = np.zeros((HW, 3), np.float64)
    dropped_total = 0

    cam_j = jax.jit(lambda it, swl: _camera_pass(
        scene, camera, sensor, cam_sampler, pixel_idx, it, swl, max_depth))
    ph_j = jax.jit(lambda it, swl, vp, grid: _photon_pass(
        scene, sensor, ph_sampler, photons_per_iteration, it, swl,
        max_depth, ls_power, vp, grid, K))

    rng = np.random.RandomState(seed)
    for it in range(n_iterations):
        # one shared wavelength sample per iteration (integrators.cpp: the
        # photon pass reuses the camera pass's lambda)
        u_lam = jnp.full((max(HW, photons_per_iteration),), rng.rand(),
                         jnp.float32)
        swl_cam = spc.sample_visible_wavelengths(u_lam[:HW])
        swl_ph = spc.sample_visible_wavelengths(
            u_lam[:photons_per_iteration])
        cp = cam_j(jnp.int32(it), swl_cam)
        Ld_sum += np.asarray(cp["Ld"], np.float64)

        # ---- host grid build over visible points -------------------------
        vp_p = np.asarray(cp["vp_p"], np.float64)
        valid = np.asarray(cp["vp_valid"])
        r = np.sqrt(r2)
        r_max = float(r[valid].max()) if valid.any() else initial_radius
        cell = 2.0 * r_max
        lo = vp_p[valid].min(axis=0) - cell if valid.any() else np.zeros(3)
        inv_cell = 1.0 / cell
        # each VP covers up to 8 cells
        entries_c, entries_v = [], []
        for dx in (0, 1):
            for dy in (0, 1):
                for dz in (0, 1):
                    corner = vp_p + np.stack(
                        [(2 * dx - 1) * r, (2 * dy - 1) * r,
                         (2 * dz - 1) * r], -1)
                    ci = np.floor((corner - lo) * inv_cell).astype(np.int64)
                    h = ((ci[:, 0].astype(np.uint32) * np.uint32(73856093))
                         ^ (ci[:, 1].astype(np.uint32) * np.uint32(19349663))
                         ^ (ci[:, 2].astype(np.uint32)
                            * np.uint32(83492791)))
                    entries_c.append(h)
                    entries_v.append(np.arange(HW, dtype=np.int32))
        cells = np.concatenate(entries_c)
        vps = np.concatenate(entries_v)
        # dedup (VP spanning < 8 distinct cells repeats entries)
        key64 = cells.astype(np.uint64) << np.uint64(32) | \
            vps.astype(np.uint64)
        uniq = np.unique(key64)
        cells_u = (uniq >> np.uint64(32)).astype(np.uint32)
        vps_u = (uniq & np.uint64(0xFFFFFFFF)).astype(np.int32)
        order = np.argsort(cells_u, kind="stable")
        E = 8 * HW
        cs = np.full(E, np.uint32(0xFFFFFFFF), np.uint32)
        vs = np.zeros(E, np.int32)
        cs[:len(order)] = cells_u[order]
        vs[:len(order)] = vps_u[order]
        grid = dict(lo=jnp.asarray(lo, jnp.float32),
                    inv_cell=jnp.float32(inv_cell),
                    cells_sorted=jnp.asarray(cs),
                    vp_sorted=jnp.asarray(vs),
                    r2=jnp.asarray(r2, jnp.float32))

        Phi, M, dropped = ph_j(jnp.int32(it), swl_ph, cp, grid)
        Phi = np.asarray(Phi, np.float64)
        M = np.asarray(M, np.float64)
        dropped_total += int(dropped)

        # ---- progressive statistics update (integrators.cpp:3199) --------
        has = M > 0
        gamma = 2.0 / 3.0
        n_new = n_vp + gamma * M
        r_new2 = np.where(has, r2 * n_new / np.maximum(n_vp + M, 1e-9), r2)
        tau = np.where(has[:, None], (tau + Phi) * (r_new2 / r2)[:, None],
                       tau)
        n_vp = np.where(has, n_new, n_vp)
        r2 = r_new2
        if verbose:
            print(f"sppm iter {it}: M={M.sum():.0f} r_mean={np.sqrt(r2).mean():.4f}")

    np_total = n_iterations * photons_per_iteration
    L = Ld_sum / n_iterations + tau / (np_total * np.pi * r2[:, None])
    from ..utils import color as pcolor
    cs_out = pcolor.srgb() if colorspace is None else colorspace
    xyz = L @ np.asarray(sensor.xyz_from_sensor_rgb, np.float64).T
    img = (xyz @ np.asarray(cs_out.rgb_from_xyz, np.float64).T)
    img = img.reshape(H, W, 3).astype(np.float32)
    return img, dict(seconds=time.time() - t0, dropped=dropped_total,
                     mean_radius=float(np.sqrt(r2).mean()))
