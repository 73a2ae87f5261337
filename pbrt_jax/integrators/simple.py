"""Pedagogical integrators: RandomWalk and SimplePath.

Role models: the reference's ``RandomWalkIntegrator`` (cpu/integrators.h:115
— uniform-sphere sampling, no NEE, no MIS) and ``SimplePathIntegrator``
(cpu/integrators.h:183 / integrators.cpp SimplePathIntegrator::Li — optional
uniform-light NEE without MIS, optional BSDF sampling).  Same masked-lane
wavefront shape as the main path integrator, deliberately unoptimized
estimators — these exist as teaching tools and as simple cross-checks of
the MIS-weighted integrator.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from ..utils import struct

from .. import scene_core as sc
from .. import samplers as smp
from .. import cameras as cam_mod
from .. import lights as lgt
from .. import lightsamplers as lsamp
from .. import materials as mtl
from .. import bxdfs
from ..utils import spectrum as spc
from ..utils import sampling as sp
from ..utils import vecmath as vm
from ..utils.math import safe_div
from .path import PathOptions, _to_local, _to_world, _shading_frame

_CAM_DIMS = 6
_DIMS = 6  # per bounce: pick(1) light u(2) uc(1) u2(2)


@struct.dataclass
class SimpleOptions(PathOptions):
    kind: str = struct.field(pytree_node=False, default="simplepath")
    sample_lights: bool = struct.field(pytree_node=False, default=True)
    sample_bsdf: bool = struct.field(pytree_node=False, default=True)


def trace_simple(scene: sc.Scene, sampler, px, py, sample_index, o, d, swl,
                 opts: SimpleOptions):
    lam = swl.lam
    N = o.shape[0]
    randomwalk = opts.kind == "randomwalk"
    sample_lights = (not randomwalk) and opts.sample_lights
    sample_bsdf = (not randomwalk) and opts.sample_bsdf
    spec_cache = None
    if scene.spectra_pool.shape[0] <= lgt.SPEC_CACHE_MAX:
        spec_cache = lgt.eval_all_spectra(scene.spectra_pool, lam)
    # uniform light sampler (SimplePathIntegrator uses UniformLightSampler)
    n_lights = scene.lights.packed.shape[0]

    def body(depth, state):
        o, d, beta, L = state["o"], state["d"], state["beta"], state["L"]
        active, spec_bounce = state["active"], state["spec"]
        isect = sc.intersect(scene, o, d, jnp.full((N,), 1e30, jnp.float32))
        hit = isect["hit"] & active

        take_le = (~jnp.asarray(sample_lights)) | spec_bounce
        if scene.has_area_lights:
            from ..ops.gather import pool_lookup
            li = isect["light"]
            lrow = lgt.LightRow(pool_lookup(scene.lights.packed,
                                            jnp.maximum(li, 0)))
            Le = lgt.area_light_radiance(lrow, isect["ng"], isect["wo"], lam,
                                         scene.spectra_pool,
                                         spec_cache=spec_cache)
            L = L + jnp.where((hit & (li >= 0) & take_le)[..., None],
                              beta * Le, 0.0)
        if scene.env is not None:
            Le_env = lgt.env_radiance(scene.env, d, lam, p=o)
            L = L + jnp.where((active & ~isect["hit"] & take_le)[..., None],
                              beta * Le_env, 0.0)
        if scene.n_infinite > 0:
            Le_inf = lgt.infinite_light_radiance(scene.lights, lam,
                                                 scene.spectra_pool, d,
                                                 scene.inf_indices,
                                                 spec_cache=spec_cache)
            L = L + jnp.where((active & ~isect["hit"] & take_le)[..., None],
                              beta * Le_inf, 0.0)

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
        base = _CAM_DIMS + depth * _DIMS

        if sample_lights and n_lights > 0:
            u_pick = smp.sample_1d(sampler, px, py, sample_index, base)
            u_l = smp.sample_2d(sampler, px, py, sample_index, base + 1)
            li_idx = jnp.clip((u_pick * n_lights).astype(jnp.int32), 0,
                              n_lights - 1)
            pmf = 1.0 / n_lights
            ls = lgt.sample_li(scene.lights, li_idx, isect["p"], ns, u_l,
                               lam, scene.spectra_pool, scene.tri_geo,
                               scene.scene_radius, env=scene.env,
                               spec_cache=spec_cache)
            wi_local = _to_local(ns, t1, t2, ls["wi"])
            f = bxdfs.bsdf_f(bp, wo_local, wi_local) * \
                jnp.abs(wi_local[..., 2])[..., None]
            ok = active & ls["valid"] & (ls["pdf"] > 0) & \
                jnp.any(f > 0, axis=-1)
            o_sh = sc.offset_ray_origin(isect["p"], ng, ls["wi"])
            dist = vm.length(ls["p_light"] - o_sh)
            occ = sc.intersect_p(scene, o_sh, ls["wi"], dist * 0.999)
            Ld = f * ls["L"] * safe_div(1.0, ls["pdf"] * pmf)[..., None]
            L = L + jnp.where((ok & ~occ)[..., None], beta * Ld, 0.0)

        uc = smp.sample_1d(sampler, px, py, sample_index, base + 3)
        u2 = smp.sample_2d(sampler, px, py, sample_index, base + 4)
        if sample_bsdf:
            bs = bxdfs.bsdf_sample(bp, wo_local, uc, u2)
            wi_local = bs["wi"]
            throughput = bs["f"] * safe_div(jnp.abs(wi_local[..., 2]),
                                            bs["pdf"])[..., None]
            valid = bs["valid"]
            spec_new = bs["specular"]
        else:
            # uniform hemisphere around the shading normal, flipped to the
            # reflection side (SimplePathIntegrator's !sampleBSDF branch,
            # for reflective BSDFs; RandomWalk uses the full sphere)
            if randomwalk:
                wi_local = sp.sample_uniform_sphere(u2)
                pdf = 1.0 / (4.0 * np.pi)
            else:
                wi_local = sp.sample_uniform_sphere(u2)
                wi_local = wi_local.at[..., 2].set(jnp.abs(wi_local[..., 2]))
                pdf = 1.0 / (2.0 * np.pi)
            f = bxdfs.bsdf_f(bp, wo_local, wi_local)
            throughput = f * (jnp.abs(wi_local[..., 2]) / pdf)[..., None]
            valid = jnp.ones((N,), bool)
            spec_new = jnp.zeros((N,), bool)
        wi_world = _to_world(ns, t1, t2, wi_local)
        beta_new = beta * throughput
        active = active & valid & jnp.any(beta_new > 0, axis=-1)
        beta = jnp.where(active[..., None], beta_new, beta)
        o_next = sc.offset_ray_origin(isect["p"], ng, wi_world)
        return dict(o=o_next, d=wi_world, beta=beta, L=L, active=active,
                    spec=spec_new)

    state = dict(o=o, d=d, beta=jnp.ones((N, 4), jnp.float32),
                 L=jnp.zeros((N, 4), jnp.float32),
                 active=jnp.ones((N,), bool),
                 spec=jnp.ones((N,), bool))
    state = jax.lax.fori_loop(0, opts.max_depth + 1, body, state)
    return state["L"]


def render_wave(scene, camera, sampler, filt, pixel_idx, sample_index, opts):
    import pbrt_jax.filters as flt
    px = pixel_idx % camera.width
    py = pixel_idx // camera.width
    u_pix = smp.sample_pixel_2d(sampler, px, py, sample_index, 0)
    u_time = smp.sample_1d(sampler, px, py, sample_index, 2)
    u_lens = smp.sample_2d(sampler, px, py, sample_index, 3)
    u_lam = smp.sample_1d(sampler, px, py, sample_index, 5)
    swl = spc.sample_visible_wavelengths(u_lam) \
        if opts.sample_visible_wavelengths else \
        spc.sample_uniform_wavelengths(u_lam)
    f_off, f_weight = flt.sample(filt, u_pix)
    p_film = jnp.stack([px.astype(jnp.float32) + 0.5 + f_off[..., 0],
                        py.astype(jnp.float32) + 0.5 + f_off[..., 1]], -1)
    o, d, _t, w = cam_mod.generate_ray_weighted(camera, p_film, u_lens,
                                                u_time)
    if not isinstance(opts, SimpleOptions):
        opts = SimpleOptions(max_depth=opts.max_depth)
    L = trace_simple(scene, sampler, px, py, sample_index, o, d, swl, opts)
    return L, swl, f_weight * w


def trace_simplevolpath(scene: sc.Scene, sampler, px, py, sample_index,
                        o, d, swl, opts):
    """SimpleVolPath (reference cpu/integrators.h:239,
    integrators.cpp:837+): delta-tracking volumetric transport with phase
    sampling only — no NEE, no MIS.  Documented divergence: the reference
    errors out on scattering surfaces; here surface hits terminate the
    path after collecting any emission (interfaces/vacuum boxes excepted)."""
    from ..utils import rng as prng
    from ..utils import sampling as usamp
    from .volpath import sample_t_maj, EV_ABSORB, EV_SCATTER
    lam = swl.lam
    N = o.shape[0]
    spec_cache = None
    if scene.spectra_pool.shape[0] <= lgt.SPEC_CACHE_MAX:
        spec_cache = lgt.eval_all_spectra(scene.spectra_pool, lam)

    def body(depth, state):
        o, d, beta, L, active = (state["o"], state["d"], state["beta"],
                                 state["L"], state["active"])
        isect = sc.intersect(scene, o, d, jnp.full((N,), 1e30, jnp.float32))
        seed = prng.hash_u32(px.astype(jnp.uint32), py.astype(jnp.uint32),
                             sample_index.astype(jnp.uint32),
                             jnp.asarray(depth, jnp.uint32),
                             np.uint32(0x51f0))
        ones = jnp.ones((N, 4), jnp.float32)
        fl = sample_t_maj(scene, o, d, isect["t"], lam, seed, active,
                          beta, ones, ones)
        beta = fl["beta"]
        L = L + jnp.where(active[..., None], fl["em"], 0.0)
        absorbed = active & (fl["status"] == EV_ABSORB)
        scattered = active & (fl["status"] == EV_SCATTER)
        reach = active & ~absorbed & ~scattered

        # surface: collect emission, terminate
        if scene.has_area_lights:
            from ..ops.gather import pool_lookup
            li = isect["light"]
            lrow = lgt.LightRow(pool_lookup(scene.lights.packed,
                                            jnp.maximum(li, 0)))
            Le = lgt.area_light_radiance(lrow, isect["ng"], isect["wo"],
                                         lam, scene.spectra_pool,
                                         spec_cache=spec_cache)
            L = L + jnp.where((reach & isect["hit"] & (li >= 0))[..., None],
                              beta * Le, 0.0)
        if scene.env is not None:
            Le_env = lgt.env_radiance(scene.env, d, lam, p=o)
            L = L + jnp.where((reach & ~isect["hit"])[..., None],
                              beta * Le_env, 0.0)
        if scene.n_infinite > 0:
            Le_inf = lgt.infinite_light_radiance(scene.lights, lam,
                                                 scene.spectra_pool, d,
                                                 scene.inf_indices,
                                                 spec_cache=spec_cache)
            L = L + jnp.where((reach & ~isect["hit"])[..., None],
                              beta * Le_inf, 0.0)

        # phase-sampled continuation from the scatter point
        u2 = smp.sample_2d(sampler, px, py, sample_index,
                           _CAM_DIMS + depth * _DIMS + 4)
        p_ev = o + d * fl["t"][..., None]
        wi, pdf_hg = usamp.sample_henyey_greenstein(u2, fl["g"], -d)
        o = jnp.where(scattered[..., None], p_ev, o)
        d = jnp.where(scattered[..., None], wi, d)
        active = scattered  # only scattering lanes continue
        return dict(o=o, d=d, beta=beta, L=L, active=active)

    state = dict(o=o, d=d, beta=jnp.ones((N, 4), jnp.float32),
                 L=jnp.zeros((N, 4), jnp.float32),
                 active=jnp.ones((N,), bool))
    state = jax.lax.fori_loop(0, opts.max_depth + 1, body, state)
    return state["L"]


def render_wave_simplevol(scene, camera, sampler, filt, pixel_idx,
                          sample_index, opts):
    import pbrt_jax.filters as flt
    px = pixel_idx % camera.width
    py = pixel_idx // camera.width
    u_pix = smp.sample_pixel_2d(sampler, px, py, sample_index, 0)
    u_lens = smp.sample_2d(sampler, px, py, sample_index, 3)
    u_lam = smp.sample_1d(sampler, px, py, sample_index, 5)
    swl = spc.sample_visible_wavelengths(u_lam)
    f_off, f_weight = flt.sample(filt, u_pix)
    p_film = jnp.stack([px.astype(jnp.float32) + 0.5 + f_off[..., 0],
                        py.astype(jnp.float32) + 0.5 + f_off[..., 1]], -1)
    o, d, _t, w = cam_mod.generate_ray_weighted(
        camera, p_film, u_lens, jnp.zeros_like(f_weight))
    L = trace_simplevolpath(scene, sampler, px, py, sample_index, o, d, swl,
                            opts)
    return L, swl, f_weight * w
