"""Light-path (particle/adjoint) integrator.

Role model: the reference's ``LightPathIntegrator`` (cpu/integrators.h:322,
integrators.cpp LightPathIntegrator::EvaluatePixelSample): start paths AT
the lights via SampleLe, walk them through the scene, and at every vertex
connect to the camera with SampleWi, splatting the contribution at the
resulting raster position.  The film image is pure splats, normalized by
1/spp at develop time.

Shape: one fused masked-lane wavefront like the path integrator; each
depth scatter-adds its camera splats into an (HW, 3) sensor-RGB buffer kept
inside the jitted loop (the analog of the reference's AtomicFloat AddSplat).

Known divergence: BSDF evaluation uses the radiance-transport convention
for refraction (TransportMode::Importance's eta^2 correction is not
applied); diffuse/conductor scenes are unaffected.
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
from ..utils.math import safe_div
from .path import PathOptions, _to_local, _to_world, _shading_frame

# sampler dims: 5 = lambda (caller); 6 pick; 7-8 pos; 9-10 dir; 11-12 t1
# lens; per depth: 13 + d*5 -> lens(2) uc(1) u2(2)
_BASE = 13
_PER_DEPTH = 5


def _positionless_sampler(scene):
    """Light picking for emission sampling must not depend on a shading
    point (reference LightPathIntegrator uses a PowerLightSampler)."""
    ls = scene.light_sampler
    if getattr(ls, "kind", 0) in (lsamp.LS_UNIFORM, lsamp.LS_POWER):
        return ls
    power = np.asarray(scene.lights.power, np.float64)
    return lsamp.make_light_sampler("power", power)


def _splat(splat, camera, p_raster, rgb, ok):
    """Scatter-add sensor-rgb at nearest raster pixels (box-filter splat,
    the role of Film::AddSplat)."""
    px = jnp.clip(p_raster[..., 0].astype(jnp.int32), 0, camera.width - 1)
    py = jnp.clip(p_raster[..., 1].astype(jnp.int32), 0, camera.height - 1)
    idx = py * camera.width + px
    rgb = jnp.where(ok[..., None] & jnp.isfinite(rgb), rgb, 0.0)
    return splat.at[idx].add(rgb)


def trace_light_paths(scene: sc.Scene, camera, sensor, sampler, px, py,
                      sample_index, swl, opts: PathOptions, splat,
                      ls_power=None):
    """One wave of light paths; lanes are (px, py, sample_index) for sampler
    decorrelation only. Returns the updated (HW, 3) splat buffer."""
    lam = swl.lam
    N = lam.shape[0]
    spec_cache = None
    if scene.spectra_pool.shape[0] <= lgt.SPEC_CACHE_MAX:
        spec_cache = lgt.eval_all_spectra(scene.spectra_pool, lam)
    if ls_power is None:
        ls_power = _positionless_sampler(scene)

    def to_rgb(L):
        return film_mod.sensor_to_sensor_rgb(sensor, L, swl)

    # --- pick a light by power and sample an emitted ray -------------------
    u_pick = smp.sample_1d(sampler, px, py, sample_index, 6)
    u0 = smp.sample_2d(sampler, px, py, sample_index, 7)
    u1 = smp.sample_2d(sampler, px, py, sample_index, 9)
    li, pmf, _ = lsamp.sample_light(ls_power, u_pick)
    li = jnp.maximum(li, 0)
    les = lgt.sample_le(scene.lights, li, u0, u1, lam, scene.spectra_pool,
                        scene.tri_geo, scene.scene_radius,
                        0.5 * (scene.world_lo + scene.world_hi),
                        env=scene.env, spec_cache=spec_cache)
    valid = les["valid"] & (pmf > 0)

    # --- t=1: the emission point itself is visible to the camera -----------
    u_t1 = smp.sample_2d(sampler, px, py, sample_index, 11)
    if bool(np.any([t in (lgt.LIGHT_AREA_TRI, lgt.LIGHT_AREA_SPHERE)
                    for t in (scene.lights.tags_present or ())])):
        cs = cam_mod.camera_sample_wi(camera, les["o"], u_t1)
        cos_l = vm.dot(les["n_l"], cs["wi"])
        emit1 = les["two_sided"] | (cos_l > 0)
        ok1 = valid & les["has_area"] & cs["valid"] & emit1 & (cs["pdf"] > 0)
        o_sh = sc.offset_ray_origin(les["o"], les["n_l"], cs["wi"])
        dist1 = vm.length(cs["p_lens"] - o_sh)
        occ1 = sc.intersect_p(scene, o_sh, cs["wi"], dist1 * 0.999)
        ok1 = ok1 & ~occ1
        L1 = les["L"] * (cs["we"] * jnp.abs(cos_l) /
                         (pmf * les["pdf_pos"] * cs["pdf"]))[..., None]
        splat = _splat(splat, camera, cs["p_raster"], to_rgb(L1), ok1)

    # --- light path walk ----------------------------------------------------
    cos0 = jnp.where(les["has_area"],
                     jnp.abs(vm.dot(les["n_l"], les["d"])), 1.0)
    beta0 = les["L"] * safe_div(cos0, pmf * les["pdf_pos"]
                                * les["pdf_dir"])[..., None]
    # offset the start off the emitter surface (area lights would otherwise
    # self-intersect at t~0 and die on the black emitter backface)
    o0 = jnp.where(les["has_area"][..., None],
                   sc.offset_ray_origin(les["o"], les["n_l"], les["d"]),
                   les["o"])
    state = dict(o=o0, d=les["d"],
                 beta=jnp.where(valid[..., None], beta0, 0.0),
                 active=valid & jnp.any(beta0 > 0, axis=-1),
                 splat=splat, px=px, py=py, si=sample_index, lam=lam)
    if spec_cache is not None:
        state["spec_cache"] = spec_cache

    def body(depth, state):
        o, d, beta = state["o"], state["d"], state["beta"]
        active, splat = state["active"], state["splat"]
        px, py, sample_index = state["px"], state["py"], state["si"]
        lam = state["lam"]
        spec_cache = state.get("spec_cache")
        N = o.shape[0]

        isect = sc.intersect(scene, o, d, jnp.full((N,), 1e30, jnp.float32))
        active = active & isect["hit"]

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

        base = _BASE + depth * _PER_DEPTH
        u_lens = smp.sample_2d(sampler, px, py, sample_index, base)
        cs = cam_mod.camera_sample_wi(camera, isect["p"], u_lens)
        wi_local = _to_local(ns, t1, t2, cs["wi"])
        f = bxdfs.bsdf_f(bp, wo_local, wi_local, adjoint=True)
        Lsp = beta * f * (jnp.abs(wi_local[..., 2]) * cs["we"]
                          * safe_div(1.0, cs["pdf"]))[..., None]
        ok = active & cs["valid"] & (cs["pdf"] > 0) & \
            jnp.any(Lsp > 0, axis=-1)
        o_sh = sc.offset_ray_origin(isect["p"], ng, cs["wi"])
        dist = vm.length(cs["p_lens"] - o_sh)
        occ = sc.intersect_p(scene, o_sh, cs["wi"], dist * 0.999)
        ok = ok & ~occ
        splat = _splat(splat, camera, cs["p_raster"], to_rgb(Lsp), ok)

        # continue the walk (importance transport)
        uc = smp.sample_1d(sampler, px, py, sample_index, base + 2)
        u2 = smp.sample_2d(sampler, px, py, sample_index, base + 3)
        bs = bxdfs.bsdf_sample(bp, wo_local, uc, u2, adjoint=True)
        wi_world = _to_world(ns, t1, t2, bs["wi"])
        beta_new = beta * bs["f"] * safe_div(jnp.abs(bs["wi"][..., 2]),
                                             bs["pdf"])[..., None]
        active = active & bs["valid"] & jnp.any(beta_new > 0, axis=-1)
        beta = jnp.where(active[..., None], beta_new, beta)
        o_next = sc.offset_ray_origin(isect["p"], ng, wi_world)
        return dict(state, o=o_next, d=wi_world, beta=beta, active=active,
                    splat=splat)

    state = jax.lax.fori_loop(0, opts.max_depth, body, state)
    return state["splat"]


def render_wave_film(scene, camera, sampler, filt, sensor, film, pixel_idx,
                     sample_index, opts):
    """Film-level wave (driver hook): traces one light path per lane and
    splats; also books a zero sample so weight_sum == spp for develop."""
    px = pixel_idx % camera.width
    py = pixel_idx // camera.width
    u_lam = smp.sample_1d(sampler, px, py, sample_index, 5)
    if opts.sample_visible_wavelengths:
        swl = spc.sample_visible_wavelengths(u_lam)
    else:
        swl = spc.sample_uniform_wavelengths(u_lam)
    splat = trace_light_paths(scene, camera, sensor, sampler, px, py,
                              sample_index, swl, opts, film.splat_sum)
    film = film.replace(splat_sum=splat)
    zero = jnp.zeros((pixel_idx.shape[0], 3), jnp.float32)
    return film_mod.add_samples(film, pixel_idx, zero,
                                jnp.ones(pixel_idx.shape[0], jnp.float32))
