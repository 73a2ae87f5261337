"""Bidirectional path tracer.

Role model: the reference's ``BDPTIntegrator`` (cpu/integrators.h:345;
integrators.cpp: Vertex:1553, RandomWalk:1964, GenerateCameraSubpath:1893,
GenerateLightSubpath:1910, ConnectBDPT:2324, MISWeight:2129).  Camera and
light subpaths are generated per lane, then every (s, t) connection
strategy is evaluated with the balance-style MIS weight computed from
forward/reverse area densities along both subpaths.

Shape: the subpath walks are unrolled Python loops producing per-depth
vertex records (dicts of (N, ...) arrays — an SoA "Vertex" pool); the
(s, t) double loop is fully static, each connection costing two BSDF evals
+ one shadow ray across all lanes.  t>=2 strategies accumulate into the
lane's own pixel; t==1 strategies scatter-add splats (like lightpath).

Medium vertices (round 4, reference Vertex::CreateMedium,
integrators.cpp:1595 + RandomWalk's mi.phase branch): homogeneous
point-in-box media get closed-form distance sampling along every walk
segment — a scatter event creates a per-lane MEDIUM vertex (HG phase
sampling for the next direction, phase pdfs in the MIS weights, no cosine
in ConvertDensity/G) and connections multiply the segment transmittance.
Scope restrictions vs the reference (documented divergences):
  * medium vertices cover HOMOGENEOUS media located by the point-in-box
    lookup; heterogeneous (grid) media and MediumInterface-attached media
    are volpath-only (no null-scattering vertices in BDPT)
  * no emissive-medium vertices
  * BSDF evaluation uses radiance-convention refraction in both transport
    modes (no eta^2 importance correction)

Infinite lights are fully supported (round 4): escaped camera rays create
infinite-light vertices with unconverted solid-angle densities, the s=0/s=1
strategies use InfiniteLightDensity / planar PDFLight weights, and
env-started light subpaths get the reference's density corrections
(integrators.cpp:1590 InfiniteLightDensity, :1668-1690).
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
from .. import media as med_mod
from ..utils import sampling as usamp
from .path import PathOptions, _to_local, _to_world, _shading_frame
from .lightpath import _positionless_sampler, _splat

# sampler dim layout: 0-5 camera ray + lambda (render_wave);
# camera walk: base 6, 3 dims/step (+1 medium-distance dim when the scene
# has BDPT media); light start after the camera walk (..+5); light walk
# same stride; connections: after both walks, 3 dims per (s,t)
_CAM_WALK = 6


def _remap0(x):
    return jnp.where(x != 0.0, x, 1.0)


def _convert_density(pdf_sa, p_from, p_to, ng_to, to_on_surface):
    """Solid-angle density at p_from -> area density at p_to
    (Vertex::ConvertDensity, integrators.cpp:1731)."""
    w = p_to - p_from
    d2 = jnp.maximum(vm.length_squared(w), 1e-20)
    pdf = pdf_sa / d2
    cos = jnp.abs(vm.dot(ng_to, w)) / jnp.sqrt(d2)
    return jnp.where(to_on_surface, pdf * cos, pdf)


def _surface_pdf(v, p_prev, p_next, ng_next, next_on_surface,
                 next_infinite=None):
    """Area density of sampling p_next from vertex v arriving from
    p_prev (Vertex::PDF for VertexType::Surface/Medium). Medium lanes
    (v["in_medium"]) use the HG phase pdf instead of the BSDF pdf.
    next_infinite: lanes whose target vertex is an infinite light —
    ConvertDensity is the identity there (solid-angle density is kept,
    integrators.cpp Vertex::ConvertDensity IsInfiniteLight)."""
    wp = vm.normalize(p_prev - v["p"])
    wn = vm.normalize(p_next - v["p"])
    pdf_sa = bxdfs.bsdf_pdf(v["bp"], _to_local(v["ns"], v["t1"], v["t2"], wp),
                            _to_local(v["ns"], v["t1"], v["t2"], wn))
    im = v.get("in_medium")
    if im is not None:
        ph = usamp.henyey_greenstein(vm.dot(wp, wn), v["g_hg"])
        pdf_sa = jnp.where(im, ph, pdf_sa)
    conv = _convert_density(pdf_sa, v["p"], p_next, ng_next, next_on_surface)
    if next_infinite is None:
        return conv
    return jnp.where(next_infinite, pdf_sa, conv)


def _on_surface(v, n):
    """Per-lane 'vertex sits on a surface' mask (cos factor applies in
    ConvertDensity / G)."""
    im = v.get("in_medium")
    return jnp.ones((n,), bool) if im is None else ~im


# ---------------------------------------------------------------------------
# Homogeneous point-in-box media (Vertex::CreateMedium scope — see module
# docstring). Closed-form segment clipping against every homogeneous
# medium's world box; static unroll over the (small) medium pool.

_MED_BIG = 1e30


def _homog_clip(row, o, d, t_end):
    """Clip the segment [0, t_end] along o + t*d to a medium row's box.
    Non-homogeneous / empty rows return an inverted interval."""
    lo, hi = row[15:18], row[18:21]
    is_hom = jnp.round(row[0]).astype(jnp.int32) == med_mod.MEDIUM_HOMOGENEOUS
    nonempty = jnp.all(hi > lo)
    inv = 1.0 / jnp.where(d == 0.0, 1e-20, d)
    ta = (lo - o) * inv
    tb = (hi - o) * inv
    t0 = jnp.maximum(jnp.max(jnp.minimum(ta, tb), axis=-1), 0.0)
    t1 = jnp.minimum(jnp.min(jnp.maximum(ta, tb), axis=-1), t_end)
    ok = is_hom & nonempty
    return jnp.where(ok, t0, _MED_BIG), jnp.where(ok, t1, -_MED_BIG)


def _segment_medium(pool, o, d, t_end, lam):
    """First homogeneous medium box overlapped by the segment. Returns
    dict(valid, t0, t1, sigma_a, sigma_s, g); t1 is already clipped to
    t_end. Overlapping boxes: the first-entered box wins (documented
    single-box-per-segment scope)."""
    N = o.shape[0]
    t0b = jnp.full((N,), _MED_BIG, jnp.float32)
    t1b = jnp.full((N,), -_MED_BIG, jnp.float32)
    idxb = jnp.full((N,), -1, jnp.int32)
    for m in range(pool.desc.shape[0]):
        t0, t1 = _homog_clip(pool.desc[m], o, d, t_end)
        better = (t1 > t0) & (t0 < t0b)
        t0b = jnp.where(better, t0, t0b)
        t1b = jnp.where(better, t1, t1b)
        idxb = jnp.where(better, m, idxb)
    rows = med_mod.medium_row(pool, idxb)
    sa, ss = med_mod.sigma_at(pool, rows, o, lam)  # homogeneous: p-invariant
    valid = idxb >= 0
    return dict(valid=valid, t0=t0b, t1=t1b,
                sigma_a=jnp.where(valid[..., None], sa, 0.0),
                sigma_s=jnp.where(valid[..., None], ss, 0.0),
                g=med_mod.hg_g(rows))


def _segment_tau(pool, pa, pb, lam):
    """Optical thickness (N, 4) of the segment pa -> pb summed over ALL
    homogeneous medium boxes it crosses (connection transmittance)."""
    dv = pb - pa
    dist = vm.length(dv)
    dn = dv / jnp.maximum(dist, 1e-20)[..., None]
    tau = jnp.zeros(pa.shape[:-1] + (4,), jnp.float32)
    for m in range(pool.desc.shape[0]):
        row = pool.desc[m]
        t0, t1 = _homog_clip(row, pa, dn, dist)
        seg = jnp.maximum(t1 - t0, 0.0)
        rows = jnp.broadcast_to(row, pa.shape[:-1] + row.shape)
        sa, ss = med_mod.sigma_at(pool, rows, pa, lam)
        tau = tau + (sa + ss) * seg[..., None]
    return tau


def _bdpt_media(scene):
    """Static flag: BDPT creates medium vertices for this scene (see
    module docstring scope: homogeneous point-in-box media only)."""
    return bool(scene.has_media) and not scene.has_medium_interfaces \
        and getattr(scene.media, "all_homogeneous", True)


def bdpt_supports_media(scene) -> bool:
    """Static: BDPT's medium-vertex scope covers this scene's media; if
    not, the render driver must route to volpath (reference handles grid
    media in BDPT via null-scattering RandomWalk events,
    integrators.cpp:1480 — an unimplemented scope here, so grid-media
    scenes fall back with a warning; tests/test_bdpt.py pins this)."""
    if not scene.has_media:
        return True
    return _bdpt_media(scene)


def _walk_stride(scene):
    """Sampler dims consumed per walk step (+1 for the medium distance)."""
    return 4 if _bdpt_media(scene) else 3


def _walk(scene, camera, sampler, px, py, si, lam, spec_cache, o0, d0, beta0,
          pdf_dir0, n_steps, dim_base, record_le, adjoint=False):
    """Random walk creating up to n_steps surface/medium vertices
    (reference RandomWalk, integrators.cpp:1964 incl. the mi.phase medium
    branch). Returns list of vertex records; sets each vertex's pdf_fwd
    and its predecessor's pdf_rev (prev_pdf_rev list, aligned:
    prev_rev[i] = pdf_rev of vertex i-1, with prev_rev[0] = pdf_rev onto
    the path endpoint)."""
    N = o0.shape[0]
    use_media = _bdpt_media(scene)
    stride = _walk_stride(scene)
    verts = []
    prev_rev = []        # pdf_rev assigned to the PREVIOUS vertex/endpoint
    o, d = o0, d0
    beta = beta0
    pdf_dir = pdf_dir0   # solid-angle pdf of the direction that produced d
    active = jnp.any(beta0 > 0, axis=-1)
    p_prev = o0
    prev_specular = jnp.zeros((N,), bool)
    for i in range(n_steps):
        isect = sc.intersect(scene, o, d, jnp.full((N,), 1e30, jnp.float32))
        hit_surf = isect["hit"]
        scatter = jnp.zeros((N,), bool)
        g_hg = jnp.zeros((N,), jnp.float32)
        p_med = isect["p"]
        pdf_phase = jnp.ones((N,), jnp.float32)
        wi_med = d
        if use_media:
            # homogeneous closed-form flight (HomogeneousMedium::Sample
            # role): distance drawn from the hero wavelength's sigma_t,
            # pdfs channel-averaged (one-sample MIS over the 4 lambdas)
            t_surf = jnp.where(hit_surf, isect["t"], 1e30)
            seg = _segment_medium(scene.media, o, d, t_surf, lam)
            sig_t = seg["sigma_a"] + seg["sigma_s"]
            u_dist = smp.sample_1d(sampler, px, py, si,
                                   dim_base + stride * i + 3)
            hero = sig_t[..., 0]
            dt = -jnp.log1p(-jnp.clip(u_dist, 0.0, 1.0 - 1e-7)) / \
                jnp.maximum(hero, 1e-20)
            t_m = seg["t0"] + dt
            in_seg = seg["valid"] & (hero > 0) & active
            scatter = in_seg & (t_m < seg["t1"])
            pdf_t = jnp.mean(sig_t * jnp.exp(-sig_t * dt[..., None]),
                             axis=-1)
            clip_len = jnp.maximum(seg["t1"] - seg["t0"], 0.0)
            pdf_pass = jnp.mean(jnp.exp(-sig_t * clip_len[..., None]),
                                axis=-1)
            w_scatter = seg["sigma_s"] * jnp.exp(-sig_t * dt[..., None]) * \
                safe_div(1.0, pdf_t)[..., None]
            w_pass = jnp.exp(-sig_t * clip_len[..., None]) * \
                safe_div(1.0, pdf_pass)[..., None]
            att = seg["valid"] & active
            beta = jnp.where(scatter[..., None], beta * w_scatter,
                             jnp.where(att[..., None], beta * w_pass, beta))
            p_med = o + t_m[..., None] * d
            g_hg = seg["g"]
        valid = active & (hit_surf | scatter)
        mat_res = mtl.resolve_mix(scene.materials, isect["mat"], isect["p"])
        ns = mtl.apply_normal_mapping(scene.materials, scene.textures,
                                      mat_res, isect)
        ng = isect["ng"]
        t1, t2 = _shading_frame(ns, isect["dpdu"])
        bp = mtl.get_bsdf_params(scene.materials, mat_res, lam,
                                 scene.spectra_pool, textures=scene.textures,
                                 uv=isect["uv"], p_world=isect["p"],
                                 spec_cache=spec_cache, ns=ns)
        p_v = jnp.where(scatter[..., None], p_med, isect["p"]) \
            if use_media else isect["p"]
        ng_v = jnp.where(scatter[..., None], 0.0, ng) if use_media else ng
        pdf_fwd = jnp.where(
            prev_specular, 0.0,
            _convert_density(pdf_dir, p_prev, p_v, ng_v, ~scatter))
        v = dict(p=p_v, ng=ng_v, ns=ns, t1=t1, t2=t2, bp=bp,
                 beta=beta, pdf_fwd=pdf_fwd,
                 pdf_rev=jnp.zeros((N,), jnp.float32),
                 delta=jnp.zeros((N,), bool), valid=valid,
                 wo=isect["wo"])
        if use_media:
            v["in_medium"] = scatter
            v["g_hg"] = g_hg
        if record_le and scene.has_area_lights:
            from ..ops.gather import pool_lookup
            li = isect["light"]
            lrow = lgt.LightRow(pool_lookup(scene.lights.packed,
                                            jnp.maximum(li, 0)))
            Le = lgt.area_light_radiance(lrow, ng, isect["wo"], lam,
                                         scene.spectra_pool,
                                         spec_cache=spec_cache)
            v["Le"] = jnp.where((li >= 0)[..., None], Le, 0.0)
            v["is_light"] = valid & (li >= 0) & ~scatter
            v["light_idx"] = jnp.maximum(li, 0)
        else:
            v["Le"] = jnp.zeros_like(lam)
            v["is_light"] = jnp.zeros((N,), bool)
            v["light_idx"] = jnp.zeros((N,), jnp.int32)
        # escaped-ray infinite-light vertex (reference Vertex::CreateLight
        # for escaped rays + Vertex::Le IsInfiniteLight branch,
        # integrators.cpp:1668-1690): record the env radiance and the
        # UNCONVERTED solid-angle pdf_fwd (ConvertDensity is identity for
        # infinite-light vertices)
        has_inf = record_le and (scene.env is not None or
                                 scene.n_infinite > 0)
        if has_inf:
            esc = active & ~isect["hit"] & ~scatter
            Le_inf = jnp.zeros_like(lam)
            if scene.env is not None:
                Le_inf = Le_inf + lgt.env_radiance(scene.env, d, lam, p=o)
            if scene.n_infinite > 0:
                Le_inf = Le_inf + lgt.infinite_light_radiance(
                    scene.lights, lam, scene.spectra_pool, d,
                    scene.inf_indices, spec_cache=spec_cache)
            v["escaped"] = esc
            v["Le_inf"] = Le_inf
            v["d_in"] = d
            v["pdf_fwd"] = jnp.where(
                esc, jnp.where(prev_specular, 0.0, pdf_dir), v["pdf_fwd"])
        else:
            v["escaped"] = jnp.zeros((N,), bool)
            v["Le_inf"] = jnp.zeros_like(lam)
            v["d_in"] = d
        verts.append(v)

        # sample the next direction
        base = dim_base + stride * i
        uc = smp.sample_1d(sampler, px, py, si, base)
        u2 = smp.sample_2d(sampler, px, py, si, base + 1)
        wo_local = _to_local(ns, t1, t2, isect["wo"])
        bs = bxdfs.bsdf_sample(bp, wo_local, uc, u2, adjoint=adjoint)
        wi_world = _to_world(ns, t1, t2, bs["wi"])
        spec = bs["specular"]
        pdf_rev_sa = bxdfs.bsdf_pdf(bp, bs["wi"], wo_local)
        bs_pdf = bs["pdf"]
        bs_valid = bs["valid"]
        beta_new = beta * bs["f"] * safe_div(jnp.abs(bs["wi"][..., 2]),
                                             bs["pdf"])[..., None]
        if use_media:
            # medium lanes: HG phase sampling (weight f/pdf == 1; the
            # reverse phase pdf equals the forward value — both arguments
            # point away from the vertex and HG depends only on their dot)
            wi_med, pdf_phase = usamp.sample_henyey_greenstein(u2, g_hg, -d)
            wi_world = jnp.where(scatter[..., None], wi_med, wi_world)
            spec = spec & ~scatter
            pdf_rev_sa = jnp.where(scatter, pdf_phase, pdf_rev_sa)
            bs_pdf = jnp.where(scatter, pdf_phase, bs_pdf)
            bs_valid = jnp.where(scatter, pdf_phase > 0, bs_valid)
            beta_new = jnp.where(scatter[..., None], beta, beta_new)
        v["delta"] = spec & valid
        prev_rev.append(jnp.where(
            spec, 0.0,
            _convert_density(pdf_rev_sa, p_v, p_prev,
                             jnp.zeros_like(p_prev), jnp.zeros((N,), bool))))
        active = valid & bs_valid & jnp.any(beta_new > 0, axis=-1)
        beta = jnp.where(active[..., None], beta_new, beta)
        pdf_dir = jnp.where(spec, 0.0, bs_pdf)
        prev_specular = spec
        p_prev = p_v
        o_next = sc.offset_ray_origin(isect["p"], ng, wi_world)
        o = jnp.where(scatter[..., None], p_med, o_next) if use_media \
            else o_next
        d = wi_world
    return verts, prev_rev


def _fix_prev_rev(verts, prev_rev, endpoints_on_surface):
    """prev_rev[i] was computed with a placeholder (not-on-surface) target;
    recompute the geometric factor now that both endpoints are known, and
    write pdf_rev into the records."""
    # prev_rev[i] corresponds to target vertex i-1 (i=0 -> path endpoint,
    # handled by callers). For i>=1 multiply by |cos(ng_{i-1}, w)| / 1.
    for i in range(1, len(verts)):
        v_from = verts[i]
        v_to = verts[i - 1]
        w = v_to["p"] - v_from["p"]
        d2 = jnp.maximum(vm.length_squared(w), 1e-20)
        cos = jnp.abs(vm.dot(v_to["ng"], w)) / jnp.sqrt(d2)
        im = v_to.get("in_medium")
        if im is not None:
            cos = jnp.where(im, 1.0, cos)   # no cos onto medium vertices
        verts[i - 1]["pdf_rev"] = prev_rev[i] * cos


def trace_bdpt(scene: sc.Scene, camera, sensor, sampler, px, py,
               sample_index, swl, opts: PathOptions, splat, ls_power=None,
               p_film=None, collect=False):
    """One BDPT wave. Returns (L (N, 4) for the lane's own pixel from t>=2
    strategies, updated splat buffer).

    p_film: optional (N, 2) raster position override (MLT samples the film
    plane globally). collect=True returns the per-strategy list
    [{s, t, L (N,4), p_raster|None}] instead of the summed L (MLT picks one
    strategy per chain)."""
    lam = swl.lam
    N = lam.shape[0]
    max_depth = opts.max_depth
    spec_cache = None
    if scene.spectra_pool.shape[0] <= lgt.SPEC_CACHE_MAX:
        spec_cache = lgt.eval_all_spectra(scene.spectra_pool, lam)
    if ls_power is None:
        ls_power = _positionless_sampler(scene)
    pmf_table = ls_power.pmf_table if ls_power.pmf_table is not None else None
    scene_center = 0.5 * (scene.world_lo + scene.world_hi)

    def light_pmf_of(idx):
        if pmf_table is None:
            return jnp.full(idx.shape, 1.0 / max(scene.lights.packed.shape[0],
                                                 1), jnp.float32)
        return pmf_table[jnp.clip(idx, 0, pmf_table.shape[0] - 1)]

    def infinite_light_density(d, n, p_ref=None):
        """InfiniteLightDensity (reference integrators.cpp:1590): pmf-
        weighted sum of every infinite light's directional pdf. d is the
        SURFACE->ENV direction (what sample_li would have drawn)."""
        dens = jnp.zeros((n,), jnp.float32)
        if scene.env is not None:
            pmf_env = light_pmf_of(jnp.full((n,), scene.env.light_index,
                                            jnp.int32))
            dens = dens + lgt.env_pdf_li(scene.env, d, p_ref=p_ref) * pmf_env
        if scene.n_infinite > 0:
            for ii in scene.inf_indices:
                pmf_i = light_pmf_of(jnp.full((n,), int(ii), jnp.int32))
                dens = dens + pmf_i * (1.0 / (4.0 * np.pi))
        return dens

    has_infinite = scene.env is not None or scene.n_infinite > 0

    # ---------------- camera subpath --------------------------------------
    # camera ray was generated by the caller: first vertex is the camera
    u_lens = smp.sample_2d(sampler, px, py, sample_index, 3)
    if p_film is None:
        u_pix = smp.sample_pixel_2d(sampler, px, py, sample_index, 0)
        p_film = jnp.stack(
            [px.astype(jnp.float32) + 0.5 + u_pix[..., 0] - 0.5,
             py.astype(jnp.float32) + 0.5 + u_pix[..., 1] - 0.5], -1)
    o_cam, d_cam, _t = cam_mod.generate_ray(camera, p_film, u_lens,
                                            jnp.zeros((N,), jnp.float32))
    _, cam_pdf_dir = cam_mod.camera_pdf_we(camera, o_cam, d_cam)
    cam_v = dict(p=o_cam, delta=jnp.zeros((N,), bool))
    # camera subpath: camera endpoint + up to max_depth+1 surface vertices
    # (reference GenerateCameraSubpath(maxDepth + 2))
    n_cam_steps = max_depth + 1
    cv, cam_prev_rev = _walk(scene, camera, sampler, px, py, sample_index,
                             lam, spec_cache, o_cam, d_cam,
                             jnp.ones((N, 4), jnp.float32), cam_pdf_dir,
                             n_cam_steps, _CAM_WALK, record_le=True)
    _fix_prev_rev(cv, cam_prev_rev, True)

    # ---------------- light subpath ---------------------------------------
    stride = _walk_stride(scene)
    lbase = _CAM_WALK + stride * n_cam_steps
    u_pick = smp.sample_1d(sampler, px, py, sample_index, lbase)
    u0 = smp.sample_2d(sampler, px, py, sample_index, lbase + 1)
    u1 = smp.sample_2d(sampler, px, py, sample_index, lbase + 3)
    li, pmf_l, _ = lsamp.sample_light(ls_power, u_pick)
    li = jnp.maximum(li, 0)
    les = lgt.sample_le(scene.lights, li, u0, u1, lam, scene.spectra_pool,
                        scene.tri_geo, scene.scene_radius, scene_center,
                        env=scene.env, spec_cache=spec_cache)
    from ..ops.gather import pool_lookup
    lrow0 = lgt.LightRow(pool_lookup(scene.lights.packed, li))
    lv0 = dict(p=les["o"], ng=les["n_l"], beta=les["L"],
               pdf_fwd=pmf_l * les["pdf_pos"],
               pdf_rev=jnp.zeros((N,), jnp.float32),
               on_surface=les["has_area"], is_delta_light=lrow0.is_delta,
               light_idx=li, valid=les["valid"] & (pmf_l > 0),
               delta=jnp.zeros((N,), bool))
    cos0 = jnp.where(les["has_area"],
                     jnp.abs(vm.dot(les["n_l"], les["d"])), 1.0)
    lbeta0 = les["L"] * safe_div(cos0, pmf_l * les["pdf_pos"]
                                 * les["pdf_dir"])[..., None]
    lbeta0 = jnp.where(lv0["valid"][..., None], lbeta0, 0.0)
    o_l = jnp.where(les["has_area"][..., None],
                    sc.offset_ray_origin(les["o"], les["n_l"], les["d"]),
                    les["o"])
    # light subpath: light endpoint + up to max_depth surface vertices
    # (reference GenerateLightSubpath(maxDepth + 1))
    n_light_steps = max_depth
    wbase = lbase + 5
    lv, light_prev_rev = _walk(scene, camera, sampler, px, py, sample_index,
                               lam, spec_cache, o_l, les["d"], lbeta0,
                               les["pdf_dir"], n_light_steps, wbase,
                               record_le=False, adjoint=True)
    _fix_prev_rev(lv, light_prev_rev, True)
    # pdf_rev of the light vertex itself (onto-endpoint from first surface
    # vertex); only meaningful for area lights (on-surface endpoints)
    if n_light_steps > 0:
        w0 = lv0["p"] - lv[0]["p"]
        d20 = jnp.maximum(vm.length_squared(w0), 1e-20)
        cos_e = jnp.abs(vm.dot(lv0["ng"], w0)) / jnp.sqrt(d20)
        lv0["pdf_rev"] = light_prev_rev[0] * jnp.where(lv0["on_surface"],
                                                       cos_e, 1.0)

    # infinite-light subpath density corrections (reference
    # GenerateLightSubpath, integrators.cpp: "Correct subpath sampling
    # densities for infinite area lights"): the endpoint's spatial density
    # becomes the directional InfiniteLightDensity, the first surface
    # vertex's pdf_fwd becomes the planar positional density x |cos|, and
    # the endpoint's pdf_rev stays a SOLID-ANGLE density (ConvertDensity is
    # identity onto infinite vertices)
    is_inf0 = (lrow0.tag == lgt.LIGHT_UNIFORM_INFINITE) | \
        (lrow0.tag == lgt.LIGHT_IMAGE_INFINITE)
    lv0["infinite"] = is_inf0
    if has_infinite:
        lv0["pdf_fwd"] = jnp.where(
            is_inf0, infinite_light_density(-les["d"], N), lv0["pdf_fwd"])
        if n_light_steps > 0:
            # the planar-density cosine applies only to SURFACE vertices
            # (reference gates the AbsDot on IsOnSurface,
            # integrators.cpp:1688): a medium first-vertex has ng == 0 and
            # the unconditional form zeroed pdf_fwd, which _remap0 then
            # turned into 1 inside MIS ratios — biased weights in
            # infinite-light + fog scenes (ADVICE r4 #1)
            cos0 = jnp.where(_on_surface(lv[0], N),
                             jnp.abs(vm.dot(les["d"], lv[0]["ng"])), 1.0)
            corr0 = les["pdf_pos"] * cos0
            lv[0]["pdf_fwd"] = jnp.where(is_inf0, corr0, lv[0]["pdf_fwd"])
            lv0["pdf_rev"] = jnp.where(is_inf0, light_prev_rev[0] * d20,
                                       lv0["pdf_rev"])

    cbase = wbase + stride * n_light_steps

    use_media = _bdpt_media(scene)

    # ---------------- connections -----------------------------------------
    def tr_visible(pa, nga, pb):
        """(visible mask, transmittance (N,4) or 1.0). Medium vertices
        have ng == 0, so the offset is the identity there."""
        o_sh = sc.offset_ray_origin(pa, nga, vm.normalize(pb - pa))
        dist = vm.length(pb - o_sh)
        vis = ~sc.intersect_p(scene, o_sh, vm.normalize(pb - o_sh),
                              dist * 0.999)
        tr = jnp.exp(-_segment_tau(scene.media, o_sh, pb, lam)) \
            if use_media else 1.0
        return vis, tr

    def mis_weight(s, t, qs, qs_minus, pt, pt_minus, overrides):
        """MISWeight (integrators.cpp:2129): balance over all strategies
        for this path length, via backward remap0 products. `overrides`:
        dict vertex-id -> pdf_rev array replacing the stored one."""
        if s + t == 2:
            return jnp.ones((N,), jnp.float32)
        sum_ri = jnp.zeros((N,), jnp.float32)
        # camera side: vertices cv[0..t-2] are camera surface vertices
        # (cameraVertices[i] for i>=1); loop i = t-1 .. 1
        ri = jnp.ones((N,), jnp.float32)
        for i in range(t - 1, 0, -1):
            v = cv[i - 1]  # cameraVertices[i]
            pr = overrides.get(("c", i), v["pdf_rev"])
            delta_i = overrides.get(("cd", i), v["delta"])
            ri = ri * _remap0(pr) / _remap0(v["pdf_fwd"])
            prev_delta = cv[i - 2]["delta"] if i - 1 >= 1 else \
                jnp.zeros((N,), bool)  # camera endpoint: not delta
            prev_delta = overrides.get(("cd", i - 1), prev_delta)
            sum_ri = sum_ri + jnp.where(~delta_i & ~prev_delta, ri, 0.0)
        # light side: lightVertices[i] for i = s-1 .. 0
        ri = jnp.ones((N,), jnp.float32)
        for i in range(s - 1, -1, -1):
            if i == 0:
                v = overrides.get(("lv0",), lv0)
                pr = overrides.get(("l", 0), v["pdf_rev"])
                delta_i = overrides.get(("ld", 0), v["delta"])
                dlv = v["is_delta_light"]
            else:
                v = lv[i - 1]
                pr = overrides.get(("l", i), v["pdf_rev"])
                delta_i = overrides.get(("ld", i), v["delta"])
                # for i > 0 the reference tests the PREVIOUS vertex's delta
                # flag (lightVertices[0].delta is always false)
                if i - 1 == 0:
                    pv = overrides.get(("lv0",), lv0)
                    dlv = overrides.get(("ld", 0), pv["delta"])
                else:
                    dlv = overrides.get(("ld", i - 1), lv[i - 2]["delta"])
            ri = ri * _remap0(pr) / _remap0(v["pdf_fwd"])
            sum_ri = sum_ri + jnp.where(~delta_i & ~dlv, ri, 0.0)
        return 1.0 / (1.0 + sum_ri)

    strategies = []

    def vert_f(v, p_toward, adjoint=False):
        """f at vertex v toward point p_toward (Vertex::f,
        integrators.cpp:1583 — camera vertices carry Radiance, light
        vertices Importance). Medium lanes return the HG phase value
        (wavelength-flat, no cosine)."""
        wi = vm.normalize(p_toward - v["p"])
        wo_l = _to_local(v["ns"], v["t1"], v["t2"], v["wo"])
        wi_l = _to_local(v["ns"], v["t1"], v["t2"], wi)
        f_s = bxdfs.bsdf_f(v["bp"], wo_l, wi_l, adjoint=adjoint)
        im = v.get("in_medium")
        if im is None:
            return f_s
        ph = usamp.henyey_greenstein(vm.dot(v["wo"], wi), v["g_hg"])
        return jnp.where(im[..., None], ph[..., None], f_s)

    con_i = 0
    for t in range(2, max_depth + 3):
        for s in range(0, max_depth + 2 - t + 1):
            if s + t - 2 > max_depth:
                continue
            pt = cv[t - 2]                       # cameraVertices[t-1]
            pt_minus_p = cv[t - 3]["p"] if t >= 3 else o_cam
            dims = cbase + 3 * con_i
            con_i += 1

            if s == 0:
                # camera subpath alone: pt must be an emissive surface hit
                ok = pt["valid"] & pt["is_light"]
                Lc = pt["beta"] * pt["Le"]
                # MIS overrides: pt.pdf_rev = PDFLightOrigin; ptMinus.pdf_rev
                # = PDFLight
                w_pm = vm.normalize(pt_minus_p - pt["p"])
                ppos, pdir = lgt.pdf_le(scene.lights, pt["light_idx"], w_pm,
                                        scene.tri_geo, scene.scene_radius)
                pmf_pt = light_pmf_of(pt["light_idx"])
                over = {("c", t - 1): ppos * pmf_pt,
                        ("cd", t - 1): jnp.zeros((N,), bool)}
                if t >= 3:
                    d2 = jnp.maximum(vm.length_squared(
                        pt_minus_p - pt["p"]), 1e-20)
                    cos_pm = jnp.where(_on_surface(cv[t - 3], N),
                                       jnp.abs(vm.dot(cv[t - 3]["ng"],
                                                      w_pm)), 1.0)
                    over[("c", t - 2)] = pdir / d2 * cos_pm
                w = mis_weight(s, t, None, None, pt, None, over)
                L_s0 = jnp.where(ok[..., None], Lc * w[..., None], 0.0)
                # escaped rays hitting infinite lights (reference
                # integrators.cpp:1668-1690: IsInfiniteLight in the s=0
                # strategy with PDFLightOrigin = InfiniteLightDensity and
                # PDFLight = planar 1/(pi r^2) density)
                if has_infinite:
                    esc = pt["escaped"]
                    L_esc = pt["beta"] * pt["Le_inf"]
                    d_esc = pt["d_in"]
                    dens = infinite_light_density(d_esc, N,
                                                  p_ref=pt_minus_p)
                    over_esc = {("c", t - 1): dens,
                                ("cd", t - 1): jnp.zeros((N,), bool)}
                    if t >= 3:
                        r_w = jnp.maximum(scene.scene_radius, 1e-6)
                        cos_esc = jnp.where(
                            _on_surface(cv[t - 3], N),
                            jnp.abs(vm.dot(cv[t - 3]["ng"], d_esc)), 1.0)
                        over_esc[("c", t - 2)] = (
                            1.0 / (np.pi * r_w * r_w) * cos_esc)
                    w_esc = mis_weight(s, t, None, None, pt, None, over_esc)
                    L_s0 = L_s0 + jnp.where(esc[..., None],
                                            L_esc * w_esc[..., None], 0.0)
                strategies.append(dict(s=s, t=t, p_raster=None, L=L_s0))
                continue

            if t == 1:
                continue  # handled in the splat pass below

            if s == 1:
                # resample a light toward pt (reference s==1 case)
                u_p1 = smp.sample_1d(sampler, px, py, sample_index, dims)
                u_l1 = smp.sample_2d(sampler, px, py, sample_index, dims + 1)
                li1, pmf1, _ = lsamp.sample_light(ls_power, u_p1)
                li1 = jnp.maximum(li1, 0)
                ls1 = lgt.sample_li(scene.lights, li1, pt["p"], pt["ns"],
                                    u_l1, lam, scene.spectra_pool,
                                    scene.tri_geo, scene.scene_radius,
                                    env=scene.env, spec_cache=spec_cache)
                lr1 = lgt.LightRow(pool_lookup(scene.lights.packed, li1))
                n_s1 = lgt.light_point_normal(scene.lights, li1,
                                              ls1["p_light"], scene.tri_geo)
                on_surf1 = (lr1.tag == lgt.LIGHT_AREA_TRI) | \
                    (lr1.tag == lgt.LIGHT_AREA_SPHERE)
                s_beta = ls1["L"] * safe_div(1.0, ls1["pdf"]
                                             * pmf1)[..., None]
                f_pt = vert_f(pt, ls1["p_light"])
                cos_pt = jnp.where(_on_surface(pt, N),
                                   jnp.abs(vm.dot(ls1["wi"], pt["ns"])), 1.0)
                vis, tr1 = tr_visible(pt["p"], pt["ng"], ls1["p_light"])
                Lc = pt["beta"] * f_pt * s_beta * cos_pt[..., None] * tr1
                ok = pt["valid"] & ~pt["delta"] & ls1["valid"] & \
                    (ls1["pdf"] > 0) & (pmf1 > 0) & vis & \
                    jnp.any(Lc > 0, axis=-1)
                # sampled light vertex for MIS; infinite lights use the
                # directional InfiniteLightDensity as their origin density
                # (reference Vertex::PDFLightOrigin IsInfiniteLight,
                # integrators.cpp:1668-1690)
                inf1 = (lr1.tag == lgt.LIGHT_UNIFORM_INFINITE) | \
                    (lr1.tag == lgt.LIGHT_IMAGE_INFINITE)
                ppos1, _pd = lgt.pdf_le(
                    scene.lights, li1,
                    vm.normalize(pt["p"] - ls1["p_light"]), scene.tri_geo,
                    scene.scene_radius)
                pdf_org1 = jnp.where(
                    inf1, infinite_light_density(ls1["wi"], N,
                                                 p_ref=pt["p"]),
                    ppos1 * pmf1) if has_infinite else ppos1 * pmf1
                sampled = dict(p=ls1["p_light"], ng=n_s1,
                               pdf_fwd=pdf_org1,
                               pdf_rev=jnp.zeros((N,), jnp.float32),
                               on_surface=on_surf1, infinite=inf1,
                               is_delta_light=lr1.is_delta,
                               valid=ok, delta=jnp.zeros((N,), bool))
                over = {("lv0",): sampled}
                # pt.pdf_rev = qs.PDFLight(pt): planar density (no 1/d^2)
                # for infinite lights (reference Vertex::PDFLight)
                w_qp = vm.normalize(pt["p"] - ls1["p_light"])
                _pp, pdir1 = lgt.pdf_le(scene.lights, li1, w_qp,
                                        scene.tri_geo, scene.scene_radius)
                d2qp = jnp.maximum(vm.length_squared(pt["p"]
                                                     - ls1["p_light"]),
                                   1e-20)
                pt_surf = _on_surface(pt, N)
                pl_pt = pdir1 / d2qp * jnp.where(
                    pt_surf, jnp.abs(vm.dot(pt["ng"], w_qp)), 1.0)
                r_w = jnp.maximum(scene.scene_radius, 1e-6)
                pl_inf = (1.0 / (np.pi * r_w * r_w)
                          * jnp.where(pt_surf,
                                      jnp.abs(vm.dot(pt["ng"], ls1["wi"])),
                                      1.0))
                over[("c", t - 1)] = jnp.where(inf1, pl_inf, pl_pt) \
                    if has_infinite else pl_pt
                over[("cd", t - 1)] = jnp.zeros((N,), bool)
                # ptMinus.pdf_rev = pt.PDF(qs, ptMinus)
                if t >= 3:
                    over[("c", t - 2)] = _surface_pdf(
                        dict(pt, wo=vm.normalize(ls1["p_light"] - pt["p"])),
                        ls1["p_light"], cv[t - 3]["p"], cv[t - 3]["ng"],
                        _on_surface(cv[t - 3], N))
                # qs.pdf_rev = pt.PDF(ptMinus, qs)
                over[("l", 0)] = _surface_pdf(pt, pt_minus_p, ls1["p_light"],
                                              n_s1, on_surf1,
                                              next_infinite=inf1)
                over[("ld", 0)] = jnp.zeros((N,), bool)
                w = mis_weight(s, t, sampled, None, pt, None, over)
                strategies.append(dict(s=s, t=t, p_raster=None,
                                       L=jnp.where(ok[..., None],
                                                   Lc * w[..., None], 0.0)))
                continue

            # ----- general s >= 2, t >= 2 connection -----
            qs = lv[s - 2]                      # lightVertices[s-1]
            qs_minus_p = lv[s - 3]["p"] if s >= 3 else lv0["p"]
            f_qs = vert_f(qs, pt["p"], adjoint=True)
            f_pt = vert_f(pt, qs["p"])
            wd = qs["p"] - pt["p"]
            d2 = jnp.maximum(vm.length_squared(wd), 1e-20)
            wn = wd / jnp.sqrt(d2)[..., None]
            # G(): cos only at surface endpoints (reference
            # integrators.cpp:2118 — IsOnSurface gates each cos)
            cos_q = jnp.where(_on_surface(qs, N),
                              jnp.abs(vm.dot(qs["ns"], wn)), 1.0)
            cos_p = jnp.where(_on_surface(pt, N),
                              jnp.abs(vm.dot(pt["ns"], wn)), 1.0)
            g = cos_q * cos_p / d2
            vis, tr_c = tr_visible(pt["p"], pt["ng"], qs["p"])
            Lc = qs["beta"] * f_qs * f_pt * pt["beta"] * g[..., None] * tr_c
            ok = qs["valid"] & pt["valid"] & ~qs["delta"] & ~pt["delta"] & \
                vis & jnp.any(Lc > 0, axis=-1)
            over = {
                ("cd", t - 1): jnp.zeros((N,), bool),
                ("ld", s - 1): jnp.zeros((N,), bool),
                # pt.pdf_rev = qs.PDF(qsMinus, pt)
                ("c", t - 1): _surface_pdf(qs, qs_minus_p, pt["p"],
                                           pt["ng"], _on_surface(pt, N)),
                # qs.pdf_rev = pt.PDF(ptMinus, qs)
                ("l", s - 1): _surface_pdf(pt, pt_minus_p, qs["p"],
                                           qs["ng"], _on_surface(qs, N)),
            }
            # ptMinus.pdf_rev = pt.PDF(qs, ptMinus)
            if t >= 3:
                over[("c", t - 2)] = _surface_pdf(
                    pt, qs["p"], cv[t - 3]["p"], cv[t - 3]["ng"],
                    _on_surface(cv[t - 3], N))
            # qsMinus.pdf_rev = qs.PDF(pt, qsMinus)
            if s >= 3:
                over[("l", s - 2)] = _surface_pdf(
                    qs, pt["p"], lv[s - 3]["p"], lv[s - 3]["ng"],
                    _on_surface(lv[s - 3], N))
            elif s == 2:
                over[("l", 0)] = _surface_pdf(
                    qs, pt["p"], lv0["p"], lv0["ng"], lv0["on_surface"],
                    next_infinite=lv0.get("infinite"))
            w = mis_weight(s, t, qs, None, pt, None, over)
            strategies.append(dict(s=s, t=t, p_raster=None,
                                   L=jnp.where(ok[..., None],
                                               Lc * w[..., None], 0.0)))

    # ---------------- t == 1 splat strategies ------------------------------
    def to_rgb(L):
        return film_mod.sensor_to_sensor_rgb(sensor, L, swl)

    for s in range(2, max_depth + 2):
        if s + 1 - 2 > max_depth:
            continue
        qs = lv[s - 2]
        qs_minus_p = lv[s - 3]["p"] if s >= 3 else lv0["p"]
        dims = cbase + 3 * con_i
        con_i += 1
        u_c1 = smp.sample_2d(sampler, px, py, sample_index, dims)
        cs = cam_mod.camera_sample_wi(camera, qs["p"], u_c1)
        f_qs = vert_f(qs, cs["p_lens"], adjoint=True)
        cos_qs = jnp.where(_on_surface(qs, N),
                           jnp.abs(vm.dot(cs["wi"], qs["ns"])), 1.0)
        cam_beta = cs["we"] * safe_div(1.0, cs["pdf"])
        vis, tr_t1 = tr_visible(qs["p"], qs["ng"], cs["p_lens"])
        Lc = qs["beta"] * f_qs * (cos_qs * cam_beta)[..., None] * tr_t1
        ok = qs["valid"] & ~qs["delta"] & cs["valid"] & (cs["pdf"] > 0) & \
            vis & jnp.any(Lc > 0, axis=-1)
        over = {
            ("ld", s - 1): jnp.zeros((N,), bool),
            # qs.pdf_rev = cameraVertex.PDF(None, qs)
        }
        _pp, cpdir = cam_mod.camera_pdf_we(camera, cs["p_lens"], -cs["wi"])
        over[("l", s - 1)] = _convert_density(cpdir, cs["p_lens"], qs["p"],
                                              qs["ng"],
                                              _on_surface(qs, N))
        if s >= 3:
            over[("l", s - 2)] = _surface_pdf(
                qs, cs["p_lens"], lv[s - 3]["p"], lv[s - 3]["ng"],
                _on_surface(lv[s - 3], N))
        elif s == 2:
            over[("l", 0)] = _surface_pdf(
                qs, cs["p_lens"], lv0["p"], lv0["ng"], lv0["on_surface"],
                next_infinite=lv0.get("infinite"))
        w = mis_weight(s, 1, qs, None, None, None, over)
        strategies.append(dict(s=s, t=1, p_raster=cs["p_raster"],
                               L=jnp.where(ok[..., None],
                                           Lc * w[..., None], 0.0)))

    if collect:
        return strategies, splat
    L_total = jnp.zeros((N, 4), jnp.float32)
    for st in strategies:
        if st["t"] == 1:
            splat = _splat(splat, camera, st["p_raster"], to_rgb(st["L"]),
                           jnp.any(st["L"] != 0, axis=-1))
        else:
            L_total = L_total + st["L"]
    return L_total, splat


def render_wave_film(scene, camera, sampler, filt, sensor, film, pixel_idx,
                     sample_index, opts):
    """Driver hook: BDPT wave — pixel-sample L from t>=2 strategies plus
    t=1 splats."""
    px = pixel_idx % camera.width
    py = pixel_idx // camera.width
    u_lam = smp.sample_1d(sampler, px, py, sample_index, 5)
    if opts.sample_visible_wavelengths:
        swl = spc.sample_visible_wavelengths(u_lam)
    else:
        swl = spc.sample_uniform_wavelengths(u_lam)
    L, splat = trace_bdpt(scene, camera, sensor, sampler, px, py,
                          sample_index, swl, opts, film.splat_sum)
    film = film.replace(splat_sum=splat)
    rgb = film_mod.sensor_to_sensor_rgb(sensor, L, swl)
    return film_mod.add_samples(film, pixel_idx, rgb,
                                jnp.ones(pixel_idx.shape[0], jnp.float32))
