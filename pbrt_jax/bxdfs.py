"""BxDFs in the local shading frame (reference bxdfs.{h,cpp},
util/scattering.{h,cpp}; closed world base/bxdf.h:154).

Conventions follow the reference: wo/wi in shading space with n = (0,0,1),
both pointing away from the surface; f includes no cosine; pdfs are solid
angle. All functions are batched over leading axes; spectral values (..., 4).

Dispatch: instead of TaggedPointer::Dispatch we evaluate the closed set of
BxDF lobes and select by tag (evaluate-all-and-select vectorizes cleanly on
the VPU; per-tag compaction is a later optimization mirroring the
reference's per-material wavefront queues).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
from .utils import struct

from .utils import vecmath as vm
from .utils.math import sqr, safe_sqrt, safe_div, PI, INV_PI, lerp
from .utils import sampling as sp

BXDF_NONE = -1
BXDF_DIFFUSE = 0
BXDF_CONDUCTOR = 1
BXDF_DIELECTRIC = 2
BXDF_THIN_DIELECTRIC = 3
BXDF_DIFFUSE_TRANSMISSION = 4
BXDF_COATED_DIFFUSE = 5
BXDF_COATED_CONDUCTOR = 6
BXDF_HAIR = 7
BXDF_SUBSURFACE = 8  # handled by the integrator's BSSRDF stage, not a lobe
BXDF_MEASURED = 9    # tabulated (theta_h, theta_d, phi_d) BRDF (bxdfs.h:1022)

# flags (reference base/bxdf.h BxDFFlags)
FLAG_REFLECTION = 1
FLAG_TRANSMISSION = 2
FLAG_DIFFUSE = 4
FLAG_GLOSSY = 8
FLAG_SPECULAR = 16


@struct.dataclass
class BSDFParams:
    """Per-lane BSDF parameters after texture evaluation."""
    tag: jnp.ndarray          # (N,) int32
    albedo: jnp.ndarray       # (N, 4) reflectance spectrum samples
    alpha_x: jnp.ndarray      # (N,)
    alpha_y: jnp.ndarray      # (N,)
    eta: jnp.ndarray          # (N, 4) real IOR (dielectric: scalar-per-lambda)
    k: jnp.ndarray            # (N, 4) absorption (conductor)
    # layered coats (CoatedDiffuse / CoatedConductor): interface roughness
    # and IOR; None when the scene has no coated-conductor materials
    coat_alpha: jnp.ndarray = None   # (N,)
    coat_eta: jnp.ndarray = None     # (N,)
    # hair: azimuthal offset h in [-1, 1] from the curve hit's v coordinate
    h: jnp.ndarray = None
    # measured BRDF table ((Nh*Nd*Np, 4) coeffs+scale), shared per scene
    measured_table: jnp.ndarray = None
    # static set of tags actually present (None = all): dispatchers compile
    # only these branches (per-material kernel specialization)
    tags_present: tuple = struct.field(pytree_node=False, default=None)


# ---------------------------------------------------------------------------
# Fresnel (reference util/scattering.h FrDielectric / FrComplex)

def fr_dielectric(cos_theta_i, eta):
    """Unpolarized Fresnel reflectance, real eta. cos_theta_i may be negative
    (ray inside medium) — eta is flipped accordingly."""
    cos_theta_i = jnp.clip(cos_theta_i, -1.0, 1.0)
    flip = cos_theta_i < 0
    eta = jnp.where(flip, 1.0 / eta, eta)
    cos_theta_i = jnp.abs(cos_theta_i)
    sin2_i = 1.0 - sqr(cos_theta_i)
    sin2_t = sin2_i / sqr(eta)
    cos_theta_t = safe_sqrt(1.0 - sin2_t)
    r_parl = safe_div(eta * cos_theta_i - cos_theta_t,
                      eta * cos_theta_i + cos_theta_t)
    r_perp = safe_div(cos_theta_i - eta * cos_theta_t,
                      cos_theta_i + eta * cos_theta_t)
    F = 0.5 * (sqr(r_parl) + sqr(r_perp))
    return jnp.where(sin2_t >= 1.0, 1.0, F)


def fr_complex(cos_theta_i, eta, k):
    """Fresnel for complex IOR eta - i k (conductors), computed with explicit
    complex arithmetic in real pairs (reference FrComplex)."""
    cos_theta_i = jnp.clip(jnp.abs(cos_theta_i), 0.0, 1.0)
    cos2 = sqr(cos_theta_i)
    sin2 = 1.0 - cos2
    # eta_c^2 = (eta^2 - k^2) + i(2 eta k)
    e2r = sqr(eta) - sqr(k)
    e2i = 2.0 * eta * k
    # sin2_t = sin2 / eta_c^2 ; cos2_t = 1 - sin2_t ; need sqrt(cos2_t)*eta_c
    # work with w = sqrt(eta_c^2 - sin2) (complex sqrt)
    wr = e2r - sin2
    wi = e2i
    mag = jnp.sqrt(jnp.maximum(sqr(wr) + sqr(wi), 1e-30))
    sr = jnp.sqrt(jnp.maximum((mag + wr) / 2.0, 0.0))
    si = jnp.sign(wi) * jnp.sqrt(jnp.maximum((mag - wr) / 2.0, 0.0))
    # r_perp = (cos - w) / (cos + w)
    def cdiv(ar, ai, br, bi):
        den = jnp.maximum(sqr(br) + sqr(bi), 1e-30)
        return ((ar * br + ai * bi) / den, (ai * br - ar * bi) / den)
    rp_r, rp_i = cdiv(cos_theta_i - sr, -si, cos_theta_i + sr, si)
    r_perp = sqr(rp_r) + sqr(rp_i)
    # r_parl = (eta_c^2 cos - w) / (eta_c^2 cos + w)
    ar, ai = e2r * cos_theta_i - sr, e2i * cos_theta_i - si
    br, bi = e2r * cos_theta_i + sr, e2i * cos_theta_i + si
    rl_r, rl_i = cdiv(ar, ai, br, bi)
    r_parl = sqr(rl_r) + sqr(rl_i)
    return 0.5 * (r_perp + r_parl)


# ---------------------------------------------------------------------------
# Trowbridge-Reitz / GGX (reference util/scattering.h:109)

def tr_d(wm, ax, ay):
    tan2 = vm.tan2_theta(wm)
    cos4 = sqr(vm.cos2_theta(wm))
    e = (sqr(vm.cos_phi(wm) / ax) + sqr(vm.sin_phi(wm) / ay)) * tan2
    d = safe_div(1.0, PI * ax * ay * cos4 * sqr(1.0 + e))
    return jnp.where(jnp.isfinite(tan2), d, 0.0)


def tr_lambda(w, ax, ay):
    tan2 = vm.tan2_theta(w)
    alpha2 = sqr(vm.cos_phi(w) * ax) + sqr(vm.sin_phi(w) * ay)
    lam = (safe_sqrt(1.0 + alpha2 * tan2) - 1.0) / 2.0
    return jnp.where(jnp.isfinite(tan2), lam, 0.0)


def tr_g1(w, ax, ay):
    return 1.0 / (1.0 + tr_lambda(w, ax, ay))


def tr_g(wo, wi, ax, ay):
    return 1.0 / (1.0 + tr_lambda(wo, ax, ay) + tr_lambda(wi, ax, ay))


def tr_d_visible(w, wm, ax, ay):
    """Visible-normal distribution PDF of wm given w."""
    return safe_div(tr_g1(w, ax, ay) * vm.absdot(w, wm) * tr_d(wm, ax, ay),
                    vm.abs_cos_theta(w))


def tr_sample_wm(w, u, ax, ay):
    """Sample visible normals (reference TrowbridgeReitz Sample_wm; Heitz 2018)."""
    wh = vm.normalize(jnp.stack([ax * w[..., 0], ay * w[..., 1], w[..., 2]], -1))
    wh = jnp.where((wh[..., 2] < 0)[..., None], -wh, wh)
    t1 = jnp.where((wh[..., 2] < 0.999)[..., None],
                   vm.normalize(vm.cross(jnp.broadcast_to(
                       jnp.asarray([0.0, 0.0, 1.0], jnp.float32), wh.shape), wh)),
                   jnp.broadcast_to(jnp.asarray([1.0, 0.0, 0.0], jnp.float32), wh.shape))
    t2 = vm.cross(wh, t1)
    p = sp.sample_uniform_disk_concentric(u)
    h = safe_sqrt(1.0 - sqr(p[..., 0]))
    py = lerp((1.0 + wh[..., 2]) / 2.0, h, p[..., 1])
    pz = safe_sqrt(1.0 - sqr(p[..., 0]) - sqr(py))
    nh = p[..., 0][..., None] * t1 + py[..., None] * t2 + pz[..., None] * wh
    wm = jnp.stack([ax * nh[..., 0], ay * nh[..., 1],
                    jnp.maximum(nh[..., 2], 1e-6)], -1)
    return vm.normalize(wm)


def tr_pdf(w, wm, ax, ay):
    return tr_d_visible(w, wm, ax, ay) / (4.0 * jnp.maximum(vm.absdot(w, wm), 1e-8)) * \
        4.0 * vm.absdot(w, wm) / (4.0 * jnp.maximum(vm.absdot(w, wm), 1e-8))


def tr_effectively_smooth(ax, ay):
    return jnp.maximum(ax, ay) < 1e-3


def roughness_to_alpha(roughness):
    """(reference scattering.h RoughnessToAlpha: sqrt)"""
    return jnp.sqrt(jnp.maximum(roughness, 0.0))


# ---------------------------------------------------------------------------
# Lobe evaluations; each returns (f (N,4), pdf (N,)) given local wo, wi

def _diffuse_f_pdf(p: BSDFParams, wo, wi):
    same = vm.same_hemisphere(wo, wi)
    f = jnp.where(same[..., None], p.albedo * INV_PI, 0.0)
    pdf = jnp.where(same, sp.cosine_hemisphere_pdf(vm.abs_cos_theta(wi)), 0.0)
    return f, pdf


def _diffuse_transmission_f_pdf(p: BSDFParams, wo, wi):
    same = vm.same_hemisphere(wo, wi)
    # albedo = reflectance; use k slot as transmittance color
    f = jnp.where(same[..., None], p.albedo * INV_PI, p.k * INV_PI)
    pr = jnp.max(p.albedo, axis=-1)
    pt = jnp.max(p.k, axis=-1)
    tot = jnp.maximum(pr + pt, 1e-9)
    pdf = jnp.where(same, pr / tot, pt / tot) * \
        sp.cosine_hemisphere_pdf(vm.abs_cos_theta(wi))
    return f, pdf


def _conductor_f_pdf(p: BSDFParams, wo, wi):
    """Rough conductor; smooth case handled in sampling as specular."""
    same = vm.same_hemisphere(wo, wi)
    cos_o = vm.abs_cos_theta(wo)
    cos_i = vm.abs_cos_theta(wi)
    wm = wo + wi
    wm_ok = vm.length_squared(wm) > 1e-12
    wm = vm.normalize(wm)
    F = fr_complex(vm.absdot(wo, wm)[..., None], p.eta, p.k)
    d = tr_d(wm, p.alpha_x, p.alpha_y)
    g = tr_g(wo, wi, p.alpha_x, p.alpha_y)
    f = safe_div(d * g, 4.0 * cos_o * cos_i)[..., None] * F
    pdf = tr_d_visible(wo, wm, p.alpha_x, p.alpha_y) / \
        (4.0 * jnp.maximum(vm.absdot(wo, wm), 1e-8))
    smooth = tr_effectively_smooth(p.alpha_x, p.alpha_y)
    valid = same & wm_ok & ~smooth & (cos_o > 0) & (cos_i > 0)
    return jnp.where(valid[..., None], f, 0.0), jnp.where(valid, pdf, 0.0)


def _coated_diffuse_f_pdf(p: BSDFParams, wo, wi):
    """Coated diffuse as a Fresnel-weighted blend of a GGX dielectric coat
    and a Lambertian base (round-1 approximation of the reference's
    stochastic LayeredBxDF walk, bxdfs.h:432 — energy-compensated blend;
    the full Guo et al. walk is a planned upgrade)."""
    same = vm.same_hemisphere(wo, wi)
    eta_s = p.eta[..., 0]
    cos_o = vm.abs_cos_theta(wo)
    cos_i = vm.abs_cos_theta(wi)
    F_o = fr_dielectric(cos_o, eta_s)
    F_i = fr_dielectric(cos_i, eta_s)
    # specular coat lobe (GGX), reusing conductor-style microfacet math
    wm = wo + wi
    wm_ok = vm.length_squared(wm) > 1e-12
    wm = vm.normalize(wm)
    F_m = fr_dielectric(vm.absdot(wo, wm), eta_s)
    d = tr_d(wm, p.alpha_x, p.alpha_y)
    g = tr_g(wo, wi, p.alpha_x, p.alpha_y)
    f_spec = safe_div(d * g * F_m, 4.0 * cos_o * cos_i)
    # diffuse base attenuated by both interface transmissions
    f_diff = (1.0 - F_o)[..., None] * (1.0 - F_i)[..., None] * \
        p.albedo * INV_PI
    smooth = tr_effectively_smooth(p.alpha_x, p.alpha_y)
    f = f_diff + jnp.where((wm_ok & ~smooth)[..., None],
                           f_spec[..., None] * jnp.ones_like(p.albedo), 0.0)
    pdf_spec = tr_d_visible(wo, wm, p.alpha_x, p.alpha_y) / \
        (4.0 * jnp.maximum(vm.absdot(wo, wm), 1e-8))
    pdf = F_o * jnp.where(smooth | ~wm_ok, 0.0, pdf_spec) + \
        (1.0 - F_o) * sp.cosine_hemisphere_pdf(cos_i)
    valid = same & (cos_o > 0) & (cos_i > 0)
    return jnp.where(valid[..., None], f, 0.0), jnp.where(valid, pdf, 0.0)


def _coat_params(p: BSDFParams):
    ca = p.coat_alpha if p.coat_alpha is not None else p.alpha_x
    ce = p.coat_eta if p.coat_eta is not None else p.eta[..., 0]
    return ca, ce


def _coated_conductor_f_pdf(p: BSDFParams, wo, wi):
    """Coated conductor as a Fresnel-weighted blend of a GGX dielectric coat
    (coat_alpha/coat_eta) over a microfacet conductor base (alpha_x/y +
    eta/k), with the base attenuated by both interface transmissions
    (approximation of the reference's stochastic CoatedConductorBxDF layered
    walk, bxdfs.h:432/1165 — single-scatter, no interreflection term)."""
    ca, ce = _coat_params(p)
    same = vm.same_hemisphere(wo, wi)
    cos_o = vm.abs_cos_theta(wo)
    cos_i = vm.abs_cos_theta(wi)
    F_o = fr_dielectric(cos_o, ce)
    F_i = fr_dielectric(cos_i, ce)
    wm = wo + wi
    wm_ok = vm.length_squared(wm) > 1e-12
    wm = vm.normalize(wm)
    F_m = fr_dielectric(vm.absdot(wo, wm), ce)
    d = tr_d(wm, ca, ca)
    g = tr_g(wo, wi, ca, ca)
    f_coat = safe_div(d * g * F_m, 4.0 * cos_o * cos_i)
    coat_smooth = tr_effectively_smooth(ca, ca)
    f_base, pdf_base = _conductor_f_pdf(p, wo, wi)
    f = (1.0 - F_o)[..., None] * (1.0 - F_i)[..., None] * f_base + \
        jnp.where((wm_ok & ~coat_smooth)[..., None],
                  f_coat[..., None] * jnp.ones_like(p.albedo), 0.0)
    pdf_coat = tr_d_visible(wo, wm, ca, ca) / \
        (4.0 * jnp.maximum(vm.absdot(wo, wm), 1e-8))
    pdf = F_o * jnp.where(coat_smooth | ~wm_ok, 0.0, pdf_coat) + \
        (1.0 - F_o) * pdf_base
    valid = same & (cos_o > 0) & (cos_i > 0)
    return jnp.where(valid[..., None], f, 0.0), jnp.where(valid, pdf, 0.0)


def _dielectric_f_pdf(p: BSDFParams, wo, wi, adjoint=False):
    """Rough dielectric reflection+transmission (reference DielectricBxDF::f).

    adjoint: importance transport (TransportMode::Importance) — the
    radiance-compression factor 1/etap^2 applies only when carrying
    RADIANCE across a refraction (reference bxdfs.cpp:110 "if (mode ==
    TransportMode::Radiance) ft /= Sqr(etap)"); light subpaths
    (BDPT/MLT/SPPM photons/lightpath) must skip it."""
    eta_s = p.eta[..., 0]  # non-dispersive path for eval (hero wavelength)
    cos_o = vm.cos_theta(wo)
    cos_i = vm.cos_theta(wi)
    reflectv = cos_i * cos_o > 0
    etap = jnp.where(reflectv, 1.0, jnp.where(cos_o > 0, eta_s, 1.0 / eta_s))
    wm = wi * etap[..., None] + wo
    wm_ok = vm.length_squared(wm) > 1e-12
    wm = vm.normalize(wm)
    wm = jnp.where((vm.cos_theta(wm) < 0)[..., None], -wm, wm)
    # discard backfacing microfacets
    backface = (vm.dot(wm, wi) * cos_i < 0) | (vm.dot(wm, wo) * cos_o < 0)
    F = fr_dielectric(vm.dot(wo, wm), eta_s)
    d = tr_d(wm, p.alpha_x, p.alpha_y)
    g = tr_g(wo, wi, p.alpha_x, p.alpha_y)
    # reflection
    f_r = safe_div(d * g * F, jnp.abs(4.0 * cos_o * cos_i))
    # transmission
    denom = sqr(vm.dot(wi, wm) + vm.dot(wo, wm) / etap)
    f_t = safe_div(d * (1.0 - F) * g *
                   jnp.abs(vm.dot(wi, wm) * vm.dot(wo, wm)),
                   jnp.abs(cos_i * cos_o) * denom)
    if not adjoint:
        f_t = f_t / sqr(etap)
    f_scalar = jnp.where(reflectv, f_r, f_t)
    # pdf with MIS-weighted lobe choice R/(R+T)
    pdf_wm = tr_d_visible(wo, wm, p.alpha_x, p.alpha_y)
    pr, pt = F, 1.0 - F
    dwm_dwi_r = 1.0 / (4.0 * jnp.maximum(vm.absdot(wo, wm), 1e-8))
    dwm_dwi_t = safe_div(jnp.abs(vm.dot(wi, wm)), denom)
    pdf = jnp.where(reflectv,
                    pdf_wm * dwm_dwi_r * safe_div(pr, pr + pt),
                    pdf_wm * dwm_dwi_t * safe_div(pt, pr + pt))
    smooth = tr_effectively_smooth(p.alpha_x, p.alpha_y)
    valid = wm_ok & ~smooth & ~backface & (cos_o != 0) & (cos_i != 0)
    f = jnp.where(valid[..., None], f_scalar[..., None] * jnp.ones_like(p.albedo), 0.0)
    return f, jnp.where(valid, pdf, 0.0)




# ---------------------------------------------------------------------------
# Hair BxDF (reference bxdfs.h:921 HairBxDF; Marschner 2003 decomposition
# with Chiang 2016 azimuthal logistic lobes). Hair shading frame: +x along
# the fiber (dpdu = curve tangent), the (y, z) plane is the normal plane.
# Parameter packing in BSDFParams: albedo = spectral sigma_a, alpha_x =
# beta_m, alpha_y = beta_n, eta = IOR, h = azimuthal offset (from the curve
# hit's v coordinate), coat_eta slot unused, tilt alpha fixed at 2 degrees
# (the reference's default).

_P_MAX = 3
_HAIR_ALPHA = np.deg2rad(2.0)


def _i0(x):
    """Modified Bessel I0, 10-term series (reference util/math.h I0)."""
    val = jnp.zeros_like(x)
    x2i = jnp.ones_like(x)
    ifact = 1.0
    i4 = 1.0
    for i in range(10):
        if i > 1:
            ifact *= i
        val = val + x2i / (i4 * ifact * ifact)
        x2i = x2i * x * x
        i4 *= 4.0
    return val


def _log_i0(x):
    big = x + 0.5 * (-jnp.log(2.0 * np.pi) +
                     jnp.log(safe_div(1.0, jnp.maximum(x, 1e-6))) +
                     safe_div(1.0, 8.0 * jnp.maximum(x, 1e-6)))
    return jnp.where(x > 12.0, big, jnp.log(jnp.maximum(_i0(x), 1e-30)))


def _mp(cos_i, cos_o, sin_i, sin_o, v):
    """Longitudinal scattering lobe (reference Mp, bxdfs.cpp)."""
    a = cos_i * cos_o / v
    b = sin_i * sin_o / v
    small = jnp.exp(_log_i0(a) - b - safe_div(1.0, v) + 0.6931 +
                    jnp.log(safe_div(1.0, 2.0 * v)))
    big = safe_div(jnp.exp(-b) * _i0(a),
                   jnp.sinh(safe_div(1.0, v)) * 2.0 * v)
    return jnp.where(v <= 0.1, small, big)


def _logistic(x, s):
    x = jnp.abs(x)
    e = jnp.exp(-x / s)
    return safe_div(e, s * sqr(1.0 + e))


def _logistic_cdf(x, s):
    return 1.0 / (1.0 + jnp.exp(-x / s))


def _trimmed_logistic(x, s, a, b):
    return safe_div(_logistic(x, s),
                    _logistic_cdf(b, s) - _logistic_cdf(a, s))


def _sample_trimmed_logistic(u, s, a, b):
    k = _logistic_cdf(b, s) - _logistic_cdf(a, s)
    x = -s * jnp.log(safe_div(1.0, u * k + _logistic_cdf(a, s)) - 1.0)
    return jnp.clip(x, a, b)


def _phi_p(p, gamma_o, gamma_t):
    return 2.0 * p * gamma_t - 2.0 * gamma_o + p * np.pi


def _wrap_phi(dphi):
    # wrap to [-pi, pi]
    return dphi - 2.0 * np.pi * jnp.floor((dphi + np.pi) / (2.0 * np.pi))


def _np_lobe(phi, p, s, gamma_o, gamma_t):
    return _trimmed_logistic(_wrap_phi(phi - _phi_p(p, gamma_o, gamma_t)),
                             s, -np.pi, np.pi)


def _hair_vs(beta_m, beta_n):
    v0 = sqr(0.726 * beta_m + 0.812 * sqr(beta_m) + 3.7 * beta_m ** 20)
    vs = [v0, 0.25 * v0, 4.0 * v0, 4.0 * v0]
    s_az = 0.626657069 * (0.265 * beta_n + 1.194 * sqr(beta_n) +
                          5.372 * beta_n ** 22)
    return vs, jnp.maximum(s_az, 1e-5)


def _hair_tilt(sin_to, cos_to, p):
    """Rotate (sin, cos) theta_o by the cuticle tilt for lobe p
    (reference: -2a for R, +a for TT, +4a for TRT)."""
    s1, c1 = np.sin(_HAIR_ALPHA), np.cos(_HAIR_ALPHA)
    s2, c2 = np.sin(2 * _HAIR_ALPHA), np.cos(2 * _HAIR_ALPHA)
    s4, c4 = np.sin(4 * _HAIR_ALPHA), np.cos(4 * _HAIR_ALPHA)
    if p == 0:
        so = sin_to * c2 - cos_to * s2
        co = cos_to * c2 + sin_to * s2
    elif p == 1:
        so = sin_to * c1 + cos_to * s1
        co = cos_to * c1 - sin_to * s1
    elif p == 2:
        so = sin_to * c4 + cos_to * s4
        co = cos_to * c4 - sin_to * s4
    else:
        so, co = sin_to, cos_to
    return so, jnp.abs(co)


def _hair_geom(p: BSDFParams, wo):
    sin_to = jnp.clip(wo[..., 0], -1.0, 1.0)
    cos_to = safe_sqrt(1.0 - sqr(sin_to))
    phi_o = jnp.arctan2(wo[..., 2], wo[..., 1])
    eta = p.eta[..., 0]
    h = jnp.clip(p.h, -1.0, 1.0) if p.h is not None else jnp.zeros_like(sin_to)
    gamma_o = jnp.arcsin(h)
    # refracted longitudinal/azimuthal angles
    sin_tt = sin_to / eta
    cos_tt = safe_sqrt(1.0 - sqr(sin_tt))
    etap = safe_sqrt(sqr(eta) - sqr(sin_to)) / jnp.maximum(cos_to, 1e-6)
    sin_gt = jnp.clip(h / jnp.maximum(etap, 1e-6), -1.0, 1.0)
    cos_gt = safe_sqrt(1.0 - sqr(sin_gt))
    gamma_t = jnp.arcsin(sin_gt)
    return (sin_to, cos_to, phi_o, eta, h, gamma_o, sin_tt, cos_tt,
            sin_gt, cos_gt, gamma_t)


def _hair_ap(p: BSDFParams, cos_to, cos_tt, cos_gt, eta, h):
    """Attenuations A_p (list of 4 spectra) (reference Ap, bxdfs.cpp)."""
    sigma_a = p.albedo
    T = jnp.exp(-sigma_a * (2.0 * cos_gt / jnp.maximum(cos_tt, 1e-6))[..., None])
    cos_g = safe_sqrt(1.0 - sqr(h))
    f = fr_dielectric(cos_to * cos_g, eta)[..., None]
    ap0 = jnp.broadcast_to(f, T.shape)
    ap1 = sqr(1.0 - f) * T
    ap2 = ap1 * T * f
    ap3 = safe_div(ap2 * f * T, jnp.maximum(1.0 - T * f, 1e-6))
    return [ap0, ap1, ap2, ap3]


def _hair_f_pdf(p: BSDFParams, wo, wi):
    """(f, pdf) of the hair BxDF for given directions."""
    (sin_to, cos_to, phi_o, eta, h, gamma_o, sin_tt, cos_tt, sin_gt,
     cos_gt, gamma_t) = _hair_geom(p, wo)
    sin_ti = jnp.clip(wi[..., 0], -1.0, 1.0)
    cos_ti = safe_sqrt(1.0 - sqr(sin_ti))
    phi_i = jnp.arctan2(wi[..., 2], wi[..., 1])
    phi = phi_i - phi_o
    vs, s_az = _hair_vs(p.alpha_x, p.alpha_y)
    ap = _hair_ap(p, cos_to, cos_tt, cos_gt, eta, h)
    # lobe-selection pdf weights: luminance-normalized attenuations
    ap_lum = [jnp.mean(a, axis=-1) for a in ap]
    lum_sum = jnp.maximum(sum(ap_lum), 1e-9)
    f = jnp.zeros_like(p.albedo)
    pdf = jnp.zeros_like(sin_to)
    for lobe in range(_P_MAX):
        so, co = _hair_tilt(sin_to, cos_to, lobe)
        mp = _mp(cos_ti, co, sin_ti, so, vs[lobe])
        np_l = _np_lobe(phi, lobe, s_az, gamma_o, gamma_t)
        f = f + mp[..., None] * ap[lobe] * np_l[..., None]
        pdf = pdf + mp * (ap_lum[lobe] / lum_sum) * np_l
    mp3 = _mp(cos_ti, cos_to, sin_ti, sin_to, vs[3])
    f = f + mp3[..., None] * ap[3] / (2.0 * np.pi)
    pdf = pdf + mp3 * (ap_lum[3] / lum_sum) / (2.0 * np.pi)
    abs_ci = jnp.maximum(vm.abs_cos_theta(wi), 1e-6)
    f = f / abs_ci[..., None]
    return f, pdf


def _hair_sample(p: BSDFParams, wo, uc, u2):
    """Sample wi ~ hair BxDF (reference HairBxDF::Sample_f)."""
    (sin_to, cos_to, phi_o, eta, h, gamma_o, sin_tt, cos_tt, sin_gt,
     cos_gt, gamma_t) = _hair_geom(p, wo)
    vs, s_az = _hair_vs(p.alpha_x, p.alpha_y)
    ap = _hair_ap(p, cos_to, cos_tt, cos_gt, eta, h)
    ap_lum = [jnp.mean(a, axis=-1) for a in ap]
    lum_sum = jnp.maximum(sum(ap_lum), 1e-9)
    # choose lobe by attenuation luminance with uc
    c0 = ap_lum[0] / lum_sum
    c1 = c0 + ap_lum[1] / lum_sum
    c2 = c1 + ap_lum[2] / lum_sum
    lobe = jnp.where(uc < c0, 0, jnp.where(uc < c1, 1,
                     jnp.where(uc < c2, 2, 3)))
    # remap uc within the chosen lobe for the Mp sample
    lo = jnp.where(lobe == 0, 0.0, jnp.where(lobe == 1, c0,
                   jnp.where(lobe == 2, c1, c2)))
    hi = jnp.where(lobe == 0, c0, jnp.where(lobe == 1, c1,
                   jnp.where(lobe == 2, c2, 1.0)))
    u0 = jnp.clip(safe_div(uc - lo, jnp.maximum(hi - lo, 1e-9)), 1e-5,
                  1.0 - 1e-5)
    # tilted outgoing angle per lobe
    so_t = jnp.zeros_like(sin_to)
    co_t = jnp.zeros_like(cos_to)
    v_sel = jnp.zeros_like(sin_to)
    for lb in range(4):
        so, co = _hair_tilt(sin_to, cos_to, lb)
        m = lobe == lb
        so_t = jnp.where(m, so, so_t)
        co_t = jnp.where(m, co, co_t)
        v_sel = jnp.where(m, vs[lb], v_sel)
    # sample Mp: cosTheta = 1 + v log(u + (1-u) e^{-2/v})
    cos_theta = 1.0 + v_sel * jnp.log(
        u0 + (1.0 - u0) * jnp.exp(-2.0 / jnp.maximum(v_sel, 1e-6)))
    sin_theta = safe_sqrt(1.0 - sqr(cos_theta))
    u1 = jnp.clip(u2[..., 0], 1e-5, 1.0 - 1e-5)
    cos_phi_m = jnp.cos(2.0 * np.pi * u1)
    sin_ti = -cos_theta * so_t + sin_theta * cos_phi_m * co_t
    cos_ti = safe_sqrt(1.0 - sqr(sin_ti))
    # azimuth
    u_phi = jnp.clip(u2[..., 1], 1e-5, 1.0 - 1e-5)
    dphi_log = _sample_trimmed_logistic(u_phi, s_az, -np.pi, np.pi)
    phi_i = jnp.zeros_like(sin_to)
    for lb in range(4):
        m = lobe == lb
        if lb < _P_MAX:
            phi_i = jnp.where(m, phi_o + _phi_p(lb, gamma_o, gamma_t)
                              + dphi_log, phi_i)
        else:
            phi_i = jnp.where(m, phi_o + 2.0 * np.pi * u_phi, phi_i)
    wi = jnp.stack([sin_ti, cos_ti * jnp.cos(phi_i),
                    cos_ti * jnp.sin(phi_i)], -1)
    f, pdf = _hair_f_pdf(p, wo, wi)
    return wi, f, pdf




# ---------------------------------------------------------------------------
# Measured BRDF (reference MeasuredBxDF, bxdfs.h:1022). The reference uses
# the Dupuy-Jakob adaptive parameterization from .bsdf captures; this build
# stores measured data in the classic MERL/Rusinkiewicz half/difference
# grid (90 x 90 x 180 in (theta_h, theta_d, phi_d)) — the dominant public
# measured-BRDF corpus — as sigmoid-coefficient texels evaluated spectrally.
# Sampling uses the cosine hemisphere with exact pdfs (unbiased; the
# reference fits a dedicated sampling distribution, a variance-only
# difference).

def _rusink_coords(wo, wi):
    """(theta_h, theta_d, phi_d) of a direction pair in the local frame."""
    h = vm.normalize(wo + wi)
    theta_h = jnp.arccos(jnp.clip(h[..., 2], -1.0, 1.0))
    phi_h = jnp.arctan2(h[..., 1], h[..., 0])
    # rotate wi into the half-vector frame: R_y(-theta_h) R_z(-phi_h) wi
    cp, sp = jnp.cos(-phi_h), jnp.sin(-phi_h)
    x1 = cp * wi[..., 0] - sp * wi[..., 1]
    y1 = sp * wi[..., 0] + cp * wi[..., 1]
    z1 = wi[..., 2]
    ct, st = jnp.cos(-theta_h), jnp.sin(-theta_h)
    x2 = ct * x1 + st * z1
    z2 = -st * x1 + ct * z1
    d = jnp.stack([x2, y1, z2], -1)
    theta_d = jnp.arccos(jnp.clip(d[..., 2], -1.0, 1.0))
    phi_d = jnp.arctan2(d[..., 1], d[..., 0])
    phi_d = jnp.where(phi_d < 0, phi_d + np.pi, phi_d)  # reciprocity fold
    return theta_h, theta_d, phi_d


def _measured_f_pdf(p: BSDFParams, wo, wi):
    """Registry shim: spectral table eval + cosine-hemisphere pdf. The
    wavelengths ride in p.k[..., :4] (stashed by get_bsdf_params)."""
    f = measured_f(p.measured_table, wo, wi, p.k)
    same = vm.same_hemisphere(wo, wi)
    pdf = jnp.where(same, sp.cosine_hemisphere_pdf(vm.abs_cos_theta(wi)),
                    0.0)
    return f, pdf


def measured_f(table, wo, wi, lam):
    """Evaluate a measured BRDF table at (wo, wi) spectrally.

    table: (Nh*Nd*Np, 4) [sigmoid coeffs, scale] + static dims in
    MEASURED_DIMS; returns (N, 4)."""
    from .utils import color as pcolor
    Nh, Nd, Np_ = MEASURED_DIMS
    th, td, pd = _rusink_coords(wo, wi)
    # MERL's theta_h axis is warped: bin = sqrt(th / (pi/2)) * Nh
    ih = jnp.clip((jnp.sqrt(jnp.maximum(th, 0.0) / (np.pi / 2)) *
                   Nh).astype(jnp.int32), 0, Nh - 1)
    i_d = jnp.clip((td / (np.pi / 2) * Nd).astype(jnp.int32), 0, Nd - 1)
    ip = jnp.clip((pd / np.pi * Np_).astype(jnp.int32), 0, Np_ - 1)
    idx = (ih * Nd + i_d) * Np_ + ip
    rows = table[idx]                       # one gather (N, 4)
    refl = pcolor.eval_rgb_sigmoid_polynomial(rows[..., 0:3], lam)
    f = refl * rows[..., 3:4]
    same = vm.same_hemisphere(wo, wi)
    return jnp.where(same[..., None], f, 0.0)


MEASURED_DIMS = (90, 90, 180)


def fresnel_moment1(eta):
    """First moment of the Fresnel reflectance (reference FresnelMoment1,
    bssrdf.cpp polynomial fits)."""
    eta2 = eta * eta
    eta3 = eta2 * eta
    eta4 = eta3 * eta
    eta5 = eta4 * eta
    lo = (0.45966 - 1.73965 * eta + 3.37668 * eta2 - 3.904945 * eta3
          + 2.49277 * eta4 - 0.68441 * eta5)
    hi = (-4.61686 + 11.1136 * eta - 10.4646 * eta2 + 5.11455 * eta3
          - 1.27198 * eta4 + 0.12746 * eta5)
    return jnp.where(eta < 1.0, lo, hi)


_F_PDF_FNS = {
    BXDF_DIFFUSE: _diffuse_f_pdf,
    BXDF_CONDUCTOR: _conductor_f_pdf,
    BXDF_DIELECTRIC: _dielectric_f_pdf,
    BXDF_DIFFUSE_TRANSMISSION: _diffuse_transmission_f_pdf,
    BXDF_COATED_DIFFUSE: _coated_diffuse_f_pdf,
    BXDF_COATED_CONDUCTOR: _coated_conductor_f_pdf,
    BXDF_HAIR: _hair_f_pdf,
    BXDF_MEASURED: _measured_f_pdf,
}


# (THIN_DIELECTRIC is specular-only: f == 0, no entry above)


def _present(p: BSDFParams):
    if p.tags_present is not None:
        tags = p.tags_present
    else:
        tags = (BXDF_DIFFUSE, BXDF_CONDUCTOR, BXDF_DIELECTRIC,
                BXDF_THIN_DIELECTRIC, BXDF_DIFFUSE_TRANSMISSION,
                BXDF_COATED_DIFFUSE, BXDF_COATED_CONDUCTOR, BXDF_HAIR,
                BXDF_MEASURED)
    if p.measured_table is None:
        tags = tuple(t for t in tags if t != BXDF_MEASURED)
    return tags


def _call_f_pdf(t, p, wo, wi, adjoint):
    if t == BXDF_DIELECTRIC:
        return _dielectric_f_pdf(p, wo, wi, adjoint=adjoint)
    return _F_PDF_FNS[t](p, wo, wi)


def bsdf_f(p: BSDFParams, wo, wi, adjoint=False):
    """f(wo, wi) for non-specular lobes, dispatched on tag. (N, 4).

    Only branches for BxDF types present in the scene's material pool are
    traced (p.tags_present, a static scene constant). adjoint: importance
    transport — see _dielectric_f_pdf."""
    present = [t for t in _present(p) if t in _F_PDF_FNS]
    if len(present) == 1:
        return _call_f_pdf(present[0], p, wo, wi, adjoint)[0]
    f = jnp.zeros_like(p.albedo)
    tag = p.tag[..., None]
    for t in present:
        ft, _ = _call_f_pdf(t, p, wo, wi, adjoint)
        f = jnp.where(tag == t, ft, f)
    return f


def bsdf_pdf(p: BSDFParams, wo, wi):
    present = [t for t in _present(p) if t in _F_PDF_FNS]
    if len(present) == 1:
        return _F_PDF_FNS[present[0]](p, wo, wi)[1]
    pdf = jnp.zeros(p.alpha_x.shape, jnp.float32)
    for t in present:
        _, pt = _F_PDF_FNS[t](p, wo, wi)
        pdf = jnp.where(p.tag == t, pt, pdf)
    return pdf


def bsdf_sample(p: BSDFParams, wo, uc, u2, adjoint=False):
    """Sample wi ~ the BSDF. Returns dict(wi, f, pdf, specular, transmission,
    eta_scale) — eta_scale is eta^2 relative IOR scaling for RR (reference
    PathIntegrator etaScale, integrators.cpp:749). adjoint: importance
    transport (light subpaths) — dielectric transmission skips the
    1/etap^2 radiance-compression factor (see _dielectric_f_pdf).

    Only branches for BxDF types in p.tags_present (a static scene
    constant) are traced — the array analog of the reference wavefront's
    per-material kernel specialization (wavefront/integrator.h:139)."""
    present = _present(p)
    single = len(present) == 1
    smooth = tr_effectively_smooth(p.alpha_x, p.alpha_y)
    tag = p.tag
    tag3 = tag[..., None]

    # accumulators (filled per present branch)
    wi = jnp.zeros_like(wo)
    f = jnp.zeros_like(p.albedo)
    pdf = jnp.zeros(p.alpha_x.shape, jnp.float32)
    specular = jnp.zeros(p.alpha_x.shape, bool)
    transmission = jnp.zeros(p.alpha_x.shape, bool)
    eta_scale = jnp.ones(p.alpha_x.shape, jnp.float32)
    dispersed = jnp.zeros(p.alpha_x.shape, bool)

    def sel(tagv, wi_b, f_b, pdf_b, spec_b, trans_b, etas_b, disp_b):
        nonlocal wi, f, pdf, specular, transmission, eta_scale, dispersed
        to_b = lambda v: jnp.broadcast_to(jnp.asarray(v), p.alpha_x.shape)
        if single:
            wi, f, pdf = wi_b, f_b, pdf_b
            specular, transmission = to_b(spec_b), to_b(trans_b)
            eta_scale = to_b(etas_b).astype(jnp.float32)
            dispersed = to_b(disp_b)
            return
        m = tag == tagv
        m3 = m[..., None]
        wi = jnp.where(m3, wi_b, wi)
        f = jnp.where(m3, f_b, f)
        pdf = jnp.where(m, pdf_b, pdf)
        specular = jnp.where(m, spec_b, specular)
        transmission = jnp.where(m, trans_b, transmission)
        eta_scale = jnp.where(m, etas_b, eta_scale)
        dispersed = jnp.where(m, disp_b, dispersed)

    # shared: cosine-hemisphere direction for the diffuse-family lobes
    if (BXDF_DIFFUSE in present or BXDF_DIFFUSE_TRANSMISSION in present
            or BXDF_COATED_DIFFUSE in present):
        wi_d = sp.sample_cosine_hemisphere(u2)
        wi_d = jnp.where((wo[..., 2] < 0)[..., None],
                         jnp.concatenate([wi_d[..., :2], -wi_d[..., 2:]], -1),
                         wi_d)

    if BXDF_DIFFUSE in present:
        f_d, pdf_d = _diffuse_f_pdf(p, wo, wi_d)
        sel(BXDF_DIFFUSE, wi_d, f_d, pdf_d, False, False, 1.0, False)

    if BXDF_DIFFUSE_TRANSMISSION in present:
        pr_dt = jnp.max(p.albedo, axis=-1)
        pt_dt = jnp.max(p.k, axis=-1)
        tot_dt = jnp.maximum(pr_dt + pt_dt, 1e-9)
        choose_t = uc < pt_dt / tot_dt
        wi_dt = jnp.where(
            (choose_t ^ (wo[..., 2] < 0))[..., None],
            jnp.concatenate([wi_d[..., :2], -jnp.abs(wi_d[..., 2:])], -1),
            jnp.concatenate([wi_d[..., :2], jnp.abs(wi_d[..., 2:])], -1))
        f_dt, pdf_dt = _diffuse_transmission_f_pdf(p, wo, wi_dt)
        sel(BXDF_DIFFUSE_TRANSMISSION, wi_dt, f_dt, pdf_dt, False, choose_t,
            1.0, False)

    # shared: rough-conductor VNDF sample (conductor + coated-conductor)
    if BXDF_CONDUCTOR in present or BXDF_COATED_CONDUCTOR in present:
        wm_c = tr_sample_wm(wo, u2, p.alpha_x, p.alpha_y)
        wi_cr = vm.reflect(wo, wm_c)

    if BXDF_CONDUCTOR in present:
        # smooth: perfect mirror
        wi_cs = jnp.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]], -1)
        F_cs = fr_complex(vm.abs_cos_theta(wo)[..., None], p.eta, p.k)
        f_cs = safe_div(F_cs, vm.abs_cos_theta(wi_cs)[..., None])
        f_cr, pdf_cr = _conductor_f_pdf(p, wo, wi_cr)
        wi_c = jnp.where(smooth[..., None], wi_cs, wi_cr)
        f_c = jnp.where(smooth[..., None], f_cs, f_cr)
        pdf_c = jnp.where(smooth, 1.0, pdf_cr)
        sel(BXDF_CONDUCTOR, wi_c, f_c, pdf_c, smooth, False, 1.0, False)

    eta_s = p.eta[..., 0]

    if BXDF_DIELECTRIC in present:
        # smooth case
        F_ds = fr_dielectric(vm.cos_theta(wo), eta_s)
        refl_ds = uc < F_ds
        wi_ds_r = jnp.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]], -1)
        ok_t, wi_ds_t, etap_s = vm.refract(wo, jnp.broadcast_to(
            jnp.asarray([0.0, 0.0, 1.0], jnp.float32), wo.shape), eta_s)
        wi_ds = jnp.where(refl_ds[..., None], wi_ds_r, wi_ds_t)
        f_ds_r = safe_div(F_ds, vm.abs_cos_theta(wi_ds_r))
        f_ds_t = safe_div((1.0 - F_ds) if adjoint
                          else (1.0 - F_ds) / sqr(etap_s),
                          vm.abs_cos_theta(wi_ds_t))
        f_ds = jnp.where(refl_ds, f_ds_r, jnp.where(ok_t, f_ds_t, 0.0))
        pdf_ds = jnp.where(refl_ds, F_ds, jnp.where(ok_t, 1.0 - F_ds, 1.0))
        # rough case
        wm_g = tr_sample_wm(wo, u2, p.alpha_x, p.alpha_y)
        F_dr = fr_dielectric(vm.dot(wo, wm_g), eta_s)
        refl_dr = uc < F_dr
        wi_dr_r = vm.reflect(wo, wm_g)
        ok_rt, wi_dr_t, _ = vm.refract(wo, wm_g, eta_s)
        wi_dr = jnp.where(refl_dr[..., None], wi_dr_r, wi_dr_t)
        # reject lobe/hemisphere mismatches (reference
        # DielectricBxDF::Sample_f: reflected wi must stay in wo's
        # hemisphere, transmitted must cross; keeping strays would price
        # them with the other lobe's pdf)
        same_h = vm.same_hemisphere(wo, wi_dr)
        lobe_ok = jnp.where(refl_dr, same_h, ~same_h & ok_rt)
        f_dr, pdf_dr = _dielectric_f_pdf(p, wo, wi_dr, adjoint=adjoint)
        pdf_dr = jnp.where(lobe_ok, pdf_dr, 0.0)
        f_dr = jnp.where(lobe_ok[..., None], f_dr, 0.0)
        wi_g = jnp.where(smooth[..., None], wi_ds, wi_dr)
        pdf_g = jnp.where(smooth, pdf_ds, pdf_dr)
        f_g = jnp.where(smooth[..., None],
                        f_ds[..., None] * jnp.ones_like(p.albedo), f_dr)
        trans_g = jnp.where(smooth, refl_ds == False, refl_dr == False)  # noqa: E712
        eta_scale_g = jnp.where(
            trans_g, sqr(jnp.where(vm.cos_theta(wo) > 0, eta_s, 1.0 / eta_s)),
            1.0)
        # dispersion: spectral eta + transmission -> the path follows the
        # hero wavelength; the integrator terminates secondary wavelengths
        # (reference DielectricBxDF::Sample_f -> SampledWavelengths::
        # TerminateSecondary, spectrum.h)
        dispersive_g = trans_g & (jnp.max(p.eta, -1) - jnp.min(p.eta, -1)
                                  > 1e-4)
        sel(BXDF_DIELECTRIC, wi_g, f_g, pdf_g, smooth, trans_g, eta_scale_g,
            dispersive_g)

    if BXDF_COATED_DIFFUSE in present:
        # Fresnel-blend; see _coated_diffuse_f_pdf
        eta_cd = p.eta[..., 0]
        F_cd = fr_dielectric(vm.abs_cos_theta(wo), eta_cd)
        choose_spec = uc < F_cd
        wm_cd = tr_sample_wm(wo, u2, p.alpha_x, p.alpha_y)
        wi_cd_spec = vm.reflect(wo, wm_cd)
        wi_cd_diff = jnp.where(
            (wo[..., 2] < 0)[..., None],
            jnp.concatenate([wi_d[..., :2], -jnp.abs(wi_d[..., 2:])], -1),
            jnp.concatenate([wi_d[..., :2], jnp.abs(wi_d[..., 2:])], -1))
        wi_cd = jnp.where(choose_spec[..., None], wi_cd_spec, wi_cd_diff)
        f_cd, pdf_cd = _coated_diffuse_f_pdf(p, wo, wi_cd)
        sel(BXDF_COATED_DIFFUSE, wi_cd, f_cd, pdf_cd, False, False, 1.0,
            False)

    if BXDF_COATED_CONDUCTOR in present:
        # see _coated_conductor_f_pdf
        ca_cc, ce_cc = _coat_params(p)
        F_cc = fr_dielectric(vm.abs_cos_theta(wo), ce_cc)
        choose_coat = uc < F_cc
        wm_cc = tr_sample_wm(wo, u2, ca_cc, ca_cc)
        wi_cc_coat = vm.reflect(wo, wm_cc)
        wi_cc = jnp.where(choose_coat[..., None], wi_cc_coat, wi_cr)
        f_cc, pdf_cc = _coated_conductor_f_pdf(p, wo, wi_cc)
        sel(BXDF_COATED_CONDUCTOR, wi_cc, f_cc, pdf_cc, False, False, 1.0,
            False)

    if BXDF_HAIR in present:
        wi_h, f_h, pdf_h = _hair_sample(p, wo, uc, u2)
        sel(BXDF_HAIR, wi_h, f_h, pdf_h, False, False, 1.0, False)

    if BXDF_MEASURED in present:
        wi_m = sp.sample_cosine_hemisphere(u2)
        wi_m = jnp.where((wo[..., 2] < 0)[..., None],
                         jnp.concatenate([wi_m[..., :2], -wi_m[..., 2:]],
                                         -1), wi_m)
        f_m, pdf_m = _measured_f_pdf(p, wo, wi_m)
        sel(BXDF_MEASURED, wi_m, f_m, pdf_m, False, False, 1.0, False)

    if BXDF_THIN_DIELECTRIC in present:
        # reference ThinDielectricBxDF, bxdfs.h:209
        R0 = fr_dielectric(vm.abs_cos_theta(wo), eta_s)
        R_th = jnp.where(R0 < 1.0,
                         R0 + sqr(1.0 - R0) * R0 / (1.0 - sqr(R0)), 1.0)
        T_th = 1.0 - R_th
        refl_th = uc < R_th
        wi_th = jnp.where(
            refl_th[..., None],
            jnp.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]], -1), -wo)
        f_th = jnp.where(refl_th, safe_div(R_th, vm.abs_cos_theta(wo)),
                         safe_div(T_th, vm.abs_cos_theta(wo)))
        pdf_th = jnp.where(refl_th, R_th, T_th)
        sel(BXDF_THIN_DIELECTRIC, wi_th,
            f_th[..., None] * jnp.ones_like(p.albedo), pdf_th,
            True, ~refl_th, 1.0, False)

    valid = pdf > 0
    return dict(wi=wi, f=f, pdf=jnp.maximum(pdf, 0.0), valid=valid,
                specular=specular, transmission=transmission,
                eta_scale=eta_scale, dispersed=dispersed)


def bsdf_flags(p: BSDFParams):
    smooth = tr_effectively_smooth(p.alpha_x, p.alpha_y)
    spec = ((p.tag == BXDF_CONDUCTOR) & smooth) | \
           ((p.tag == BXDF_DIELECTRIC) & smooth) | \
           (p.tag == BXDF_THIN_DIELECTRIC)
    return dict(specular=spec)
