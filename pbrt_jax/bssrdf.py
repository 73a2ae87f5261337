"""Tabulated BSSRDF: photon-beam-diffusion profile tables (reference
bssrdf.cpp:26-128 BeamDiffusionMS/SS + ComputeBeamDiffusionBSSRDF,
bssrdf.h:74 BSSRDFTable, :280 SubsurfaceFromDiffuse).

Host side (numpy, vectorized over the whole (rho, radius, depth-sample)
grid instead of the reference's scalar loops): the classical dipole with
Grosjean's non-classical diffusion coefficient + exitance-corrected
fluence (Habel et al. 2013 PBD), plus the single-scattering integral.
Profiles are tabulated in OPTICAL units (sigma_t = 1): profile[i, j] =
2*pi*r_j * Sr(rho_i, r_j).

Device side: piecewise-LINEAR interpolation of the profile and its
radial CDF (the reference uses Catmull-Rom; linear on the same 64-point
log-spaced radius grid is self-consistent between eval, integral and
sampling, and keeps the device side at two small gathers).
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp
from .utils import struct


# --------------------------------------------------------------------- host

def fresnel_moment1(eta):
    """First Fresnel reflectance moment (reference bxdfs.cpp
    FresnelMoment1 polynomial fit)."""
    eta = np.asarray(eta, np.float64)
    e2, e3, e4, e5 = eta**2, eta**3, eta**4, eta**5
    return np.where(
        eta < 1,
        0.45966 - 1.73965 * eta + 3.37668 * e2 - 3.904945 * e3 +
        2.49277 * e4 - 0.68441 * e5,
        -4.61686 + 11.1136 * eta - 10.4646 * e2 + 5.11455 * e3 -
        1.27198 * e4 + 0.12746 * e5)


def fresnel_moment2(eta):
    """Second Fresnel reflectance moment (reference bxdfs.cpp
    FresnelMoment2 polynomial fit)."""
    eta = np.asarray(eta, np.float64)
    e2, e3, e4, e5 = eta**2, eta**3, eta**4, eta**5
    lo = (0.27614 - 0.87350 * eta + 1.12077 * e2 - 0.65095 * e3 -
          0.07883 * e4 + 0.04860 * e5)
    r_1 = -547.033 + 45.3087 / e3 - 218.725 / e2 + 458.843 / eta + \
        404.557 * eta - 189.519 * e2 + 54.9327 * e3 - 9.00603 * e4 + \
        0.63942 * e5
    return np.where(eta < 1, lo, r_1)


def _fr_dielectric(cos_i, eta):
    """Exact unpolarized Fresnel (host)."""
    cos_i = np.clip(cos_i, -1, 1)
    eta = np.where(cos_i < 0, 1.0 / eta, eta)
    cos_i = np.abs(cos_i)
    sin2_t = (1 - cos_i**2) / eta**2
    tir = sin2_t >= 1
    cos_t = np.sqrt(np.maximum(1 - sin2_t, 0))
    r_par = (eta * cos_i - cos_t) / (eta * cos_i + cos_t)
    r_perp = (cos_i - eta * cos_t) / (cos_i + eta * cos_t)
    return np.where(tir, 1.0, 0.5 * (r_par**2 + r_perp**2))


def beam_diffusion_ms(sigma_s, sigma_a, g, eta, r, n_samples=100):
    """Multiple-scattering PBD term (reference bssrdf.cpp:26-77).
    sigma_s/sigma_a/r broadcast together; returns same shape."""
    sigma_s = np.asarray(sigma_s, np.float64)
    sigma_a = np.asarray(sigma_a, np.float64)
    r = np.asarray(r, np.float64)
    sigmap_s = sigma_s * (1 - g)
    sigmap_t = sigma_a + sigmap_s
    rhop = sigmap_s / sigmap_t
    # Grosjean non-classical diffusion coefficient
    d_g = (2 * sigma_a + sigmap_s) / (3 * sigmap_t**2)
    sigma_tr = np.sqrt(np.maximum(sigma_a / d_g, 0))
    fm1 = fresnel_moment1(eta)
    fm2 = fresnel_moment2(eta)
    ze = -2 * d_g * (1 + 3 * fm2) / (1 - 2 * fm1)
    c_phi = 0.25 * (1 - 2 * fm1)
    c_e = 0.5 * (1 - 3 * fm2)
    # exponential depth samples of the real source (stratified midpoints)
    u = (np.arange(n_samples) + 0.5) / n_samples
    zr = -np.log(1 - u) / sigmap_t[..., None]            # (..., S)
    zv = -zr + 2 * ze[..., None]
    rr = r[..., None]
    dr = np.sqrt(rr**2 + zr**2)
    dv = np.sqrt(rr**2 + zv**2)
    inv4pi = 1.0 / (4 * np.pi)
    phi_d = inv4pi / d_g[..., None] * (np.exp(-sigma_tr[..., None] * dr) / dr
                                       - np.exp(-sigma_tr[..., None] * dv)
                                       / dv)
    edn = inv4pi * (zr * (1 + sigma_tr[..., None] * dr) *
                    np.exp(-sigma_tr[..., None] * dr) / dr**3 -
                    zv * (1 + sigma_tr[..., None] * dv) *
                    np.exp(-sigma_tr[..., None] * dv) / dv**3)
    e_total = phi_d * c_phi + edn * c_e
    kappa = 1 - np.exp(-2 * sigmap_t[..., None] * (dr + zr))
    return np.mean(kappa * rhop[..., None]**2 * e_total, axis=-1)


def beam_diffusion_ss(sigma_s, sigma_a, g, eta, r, n_samples=100):
    """Single-scattering term (reference bssrdf.cpp:79-98)."""
    sigma_s = np.asarray(sigma_s, np.float64)
    sigma_a = np.asarray(sigma_a, np.float64)
    r = np.asarray(r, np.float64)
    sigma_t = sigma_a + sigma_s
    rho = sigma_s / sigma_t
    t_crit = r * np.sqrt(np.maximum(eta**2 - 1, 0))
    u = (np.arange(n_samples) + 0.5) / n_samples
    ti = t_crit[..., None] - np.log(1 - u) / sigma_t[..., None]
    rr = r[..., None]
    d = np.sqrt(rr**2 + ti**2)
    cos_o = ti / d
    # Henyey-Greenstein phase
    denom = 1 + g * g + 2 * g * cos_o
    hg = (1 - g * g) / (4 * np.pi * denom * np.sqrt(np.maximum(denom,
                                                               1e-12)))
    fr = _fr_dielectric(-cos_o, eta)
    ess = rho[..., None] * np.exp(-sigma_t[..., None] *
                                  (d + t_crit[..., None])) / d**2 * \
        hg * (1 - fr) * np.abs(cos_o)
    return np.mean(ess, axis=-1)


@struct.dataclass
class BSSRDFTable:
    rho: jnp.ndarray        # (R,) albedo samples
    radius: jnp.ndarray     # (J,) optical radius samples (log-spaced)
    profile: jnp.ndarray    # (R, J): 2*pi*r*Sr in optical units
    rho_eff: jnp.ndarray    # (R,) integral of each profile row
    cdf: jnp.ndarray        # (R, J): radial CDF in [0, 1]
    eta: float = struct.field(pytree_node=False, default=1.33)
    g: float = struct.field(pytree_node=False, default=0.0)


def compute_table(g=0.0, eta=1.33, n_rho=64, n_radius=64) -> BSSRDFTable:
    """Tabulate the beam-diffusion profile (reference
    ComputeBeamDiffusionBSSRDF, bssrdf.cpp:101-128)."""
    radius = np.empty(n_radius)
    radius[0] = 0.0
    radius[1] = 2.5e-3
    for i in range(2, n_radius):
        radius[i] = radius[i - 1] * 1.2
    i = np.arange(n_rho)
    rho = (1 - np.exp(-8 * i / (n_rho - 1))) / (1 - np.exp(-8.0))

    rr, rj = np.meshgrid(rho, radius, indexing="ij")     # (R, J)
    prof = 2 * np.pi * rj * (
        beam_diffusion_ss(rr, 1 - rr, g, eta, rj) +
        beam_diffusion_ms(rr, 1 - rr, g, eta, rj))
    # piecewise-linear radial integral + CDF (self-consistent with the
    # device's linear interpolation)
    seg = 0.5 * (prof[:, 1:] + prof[:, :-1]) * np.diff(radius)[None, :]
    cdf = np.concatenate([np.zeros((n_rho, 1)), np.cumsum(seg, axis=1)],
                         axis=1)
    rho_eff = cdf[:, -1].copy()
    cdf = cdf / np.maximum(rho_eff[:, None], 1e-12)
    return BSSRDFTable(rho=jnp.asarray(rho, jnp.float32),
                       radius=jnp.asarray(radius, jnp.float32),
                       profile=jnp.asarray(prof, jnp.float32),
                       rho_eff=jnp.asarray(rho_eff, jnp.float32),
                       cdf=jnp.asarray(cdf, jnp.float32),
                       eta=float(eta), g=float(g))


def subsurface_from_diffuse(table: BSSRDFTable, reflectance, mfp):
    """Invert the table: (diffuse surface reflectance, mean free path) ->
    (sigma_a, sigma_s) per channel (reference SubsurfaceFromDiffuse,
    bssrdf.cpp:280; InvertCatmullRom role played by monotone interp)."""
    rho_eff = np.asarray(table.rho_eff, np.float64)
    rho_s = np.asarray(table.rho, np.float64)
    refl = np.clip(np.asarray(reflectance, np.float64), 0.0,
                   float(rho_eff.max()) - 1e-6)
    rho = np.interp(refl, rho_eff, rho_s)
    mfp = np.asarray(mfp, np.float64)
    sigma_t = 1.0 / np.maximum(mfp, 1e-9)
    return ((1 - rho) * sigma_t).astype(np.float32), \
        (rho * sigma_t).astype(np.float32)


# ------------------------------------------------------------------- device

def _row_weights(table: BSSRDFTable, rho):
    """Nearest-below row index + linear weight for rho (N,)."""
    idx = jnp.clip(jnp.searchsorted(table.rho, rho, side="right") - 1,
                   0, table.rho.shape[0] - 2)
    r0 = table.rho[idx]
    r1 = table.rho[idx + 1]
    w = jnp.clip((rho - r0) / jnp.maximum(r1 - r0, 1e-9), 0.0, 1.0)
    return idx, w


def radial_profile_pdf(table: BSSRDFTable, rho, sigma_t, r_world):
    """Radial throughput density Q_l(r) = Sp_l(r) * 2*pi*r and the
    4-channel-mixture radial sampling pdf at world radius r.

    rho, sigma_t: (N, 4) per-wavelength; r_world: (N,).
    Q_l = profile_l(rho_l, sigma_t_l * r) * sigma_t_l (world radial units;
    Sp itself is profile/(2 pi r_opt) * sigma_t^2, bssrdf.h:130);
    pdf = mean_l Q_l / rho_eff_l — each channel's normalized radial
    density, uniform channel mixture (bssrdf.h:199 ChannelMIS role).
    Returns (Q (N, 4), pdf (N,), rho_eff (N, 4))."""
    r_opt = r_world[..., None] * sigma_t                      # (N, 4)
    J = table.radius.shape[0]
    j = jnp.clip(jnp.searchsorted(table.radius, r_opt, side="right") - 1,
                 0, J - 2)
    x0 = table.radius[j]
    x1 = table.radius[j + 1]
    tw = jnp.clip((r_opt - x0) / jnp.maximum(x1 - x0, 1e-12), 0.0, 1.0)
    i, w = _row_weights(table, rho)

    def prof_at(ii):
        p0 = table.profile[ii, j]
        p1 = table.profile[ii, j + 1]
        return p0 * (1 - tw) + p1 * tw

    prof = prof_at(i) * (1 - w) + prof_at(i + 1) * w          # 2 pi r Sr
    prof = jnp.where(r_opt >= table.radius[-1], 0.0, prof)
    rho_eff = table.rho_eff[i] * (1 - w) + table.rho_eff[i + 1] * w
    q = prof * sigma_t                                 # per unit WORLD r
    pdf = jnp.mean(q / jnp.maximum(rho_eff, 1e-9), axis=-1)
    return q, pdf, rho_eff


def sample_r(table: BSSRDFTable, rho_c, sigma_t_c, u):
    """Sample a WORLD radius from the tabulated radial CDF of the chosen
    channel (rho_c, sigma_t_c: (N,)); reference SampleCatmullRom2D role.
    Returns (r_world (N,), r_max_world (N,))."""
    i, w = _row_weights(table, rho_c)
    cdf = table.cdf[i] * (1 - w[..., None]) + \
        table.cdf[i + 1] * w[..., None]                       # (N, J)
    j = jnp.clip((cdf < u[..., None]).sum(axis=-1) - 1, 0,
                 table.radius.shape[0] - 2)
    take = lambda a, jj: jnp.take_along_axis(a, jj[..., None], -1)[..., 0]
    c0 = take(cdf, j)
    c1 = take(cdf, j + 1)
    x0 = table.radius[j]
    x1 = table.radius[j + 1]
    t = jnp.clip((u - c0) / jnp.maximum(c1 - c0, 1e-9), 0.0, 1.0)
    r_opt = x0 + t * (x1 - x0)
    inv_st = 1.0 / jnp.maximum(sigma_t_c, 1e-9)
    return r_opt * inv_st, table.radius[-1] * inv_st


# Measured subsurface scattering presets (sigma_prime_s, sigma_a in mm^-1):
# Jensen, Marschner, Levoy, Hanrahan, "A Practical Model for Subsurface
# Light Transport", SIGGRAPH 2001 (public dataset; the reference embeds the
# same values in media.cpp:86-97 GetMediumScatteringProperties).
SCATTERING_PRESETS = {
    "Apple":     ((2.29, 2.39, 1.97), (0.0030, 0.0034, 0.046)),
    "Chicken1":  ((0.15, 0.21, 0.38), (0.015, 0.077, 0.19)),
    "Chicken2":  ((0.19, 0.25, 0.32), (0.018, 0.088, 0.20)),
    "Cream":     ((7.38, 5.47, 3.15), (0.0002, 0.0028, 0.0163)),
    "Ketchup":   ((0.18, 0.07, 0.03), (0.061, 0.97, 1.45)),
    "Marble":    ((2.19, 2.62, 3.00), (0.0021, 0.0041, 0.0071)),
    "Potato":    ((0.68, 0.70, 0.55), (0.0024, 0.0090, 0.12)),
    "Skimmilk":  ((0.70, 1.22, 1.90), (0.0014, 0.0025, 0.0142)),
    "Skin1":     ((0.74, 0.88, 1.01), (0.032, 0.17, 0.48)),
    "Skin2":     ((1.09, 1.59, 1.79), (0.013, 0.070, 0.145)),
    "Spectralon": ((11.6, 20.4, 14.9), (0.00, 0.00, 0.00)),
    "Wholemilk": ((2.55, 3.21, 3.77), (0.0011, 0.0024, 0.014)),
}


def get_scattering_preset(name, scale=1.0):
    """(sigma_a, sigma_s_prime) for a named measured material, scaled
    (reference GetMediumScatteringProperties, media.cpp:79)."""
    if name not in SCATTERING_PRESETS:
        return None
    sps, sa = SCATTERING_PRESETS[name]
    return (np.asarray(sa, np.float32) * scale,
            np.asarray(sps, np.float32) * scale)
