"""Material pool (reference materials.{h,cpp}; closed world base/material.h:22).

Round-1 material set: Diffuse, Conductor, Dielectric, ThinDielectric,
DiffuseTransmission — each bound to constant or (later) image textures.
Materials are compiled into an SoA pool; `get_bsdf` evaluates textures at the
hit and returns per-lane BSDFParams for the bxdfs module (the analogue of
the reference's Material::GetBxDF texture-evaluator dispatch,
surfscatter.cpp:39).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
from .utils import struct

from . import bxdfs
from .utils import color as pcolor
from .utils import spectrum as spc


# tag value for the Mix MATERIAL (resolved to a concrete sub-material at
# shading time; all other tags are BxDF tags from bxdfs.py)
MTL_MIX = 64


@struct.dataclass
class MaterialPool:
    """Packed material rows: one gather per shading lookup (see
    ops/gather.py).

    packed columns: [bits(tag), albedo_coeffs(3), trans_coeffs(3), ur, vr,
                     eta_const, bits(eta_spec_idx), bits(k_spec_idx),
                     bits(albedo_tex), remap,
                     bits(rough_tex), bits(bump_tex), bump_scale,
                     bits(normal_tex), bits(mix_other), mix_amount,
                     coat_alpha, coat_eta] = 22
    """
    packed: jnp.ndarray         # (M, 22) f32
    has_spectral_eta: bool = struct.field(pytree_node=False, default=False)
    has_textures: bool = struct.field(pytree_node=False, default=False)
    has_mix: bool = struct.field(pytree_node=False, default=False)
    has_bump: bool = struct.field(pytree_node=False, default=False)
    has_rough_tex: bool = struct.field(pytree_node=False, default=False)
    has_coated_conductor: bool = struct.field(pytree_node=False,
                                              default=False)
    has_subsurface: bool = struct.field(pytree_node=False, default=False)
    # tabulated photon-beam-diffusion BSSRDF (bssrdf.cpp:26-128); None ->
    # the Burley stand-in profile
    sss_table: object = None         # bssrdf.BSSRDFTable | None
    sss_tabulated: bool = struct.field(pytree_node=False, default=False)
    # measured BRDF table ((Nh*Nd*Np, 4) sigmoid coeffs + scale); one
    # shared table per scene (reference MeasuredBxDF data, bxdfs.h:1022)
    measured_table: jnp.ndarray = None
    has_measured: bool = struct.field(pytree_node=False, default=False)
    # static set of BxDF tags in the pool (Mix resolved to sub-materials):
    # bsdf_f/sample compile ONLY these branches (the array analog of the
    # reference wavefront's per-material kernel split, integrator.h:139)
    bxdf_tags_present: tuple = struct.field(pytree_node=False, default=None)


class MaterialBuilder:
    """Host-side accumulation of materials into pool arrays."""

    def __init__(self, colorspace=None):
        self.cs = colorspace or pcolor.srgb()
        self.rows = []
        self._sss_profile = None     # 'burley' | 'tabulated' | None
        self._sss_table = None       # bssrdf.BSSRDFTable (tabulated)

    def _add(self, **kw):
        row = dict(bxdf_tag=bxdfs.BXDF_DIFFUSE,
                   albedo_coeffs=np.zeros(3, np.float32),
                   trans_coeffs=np.zeros(3, np.float32),
                   uroughness=0.0, vroughness=0.0, eta_const=1.5,
                   eta_spec_idx=-1, k_spec_idx=-1, albedo_tex=-1,
                   remap_roughness=True, rough_tex=-1, bump_tex=-1,
                   bump_scale=1.0, normal_tex=-1, mix_other=-1,
                   mix_amount=0.5, coat_alpha=0.0, coat_eta=1.5)
        row.update(kw)
        self.rows.append(row)
        return len(self.rows) - 1

    def add_mix(self, m1: int, m2: int, amount=0.5):
        """Mix material (reference materials.h:272 MixMaterial): picks m1
        with probability `amount`, else m2, stochastically per shading point
        (hash of the hit position, as the reference's wavefront path does).
        Mix-of-mix is not supported."""
        return self._add(bxdf_tag=MTL_MIX, mix_other=m2, mix_amount=amount,
                         albedo_tex=m1)  # albedo_tex slot holds m1

    def add_coated_conductor(self, interface_roughness=0.1, interface_eta=1.5,
                             conductor_roughness=0.1, eta_spec_idx=-1,
                             k_spec_idx=-1, reflectance=None, remap=True):
        """Coated conductor: GGX dielectric coat over a microfacet conductor
        base (reference CoatedConductorBxDF bxdfs.h:1165; Fresnel-blend
        single-scatter approximation — see bxdfs._coated_conductor_f_pdf)."""
        ca = float(np.sqrt(max(interface_roughness, 0.0))) if remap \
            else interface_roughness
        return self._add(
            bxdf_tag=bxdfs.BXDF_COATED_CONDUCTOR,
            eta_spec_idx=eta_spec_idx, k_spec_idx=k_spec_idx,
            uroughness=max(conductor_roughness, 2e-3),
            vroughness=max(conductor_roughness, 2e-3),
            remap_roughness=remap,
            coat_alpha=max(ca, 2e-3), coat_eta=interface_eta,
            albedo_coeffs=(self.cs.to_spectrum_coeffs(np.asarray(reflectance))
                           if reflectance is not None
                           else np.zeros(3, np.float32)))

    def set_bump(self, mat: int, bump_tex: int, scale=1.0):
        """Attach a float height texture for bump mapping (reference
        materials.h:42 NormalBumpEvalContext / BumpMap)."""
        self.rows[mat]["bump_tex"] = bump_tex
        self.rows[mat]["bump_scale"] = scale

    def set_normal_map(self, mat: int, normal_tex: int):
        """Attach a tangent-space RGB normal map (values in [0,1]^3, added
        via TextureBuilder.add_image_raw)."""
        self.rows[mat]["normal_tex"] = normal_tex

    def set_roughness_texture(self, mat: int, rough_tex: int):
        """Attach a float roughness texture (overrides u/v roughness)."""
        self.rows[mat]["rough_tex"] = rough_tex

    def add_measured(self, brdf_rgb):
        """Measured BRDF material (reference \"measured\" / MeasuredBxDF
        bxdfs.h:1022). brdf_rgb: (90, 90, 180, 3) linear-RGB BRDF values on
        the MERL (theta_h^2-warped, theta_d, phi_d) grid — use
        load_merl_brdf() for .binary MERL captures."""
        t = np.asarray(brdf_rgb, np.float32).reshape(-1, 3)
        m = np.maximum(t.max(axis=-1), 1e-9)
        scale = np.where(t.max(axis=-1) > 1.0, 2.0 * m,
                         1.0).astype(np.float32)
        coeffs = self.cs.to_spectrum_coeffs(t / scale[:, None])
        self._measured = np.concatenate([coeffs, scale[:, None]], 1)
        return self._add(bxdf_tag=bxdfs.BXDF_MEASURED,
                         remap_roughness=False)

    def add_subsurface(self, reflectance=(0.8, 0.6, 0.5), mfp=(0.1, 0.1, 0.1),
                       eta=1.33, profile="tabulated", sigma_a=None,
                       sigma_s=None, g=0.0):
        """Subsurface material (reference \"subsurface\" +
        TabulatedBSSRDF, bssrdf.h:105).

        profile=\"tabulated\" (default): photon-beam-diffusion tables
        (bssrdf.cpp:26-128) — (reflectance, mfp) invert to (sigma_a,
        sigma_s) via SubsurfaceFromDiffuse (bssrdf.cpp:280), or pass
        sigma_a/sigma_s directly (measured presets). Row packing: rho(λ)
        rides the albedo slot, sigma_t(λ) the trans slot × scale.

        profile=\"burley\": the Christensen-Burley normalized-diffusion
        stand-in (closed-form Sr, no tables)."""
        if profile == "tabulated":
            from . import bssrdf as bs
            if self._sss_profile == "burley":
                raise ValueError("cannot mix burley and tabulated "
                                 "subsurface materials in one scene")
            self._sss_profile = "tabulated"
            if self._sss_table is None or self._sss_table.eta != eta or \
                    self._sss_table.g != g:
                self._sss_table = bs.compute_table(g=g, eta=eta)
            if sigma_a is not None and sigma_s is not None:
                sa = np.asarray(sigma_a, np.float32)
                ss = np.asarray(sigma_s, np.float32) * (1.0 - g)
            else:
                sa, ss = bs.subsurface_from_diffuse(
                    self._sss_table, np.asarray(reflectance, np.float32),
                    np.asarray(mfp, np.float32))
            st = np.maximum(sa + ss, 1e-6)
            rho = ss / st
            st_max = float(st.max())
            return self._add(bxdf_tag=bxdfs.BXDF_SUBSURFACE,
                             albedo_coeffs=self.cs.to_spectrum_coeffs(
                                 np.clip(rho, 0, 1)),
                             trans_coeffs=self.cs.to_spectrum_coeffs(
                                 st / st_max),
                             mix_amount=st_max,  # sigma_t scale
                             eta_const=eta, remap_roughness=False)
        if self._sss_profile == "tabulated":
            raise ValueError("cannot mix burley and tabulated subsurface "
                             "materials in one scene")
        self._sss_profile = "burley"
        A = np.clip(np.asarray(reflectance, np.float32), 0.0, 1.0)
        # Burley fit: s = 1.85 - A + 7|A - 0.8|^3  (searchlight config)
        s_fit = 1.85 - A + 7.0 * np.abs(A - 0.8) ** 3
        d = np.asarray(mfp, np.float32) / np.maximum(s_fit, 1e-4)
        return self._add(bxdf_tag=bxdfs.BXDF_SUBSURFACE,
                         albedo_coeffs=self.cs.to_spectrum_coeffs(A),
                         trans_coeffs=self.cs.to_spectrum_coeffs(
                             d / max(float(d.max()), 1e-6)),
                         mix_amount=float(d.max()),  # d scale
                         eta_const=eta, remap_roughness=False)

    def add_hair(self, sigma_a=(0.06, 0.1, 0.2), beta_m=0.3, beta_n=0.3,
                 eta=1.55):
        """Hair fiber material (reference HairBxDF bxdfs.h:921 /
        \"hair\" material). sigma_a: absorption per unit width (RGB,
        unbounded); beta_m/beta_n: longitudinal/azimuthal roughness."""
        sa = np.asarray(sigma_a, np.float32)
        m = max(float(sa.max()), 1e-6)
        scale = 2.0 * m if m > 1.0 else 1.0
        return self._add(bxdf_tag=bxdfs.BXDF_HAIR,
                         trans_coeffs=self.cs.to_spectrum_coeffs(sa / scale),
                         mix_amount=scale,
                         uroughness=float(np.clip(beta_m, 1e-3, 1.0)),
                         vroughness=float(np.clip(beta_n, 1e-3, 1.0)),
                         eta_const=eta, remap_roughness=False)

    def add_diffuse(self, reflectance=(0.5, 0.5, 0.5), albedo_tex=-1):
        return self._add(bxdf_tag=bxdfs.BXDF_DIFFUSE,
                         albedo_coeffs=self.cs.to_spectrum_coeffs(np.asarray(reflectance)),
                         albedo_tex=albedo_tex)

    def add_conductor(self, eta_spec_idx=-1, k_spec_idx=-1, roughness=0.0,
                      uroughness=None, vroughness=None, remap=True,
                      reflectance=None):
        return self._add(bxdf_tag=bxdfs.BXDF_CONDUCTOR,
                         eta_spec_idx=eta_spec_idx, k_spec_idx=k_spec_idx,
                         uroughness=roughness if uroughness is None else uroughness,
                         vroughness=roughness if vroughness is None else vroughness,
                         remap_roughness=remap,
                         albedo_coeffs=(self.cs.to_spectrum_coeffs(np.asarray(reflectance))
                                        if reflectance is not None else np.zeros(3, np.float32)))

    def add_dielectric(self, eta=1.5, roughness=0.0, uroughness=None,
                       vroughness=None, remap=True, thin=False,
                       eta_spec_idx=-1):
        """eta_spec_idx: spectrum-pool row of a dispersive IOR curve
        (e.g. glass-BK7); enables hero-wavelength dispersion."""
        return self._add(
            bxdf_tag=bxdfs.BXDF_THIN_DIELECTRIC if thin else bxdfs.BXDF_DIELECTRIC,
            eta_const=eta, eta_spec_idx=eta_spec_idx,
            uroughness=roughness if uroughness is None else uroughness,
            vroughness=roughness if vroughness is None else vroughness,
            remap_roughness=remap)

    def add_coated_diffuse(self, reflectance=(0.5,) * 3, roughness=0.1,
                           eta=1.5, remap=True):
        """Fresnel-blend coat over a diffuse base (reference CoatedDiffuse
        approximated; see bxdfs._coated_diffuse_f_pdf)."""
        return self._add(bxdf_tag=bxdfs.BXDF_COATED_DIFFUSE,
                         albedo_coeffs=self.cs.to_spectrum_coeffs(np.asarray(reflectance)),
                         uroughness=roughness, vroughness=roughness,
                         eta_const=eta, remap_roughness=remap)

    def add_diffuse_transmission(self, reflectance=(0.25,) * 3,
                                 transmittance=(0.25,) * 3):
        return self._add(bxdf_tag=bxdfs.BXDF_DIFFUSE_TRANSMISSION,
                         albedo_coeffs=self.cs.to_spectrum_coeffs(np.asarray(reflectance)),
                         trans_coeffs=self.cs.to_spectrum_coeffs(np.asarray(transmittance)))

    def build(self) -> MaterialPool:
        if not self.rows:
            self.add_diffuse()

        def col(k, dtype=np.float32):
            return np.stack([np.asarray(r[k]) for r in self.rows]).astype(dtype)

        packed = np.concatenate([
            col("bxdf_tag", np.float32)[:, None],         # value-encoded ints
            col("albedo_coeffs").reshape(-1, 3),
            col("trans_coeffs").reshape(-1, 3),
            col("uroughness")[:, None], col("vroughness")[:, None],
            col("eta_const")[:, None],
            col("eta_spec_idx", np.float32)[:, None],
            col("k_spec_idx", np.float32)[:, None],
            col("albedo_tex", np.float32)[:, None],
            col("remap_roughness", np.float32)[:, None],
            col("rough_tex", np.float32)[:, None],
            col("bump_tex", np.float32)[:, None],
            col("bump_scale")[:, None],
            col("normal_tex", np.float32)[:, None],
            col("mix_other", np.float32)[:, None],
            col("mix_amount")[:, None],
            col("coat_alpha")[:, None],
            col("coat_eta")[:, None]], axis=1)
        tags = col("bxdf_tag", np.int32)
        non_mix = tags != MTL_MIX
        return MaterialPool(
            packed=jnp.asarray(packed),
            has_spectral_eta=bool((col("eta_spec_idx", np.int32) >= 0).any() or
                                  (col("k_spec_idx", np.int32) >= 0).any()),
            has_textures=bool(((col("albedo_tex", np.int32) >= 0)
                               & non_mix).any()),
            has_mix=bool((tags == MTL_MIX).any()),
            has_bump=bool((col("bump_tex", np.int32) >= 0).any() or
                          (col("normal_tex", np.int32) >= 0).any()),
            has_rough_tex=bool((col("rough_tex", np.int32) >= 0).any()),
            has_coated_conductor=bool(
                (tags == bxdfs.BXDF_COATED_CONDUCTOR).any()),
            has_subsurface=bool((tags == bxdfs.BXDF_SUBSURFACE).any()),
            sss_table=self._sss_table,
            sss_tabulated=self._sss_profile == "tabulated",
            measured_table=(jnp.asarray(self._measured)
                            if getattr(self, "_measured", None) is not None
                            else None),
            has_measured=bool((tags == bxdfs.BXDF_MEASURED).any()),
            bxdf_tags_present=tuple(sorted(
                set(int(t) for t in tags if t != MTL_MIX)
                # the BSSRDF stage rewrites subsurface lanes to a diffuse
                # exit lobe + a mirror entry lobe: compile those branches
                | ({bxdfs.BXDF_DIFFUSE, bxdfs.BXDF_CONDUCTOR}
                   if (tags == bxdfs.BXDF_SUBSURFACE).any() else set()))))


def load_merl_brdf(path):
    """Read a MERL .binary BRDF capture -> (90, 90, 180, 3) linear RGB
    (public format: 3 int32 dims + float64 data, channel-planar, with the
    standard 1/1500, 1.15/1500, 1.66/1500 channel scales)."""
    import struct as pystruct
    raw = open(path, "rb").read()
    nh, nd, np_ = pystruct.unpack("<iii", raw[:12])
    n = nh * nd * np_
    data = np.frombuffer(raw[12:12 + n * 3 * 8], np.float64)
    r = data[:n] * (1.0 / 1500.0)
    g = data[n:2 * n] * (1.15 / 1500.0)
    b = data[2 * n:] * (1.66 / 1500.0)
    out = np.stack([r, g, b], -1).reshape(nh, nd, np_, 3)
    return np.clip(out, 0.0, None).astype(np.float32)


# Default conductor (Cu) dense spectra indices are resolved at scene compile.

def resolve_mix(pool: MaterialPool, mat_idx, p_world):
    """Resolve Mix materials to a concrete sub-material index by a
    stochastic per-point choice (reference MixMaterial::ChooseMaterial /
    wavefront surfscatter pre-resolution: u = HashFloat(p))."""
    if not pool.has_mix:
        return mat_idx
    import jax
    from .ops.gather import pool_lookup, f32_to_i32
    from .utils import rng as prng
    rows = pool_lookup(pool.packed, mat_idx)
    tag = f32_to_i32(rows[..., 0])
    pb = jax.lax.bitcast_convert_type(p_world, jnp.uint32)
    u = prng.uniform_float(pb[..., 0], pb[..., 1], pb[..., 2],
                           mat_idx.astype(jnp.uint32))
    m1 = f32_to_i32(rows[..., 12])       # albedo_tex slot holds m1
    m2 = f32_to_i32(rows[..., 18])
    picked = jnp.where(u < rows[..., 19], m1, m2)
    return jnp.where(tag == MTL_MIX, picked, mat_idx)


def apply_normal_mapping(pool: MaterialPool, textures, mat_idx, isect):
    """Perturb the shading normal by the material's bump height map or
    tangent-space normal map (reference NormalBumpEvalContext materials.h:42,
    BumpMap / NormalMap in interaction GetBSDF flow).

    isect: intersect() result dict with ns/ng/uv/dpdu/dpdv. Returns the new
    shading normal (N, 3)."""
    ns = isect["ns"]
    if not pool.has_bump:
        return ns
    from .ops.gather import pool_lookup, f32_to_i32
    from . import textures as tex_mod
    from .utils import vecmath as vm
    rows = pool_lookup(pool.packed, mat_idx)
    uv = isect["uv"]
    dpdu = isect["dpdu"]
    dpdv = isect["dpdv"]

    # --- bump mapping: finite differences of the height texture ---
    bump_tex = f32_to_i32(rows[..., 15])
    bscale = rows[..., 16]
    eps = 5e-4
    h0 = tex_mod.eval_texture_float(textures, bump_tex, uv)
    hu = tex_mod.eval_texture_float(
        textures, bump_tex, uv + jnp.asarray([eps, 0.0], jnp.float32))
    hv = tex_mod.eval_texture_float(
        textures, bump_tex, uv + jnp.asarray([0.0, eps], jnp.float32))
    dhdu = (hu - h0) / eps * bscale
    dhdv = (hv - h0) / eps * bscale
    ns_bump = vm.normalize(vm.cross(dpdu + dhdu[..., None] * ns,
                                    dpdv + dhdv[..., None] * ns))
    ns_bump = jnp.where(vm.dot(ns_bump, ns)[..., None] < 0, -ns_bump, ns_bump)

    # --- normal mapping: tangent-space RGB map ---
    normal_tex = f32_to_i32(rows[..., 17])
    rgb = tex_mod.eval_texture_rgb_raw(textures, normal_tex, uv)
    n_ts = vm.normalize(2.0 * rgb - 1.0)
    t = vm.normalize(dpdu - vm.dot(dpdu, ns)[..., None] * ns)
    bvec = vm.cross(ns, t)
    ns_nm = vm.normalize(n_ts[..., 0:1] * t + n_ts[..., 1:2] * bvec +
                         n_ts[..., 2:3] * ns)

    out = jnp.where((bump_tex >= 0)[..., None], ns_bump, ns)
    out = jnp.where((normal_tex >= 0)[..., None], ns_nm, out)
    return out


def get_bsdf_params(pool: MaterialPool, mat_idx, lam, spectra_pool,
                    textures=None, uv=None, p_world=None,
                    spec_cache=None, footprint=None,
                    ns=None, prim=None) -> bxdfs.BSDFParams:
    """Evaluate material textures at the hit -> per-lane BSDFParams.

    mat_idx: (N,) int32; lam: (N, 4). textures: optional TexturePool;
    uv: (N, 2) hit uv for texture evaluation (used where albedo_tex >= 0).

    One packed-row lookup + (only if the scene has spectral eta/k) one fused
    spectrum-pool gather each for eta and k + (only if textured) one texture
    evaluation (coeffs baked at compile; see textures.py).
    """
    from .ops.gather import pool_lookup, f32_to_i32
    if pool.has_mix and p_world is not None:
        mat_idx = resolve_mix(pool, mat_idx, p_world)
    rows = pool_lookup(pool.packed, mat_idx)
    tag = f32_to_i32(rows[..., 0])
    coeffs = rows[..., 1:4]
    albedo = pcolor.eval_rgb_sigmoid_polynomial(coeffs, lam)
    if textures is not None and pool.has_textures and uv is not None:
        from . import textures as tex_mod
        tex_idx = f32_to_i32(rows[..., 12])
        tex_idx = jnp.where(tag == MTL_MIX, -1, tex_idx)
        if textures.has_mixers:
            tex_albedo = tex_mod.eval_texture_spectral(
                textures, tex_idx, uv, lam, p_world, footprint=footprint,
                ns=ns, prim=prim)
        else:
            tc, tscale = tex_mod.eval_texture(textures, tex_idx, uv,
                                              p_world, footprint=footprint,
                                              prim=prim)
            tex_albedo = pcolor.eval_rgb_sigmoid_polynomial(tc, lam) * \
                tscale[..., None]
        albedo = jnp.where((tex_idx >= 0)[..., None], tex_albedo, albedo)
    trans = pcolor.eval_rgb_sigmoid_polynomial(rows[..., 4:7], lam)
    ur = rows[..., 7]
    vr = rows[..., 8]
    if textures is not None and pool.has_rough_tex and uv is not None:
        from . import textures as tex_mod
        rt = f32_to_i32(rows[..., 14])
        r_val = tex_mod.eval_texture_float(textures, rt, uv)
        ur = jnp.where(rt >= 0, r_val, ur)
        vr = jnp.where(rt >= 0, r_val, vr)
    remap = rows[..., 13] > 0.5
    ax = jnp.where(remap, bxdfs.roughness_to_alpha(ur), ur)
    ay = jnp.where(remap, bxdfs.roughness_to_alpha(vr), vr)
    eta_const = rows[..., 9]
    ones = jnp.ones_like(lam)
    if pool.has_spectral_eta:
        from .lights import _lspec
        eidx = f32_to_i32(rows[..., 10])
        kidx = f32_to_i32(rows[..., 11])
        one = jnp.ones_like(ur)
        eta_dense = _lspec(spectra_pool, jnp.maximum(eidx, 0), one, lam,
                           spec_cache)
        k_dense = _lspec(spectra_pool, jnp.maximum(kidx, 0), one, lam,
                         spec_cache)
        eta = jnp.where((eidx >= 0)[..., None], eta_dense, eta_const[..., None] * ones)
        k = jnp.where((kidx >= 0)[..., None], k_dense, ones)
    else:
        eta = eta_const[..., None] * ones
        k = ones
    # diffuse-transmission stores transmittance in the k slot (see bxdfs)
    k = jnp.where((tag == bxdfs.BXDF_DIFFUSE_TRANSMISSION)[..., None], trans, k)
    # subsurface: spectral diffusion radius d (trans coeffs x scale) in the
    # k slot; surface albedo stays in the albedo slot
    if pool.bxdf_tags_present is None or \
            bxdfs.BXDF_SUBSURFACE in (pool.bxdf_tags_present or ()):
        d_spec = trans * rows[..., 19:20]
        k = jnp.where((tag == bxdfs.BXDF_SUBSURFACE)[..., None], d_spec, k)
    # hair: spectral sigma_a (unbounded: trans coeffs x stored scale) in
    # the albedo slot; azimuthal offset h from the curve hit's v coordinate
    h = None
    if pool.bxdf_tags_present is None or \
            bxdfs.BXDF_HAIR in (pool.bxdf_tags_present or ()):
        sigma_a = trans * rows[..., 19:20]  # mix_amount slot = scale
        albedo = jnp.where((tag == bxdfs.BXDF_HAIR)[..., None], sigma_a,
                           albedo)
        if uv is not None:
            h = jnp.clip(-1.0 + 2.0 * uv[..., 1], -1.0, 1.0)
    coat_alpha = rows[..., 20] if pool.has_coated_conductor else None
    coat_eta = rows[..., 21] if pool.has_coated_conductor else None
    if pool.has_measured:
        k = jnp.where((tag == bxdfs.BXDF_MEASURED)[..., None], lam, k)
    return bxdfs.BSDFParams(tag=tag, albedo=albedo, alpha_x=ax, alpha_y=ay,
                            eta=eta, k=k, coat_alpha=coat_alpha,
                            coat_eta=coat_eta, h=h,
                            measured_table=pool.measured_table,
                            tags_present=pool.bxdf_tags_present)
