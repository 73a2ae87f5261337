"""Material system depth: Mix, bump/normal mapping, textured roughness,
coated conductor (reference materials.h:272 MixMaterial, materials.h:42
NormalBumpEvalContext, bxdfs.h:1165 CoatedConductorBxDF)."""
import pytest
import jax.numpy as jnp
import numpy as np

from pbrt_jax import bxdfs
from pbrt_jax import materials as mtl
from pbrt_jax import textures as tex_mod
from pbrt_jax.utils import sampling as usamp


def _params_coated_conductor(n, coat_rough=0.2, base_rough=0.3):
    ca = np.sqrt(coat_rough)
    ax = np.sqrt(base_rough)
    return bxdfs.BSDFParams(
        tag=jnp.full((n,), bxdfs.BXDF_COATED_CONDUCTOR, jnp.int32),
        albedo=jnp.ones((n, 4)),
        alpha_x=jnp.full((n,), ax), alpha_y=jnp.full((n,), ax),
        eta=jnp.full((n, 4), 0.2),   # gold-ish
        k=jnp.full((n, 4), 3.0),
        coat_alpha=jnp.full((n,), ca), coat_eta=jnp.full((n,), 1.5))


@pytest.mark.slow
def test_coated_conductor_energy_conservation():
    """Integral of f cos over the hemisphere <= 1 (no energy gain)."""
    n = 4096
    rng = np.random.RandomState(3)
    p = _params_coated_conductor(n)
    wo = jnp.broadcast_to(
        jnp.asarray([0.3, 0.0, np.sqrt(1 - 0.09)], jnp.float32), (n, 3))
    # uniform hemisphere MC
    u = jnp.asarray(rng.rand(n, 2), jnp.float32)
    wi = usamp.sample_uniform_hemisphere(u)
    f = bxdfs.bsdf_f(p, wo, wi)
    cos_i = jnp.abs(wi[..., 2])
    est = np.asarray(jnp.mean(f[..., 0] * cos_i) * 2 * np.pi)
    assert est <= 1.05, est
    assert est > 0.2, est  # a metal under a clear coat still reflects plenty


@pytest.mark.slow
def test_coated_conductor_sample_pdf_consistency():
    """E[f cos / pdf] from importance sampling == the uniform-MC estimate."""
    n = 1 << 15
    rng = np.random.RandomState(9)
    p = _params_coated_conductor(n)
    wo = jnp.broadcast_to(
        jnp.asarray([0.4, 0.2, np.sqrt(1 - 0.2)], jnp.float32), (n, 3))
    uc = jnp.asarray(rng.rand(n), jnp.float32)
    u2 = jnp.asarray(rng.rand(n, 2), jnp.float32)
    bs = bxdfs.bsdf_sample(p, wo, uc, u2)
    w = np.asarray(jnp.where(bs["valid"],
                             bs["f"][..., 0] * jnp.abs(bs["wi"][..., 2]) /
                             jnp.maximum(bs["pdf"], 1e-9), 0.0))
    rho_is = w.mean()
    u = jnp.asarray(rng.rand(n, 2), jnp.float32)
    wi = usamp.sample_uniform_hemisphere(u)
    f = bxdfs.bsdf_f(p, wo, wi)
    rho_uni = float(jnp.mean(f[..., 0] * jnp.abs(wi[..., 2])) * 2 * np.pi)
    np.testing.assert_allclose(rho_is, rho_uni, rtol=0.08)


def test_mix_material_resolution():
    mb = mtl.MaterialBuilder()
    m_red = mb.add_diffuse((0.9, 0.1, 0.1))
    m_grn = mb.add_diffuse((0.1, 0.9, 0.1))
    m_mix = mb.add_mix(m_red, m_grn, amount=0.7)
    pool = mb.build()
    assert pool.has_mix
    n = 4096
    rng = np.random.RandomState(1)
    p = jnp.asarray(rng.rand(n, 3) * 10, jnp.float32)
    mat = jnp.full((n,), m_mix, jnp.int32)
    res = np.asarray(mtl.resolve_mix(pool, mat, p))
    frac_red = (res == m_red).mean()
    assert abs(frac_red - 0.7) < 0.03, frac_red
    assert set(np.unique(res)) == {m_red, m_grn}
    # deterministic per point
    res2 = np.asarray(mtl.resolve_mix(pool, mat, p))
    np.testing.assert_array_equal(res, res2)


def _isect_flat(n, uv):
    return dict(ns=jnp.broadcast_to(jnp.asarray([0., 0., 1.]), (n, 3)),
                ng=jnp.broadcast_to(jnp.asarray([0., 0., 1.]), (n, 3)),
                uv=jnp.asarray(uv, jnp.float32),
                dpdu=jnp.broadcast_to(jnp.asarray([1., 0., 0.]), (n, 3)),
                dpdv=jnp.broadcast_to(jnp.asarray([0., 1., 0.]), (n, 3)))


def test_normal_map_identity_and_tilt():
    tb = tex_mod.TextureBuilder()
    flat = tb.add_image_raw(np.full((4, 4, 3), [0.5, 0.5, 1.0], np.float32))
    # tilt toward +u: n_ts = (sin30, 0, cos30)
    s30, c30 = np.sin(np.pi / 6), np.cos(np.pi / 6)
    tilt = tb.add_image_raw(np.full((4, 4, 3),
                                    [(s30 + 1) / 2, 0.5, (c30 + 1) / 2],
                                    np.float32))
    tp = tb.build()
    mb = mtl.MaterialBuilder()
    m0 = mb.add_diffuse((0.5,) * 3)
    m1 = mb.add_diffuse((0.5,) * 3)
    mb.set_normal_map(m0, flat)
    mb.set_normal_map(m1, tilt)
    pool = mb.build()
    n = 4
    isect = _isect_flat(n, np.full((n, 2), 0.5))
    ns0 = np.asarray(mtl.apply_normal_mapping(
        pool, tp, jnp.full((n,), m0, jnp.int32), isect))
    np.testing.assert_allclose(ns0, [[0, 0, 1]] * n, atol=1e-3)
    ns1 = np.asarray(mtl.apply_normal_mapping(
        pool, tp, jnp.full((n,), m1, jnp.int32), isect))
    np.testing.assert_allclose(ns1, [[s30, 0, c30]] * n, atol=2e-3)


def test_bump_map_gradient():
    """Height ramp h = u: perturbed normal tilts by atan(bump_scale)."""
    tb = tex_mod.TextureBuilder()
    w = 256
    ramp = np.broadcast_to(np.linspace(0, 1, w, dtype=np.float32)[None, :],
                           (4, w)).copy()
    bt = tb.add_image_raw(ramp)
    tp = tb.build()
    mb = mtl.MaterialBuilder()
    m = mb.add_diffuse((0.5,) * 3)
    mb.set_bump(m, bt, scale=0.5)
    pool = mb.build()
    n = 4
    isect = _isect_flat(n, np.full((n, 2), 0.43))
    ns = np.asarray(mtl.apply_normal_mapping(
        pool, tp, jnp.full((n,), m, jnp.int32), isect))
    # dh/du = 1 (ramp over [0,1]) * scale 0.5 -> normal ~ (-0.5, 0, 1)/norm
    expect = np.asarray([-0.5, 0, 1.0])
    expect /= np.linalg.norm(expect)
    np.testing.assert_allclose(ns[0], expect, atol=0.02)


def test_textured_roughness_overrides():
    tb = tex_mod.TextureBuilder()
    rt = tb.add_constant_float(0.09)
    tp = tb.build()
    mb = mtl.MaterialBuilder()
    m = mb.add_conductor(roughness=0.5)
    mb.set_roughness_texture(m, rt)
    pool = mb.build()
    n = 2
    lam = jnp.full((n, 4), 550.0)
    spectra = jnp.zeros((1, 471))
    bp = mtl.get_bsdf_params(pool, jnp.full((n,), m, jnp.int32), lam,
                             spectra, textures=tp,
                             uv=jnp.full((n, 2), 0.5),
                             p_world=jnp.zeros((n, 3)))
    # remapped: alpha = sqrt(0.09) = 0.3 (not sqrt(0.5))
    np.testing.assert_allclose(np.asarray(bp.alpha_x), 0.3, atol=1e-3)
