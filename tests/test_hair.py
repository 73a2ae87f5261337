"""Hair BxDF (reference bxdfs.h:921; pattern: hair_test.cpp WhiteFurnace /
sampling consistency)."""
import pytest
import numpy as np
import jax.numpy as jnp

from pbrt_jax import bxdfs


def _hair_params(n, sigma_a=0.0, beta_m=0.3, beta_n=0.3, h=0.3):
    return bxdfs.BSDFParams(
        tag=jnp.full((n,), bxdfs.BXDF_HAIR, jnp.int32),
        albedo=jnp.full((n, 4), sigma_a),
        alpha_x=jnp.full((n,), beta_m),
        alpha_y=jnp.full((n,), beta_n),
        eta=jnp.full((n, 4), 1.55),
        k=jnp.zeros((n, 4)),
        h=jnp.full((n,), h),
        tags_present=(bxdfs.BXDF_HAIR,))


def test_hair_white_furnace():
    """sigma_a = 0: the fiber absorbs nothing, so the scattered energy
    integrates to ~1 (reference hair_test.cpp WhiteFurnace)."""
    rng = np.random.default_rng(0)
    n = 200000
    for beta in (0.2, 0.4):
        p = _hair_params(n, sigma_a=0.0, beta_m=beta, beta_n=beta, h=0.25)
        # fixed wo at a moderate angle
        wo = jnp.tile(jnp.asarray([[0.35, 0.65, 0.674]]), (n, 1))
        wo = wo / jnp.linalg.norm(wo, axis=-1, keepdims=True)
        wi = rng.normal(size=(n, 3))
        wi /= np.linalg.norm(wi, axis=-1, keepdims=True)
        f, _ = bxdfs._hair_f_pdf(p, wo, jnp.asarray(wi, jnp.float32))
        # E_uniform[f |cos| * 4pi] = integral of f cos over sphere
        est = float((np.asarray(f).mean(-1) *
                     np.abs(wi[:, 2])).mean() * 4.0 * np.pi)
        assert abs(est - 1.0) < 0.08, (beta, est)


def test_hair_sample_pdf_consistency():
    """E[f |cos| / pdf] over self-samples == energy (=1 for sigma_a=0)."""
    rng = np.random.default_rng(1)
    n = 100000
    p = _hair_params(n, sigma_a=0.0, beta_m=0.35, beta_n=0.35, h=-0.4)
    wo = jnp.tile(jnp.asarray([[0.2, -0.5, 0.843]]), (n, 1))
    wo = wo / jnp.linalg.norm(wo, axis=-1, keepdims=True)
    uc = jnp.asarray(rng.uniform(0, 1, n), jnp.float32)
    u2 = jnp.asarray(rng.uniform(0, 1, (n, 2)), jnp.float32)
    wi, f, pdf = bxdfs._hair_sample(p, wo, uc, u2)
    mask = np.asarray(pdf) > 1e-7
    est = (np.asarray(f).mean(-1) * np.abs(np.asarray(wi)[:, 2]) /
           np.maximum(np.asarray(pdf), 1e-7))[mask].mean()
    assert abs(est - 1.0) < 0.1, est


def test_hair_absorption_darkens():
    rng = np.random.default_rng(2)
    n = 50000
    wo = jnp.tile(jnp.asarray([[0.3, 0.6, 0.742]]), (n, 1))
    wo = wo / jnp.linalg.norm(wo, axis=-1, keepdims=True)
    wi = rng.normal(size=(n, 3))
    wi /= np.linalg.norm(wi, axis=-1, keepdims=True)
    wi = jnp.asarray(wi, jnp.float32)
    e = []
    for sa in (0.0, 1.0, 4.0):
        p = _hair_params(n, sigma_a=sa)
        f, _ = bxdfs._hair_f_pdf(p, wo, wi)
        e.append(float((np.asarray(f).mean(-1) *
                        np.abs(np.asarray(wi)[:, 2])).mean()))
    assert e[0] > e[1] > e[2] > 0


@pytest.mark.slow
def test_hair_render_on_curves():
    """Hair material on curve geometry renders finite, nonzero."""
    import jax
    from pbrt_jax import scene_core as sc, cameras as cam_mod
    from pbrt_jax.integrators import render as rdr
    from pbrt_jax.integrators.path import PathOptions
    from pbrt_jax.utils import spectrum as spc, transform as tfm
    b = sc.SceneBuilder()
    m = b.materials.add_hair(sigma_a=(0.1, 0.2, 0.4), beta_m=0.3, beta_n=0.3)
    rng = np.random.default_rng(3)
    for i in range(12):
        x = rng.uniform(-0.5, 0.5)
        b.add_curve([[x, 0, 0], [x + 0.1, 0.5, 0], [x - 0.1, 1.0, 0],
                     [x, 1.5, 0]], 0.05, 0.02, m, curve_type="cylinder",
                    subdiv=2)
    b.add_uniform_infinite_light(spc.ConstantSpectrum(1.0))
    scene = b.build(force_bvh=False)
    cam = cam_mod.make_camera(
        "perspective", fov=45, width=20, height=20,
        camera_from_world=tfm.look_at((0, 0.8, 3), (0, 0.8, 0),
                                      (0, 1, 0)).inverse())
    img, _ = rdr.render(scene, cam, spp=4, opts=PathOptions(max_depth=4))
    a = np.asarray(img)
    assert np.isfinite(a).all() and a.max() > 0
