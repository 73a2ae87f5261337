"""BSSRDF subsurface scattering (reference bssrdf.h:105 TabulatedBSSRDF /
wavefront subsurface.cpp; vectorized substitution: Burley normalized diffusion)."""
import pytest
import numpy as np
import jax.numpy as jnp


def _sss_scene(mfp=0.2):
    from pbrt_jax import scene_core as sc
    from pbrt_jax.utils import spectrum as spc
    b = sc.SceneBuilder()
    m = b.materials.add_subsurface(reflectance=(0.8, 0.4, 0.3),
                                   mfp=(mfp,) * 3, eta=1.33)
    # a slab (top face at y=0)
    V = np.asarray([[-2, 0, -2], [2, 0, -2], [2, 0, 2], [-2, 0, 2],
                    [-2, -0.5, -2], [2, -0.5, -2], [2, -0.5, 2],
                    [-2, -0.5, 2]], np.float32)
    F = np.asarray([[0, 2, 1], [0, 3, 2],         # top (upward)
                    [4, 5, 6], [4, 6, 7]])         # bottom
    b.add_mesh(V, F, m)
    b.add_uniform_infinite_light(spc.ConstantSpectrum(1.0))
    return b.build(force_bvh=False)


def test_subsurface_material_pool_flags():
    scene = _sss_scene()
    from pbrt_jax import bxdfs
    assert scene.materials.has_subsurface
    assert bxdfs.BXDF_DIFFUSE in scene.materials.bxdf_tags_present
    assert bxdfs.BXDF_CONDUCTOR in scene.materials.bxdf_tags_present


@pytest.mark.slow
def test_subsurface_render_finite_and_colored():
    from pbrt_jax.integrators import render as rdr
    from pbrt_jax.integrators.path import PathOptions
    from pbrt_jax import cameras as cam_mod
    from pbrt_jax.utils import transform as tfm
    scene = _sss_scene()
    cam = cam_mod.make_camera(
        "perspective", fov=50, width=24, height=24,
        camera_from_world=tfm.look_at((0, 2.5, 2.5), (0, 0, 0),
                                      (0, 1, 0)).inverse())
    img, _ = rdr.render(scene, cam, spp=16, opts=PathOptions(max_depth=5))
    a = np.asarray(img)
    assert np.isfinite(a).all()
    # central slab pixels lit and tinted (R reflectance > B)
    c = a[8:16, 8:16]
    assert c.mean() > 0.01
    assert c[..., 0].mean() > c[..., 2].mean()


@pytest.mark.slow
def test_subsurface_mfp_controls_translucency():
    """Small mfp -> surface-like (brighter local response at normal
    incidence); the render differs measurably from large mfp."""
    from pbrt_jax.integrators import render as rdr
    from pbrt_jax.integrators.path import PathOptions
    from pbrt_jax import cameras as cam_mod
    from pbrt_jax.utils import transform as tfm
    cam = cam_mod.make_camera(
        "perspective", fov=50, width=16, height=16,
        camera_from_world=tfm.look_at((0, 2.5, 2.5), (0, 0, 0),
                                      (0, 1, 0)).inverse())
    imgs = []
    for mfp in (0.02, 0.8):
        scene = _sss_scene(mfp)
        img, _ = rdr.render(scene, cam, spp=16,
                            opts=PathOptions(max_depth=5))
        imgs.append(np.asarray(img))
    diff = np.abs(imgs[0] - imgs[1]).mean()
    assert diff > 1e-3


def test_burley_radial_profile_normalized():
    """The two-exponential radial density integrates to 1."""
    d = 0.37
    r = np.linspace(1e-5, 60 * d, 400000)
    pdf = 0.25 / d * (np.exp(-r / d) + np.exp(-r / (3 * d)))
    total = np.trapezoid(pdf, r)
    np.testing.assert_allclose(total, 1.0, rtol=1e-3)


def test_tabulated_table_identities():
    """PBD table (reference bssrdf.cpp:26-128): rho_eff monotone, the
    sampling/evaluation estimator identity E[Q_l/pdf] == rho_eff_l, and
    SubsurfaceFromDiffuse roundtrips (bssrdf.cpp:280)."""
    import jax.numpy as jnp
    from pbrt_jax import bssrdf as bs
    tbl = bs.compute_table(g=0.0, eta=1.33)
    rho_eff = np.asarray(tbl.rho_eff)
    assert (np.diff(rho_eff) > 0).all()
    assert (np.asarray(tbl.profile) >= -1e-9).all()
    # inversion roundtrip
    refl = np.asarray([0.2, 0.5, 0.8])
    sa, ss = bs.subsurface_from_diffuse(tbl, refl, (0.01,) * 3)
    back = np.interp(ss / (sa + ss), np.asarray(tbl.rho), rho_eff)
    np.testing.assert_allclose(back, refl, atol=1e-5)
    # estimator identity with per-channel sigma_t
    rng = np.random.default_rng(0)
    N = 20000
    rho4 = jnp.asarray(np.tile([[0.7, 0.5, 0.9, 0.3]], (N, 1)))
    st4 = jnp.asarray(np.tile([[100.0, 50.0, 200.0, 120.0]], (N, 1)))
    ch = rng.integers(0, 4, N)
    u = jnp.asarray(rng.uniform(0, 1, N))
    rho_c = jnp.take_along_axis(rho4, ch[:, None], 1)[:, 0]
    st_c = jnp.take_along_axis(st4, ch[:, None], 1)[:, 0]
    r, _rmax = bs.sample_r(tbl, rho_c, st_c, u)
    q, pdf, _ = bs.radial_profile_pdf(tbl, rho4, st4, r)
    est = (np.asarray(q) / np.maximum(np.asarray(pdf)[:, None],
                                      1e-12)).mean(0)
    want = np.interp([0.7, 0.5, 0.9, 0.3], np.asarray(tbl.rho), rho_eff)
    np.testing.assert_allclose(est, want, rtol=0.03)


def test_tabulated_vs_burley_render():
    """Tabulated and Burley renders of the same material agree in overall
    energy (same reflectance/mfp; profiles differ in shape, not albedo)."""
    from pbrt_jax import scene_core as sc
    from pbrt_jax import scenes, samplers as smp, cameras as cam_mod
    from pbrt_jax.integrators import render as rdr
    from pbrt_jax.integrators.path import PathOptions
    from pbrt_jax.utils import spectrum as spc, transform as tfm
    imgs = {}
    for prof in ("tabulated", "burley"):
        b = sc.SceneBuilder()
        m = b.materials.add_subsurface(reflectance=(0.6, 0.5, 0.4),
                                       mfp=(0.06,) * 3, profile=prof)
        V, F, _n = scenes.make_sphere_mesh((0, 0, 0), 1.0, subdiv=3)
        b.add_mesh(V, F, m)
        b.add_uniform_infinite_light(spc.ConstantSpectrum(1.0))
        scene = b.build(force_bvh=False)
        assert scene.materials.sss_tabulated == (prof == "tabulated")
        cam = cam_mod.make_camera(
            "perspective", fov=40, width=24, height=24,
            camera_from_world=tfm.look_at((0, 0, 4), (0, 0, 0),
                                          (0, 1, 0)).inverse())
        img, _ = rdr.render(scene, cam, spp=24,
                            sampler=smp.make_sampler("independent", spp=24),
                            opts=PathOptions(max_depth=6))
        imgs[prof] = np.asarray(img)
        assert np.isfinite(imgs[prof]).all()
    lum = {k: float((0.2126 * v[..., 0] + 0.7152 * v[..., 1] +
                     0.0722 * v[..., 2])[8:16, 8:16].mean())
           for k, v in imgs.items()}
    assert abs(lum["tabulated"] / max(lum["burley"], 1e-6) - 1.0) < 0.30, lum


def test_scattering_preset():
    from pbrt_jax import bssrdf as bs
    got = bs.get_scattering_preset("Marble")
    assert got is not None
    sa, sps = got
    assert (sps > 0).all()
    assert bs.get_scattering_preset("NotAMaterial") is None
