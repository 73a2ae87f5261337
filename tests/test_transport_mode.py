"""TransportMode eta^2 adjoint correction (reference bxdfs.cpp:110,164,204;
base/bxdf.h:110 TransportMode): importance transport (light subpaths in
lightpath/BDPT/MLT/SPPM) must NOT apply the 1/etap^2 radiance-compression
factor on dielectric transmission.

Gates: (1) the adjoint identity f_importance(wo, wi) == f_radiance(wi, wo)
on rough-dielectric transmission pairs; (2) a glass-slab scene where BDPT
(light subpaths crossing the dielectric) matches the path tracer."""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp
import numpy as np
import pytest

from pbrt_jax import bxdfs
from pbrt_jax.utils import vecmath as vm


def _dielectric_params(n, eta=1.5, alpha=0.3):
    return bxdfs.BSDFParams(
        tag=jnp.full((n,), bxdfs.BXDF_DIELECTRIC, jnp.int32),
        albedo=jnp.ones((n, 4)),
        alpha_x=jnp.full((n,), alpha), alpha_y=jnp.full((n,), alpha),
        eta=jnp.full((n, 4), eta), k=jnp.zeros((n, 4)),
        tags_present=(bxdfs.BXDF_DIELECTRIC,))


def test_adjoint_reciprocity_rough_dielectric():
    """f_importance(wo, wi) == f_radiance(wi, wo): the adjoint BSDF is the
    transpose, and for dielectric transmission the transpose relation holds
    exactly when the eta^2 factor rides only on the radiance side
    (Veach 5.2; reference bxdfs.cpp:110)."""
    rng = np.random.default_rng(3)
    n = 256
    wo = rng.normal(size=(n, 3))
    wo[:, 2] = np.abs(wo[:, 2]) + 0.2          # from above
    wo /= np.linalg.norm(wo, axis=-1, keepdims=True)
    wi = rng.normal(size=(n, 3))
    wi[:, 2] = -(np.abs(wi[:, 2]) + 0.2)       # transmitted below
    wi /= np.linalg.norm(wi, axis=-1, keepdims=True)
    wo = jnp.asarray(wo, jnp.float32)
    wi = jnp.asarray(wi, jnp.float32)
    p = _dielectric_params(n)
    f_imp = np.asarray(bxdfs.bsdf_f(p, wo, wi, adjoint=True))
    f_rad_T = np.asarray(bxdfs.bsdf_f(p, wi, wo, adjoint=False))
    nz = f_imp[:, 0] > 1e-6
    assert nz.sum() > 50  # enough valid transmission pairs
    rel = np.abs(f_imp[nz] - f_rad_T[nz]) / np.maximum(f_imp[nz], 1e-6)
    # near-TIR pairs lose a digit to (1-F) cancellation; the identity must
    # hold to float noise in the bulk and a couple % at grazing — vs the
    # 2.25x factor the gate exists to catch
    assert np.median(rel) < 1e-5, np.median(rel)
    assert rel.max() < 0.05, rel.max()
    # and the two modes genuinely differ (eta != 1): radiance-mode f on the
    # same pairs carries the 1/etap^2 factor
    f_rad = np.asarray(bxdfs.bsdf_f(p, wo, wi, adjoint=False))
    ratio = f_imp[nz] / np.maximum(f_rad[nz], 1e-9)
    assert np.all(np.abs(ratio - 1.5 ** 2) < 1e-2) or \
        np.all(np.abs(ratio - 1.5 ** -2) < 1e-2)


def _glass_slab_scene(width=48, height=48):
    """Diffuse floor under a thin glass slab under an area light: every
    light subpath to the floor crosses the dielectric twice."""
    from pbrt_jax import scene_core as sc
    from pbrt_jax import cameras as cam_mod
    from pbrt_jax.utils import transform as tfm
    from pbrt_jax.utils import color as pcolor

    b = sc.SceneBuilder()
    floor = b.materials.add_diffuse((0.6, 0.6, 0.6))
    glass = b.materials.add_dielectric(eta=1.5, roughness=0.0)

    def quad(corners, material, **kw):
        v = np.asarray(corners, np.float32)
        b.add_mesh(v, [[0, 1, 2], [0, 2, 3]], material, **kw)

    quad([(-4, 0, -4), (4, 0, -4), (4, 0, 4), (-4, 0, 4)], floor)
    # closed thin slab (12 tris) spanning the light-floor gap
    lo = np.asarray([-3, 1.0, -3])
    hi = np.asarray([3, 1.2, 3])
    corners = [(x, y, z) for x in (lo[0], hi[0]) for y in (lo[1], hi[1])
               for z in (lo[2], hi[2])]
    faces = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6),
             (0, 2, 6, 4), (1, 5, 7, 3)]
    for f in faces:
        quad([corners[i] for i in f], glass)
    emit = pcolor.RGBIlluminantSpectrum((10.0, 10.0, 10.0), b.cs)
    # winding chosen so ng points DOWN (-y) toward the slab and floor
    quad([(1.5, 2.5, -1.5), (1.5, 2.5, 1.5), (-1.5, 2.5, 1.5),
          (-1.5, 2.5, -1.5)], floor, emission=emit)
    scene = b.build(light_sampler="power", force_bvh=False)
    cam = cam_mod.make_camera(
        "perspective",
        camera_from_world=tfm.look_at((0, 0.6, -3.5), (0, 0.3, 0),
                                      (0, 1, 0)).inverse(),
        width=width, height=height, fov=45.0)
    return scene, cam


@pytest.mark.slow
def test_bdpt_matches_path_through_glass():
    """With the eta^2 adjoint fix, light subpaths crossing the slab carry
    the same weight as camera subpaths: BDPT mean == path mean."""
    from pbrt_jax import samplers as smp
    from pbrt_jax.integrators import render as rdr
    from pbrt_jax.integrators.path import PathOptions

    scene, cam = _glass_slab_scene()
    opts = PathOptions(max_depth=5)
    img_p, _ = rdr.render(scene, cam, spp=96, opts=opts,
                          sampler=smp.make_sampler("zsobol", spp=96,
                                                   full_resolution=(48, 48)))
    img_b, _ = rdr.render(scene, cam, spp=96, opts=opts, integrator="bdpt",
                          sampler=smp.make_sampler("zsobol", spp=96,
                                                   full_resolution=(48, 48)))
    m_p = float(np.mean(np.asarray(img_p)))
    m_b = float(np.mean(np.asarray(img_b)))
    assert abs(m_b - m_p) / m_p < 0.05, (m_p, m_b)
