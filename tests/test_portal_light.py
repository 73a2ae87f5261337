"""PortalImageInfiniteLight (reference lights.h:631): rectified-space
resampling, windowed sampling, pdf consistency, variance advantage."""
import pytest
import numpy as np
import jax.numpy as jnp

from pbrt_jax import lights as lgt
from pbrt_jax.utils import color as pcolor
from pbrt_jax.utils import spectrum as spc


def _portal_light(img=None, res=32):
    if img is None:
        img = np.full((32, 32, 3), 0.5, np.float32)
    # winding per the reference convention (lights.cpp:1140
    # Frame::FromXY(p03, p01)): x = c0->c3, y = c0->c1, z = x cross y must
    # point the way escaped rays travel (+z here, away from the origin)
    corners = np.asarray([[-1, -1, 2], [-1, 1, 2], [1, 1, 2], [1, -1, 2]],
                         np.float32)
    return lgt.make_portal_env_light(img, corners, pcolor.srgb(), res=res), \
        corners


def test_portal_uv_roundtrip():
    env, corners = _portal_light()
    rng = np.random.default_rng(0)
    # directions through the portal from the origin
    pts = np.stack([rng.uniform(-0.9, 0.9, 64), rng.uniform(-0.9, 0.9, 64),
                    np.full(64, 2.0)], -1)
    w = pts / np.linalg.norm(pts, axis=-1, keepdims=True)
    u, v, jac, valid = lgt._portal_uv_from_w(env, jnp.asarray(w, jnp.float32))
    assert np.asarray(valid).all()
    assert np.asarray(jac).min() > 0
    # behind the portal plane: invalid
    _, _, _, v2 = lgt._portal_uv_from_w(
        env, jnp.asarray([[0.0, 0.0, -1.0]], jnp.float32))
    assert not bool(np.asarray(v2)[0])


@pytest.mark.slow
def test_portal_window_contains_samples():
    env, corners = _portal_light()
    n = 512
    rng = np.random.default_rng(1)
    p = jnp.tile(jnp.asarray([[0.3, -0.2, 0.0]], jnp.float32), (n, 1))
    u2 = jnp.asarray(rng.uniform(0, 1, (n, 2)), jnp.float32)
    swl = spc.sample_uniform_wavelengths(jnp.full((n,), 0.5))
    wi, L, pdf, _ = lgt.portal_env_sample_li(env, p, u2, swl.lam,
                                             jnp.float32(10.0))
    wi = np.asarray(wi)
    assert np.asarray(pdf).min() > 0
    # every sampled direction lies inside the portal's rectified-uv
    # window (up to the 1-texel quantization of the window bounds)
    u, v, _, valid = lgt._portal_uv_from_w(env, jnp.asarray(wi, jnp.float32))
    assert np.asarray(valid).all()
    u0, v0, u1, v1, ok = lgt._portal_window(env, p)
    slop = 1.5 / env.width
    assert (np.asarray(u) > np.asarray(u0) - slop).all()
    assert (np.asarray(u) < np.asarray(u1) + slop).all()
    assert (np.asarray(v) > np.asarray(v0) - slop).all()
    assert (np.asarray(v) < np.asarray(v1) + slop).all()
    # and the directions do cross the portal plane toward it
    assert (wi[:, 2] > 0).all()


def test_portal_pdf_integrates_to_one():
    """MC check: E_uniform[pdf_portal(w) / pdf_uniform] == 1 over the
    sphere => the sampling pdf is a proper density."""
    env, corners = _portal_light()
    rng = np.random.default_rng(2)
    n = 200000
    w = rng.normal(size=(n, 3))
    w /= np.linalg.norm(w, axis=-1, keepdims=True)
    p = jnp.tile(jnp.asarray([[0.0, 0.0, 0.0]], jnp.float32), (n, 1))
    pdf = np.asarray(lgt.portal_env_pdf_li(env, jnp.asarray(w, jnp.float32),
                                           p))
    est = pdf.mean() * 4.0 * np.pi   # / uniform pdf (1/4pi)
    assert abs(est - 1.0) < 0.05, est


@pytest.mark.slow
def test_portal_estimator_matches_window_solid_angle():
    """With constant radiance, the portal estimator's mean equals
    L0 x (portal solid angle from p) — cross-checked against a geometric
    MC estimate of the rectangle's solid angle. The estimator touches ONLY
    through-portal directions (that's the whole point: zero-day-style
    scenes waste no samples on occluded sky)."""
    env, corners = _portal_light(res=256)  # fine texels: window
    # quantization error ~1/256 (the sampler rounds the window outward to
    # whole texels, which only adds variance, never bias)
    rng = np.random.default_rng(3)
    n = 8192
    p_np = np.asarray([0.0, 0.0, -1.0], np.float32)
    p = jnp.tile(jnp.asarray(p_np[None]), (n, 1))
    u2 = jnp.asarray(rng.uniform(0, 1, (n, 2)), jnp.float32)
    swl = spc.sample_uniform_wavelengths(jnp.full((n,), 0.5))
    wi, L, pdf, _ = lgt.portal_env_sample_li(env, p, u2, swl.lam,
                                             jnp.float32(10.0))
    f_portal = (np.asarray(L).mean(-1)
                / np.maximum(np.asarray(pdf), 1e-12)).mean()
    # geometric solid angle of the rectangle from p (uniform-sphere MC)
    m = 400000
    w = rng.normal(size=(m, 3))
    w /= np.linalg.norm(w, axis=-1, keepdims=True)
    tt = (2.0 - p_np[2]) / np.where(np.abs(w[:, 2]) > 1e-9, w[:, 2], 1e-9)
    hit = p_np[None] + tt[:, None] * w
    through = (w[:, 2] > 0) & (np.abs(hit[:, 0]) < 1) & \
        (np.abs(hit[:, 1]) < 1)
    omega = through.mean() * 4.0 * np.pi
    # constant-radiance L0 from the env itself (any through direction)
    L0 = float(np.asarray(lgt.portal_env_radiance(
        env, jnp.asarray([[0.0, 0.0, 1.0]], jnp.float32),
        swl.lam[:1])).mean())
    assert abs(f_portal - L0 * omega) / (L0 * omega) < 0.1, \
        (f_portal, L0 * omega)


@pytest.mark.slow
def test_portal_scene_render_smoke():
    from pbrt_jax import scene_core as sc
    from pbrt_jax.integrators import render as rdr
    from pbrt_jax.integrators.path import PathOptions
    from pbrt_jax import cameras as cam_mod
    b = sc.SceneBuilder()
    m = b.materials.add_diffuse((0.6,) * 3)
    b.add_mesh([[-3, -1, -3], [3, -1, -3], [3, -1, 3], [-3, -1, 3]],
               [[0, 1, 2], [0, 2, 3]], m)
    img = np.full((16, 16, 3), 1.0, np.float32)
    b.add_portal_infinite_light(
        img, [[-1, -1, 2], [1, -1, 2], [1, 1, 2], [-1, 1, 2]])
    scene = b.build(force_bvh=False)
    assert isinstance(scene.env, lgt.PortalEnvLight)
    cam = cam_mod.make_camera("perspective", fov=60, width=16, height=16)
    img_out, _ = rdr.render(scene, cam, spp=4, opts=PathOptions(max_depth=2))
    assert np.isfinite(np.asarray(img_out)).all()
