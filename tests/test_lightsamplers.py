"""Light sampler tests (reference lightsamplers_test.cpp:24-336:
sampled PMF must equal empirical pick frequency; PDF-method consistency)."""
import jax.numpy as jnp
import numpy as np
import pytest

from pbrt_jax import scene_core as sc
from pbrt_jax import lightsamplers as lsamp
from pbrt_jax.utils import spectrum as spc


def _many_light_scene(n_lights=20, light_sampler="bvh", seed=0):
    rng = np.random.RandomState(seed)
    b = sc.SceneBuilder()
    m = b.materials.add_diffuse((0.5, 0.5, 0.5))
    b.add_mesh([[-50, 0, -50], [50, 0, -50], [50, 0, 50], [-50, 0, 50]],
               [[0, 1, 2], [0, 2, 3]], m)
    emit = spc.ConstantSpectrum(1.0)
    for i in range(n_lights):
        x, z = rng.rand(2) * 40 - 20
        s = 0.3 + rng.rand() * 2
        scale = 10 ** (rng.rand() * 2 - 1)
        # small emissive quad hovering above the floor (one-sided, facing
        # down: winding chosen so the geometric normal is -y)
        b.add_mesh([[x, 5, z], [x + s, 5, z], [x + s, 5, z + s], [x, 5, z + s]],
                   [[0, 1, 2], [0, 2, 3]], m, emission=emit,
                   emission_scale=scale)
    return b.build(light_sampler=light_sampler, force_bvh=False)


def test_bvh_sampler_pmf_matches_frequency():
    """For a fixed shading point, light_pmf(l) must equal the empirical pick
    frequency of sample_light (the reference's core BVH sampler test)."""
    scene = _many_light_scene(12)
    ls = scene.light_sampler
    assert ls.kind == lsamp.LS_BVH
    n = 200_000
    u = jnp.asarray(np.random.RandomState(1).rand(n), jnp.float32)
    p = jnp.broadcast_to(jnp.asarray([0.0, 0.5, 0.0]), (n, 3))
    idx, pmf, _ = lsamp.sample_light(ls, u, p=p)
    idx = np.asarray(idx)
    n_lights = scene.lights.packed.shape[0]
    freq = np.bincount(idx, minlength=n_lights) / n
    # claimed pmf at each light (queried independently)
    li = jnp.arange(n_lights, dtype=jnp.int32)
    pq = jnp.broadcast_to(jnp.asarray([0.0, 0.5, 0.0]), (n_lights, 3))
    pmf_q = np.asarray(lsamp.light_pmf(ls, light_idx=li, p=pq))
    np.testing.assert_allclose(pmf_q.sum(), 1.0, rtol=1e-3)
    for l in range(n_lights):
        if pmf_q[l] > 0.005:
            assert abs(freq[l] - pmf_q[l]) < 0.01 + 3 * np.sqrt(pmf_q[l] / n), \
                (l, freq[l], pmf_q[l])
    # sampled pmf values must agree with queried pmf
    pmf_s = np.asarray(pmf)
    np.testing.assert_allclose(pmf_s, pmf_q[idx], rtol=1e-3, atol=1e-6)


def test_bvh_sampler_prefers_near_lights():
    """Importance-aware sampling: a shading point near one light should pick
    it far more often than a uniform/power sampler would."""
    b = sc.SceneBuilder()
    m = b.materials.add_diffuse((0.5, 0.5, 0.5))
    b.add_mesh([[-50, 0, -50], [50, 0, -50], [50, 0, 50], [-50, 0, 50]],
               [[0, 1, 2], [0, 2, 3]], m)
    emit = spc.ConstantSpectrum(1.0)
    # one near light at origin, many far identical lights (facing down)
    b.add_mesh([[0, 2, 0], [1, 2, 0], [1, 2, 1], [0, 2, 1]],
               [[0, 1, 2], [0, 2, 3]], m, emission=emit)
    for i in range(16):
        x = 100 + i * 3
        b.add_mesh([[x, 2, 0], [x + 1, 2, 0], [x + 1, 2, 1], [x, 2, 1]],
                   [[0, 1, 2], [0, 2, 3]], m, emission=emit)
    scene = b.build(light_sampler="bvh", force_bvh=False)
    n = 50_000
    u = jnp.asarray(np.random.RandomState(2).rand(n), jnp.float32)
    p = jnp.broadcast_to(jnp.asarray([0.5, 0.0, 0.5]), (n, 3))
    idx, pmf, _ = lsamp.sample_light(scene.light_sampler, u, p=p)
    near_frac = (np.asarray(idx) < 2).mean()  # the near quad = lights 0,1
    assert near_frac > 0.5, near_frac  # uniform would give 2/34 ~ 0.06


@pytest.mark.slow
def test_bvh_render_matches_power_render():
    """Same scene rendered with power and BVH light samplers must agree
    (both unbiased; compare means)."""
    from pbrt_jax import cameras as cm
    from pbrt_jax import samplers as smp
    from pbrt_jax.utils import transform as tfm
    from pbrt_jax.integrators import render as rdr
    from pbrt_jax.integrators.path import PathOptions
    cam = cm.make_camera(
        "perspective",
        camera_from_world=tfm.look_at((0, 10, -25), (0, 0, 0), (0, 1, 0)).inverse(),
        width=24, height=24, fov=40)
    opts = PathOptions(max_depth=2)
    samp = smp.make_sampler("independent", spp=96)
    imgs = {}
    for kind in ("power", "bvh"):
        scene = _many_light_scene(8, light_sampler=kind, seed=3)
        imgs[kind], _ = rdr.render(scene, cam, spp=96, sampler=samp, opts=opts)
    m_pow = imgs["power"].mean()
    m_bvh = imgs["bvh"].mean()
    np.testing.assert_allclose(m_bvh, m_pow, rtol=0.06), (m_bvh, m_pow)


def test_exhaustive_sampler_pmf_matches_frequency():
    """Exhaustive sampler (reference lightsamplers.h:407): dense per-light
    importance pick; pmf must equal empirical frequency and sum to 1."""
    scene = _many_light_scene(10, light_sampler="exhaustive")
    ls = scene.light_sampler
    assert ls.kind == lsamp.LS_EXHAUSTIVE
    n = 100_000
    u = jnp.asarray(np.random.RandomState(2).rand(n), jnp.float32)
    p = jnp.broadcast_to(jnp.asarray([3.0, 0.5, -2.0]), (n, 3))
    idx, pmf, u2 = lsamp.sample_light(ls, u, p=p)
    idx = np.asarray(idx)
    n_lights = scene.lights.packed.shape[0]
    freq = np.bincount(idx, minlength=n_lights) / n
    li = jnp.arange(n_lights, dtype=jnp.int32)
    pq = jnp.broadcast_to(jnp.asarray([3.0, 0.5, -2.0]), (n_lights, 3))
    pmf_q = np.asarray(lsamp.light_pmf(ls, light_idx=li, p=pq))
    np.testing.assert_allclose(pmf_q.sum(), 1.0, rtol=1e-3)
    for l in range(n_lights):
        if pmf_q[l] > 0.005:
            assert abs(freq[l] - pmf_q[l]) < 0.01 + 3 * np.sqrt(pmf_q[l] / n)
    np.testing.assert_allclose(np.asarray(pmf), pmf_q[idx], rtol=1e-3,
                               atol=1e-6)
    assert np.all((np.asarray(u2) >= 0) & (np.asarray(u2) < 1))


def test_exhaustive_agrees_with_bvh_preference():
    """Both importance-aware samplers should prefer the near light."""
    sc_ex = _many_light_scene(8, light_sampler="exhaustive", seed=5)
    sc_bvh = _many_light_scene(8, light_sampler="bvh", seed=5)
    n = 50_000
    u = jnp.asarray(np.random.RandomState(3).rand(n), jnp.float32)
    # directly under light 1 (lights start at index... probe all)
    p = jnp.broadcast_to(jnp.asarray([0.0, 4.9, 0.0]), (n, 3))
    i_ex, _, _ = lsamp.sample_light(sc_ex.light_sampler, u, p=p)
    i_bvh, _, _ = lsamp.sample_light(sc_bvh.light_sampler, u, p=p)
    n_lights = sc_ex.lights.packed.shape[0]
    f_ex = np.bincount(np.asarray(i_ex), minlength=n_lights) / n
    f_bvh = np.bincount(np.asarray(i_bvh), minlength=n_lights) / n
    # the exhaustive distribution is the ground truth the BVH approximates;
    # cluster-level cone unions can reorder the top lights, but the two
    # distributions must be strongly correlated and agree on the important set
    corr = np.corrcoef(f_ex, f_bvh)[0, 1]
    assert corr > 0.5, (corr, f_ex, f_bvh)
    top_ex = set(np.argsort(f_ex)[-4:])
    top_bvh = set(np.argsort(f_bvh)[-4:])
    assert len(top_ex & top_bvh) >= 3, (top_ex, top_bvh)
