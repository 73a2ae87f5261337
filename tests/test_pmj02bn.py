"""PMJ02BN sampler + blue-noise tables (reference samplers.h:367,
pmj02tables.h, bluenoise.h; tables generated by tools/gen_pmj02.py and
tools/gen_bluenoise.py)."""
import pytest
import jax.numpy as jnp
import numpy as np

from pbrt_jax import samplers as smp


def test_pmj02_table_elementary_intervals():
    d = smp._pmj02_tables()
    assert d.shape == (5, 65536, 2) and d.dtype == np.uint32
    for s in range(5):
        for n in (64, 1024):
            pts = d[s, :n] / 2.0 ** 32
            k = int(np.sqrt(n))
            cnt = np.zeros((k, k), int)
            np.add.at(cnt, (np.minimum((pts[:, 1] * k).astype(int), k - 1),
                            np.minimum((pts[:, 0] * k).astype(int), k - 1)), 1)
            assert (cnt == 1).all(), (s, n)


def test_pmj02bn_sampler_stratified_per_pixel():
    """The spp samples of one pixel must be (0,2)-stratified in 2D after the
    (per-pixel constant) CP rotation (rotation preserves toroidal strata
    counts only statistically — test pre-rotation via identical pixel)."""
    spp = 64
    s = smp.make_sampler("pmj02bn", spp=spp, full_resolution=(16, 16))
    px = jnp.zeros((spp,), jnp.int32) + 5
    py = jnp.zeros((spp,), jnp.int32) + 9
    si = jnp.arange(spp, dtype=jnp.int32)
    u = np.asarray(smp.sample_2d(s, px, py, si, jnp.zeros((spp,), jnp.int32)))
    assert ((u >= 0) & (u < 1)).all()
    # dim 0 -> instance 0, index = sample_index, same CP rotation for the
    # whole pixel: undo it using sample 0 of the raw table
    raw = smp._pmj02_tables()[0, :spp] / 2.0 ** 32
    rot = (u[0] - raw[0]) % 1.0
    unrot = (u - rot) % 1.0
    np.testing.assert_allclose(unrot, raw % 1.0, atol=1e-5)
    k = int(np.sqrt(spp))
    cnt = np.zeros((k, k), int)
    np.add.at(cnt, (np.minimum((unrot[:, 1] * k).astype(int), k - 1),
                    np.minimum((unrot[:, 0] * k).astype(int), k - 1)), 1)
    assert (cnt == 1).all()


def test_pmj02bn_1d_stratified():
    spp = 32
    s = smp.make_sampler("pmj02bn", spp=spp, full_resolution=(8, 8))
    px = jnp.zeros((spp,), jnp.int32) + 3
    py = jnp.zeros((spp,), jnp.int32) + 4
    si = jnp.arange(spp, dtype=jnp.int32)
    u = np.asarray(smp.sample_1d(s, px, py, si, jnp.full((spp,), 7,
                                                         jnp.int32)))
    # one sample in each of the spp strata
    cnt = np.zeros(spp, int)
    np.add.at(cnt, np.minimum((u * spp).astype(int), spp - 1), 1)
    assert (cnt == 1).all()


def test_bluenoise_masks_are_blue():
    """Each mask is a full ranking (all values distinct) and its power
    spectrum is high-pass (blue): energy in the lowest-frequency band is a
    small fraction of the total."""
    masks = smp._bluenoise_masks()
    assert masks.dtype == np.uint16
    for m in masks[:2]:
        assert len(np.unique(m)) == m.size  # a permutation of ranks
        x = m.astype(np.float64) / 65535.0 - 0.5
        f = np.abs(np.fft.fftshift(np.fft.fft2(x))) ** 2
        c = m.shape[0] // 2
        r = 8
        low = f[c - r:c + r, c - r:c + r].sum() - f[c, c]
        total = f.sum() - f[c, c]
        assert low / total < 0.01, low / total


@pytest.mark.slow
def test_pmj02bn_render_smoke():
    """End-to-end: cornell box with the pmj02bn sampler converges to the
    same mean as zsobol."""
    import jax
    from pbrt_jax import scenes
    from pbrt_jax.integrators import render as rdr
    from pbrt_jax.integrators.path import PathOptions
    scene, cam = scenes.make_cornell_box(width=24, height=24)
    opts = PathOptions(max_depth=3)
    img1, _ = rdr.render(scene, cam, spp=32,
                         sampler=smp.make_sampler("pmj02bn", spp=32,
                                                  full_resolution=(24, 24)),
                         opts=opts)
    img2, _ = rdr.render(scene, cam, spp=32,
                         sampler=smp.make_sampler("zsobol", spp=32,
                                                  full_resolution=(24, 24)),
                         opts=opts)
    np.testing.assert_allclose(img1.mean(), img2.mean(), rtol=0.05)
