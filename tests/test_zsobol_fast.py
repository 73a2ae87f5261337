"""Fast (arithmetic base-2 Owen) ZSobol index shuffle properties."""
import numpy as np
import jax.numpy as jnp

from pbrt_jax import samplers as smp


def test_fast_shuffle_is_bijective():
    """The shuffled index must be a permutation of the full index space
    (nested uniform scrambles are triangular bit maps -> bijective)."""
    params = smp.make_sampler("zsobol", spp=4, full_resolution=(4, 4))
    B = smp._zsobol_index_bits(params)
    px, py, si = np.meshgrid(np.arange(4), np.arange(4), np.arange(4),
                             indexing="ij")
    for dim in (0, 3, 11):
        idx = np.asarray(smp._zsobol_sample_index_fast(
            params, jnp.asarray(px.ravel()), jnp.asarray(py.ravel()),
            jnp.asarray(si.ravel()), jnp.int32(dim)))
        assert np.unique(idx).size == idx.size
        assert idx.max() < (1 << B)


def test_fast_shuffle_preserves_pixel_stratification():
    """Per-pixel 2D points from the shuffled Sobol' index must remain
    stratified over the 4x4 elementary grid at spp=16 (the nested shuffle
    maps the pixel's index block to a valid Sobol' subsequence)."""
    spp = 16
    params = smp.make_sampler("zsobol", spp=spp, full_resolution=(16, 16))
    si = jnp.arange(spp, dtype=jnp.int32)
    for (px, py) in ((0, 0), (7, 3), (15, 15)):
        u = np.asarray(smp.sample_2d(
            params, jnp.full((spp,), px, jnp.int32),
            jnp.full((spp,), py, jnp.int32), si, jnp.int32(2)))
        # each of the 16 4x4 cells must contain exactly one point
        cells = (np.floor(u[:, 0] * 4).astype(int) * 4 +
                 np.floor(u[:, 1] * 4).astype(int))
        assert np.unique(cells).size == spp
