"""Film variance channels, multi-channel EXR, spectral film output
(reference film.h:319 GBufferFilm / :401 SpectralFilm)."""
import numpy as np
import jax.numpy as jnp

from pbrt_jax import film as film_mod
from pbrt_jax.utils import image as pimg


def test_variance_channels_track_welford():
    film = film_mod.make_film(2, 1)
    vals = [0.2, 0.8, 0.5, 0.1]
    for v in vals:
        film = film_mod.add_samples(
            film, jnp.asarray([0], jnp.int32),
            jnp.asarray([[v, v, v]]), jnp.asarray([1.0]))
    var = film_mod.get_variance_image(film)
    lum = [0.2126 * v + 0.7152 * v + 0.0722 * v for v in vals]
    want = np.var(lum, ddof=1)
    np.testing.assert_allclose(var[0, 0], want, rtol=1e-4)
    assert var[0, 1] == 0.0  # untouched pixel


def test_multichannel_exr_roundtrip_rgb(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 4, (9, 13, 3)).astype(np.float32)
    p = str(tmp_path / "t.exr")
    pimg.write_exr_channels(p, {"R": img[..., 0], "G": img[..., 1],
                                "B": img[..., 2]})
    back = pimg.read_exr(p)
    np.testing.assert_allclose(back, img, rtol=1e-6)


def test_spectral_exr_writes(tmp_path):
    from pbrt_jax.integrators import aov
    rng = np.random.default_rng(1)
    buckets = rng.uniform(0, 1, (6, 7, 4)).astype(np.float32)
    edges = np.linspace(360, 830, 5)
    p = str(tmp_path / "spec.exr")
    aov.write_spectral_exr(p, buckets, edges)
    import os
    assert os.path.getsize(p) > 100


def test_gbuffer_exr_writes(tmp_path):
    from pbrt_jax.integrators import aov
    H, W = 5, 6
    aovs = dict(p=np.zeros((H, W, 3)), n=np.zeros((H, W, 3)),
                ns=np.zeros((H, W, 3)), uv=np.zeros((H, W, 2)),
                z=np.zeros((H, W)), albedo=np.zeros((H, W, 3)))
    p = str(tmp_path / "g.exr")
    aov.write_gbuffer_exr(p, aovs, variance=np.ones((H, W)))
    import os
    assert os.path.getsize(p) > 100
