"""MLT integrator (reference cpu/integrators.h:384 MLTIntegrator,
PSSMLT over BDPT): chain-averaged splats must converge to the path-traced
image with the bootstrap normalization b."""
import numpy as np
import pytest

from pbrt_jax import scenes, samplers as smp
from pbrt_jax.integrators import render as rdr, mlt
from pbrt_jax.integrators.path import PathOptions


def test_table_width_covers_dims():
    assert mlt._table_width(1) > 20
    assert mlt._table_width(5) > mlt._table_width(2)


@pytest.mark.slow
def test_mlt_matches_path_on_cornell():
    scene, cam = scenes.make_cornell_box(width=32, height=32)
    opts = PathOptions(max_depth=4)
    s = smp.make_sampler("independent", spp=96, full_resolution=(32, 32))
    img_p, _ = rdr.render(scene, cam, sampler=s, opts=opts,
                          integrator="path")
    img_m, st = mlt.render_mlt(scene, cam, max_depth=4, n_chains=8192,
                               n_bootstrap=65536, mutations_per_pixel=160,
                               seed=3)
    # bootstrap normalization is a direct luminance estimate
    assert st["b"] > 0
    assert 0.2 < st["acceptance"] < 0.95
    r = img_m.mean() / img_p.mean()
    assert abs(r - 1.0) < 0.12, r
    # bright channels converge reasonably; dim blue gets a looser bound
    assert abs(img_m[..., 0].mean() / img_p[..., 0].mean() - 1.0) < 0.12
    assert abs(img_m[..., 1].mean() / img_p[..., 1].mean() - 1.0) < 0.12
    assert abs(img_m[..., 2].mean() / img_p[..., 2].mean() - 1.0) < 0.3


def test_mlt_replay_deterministic():
    """replay() (reference DebugMLTSampler role): the same PSS vector
    reproduces the same contribution bit-for-bit, and perturbing the film
    dims moves the raster position."""
    import numpy as np
    from pbrt_jax import scenes
    from pbrt_jax.integrators import mlt as mlt_mod
    scene, cam = scenes.make_cornell_box(width=32, height=32)
    rng = np.random.default_rng(3)
    vec = rng.random(mlt_mod._table_width(3)).astype(np.float32)
    a = mlt_mod.replay(scene, cam, vec, max_depth=3)
    b = mlt_mod.replay(scene, cam, vec, max_depth=3)
    assert a["y"] == b["y"]
    np.testing.assert_array_equal(a["rgb"], b["rgb"])
    # a fully different PSS vector describes a different path: some
    # observable (radiance or raster position) must move
    vec2 = rng.random(mlt_mod._table_width(3)).astype(np.float32)
    c = mlt_mod.replay(scene, cam, vec2, max_depth=3)
    assert (a["y"] != c["y"]
            or not np.allclose(a["p_raster"], c["p_raster"]))
    assert np.isfinite(a["rgb"]).all() and a["y"] >= 0.0
