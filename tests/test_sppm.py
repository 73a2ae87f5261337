"""SPPM integrator (reference cpu/integrators.h:436 SPPMIntegrator):
progressive photon mapping must converge toward the path-traced image."""
import numpy as np
import pytest

from pbrt_jax import scenes, samplers as smp
from pbrt_jax.integrators import render as rdr, sppm
from pbrt_jax.integrators.path import PathOptions


@pytest.mark.slow
def test_sppm_matches_path_on_cornell():
    scene, cam = scenes.make_cornell_box(width=32, height=32)
    opts = PathOptions(max_depth=4)
    s = smp.make_sampler("independent", spp=64, full_resolution=(32, 32))
    img_p, _ = rdr.render(scene, cam, sampler=s, opts=opts,
                          integrator="path")
    img_s, st = sppm.render_sppm(scene, cam, n_iterations=24, max_depth=4,
                                 seed=1)
    # search radius must shrink from its initial value
    r0 = 2.0 * float(scene.scene_radius) / 32
    assert st["mean_radius"] < r0
    # dropped (K-overflow) photon deposits stay a bounded fraction of the
    # per-iteration photon count (dense cells at this tiny resolution)
    assert st["dropped"] < 0.25 * 24 * 32 * 32
    r = img_s.mean() / img_p.mean()
    assert abs(r - 1.0) < 0.10, r
    assert abs(img_s[..., 0].mean() / img_p[..., 0].mean() - 1.0) < 0.10
    assert abs(img_s[..., 1].mean() / img_p[..., 1].mean() - 1.0) < 0.10
    # density-estimation blur bleeds into the dim blue channel at this
    # resolution: loose bound only
    assert abs(img_s[..., 2].mean() / img_p[..., 2].mean() - 1.0) < 0.35
    # spatial structure: block means correlate strongly
    bp = img_p.reshape(8, 4, 8, 4, 3).mean(axis=(1, 3, 4))
    bs = img_s.reshape(8, 4, 8, 4, 3).mean(axis=(1, 3, 4))
    corr = np.corrcoef(bp.reshape(-1), bs.reshape(-1))[0, 1]
    assert corr > 0.95, corr
