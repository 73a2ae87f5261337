"""pspec sampler power-spectrum tool (reference cmd/pspec.cpp:260)."""
import json

import numpy as np


def test_low_discrepancy_suppresses_low_frequencies(capsys):
    """Sobol'-family samplers must have much less low-frequency energy
    than independent sampling (the whole point of the diagnostic)."""
    from pbrt_jax.cmd import pspec
    stats = {}
    for kind in ("independent", "zsobol"):
        pts = pspec.sampler_points(kind, spp=64, runs=8)
        spec = pspec.power_spectrum(pts, res=65)
        c = 65 // 2
        yy, xx = np.meshgrid(np.arange(65) - c, np.arange(65) - c,
                             indexing="ij")
        r = np.sqrt(xx ** 2 + yy ** 2)
        ring = (r > 1) & (r < 4)
        stats[kind] = float(spec[ring].mean())
    # independent sampling is flat white noise (~1); zsobol kills low freq
    assert stats["zsobol"] < 0.35 * stats["independent"]
    assert 0.5 < stats["independent"] < 2.0


def test_pspec_cli(tmp_path, capsys):
    from pbrt_jax.cmd import pspec
    out = str(tmp_path / "s.png")
    assert pspec.main(["--sampler", "stratified", "--spp", "16",
                       "--runs", "4", "--res", "33",
                       "--outfile", out]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["spp"] == 16
    import os
    assert os.path.exists(out)
