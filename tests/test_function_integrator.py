"""Function integrator (reference cpu/integrators.cpp:3435 FunctionIntegrator):
sampler convergence measurement on analytic [0,1)^2 test functions."""
import numpy as np
import pytest

from pbrt_jax.integrators import function as fn


@pytest.mark.parametrize("name", sorted(fn.FUNCTIONS))
def test_every_function_integrates_to_one(name):
    rows, avg = fn.run(function=name, sampler="zsobol", spp=64,
                       resolution=(16, 16))
    assert 0.99 < avg < 1.01, (name, avg)
    # MSE decreases with sample count
    assert rows[-1][1] <= rows[0][1]


def test_qmc_beats_independent_on_smooth_function():
    rows_i, _ = fn.run(function="gaussian", sampler="independent", spp=64,
                       resolution=(16, 16))
    rows_z, _ = fn.run(function="gaussian", sampler="zsobol", spp=64,
                       resolution=(16, 16))
    assert rows_z[-1][1] < rows_i[-1][1] / 4


def test_skip_bad_rules():
    assert fn._good_spp(16, "zsobol") and not fn._good_spp(12, "zsobol")
    assert fn._good_spp(9, "stratified") and not fn._good_spp(8, "stratified")
    assert fn._good_spp(6, "halton") and not fn._good_spp(8, "halton")
    assert fn._good_spp(36, "halton")
    assert fn._good_spp(7, "independent")


def test_cli_scene_file(tmp_path, monkeypatch):
    scene = tmp_path / "fn.pbrt"
    out = tmp_path / "mse.txt"
    scene.write_text(
        'Film "rgb" "integer xresolution" [8] "integer yresolution" [8]\n'
        'Sampler "zsobol" "integer pixelsamples" [16]\n'
        f'Integrator "function" "string function" "disk" '
        f'"string filename" "{out}"\n'
        'WorldBegin\n')
    from pbrt_jax.cmd import main as cli
    assert cli.main([str(scene)]) == 0
    rows = [line.split() for line in out.read_text().splitlines()]
    assert rows and float(rows[-1][1]) < 0.2
