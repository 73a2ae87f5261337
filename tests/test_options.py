"""Layered options (reference options.h BasicPBRTOptions + Option directive
scene.cpp:492)."""
import numpy as np
import pytest

from pbrt_jax.options import get_options, reset_options


def test_option_directive_writes_globals():
    reset_options()
    from pbrt_jax.scene.parser import parse_string
    parse_string('Option "integer seed" [7] "bool disablepixeljitter" true\n'
                 'Camera "perspective"\nWorldBegin\n'
                 'LightSource "infinite" "rgb L" [1 1 1]\n'
                 'Shape "sphere" "float radius" [1]\n')
    o = get_options()
    assert o.seed == 7
    assert o.disable_pixel_jitter is True
    reset_options()


def test_disable_jitters_make_waves_deterministic():
    reset_options()
    from pbrt_jax import scenes, samplers as smp
    from pbrt_jax.integrators import render as rdr
    from pbrt_jax.integrators.path import PathOptions
    scene, cam = scenes.make_cornell_box(width=16, height=16)
    s = smp.make_sampler("independent", spp=1, full_resolution=(16, 16))
    o = get_options()
    o.disable_pixel_jitter = True
    o.disable_wavelength_jitter = True
    try:
        img1, _ = rdr.render(scene, cam, sampler=s,
                             opts=PathOptions(max_depth=2))
        img2, _ = rdr.render(scene, cam, sampler=s,
                             opts=PathOptions(max_depth=2))
        np.testing.assert_array_equal(img1, img2)
    finally:
        reset_options()
