"""Infrastructure: logging, progress, film checkpoint/resume, FileLoc
errors, CLI flags (reference util/log.h, progressreporter.h, options.h:42,
error.h:19)."""
import io
import os

import numpy as np
import jax.numpy as jnp
import pytest

from pbrt_jax.utils import log
from pbrt_jax.utils.progress import ProgressReporter
from pbrt_jax import film as film_mod


def test_log_levels(capsys):
    old = log.get_log_level()
    try:
        log.set_log_level("warning")
        log.info("hidden %d", 1)
        log.warning("shown %d", 2)
        err = capsys.readouterr().err
        assert "shown 2" in err and "hidden" not in err
        log.set_log_level("verbose")
        log.verbose("now visible")
        assert "now visible" in capsys.readouterr().err
    finally:
        log.set_log_level(old)


def test_progress_reporter_output():
    buf = io.StringIO()
    with ProgressReporter(10, title="T", enabled=True, out=buf) as pr:
        for _ in range(10):
            pr.update()
    s = buf.getvalue()
    assert "100.0%" in s and "T:" in s


def test_film_checkpoint_roundtrip(tmp_path):
    film = film_mod.make_film(4, 4)
    film = film_mod.add_samples(
        film, jnp.arange(16, dtype=jnp.int32),
        jnp.ones((16, 3)) * jnp.arange(16)[:, None],
        jnp.full((16,), 0.5))
    pth = str(tmp_path / "ck.npz")
    film_mod.save_checkpoint(film, pth, waves_done=7)
    film2, waves = film_mod.load_checkpoint(pth)
    assert waves == 7
    np.testing.assert_allclose(np.asarray(film.rgb_sum),
                               np.asarray(film2.rgb_sum))
    np.testing.assert_allclose(np.asarray(film.weight_sum),
                               np.asarray(film2.weight_sum))


@pytest.mark.slow
def test_render_resume_equals_straight(tmp_path):
    """A render interrupted at wave k and resumed must equal an
    uninterrupted render (same sampler => same sample set)."""
    from pbrt_jax import scenes, samplers as smp
    from pbrt_jax.integrators import render as rdr
    from pbrt_jax.integrators.path import PathOptions

    scene, cam = scenes.make_furnace_plane(albedo=0.5, width=16, height=16)
    sampler = smp.make_sampler("zsobol", spp=4, full_resolution=(16, 16))
    opts = PathOptions(max_depth=3)
    img_full, _ = rdr.render(scene, cam, sampler=sampler, opts=opts)

    ck = str(tmp_path / "resume.npz")
    # phase 1: render half the waves, persisting the checkpoint
    rdr.render(scene, cam, sampler=sampler, opts=opts, max_waves=2,
               checkpoint_path=ck, checkpoint_every=1)
    assert os.path.exists(ck)
    # phase 2: resume to completion
    img_res, _ = rdr.render(scene, cam, sampler=sampler, opts=opts,
                            checkpoint_path=ck, checkpoint_every=1)
    np.testing.assert_allclose(np.asarray(img_full), np.asarray(img_res),
                               rtol=1e-5, atol=1e-6)


def test_parse_error_carries_file_loc():
    from pbrt_jax.scene import parser
    with pytest.raises(parser.ParseError, match=r"test\.pbrt:3:"):
        parser.parse_string(
            'Camera "perspective"\nWorldBegin\nShape "hyperboloid"\n',
            fname="test.pbrt")


@pytest.mark.slow
def test_cli_end_to_end(tmp_path):
    from pbrt_jax.cmd import main as cli
    scene_file = tmp_path / "t.pbrt"
    scene_file.write_text('''
Film "rgb" "integer xresolution" [8] "integer yresolution" [8]
    "string filename" "%s"
Sampler "zsobol" "integer pixelsamples" [2]
Integrator "path" "integer maxdepth" [2]
Camera "perspective" "float fov" [60]
WorldBegin
LightSource "infinite" "float scale" [1]
AttributeBegin
  Material "diffuse" "rgb reflectance" [0.5 0.5 0.5]
  Shape "trianglemesh"
    "point3 P" [-1 -1 -2  1 -1 -2  1 1 -2  -1 1 -2]
    "integer indices" [0 1 2 0 2 3]
AttributeEnd
''' % (tmp_path / "out.png"))
    rc = cli.main([str(scene_file), "--quiet", "--stats",
                   "--checkpoint", str(tmp_path / "cli_ck.npz")])
    assert rc == 0
    assert (tmp_path / "out.png").exists()
    assert (tmp_path / "cli_ck.npz").exists()


def test_stats_registry_and_pixelstats(tmp_path):
    """STAT_* registry roles (stats.h:88-170) + per-pixel stat images."""
    from pbrt_jax.utils.stats import StatsAccumulator, PixelStats
    import numpy as np
    a = StatsAccumulator()
    a.count("Geometry/Triangles", 10)
    a.memory("BVH/Nodes", 3 << 20)
    a.ratio("Intersections/Hits", 25, 50)
    b = StatsAccumulator()
    b.count("Geometry/Triangles", 5)
    a.merge(b)
    rep = a.report()
    assert "Geometry/Triangles" in rep and "15" in rep
    assert "3.00 MiB" in rep
    assert "(50.00%)" in rep
    ps = PixelStats(4, 4)
    ps.add("visits", np.asarray([0, 0, 5]), np.asarray([1.0, 2.0, 7.0]))
    paths = ps.write(str(tmp_path / "st"))
    from pbrt_jax.utils import image as pimg
    img = pimg.read_exr_channels(paths[0])["Y"]
    assert img[0, 0] == 3.0 and img[1, 1] == 7.0


def test_crash_context_scope(capsys):
    """CheckCallbackScope (reference util/check.h): registered context is
    rendered on demand and unregistered on exit."""
    from pbrt_jax.utils import check
    with check.CheckCallbackScope("outer", lambda: "scene.pbrt"):
        with check.CheckCallbackScope("render", lambda: "wave 3/64"):
            ctx = check.crash_context()
            assert "[render] wave 3/64" in ctx
            assert "[outer] scene.pbrt" in ctx
            # newest first
            assert ctx.index("render") < ctx.index("outer")
    assert check.crash_context() == ""
