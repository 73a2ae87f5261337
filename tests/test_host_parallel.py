"""Host-side task parallelism (role of util/parallel.h ThreadPool +
parallel Import parsing parser.cpp:771-808)."""
import numpy as np

from pbrt_jax.parallel import host as phost


def test_parallel_map_preserves_order():
    out = phost.parallel_map(lambda x: x * x, range(50))
    assert out == [x * x for x in range(50)]


def test_run_async_future():
    f = phost.run_async(sum, [1, 2, 3])
    assert f.result() == 6


def test_include_prefetch_parses(tmp_path):
    """Included files are tokenized on the pool and spliced identically."""
    inc = tmp_path / "geo.pbrt"
    inc.write_text('Material "diffuse" "rgb reflectance" [0.8 0.1 0.1]\n'
                   'Shape "sphere" "float radius" [1]\n')
    main = tmp_path / "scene.pbrt"
    main.write_text(
        'Camera "perspective"\n'
        'Film "rgb" "integer xresolution" [16] "integer yresolution" [16]\n'
        'WorldBegin\n'
        'LightSource "infinite" "rgb L" [1 1 1]\n'
        'Translate 0 0 4\n'
        'Include "geo.pbrt"\n')
    from pbrt_jax.scene.parser import parse_file
    desc = parse_file(str(main))
    assert desc.scene.n_spheres > 0 or desc.scene.tri_p0.shape[0] > 1


def test_ply_prefetch_warms_cache(tmp_path):
    from pbrt_jax.scene import plyio
    v = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    f = np.array([[0, 1, 2]], np.int32)
    ply = tmp_path / "m.ply"
    plyio.write_ply(str(ply), v, f)
    scene = tmp_path / "s.pbrt"
    scene.write_text(
        'Camera "perspective"\n'
        'WorldBegin\nLightSource "infinite" "rgb L" [1 1 1]\n'
        f'Shape "plymesh" "string filename" "m.ply"\n')
    from pbrt_jax.scene.parser import parse_file
    desc = parse_file(str(scene))
    assert desc.scene.tri_p0.shape[0] >= 1
