"""Loop subdivision, noise variants, PLY buffer cache (reference
shapes loopsubdiv, util/noise.cpp, util/buffercache.h:33)."""
import numpy as np
import jax.numpy as jnp

from pbrt_jax.utils.subdivision import loop_subdivide


def _octahedron():
    V = np.asarray([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
                    [0, 0, 1], [0, 0, -1]], np.float32)
    F = np.asarray([[0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4],
                    [2, 0, 5], [1, 2, 5], [3, 1, 5], [0, 3, 5]])
    return V, F


def test_loop_subdivide_counts_and_smoothing():
    V, F = _octahedron()
    V2, F2 = loop_subdivide(V, F, 1)
    assert F2.shape[0] == 4 * F.shape[0]
    # octahedron: 6 verts + 12 edges = 18
    assert V2.shape[0] == 18
    # subdivision pulls vertices inward toward the limit sphere of smaller
    # radius: all radii shrink but stay positive and mutually closer
    r = np.linalg.norm(V2, axis=-1)
    assert r.max() < 1.0 and r.min() > 0.5
    assert (r.max() - r.min()) < 0.35
    # more levels refine without blowing up: 8 * 4^3 faces, tight radii
    V3, F3 = loop_subdivide(V, F, 3)
    assert F3.shape[0] == 8 * 64
    r3 = np.linalg.norm(V3, axis=-1)
    assert (r3.max() - r3.min()) / r3.mean() < 0.1


def test_loop_boundary_preserved():
    # single triangle: all edges are boundary; vertices use the 3/4-1/8
    # rule and edge points are midpoints
    V = np.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    F = np.asarray([[0, 1, 2]])
    V2, F2 = loop_subdivide(V, F, 1)
    assert F2.shape[0] == 4
    # midpoints present
    mids = {(0.5, 0.0, 0.0), (0.0, 0.5, 0.0), (0.5, 0.5, 0.0)}
    got = {tuple(np.round(v, 4)) for v in V2[3:]}
    assert mids == got


def test_turbulence_positive_and_rougher_than_fbm():
    from pbrt_jax import textures as tex
    rng = np.random.default_rng(0)
    p = jnp.asarray(rng.uniform(-3, 3, (256, 3)), jnp.float32)
    t = np.asarray(tex.turbulence(p, 6, 0.5))
    f = np.asarray(tex.fbm(p, 6, 0.5))
    assert (t >= 0).all()
    assert t.mean() > abs(f.mean())  # |noise| sums up, signed noise cancels


def test_windy_wrinkled_textures_eval():
    from pbrt_jax import textures as tex
    tb = tex.TextureBuilder()
    iw = tb.add_windy()
    ir = tb.add_wrinkled()
    pool = tb.build()
    uv = jnp.asarray([[0.3, 0.7], [0.9, 0.1]])
    pw = jnp.asarray([[0.5, 1.0, 2.0], [3.0, -1.0, 0.5]])
    for idx in (iw, ir):
        c, s = tex.eval_texture(pool, jnp.full((2,), idx, jnp.int32), uv,
                                p_world=pw)
        assert np.isfinite(np.asarray(s)).all()
        assert (np.asarray(s) >= 0).all()


def test_ply_cache_dedups(tmp_path):
    from pbrt_jax.scene import plyio
    V = np.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    F = np.asarray([[0, 1, 2]])
    p = str(tmp_path / "t.ply")
    plyio.write_ply(p, V, F)
    a = plyio.read_ply(p)
    b = plyio.read_ply(p)
    assert a is b  # same cached object (BufferCache role)


def test_parser_loopsubdiv():
    from pbrt_jax.scene import parser
    desc = parser.parse_string('''
Camera "perspective"
Film "rgb" "integer xresolution" [8] "integer yresolution" [8]
WorldBegin
LightSource "infinite"
Material "diffuse"
Shape "loopsubdiv" "integer levels" [2]
    "point3 P" [1 0 0  -1 0 0  0 1 0  0 -1 0  0 0 1  0 0 -1]
    "integer indices" [0 2 4  2 1 4  1 3 4  3 0 4  2 0 5  1 2 5  3 1 5  0 3 5]
''')
    # 8 faces x 4^2 = 128 triangles
    assert desc.scene.tri_p0.shape[0] == 128


def test_dots_texture_two_values_cell_coverage():
    from pbrt_jax import textures as tex
    tb = tex.TextureBuilder()
    idx = tb.add_dots((1.0, 0.0, 0.0), (0.0, 0.0, 1.0))
    pool = tb.build()
    rng = np.random.default_rng(1)
    uv = jnp.asarray(rng.uniform(0, 8, (4096, 2)), jnp.float32)
    c, s = tex.eval_texture(pool, jnp.zeros((4096,), jnp.int32) + idx, uv)
    # both dot and background regions appear, dots cover a minority
    red = np.asarray(c)[:, 0]
    frac = (red > np.median(red)).mean()
    reds = np.unique(np.round(np.asarray(c)[:, 0], 3))
    assert len(reds) == 2
    # area fraction of radius-0.35 dots = pi*0.35^2 ~ 0.385
    in_dot = np.round(np.asarray(c)[:, 0], 3) == reds.max()
    assert 0.25 < in_dot.mean() < 0.5
