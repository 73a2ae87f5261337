"""Curve shape: pre-split Bezier sub-segments + width-aware ray test
(reference shapes.h:1219 Curve, shapes.cpp RecursiveIntersect base case)."""
import pytest
import numpy as np
import jax.numpy as jnp

from pbrt_jax.ops import curves as crv
from pbrt_jax import scene_core as sc


def test_bezier_eval_endpoints():
    cp = np.asarray([[0, 0, 0], [1, 1, 0], [2, -1, 0], [3, 0, 0]], np.float32)
    p = crv.bezier_eval(cp, np.asarray([0.0, 1.0]))
    np.testing.assert_allclose(p[0], cp[0], atol=1e-6)
    np.testing.assert_allclose(p[1], cp[3], atol=1e-6)


def test_straight_curve_hit_within_width():
    """A straight 'curve' along x is a ribbon of known width: rays down z
    hit iff |y| < width/2 and 0 <= x <= length."""
    cp = np.asarray([[0, 0, 0], [1, 0, 0], [2, 0, 0], [3, 0, 0]], np.float32)
    rows, lo, hi = crv.split_curve(cp, 0.2, 0.2, depth=2)
    segs = jnp.asarray(rows)
    n = 7
    xs = np.linspace(0.2, 2.8, n).astype(np.float32)
    for y, want in ((0.0, True), (0.09, True), (0.11, False), (0.5, False)):
        o = jnp.asarray(np.stack([xs, np.full(n, y), np.full(n, 3.0)], -1))
        d = jnp.tile(jnp.asarray([[0.0, 0.0, -1.0]]), (n, 1))
        # test against every sub-segment directly
        hit_any = np.zeros(n, bool)
        for si in range(rows.shape[0]):
            seg = jnp.tile(segs[si][None], (n, 1))
            r = crv._segment_test(o, d, jnp.full((n,), 1e30), seg)
            hit_any |= np.asarray(r["hit"])
        assert hit_any.all() == want and hit_any.any() == want, (y, hit_any)


def test_curve_u_parameter_monotone():
    cp = np.asarray([[0, 0, 0], [1, 0, 0], [2, 0, 0], [3, 0, 0]], np.float32)
    rows, _, _ = crv.split_curve(cp, 0.3, 0.3, depth=3)
    segs = jnp.asarray(rows)
    xs = np.linspace(0.1, 2.9, 9).astype(np.float32)
    n = xs.size
    o = jnp.asarray(np.stack([xs, np.zeros(n), np.full(n, 3.0)], -1))
    d = jnp.tile(jnp.asarray([[0.0, 0.0, -1.0]]), (n, 1))
    u_hit = np.full(n, -1.0)
    for si in range(rows.shape[0]):
        seg = jnp.tile(segs[si][None], (n, 1))
        r = crv._segment_test(o, d, jnp.full((n,), 1e30), seg)
        m = np.asarray(r["hit"])
        u_hit[m] = np.asarray(r["u"])[m]
    assert (u_hit >= 0).all()
    assert (np.diff(u_hit) > 0).all()        # u grows along the curve
    np.testing.assert_allclose(u_hit, xs / 3.0, atol=0.05)


@pytest.mark.slow
def test_scene_with_curves_renders_and_occludes():
    """Full scene path: curve BVH closest-hit + shadow occlusion."""
    from pbrt_jax.utils import spectrum as spc
    b = sc.SceneBuilder()
    m = b.materials.add_diffuse((0.8, 0.2, 0.2))
    # arc over the origin
    b.add_curve([[-1, 0.5, 0], [-0.3, 1.2, 0], [0.3, 1.2, 0], [1, 0.5, 0]],
                0.3, 0.3, m, curve_type="cylinder", subdiv=3)
    mg = b.materials.add_diffuse((0.6, 0.6, 0.6))
    b.add_mesh([[-5, -1, -5], [5, -1, -5], [5, -1, 5], [-5, -1, 5]],
               [[0, 1, 2], [0, 2, 3]], mg)
    b.add_uniform_infinite_light(spc.ConstantSpectrum(1.0))
    scene = b.build(force_bvh=False)
    assert scene.has_curves

    # direct intersect: ray through the arc top
    o = jnp.asarray([[0.0, 1.0, 3.0], [0.0, 3.0, 3.0]])
    d = jnp.asarray([[0.0, 0.0, -1.0], [0.0, 0.0, -1.0]])
    r = sc.intersect(scene, o, d, jnp.full((2,), 1e30))
    hits = np.asarray(r["hit"])
    assert hits[0] and not hits[1]
    assert int(np.asarray(r["mat"])[0]) == m

    # occlusion: vertical shadow ray from the floor under the curve is
    # blocked; one off to the side is not
    oc = sc.intersect_p(scene,
                        jnp.asarray([[0.0, -0.9, 0.0], [3.0, -0.9, 0.0]]),
                        jnp.asarray([[0.0, 1.0, 0.0], [0.0, 1.0, 0.0]]),
                        jnp.full((2,), 10.0))
    occ = np.asarray(oc)
    assert occ[0] and not occ[1]


def test_parser_curve_shape():
    from pbrt_jax.scene import parser
    desc = parser.parse_string('''
Camera "perspective"
Film "rgb" "integer xresolution" [8] "integer yresolution" [8]
WorldBegin
LightSource "infinite"
Material "diffuse" "rgb reflectance" [.6 .3 .3]
Shape "curve" "point3 P" [0 0 0  1 1 0  2 1 0  3 0 0]
    "float width0" [0.1] "float width1" [0.05] "string type" "cylinder"
''')
    assert desc.scene.has_curves
    assert desc.scene.curve_segs.shape[0] >= 8
