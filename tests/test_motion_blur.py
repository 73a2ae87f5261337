"""Animated instances / motion blur (reference transform.h:444
AnimatedTransform + cpu/primitive.h:103 AnimatedPrimitive)."""
import numpy as np
import jax.numpy as jnp
import pytest

from pbrt_jax import scene_core as sc
from pbrt_jax.utils import spectrum as spc
from pbrt_jax.utils import transform as tfm


def _animated_scene():
    b = sc.SceneBuilder()
    m = b.materials.add_diffuse((0.8, 0.2, 0.2))
    proto = b.new_prototype()
    b.add_proto_mesh(proto, [[-0.5, -0.5, 0], [0.5, -0.5, 0],
                             [0.5, 0.5, 0], [-0.5, 0.5, 0]],
                     [[0, 1, 2], [0, 2, 3]], m)
    # quad sweeps from x=0 to x=4 over the shutter
    b.add_instance(proto, tfm.translate((0, 0, 0)),
                   object_to_world_end=tfm.translate((4, 0, 0)))
    b.add_uniform_infinite_light(spc.ConstantSpectrum(1.0))
    return b.build(force_bvh=False)


@pytest.mark.slow
def test_animated_instance_interpolates_with_time():
    scene = _animated_scene()
    o = jnp.tile(jnp.asarray([[0.0, 0.0, 5.0]]), (3, 1))
    d = jnp.tile(jnp.asarray([[0.0, 0.0, -1.0]]), (3, 1))
    tmax = jnp.full((3,), 1e30)
    for t, want in ((0.0, True), (0.5, False), (1.0, False)):
        r = sc.intersect(scene, o, d, tmax,
                         time=jnp.full((3,), t, jnp.float32))
        assert bool(r["hit"][0]) == want, (t, want)
    # at time 0.5 the quad is at x=2: a ray at x=2 hits then
    o2 = jnp.asarray([[2.0, 0.0, 5.0]])
    d2 = jnp.asarray([[0.0, 0.0, -1.0]])
    r = sc.intersect(scene, o2, d2, jnp.full((1,), 1e30),
                     time=jnp.full((1,), 0.5, jnp.float32))
    assert bool(r["hit"][0])
    assert abs(float(r["t"][0]) - 5.0) < 1e-3


def test_animated_shadows_move():
    scene = _animated_scene()
    o = jnp.asarray([[0.0, 0.0, 5.0], [4.0, 0.0, 5.0]])
    d = jnp.tile(jnp.asarray([[0.0, 0.0, -1.0]]), (2, 1))
    occ0 = sc.intersect_p(scene, o, d, jnp.full((2,), 20.0),
                          time=jnp.zeros((2,), jnp.float32))
    occ1 = sc.intersect_p(scene, o, d, jnp.full((2,), 20.0),
                          time=jnp.ones((2,), jnp.float32))
    assert bool(occ0[0]) and not bool(occ0[1])
    assert not bool(occ1[0]) and bool(occ1[1])


@pytest.mark.slow
def test_motion_blur_render_streaks():
    """A fast-moving quad renders as a streak: pixels across the sweep
    each get partial coverage."""
    from pbrt_jax.integrators import render as rdr
    from pbrt_jax.integrators.path import PathOptions
    from pbrt_jax import cameras as cam_mod
    scene = _animated_scene()
    cam = cam_mod.make_camera(
        "perspective", fov=60, width=48, height=16,
        camera_from_world=tfm.look_at((2, 0, 6), (2, 0, 0),
                                      (0, 1, 0)).inverse())
    img, _ = rdr.render(scene, cam, spp=128,
                        opts=PathOptions(max_depth=2))
    a = np.asarray(img)
    # the quad reflects almost no blue: motion blur shows as a partial
    # blue DEFICIT across the swept band (row 8) vs pure sky (row 1),
    # partial (blurred) rather than the full deficit of a static quad
    deficit = 1.0 - a[8, :, 2] / np.maximum(a[1, :, 2], 1e-6)
    band = deficit[19:29]     # the swept region at this camera framing
    assert (band > 0.05).mean() > 0.7         # spread across the band
    assert 0.05 < band.mean() < 0.8           # partial coverage, not solid
    # sky edges unaffected
    assert np.abs(deficit[[0, 1, 46, 47]]).max() < 0.1


@pytest.mark.slow
def test_parser_active_transform_animates_instance():
    from pbrt_jax.scene import parser
    desc = parser.parse_string('''
Camera "perspective"
Film "rgb" "integer xresolution" [8] "integer yresolution" [8]
WorldBegin
LightSource "infinite"
ObjectBegin "q"
  Material "diffuse"
  Shape "trianglemesh" "point3 P" [-0.5 -0.5 0  0.5 -0.5 0  0.5 0.5 0  -0.5 0.5 0]
      "integer indices" [0 1 2 0 2 3]
ObjectEnd
AttributeBegin
  ActiveTransform StartTime
  Translate 0 0 0
  ActiveTransform EndTime
  Translate 4 0 0
  ActiveTransform All
  ObjectInstance "q"
AttributeEnd
''')
    scene = desc.scene
    assert scene.has_instances
    # instance row 26 flags motion on exactly one instance
    ir = np.asarray(scene.inst_rows)
    assert (ir[:, 26] > 0.5).sum() == 1
    o = jnp.asarray([[0.0, 0.0, 5.0], [4.0, 0.0, 5.0]])
    d = jnp.tile(jnp.asarray([[0.0, 0.0, -1.0]]), (2, 1))
    r0 = sc.intersect(scene, o, d, jnp.full((2,), 1e30),
                      time=jnp.zeros((2,), jnp.float32))
    r1 = sc.intersect(scene, o, d, jnp.full((2,), 1e30),
                      time=jnp.ones((2,), jnp.float32))
    assert bool(r0["hit"][0]) and not bool(r0["hit"][1])
    assert not bool(r1["hit"][0]) and bool(r1["hit"][1])


def test_animated_rotation_stays_rigid():
    """TRS slerp (reference AnimatedTransform transform.h:444): a 90-degree
    rotation interpolated at t=0.5 must remain a RIGID rotation — the
    linear matrix blend this replaced shrinks vectors to ~0.707 of their
    length at the halfway point."""
    import numpy as np
    import jax.numpy as jnp
    from pbrt_jax.ops import tlas as tlas_mod

    c, s = np.cos(np.pi / 2), np.sin(np.pi / 2)
    o2w0 = np.asarray([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0]],
                      np.float32)
    o2w1 = np.asarray([[c, 0, s, 0], [0, 1, 0, 0], [-s, 0, c, 0]],
                      np.float32)
    rows = np.zeros((1, tlas_mod.INST_COLS), np.float32)
    rows[0, 12:24] = o2w0.reshape(-1)
    rows[0, 26] = 1.0
    rows[0, 28:40] = o2w1.reshape(-1)
    q0, S0 = tlas_mod._decompose_trs(o2w0)
    q1, S1 = tlas_mod._decompose_trs(o2w1)
    if np.dot(q0, q1) < 0:
        q1 = -q1
    rows[0, 40:44] = q0
    rows[0, 44:48] = q1
    rows[0, 48:57] = S0.reshape(-1)
    rows[0, 57:66] = S1.reshape(-1)
    irow = jnp.asarray(rows)
    A = np.asarray(tlas_mod.lerp_inst_o2w(irow, jnp.asarray([0.5])))[0]
    p = np.asarray([1.0, 0.0, 0.0])
    v = A[:, :3] @ p
    # rigid: |v| == 1 (matrix lerp gives 0.7071); halfway = 45 degrees
    # along the keyframe arc x -> (0, 0, -1)
    np.testing.assert_allclose(np.linalg.norm(v), 1.0, atol=1e-4)
    np.testing.assert_allclose(v, [np.sqrt(0.5), 0.0, -np.sqrt(0.5)],
                               atol=1e-4)
    # endpoints reproduce the keyframes exactly
    A0 = np.asarray(tlas_mod.lerp_inst_o2w(irow, jnp.asarray([0.0])))[0]
    A1 = np.asarray(tlas_mod.lerp_inst_o2w(irow, jnp.asarray([1.0])))[0]
    np.testing.assert_allclose(A0, o2w0, atol=1e-5)
    np.testing.assert_allclose(A1, o2w1, atol=1e-5)
