"""Object instancing: two-level BVH traversal (reference
cpu/primitive.h:83 TransformedPrimitive; ops/tlas.py)."""
import pytest
import numpy as np
import jax.numpy as jnp

from pbrt_jax import scene_core as sc
from pbrt_jax.utils import spectrum as spc
from pbrt_jax.utils import transform as tfm


def _cube(size=1.0):
    s = size / 2
    V = np.asarray([[-s, -s, -s], [s, -s, -s], [s, s, -s], [-s, s, -s],
                    [-s, -s, s], [s, -s, s], [s, s, s], [-s, s, s]],
                   np.float32)
    F = np.asarray([[0, 1, 2], [0, 2, 3], [4, 6, 5], [4, 7, 6],
                    [0, 4, 5], [0, 5, 1], [3, 2, 6], [3, 6, 7],
                    [0, 3, 7], [0, 7, 4], [1, 5, 6], [1, 6, 2]])
    return V, F


def _scene_with_instances():
    b = sc.SceneBuilder()
    m = b.materials.add_diffuse((0.7, 0.3, 0.3))
    mg = b.materials.add_diffuse((0.5, 0.5, 0.5))
    # world geometry: a floor
    b.add_mesh([[-10, -1, -10], [10, -1, -10], [10, -1, 10], [-10, -1, 10]],
               [[0, 1, 2], [0, 2, 3]], mg)
    V, F = _cube(1.0)
    proto = b.new_prototype()
    b.add_proto_mesh(proto, V, F, m)
    # three instances: translated, translated+scaled, rotated
    b.add_instance(proto, tfm.translate((0, 0, 0)))
    b.add_instance(proto, tfm.translate((3, 0, 0)) @ tfm.scale(0.5, 0.5, 0.5))
    b.add_instance(proto, tfm.translate((-3, 0.0, 0)) @ tfm.rotate(45, (0, 1, 0)))
    b.add_uniform_infinite_light(spc.ConstantSpectrum(1.0))
    return b, m, mg


def test_instance_memory_is_o_prototype():
    b, m, mg = _scene_with_instances()
    scene = b.build(force_bvh=False)
    assert scene.has_instances
    # triangle pool: 2 floor + 12 proto (NOT 2 + 36)
    assert scene.tri_geo.shape[0] == 14
    assert scene.inst_rows.shape[0] == 4  # world + 3 instances


def test_instances_hit_at_transformed_positions():
    b, m, mg = _scene_with_instances()
    scene = b.build(force_bvh=False)
    o = jnp.asarray([[0.0, 0.0, 5.0],    # center cube
                     [3.0, 0.0, 5.0],    # scaled cube
                     [-3.0, 0.0, 5.0],   # rotated cube
                     [6.0, 0.0, 5.0],    # empty space -> floor miss (up)
                     [0.0, -0.99, 5.0]])  # grazing above floor
    d = jnp.tile(jnp.asarray([[0.0, 0.0, -1.0]]), (5, 1))
    r = sc.intersect(scene, o, d, jnp.full((5,), 1e30))
    hit = np.asarray(r["hit"])
    t = np.asarray(r["t"])
    mat = np.asarray(r["mat"])
    assert hit[0] and abs(t[0] - 4.5) < 1e-3 and mat[0] == m
    assert hit[1] and abs(t[1] - 4.75) < 1e-3 and mat[1] == m  # 0.5 cube
    # rotated cube: 45 deg about y -> half-diagonal sqrt(2)/2 toward +z
    assert hit[2] and abs(t[2] - (5 - np.sqrt(2) / 2)) < 1e-3
    assert not hit[3]
    assert not hit[4]


def test_instance_normals_are_world_space():
    b, m, _ = _scene_with_instances()
    scene = b.build(force_bvh=False)
    # hit the rotated cube's face: normal must be the ROTATED face normal
    o = jnp.asarray([[-3.0, 0.0, 5.0]])
    d = jnp.asarray([[0.0, 0.0, -1.0]])
    r = sc.intersect(scene, o, d, jnp.full((1,), 1e30))
    n = np.asarray(r["ng"])[0]
    c = np.cos(np.deg2rad(45))
    # face normal rotated 45 deg about y: +-(c, 0, c) up to winding sign
    assert abs(abs(n[0]) - c) < 1e-3 and abs(abs(n[2]) - c) < 1e-3
    assert abs(n[1]) < 1e-3


def test_instance_shadows():
    b, m, mg = _scene_with_instances()
    scene = b.build(force_bvh=False)
    occ = sc.intersect_p(
        scene,
        jnp.asarray([[0.0, -0.99, 0.0], [6.0, -0.99, 0.0]]),
        jnp.asarray([[0.0, 1.0, 0.0], [0.0, 1.0, 0.0]]),
        jnp.full((2,), 20.0))
    occ = np.asarray(occ)
    assert occ[0] and not occ[1]   # under the cube vs empty sky


@pytest.mark.slow
def test_instanced_render_smoke():
    from pbrt_jax.integrators import render as rdr
    from pbrt_jax.integrators.path import PathOptions
    from pbrt_jax import cameras as cam_mod
    b, m, mg = _scene_with_instances()
    scene = b.build(force_bvh=False)
    cam = cam_mod.make_camera(
        "perspective", fov=50, width=24, height=24,
        camera_from_world=tfm.look_at((0, 2, 8), (0, 0, 0),
                                      (0, 1, 0)).inverse())
    img, _ = rdr.render(scene, cam, spp=4, opts=PathOptions(max_depth=2))
    a = np.asarray(img)
    assert np.isfinite(a).all() and a.max() > 0


def test_parser_object_instance():
    from pbrt_jax.scene import parser
    desc = parser.parse_string('''
Camera "perspective"
Film "rgb" "integer xresolution" [8] "integer yresolution" [8]
WorldBegin
LightSource "infinite"
ObjectBegin "block"
  Material "diffuse" "rgb reflectance" [.7 .3 .3]
  Shape "trianglemesh" "point3 P" [-1 -1 0  1 -1 0  1 1 0  -1 1 0]
      "integer indices" [0 1 2 0 2 3]
ObjectEnd
AttributeBegin
  Translate 0 0 -3
  ObjectInstance "block"
AttributeEnd
AttributeBegin
  Translate 4 0 -3
  ObjectInstance "block"
AttributeEnd
''')
    scene = desc.scene
    assert scene.has_instances
    assert scene.inst_rows.shape[0] == 3   # world + 2 instances
    # the quad is stored once: 1 dummy-or-0 world tris + 2 proto tris
    assert int((np.asarray(scene.tri_shade)[:, 15] >= 0).sum()) >= 2
    # rays hit both instances
    o = jnp.asarray([[0.0, 0.0, 5.0], [4.0, 0.0, 5.0], [8.0, 0.0, 5.0]])
    d = jnp.tile(jnp.asarray([[0.0, 0.0, -1.0]]), (3, 1))
    r = sc.intersect(scene, o, d, jnp.full((3,), 1e30))
    hit = np.asarray(r["hit"])
    assert hit[0] and hit[1] and not hit[2]
