"""Scene parser tests (reference parser_test.cpp patterns + end-to-end)."""
from pathlib import Path

import numpy as np
import pytest

from pbrt_jax.scene import parser as pp
from pbrt_jax.scene import plyio

DATA = Path(__file__).parent / "data"


def test_tokenizer():
    toks = pp.tokenize(b'Shape "trianglemesh" # comment\n "point3 P" [ 0 1 2.5 ]')
    assert toks == ['Shape', '"trianglemesh"', '"point3 P"', '[', 0.0, 1.0, 2.5, ']']


def test_native_and_python_tokenizers_agree():
    src = (b'LookAt 1 2 3 0 0 0 0 1 0 # comment\n'
           b'Material "diffuse" "rgb reflectance" [.5 .5 .5]\n'
           b'Shape "sphere" "float radius" [-1.5e2]')
    from pbrt_jax.native import tokenize_native
    nat = tokenize_native(src)
    if nat is None:
        import pytest
        pytest.skip("native tokenizer unavailable")
    # python fallback path
    import re
    out = []
    for m in pp._TOKEN_RE.finditer(src):
        t = m.group(0)
        if t.startswith(b"#"):
            continue
        tok = t.decode()
        if tok not in ("[", "]") and not tok.startswith('"'):
            try:
                out.append(float(tok))
                continue
            except ValueError:
                pass
        out.append(tok)
    assert nat == out


def test_tokenizer_strings_with_spaces():
    toks = pp.tokenize(b'"string filename" "my file.exr"')
    assert toks == ['"string filename"', '"my file.exr"']


def test_parse_cornell():
    desc = pp.parse_file(DATA / "cornell-box.pbrt")
    assert desc.scene.tri_p0.shape[0] == 14  # 7 quads
    assert desc.camera.width == 64
    assert desc.integrator["max_depth"] == 5
    assert desc.sampler.spp == 16
    assert desc.scene.lights.packed.shape[0] == 2  # area light split per tri
    assert desc.film_params["filename"] == "cornell.exr"


@pytest.mark.slow
def test_parse_and_render_cornell():
    import jax
    desc = pp.parse_file(DATA / "cornell-box.pbrt")
    from pbrt_jax.integrators import render as rdr
    from pbrt_jax.integrators.path import PathOptions
    from pbrt_jax import samplers as smp
    img, _ = rdr.render(desc.scene, desc.camera, spp=4,
                        sampler=smp.make_sampler("zsobol", spp=4,
                                                 full_resolution=(64, 64)),
                        opts=PathOptions(max_depth=4))
    assert np.isfinite(img).all()
    assert img.max() > 0.5
    # red wall left, green right (as in scenes.make_cornell_box)
    left = img[:, :10].mean(axis=(0, 1))
    right = img[:, -10:].mean(axis=(0, 1))
    assert left[0] / max(left[1], 1e-6) > right[0] / max(right[1], 1e-6)


def test_parse_transforms_compose():
    scene_txt = b'''
    Film "rgb" "integer xresolution" [8] "integer yresolution" [8]
    Camera "perspective"
    WorldBegin
    Material "diffuse" "rgb reflectance" [.5 .5 .5]
    Translate 10 0 0
    Scale 2 2 2
    Shape "trianglemesh" "integer indices" [0 1 2]
        "point3 P" [0 0 0  1 0 0  0 1 0]
    '''
    desc = pp.parse_string(scene_txt)
    p0 = np.asarray(desc.scene.tri_p0[0])
    p1 = np.asarray(desc.scene.tri_p1[0])
    np.testing.assert_allclose(p0, [10, 0, 0], atol=1e-5)
    np.testing.assert_allclose(p1, [12, 0, 0], atol=1e-5)


def test_parse_object_instancing():
    scene_txt = b'''
    Film "rgb" "integer xresolution" [8] "integer yresolution" [8]
    Camera "perspective"
    WorldBegin
    Material "diffuse"
    ObjectBegin "tri"
    Shape "trianglemesh" "integer indices" [0 1 2]
        "point3 P" [0 0 0  1 0 0  0 1 0]
    ObjectEnd
    ObjectInstance "tri"
    Translate 5 0 0
    ObjectInstance "tri"
    '''
    desc = pp.parse_string(scene_txt)
    # REAL instancing (round 2): the prototype triangle is stored once and
    # the two placements are transform-table rows (cpu/primitive.h:83)
    scene = desc.scene
    assert scene.has_instances
    assert scene.inst_rows.shape[0] == 3  # world + 2 instances
    import jax.numpy as jnp
    from pbrt_jax import scene_core as sc
    o = jnp.asarray([[0.2, 0.2, 5.0], [5.2, 0.2, 5.0], [9.0, 0.2, 5.0]])
    d = jnp.tile(jnp.asarray([[0.0, 0.0, -1.0]]), (3, 1))
    r = sc.intersect(scene, o, d, jnp.full((3,), 1e30))
    hit = np.asarray(r["hit"])
    assert hit[0] and hit[1] and not hit[2]


def test_parse_object_instancing_nonidentity_base_ctm():
    """ObjectBegin under a non-identity CTM: reference semantics
    (scene.cpp:365) compose CTM_instance @ CTM_at_definition, so a quad
    defined under `Translate 5 0 0` and instanced at identity lands at
    x=+5 (round-2 advisor bug: it landed at x=-5)."""
    scene_txt = b'''
    Film "rgb" "integer xresolution" [8] "integer yresolution" [8]
    Camera "perspective"
    WorldBegin
    Material "diffuse"
    AttributeBegin
    Translate 5 0 0
    ObjectBegin "tri"
    Shape "trianglemesh" "integer indices" [0 1 2]
        "point3 P" [0 0 0  1 0 0  0 1 0]
    ObjectEnd
    AttributeEnd
    ObjectInstance "tri"
    Translate 0 7 0
    ObjectInstance "tri"
    '''
    desc = pp.parse_string(scene_txt)
    scene = desc.scene
    import jax.numpy as jnp
    from pbrt_jax import scene_core as sc
    o = jnp.asarray([[5.2, 0.2, 5.0],    # first instance: at x=+5
                     [-4.8, 0.2, 5.0],   # the old inverted-base position
                     [5.2, 7.2, 5.0]])   # second instance: +5,+7
    d = jnp.tile(jnp.asarray([[0.0, 0.0, -1.0]]), (3, 1))
    r = sc.intersect(scene, o, d, jnp.full((3,), 1e30))
    hit = np.asarray(r["hit"])
    assert hit[0] and not hit[1] and hit[2]


def test_parse_sphere_analytic():
    """Translate + uniform scale -> analytic quadric sphere in the pool."""
    scene_txt = b'''
    Film "rgb" "integer xresolution" [8] "integer yresolution" [8]
    Camera "perspective"
    WorldBegin
    Material "conductor" "float roughness" [0.1]
    Translate 0 0 5
    Scale 2 2 2
    Shape "sphere" "float radius" [1.0]
    '''
    desc = pp.parse_string(scene_txt)
    assert desc.scene.n_spheres == 1
    row = np.asarray(desc.scene.quadrics[0])
    # w2o translation column holds -center; radius is col 12
    np.testing.assert_allclose(-row[3:12:4], [0, 0, 5], atol=1e-5)
    np.testing.assert_allclose(row[12], 2.0, rtol=1e-5)


def test_parse_sphere_nonuniform_scale_exact_quadric():
    """Non-uniform scale (ellipsoid) stays an EXACT quadric with the full
    affine transform (reference shapes.h:107; no tessellation)."""
    scene_txt = b'''
    Film "rgb" "integer xresolution" [8] "integer yresolution" [8]
    Camera "perspective"
    WorldBegin
    Material "conductor" "float roughness" [0.1]
    Translate 0 0 5
    Scale 1 2 1
    Shape "sphere" "float radius" [2.0]
    '''
    desc = pp.parse_string(scene_txt, sphere_subdiv=2)
    assert desc.scene.n_spheres == 1
    assert desc.scene.quadric_tags == (0,)  # QUADRIC_SPHERE
    # only the dummy keep-alive triangle is in the mesh pool
    assert desc.scene.tri_p0.shape[0] == 1
    # probe: a +z ray down the center hits the ellipsoid front at z' = -2
    import jax.numpy as jnp
    from pbrt_jax import scene_core as sc
    o = jnp.asarray([[0.0, 0.0, -5.0], [0.0, 3.5, 3.0]])
    d = jnp.asarray([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0]])
    r = sc.intersect(desc.scene, o, d, jnp.full((2,), 1e30))
    assert bool(r["hit"][0]) and abs(float(r["t"][0]) - 8.0) < 1e-3
    # y half-axis is 4: a ray at y=3.5 still hits
    assert bool(r["hit"][1])


def test_ply_roundtrip(tmp_path):
    rng = np.random.RandomState(0)
    v = rng.rand(10, 3).astype(np.float32)
    f = np.asarray([[0, 1, 2], [3, 4, 5], [6, 7, 8]])
    n = rng.rand(10, 3).astype(np.float32)
    uv = rng.rand(10, 2).astype(np.float32)
    plyio.write_ply(tmp_path / "t.ply", v, f, normals=n, uvs=uv)
    m = plyio.read_ply(tmp_path / "t.ply")
    np.testing.assert_allclose(m["vertices"], v, rtol=1e-6)
    np.testing.assert_array_equal(m["indices"], f)
    np.testing.assert_allclose(m["normals"], n, rtol=1e-6)
    np.testing.assert_allclose(m["uvs"], uv, rtol=1e-6)


def test_ply_quads_split(tmp_path):
    # hand-written ascii PLY with a quad
    txt = """ply
format ascii 1.0
element vertex 4
property float x
property float y
property float z
element face 1
property list uchar int vertex_indices
end_header
0 0 0
1 0 0
1 1 0
0 1 0
4 0 1 2 3
"""
    (tmp_path / "q.ply").write_text(txt)
    m = plyio.read_ply(tmp_path / "q.ply")
    assert m["indices"].shape == (2, 3)


def test_parser_texture_directive_kinds(tmp_path):
    """Texture directive: checkerboard / imagemap / mix / directionmix /
    bilerp / scale build real texture-pool rows and attach to diffuse
    reflectance (reference textures.cpp Create* registry)."""
    import numpy as np
    from pbrt_jax.utils import image as pimg
    from pbrt_jax import textures as tex_mod
    img = np.ones((8, 8, 3), np.float32) * 0.25
    pimg.write_exr(tmp_path / "t.exr", img)
    scene_txt = """
LookAt 0 0 5  0 0 0  0 1 0
Camera "perspective" "float fov" [40]
Film "rgb" "integer xresolution" [8] "integer yresolution" [8]
Sampler "independent" "integer pixelsamples" [1]
Integrator "path" "integer maxdepth" [2]
WorldBegin
Texture "chk" "spectrum" "checkerboard" "rgb tex1" [1 0 0] "rgb tex2" [0 0 1]
    "float uscale" [4] "float vscale" [4]
Texture "img" "spectrum" "imagemap" "string filename" "t.exr"
Texture "mx" "spectrum" "mix" "texture tex1" "chk" "texture tex2" "img"
    "float amount" [0.3]
Texture "dm" "spectrum" "directionmix" "texture tex1" "chk"
    "texture tex2" "img" "vector dir" [0 1 0]
Texture "bl" "spectrum" "bilerp" "rgb v00" [1 0 0] "rgb v11" [0 0 1]
Texture "sc" "spectrum" "scale" "texture tex" "img" "float scale" [0.5]
Material "diffuse" "texture reflectance" "mx"
Shape "trianglemesh" "integer indices" [0 1 2]
    "point3 P" [-1 -1 0  1 -1 0  0 1 0]
LightSource "infinite" "spectrum L" [360 1 830 1]
"""
    f = tmp_path / "tex.pbrt"
    f.write_text(scene_txt)
    from pbrt_jax.scene import parser as pparser
    desc = pparser.parse_file(f)
    pool = desc.scene.textures
    assert pool.has_mixers
    tags = set(np.asarray(pool.desc[:, 0]).astype(int).tolist())
    assert tex_mod.TEX_CHECKER in tags
    assert tex_mod.TEX_IMAGE in tags
    assert tex_mod.TEX_MIX in tags
    assert tex_mod.TEX_DIRMIX in tags
    assert tex_mod.TEX_BILERP in tags
    # renders without error and produces finite pixels
    from pbrt_jax.integrators import render as rdr
    from pbrt_jax.integrators.path import PathOptions
    img_out, _ = rdr.render(desc.scene, desc.camera, spp=1,
                            sampler=desc.sampler,
                            opts=PathOptions(max_depth=2))
    assert np.isfinite(np.asarray(img_out)).all()


def test_attribute_directive_applies_defaults():
    """Attribute "shape"/"material" params apply to subsequent directives
    of that category within the attribute scope (reference
    BasicSceneBuilder::Attribute, scene.cpp); own params win."""
    from pbrt_jax.scene.parser import parse_string
    import numpy as np
    desc = parse_string('''
Camera "perspective"
WorldBegin
LightSource "infinite" "rgb L" [1 1 1]
AttributeBegin
  Attribute "material" "rgb reflectance" [0.9 0.1 0.1]
  Material "diffuse"
  Translate 0 0 3
  Shape "sphere" "float radius" [2]
AttributeEnd
Material "diffuse"
Shape "sphere" "float radius" [1]
''')
    # first material got the attribute reflectance; second did not
    ir = desc.ir
    assert len(ir.materials) == 2
    assert "reflectance" in ir.materials[0].params
    assert "reflectance" not in ir.materials[1].params
    # shape attribute: radius default with own override winning
    desc2 = parse_string('''
Camera "perspective"
WorldBegin
LightSource "infinite" "rgb L" [1 1 1]
Attribute "shape" "float radius" [5]
Shape "sphere"
Shape "sphere" "float radius" [1]
''')
    assert desc2.ir.shapes[0].params["radius"][1][0] == 5
    assert desc2.ir.shapes[1].params["radius"][1][0] == 1
