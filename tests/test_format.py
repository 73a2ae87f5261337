"""Scene formatter / v3->v4 upgrader (reference FormattingParserTarget,
parser.cpp:1038-1934; pbrt --format/--upgrade/--toply)."""
import io

import numpy as np
import pytest

from pbrt_jax.scene.format import format_string
from pbrt_jax.scene.parser import parse_string


def _fmt(text, **kw):
    out = io.StringIO()
    f = format_string(text, out=out, **kw)
    return out.getvalue(), f


def test_format_roundtrip_parses_identically():
    """Formatting (no upgrade) must preserve meaning: the formatted scene
    compiles to the same film as the original."""
    scene = '''
Camera "perspective" "float fov" [45]
Film "rgb" "integer xresolution" [32] "integer yresolution" [32]
WorldBegin
LightSource "infinite" "rgb L" [1 0.5 0.25]
AttributeBegin
  Translate 0 0 3
  Material "diffuse" "rgb reflectance" [0.7 0.2 0.1]
  Shape "sphere" "float radius" [1]
AttributeEnd
'''
    text, f = _fmt(scene)
    assert not f.warnings
    d1 = parse_string(scene)
    d2 = parse_string(text)
    np.testing.assert_allclose(np.asarray(d1.scene.tri_p0),
                               np.asarray(d2.scene.tri_p0))
    assert text.count("    Translate 0 0 3") == 1  # indented inside attribute


def test_upgrade_matte_and_area_light():
    scene = ('WorldBegin\n'
             'Material "matte" "rgb Kd" [0.5 0.5 0.5] "float sigma" [10]\n'
             'AreaLightSource "area" "blackbody L" [6500 4]\n')
    text, f = _fmt(scene, upgrade=True)
    assert 'Material "diffuse"' in text
    assert '"rgb reflectance"' in text and "sigma" not in text
    assert 'AreaLightSource "diffuse"' in text
    assert '"blackbody L" [ 6500 ]' in text
    assert '"float scale" [ 4 ]' in text


def test_upgrade_mirror_uber_glass():
    scene = ('WorldBegin\n'
             'Material "mirror"\n'
             'Material "glass" "float index" [1.8]\n'
             'Material "uber" "rgb Kd" [.5 .5 .5] "rgb Ks" [0 0 0]\n')
    text, f = _fmt(scene, upgrade=True)
    assert 'Material "conductor"' in text and "metal-Ag-eta" in text
    assert 'Material "dielectric"' in text
    assert '"float eta" [ 1.8 ]' in text
    # uber with Ks=0 degrades to diffuse
    assert 'Material "diffuse"' in text


def test_upgrade_mix_material_swaps_order():
    scene = ('WorldBegin\n'
             'MakeNamedMaterial "a" "string type" "matte"\n'
             'MakeNamedMaterial "b" "string type" "matte"\n'
             'Material "mix" "rgb amount" [0.2 0.2 0.2] '
             '"string namedmaterial1" "a" "string namedmaterial2" "b"\n')
    text, f = _fmt(scene, upgrade=True)
    assert '"float amount" [ 0.2 ]' in text
    assert '"string materials" [ "b" "a" ]' in text  # swapped (parser.cpp:1545)


def test_upgrade_light_scale_and_mapname():
    scene = ('WorldBegin\n'
             'LightSource "infinite" "rgb scale" [2 2 2] '
             '"string mapname" "env.exr" "integer samples" [4]\n')
    text, f = _fmt(scene, upgrade=True)
    assert '"string filename" [ "env.exr" ]' in text
    assert '"float scale" [ 2 ]' in text
    assert "samples" not in text
    assert "WorldEnd" not in text


def test_upgrade_texture_rules():
    scene = ('WorldBegin\n'
             'Texture "t1" "color" "scale" "texture tex1" "base" '
             '"rgb tex2" [0.5 0.5 0.5]\n'
             'Texture "t2" "float" "imagemap" "bool trilinear" true '
             '"float gamma" [2.2]\n')
    text, f = _fmt(scene, upgrade=True)
    assert 'Texture "t1" "spectrum" "scale"' in text
    assert '"texture tex" [ "base" ]' in text
    assert '"float scale" [ 0.5 ]' in text
    assert '"string filter" [ "trilinear" ]' in text
    assert '"string encoding" [ "gamma 2.2" ]' in text


def test_upgrade_trianglemesh_uvs():
    scene = ('WorldBegin\n'
             'Shape "trianglemesh" "integer indices" [0 1 2] '
             '"point3 P" [0 0 0 1 0 0 0 1 0] "float st" [0 0 1 0 0 1]\n')
    text, f = _fmt(scene, upgrade=True)
    assert '"point2 uv" [ 0 0 1 0 0 1 ]' in text
    assert '"float st"' not in text


def test_toply_extracts_large_mesh(tmp_path):
    n = 600
    tris = []
    pts = []
    for i in range(n):
        pts += [[i, 0, 0], [i + 1, 0, 0], [i, 1, 0]]
        tris += [3 * i, 3 * i + 1, 3 * i + 2]
    scene = ('WorldBegin\nShape "trianglemesh" "integer indices" ['
             + " ".join(map(str, tris)) + '] "point3 P" ['
             + " ".join(f"{c}" for p in pts for c in p) + ']\n')
    text, f = _fmt(scene, toply=True, ply_dir=str(tmp_path))
    assert 'Shape "plymesh"' in text and '"string filename"' in text
    from pbrt_jax.scene import plyio
    m = plyio.read_ply(str(tmp_path / "mesh_00000.ply"))
    assert len(m["indices"]) == n
    # small meshes stay inline
    small = ('WorldBegin\nShape "trianglemesh" "integer indices" [0 1 2] '
             '"point3 P" [0 0 0 1 0 0 0 1 0]\n')
    text2, _ = _fmt(small, toply=True, ply_dir=str(tmp_path))
    assert "plymesh" not in text2
