"""Scene IR entity lists (reference scene.h:35-257 BasicScene/SceneEntity:
the parse product is inspectable data, not just compiled arrays)."""
from pbrt_jax.scene.parser import parse_string


_SCENE = '''
Camera "perspective" "float fov" [45]
Film "rgb" "integer xresolution" [16] "integer yresolution" [16]
WorldBegin
MakeNamedMaterial "red" "string type" "diffuse" "rgb reflectance" [1 0 0]
Texture "chk" "spectrum" "checkerboard" "rgb tex1" [1 1 1] "rgb tex2" [0 0 0]
LightSource "point" "rgb I" [5 5 5]
Material "conductor"
AttributeBegin
  Translate 1 2 3
  AreaLightSource "diffuse" "rgb L" [2 2 2]
  Shape "sphere" "float radius" [0.5]
AttributeEnd
Shape "trianglemesh" "integer indices" [0 1 2] "point3 P" [0 0 0 1 0 0 0 1 0]
ObjectBegin "proto"
  Shape "trianglemesh" "integer indices" [0 1 2] "point3 P" [0 0 0 1 0 0 0 1 0]
ObjectEnd
ObjectInstance "proto"
'''


def test_ir_entity_lists():
    desc = parse_string(_SCENE)
    ir = desc.ir
    assert ir.camera.name == "perspective"
    assert ir.camera.params["fov"][1][0] == 45.0
    s = ir.summary()
    assert s["lights"] == 1 and s["area_lights"] == 1
    assert s["materials"] == 1 and s["named_materials"] == 1
    assert s["textures"] == 1 and s["instances"] == 1
    assert s["shapes"] == 3  # sphere + world mesh + proto mesh
    sph = ir.shapes_of("sphere")[0]
    assert sph.area_light
    # declaration CTM captured: translate moved the sphere
    assert abs(float(sph.ctm[0, 3]) - 1.0) < 1e-6
    assert ir.lights[0].name == "point"
    assert "file" not in ir.lights[0].loc  # '<scene>:line:col' form
    assert ":" in ir.lights[0].loc
