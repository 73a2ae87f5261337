"""Baked-Ptex per-face textures (reference textures.h:921 PtexTextureBase;
SURVEY hard-part #4: offline conversion to array form)."""
import numpy as np
import pytest

from pbrt_jax import samplers as smp
from pbrt_jax.integrators import render as rdr
from pbrt_jax.integrators.path import PathOptions
from pbrt_jax.scene.parser import parse_string, ParseError


def test_ptex_per_face_colors(tmp_path):
    # two triangles, red and blue faces
    np.savez(tmp_path / "faces.npz",
             rgb=np.asarray([[0.9, 0.05, 0.05], [0.05, 0.05, 0.9]],
                            np.float32))
    scene_text = '''
Camera "perspective" "float fov" [60]
Film "rgb" "integer xresolution" [32] "integer yresolution" [32]
WorldBegin
LightSource "infinite" "rgb L" [1 1 1]
Texture "pf" "spectrum" "ptex" "string filename" "faces.npz"
Material "diffuse" "texture reflectance" "pf"
Translate 0 0 3
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
  "point3 P" [-2 -2 0  2 -2 0  2 2 0  -2 2 0]
'''
    desc = parse_string(scene_text, base_dir=str(tmp_path))
    assert desc.scene.textures.has_face
    s = smp.make_sampler("independent", spp=16, full_resolution=(32, 32))
    img, _ = rdr.render(desc.scene, desc.camera, sampler=s,
                        opts=PathOptions(max_depth=2))
    # lower-right half = tri 0 (red), upper-left half = tri 1 (blue)
    red = img[24, 20]   # bottom-right region (raster y down)
    blue = img[6, 10]
    assert red[0] > 2 * red[2], red
    assert blue[2] > 2 * blue[0], blue


def test_ptex_requires_baked_npz(tmp_path):
    scene_text = ('WorldBegin\n'
                  'Texture "pf" "spectrum" "ptex" '
                  '"string filename" "raw.ptx"\n')
    with pytest.raises(ParseError, match="baked offline"):
        parse_string(scene_text, base_dir=str(tmp_path))
