"""pbrt scene-description parser (reference parser.{h,cpp}, scene.{h,cpp}).

Keeps the reference's .pbrt format: tokenizer -> directive loop ->
graphics-state builder -> compiled Scene. The parse product feeds
scene_core.SceneBuilder, which compiles to flat device arrays
(the reference's BasicScene -> RenderCPU pipeline, SURVEY.md §2.4).

Reference directive surface (parser.h:25-110): ~45 directives — transforms
(Identity/Translate/Scale/Rotate/LookAt/Transform/ConcatTransform/
CoordinateSystem/CoordSysTransform/TransformTimes/ActiveTransform),
Camera/Sampler/Film/PixelFilter/Integrator/Accelerator/Option, WorldBegin,
Attribute(Begin/End) incl. per-category defaults, Object(Begin/End/
Instance), Shape (trianglemesh, plymesh, sphere, disk, cylinder, curve,
bilinearmesh, loopsubdiv), Material / MakeNamedMaterial / NamedMaterial,
Texture (constant/scale/mix/checkerboard/dots/fbm/windy/wrinkled/marble/
imagemap/ptex with uv/spherical/cylindrical/planar mappings), LightSource
(all types incl. image/portal infinite), AreaLightSource,
MakeNamedMedium/MediumInterface, ReverseOrientation, Include/Import.
"""
from __future__ import annotations

import os
import re
from pathlib import Path

import numpy as np

from .. import scene_core as sc
from .. import cameras as cam_mod
from .. import filters as flt
from .. import samplers as smp
from ..utils import transform as tfm
from ..utils import spectrum as spc
from ..utils import color as pcolor
from . import plyio


class ParseError(ValueError):
    """Scene-description error (reference util/error.h ErrorExit; FileLoc
    tracking is attached by the directive loop where available)."""

_TOKEN_RE = re.compile(rb'"[^"]*"|\[|\]|[^\s"\[\]#]+|#[^\n]*')


# Include/Import token streams prefetched on the host thread pool keyed by
# absolute path (reference parser.cpp:771-808 parallel Import parsing)
_prefetch_cache = {}


def _prefetch_assets(toks, base_dir):
    """Kick off background tokenization of Include/Import files and PLY
    reads referenced by the token stream (reference: parallel Import +
    async shape creation, parser.cpp:771 / scene.cpp:1391)."""
    from ..parallel import host as phost
    from pathlib import Path as _P

    def prefetch_stream(stream):
        for i, t in enumerate(stream[:-1]):
            if t in ("Include", "Import"):
                nxt = stream[i + 1]
                if isinstance(nxt, str) and nxt.startswith('"'):
                    sub = _P(base_dir) / nxt[1:-1]
                    key = str(sub)
                    if key not in _prefetch_cache and sub.exists():
                        def job(path=sub):
                            st = tokenize(path.read_bytes())
                            # one level of nested prefetch
                            prefetch_stream(st)
                            return st
                        _prefetch_cache[key] = phost.run_async(job)
            elif isinstance(t, str) and t.endswith('.ply"'):
                ply = _P(base_dir) / t[1:-1]
                if ply.exists():
                    from . import plyio
                    phost.run_async(plyio.read_ply, str(ply))

    prefetch_stream(toks)


def tokenize(text: bytes):
    """pbrt tokens: quoted strings, brackets, atoms; # comments stripped
    (reference Tokenizer, parser.cpp:130-266). Numbers come back pre-parsed
    as floats. Uses the native C++ tokenizer when available."""
    return tokenize_with_offsets(text)[0]


def tokenize_with_offsets(text: bytes):
    """Returns (tokens, byte_offsets) — offsets drive FileLoc diagnostics
    (reference util/error.h FileLoc carried by Token, parser.h:46)."""
    try:
        from ..native import tokenize_native
        r = tokenize_native(text, with_offsets=True)
        if r is not None:
            return r
    except Exception:
        pass
    out = []
    offs = []
    for m in _TOKEN_RE.finditer(text):
        t = m.group(0)
        if t.startswith(b"#"):
            continue
        tok = t.decode("utf-8")
        if tok not in ("[", "]") and not tok.startswith('"'):
            try:
                out.append(float(tok))
                offs.append(m.start())
                continue
            except ValueError:
                pass
        out.append(tok)
        offs.append(m.start())
    return out, offs


_DIRECTIVES = {
    "Integrator", "Transform", "ConcatTransform", "Identity", "Translate",
    "Scale", "Rotate", "LookAt", "CoordinateSystem", "CoordSysTransform",
    "Camera", "Sampler", "Film", "Filter", "PixelFilter", "Accelerator",
    "WorldBegin", "WorldEnd", "AttributeBegin", "AttributeEnd",
    "TransformBegin", "TransformEnd", "ObjectBegin", "ObjectEnd",
    "ObjectInstance", "Shape", "Material", "MakeNamedMaterial",
    "NamedMaterial", "Texture", "LightSource", "AreaLightSource",
    "ReverseOrientation", "MediumInterface", "MakeNamedMedium", "Include",
    "Import", "Option", "Attribute", "ColorSpace", "ActiveTransform",
    "TransformTimes", "StartTime", "EndTime",
}


class ParamSet:
    """Typed parameter dictionary (reference paramdict.h ParameterDictionary)."""

    def __init__(self, pairs):
        self.d = {}  # name -> (type, values)
        for (ty, name), vals in pairs:
            self.d[name] = (ty, vals)

    def _get(self, name, types=None):
        if name not in self.d:
            return None
        ty, vals = self.d[name]
        if types and ty not in types:
            return None
        return vals

    def floats(self, name, default=None):
        v = self._get(name, ("float", "integer"))
        return np.asarray(v, np.float64) if v is not None else default

    def float(self, name, default=None):
        v = self._get(name, ("float", "integer"))
        return float(v[0]) if v else default

    def int(self, name, default=None):
        v = self._get(name, ("integer", "float"))
        return int(v[0]) if v else default

    def ints(self, name, default=None):
        v = self._get(name, ("integer",))
        return np.asarray(v, np.int64) if v is not None else default

    def bool(self, name, default=None):
        v = self._get(name, ("bool",))
        if v is None:
            return default
        return v[0] in (True, "true", "\"true\"")

    def string(self, name, default=None):
        v = self._get(name, ("string", "texture"))
        return v[0] if v else default

    def point3s(self, name, default=None):
        v = self._get(name, ("point3", "point", "vector3", "vector", "normal",
                             "normal3"))
        return np.asarray(v, np.float64).reshape(-1, 3) if v is not None else default

    def point2s(self, name, default=None):
        v = self._get(name, ("point2", "float"))
        return np.asarray(v, np.float64).reshape(-1, 2) if v is not None else default

    def rgb(self, name, default=None):
        v = self._get(name, ("rgb", "color"))
        return np.asarray(v, np.float64) if v is not None else default

    def texture_name(self, name):
        ty_v = self.d.get(name)
        if ty_v and ty_v[0] == "texture":
            return ty_v[1][0]
        return None

    def spectrum(self, name, cs, kind="albedo", default=None):
        """Resolve a spectral parameter: rgb / blackbody / named spectrum /
        spectrum file / float list [(lam, v)...] (reference paramdict.cpp)."""
        if name not in self.d:
            return default
        ty, vals = self.d[name]
        if ty in ("rgb", "color"):
            rgb = np.asarray(vals, np.float64)
            if kind == "illuminant":
                return pcolor.RGBIlluminantSpectrum(rgb, cs)
            if kind == "unbounded":
                return pcolor.RGBUnboundedSpectrum(rgb, cs)
            return pcolor.RGBAlbedoSpectrum(np.clip(rgb, 0, 1), cs)
        if ty == "blackbody":
            return spc.BlackbodySpectrum(float(vals[0]))
        if ty == "spectrum":
            if isinstance(vals[0], str):
                s = spc.get_named_spectrum(vals[0])
                if s is None and os.path.exists(vals[0]):
                    data = np.loadtxt(vals[0])
                    s = spc.PiecewiseLinearSpectrum(data[:, 0], data[:, 1])
                return s
            arr = np.asarray(vals, np.float64)
            return spc.PiecewiseLinearSpectrum(arr[0::2], arr[1::2])
        if ty in ("float", "integer"):
            return spc.ConstantSpectrum(float(vals[0]))
        return default


def _with_attributes(gs, category, ps):
    """Prepend Attribute-directive defaults for the category (own params
    win on conflicts — ParamSet keeps the last entry per name)."""
    pairs = gs.attributes.get(category, [])
    if not pairs:
        return ps
    merged = ParamSet(list(pairs))
    merged.d.update(ps.d)
    return merged


def _parse_value(tok):
    if isinstance(tok, float):
        return tok
    if tok.startswith('"'):
        return tok[1:-1]
    if tok == "true":
        return True
    if tok == "false":
        return False
    return float(tok)


class Parser:
    def __init__(self, tokens, base_dir=".", offsets=None, fname=None,
                 text=None):
        self.toks = tokens
        self.pos = 0
        self.base_dir = Path(base_dir)
        self.offsets = offsets
        self.fname = fname
        self.text = text

    def loc(self, pos=None) -> str:
        """'file:line:col' of the token at pos (default: last consumed) —
        the reference's FileLoc (util/error.h:19)."""
        if self.offsets is None or self.text is None:
            return f"{self.fname or '<scene>'}:token {self.pos}"
        pos = self.pos - 1 if pos is None else pos
        pos = min(max(pos, 0), len(self.offsets) - 1)
        off = self.offsets[pos]
        # newline offsets are precomputed once: loc() runs per directive
        # (scene-IR entity locations), and counting newlines over a
        # multi-MB buffer per call measured 120s on an 8.5k-shape scene
        if not hasattr(self, "_nl"):
            import numpy as _np
            self._nl = _np.frombuffer(self.text, _np.uint8)
            self._nl = _np.nonzero(self._nl == 0x0A)[0]
        import bisect
        i = bisect.bisect_left(self._nl, off)
        line = i + 1
        col = off - (int(self._nl[i - 1]) + 1 if i > 0 else 0) + 1
        return f"{self.fname or '<scene>'}:{line}:{col}"

    def peek(self):
        return self.toks[self.pos] if self.pos < len(self.toks) else None

    def next(self):
        t = self.toks[self.pos]
        self.pos += 1
        return t

    def parse_params(self) -> ParamSet:
        """Parse '"type name" [values...]' pairs until the next directive."""
        pairs = []
        while True:
            t = self.peek()
            if t is None or not isinstance(t, str) or not t.startswith('"'):
                break
            decl = self.next()[1:-1].split()
            if len(decl) == 1:
                # a bare string argument, not a parameter: put back
                self.pos -= 1
                break
            ty, name = decl[0], " ".join(decl[1:])
            vals = []
            if self.peek() == "[":
                self.next()
                while self.peek() != "]":
                    vals.append(_parse_value(self.next()))
                self.next()
            else:
                vals.append(_parse_value(self.next()))
            pairs.append(((ty, name), vals))
        return ParamSet(pairs)

    def parse_args(self, n):
        return [_parse_value(self.next()) for _ in range(n)]

    def parse_string(self):
        return self.next()[1:-1]


class GraphicsState:
    def __init__(self):
        self.ctm = tfm.identity()
        # animated CTM (reference AnimatedTransform via ActiveTransform
        # StartTime/EndTime): ctm_end tracks the end-of-shutter transform;
        # active selects which of the pair subsequent directives touch
        self.ctm_end = None
        self.active_transform = "All"
        self.reverse_orientation = False
        self.material = 0
        self.area_light = None  # (Spectrum, scale, two_sided)
        self.named_material = None
        # MediumInterface names (inside, outside); None = unset (reference
        # graphics-state currentInsideMedium/currentOutsideMedium)
        self.medium_interface = None
        # Attribute-directive parameter defaults per target category
        # (reference BasicSceneBuilder::Attribute, scene.cpp: params ride
        # the graphics state and prepend to matching directives)
        self.attributes = {}  # category -> list of ((type, name), values)


def _apply_xf(gs, f):
    """Apply a CTM update respecting ActiveTransform
    (reference scene.cpp transform directives + AnimatedTransform)."""
    if gs.active_transform in ("All", "StartTime"):
        gs.ctm = f(gs.ctm)
    if gs.active_transform in ("All", "EndTime"):
        if gs.ctm_end is None and gs.active_transform == "EndTime":
            gs.ctm_end = tfm.identity()
        if gs.ctm_end is not None:
            gs.ctm_end = f(gs.ctm_end)
    elif gs.active_transform == "All" and gs.ctm_end is not None:
        pass  # handled above


class PbrtSceneDescription:
    """Everything a .pbrt file defines: compiled scene + camera + render opts."""

    def __init__(self, scene, camera, sampler, filter_, integrator,
                 film_params, ir=None):
        self.scene = scene
        self.camera = camera
        self.sampler = sampler
        self.filter = filter_
        self.integrator = integrator  # dict(name, max_depth, ...)
        self.film_params = film_params  # dict(filename, xres, yres)
        self.ir = ir  # scene.ir.SceneIR entity lists (reference BasicScene)


def parse_file(path, **overrides) -> PbrtSceneDescription:
    text = Path(path).read_bytes()
    return parse_string(text, base_dir=Path(path).parent, fname=str(path),
                        **overrides)


def parse_string(text, base_dir=".", light_sampler="power",
                 force_bvh=None, sphere_subdiv=4,
                 fname=None) -> PbrtSceneDescription:
    if isinstance(text, str):
        text = text.encode()
    toks, offs = tokenize_with_offsets(text)
    _prefetch_assets(toks, base_dir)
    p = Parser(toks, base_dir, offsets=offs, fname=fname, text=text)
    from . import ir as sir
    scene_ir = sir.SceneIR()
    b = sc.SceneBuilder()
    cs = b.cs

    gs = GraphicsState()
    stack = []
    named_transforms = {}
    named_materials = {}
    named_textures = {}   # name -> ("constant", value) | ("scale", ...) etc.
    named_media = {}      # name -> index into b.media rows
    objects = {}          # name -> list of deferred shape records
    current_object = None

    accel_kind = None
    pending_face_textures = []
    cam_params = dict(kind="perspective", fov=90.0,
                      camera_from_world=tfm.identity())
    film_params = dict(xres=1280, yres=720, filename="out.exr")
    sampler_params = dict(kind="zsobol", spp=16)
    filter_params = dict(kind="gaussian")
    integrator = dict(name="path", max_depth=5)
    default_mat_added = False

    def cur_material():
        nonlocal default_mat_added
        if gs.material is None or (gs.material == 0 and not b.materials.rows):
            if not b.materials.rows:
                b.materials.add_diffuse((0.5, 0.5, 0.5))
            default_mat_added = True
            return 0
        return gs.material

    def resolve_float_or_texture(ps, name, default):
        tex = ps.texture_name(name)
        if tex is not None and tex in named_textures:
            t = named_textures[tex]
            if t[0] == "constant":
                return float(t[1])
        return ps.float(name, default)

    def make_material(name, ps: ParamSet) -> int:
        if name in ("", "none", "interface"):
            # null material: interface-only geometry, never scatters
            # (reference Material() null case; used with MediumInterface)
            return -1
        rough = resolve_float_or_texture(ps, "roughness", 0.0)
        urough = resolve_float_or_texture(ps, "uroughness", None)
        vrough = resolve_float_or_texture(ps, "vroughness", None)
        remap = ps.bool("remaproughness", True)
        if name == "subsurface":
            g_par = ps.float("g", 0.0)
            eta_par = ps.float("eta", 1.33)
            pname = ps.string("name", None)
            if pname is not None:
                from .. import bssrdf as _bs
                got = _bs.get_scattering_preset(pname,
                                                scale=ps.float("scale", 1.0))
                if got is None:
                    raise ParseError(
                        f"{p.loc()}: unknown scattering preset '{pname}'")
                sa, sps = got
                return b.materials.add_subsurface(
                    sigma_a=sa, sigma_s=sps / max(1.0 - g_par, 1e-3),
                    eta=eta_par, g=g_par)
            sa = ps.rgb("sigma_a", None)
            ss = ps.rgb("sigma_s", None)
            if sa is not None and ss is not None:
                return b.materials.add_subsurface(sigma_a=np.asarray(sa),
                                                  sigma_s=np.asarray(ss),
                                                  eta=eta_par, g=g_par)
            refl = ps.rgb("reflectance", (0.8, 0.6, 0.5))
            mfp = ps.rgb("mfp", None)
            if mfp is None:
                mfp = (0.1, 0.1, 0.1)
            return b.materials.add_subsurface(
                reflectance=refl, mfp=mfp, eta=eta_par, g=g_par)
        if name == "hair":
            sig = ps.rgb("sigma_a", None)
            if sig is None:
                # reference defaults via eumelanin concentration 1.3
                sig = (0.227, 0.419, 0.805)
            return b.materials.add_hair(
                sigma_a=sig,
                beta_m=ps.float("beta_m", 0.3),
                beta_n=ps.float("beta_n", 0.3),
                eta=ps.float("eta", 1.55))
        if name in ("diffuse", "matte"):
            tn = ps.texture_name("reflectance")
            if tn is not None and tn in named_textures and \
                    named_textures[tn][0] == "tex":
                return b.materials.add_diffuse(
                    albedo_tex=named_textures[tn][1])
            refl = ps.rgb("reflectance", None)
            if refl is None:
                s = ps.spectrum("reflectance", cs)
                if s is not None:
                    refl = np.clip(cs.to_rgb(np.asarray(s.to_xyz())), 0, 1)
                else:
                    refl = (0.5, 0.5, 0.5)
            return b.materials.add_diffuse(tuple(np.clip(refl, 0, 1)))
        if name == "conductor":
            eta_s = ps.spectrum("eta", cs, kind="unbounded")
            k_s = ps.spectrum("k", cs, kind="unbounded")
            if eta_s is None:
                eta_s = spc.get_named_spectrum("metal-Cu-eta")
            if k_s is None:
                k_s = spc.get_named_spectrum("metal-Cu-k")
            ei = b.add_spectrum(eta_s, key=("mat-eta", id(eta_s)))
            ki = b.add_spectrum(k_s, key=("mat-k", id(k_s)))
            return b.materials.add_conductor(
                eta_spec_idx=ei, k_spec_idx=ki, roughness=rough,
                uroughness=urough, vroughness=vrough, remap=remap)
        if name == "dielectric" or name == "glass":
            ei = -1
            if ps.d.get("eta", ("", []))[0] == "spectrum":
                es = ps.spectrum("eta", cs, kind="unbounded")
                if es is not None:
                    ei = b.add_spectrum(es, key=("eta", id(es)))
            eta = ps.float("eta", 1.5)
            return b.materials.add_dielectric(eta=eta if eta else 1.5,
                                              roughness=rough,
                                              uroughness=urough,
                                              vroughness=vrough, remap=remap,
                                              eta_spec_idx=ei)
        if name in ("coateddiffuse", "plastic"):
            refl = ps.rgb("reflectance", (0.5,) * 3)
            return b.materials.add_coated_diffuse(
                tuple(np.clip(refl, 0, 1)), roughness=rough if rough else 0.1,
                eta=ps.float("interface.eta", ps.float("eta", 1.5)),
                remap=remap)
        if name == "thindielectric":
            return b.materials.add_dielectric(eta=ps.float("eta", 1.5), thin=True)
        if name == "diffusetransmission":
            r = ps.rgb("reflectance", (0.25,) * 3)
            t = ps.rgb("transmittance", (0.25,) * 3)
            return b.materials.add_diffuse_transmission(tuple(r), tuple(t))
        if name == "coatedconductor":
            eta_s = ps.spectrum("conductor.eta", cs, kind="unbounded")
            k_s = ps.spectrum("conductor.k", cs, kind="unbounded")
            if eta_s is None:
                eta_s = spc.get_named_spectrum("metal-Cu-eta")
            if k_s is None:
                k_s = spc.get_named_spectrum("metal-Cu-k")
            ei = b.add_spectrum(eta_s, key=("mat-eta", id(eta_s)))
            ki = b.add_spectrum(k_s, key=("mat-k", id(k_s)))
            return b.materials.add_coated_conductor(
                interface_roughness=resolve_float_or_texture(
                    ps, "interface.roughness", rough if rough else 0.1),
                interface_eta=ps.float("interface.eta", 1.5),
                conductor_roughness=resolve_float_or_texture(
                    ps, "conductor.roughness", 0.1),
                eta_spec_idx=ei, k_spec_idx=ki, remap=remap)
        if name == "mix":
            names = ps._get("materials", ("string",))
            if not names or len(names) != 2:
                raise ParseError(
                    f"{p.loc()}: mix material needs \"string materials\" [two names]")
            m1 = named_materials.get(names[0])
            m2 = named_materials.get(names[1])
            if m1 is None or m2 is None:
                raise ParseError(
                    f"{p.loc()}: mix material references unknown materials {names}")
            return b.materials.add_mix(m1, m2, ps.float("amount", 0.5))
        raise ParseError(f"{p.loc()}: material '{name}' is not supported")

    def _read_any_image(fp):
        from ..utils import image as pimg
        fp = str(fp)
        if fp.endswith(".exr"):
            return pimg.read_exr(fp)
        if fp.endswith(".pfm"):
            return pimg.read_pfm(fp)
        return pimg.read_png(fp).astype(np.float32) / 255.0

    def add_shape(name, ps: ParamSet, gs: GraphicsState):
        mat = gs.material if gs.material is not None else cur_material()
        emission = None
        escale = 1.0
        two_sided = False
        if gs.area_light is not None:
            emission, escale, two_sided = gs.area_light
        record = dict(name=name, ps=ps, ctm=gs.ctm, mat=mat,
                      reverse=gs.reverse_orientation, emission=emission,
                      escale=escale, two_sided=two_sided,
                      medium_interface=gs.medium_interface)
        if current_object is not None:
            objects[current_object]["records"].append(record)
        else:
            instantiate_shape(record, tfm.identity())

    def mesh_data_for_record(rec):
        """(P, idx, N, uv) for a mesh-kind shape record (object space,
        BEFORE any transform)."""
        name, ps = rec["name"], rec["ps"]
        if name == "trianglemesh":
            P = ps.point3s("P")
            idx = ps.ints("indices").reshape(-1, 3)
            N = ps.point3s("N", None)
            uv = ps.point2s("uv", ps.point2s("st", None))
        elif name == "plymesh":
            fn = ps.string("filename")
            mesh = plyio.read_ply(Path(base_dir) / fn)
            P, idx, N, uv = (mesh["vertices"], mesh["indices"],
                             mesh["normals"], mesh["uvs"])
        else:  # bilinearmesh
            P = ps.point3s("P")
            qidx = ps.ints("indices").reshape(-1, 4)
            idx = np.concatenate([qidx[:, [0, 1, 3]], qidx[:, [0, 3, 2]]])
            N = ps.point3s("N", None)
            uv = ps.point2s("uv", None)
        return P, idx, N, uv

    def instantiate_shape(rec, instance_xf):
        name, ps, ctm = rec["name"], rec["ps"], rec["ctm"]
        xf = instance_xf @ ctm
        emission, escale, two = rec["emission"], rec["escale"], rec["two_sided"]
        reverse = rec["reverse"]
        mat = rec["mat"]
        if mat == -1:
            # null material: medium-interface boundary geometry (reference
            # GeometricPrimitive with !material, cpu/primitive.h:48)
            mi = rec.get("medium_interface") or (None, None)

            def med_idx(nm):
                if nm is None:
                    return -1
                if nm not in named_media:
                    raise ParseError(
                        f"{p.loc()}: MediumInterface names unknown medium "
                        f"'{nm}'")
                return named_media[nm]
            if name == "trianglemesh":
                P = ps.point3s("P")
                idx = ps.ints("indices").reshape(-1, 3)
            elif name == "plymesh":
                mesh = plyio.read_ply(Path(base_dir) / ps.string("filename"))
                P, idx = mesh["vertices"], mesh["indices"]
            else:
                raise ParseError(
                    f"{p.loc()}: interface (null-material) shapes are "
                    f"supported for meshes only, not '{name}'")
            Pw = np.asarray(xf.apply_point(np.asarray(P, np.float32)))
            b.add_interface_mesh(Pw, idx, med_in=med_idx(mi[0]),
                                 med_out=med_idx(mi[1]))
            return
        if name == "trianglemesh":
            P = ps.point3s("P")
            idx = ps.ints("indices").reshape(-1, 3)
            N = ps.point3s("N", None)
            uv = ps.point2s("uv", ps.point2s("st", None))
        elif name == "plymesh":
            fn = ps.string("filename")
            mesh = plyio.read_ply(Path(base_dir) / fn)
            P, idx, N, uv = (mesh["vertices"], mesh["indices"],
                             mesh["normals"], mesh["uvs"])
        elif name == "sphere":
            radius = ps.float("radius", 1.0)
            zmin = ps.float("zmin", -radius)
            zmax = ps.float("zmax", radius)
            phimax = ps.float("phimax", 360.0)
            A = np.asarray(xf.m, np.float64)[:3, :3]
            gram = A @ A.T
            s_sq = gram[0, 0]
            uniform = np.allclose(gram, s_sq * np.eye(3), rtol=1e-4) and s_sq > 0
            full = zmin <= -radius + 1e-6 and zmax >= radius - 1e-6 and \
                phimax >= 360.0 - 1e-4
            if uniform and full and emission is not None:
                # emissive spheres need the cone-sampled sphere light path
                center = np.asarray(xf.apply_point(
                    np.zeros((1, 3), np.float32)))[0]
                b.add_sphere(center, radius * float(np.sqrt(s_sq)), mat,
                             emission=emission, emission_scale=escale)
                return
            if uniform and full:
                center = np.asarray(xf.apply_point(
                    np.zeros((1, 3), np.float32)))[0]
                b.add_sphere(center, radius * float(np.sqrt(s_sq)), mat)
                return
            if emission is not None:
                # partial/ellipsoid emissive spheres: tessellate for the
                # area-light machinery (exact quadric light sampling TBD)
                from ..scenes import make_sphere_mesh
                P, idx, N = make_sphere_mesh((0, 0, 0), radius,
                                             subdiv=sphere_subdiv)
                uv = None
            else:
                # exact quadric under an arbitrary affine transform
                # (reference shapes.h:107; zmin/zmax clipping pending)
                if not full:
                    raise ParseError(
                        f"{p.loc()}: partial spheres (zmin/zmax/phimax) are not yet "
                        "supported as exact quadrics")
                b.add_quadric_sphere(np.asarray(xf.m, np.float64), radius,
                                     mat)
                return
        elif name == "disk":
            if emission is not None:
                raise ParseError(f"{p.loc()}: area lights on disks are not supported yet")
            b.add_disk(np.asarray(xf.m, np.float64),
                       ps.float("radius", 1.0), mat,
                       height=ps.float("height", 0.0),
                       inner_radius=ps.float("innerradius", 0.0),
                       phi_max=np.deg2rad(ps.float("phimax", 360.0)))
            return
        elif name == "cylinder":
            if emission is not None:
                raise ParseError(
                    f"{p.loc()}: area lights on cylinders are not supported yet")
            b.add_cylinder(np.asarray(xf.m, np.float64),
                           ps.float("radius", 1.0),
                           ps.float("zmin", -1.0), ps.float("zmax", 1.0), mat,
                           phi_max=np.deg2rad(ps.float("phimax", 360.0)))
            return
        elif name == "curve":
            # reference Shape "curve" (shapes.cpp CreateCurve): cubic Bezier
            # control points, lerped width, type flat/cylinder/ribbon
            if emission is not None:
                raise ParseError(f"{p.loc()}: emissive curves are not "
                                 "supported")
            cp = np.asarray(ps.point3s("P"), np.float32)
            basis = ps.string("basis", "bezier")
            if basis != "bezier":
                raise ParseError(f"{p.loc()}: curve basis '{basis}' is not "
                                 "supported (bezier only; convert b-splines "
                                 "upstream)")
            degree = int(ps.float("degree", 3))
            if degree != 3 or cp.shape[0] < 4:
                raise ParseError(f"{p.loc()}: only degree-3 bezier curves "
                                 "with 4+ control points are supported")
            w = ps.float("width", 1.0)
            w0 = ps.float("width0", w)
            w1 = ps.float("width1", w)
            ctype = ps.string("type", "flat")
            nrm = ps.point3s("N", None)
            cp_w = np.asarray(xf.apply_point(cp.reshape(-1, 3)), np.float32)
            # multiple chained bezier spans: groups of 4 (shared endpoints
            # use 3*k+1 points; accept both packed layouts)
            n_spans = max((cp_w.shape[0] - 1) // 3, 1)
            for si in range(n_spans):
                a = si * 3
                span = cp_w[a:a + 4] if cp_w.shape[0] >= a + 4 else cp_w[-4:]
                u0 = si / n_spans
                u1 = (si + 1) / n_spans
                ws0 = w0 + (w1 - w0) * u0
                ws1 = w0 + (w1 - w0) * u1
                normals = None
                if nrm is not None and len(nrm) >= 2:
                    normals = (nrm[0], nrm[1])
                b.add_curve(span, ws0, ws1, mat, curve_type=ctype,
                            normals=normals)
            return
        elif name == "loopsubdiv":
            # reference Shape "loopsubdiv": Loop-subdivided control mesh
            levels = int(ps.float("levels", 3))
            P = ps.point3s("P")
            idx = ps.ints("indices").reshape(-1, 3)
            from ..utils.subdivision import loop_subdivide
            P, idx = loop_subdivide(P, idx, levels)
            N = None
            uv = None
        elif name == "bilinearmesh":
            P = ps.point3s("P")
            qidx = ps.ints("indices").reshape(-1, 4)
            N = ps.point3s("N", None)
            uv = ps.point2s("uv", None)
            if emission is None and N is None and uv is None and \
                    len(qidx) <= 64 and ps.float("alpha", 1.0) == 1.0:
                # EXACT Reshetov patches (shapes.h:1279); large/emissive/
                # attribute-carrying quad meshes triangulate below
                Pw = np.asarray(xf.apply_point(np.asarray(P, np.float32)))
                for q4 in qidx:
                    b.add_bilinear_patch(Pw[q4[0]], Pw[q4[1]], Pw[q4[2]],
                                         Pw[q4[3]], mat)
                return
            idx = np.concatenate([qidx[:, [0, 1, 3]], qidx[:, [0, 3, 2]]])
        else:
            raise ParseError(
                f"{p.loc()}: shape '{name}' is not supported — refusing to render a "
                f"silently-wrong image (reference errors with FileLoc)")
        P = np.asarray(xf.apply_point(np.asarray(P, np.float32)))
        if N is not None:
            N = np.asarray(xf.apply_normal(np.asarray(N, np.float32)))
            N = N / np.maximum(np.linalg.norm(N, axis=-1, keepdims=True), 1e-20)
        if reverse ^ xf.swaps_handedness():
            idx = np.asarray(idx)[:, ::-1]
        alpha_tex = -1
        tn_alpha = ps.texture_name("alpha")
        if tn_alpha is not None and tn_alpha in named_textures:
            e = named_textures[tn_alpha]
            if e[0] in ("ftex", "tex"):
                alpha_tex = e[1]
            elif e[0] == "constant" and float(e[1]) == 0.0:
                return  # constant-0 alpha: fully cut away
        alpha = ps.float("alpha", 1.0)
        if alpha == 0.0:
            return  # fully cut-away shape
        b.add_mesh(P, idx, mat, normals=N, uvs=uv, emission=emission,
                   emission_scale=escale, two_sided=two,
                   alpha_tex=alpha_tex)

    while p.peek() is not None:
        directive_pos = p.pos
        tok = p.next()
        if not isinstance(tok, str):
            raise ParseError(f"{p.loc(directive_pos)}: "
                             f"unexpected token {tok!r}")
        if tok == "Include" or tok == "Import":
            fn = p.parse_string()
            sub = Path(base_dir) / fn
            # prefetched in a background thread at parse start (the role of
            # the reference's parallel Import parsing, parser.cpp:771-808)
            fut = _prefetch_cache.get(str(sub))
            subtoks = fut.result() if fut is not None \
                else tokenize(sub.read_bytes())
            p.toks = p.toks[:p.pos] + subtoks + p.toks[p.pos:]
        elif tok == "Identity":
            _apply_xf(gs, lambda c: tfm.identity())
        elif tok == "Translate":
            a = p.parse_args(3)
            _apply_xf(gs, lambda c: c @ tfm.translate(a))
        elif tok == "Scale":
            a = p.parse_args(3)
            _apply_xf(gs, lambda c: c @ tfm.scale(*a))
        elif tok == "Rotate":
            a = p.parse_args(4)
            _apply_xf(gs, lambda c: c @ tfm.rotate(a[0], a[1:]))
        elif tok == "LookAt":
            a = p.parse_args(9)
            _apply_xf(gs, lambda c: c @ tfm.look_at(a[0:3], a[3:6],
                                                    a[6:9]).inverse())
        elif tok == "Transform":
            assert p.next() == "["
            m = [float(p.next()) for _ in range(16)]
            assert p.next() == "]"
            _apply_xf(gs,
                      lambda c: tfm.from_matrix(np.asarray(m).reshape(4, 4).T))
        elif tok == "ConcatTransform":
            assert p.next() == "["
            m = [float(p.next()) for _ in range(16)]
            assert p.next() == "]"
            _apply_xf(gs, lambda c: c @ tfm.from_matrix(
                np.asarray(m).reshape(4, 4).T))
        elif tok == "CoordinateSystem":
            named_transforms[p.parse_string()] = gs.ctm
        elif tok == "CoordSysTransform":
            gs.ctm = named_transforms.get(p.parse_string(), gs.ctm)
        elif tok == "Camera":
            kind = p.parse_string()
            ps = p.parse_params()
            scene_ir.camera = sir.SceneEntity(name=kind, params=dict(ps.d),
                                              loc=p.loc(directive_pos))
            cam_params = dict(kind=kind, fov=ps.float("fov", 90.0),
                              camera_from_world=gs.ctm,
                              lens_radius=ps.float("lensradius", 0.0),
                              focal_distance=ps.float("focaldistance", 1e6),
                              aperture_diameter=ps.float("aperturediameter",
                                                         None))
            named_transforms["camera"] = gs.ctm.inverse()
        elif tok == "Sampler":
            kind = p.parse_string()
            ps = p.parse_params()
            kind_map = {"zsobol": "zsobol", "halton": "halton", "sobol": "sobol",
                        "paddedsobol": "paddedsobol", "independent": "independent",
                        "stratified": "stratified", "pmj02bn": "zsobol"}
            sampler_params = dict(kind=kind_map.get(kind, "zsobol"),
                                  spp=ps.int("pixelsamples", 16))
            # halton does not need pow2 spp
            if kind == "halton":
                sampler_params["kind"] = "halton"
        elif tok == "Film":
            _kind = p.parse_string()
            ps = p.parse_params()
            film_params = dict(xres=ps.int("xresolution", 1280),
                               yres=ps.int("yresolution", 720),
                               filename=ps.string("filename", "out.exr"))
        elif tok in ("Filter", "PixelFilter"):
            kind = p.parse_string()
            ps = p.parse_params()
            filter_params = dict(kind=kind,
                                 xradius=ps.float("xradius", None),
                                 yradius=ps.float("yradius", None))
        elif tok == "Integrator":
            name = p.parse_string()
            ps = p.parse_params()
            integrator = dict(name=name, max_depth=ps.int("maxdepth", 5))
            # "string lightsampler" (reference path/volpath integrators
            # default "bvh", cpu/integrators.cpp CreatePathIntegrator)
            ls_over = ps.string("lightsampler", None)
            if ls_over is not None:
                light_sampler = ls_over.strip('"')
            if name == "function":
                integrator["function"] = ps.string("function", "step")
                integrator["filename"] = ps.string("filename", "")
        elif tok == "Accelerator":
            accel_kind = p.parse_string()
            p.parse_params()
        elif tok == "MakeNamedMedium":
            nm = p.parse_string()
            ps = p.parse_params()
            mtype = ps.string("type", "homogeneous")
            scene_ir.media[nm] = sir.SceneEntity(
                name=mtype, params=dict(ps.d), loc=p.loc(directive_pos))
            g = ps.float("g", 0.0)
            sig_a = ps.rgb("sigma_a", (1.0,) * 3)
            sig_s = ps.rgb("sigma_s", (1.0,) * 3)
            mscale = ps.float("scale", 1.0)
            if mtype == "homogeneous":
                # participate in a box around the whole scene (media are
                # box-bounded in this framework; see media.py)
                named_media[nm] = b.media.add_homogeneous(
                    sigma_a=tuple(sig_a), sigma_s=tuple(sig_s), g=g,
                    scale=mscale)
            elif mtype in ("uniformgrid", "rgbgrid", "cloud"):
                nx = ps.int("nx", 1)
                ny = ps.int("ny", 1)
                nz = ps.int("nz", 1)
                p0 = ps.point3s("p0", np.zeros((1, 3)))[0]
                p1 = ps.point3s("p1", np.ones((1, 3)))[0]
                corners = np.array([[p0[0], p0[1], p0[2]], [p1[0], p1[1], p1[2]]],
                                   np.float32)
                wc = np.asarray(gs.ctm.apply_point(corners))
                blo = np.minimum(wc[0], wc[1])
                bhi = np.maximum(wc[0], wc[1])
                if mtype == "cloud":
                    # reference CloudMedium (media.h:430); recipe baked to
                    # a dense grid at build (media.add_cloud)
                    named_media[nm] = b.media.add_cloud(
                        blo, bhi, sigma_a=tuple(sig_a),
                        sigma_s=tuple(sig_s), g=g, scale=mscale,
                        density=ps.float("density", 1.0),
                        wispiness=ps.float("wispiness", 1.0),
                        frequency=ps.float("frequency", 5.0))
                elif mtype == "rgbgrid":
                    # reference RGBGridMedium (media.h:355): per-voxel rgb
                    # sigma grids + optional Le emission grid
                    n3 = nx * ny * nz
                    sa_g = ps.floats("sigma_a", None)
                    ss_g = ps.floats("sigma_s", None)
                    le_g = ps.floats("Le", None)

                    def vol(vals, default):
                        if vals is None:
                            return np.full((nz, ny, nx, 3), default,
                                           np.float32)
                        v = np.asarray(vals, np.float32)
                        if v.size == 3 * n3:
                            return v.reshape(nz, ny, nx, 3)
                        return np.broadcast_to(
                            v.reshape(nz, ny, nx, 1),
                            (nz, ny, nx, 3)).astype(np.float32)

                    named_media[nm] = b.media.add_rgbgrid(
                        vol(sa_g, 1.0), vol(ss_g, 1.0), blo, bhi, g=g,
                        scale=mscale,
                        Le_rgb=vol(le_g, 0.0) if le_g is not None else None,
                        le_scale=ps.float("Lescale", 1.0))
                else:
                    dens = ps.floats("density", np.ones(nx * ny * nz))
                    named_media[nm] = b.media.add_grid(
                        np.asarray(dens, np.float32).reshape(nz, ny, nx),
                        blo, bhi, sigma_a=tuple(sig_a),
                        sigma_s=tuple(sig_s), g=g, scale=mscale)
            else:
                import warnings
                raise ParseError(f"{p.loc()}: medium type '{mtype}' is not supported")
        elif tok == "ActiveTransform":
            which = p.next()
            gs.active_transform = which
            if which in ("EndTime", "StartTime") and gs.ctm_end is None:
                gs.ctm_end = gs.ctm
        elif tok in ("Option", "ColorSpace", "MediumInterface",
                     "Attribute",
                     "TransformTimes", "StartTime", "EndTime"):
            # Option writes the layered global options (reference
            # scene.cpp:492-520 mirroring CLI flags); Attribute consumed
            if tok == "Option":
                ps_o = p.parse_params()
                from ..options import get_options
                for nm_o, (_ty, vals) in ps_o.d.items():
                    get_options().apply(nm_o, vals[0])
            elif tok == "Attribute":
                target = p.parse_string() \
                    if isinstance(p.peek(), str) and \
                    p.peek().startswith('"') else "shape"
                ps_a = p.parse_params()
                # copy-on-write: AttributeBegin snapshots via copy.copy of
                # gs.__dict__, so never mutate the shared dict/list in place
                attrs = dict(gs.attributes)
                attrs[target] = list(attrs.get(target, [])) + \
                    [((ty, nm2), vals)
                     for nm2, (ty, vals) in ps_a.d.items()]
                gs.attributes = attrs
            elif tok == "ColorSpace":
                p.parse_string()
            elif tok == "MediumInterface":
                inside = p.parse_string()
                outside = ""
                if isinstance(p.peek(), str) and p.peek().startswith('"'):
                    outside = p.parse_string()
                gs.medium_interface = (inside or None, outside or None)
            elif tok == "TransformTimes":
                p.parse_args(2)
        elif tok == "WorldBegin":
            gs.ctm = tfm.identity()
        elif tok == "WorldEnd":
            pass
        elif tok == "AttributeBegin" or tok == "TransformBegin":
            import copy
            stack.append(copy.copy(gs.__dict__))
        elif tok == "AttributeEnd" or tok == "TransformEnd":
            gs.__dict__.update(stack.pop())
        elif tok == "ObjectBegin":
            name = p.parse_string()
            objects[name] = dict(records=[], base_ctm=gs.ctm, proto=None)
            current_object = name
            import copy
            stack.append(copy.copy(gs.__dict__))
        elif tok == "ObjectEnd":
            current_object = None
            gs.__dict__.update(stack.pop())
        elif tok == "ObjectInstance":
            # real instancing (reference TransformedPrimitive,
            # cpu/primitive.h:83): meshes compile ONCE into a prototype
            # BLAS; the instance is a transform-table row. Non-mesh shapes
            # (quadrics, curves) fall back to baked duplication.
            name = p.parse_string()
            scene_ir.instances.append(sir.InstanceSceneEntity(
                name=name, params={}, loc=p.loc(directive_pos),
                ctm=gs.ctm.m))
            obj = objects.get(name)
            if obj is None:
                raise ParseError(f"{p.loc()}: ObjectInstance of unknown "
                                 f"object '{name}'")
            # Reference semantics (scene.cpp:365 ObjectInstance): the final
            # shape transform is CTM_instance @ CTM_at_definition, where the
            # definition CTM includes everything above ObjectBegin. Prototype
            # meshes below are baked BASE-RELATIVE (base_inv @ rec_ctm), so
            # the per-instance transform must restore the base:
            #   inst @ (base_inv @ rec_ctm) = ctm @ rec_ctm.
            base_inv = obj["base_ctm"].inverse()
            inst_xf = gs.ctm @ obj["base_ctm"]
            inst_xf_end = None
            if gs.ctm_end is not None and \
                    not np.allclose(np.asarray(gs.ctm_end.m),
                                    np.asarray(gs.ctm.m)):
                inst_xf_end = gs.ctm_end @ obj["base_ctm"]
            if obj["proto"] is None:
                obj["proto"] = b.new_prototype()
                obj["nonmesh"] = []
                for rec in obj["records"]:
                    if rec["name"] in ("trianglemesh", "plymesh",
                                       "bilinearmesh"):
                        if rec["emission"] is not None:
                            raise ParseError(
                                f"{p.loc()}: emissive instanced geometry "
                                "is not supported")
                        obj_xf = base_inv @ rec["ctm"]
                        P, idx, N, uv = mesh_data_for_record(rec)
                        Pw = np.asarray(obj_xf.apply_point(P), np.float32)
                        Nw = np.asarray(obj_xf.apply_normal(N), np.float32) \
                            if N is not None else None
                        b.add_proto_mesh(obj["proto"], Pw, idx, rec["mat"],
                                         normals=Nw, uvs=uv)
                    else:
                        obj["nonmesh"].append(rec)
            b.add_instance(obj["proto"], inst_xf,
                           object_to_world_end=inst_xf_end)
            # Non-mesh records are re-baked from their FULL definition CTM
            # (instantiate_shape applies instance_xf @ rec["ctm"]), so they
            # take the raw instance CTM, not the base-composed one.
            for rec in obj["nonmesh"]:
                instantiate_shape(rec, gs.ctm)
        elif tok == "ReverseOrientation":
            gs.reverse_orientation = not gs.reverse_orientation
        elif tok == "Shape":
            name = p.parse_string()
            ps = _with_attributes(gs, "shape", p.parse_params())
            if pending_face_textures and name in ("trianglemesh", "plymesh",
                                                  "bilinearmesh"):
                for ti in pending_face_textures:
                    b.textures.bind_face_texture(ti, len(b.v0))
                pending_face_textures.clear()
            scene_ir.shapes.append(sir.ShapeSceneEntity(
                name=name, params=dict(ps.d), loc=p.loc(directive_pos),
                ctm=gs.ctm.m, material=gs.material if gs.material else 0,
                reverse_orientation=gs.reverse_orientation,
                area_light=gs.area_light is not None,
                inside_medium=(gs.medium_interface or (-1, -1))[0],
                outside_medium=(gs.medium_interface or (-1, -1))[1]))
            add_shape(name, ps, gs)
        elif tok == "Material":
            name = p.parse_string()
            ps = _with_attributes(gs, "material", p.parse_params())
            scene_ir.materials.append(sir.SceneEntity(
                name=name, params=dict(ps.d), loc=p.loc(directive_pos)))
            gs.material = make_material(name, ps)
        elif tok == "MakeNamedMaterial":
            nm = p.parse_string()
            ps = p.parse_params()
            ty = ps.string("type", "diffuse")
            scene_ir.named_materials[nm] = sir.SceneEntity(
                name=ty, params=dict(ps.d), loc=p.loc(directive_pos))
            named_materials[nm] = make_material(ty, ps)
        elif tok == "NamedMaterial":
            nm = p.parse_string()
            gs.material = named_materials.get(nm, 0)
        elif tok == "Texture":
            nm = p.parse_string()
            ty = p.parse_string()
            cls = p.parse_string()
            scene_ir.textures.append(sir.SceneEntity(
                name=f"{nm}:{ty}:{cls}", params={},
                loc=p.loc(directive_pos)))
            ps = _with_attributes(gs, "texture", p.parse_params())

            def tex_child(pname, default=(0.5, 0.5, 0.5)):
                """Resolve a texture-or-value parameter to a texture pool
                index (constants become constant rows)."""
                t = ps.texture_name(pname)
                if t is not None and t in named_textures:
                    e = named_textures[t]
                    if e[0] == "tex":
                        return e[1]
                    if e[0] == "constant":
                        return b.textures.add_constant((e[1],) * 3)
                rgb = ps.rgb(pname, None)
                if rgb is None:
                    f = ps.float(pname, None)
                    rgb = (f,) * 3 if f is not None else default
                return b.textures.add_constant(tuple(rgb))

            uscale = ps.float("uscale", 1.0)
            vscale = ps.float("vscale", 1.0)
            mapping = ps.string("mapping", "uv")
            if mapping not in ("uv", "spherical", "cylindrical", "planar"):
                raise ParseError(f"{p.loc()}: unknown texture mapping "
                                 f"{mapping!r}")
            if mapping != "uv":
                # uscale/vscale are UVMapping parameters only
                # (reference textures.h:86-201)
                uscale = vscale = 1.0

            def _apply_mapping(ti, ps=ps, mapping=mapping, gs=gs):
                """Attach a non-UV TextureMapping2D to texture row ti:
                spherical/cylindrical use the inverse CTM as the
                world-to-texture transform; planar packs v1/v2 + deltas."""
                if mapping == "uv":
                    return ti
                if mapping == "planar":
                    v1 = ps.point3s("v1", np.asarray([[1.0, 0, 0]]))[0]
                    v2 = ps.point3s("v2", np.asarray([[0, 1.0, 0]]))[0]
                    w2t = np.zeros((3, 4), np.float32)
                    w2t[0, :3] = np.asarray(v1, np.float32)
                    w2t[0, 3] = ps.float("udelta", 0.0)
                    w2t[1, :3] = np.asarray(v2, np.float32)
                    w2t[1, 3] = ps.float("vdelta", 0.0)
                else:
                    w2t = np.asarray(gs.ctm.inverse().m,
                                     np.float32)[:3, :4]
                b.textures.set_mapping(ti, mapping, w2t)
                return ti
            if cls == "constant":
                if ty == "float":
                    named_textures[nm] = ("constant", ps.float("value", 1.0))
                else:
                    rgb = ps.rgb("value", (1.0,) * 3)
                    named_textures[nm] = (
                        "tex", b.textures.add_constant(tuple(rgb)))
            elif cls == "ptex":
                # baked-Ptex route (reference textures.h:921 PtexTexture;
                # SURVEY hard-part #4: convert offline to array form).
                # filename: .npz with a per-face "rgb" (F, 3) array — bake
                # with the external ptxconvert tooling. The texture binds to
                # the NEXT declared mesh shape (ptex data is mesh-specific).
                fn = ps.string("filename", "")
                path = Path(base_dir) / fn
                if not str(fn).endswith(".npz") or not path.exists():
                    raise ParseError(
                        f"{p.loc()}: ptex textures must be baked offline to "
                        f"a per-face .npz (got {fn!r}); see "
                        "pbrt_jax/textures.py TEX_FACE")
                face_rgb = np.load(path)["rgb"]
                ti = b.textures.add_face_texture(face_rgb)
                pending_face_textures.append(ti)
                named_textures[nm] = ("tex", ti)
            elif cls == "checkerboard":
                t1 = ps.rgb("tex1", (1.0,) * 3)
                t2 = ps.rgb("tex2", (0.0,) * 3)
                named_textures[nm] = (
                    "tex", _apply_mapping(b.textures.add_checker(
                        tuple(t1), tuple(t2), su=uscale, sv=vscale)))
            elif cls == "imagemap":
                fn = ps.string("filename", None)
                if fn is None:
                    raise ParseError(f"{p.loc()}: imagemap needs filename")
                img = _read_any_image(Path(base_dir) / fn)
                if ty == "float":
                    # raw-valued map (alpha masks, roughness, bump):
                    # values, not reflectance coefficients
                    if img.ndim == 2:
                        img = img[..., None]
                    img3 = np.repeat(img[..., :1], 3, axis=-1) \
                        if img.shape[-1] < 3 else img[..., :3]
                    named_textures[nm] = (
                        "ftex", _apply_mapping(b.textures.add_image_raw(
                            np.asarray(img3, np.float32),
                            su=uscale, sv=vscale)))
                else:
                    if not str(fn).endswith((".exr", ".pfm")):
                        from ..utils.color import srgb_to_linear
                        img = np.asarray(srgb_to_linear(img), np.float32)
                    named_textures[nm] = (
                        "tex", _apply_mapping(b.textures.add_image(
                            img[..., :3], su=uscale, sv=vscale,
                            scale=ps.float("scale", 1.0))))
            elif cls == "scale":
                # tex * scale expressed through the mix family:
                # mix(black, tex, amount=s) == s * tex for s in [0, 1]
                s_val = ps.float("scale", 1.0)
                child = tex_child("tex", (1.0,) * 3)
                if 0.0 <= s_val <= 1.0:
                    black = b.textures.add_constant((0.0,) * 3)
                    named_textures[nm] = (
                        "tex", b.textures.add_mix(black, child,
                                                  amount=s_val))
                else:
                    raise ParseError(
                        f"{p.loc()}: scale texture with scale > 1 is not "
                        "supported")
            elif cls == "mix":
                named_textures[nm] = (
                    "tex", b.textures.add_mix(tex_child("tex1"),
                                              tex_child("tex2"),
                                              amount=ps.float("amount",
                                                              0.5)))
            elif cls == "directionmix":
                dirv = ps.point3s("dir", np.asarray([[0, 1.0, 0]]))[0]
                named_textures[nm] = (
                    "tex", b.textures.add_direction_mix(
                        tex_child("tex1"), tex_child("tex2"),
                        dir=tuple(np.asarray(gs.ctm.apply_vector(
                            np.asarray(dirv, np.float32))))))
            elif cls == "bilerp":
                v00 = ps.rgb("v00", (0.0,) * 3)
                v01 = ps.rgb("v01", (1.0,) * 3)
                v10 = ps.rgb("v10", (0.0,) * 3)
                v11 = ps.rgb("v11", (1.0,) * 3)
                named_textures[nm] = (
                    "tex", b.textures.add_bilerp(tuple(v00), tuple(v10),
                                                 tuple(v01), tuple(v11)))
            elif cls == "dots":
                t1 = ps.rgb("inside", (1.0,) * 3)
                t2 = ps.rgb("outside", (0.0,) * 3)
                named_textures[nm] = (
                    "tex", _apply_mapping(b.textures.add_dots(
                        tuple(t1), tuple(t2), su=uscale, sv=vscale)))
            elif cls in ("fbm", "wrinkled"):
                add = dict(fbm=b.textures.add_fbm,
                           wrinkled=b.textures.add_wrinkled)
                named_textures[nm] = (
                    "tex", add[cls](octaves=ps.int("octaves", 6),
                                    omega=ps.float("roughness", 0.5)))
            elif cls == "windy":
                named_textures[nm] = ("tex", b.textures.add_windy())
            else:
                named_textures[nm] = ("unsupported", cls)
        elif tok == "LightSource":
            name = p.parse_string()
            ps = _with_attributes(gs, "light", p.parse_params())
            scene_ir.lights.append(sir.LightSceneEntity(
                name=name, params=dict(ps.d), loc=p.loc(directive_pos),
                ctm=gs.ctm.m))
            scale = ps.float("scale", 1.0)
            if name == "point":
                s = ps.spectrum("I", cs, kind="illuminant",
                                default=spc.d65_spectrum())
                from_p = ps.point3s("from", np.zeros((1, 3)))[0]
                pos = np.asarray(gs.ctm.apply_point(
                    np.asarray(from_p, np.float32)))
                b.add_point_light(pos, s, scale)
            elif name == "distant":
                s = ps.spectrum("L", cs, kind="illuminant",
                                default=spc.d65_spectrum())
                fr = ps.point3s("from", np.zeros((1, 3)))[0]
                to = ps.point3s("to", np.asarray([[0, 0, 1.0]]))[0]
                d = np.asarray(gs.ctm.apply_vector(
                    np.asarray(to - fr, np.float32)))
                b.add_distant_light(d, s, scale)
            elif name == "spot":
                s = ps.spectrum("I", cs, kind="illuminant",
                                default=spc.d65_spectrum())
                fr = ps.point3s("from", np.zeros((1, 3)))[0]
                to = ps.point3s("to", np.asarray([[0, 0, 1.0]]))[0]
                pos = np.asarray(gs.ctm.apply_point(np.asarray(fr, np.float32)))
                d = np.asarray(gs.ctm.apply_vector(np.asarray(to - fr, np.float32)))
                b.add_spot_light(pos, d, s, scale,
                                 cone_angle=ps.float("coneangle", 30.0),
                                 cone_delta=ps.float("conedeltaangle", 5.0))
            elif name == "infinite":
                fn = ps.string("filename", None)
                if fn is None:
                    s = ps.spectrum("L", cs, kind="illuminant",
                                    default=spc.d65_spectrum())
                    b.add_uniform_infinite_light(s, scale)
                else:
                    from ..utils import image as pimg
                    from ..utils import image_env
                    fp = Path(base_dir) / fn
                    if fn.endswith(".exr"):
                        img = pimg.read_exr(fp)
                    elif fn.endswith(".pfm"):
                        img = pimg.read_pfm(fp)
                    else:
                        img = pimg.read_png(fp).astype(np.float32) / 255.0
                    if img.shape[0] != img.shape[1]:
                        # lat-long: resample to equal-area octahedral
                        img = image_env.equalarea_from_latlong(img)
                    portal = ps.point3s("portal", None)
                    if portal is not None and len(portal) == 4:
                        pc = np.asarray(gs.ctm.apply_point(
                            np.asarray(portal, np.float32)))
                        b.add_portal_infinite_light(img, pc, scale)
                    else:
                        b.add_image_infinite_light(img, scale)
            elif name == "projection":
                sI = ps.spectrum("I", cs, kind="illuminant",
                                 default=spc.d65_spectrum())
                fn = ps.string("filename", None)
                img = _read_any_image(Path(base_dir) / fn) if fn else \
                    np.ones((2, 2, 3), np.float32)
                pos = np.asarray(gs.ctm.apply_point(np.zeros(3, np.float32)))
                d = np.asarray(gs.ctm.apply_vector(
                    np.asarray([0, 0, 1.0], np.float32)))
                b.add_projection_light(pos, d, img, sI, scale,
                                       fov=ps.float("fov", 90.0))
            elif name == "goniometric":
                sI = ps.spectrum("I", cs, kind="illuminant",
                                 default=spc.d65_spectrum())
                fn = ps.string("filename", None)
                img = _read_any_image(Path(base_dir) / fn) if fn else \
                    np.ones((2, 2, 3), np.float32)
                if img.shape[0] != img.shape[1]:
                    from ..utils import image_env
                    img = image_env.equalarea_from_latlong(img)
                fr = ps.point3s("from", np.zeros((1, 3)))[0]
                pos = np.asarray(gs.ctm.apply_point(
                    np.asarray(fr, np.float32)))
                b.add_goniometric_light(pos, img, sI, scale)
            else:
                raise ParseError(f"{p.loc()}: light '{name}' is not supported")
        elif tok == "AreaLightSource":
            _name = p.parse_string()
            ps = _with_attributes(gs, "arealight", p.parse_params())
            scene_ir.area_lights.append(sir.SceneEntity(
                name=_name, params=dict(ps.d), loc=p.loc(directive_pos)))
            s = ps.spectrum("L", cs, kind="illuminant",
                            default=spc.d65_spectrum())
            gs.area_light = (s, ps.float("scale", 1.0),
                             ps.bool("twosided", False))
        else:
            raise ParseError(f"{p.loc(directive_pos)}: "
                             f"unknown directive {tok!r}")

    scene = b.build(light_sampler=light_sampler, force_bvh=force_bvh,
                    accelerator=accel_kind)
    if cam_params["kind"] == "realistic":
        camera = cam_mod.make_realistic_camera(
            camera_from_world=cam_params["camera_from_world"],
            width=film_params["xres"], height=film_params["yres"],
            focus_distance=cam_params.get("focal_distance", 3.0) or 3.0,
            aperture_diameter=cam_params.get("aperture_diameter"))
    else:
        camera = cam_mod.make_camera(
            cam_params["kind"],
            camera_from_world=cam_params["camera_from_world"],
            width=film_params["xres"], height=film_params["yres"],
            fov=cam_params.get("fov", 90.0),
            lens_radius=cam_params.get("lens_radius", 0.0),
            focal_distance=cam_params.get("focal_distance", 1e6))
    sampler = smp.make_sampler(sampler_params["kind"], spp=sampler_params["spp"],
                               full_resolution=(film_params["xres"],
                                                film_params["yres"]))
    filter_ = flt.make_filter(filter_params.get("kind", "gaussian"),
                              xradius=filter_params.get("xradius"),
                              yradius=filter_params.get("yradius"))
    return PbrtSceneDescription(scene, camera, sampler, filter_, integrator,
                                film_params, ir=scene_ir)
