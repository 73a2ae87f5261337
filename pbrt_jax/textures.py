"""Textures (reference textures.{h,cpp}: 28 concrete types, base/texture.h).

Design: all images live in ONE flat atlas array whose texels are
PRE-CONVERTED sigmoid-polynomial coefficients + scale (RGB->spectrum
conversion runs at scene compile on host, so the device never touches the
64^3 conversion table); each texture is a descriptor row. Procedural
textures (checker, noise family) are elementwise. Evaluation is
select-over-tags with at most one atlas gather, returning
(coeffs (N,3), scale (N,)) — spectral albedo = sigmoid(coeffs, lam) * scale.

Round-1 texture set: constant, scale, image (bilinear, repeat/clamp),
checkerboard (2 constant/image children pre-resolved), UV mapping with
scale/offset, fbm/turbulence/marble via Perlin noise.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from .utils import struct

from .ops.gather import pool_lookup, f32_to_i32

TEX_CONSTANT = 0
TEX_IMAGE = 1
TEX_CHECKER = 2
TEX_SCALE = 3
TEX_FBM = 4
TEX_MARBLE = 5
TEX_WINDY = 6
TEX_WRINKLED = 7
TEX_DOTS = 8
# mix family (reference textures.h:803-900 FloatMix/SpectrumMix,
# :831 DirectionMix, :333 Bilerp): rows hold CHILD texture indices in
# cols 4-7; children are evaluated and blended SPECTRALLY (sigmoid
# coefficients cannot be lerped), one nesting level deep
TEX_MIX = 9       # (1-amt)*t1 + amt*t2, amt const in col 8
TEX_DIRMIX = 10   # absdot(n, dir)*t1 + (1-.)*t2, dir in cols 10:13
TEX_BILERP = 11   # Bilerp(st; v00, v10, v01, v11) over 4 children
TEX_FACE = 12     # per-face constant color (the baked-Ptex route:
                  # reference textures.h:921 PtexTexture; SURVEY hard-part
                  # #4 sanctions offline conversion to array form). desc:
                  # img_offset = first atlas row, width = n_faces,
                  # value_b[0] (col 7) = base_prim (global id of the bound
                  # shape's first triangle)

# descriptor columns
# [0]=tag [1]=img_offset [2]=width [3]=height [4:7]=value_a(rgb)
# [7:10]=value_b(rgb) [10]=su [11]=sv [12]=du [13]=dv [14]=octaves [15]=omega/roughness
TEX_COLS = 16

# 2D texture-coordinate mappings (reference textures.h:86-201
# TextureMapping2D: UVMapping / SphericalMapping / CylindricalMapping /
# PlanarMapping). Stored per texture as a (13,) row: [tag, world-to-texture
# affine (3x4, row-major)]. Planar packs vs/ds in row 0 and vt/dt in row 1.
MAP_UV = 0
MAP_SPHERICAL = 1
MAP_CYLINDRICAL = 2
MAP_PLANAR = 3


@struct.dataclass
class TexturePool:
    desc: jnp.ndarray    # (K, TEX_COLS) f32 descriptor rows
    atlas: jnp.ndarray   # (A, 4) flat texel pool: [c0, c1, c2, scale]
    # MIP pyramid (reference util/mipmap.h:49): per-texture level count +
    # up to 15 level offsets into the atlas; level l has dims
    # (max(w>>l,1), max(h>>l,1)). Built by 2x2 box downsampling of the
    # pow2-resampled base image.
    mips: jnp.ndarray = None   # (K, 16): [n_levels, off0..off14]
    has_image: bool = struct.field(pytree_node=False, default=False)
    has_procedural: bool = struct.field(pytree_node=False, default=False)
    has_mips: bool = struct.field(pytree_node=False, default=False)
    # scene contains mix/directionmix/bilerp rows: albedo lookups route
    # through eval_texture_spectral's child-blending path
    has_mixers: bool = struct.field(pytree_node=False, default=False)
    # scene contains per-face (baked-Ptex) rows
    has_face: bool = struct.field(pytree_node=False, default=False)
    # per-texture coordinate mapping rows (K, 13): [tag, w2t 3x4]; None /
    # has_mapped=False when every texture uses plain UV (the common case —
    # the mapping select is skipped entirely then)
    maps: jnp.ndarray = None
    has_mapped: bool = struct.field(pytree_node=False, default=False)


class TextureBuilder:
    def __init__(self, colorspace=None):
        from .utils import color as pcolor
        self.cs = colorspace or pcolor.srgb()
        self.rows = []
        self.mip_rows = []
        self.map_rows = []
        self.atlas = [np.zeros((1, 4), np.float32)]
        self.atlas_size = 1

    def _rgb_to_coeffs_scale(self, rgb):
        """RGB (any positive range) -> (coeffs (...,3), scale (...)) such that
        sigmoid(coeffs) * scale reproduces rgb (RGBUnboundedSpectrum logic)."""
        rgb = np.asarray(rgb, np.float32).reshape(-1, 3)
        m = np.maximum(rgb.max(axis=-1), 1e-9)
        scale = np.where(rgb.max(axis=-1) > 1.0, 2.0 * m, 1.0).astype(np.float32)
        coeffs = self.cs.to_spectrum_coeffs(rgb / scale[:, None])
        return coeffs, scale

    @staticmethod
    def _resample_pow2(img):
        """Box-resample (H, W, C) to the next pow2 dims (reference
        MIPMap generation resamples to pow2, mipmap.cpp)."""
        h, w = img.shape[:2]
        ph = 1 << max(int(np.ceil(np.log2(max(h, 1)))), 0)
        pw = 1 << max(int(np.ceil(np.log2(max(w, 1)))), 0)
        if (ph, pw) == (h, w):
            return img
        ys = np.minimum((np.arange(ph) * h) // ph, h - 1)
        xs = np.minimum((np.arange(pw) * w) // pw, w - 1)
        return img[ys][:, xs]

    @staticmethod
    def _pyramid(img):
        """[level0, level1, ...] by 2x2 box filter down to 1x1."""
        levels = [img]
        while img.shape[0] > 1 or img.shape[1] > 1:
            h, w = img.shape[:2]
            h2, w2 = max(h // 2, 1), max(w // 2, 1)
            if h > 1 and w > 1:
                img = 0.25 * (img[0::2, 0::2][:h2, :w2] +
                              img[1::2, 0::2][:h2, :w2] +
                              img[0::2, 1::2][:h2, :w2] +
                              img[1::2, 1::2][:h2, :w2])
            elif h > 1:
                img = 0.5 * (img[0::2][:h2] + img[1::2][:h2])
            else:
                img = 0.5 * (img[:, 0::2][:, :w2] + img[:, 1::2][:, :w2])
            levels.append(img)
        return levels

    def _add_mip_levels(self, img, to_texels):
        """Append the full pyramid of `img` to the atlas; returns
        (base_offset, n_levels, offsets list). to_texels maps an (N, C)
        image slab to (N, 4) atlas texels."""
        img = self._resample_pow2(img)
        offsets = []
        for lv in self._pyramid(img):
            offsets.append(self.atlas_size)
            t = to_texels(lv.reshape(-1, lv.shape[-1]))
            self.atlas.append(t)
            self.atlas_size += t.shape[0]
        return img, offsets

    def _add_row(self, **kw):
        row = np.zeros(TEX_COLS, np.float32)
        row[0] = kw.get("tag", TEX_CONSTANT)
        row[1] = kw.get("img_offset", 0)
        row[2] = kw.get("width", 0)
        row[3] = kw.get("height", 0)
        row[4:7] = kw.get("value_a", (0, 0, 0))
        row[7:10] = kw.get("value_b", (0, 0, 0))
        row[10] = kw.get("su", 1.0)
        row[11] = kw.get("sv", 1.0)
        row[12] = kw.get("du", 0.0)
        row[13] = kw.get("dv", 0.0)
        row[14] = kw.get("octaves", 6)
        row[15] = kw.get("omega", 0.5)
        self.rows.append(row)
        mip = np.zeros(16, np.float32)
        offs = kw.get("mip_offsets") or []
        mip[0] = len(offs)
        mip[1:1 + min(len(offs), 15)] = offs[:15]
        self.mip_rows.append(mip)
        mr = np.zeros(13, np.float32)
        mr[1:13] = np.eye(3, 4, dtype=np.float32).reshape(-1)
        self.map_rows.append(mr)
        return len(self.rows) - 1

    def set_mapping(self, tex_idx, kind, w2t=None):
        """Attach a non-UV coordinate mapping (reference textures.h:86-201).

        kind: "spherical" | "cylindrical" | "planar"; w2t: (3, 4) affine
        world-to-texture transform (for planar, rows are [vs, ds] / [vt, dt])."""
        tag = {"uv": MAP_UV, "spherical": MAP_SPHERICAL,
               "cylindrical": MAP_CYLINDRICAL, "planar": MAP_PLANAR}[kind]
        mr = self.map_rows[tex_idx]
        mr[0] = float(tag)
        if w2t is not None:
            mr[1:13] = np.asarray(w2t, np.float32).reshape(-1)[:12]

    def add_constant(self, rgb):
        c, s = self._rgb_to_coeffs_scale(np.broadcast_to(np.asarray(rgb, np.float32), (1, 3)))
        return self._add_row(tag=TEX_CONSTANT, value_a=c[0], value_b=(s[0], 0, 0))

    def add_image(self, img, su=1.0, sv=1.0, du=0.0, dv=0.0, scale=1.0,
                  mip=True):
        """img: (H, W, 3) float32 linear RGB (texels baked to coeffs).
        mip=True builds the full pyramid (reference mipmap.h:49)."""
        img = np.asarray(img, np.float32)
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, -1)

        def to_texels(flat_rgb):
            c, s = self._rgb_to_coeffs_scale(flat_rgb * scale)
            return np.concatenate([c, s[:, None]], 1)

        if mip:
            img, offs = self._add_mip_levels(img, to_texels)
            h, w = img.shape[:2]
            return self._add_row(tag=TEX_IMAGE, img_offset=offs[0], width=w,
                                 height=h, su=su, sv=sv, du=du, dv=dv,
                                 mip_offsets=offs)
        h, w = img.shape[:2]
        off = self.atlas_size
        self.atlas.append(to_texels(img.reshape(-1, 3)))
        self.atlas_size += h * w
        return self._add_row(tag=TEX_IMAGE, img_offset=off, width=w, height=h,
                             su=su, sv=sv, du=du, dv=dv)

    def add_image_raw(self, img, su=1.0, sv=1.0, du=0.0, dv=0.0):
        """RAW image texture: texels stored as-is (rgb, 1), not converted to
        spectrum coefficients — for normal maps and float textures (bump
        heights, roughness maps) where values are data, not colors."""
        img = np.asarray(img, np.float32)
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, -1)
        h, w = img.shape[:2]
        texels = np.concatenate([img.reshape(-1, 3),
                                 np.ones((h * w, 1), np.float32)], 1)
        off = self.atlas_size
        self.atlas.append(texels)
        self.atlas_size += h * w
        r = self._add_row(tag=TEX_IMAGE, img_offset=off, width=w, height=h,
                          su=su, sv=sv, du=du, dv=dv)
        self.rows[-1][14] = 1.0  # raw flag (octaves slot is unused by images)
        return r

    def add_constant_float(self, value):
        """Float texture with a constant value (for roughness/bump)."""
        r = self._add_row(tag=TEX_CONSTANT, value_a=(0, 0, 0),
                          value_b=(0, 0, 0))
        self.rows[-1][4:7] = value  # raw value in the coeff slots
        self.rows[-1][7] = 1.0
        self.rows[-1][14] = 1.0  # raw flag
        return r

    def add_checker(self, rgb1, rgb2, su=1.0, sv=1.0):
        c1, s1 = self._rgb_to_coeffs_scale(np.broadcast_to(np.asarray(rgb1, np.float32), (1, 3)))
        c2, s2 = self._rgb_to_coeffs_scale(np.broadcast_to(np.asarray(rgb2, np.float32), (1, 3)))
        r = self._add_row(tag=TEX_CHECKER, value_a=c1[0], value_b=c2[0],
                          su=su, sv=sv)
        self.rows[-1][14] = s1[0]
        self.rows[-1][15] = s2[0]
        return r

    def add_scale(self, rgb, scale):
        c, s = self._rgb_to_coeffs_scale(np.broadcast_to(np.asarray(rgb, np.float32), (1, 3)))
        return self._add_row(tag=TEX_SCALE, value_a=c[0],
                             value_b=(s[0] * scale, 0, 0))

    def add_windy(self, scale=1.0):
        """Windy waves: low-freq wind strength x high-freq waves
        (reference WindyTexture, texture.h)."""
        c, s = self._rgb_to_coeffs_scale(np.full((1, 3), 0.5, np.float32))
        return self._add_row(tag=TEX_WINDY, value_a=c[0],
                             value_b=(s[0] * scale, 0, 0))

    def add_wrinkled(self, octaves=6, omega=0.5, scale=1.0):
        """Turbulence-valued texture (reference WrinkledTexture)."""
        c, s = self._rgb_to_coeffs_scale(np.full((1, 3), 0.5, np.float32))
        return self._add_row(tag=TEX_WRINKLED, octaves=octaves, omega=omega,
                             value_a=c[0], value_b=(s[0] * scale, 0, 0))

    def add_dots(self, rgb_inside, rgb_outside, su=1.0, sv=1.0):
        """Polka-dot texture (reference DotsTexture, texture.h): one
        randomly-jittered dot per uv cell."""
        c1, s1 = self._rgb_to_coeffs_scale(
            np.broadcast_to(np.asarray(rgb_inside, np.float32), (1, 3)))
        c2, s2 = self._rgb_to_coeffs_scale(
            np.broadcast_to(np.asarray(rgb_outside, np.float32), (1, 3)))
        r = self._add_row(tag=TEX_DOTS, value_a=c1[0], value_b=c2[0],
                          su=su, sv=sv)
        self.rows[-1][14] = s1[0]
        self.rows[-1][15] = s2[0]
        return r

    def add_mix(self, tex1: int, tex2: int, amount=0.5):
        """(1-amount)*tex1 + amount*tex2 (reference SpectrumMixTexture,
        textures.h:862). Children blended spectrally at eval."""
        return self._add_row(tag=TEX_MIX,
                             value_a=(float(tex1), float(tex2), 0.0),
                             value_b=(0.0, float(amount), 0.0))

    def add_direction_mix(self, tex1: int, tex2: int, dir=(0.0, 1.0, 0.0)):
        """absdot(n, dir)*tex1 + (1-.)*tex2 (reference
        DirectionMixTexture, textures.h:831)."""
        dn = np.asarray(dir, np.float32)
        dn = dn / max(float(np.linalg.norm(dn)), 1e-9)
        return self._add_row(tag=TEX_DIRMIX,
                             value_a=(float(tex1), float(tex2), 0.0),
                             su=dn[0], sv=dn[1], du=dn[2])

    def add_bilerp(self, rgb00, rgb10, rgb01, rgb11):
        """Bilinear blend of four corner reflectances over (u, v)
        (reference SpectrumBilerpTexture, textures.h:333). Corners are
        stored as constant child rows and blended spectrally."""
        kids = [self.add_constant(c) for c in (rgb00, rgb10, rgb01, rgb11)]
        return self._add_row(tag=TEX_BILERP,
                             value_a=(float(kids[0]), float(kids[1]),
                                      float(kids[2])),
                             value_b=(float(kids[3]), 0.0, 0.0))

    def add_fbm(self, octaves=6, omega=0.5, scale=1.0):
        # fbm modulates a flat 0.5 reflectance by the noise value
        c, s = self._rgb_to_coeffs_scale(np.full((1, 3), 0.5, np.float32))
        return self._add_row(tag=TEX_FBM, octaves=octaves, omega=omega,
                             value_a=c[0], value_b=(s[0] * scale, 0, 0))

    def add_face_texture(self, face_rgb, base_prim=-1):
        """Per-face constant colors (baked-Ptex per-face reduction).

        face_rgb: (F, 3); base_prim: global index of the bound shape's
        first triangle (set later via bind_face_texture when -1)."""
        face_rgb = np.asarray(face_rgb, np.float32).reshape(-1, 3)
        coeffs, scale = self._rgb_to_coeffs_scale(face_rgb)
        off = self.atlas_size
        t = np.concatenate([coeffs, scale[:, None]], 1).astype(np.float32)
        self.atlas.append(t)
        self.atlas_size += t.shape[0]
        return self._add_row(tag=TEX_FACE, img_offset=off,
                             width=len(face_rgb),
                             value_b=(float(base_prim), 0, 0))

    def bind_face_texture(self, tex_idx, base_prim):
        """Late-bind the shape's first-triangle id (parser calls this when
        the mesh using the texture is declared)."""
        self.rows[tex_idx][7] = float(base_prim)

    def build(self) -> TexturePool:
        if not self.rows:
            self._add_row(tag=TEX_CONSTANT, value_a=(0.5, 0.5, 0.5))
        tags = {int(r[0]) for r in self.rows}
        mips = np.stack(self.mip_rows)
        maps = np.stack(self.map_rows)
        has_mapped = bool((maps[:, 0] != 0).any())
        return TexturePool(desc=jnp.asarray(np.stack(self.rows)),
                           atlas=jnp.asarray(np.concatenate(self.atlas)),
                           mips=jnp.asarray(mips),
                           maps=jnp.asarray(maps) if has_mapped else None,
                           has_mapped=has_mapped,
                           has_image=TEX_IMAGE in tags,
                           has_procedural=bool(tags & {TEX_FBM, TEX_MARBLE,
                                                       TEX_WINDY,
                                                       TEX_WRINKLED}),
                           has_mips=bool((mips[:, 0] > 1).any()),
                           has_face=TEX_FACE in tags,
                           has_mixers=bool(tags & {TEX_MIX, TEX_DIRMIX,
                                                   TEX_BILERP}))


# ---------------------------------------------------------------------------
# Perlin noise (reference util/noise.cpp) — hash-based gradient noise so it
# needs no permutation-table gathers.

def _grad(ix, iy, iz, fx, fy, fz):
    from .utils.rng import hash_u32
    h = hash_u32(ix.astype(jnp.uint32), iy.astype(jnp.uint32),
                 iz.astype(jnp.uint32)) & jnp.uint32(15)
    h = h.astype(jnp.int32)
    u = jnp.where(h < 8, fx, fy)
    v = jnp.where(h < 4, fy, jnp.where((h == 12) | (h == 14), fx, fz))
    return jnp.where(h & 1 == 0, u, -u) + jnp.where(h & 2 == 0, v, -v)


def perlin_noise(p):
    """p: (..., 3) -> (...) in about [-1, 1]."""
    pi = jnp.floor(p)
    pf = p - pi
    ix = pi[..., 0].astype(jnp.int32)
    iy = pi[..., 1].astype(jnp.int32)
    iz = pi[..., 2].astype(jnp.int32)
    fx, fy, fz = pf[..., 0], pf[..., 1], pf[..., 2]

    def fade(t):
        return t * t * t * (t * (t * 6 - 15) + 10)

    u, v, w = fade(fx), fade(fy), fade(fz)
    n = 0.0
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                g = _grad(ix + dx, iy + dy, iz + dz,
                          fx - dx, fy - dy, fz - dz)
                wt = (u if dx else (1 - u)) * (v if dy else (1 - v)) * \
                     (w if dz else (1 - w))
                n = n + wt * g
    return n


def turbulence(p, octaves, omega):
    """Sum of |noise| octaves (reference util/noise.cpp Turbulence)."""
    total = jnp.zeros(p.shape[:-1], jnp.float32)
    lam = 1.0
    o = 1.0
    for _ in range(int(octaves)):
        total = total + o * jnp.abs(perlin_noise(p * lam))
        lam *= 1.99
        o *= omega
    return total


def fbm(p, octaves, omega):
    """Fractional Brownian motion (reference util/noise.cpp FBm)."""
    total = jnp.zeros(p.shape[:-1], jnp.float32)
    lam = 1.0
    o = 1.0
    for _ in range(int(octaves)):
        total = total + o * perlin_noise(p * lam)
        lam *= 1.99
        o *= omega
    return total


# ---------------------------------------------------------------------------
# Evaluation

def _bilinear_at(pool: TexturePool, base, w_img, h_img, u, v):
    """Bilinear 4-tap fetch at an explicit level (base offset + dims);
    ONE fused gather."""
    uu = (u - jnp.floor(u)) * w_img - 0.5
    vv = (v - jnp.floor(v)) * h_img - 0.5
    x0 = jnp.floor(uu)
    y0 = jnp.floor(vv)
    fx = (uu - x0)[..., None]
    fy = (vv - y0)[..., None]

    def wrap(x, n):
        return jnp.mod(x, jnp.maximum(n, 1.0))

    xs = jnp.stack([wrap(x0, w_img), wrap(x0 + 1, w_img)], -1)  # (N, 2)
    ys = jnp.stack([wrap(y0, h_img), wrap(y0 + 1, h_img)], -1)
    idx = (base[..., None, None] + ys[..., :, None] * w_img[..., None, None] +
           xs[..., None, :])                            # (N, 2, 2)
    texels = pool.atlas[f32_to_i32(idx)]                # ONE gather (N,2,2,4)
    c00, c01 = texels[..., 0, 0, :], texels[..., 0, 1, :]
    c10, c11 = texels[..., 1, 0, :], texels[..., 1, 1, :]
    return (c00 * (1 - fx) * (1 - fy) + c01 * fx * (1 - fy) +
            c10 * (1 - fx) * fy + c11 * fx * fy)


def _image_bilinear(pool: TexturePool, row, u, v):
    """Base-level bilinear fetch."""
    return _bilinear_at(pool, row[..., 1], jnp.maximum(row[..., 2], 1.0),
                        jnp.maximum(row[..., 3], 1.0), u, v)


def _mip_level_geom(row, mip_row, level):
    """(base_offset, w, h) of an integer mip level (per-lane)."""
    n_lv = jnp.maximum(mip_row[..., 0], 1.0)
    level = jnp.clip(level, 0.0, n_lv - 1.0)
    # one-hot select of the level offset (15 candidates; gather-free)
    lv_i = level[..., None] == jnp.arange(15, dtype=jnp.float32)
    base = jnp.sum(mip_row[..., 1:16] * lv_i, axis=-1)
    scale = jnp.exp2(-level)
    w = jnp.maximum(jnp.floor(jnp.maximum(row[..., 2], 1.0) * scale), 1.0)
    h = jnp.maximum(jnp.floor(jnp.maximum(row[..., 3], 1.0) * scale), 1.0)
    return base, w, h


def _image_trilinear(pool: TexturePool, row, mip_row, u, v, lod):
    """Trilinear MIP filtering (reference MIPMap::Filter trilinear path,
    util/mipmap.cpp): bilinear taps at floor/ceil levels, lerped. lod is
    log2(texture-space footprint in texels at level 0)."""
    n_lv = jnp.maximum(mip_row[..., 0], 1.0)
    lod = jnp.clip(lod, 0.0, n_lv - 1.0)
    l0 = jnp.floor(lod)
    f = (lod - l0)[..., None]
    b0, w0, h0 = _mip_level_geom(row, mip_row, l0)
    b1, w1, h1 = _mip_level_geom(row, mip_row, l0 + 1.0)
    v0 = _bilinear_at(pool, b0, w0, h0, u, v)
    v1 = _bilinear_at(pool, b1, w1, h1, u, v)
    return v0 * (1.0 - f) + v1 * f


def _image_ewa(pool: TexturePool, row, mip_row, u, v, duv0, duv1):
    """EWA anisotropic filtering (reference MIPMap::EWA, mipmap.cpp:225),
    Array form: the reference loops over the ellipse's texel bbox (a
    data-dependent loop); here the ellipse is sampled with a FIXED 3x3
    Gaussian-weighted tap grid at the level chosen by the MINOR axis, which
    bounds the kernel statically (XLA needs static trip counts) while
    keeping anisotropic sharpening over trilinear.

    duv0/duv1: (N, 2) texture-space footprint axes at level 0 (in uv)."""
    w0 = jnp.maximum(row[..., 2], 1.0)
    h0 = jnp.maximum(row[..., 3], 1.0)
    # axes in texels
    a0 = jnp.stack([duv0[..., 0] * w0, duv0[..., 1] * h0], -1)
    a1 = jnp.stack([duv1[..., 0] * w0, duv1[..., 1] * h0], -1)
    len0 = jnp.sqrt(jnp.maximum(jnp.sum(a0 * a0, -1), 1e-16))
    len1 = jnp.sqrt(jnp.maximum(jnp.sum(a1 * a1, -1), 1e-16))
    major = jnp.maximum(len0, len1)
    minor = jnp.minimum(len0, len1)
    # clamp eccentricity like the reference (maxAnisotropy = 8)
    minor = jnp.maximum(minor, major / 8.0)
    lod = jnp.maximum(jnp.log2(jnp.maximum(minor, 1e-6)), 0.0)
    n_lv = jnp.maximum(mip_row[..., 0], 1.0)
    lod = jnp.clip(lod, 0.0, n_lv - 1.0)
    base, wl, hl = _mip_level_geom(row, mip_row, jnp.floor(lod))
    # 3x3 taps along the major axis direction across the ellipse
    dir_major = jnp.where((len0 >= len1)[..., None], duv0, duv1)
    acc = 0.0
    wsum = 0.0
    for i, t in enumerate((-0.66, 0.0, 0.66)):
        wgt = (0.27, 0.46, 0.27)[i]
        uu = u + t * dir_major[..., 0]
        vv = v + t * dir_major[..., 1]
        acc = acc + wgt * _bilinear_at(pool, base, wl, hl, uu, vv)
        wsum = wsum + wgt
    return acc / wsum


def apply_mapping(pool: TexturePool, tex_idx, uv, p_world):
    """Per-texture 2D coordinate mapping (reference textures.h:86-201):
    uv passthrough, or spherical / cylindrical / planar st derived from the
    world hit point through the texture's world-to-texture transform. Free
    (returns uv unchanged) unless the scene declared a non-UV mapping."""
    if not pool.has_mapped or p_world is None:
        return uv
    mrow = pool_lookup(pool.maps, jnp.maximum(tex_idx, 0))
    tag = f32_to_i32(mrow[..., 0])
    A = mrow[..., 1:13].reshape(mrow.shape[:-1] + (3, 4))
    pt = jnp.einsum("...ij,...j->...i", A[..., :3], p_world,
                    precision=jax.lax.Precision.HIGHEST) + A[..., 3]
    x, y, z = pt[..., 0], pt[..., 1], pt[..., 2]
    inv2pi = 0.5 / np.pi
    r = jnp.sqrt(jnp.maximum(x * x + y * y + z * z, 1e-20))
    theta = jnp.arccos(jnp.clip(z / r, -1.0, 1.0))
    phi = jnp.arctan2(y, x)
    phi_pos = jnp.where(phi < 0, phi + 2.0 * np.pi, phi)
    sph = jnp.stack([theta / np.pi, phi_pos * inv2pi], -1)
    cyl = jnp.stack([(np.pi + phi) * inv2pi, z], -1)
    pla = jnp.stack([x, y], -1)
    return jnp.where((tag == MAP_SPHERICAL)[..., None], sph,
           jnp.where((tag == MAP_CYLINDRICAL)[..., None], cyl,
           jnp.where((tag == MAP_PLANAR)[..., None], pla, uv)))


def eval_texture_rgb_raw(pool: TexturePool, tex_idx, uv, p_world=None):
    """RAW-valued texture lookup: returns (N, 3) data values (normal maps /
    float maps added via add_image_raw / add_constant_float)."""
    row = pool_lookup(pool.desc, jnp.maximum(tex_idx, 0))
    tag = f32_to_i32(row[..., 0])
    uv = apply_mapping(pool, tex_idx, uv, p_world)
    u = uv[..., 0] * row[..., 10] + row[..., 12]
    v = uv[..., 1] * row[..., 11] + row[..., 13]
    c_const = row[..., 4:7]
    if pool.has_image:
        # image textures flip the t coordinate (reference textures.cpp:367
        # "flip t coordinate for image texture lookup")
        blend = _image_bilinear(pool, row, u, 1.0 - v)
        rgb = jnp.where((tag == TEX_IMAGE)[..., None], blend[..., 0:3],
                        c_const)
    else:
        rgb = c_const
    return rgb


def eval_texture_float(pool: TexturePool, tex_idx, uv, p_world=None):
    """Float texture lookup (first channel of the raw value)."""
    return eval_texture_rgb_raw(pool, tex_idx, uv, p_world)[..., 0]


def eval_texture(pool: TexturePool, tex_idx, uv, p_world=None,
                 footprint=None, prim=None):
    """Evaluate texture tex_idx (N,) at uv (N, 2).

    Returns (coeffs (N, 3), scale (N,)): spectral albedo at the hit is
    sigmoid(coeffs, lam) * scale. One descriptor lookup (one-hot for small
    pools) + at most one fused bilinear atlas gather."""
    row = pool_lookup(pool.desc, jnp.maximum(tex_idx, 0))
    tag = f32_to_i32(row[..., 0])
    uv = apply_mapping(pool, tex_idx, uv, p_world)
    u = uv[..., 0] * row[..., 10] + row[..., 12]
    v = uv[..., 1] * row[..., 11] + row[..., 13]

    # constant & scale share the same layout: coeffs in value_a, scale in [7]
    c_const = row[..., 4:7]
    s_const = row[..., 7]

    # checker: select between value_a/value_b coeffs (scales in cols 14/15)
    check = (jnp.floor(u) + jnp.floor(v)).astype(jnp.int32) & 1
    is_a = (check == 0)
    c_check = jnp.where(is_a[..., None], row[..., 4:7], row[..., 7:10])
    s_check = jnp.where(is_a, row[..., 14], row[..., 15])

    # dots: jittered dot per cell (reference DotsTexture, texture.h) —
    # cell-hashed center + radius, gather-free
    from .utils.rng import hash_u32
    cu = jnp.floor(u + 0.5)
    cv = jnp.floor(v + 0.5)
    hx = hash_u32(cu.astype(jnp.int32).astype(jnp.uint32),
                  cv.astype(jnp.int32).astype(jnp.uint32),
                  jnp.uint32(0x51ab33cd))
    hy = hash_u32(cu.astype(jnp.int32).astype(jnp.uint32),
                  cv.astype(jnp.int32).astype(jnp.uint32),
                  jnp.uint32(0x91e10da5))
    cx = cu + (hx.astype(jnp.float32) * (1.0 / 4294967296.0) - 0.5) * 0.5
    cy = cv + (hy.astype(jnp.float32) * (1.0 / 4294967296.0) - 0.5) * 0.5
    in_dot = (sqr_ := (u - cx) ** 2 + (v - cy) ** 2) < 0.35 * 0.35
    c_dots = jnp.where(in_dot[..., None], row[..., 4:7], row[..., 7:10])
    s_dots = jnp.where(in_dot, row[..., 14], row[..., 15])

    # image: bilinear (or trilinear MIP when a footprint is known) over
    # (coeffs, scale) texels; fused 4-tap gathers
    if pool.has_image:
        # image textures flip the t coordinate (reference textures.cpp:367)
        v_img = 1.0 - v
        if footprint is not None and pool.has_mips:
            # footprint: isotropic uv-space diameter from the ray cone;
            # the level is where one texel covers it
            mip_row = pool_lookup(pool.mips, jnp.maximum(tex_idx, 0))
            res = jnp.maximum(row[..., 2], row[..., 3])
            lod = jnp.log2(jnp.maximum(footprint * res, 1.0))
            blend = _image_trilinear(pool, row, mip_row, u, v_img, lod)
        else:
            blend = _image_bilinear(pool, row, u, v_img)
        c_img, s_img = blend[..., 0:3], blend[..., 3]
    else:
        c_img, s_img = c_const, s_const

    if pool.has_procedural:
        pp = p_world if p_world is not None else jnp.stack(
            [u, v, jnp.zeros_like(u)], -1)
        n_fbm = fbm(pp, 6, 0.5)
        s_fbm = row[..., 7] * jnp.abs(n_fbm)
        marble = jnp.sin(pp[..., 2] * 4.0 + 2.0 * n_fbm) * 0.5 + 0.5
        s_marble = row[..., 7] * marble
        # windy: FBm(p/10) wind strength x |FBm(p)| waves (texture.h)
        wind = fbm(pp * 0.1, 3, 0.5)
        waves = jnp.abs(fbm(pp, 6, 0.5))
        s_windy = row[..., 7] * jnp.abs(wind) * waves
        s_wrink = row[..., 7] * turbulence(pp, 6, 0.5)
    else:
        s_fbm = s_marble = s_windy = s_wrink = s_const

    # per-face constant (baked Ptex): atlas row = offset + local face id
    if pool.has_face and prim is not None:
        base = row[..., 7]
        nf = jnp.maximum(row[..., 2], 1.0)
        face = jnp.clip(prim.astype(jnp.float32) - base, 0.0, nf - 1.0)
        fidx = f32_to_i32(row[..., 1]) + face.astype(jnp.int32)
        ftex = pool_lookup(pool.atlas,
                           jnp.clip(fidx, 0, pool.atlas.shape[0] - 1))
        c_face, s_face = ftex[..., 0:3], ftex[..., 3]
    else:
        c_face, s_face = c_const, s_const

    t = tag[..., None]
    coeffs = jnp.where(t == TEX_IMAGE, c_img,
             jnp.where(t == TEX_CHECKER, c_check,
             jnp.where(t == TEX_FACE, c_face,
             jnp.where(t == TEX_DOTS, c_dots, c_const))))
    scale = jnp.where(tag == TEX_IMAGE, s_img,
            jnp.where(tag == TEX_CHECKER, s_check,
            jnp.where(tag == TEX_FACE, s_face,
            jnp.where(tag == TEX_DOTS, s_dots,
            jnp.where(tag == TEX_FBM, s_fbm,
            jnp.where(tag == TEX_MARBLE, s_marble,
            jnp.where(tag == TEX_WINDY, s_windy,
            jnp.where(tag == TEX_WRINKLED, s_wrink, s_const))))))))
    return coeffs, scale


def eval_texture_spectral(pool: TexturePool, tex_idx, uv, lam,
                          p_world=None, footprint=None, ns=None, prim=None):
    """Spectral albedo (N, 4) of texture tex_idx at uv/lam, including the
    mix family (TEX_MIX/TEX_DIRMIX/TEX_BILERP): child textures are
    evaluated and blended at the SAMPLED WAVELENGTHS — sigmoid polynomial
    coefficients are not linear in reflectance, so blending must happen
    after spectral evaluation (reference SpectrumMixTexture::Evaluate,
    textures.h:868). One nesting level: children must not be mixers.

    ns: (N, 3) shading normals, needed by directionmix."""
    from .utils import color as pcolor
    from .ops.gather import pool_lookup, f32_to_i32

    def alb(idx):
        c, s = eval_texture(pool, idx, uv, p_world, footprint=footprint,
                            prim=prim)
        return pcolor.eval_rgb_sigmoid_polynomial(c, lam) * s[..., None]

    if not pool.has_mixers:
        return alb(tex_idx)
    row = pool_lookup(pool.desc, jnp.maximum(tex_idx, 0))
    tag = f32_to_i32(row[..., 0])
    is_mixer = (tag == TEX_MIX) | (tag == TEX_DIRMIX) | (tag == TEX_BILERP)
    c1 = jnp.where(is_mixer, f32_to_i32(row[..., 4]), tex_idx)
    c2 = jnp.where(is_mixer, f32_to_i32(row[..., 5]), tex_idx)
    c3 = jnp.where(tag == TEX_BILERP, f32_to_i32(row[..., 6]), tex_idx)
    c4 = jnp.where(tag == TEX_BILERP, f32_to_i32(row[..., 7]), tex_idx)
    a1, a2, a3, a4 = alb(c1), alb(c2), alb(c3), alb(c4)

    amt = row[..., 8]
    out_mix = (1.0 - amt)[..., None] * a1 + amt[..., None] * a2
    if ns is not None:
        dirv = row[..., 10:13]
        amt_d = jnp.abs(jnp.sum(ns * dirv, axis=-1))
    else:
        amt_d = jnp.full(tex_idx.shape, 0.5, jnp.float32)
    out_dir = amt_d[..., None] * a1 + (1.0 - amt_d)[..., None] * a2
    u = uv[..., 0]
    v = uv[..., 1]
    out_bil = ((1 - u) * (1 - v))[..., None] * a1 + \
        (u * (1 - v))[..., None] * a2 + \
        ((1 - u) * v)[..., None] * a3 + (u * v)[..., None] * a4
    t = tag[..., None]
    return jnp.where(t == TEX_MIX, out_mix,
           jnp.where(t == TEX_DIRMIX, out_dir,
           jnp.where(t == TEX_BILERP, out_bil, a1)))
