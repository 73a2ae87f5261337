"""Participating media (reference media.{h,cpp}: HomogeneousMedium:217,
GridMedium:265, RGBGridMedium:355, DDAMajorantIterator:136, SampleT_maj:725).

Design: media live in a descriptor pool + one flat density-grid array.
Free-flight sampling is delta tracking by DDA over ONE scene-level majorant
super-grid that covers the union of all medium boxes; each cell stores a
SPECTRALLY-CONSTANT scalar majorant (>= max over lambda, media, and space of
sigma_t in the cell). A spectrally-constant majorant makes every T_maj factor
cancel out of the reference's rescaled-probability ratios (beta, r_u, r_l —
integrators.cpp:957-1050), so the flight loop tracks only event ratios: no
exponentials, no spectral majorant bookkeeping, branch-free lanes. The single
scene grid also handles any number of disjoint/overlapping medium boxes in
one DDA sweep (gaps between media are zero-majorant cells the DDA skips at
grid speed) — the reference instead chains per-medium iterators
(MajorantGrid media.h:105, DDAMajorantIterator media.h:136).

Medium boxes are axis-aligned in world space (transformed grids pending).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from .utils import struct

from .ops.gather import pool_lookup, f32_to_i32
from .utils import color as pcolor

def _np_perlin(p):
    """Hash-based gradient noise, numpy host version of
    textures.perlin_noise (reference util/noise.cpp role). p: (N, 3)."""
    def h32(x, y, z):
        h = (x.astype(np.uint32) * np.uint32(0x9e3779b1) ^
             y.astype(np.uint32) * np.uint32(0x85ebca6b) ^
             z.astype(np.uint32) * np.uint32(0xc2b2ae35))
        h ^= h >> np.uint32(15)
        h = h * np.uint32(0x2c1b3c6d)
        h ^= h >> np.uint32(12)
        return h

    pi = np.floor(p).astype(np.int64)
    pf = p - pi
    total = np.zeros(p.shape[0])
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                ix = pi[:, 0] + dx
                iy = pi[:, 1] + dy
                iz = pi[:, 2] + dz
                hh = (h32(ix, iy, iz) & np.uint32(15)).astype(np.int64)
                fx = pf[:, 0] - dx
                fy = pf[:, 1] - dy
                fz = pf[:, 2] - dz
                u = np.where(hh < 8, fx, fy)
                v = np.where(hh < 4, fy,
                             np.where((hh == 12) | (hh == 14), fx, fz))
                g = np.where(hh & 1 == 0, u, -u) + \
                    np.where(hh & 2 == 0, v, -v)
                wx = np.where(dx, pf[:, 0], 1 - pf[:, 0])
                wy = np.where(dy, pf[:, 1], 1 - pf[:, 1])
                wz = np.where(dz, pf[:, 2], 1 - pf[:, 2])

                def fade(t):
                    return 1 - (6 * t**5 - 15 * t**4 + 10 * t**3)

                total += fade(1 - wx) * fade(1 - wy) * fade(1 - wz) * g
    return total


MEDIUM_HOMOGENEOUS = 0
MEDIUM_GRID = 1
# per-voxel RGB sigma_a/sigma_s (+ optional emission) grids (reference
# RGBGridMedium, media.h:355): voxels store rgb->spectrum sigmoid
# coefficients + scales fitted at build; sigma(lambda) trilerps the
# EVALUATED corner spectra
MEDIUM_RGBGRID = 2

# descriptor columns:
# [0]=tag [1:4]=sigma_a coeffs [4]=sigma_a scale [5:8]=sigma_s coeffs
# [8]=sigma_s scale [9]=g [10]=sigma_maj (scalar majorant, premultiplied)
# [11]=grid_offset [12]=nx [13]=ny [14]=nz [15:18]=bounds_lo [18:21]=bounds_hi
# [21]=density_scale [22]=Le_scale [23]=sigma_t_peak (spectral peak, no dens)
MED_COLS = 24


@struct.dataclass
class MediumPool:
    desc: jnp.ndarray   # (M, MED_COLS)
    grid: jnp.ndarray   # (G,) flat density pool
    # RGBGrid voxel pool: per-voxel [sa_coeffs(3), sa_scale, ss_coeffs(3),
    # ss_scale, le_coeffs(3), le_scale] (media.h:355 RGBGridMedium)
    gridc: jnp.ndarray = None       # (Gc, 12)
    has_rgbgrid: bool = struct.field(pytree_node=False, default=False)
    has_emissive: bool = struct.field(pytree_node=False, default=False)
    # scene-level majorant super-grid (scalar sigma majorants per cell)
    maj_grid: jnp.ndarray = None    # (mz*my*mx,)
    maj_lo: jnp.ndarray = None      # (3,)
    maj_hi: jnp.ndarray = None      # (3,)
    maj_res: tuple = struct.field(pytree_node=False, default=(1, 1, 1))
    max_majorant: float = struct.field(pytree_node=False, default=0.0)
    # static: every medium is homogeneous (BDPT medium vertices cover only
    # this scope — see integrators/bdpt.py module docstring)
    all_homogeneous: bool = struct.field(pytree_node=False, default=True)


class MediumBuilder:
    def __init__(self, colorspace=None):
        self.cs = colorspace or pcolor.srgb()
        self.rows = []
        self.grid = [np.zeros(1, np.float32)]
        self.grid_size = 1
        self.gridc = [np.zeros((1, 12), np.float32)]
        self.gridc_size = 1
        self._has_emissive = False
        self._densities = {}  # medium index -> (nz, ny, nx) density array

    def _sigma_coeffs(self, rgb, scale):
        rgb = np.asarray(rgb, np.float64) * scale
        m = max(float(np.max(rgb)), 1e-9)
        s = 2.0 * m if m > 1.0 else 1.0
        c = self.cs.to_spectrum_coeffs(np.clip(rgb / s, 0, 1))
        c = np.asarray(c, np.float32)
        # The majorant must bound the FITTED spectrum, not the RGB values:
        # the sigmoid fit can exceed max(rgb) at the spectrum edges for
        # saturated colors (reference uses SampledSpectrum majorants).
        peak = float(pcolor.sigmoid_poly_max_value(jnp.asarray(c))) * float(s)
        return c, np.float32(s), peak

    def add_homogeneous(self, sigma_a=(1.0,) * 3, sigma_s=(1.0,) * 3,
                        g=0.0, scale=1.0, bounds_lo=(-1e5,) * 3,
                        bounds_hi=(1e5,) * 3):
        """Media participate within their world-space box (bounds); a 'global'
        fog medium uses a box enclosing the scene."""
        ca, sa, max_a = self._sigma_coeffs(sigma_a, scale)
        cs_, ss, max_s = self._sigma_coeffs(sigma_s, scale)
        row = np.zeros(MED_COLS, np.float32)
        row[0] = MEDIUM_HOMOGENEOUS
        row[1:4] = ca
        row[4] = sa
        row[5:8] = cs_
        row[8] = ss
        row[9] = g
        row[10] = max_a + max_s  # scalar majorant (fitted-spectrum peaks)
        row[15:18] = np.asarray(bounds_lo, np.float32)
        row[18:21] = np.asarray(bounds_hi, np.float32)
        row[21] = 1.0
        row[23] = max_a + max_s  # sigma_t spectral peak (density-free)
        self.rows.append(row)
        return len(self.rows) - 1

    def add_grid(self, density, bounds_lo, bounds_hi, sigma_a=(1.0,) * 3,
                 sigma_s=(1.0,) * 3, g=0.0, scale=1.0, le_scale=0.0):
        """density: (nz, ny, nx) float array."""
        density = np.asarray(density, np.float32)
        nz, ny, nx = density.shape
        ca, sa, max_a = self._sigma_coeffs(sigma_a, scale)
        cs_, ss, max_s = self._sigma_coeffs(sigma_s, scale)
        dmax = float(density.max())
        row = np.zeros(MED_COLS, np.float32)
        row[0] = MEDIUM_GRID
        row[1:4] = ca
        row[4] = sa
        row[5:8] = cs_
        row[8] = ss
        row[9] = g
        row[10] = (max_a + max_s) * dmax
        row[23] = max_a + max_s
        row[11] = self.grid_size
        row[12] = nx
        row[13] = ny
        row[14] = nz
        row[15:18] = np.asarray(bounds_lo, np.float32)
        row[18:21] = np.asarray(bounds_hi, np.float32)
        row[21] = 1.0
        row[22] = le_scale
        self.grid.append(density.reshape(-1))
        self.grid_size += density.size
        self._densities[len(self.rows)] = density
        self.rows.append(row)
        return len(self.rows) - 1

    def add_rgbgrid(self, sigma_a_rgb, sigma_s_rgb, bounds_lo, bounds_hi,
                    g=0.0, scale=1.0, Le_rgb=None, le_scale=1.0):
        """Per-voxel RGB coefficient grids (reference RGBGridMedium,
        media.h:355). sigma_a_rgb/sigma_s_rgb/Le_rgb: (nz, ny, nx, 3).
        Each voxel's rgb is fitted to a sigmoid-polynomial spectrum at
        build; device sampling trilerps the EVALUATED corner spectra."""
        sa = np.asarray(sigma_a_rgb, np.float64) * scale
        ss = np.asarray(sigma_s_rgb, np.float64) * scale
        nz, ny, nx = sa.shape[:3]

        def fit(v):
            flat = v.reshape(-1, 3)
            s = np.maximum(flat.max(axis=-1), 1e-9)
            s = np.where(flat.max(axis=-1) > 1.0, 2.0 * s, 1.0)
            c = np.asarray(self.cs.to_spectrum_coeffs(
                np.clip(flat / s[:, None], 0, 1)), np.float32)
            # zero voxels stay exactly zero
            zero = flat.max(axis=-1) <= 0
            s = np.where(zero, 0.0, s).astype(np.float32)
            return c, s

        ca, s_a = fit(sa)
        cs_, s_s = fit(ss)
        if Le_rgb is not None:
            le = np.asarray(Le_rgb, np.float64) * le_scale
            cl, s_l = fit(le)
            self._has_emissive = True
        else:
            cl = np.zeros_like(ca)
            s_l = np.zeros_like(s_a)
        rows12 = np.concatenate([ca, s_a[:, None], cs_, s_s[:, None],
                                 cl, s_l[:, None]], axis=1)
        # spectral peaks bound the fitted spectra (sigmoid can exceed
        # max(rgb) at the spectrum edges): conservative 1.12x margin over
        # the per-voxel scale (sigmoid_poly_max <= 1 by construction of
        # the clipped fit input; s already folds the 2x headroom)
        st_vox = (s_a + s_s).astype(np.float32)
        peak = float(st_vox.max())
        row = np.zeros(MED_COLS, np.float32)
        row[0] = MEDIUM_RGBGRID
        row[9] = g
        row[10] = peak
        row[11] = self.gridc_size
        row[12] = nx
        row[13] = ny
        row[14] = nz
        row[15:18] = np.asarray(bounds_lo, np.float32)
        row[18:21] = np.asarray(bounds_hi, np.float32)
        row[21] = 1.0
        row[23] = peak
        self.gridc.append(rows12.astype(np.float32))
        self.gridc_size += rows12.shape[0]
        # per-voxel sigma_t peaks drive the majorant super-grid like a
        # scalar density grid with sigma_t_peak == peak
        self._densities[len(self.rows)] = \
            (st_vox / max(peak, 1e-9)).reshape(nz, ny, nx)
        self.rows.append(row)
        return len(self.rows) - 1

    def add_cloud(self, bounds_lo=(0.0, 0.0, 0.0), bounds_hi=(1.0,) * 3,
                  sigma_a=(1.0,) * 3, sigma_s=(1.0,) * 3, g=0.0,
                  density=1.0, wispiness=1.0, frequency=5.0, scale=1.0,
                  res=96):
        """Procedural cloud medium (reference CloudMedium, media.h:430):
        the reference evaluates 5-octave noise per sample; this rebuild
        BAKES the same recipe to a res^3 density grid at build (documented
        substitution — the grid path then runs the standard DDA delta
        tracker). Density field defined over the unit cube of the medium
        box (reference medium space)."""
        n = int(res)
        zi, yi, xi = np.meshgrid(*([np.linspace(0, 1, n)] * 3),
                                 indexing="ij")
        p = np.stack([xi, yi, zi], -1).reshape(-1, 3)
        pp = frequency * p
        if wispiness > 0:
            vomega, vlambda = 0.05 * wispiness, 10.0
            for _ in range(2):
                dn = np.stack([_np_perlin(vlambda * pp + off)
                               for off in ((0.0, 0.0, 0.0),
                                           (31.7, 11.3, 5.1),
                                           (7.77, 91.3, 2.4))], -1)
                pp = pp + vomega * dn
                vomega *= 0.5
                vlambda *= 1.99
        d = np.zeros(p.shape[0])
        omega, lam = 0.5, 1.0
        for _ in range(5):
            d += omega * _np_perlin(lam * pp)
            omega *= 0.5
            lam *= 1.99
        d = np.clip((1 - p[:, 1]) * 4.5 * density * d, 0, 1)
        d += 2 * np.maximum(0, 0.5 - p[:, 1])
        dens = np.clip(d, 0, 1).astype(np.float32).reshape(n, n, n)
        return self.add_grid(dens, bounds_lo, bounds_hi, sigma_a=sigma_a,
                             sigma_s=sigma_s, g=g, scale=scale)

    def build(self, maj_res=None) -> MediumPool:
        if not self.rows:
            row = np.zeros((1, MED_COLS), np.float32)
            one = np.ones(3, np.float32)
            return MediumPool(desc=jnp.asarray(row),
                              grid=jnp.asarray(np.zeros(1, np.float32)),
                              gridc=jnp.asarray(np.zeros((1, 12),
                                                         np.float32)),
                              maj_grid=jnp.asarray(np.zeros(1, np.float32)),
                              maj_lo=jnp.asarray(-one), maj_hi=jnp.asarray(one),
                              maj_res=(1, 1, 1), max_majorant=0.0)
        desc = np.stack(self.rows)
        maj, lo, hi, res = self._build_majorant_supergrid(desc, maj_res)
        return MediumPool(desc=jnp.asarray(desc),
                          grid=jnp.asarray(np.concatenate(self.grid)),
                          gridc=jnp.asarray(np.concatenate(self.gridc)),
                          has_rgbgrid=any(int(r[0]) == MEDIUM_RGBGRID
                                          for r in self.rows),
                          has_emissive=self._has_emissive,
                          maj_grid=jnp.asarray(maj.reshape(-1)),
                          maj_lo=jnp.asarray(lo), maj_hi=jnp.asarray(hi),
                          maj_res=res,
                          max_majorant=float(desc[:, 10].max()),
                          all_homogeneous=all(
                              int(r[0]) == MEDIUM_HOMOGENEOUS
                              for r in self.rows))

    def _build_majorant_supergrid(self, desc, maj_res=None):
        """Scene-level scalar majorant grid (reference MajorantGrid media.h:105
        generalized to cover all media). Cell value = max over media
        overlapping the cell of sigma_t_peak * (local max density), dilated by
        one density voxel so trilinear filtering support is bounded."""
        lo = desc[:, 15:18].min(axis=0).astype(np.float32)
        hi = desc[:, 18:21].max(axis=0).astype(np.float32)
        ext = np.maximum(hi - lo, 1e-6)
        if maj_res is None:
            n = 64 if self._densities else 8
            # scale per-axis resolution to the domain aspect (min 1)
            longest = float(ext.max())
            res = tuple(max(1, int(round(n * float(e) / longest)))
                        for e in ext)
        else:
            res = tuple(maj_res)
        mx, my, mz = res
        maj = np.zeros((mz, my, mx), np.float32)
        cell = ext / np.asarray([mx, my, mz], np.float32)
        for i, row in enumerate(desc):
            blo, bhi = row[15:18], row[18:21]
            c0 = np.clip(np.floor((blo - lo) / cell).astype(int), 0,
                         [mx - 1, my - 1, mz - 1])
            c1 = np.clip(np.ceil((bhi - lo) / cell).astype(int), 1,
                         [mx, my, mz])
            peak = float(row[23]) * float(row[21])  # sigma_t_peak * dens_scale
            if i not in self._densities:
                maj[c0[2]:c1[2], c0[1]:c1[1], c0[0]:c1[0]] = np.maximum(
                    maj[c0[2]:c1[2], c0[1]:c1[1], c0[0]:c1[0]], peak)
                continue
            dens = self._densities[i]
            # 3^3 max-filter dilation (trilinear support spills +-1 voxel)
            dil = dens
            for ax in range(3):
                pads = [(0, 0)] * 3
                pads[ax] = (1, 1)
                ap = np.pad(dil, pads, mode="edge")
                n_ax = dil.shape[ax]
                out = dil
                for off in (0, 2):
                    s = [slice(None)] * 3
                    s[ax] = slice(off, off + n_ax)
                    out = np.maximum(out, ap[tuple(s)])
                dil = out
            nz, ny, nx = dens.shape
            bext = np.maximum(bhi - blo, 1e-9)
            # Resample the dilated density to a fine grid at least 2x the
            # super-grid resolution inside the box (nearest-voxel, which is
            # max-preserving under upsampling) so that every supercell the
            # box overlaps receives at least one sample — a plain
            # voxel-center scatter would leave zero-majorant holes whenever
            # density voxels are coarser than supercells.
            span = np.maximum(c1 - c0, 1)
            f = [max(n, 2 * int(s)) for n, s in zip((nz, ny, nx),
                                                    (span[2], span[1],
                                                     span[0]))]
            iz = np.minimum((np.arange(f[0]) + 0.5) * nz / f[0], nz - 1).astype(int)
            iy = np.minimum((np.arange(f[1]) + 0.5) * ny / f[1], ny - 1).astype(int)
            ix = np.minimum((np.arange(f[2]) + 0.5) * nx / f[2], nx - 1).astype(int)
            fine = dil[np.ix_(iz, iy, ix)]
            wz = blo[2] + (np.arange(f[0]) + 0.5) / f[0] * bext[2]
            wy = blo[1] + (np.arange(f[1]) + 0.5) / f[1] * bext[1]
            wx = blo[0] + (np.arange(f[2]) + 0.5) / f[2] * bext[0]
            sz = np.clip(((wz - lo[2]) / cell[2]).astype(int), 0, mz - 1)
            sy = np.clip(((wy - lo[1]) / cell[1]).astype(int), 0, my - 1)
            sx = np.clip(((wx - lo[0]) / cell[0]).astype(int), 0, mx - 1)
            flat = ((sz[:, None, None] * my + sy[None, :, None]) * mx +
                    sx[None, None, :])
            np.maximum.at(maj.reshape(-1), flat.reshape(-1),
                          (fine * peak).reshape(-1))
        return maj, lo, hi, res


def medium_row(pool: MediumPool, med_idx):
    return pool_lookup(pool.desc, jnp.maximum(med_idx, 0))


def density_at(pool: MediumPool, row, p):
    """Trilinear density lookup in the medium's grid; 1.0 for homogeneous.

    row: (N, MED_COLS) gathered descriptor rows; p: (N, 3) world points.
    One fused 8-tap gather."""
    tag = f32_to_i32(row[..., 0])
    lo = row[..., 15:18]
    hi = row[..., 18:21]
    n = row[..., 12:15]  # nx, ny, nz
    g = (p - lo) / jnp.maximum(hi - lo, 1e-9) * n - 0.5
    g0 = jnp.floor(g)
    frac = g - g0

    def clampi(x, nn):
        return jnp.clip(x, 0.0, jnp.maximum(nn - 1.0, 0.0))

    xs = jnp.stack([clampi(g0[..., 0], n[..., 0]),
                    clampi(g0[..., 0] + 1, n[..., 0])], -1)  # (N, 2)
    ys = jnp.stack([clampi(g0[..., 1], n[..., 1]),
                    clampi(g0[..., 1] + 1, n[..., 1])], -1)
    zs = jnp.stack([clampi(g0[..., 2], n[..., 2]),
                    clampi(g0[..., 2] + 1, n[..., 2])], -1)
    base = row[..., 11]
    nx = n[..., 0]
    nxy = n[..., 0] * n[..., 1]
    idx = (base[..., None, None, None] +
           zs[..., :, None, None] * nxy[..., None, None, None] +
           ys[..., None, :, None] * nx[..., None, None, None] +
           xs[..., None, None, :])                     # (N, 2, 2, 2)
    d = pool.grid[f32_to_i32(idx)]                     # ONE gather (N,2,2,2)
    fx, fy, fz = frac[..., 0], frac[..., 1], frac[..., 2]
    dx0 = d[..., :, :, 0] * (1 - fx)[..., None, None] + \
        d[..., :, :, 1] * fx[..., None, None]
    dy0 = dx0[..., :, 0] * (1 - fy)[..., None] + dx0[..., :, 1] * fy[..., None]
    dens = dy0[..., 0] * (1 - fz) + dy0[..., 1] * fz
    inside = jnp.all((p >= lo) & (p <= hi), axis=-1)
    dens = jnp.where(inside, dens, 0.0) * row[..., 21]
    return jnp.where(tag == MEDIUM_HOMOGENEOUS, 1.0, dens)


def _gridc_trilerp(pool: MediumPool, row, p, lam, col0):
    """Trilinear interpolation of EVALUATED per-voxel spectra from the
    RGBGrid coefficient pool (reference RGBGridMedium sampling,
    media.h:355). col0: 0 for sigma_a, 4 for sigma_s, 8 for Le.
    Returns (N, 4); zero outside the grid box."""
    lo = row[..., 15:18]
    hi = row[..., 18:21]
    n = row[..., 12:15]
    g = (p - lo) / jnp.maximum(hi - lo, 1e-9) * n - 0.5
    g0 = jnp.floor(g)
    frac = g - g0

    def clampi(x, nn):
        return jnp.clip(x, 0.0, jnp.maximum(nn - 1.0, 0.0))

    xs = jnp.stack([clampi(g0[..., 0], n[..., 0]),
                    clampi(g0[..., 0] + 1, n[..., 0])], -1)
    ys = jnp.stack([clampi(g0[..., 1], n[..., 1]),
                    clampi(g0[..., 1] + 1, n[..., 1])], -1)
    zs = jnp.stack([clampi(g0[..., 2], n[..., 2]),
                    clampi(g0[..., 2] + 1, n[..., 2])], -1)
    base = row[..., 11]
    nx = n[..., 0]
    nxy = n[..., 0] * n[..., 1]
    idx = (base[..., None, None, None] +
           zs[..., :, None, None] * nxy[..., None, None, None] +
           ys[..., None, :, None] * nx[..., None, None, None] +
           xs[..., None, None, :])                    # (N, 2, 2, 2)
    idx = jnp.clip(f32_to_i32(idx), 0, pool.gridc.shape[0] - 1)
    vox = pool.gridc[idx]                             # (N, 2, 2, 2, 12)
    val = pcolor.eval_rgb_sigmoid_polynomial(
        vox[..., col0:col0 + 3], lam[..., None, None, None, :]) * \
        vox[..., col0 + 3:col0 + 4]                   # (N, 2, 2, 2, 4)
    # val: (N, z2, y2, x2, lam4) — reduce x, then y, then z
    fx = frac[..., 0][:, None, None, None]
    vx = val[:, :, :, 0, :] * (1 - fx) + val[:, :, :, 1, :] * fx
    fy = frac[..., 1][:, None, None]
    vy = vx[:, :, 0, :] * (1 - fy) + vx[:, :, 1, :] * fy
    fz = frac[..., 2][:, None]
    out = vy[:, 0, :] * (1 - fz) + vy[:, 1, :] * fz
    inside = jnp.all((p >= lo) & (p <= hi), axis=-1)
    return jnp.where(inside[..., None], out, 0.0)


def sigma_at(pool: MediumPool, row, p, lam):
    """(sigma_a (N,4), sigma_s (N,4)) at world point p, wavelengths lam."""
    dens = density_at(pool, row, p)
    sa = pcolor.eval_rgb_sigmoid_polynomial(row[..., 1:4], lam) * \
        row[..., 4:5] * dens[..., None]
    ss = pcolor.eval_rgb_sigmoid_polynomial(row[..., 5:8], lam) * \
        row[..., 8:9] * dens[..., None]
    if pool.has_rgbgrid:
        tag = f32_to_i32(row[..., 0])
        is_rgb = (tag == MEDIUM_RGBGRID)[..., None]
        sa_g = _gridc_trilerp(pool, row, p, lam, 0)
        ss_g = _gridc_trilerp(pool, row, p, lam, 4)
        sa = jnp.where(is_rgb, sa_g, sa)
        ss = jnp.where(is_rgb, ss_g, ss)
    return sa, ss


def le_at(pool: MediumPool, row, p, lam):
    """Volumetric emission Le (N, 4) at p (RGBGrid Le voxels; zero for
    other medium kinds)."""
    if not pool.has_rgbgrid:
        return jnp.zeros(p.shape[:-1] + (4,), jnp.float32)
    tag = f32_to_i32(row[..., 0])
    le = _gridc_trilerp(pool, row, p, lam, 8)
    return jnp.where((tag == MEDIUM_RGBGRID)[..., None], le, 0.0)


def majorant(row):
    """Scalar majorant (N,)."""
    return row[..., 10]


def hg_g(row):
    return row[..., 9]
