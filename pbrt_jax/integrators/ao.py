"""Ambient-occlusion integrator (reference AOIntegrator,
cpu/integrators.h:296 / cpu/integrators.cpp AOIntegrator::Li): one camera
hit, one cosine-sampled hemisphere visibility ray of length `maxdistance`,
L = illuminant * visibility * cosTheta / (pi * pdf) == illuminant * vis
for cosine sampling.

Mapping: a single fused wave — no depth loop, so it shares only the
camera/sampler front-end with path.py."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from .. import scene_core as sc
from .. import samplers as smp
from .. import cameras as cam_mod
from .. import filters as flt
from ..utils import vecmath as vm
from ..utils import spectrum as spc
from ..utils import sampling as usamp
from .path import _CAM_DIMS


def render_wave(scene: sc.Scene, camera: cam_mod.Camera,
                sampler: smp.SamplerParams, filt: flt.Filter,
                pixel_idx, sample_index, opts, *, cos_sample=True,
                max_distance=1e30, illum_scale=1.0):
    """One AO sample wave. Returns (L (N, 4), swl, filter weight) — the
    same contract as path.render_wave so the render driver and film are
    reused unchanged."""
    px = pixel_idx % camera.width
    py = pixel_idx // camera.width
    u_pix = smp.sample_pixel_2d(sampler, px, py, sample_index, 0)
    u_time = smp.sample_1d(sampler, px, py, sample_index, 2)
    u_lens = smp.sample_2d(sampler, px, py, sample_index, 3)
    u_lam = smp.sample_1d(sampler, px, py, sample_index, 5)
    swl = spc.sample_uniform_wavelengths(u_lam)
    f_off, f_weight = flt.sample(filt, u_pix)
    p_film = jnp.stack([px.astype(jnp.float32) + 0.5 + f_off[..., 0],
                        py.astype(jnp.float32) + 0.5 + f_off[..., 1]],
                       axis=-1)
    o, d, _t, cam_wt = cam_mod.generate_ray_weighted(camera, p_film,
                                                     u_lens, u_time)
    N = o.shape[0]
    isect = sc.intersect(scene, o, d, jnp.full((N,), 1e30, jnp.float32))
    ns = isect["ns"]
    # two-sided: flip the frame toward the camera (integrators.cpp AO
    # flips n to the ray side)
    flip = vm.dot(ns, d) > 0
    ns = jnp.where(flip[..., None], -ns, ns)
    t1, t2 = vm.coordinate_system(ns)

    u2 = smp.sample_2d(sampler, px, py, sample_index, _CAM_DIMS)
    if cos_sample:
        wi_l = usamp.sample_cosine_hemisphere(u2)
        pdf = usamp.cosine_hemisphere_pdf(jnp.abs(wi_l[..., 2]))
    else:
        wi_l = usamp.sample_uniform_hemisphere(u2)
        pdf = jnp.full(wi_l.shape[:-1], usamp.uniform_hemisphere_pdf())
    ratio = jnp.where(pdf > 0, jnp.abs(wi_l[..., 2]) / (np.pi * pdf), 0.0)
    wi = wi_l[..., 0:1] * t1 + wi_l[..., 1:2] * t2 + wi_l[..., 2:3] * ns
    o_sh = sc.offset_ray_origin(isect["p"], ns, wi)
    occluded = sc.intersect_p(scene, o_sh, wi, max_distance)
    vis = isect["hit"] & ~occluded
    # illuminant: spectrally constant `illum_scale` (reference default)
    L = jnp.where(vis[..., None], illum_scale * ratio[..., None]
                  * jnp.ones((N, 4), jnp.float32), 0.0)
    return L, swl, f_weight * cam_wt
