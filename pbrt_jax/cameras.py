"""Cameras (reference cameras.{h,cpp}: Perspective:340, Orthographic:283,
Spherical:406; base/camera.h:28).

A camera is a parameter struct + a pure `generate_ray` over batched
CameraSamples. The rendering coordinate system is camera-world (reference
CameraTransform, cameras.h:27: world-space rays with precision kept near the
camera by the scene compiler translating geometry; we currently render in
world space and rely on float32 + offset-ray hygiene).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from .utils import struct

from .utils import transform as tfm
from .utils import vecmath as vm
from .utils.math import lerp, PI, safe_div, sqr
from .utils import sampling as sp

CAMERA_PERSPECTIVE = 0
CAMERA_ORTHOGRAPHIC = 1
CAMERA_SPHERICAL = 2
CAMERA_REALISTIC = 3

SPHERE_EQUIRECT = 0
SPHERE_EQUALAREA = 1


@struct.dataclass
class Camera:
    kind: int = struct.field(pytree_node=False, default=CAMERA_PERSPECTIVE)
    # camera-to-world
    c2w_m: jnp.ndarray = None           # (4,4)
    width: int = struct.field(pytree_node=False, default=640)
    height: int = struct.field(pytree_node=False, default=480)
    tan_half_fov: jnp.ndarray = None    # scalar (perspective)
    screen_min: tuple = struct.field(pytree_node=False, default=(-1.0, -1.0))
    screen_max: tuple = struct.field(pytree_node=False, default=(1.0, 1.0))
    lens_radius: jnp.ndarray = None
    focal_distance: jnp.ndarray = None
    shutter_open: float = struct.field(pytree_node=False, default=0.0)
    shutter_close: float = struct.field(pytree_node=False, default=1.0)
    mapping: int = struct.field(pytree_node=False, default=SPHERE_EQUALAREA)
    # realistic camera: lens element table, rear->front order
    # rows: [curvature_radius, thickness, eta, aperture_radius] (meters)
    lens_elements: jnp.ndarray = None     # (E, 4)
    film_diag: float = struct.field(pytree_node=False, default=0.035)
    rear_z: jnp.ndarray = None            # scalar z of rear element
    # exit-pupil tabulation (reference cameras.cpp:742 BoundExitPupil /
    # :861-897 SampleExitPupil): per-film-radius-zone rear-element bboxes
    # [x0, y0, x1, y1] computed along the +x film axis; None -> sample the
    # full rear-element disk
    exit_pupil: jnp.ndarray = None        # (n_zones, 4)
    film_r_max: jnp.ndarray = None        # scalar: film corner radius


def make_camera(kind="perspective", camera_from_world: tfm.Transform = None,
                width=640, height=480, fov=90.0, lens_radius=0.0,
                focal_distance=1e6, shutter_open=0.0, shutter_close=1.0,
                screen_window=None, mapping="equalarea") -> Camera:
    kinds = {"perspective": CAMERA_PERSPECTIVE, "orthographic": CAMERA_ORTHOGRAPHIC,
             "spherical": CAMERA_SPHERICAL}
    if camera_from_world is None:
        camera_from_world = tfm.identity()
    w2c = camera_from_world
    c2w = w2c.inverse()
    aspect = width / height
    if screen_window is not None:
        smin, smax = tuple(screen_window[0]), tuple(screen_window[1])
    elif aspect > 1:
        smin, smax = (-aspect, -1.0), (aspect, 1.0)
    else:
        smin, smax = (-1.0, -1.0 / aspect), (1.0, 1.0 / aspect)
    return Camera(kind=kinds[kind], c2w_m=jnp.asarray(c2w.m, jnp.float32),
                  width=width, height=height,
                  tan_half_fov=jnp.asarray(np.tan(np.radians(fov) / 2), jnp.float32),
                  screen_min=smin, screen_max=smax,
                  lens_radius=jnp.asarray(lens_radius, jnp.float32),
                  focal_distance=jnp.asarray(focal_distance, jnp.float32),
                  shutter_open=shutter_open, shutter_close=shutter_close,
                  mapping=SPHERE_EQUALAREA if mapping == "equalarea" else SPHERE_EQUIRECT)


def generate_ray_weighted(cam: Camera, p_film, u_lens, u_time):
    """generate_ray + camera weight (0 for lens-vignetted rays of the
    realistic camera; 1 otherwise) — the reference's CameraRay::weight."""
    if cam.kind == CAMERA_REALISTIC:
        o_w, d_w, wt = realistic_generate_ray(cam, p_film, u_lens)
        time = cam.shutter_open + u_time * (cam.shutter_close -
                                            cam.shutter_open)
        return o_w, d_w, time, wt
    o, d, t = generate_ray(cam, p_film, u_lens, u_time)
    return o, d, t, jnp.ones(p_film.shape[:-1], jnp.float32)


def _rotate(v, m):
    """v @ m in full f32 (a TF32 product would perturb camera rays)."""
    return jnp.matmul(v, m, precision=jax.lax.Precision.HIGHEST)


def generate_ray(cam: Camera, p_film, u_lens, u_time):
    """p_film: (..., 2) raster coords (continuous, [0,W)x[0,H)); u_lens (..., 2);
    u_time (...,). Returns (o, d, time) world-space.

    (reference PerspectiveCamera::GenerateRay, cameras.cpp)
    """
    if cam.kind == CAMERA_REALISTIC:
        o_w, d_w, _wt = realistic_generate_ray(cam, p_film, u_lens)
        time = cam.shutter_open + u_time * (cam.shutter_close -
                                            cam.shutter_open)
        return o_w, d_w, time


    sx = cam.screen_min[0] + (p_film[..., 0] / cam.width) * \
        (cam.screen_max[0] - cam.screen_min[0])
    # raster y grows downward; screen y grows upward
    sy = cam.screen_max[1] - (p_film[..., 1] / cam.height) * \
        (cam.screen_max[1] - cam.screen_min[1])
    time = lerp(u_time, cam.shutter_open, cam.shutter_close)

    if cam.kind == CAMERA_PERSPECTIVE:
        # camera-space direction through screen point on z=1 plane
        px = sx * cam.tan_half_fov
        py = sy * cam.tan_half_fov
        d_cam = vm.v3(px, py, jnp.ones_like(px))
        o_cam = jnp.zeros_like(d_cam)
        # depth of field (reference cameras.h:372)
        lens_ok = cam.lens_radius > 0
        p_lens = cam.lens_radius * sp.sample_uniform_disk_concentric(u_lens)
        ft = cam.focal_distance  # d_cam.z == 1
        p_focus = d_cam * ft[..., None] if ft.ndim else d_cam * ft
        o_dof = jnp.stack([p_lens[..., 0], p_lens[..., 1],
                           jnp.zeros_like(p_lens[..., 0])], -1)
        d_dof = p_focus - o_dof
        o_cam = jnp.where(lens_ok, o_dof, o_cam)
        d_cam = jnp.where(lens_ok, d_dof, d_cam)
    elif cam.kind == CAMERA_ORTHOGRAPHIC:
        o_cam = vm.v3(sx, sy, jnp.zeros_like(sx))
        d_cam = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0], jnp.float32), o_cam.shape)
    else:  # spherical
        u = p_film[..., 0] / cam.width
        v = p_film[..., 1] / cam.height
        if cam.mapping == SPHERE_EQUALAREA:
            uv = jnp.stack([u, 1.0 - v], axis=-1)
            d_ea = vm.equal_area_square_to_sphere(uv)
            # remap to pbrt's convention (z-up -> y-up view axis z)
            d_cam = jnp.stack([-d_ea[..., 0], d_ea[..., 2], -d_ea[..., 1]], axis=-1)
        else:
            theta = PI * v
            phi = 2 * PI * u
            d_cam = vm.spherical_direction(jnp.sin(theta), jnp.cos(theta), phi)
            d_cam = jnp.stack([d_cam[..., 0], d_cam[..., 2], d_cam[..., 1]], axis=-1)
        o_cam = jnp.zeros_like(d_cam)

    m = cam.c2w_m
    o_w = _rotate(o_cam, m[:3, :3].T) + m[:3, 3]
    d_w = vm.normalize(_rotate(d_cam, m[:3, :3].T))
    return o_w, d_w, time




# ---------------------------------------------------------------------------
# RealisticCamera (reference cameras.h:466 + cameras.cpp TraceLensesFromFilm)

# Double-Gauss f/2 50mm prescription (Mandler 1934-style textbook data, the
# same published design family the reference's dgauss lens file encodes).
# Columns: curvature radius (mm), thickness (mm), eta, aperture diameter (mm)
DGAUSS_50MM = np.asarray([
    [29.475, 3.76, 1.67, 25.2],
    [84.83, 0.12, 1.0, 25.2],
    [19.275, 4.025, 1.67, 23.0],
    [40.77, 3.275, 1.699, 23.0],
    [12.75, 5.705, 1.0, 18.0],
    [0.0, 4.5, 1.0, 17.1],        # aperture stop (flat)
    [-14.495, 1.18, 1.603, 17.0],
    [40.77, 6.065, 1.658, 20.0],
    [-20.385, 0.19, 1.0, 20.0],
    [437.065, 3.22, 1.717, 20.0],
    [-39.73, 0.0, 1.0, 20.0],
], np.float64)


def make_realistic_camera(camera_from_world=None, width=640, height=480,
                          lens=DGAUSS_50MM, focus_distance=3.0,
                          aperture_diameter=None, film_diag=0.043,
                          shutter_open=0.0, shutter_close=1.0):
    """Lens-system camera (reference RealisticCamera, cameras.h:466).

    The lens table is given FRONT to REAR in mm (as lens files are);
    it is flipped/scaled to meters with the film at z=0 looking down +z
    like the reference. Focusing shifts the whole lens system along z by
    solving the thick-lens equation numerically (trace two parallel rays).
    """
    if camera_from_world is None:
        camera_from_world = tfm.identity()
    lens = np.array(lens, np.float64)
    if aperture_diameter is not None:
        stop = np.argmin(np.abs(lens[:, 0]))
        lens[stop, 3] = aperture_diameter * 1000.0
    # convert: mm->m, aperture diameter -> radius
    lens_m = lens.copy()
    lens_m[:, 0] *= 1e-3
    lens_m[:, 1] *= 1e-3
    lens_m[:, 3] *= 0.5e-3
    # rear->front order for film-side tracing. Lens-file rows pair each
    # surface with the gap/medium BEHIND it (toward the film); traced
    # rear->front, surface k's thickness/eta belong to the NEXT original
    # row, and curvature signs flip with the traversal direction.
    n_el = lens_m.shape[0]
    rev = lens_m[::-1]
    Rr = -rev[:, 0]
    apr = rev[:, 3]
    thickr = np.zeros(n_el)
    thickr[:n_el - 1] = rev[1:, 1]
    etar = np.ones(n_el)
    etar[:n_el - 1] = rev[1:, 2]
    elements = np.stack([Rr, thickr, etar, apr], 1)
    # z positions: film at z=0; rear element vertex at z = rear_z; each
    # element's thickness moves toward the scene (positive z)
    # focus: binary search the film-to-rear distance so a point at
    # focus_distance images onto the film (trace a near-axis ray back)
    def axis_cross(rear_z):
        """Trace a film-center ray through an off-axis rear point and
        return the z where it crosses the optical axis (the focus
        distance for this lens position), or None if vignetted."""
        o = np.asarray([0.0, 0.0, 0.0])
        target = np.asarray([elements[0, 3] * 0.3, 0.0, rear_z])
        d = target - o
        d = d / np.linalg.norm(d)
        ok, o2, d2 = _trace_from_film_host(elements, rear_z, o, d)
        if not ok or abs(d2[0]) < 1e-12:
            return None
        t = -o2[0] / d2[0]
        if t <= 0:
            return None
        return (o2 + t * d2)[2]

    # bisect/scan the rear-element z for the requested focus distance
    best, best_err = -0.05, 1e18
    for rz in np.linspace(0.005, 0.12, 600):
        fz = axis_cross(rz)
        if fz is None or fz <= 0:
            continue
        err = abs(fz - focus_distance)
        if err < best_err:
            best, best_err = rz, err
    rear_z = best
    c2w = camera_from_world.inverse()
    aspect = width / height
    # exit-pupil tabulation (reference cameras.cpp:742 BoundExitPupil):
    # per-film-radius rear-element bboxes; at wide apertures most of the
    # rear disk vignettes, so sampling inside the pupil bounds instead of
    # the whole disk recovers the wasted samples
    film_r_max = 0.5 * film_diag
    pupils = _bound_exit_pupils(elements, rear_z, film_r_max)
    return Camera(kind=CAMERA_REALISTIC,
                  c2w_m=jnp.asarray(c2w.m, jnp.float32),
                  width=width, height=height,
                  lens_elements=jnp.asarray(elements, jnp.float32),
                  rear_z=jnp.asarray(rear_z, jnp.float32),
                  film_diag=film_diag,
                  exit_pupil=jnp.asarray(pupils, jnp.float32),
                  film_r_max=jnp.asarray(film_r_max, jnp.float32),
                  shutter_open=shutter_open, shutter_close=shutter_close,
                  screen_min=(-aspect, -1.0), screen_max=(aspect, 1.0))


def _trace_from_film_host_vec(elements, rear_z, o, d):
    """Vectorized numpy mirror of _trace_from_film_host over (N, 3) ray
    batches — powers the exit-pupil tabulation (reference BoundExitPupil,
    cameras.cpp:742, traces 1024^2 film->rear rays per radius zone)."""
    o = np.array(o, np.float64)
    d = np.array(d, np.float64)
    ok = np.ones(o.shape[0], bool)
    z = float(rear_z)
    eta_prev = np.ones(o.shape[0])
    for k in range(elements.shape[0]):
        R, thick, eta_elem, ap = (float(v) for v in elements[k])
        if R == 0.0:
            dz = np.where(np.abs(d[:, 2]) < 1e-12, 1e-12, d[:, 2])
            t = (z - o[:, 2]) / dz
            ok &= np.abs(d[:, 2]) >= 1e-12
            p = o + t[:, None] * d
        else:
            zc = z + R
            oc = o - np.asarray([0.0, 0.0, zc])
            b = np.sum(oc * d, 1)
            c = np.sum(oc * oc, 1) - R * R
            disc = b * b - c
            ok &= disc >= 0
            sq = np.sqrt(np.maximum(disc, 0.0))
            use_near = (d[:, 2] > 0) == (R > 0)
            t = np.where(use_near, -b - sq, -b + sq)
            ok &= t > 0
            p = o + t[:, None] * d
        ok &= p[:, 0] ** 2 + p[:, 1] ** 2 <= ap * ap
        if R != 0.0:
            zc = z + R
            n = (p - np.asarray([0.0, 0.0, zc])) / R
            flip = np.sum(n * d, 1) > 0
            n = np.where(flip[:, None], -n, n)
            eta_ratio = eta_prev / max(eta_elem, 1e-6)
            cos_i = -np.sum(n * d, 1)
            sin2_t = eta_ratio ** 2 * (1 - cos_i ** 2)
            ok &= sin2_t < 1
            cos_t = np.sqrt(np.maximum(1 - sin2_t, 0.0))
            d = eta_ratio[:, None] * d + \
                (eta_ratio * cos_i - cos_t)[:, None] * n
            d /= np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-12)
            eta_prev = np.where(ok, eta_elem, eta_prev)
        o = p
        z += thick
    return ok, o, d


def _bound_exit_pupils(elements, rear_z, film_r_max, n_zones=64,
                       n_rear=40, n_film=5):
    """Per-film-radius-zone bbox of rear-element points whose film->scene
    trace clears the lens (reference RealisticCamera::BoundExitPupil,
    cameras.cpp:742-806). Zone i covers film radius
    [i, i+1] * film_r_max / n_zones along +x; the bbox is expanded by the
    sample spacing like the reference. Returns (n_zones, 4) float32."""
    r_rear = float(elements[0, 3])
    # rear-element sample grid (n_rear x n_rear over the bounding square)
    xs = (np.arange(n_rear) + 0.5) / n_rear * 2 * r_rear * 1.5 - r_rear * 1.5
    gx, gy = np.meshgrid(xs, xs, indexing="ij")
    gx = gx.reshape(-1)
    gy = gy.reshape(-1)
    bounds = np.zeros((n_zones, 4), np.float32)
    spacing = 2 * 1.5 * r_rear / n_rear
    for i in range(n_zones):
        r0 = i / n_zones * film_r_max
        r1 = (i + 1) / n_zones * film_r_max
        lo = np.asarray([np.inf, np.inf])
        hi = np.asarray([-np.inf, -np.inf])
        any_ok = False
        for fr in np.linspace(r0, r1, n_film):
            o = np.zeros((gx.shape[0], 3))
            o[:, 0] = fr
            pr = np.stack([gx, gy, np.full_like(gx, rear_z)], 1)
            d = pr - o
            d /= np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-12)
            ok, _, _ = _trace_from_film_host_vec(elements, rear_z, o, d)
            if ok.any():
                any_ok = True
                lo = np.minimum(lo, [gx[ok].min(), gy[ok].min()])
                hi = np.maximum(hi, [gx[ok].max(), gy[ok].max()])
        if not any_ok:
            # fully vignetted zone: degenerate (zero-area) bbox
            bounds[i] = (0, 0, 0, 0)
        else:
            bounds[i] = (lo[0] - spacing, lo[1] - spacing,
                         hi[0] + spacing, hi[1] + spacing)
    return bounds


def _trace_from_film_host(elements, rear_z, o, d):
    """Scalar numpy mirror of realistic_generate_ray's element loop
    (film side -> scene side), used for focusing at build time."""
    o = np.array(o, np.float64)
    d = np.array(d, np.float64)
    z = float(rear_z)
    eta_prev = 1.0
    for k in range(elements.shape[0]):
        R, thick, eta_elem, ap = (float(v) for v in elements[k])
        if R == 0.0:
            if abs(d[2]) < 1e-12:
                return False, o, d
            t = (z - o[2]) / d[2]
            p = o + t * d
        else:
            zc = z + R
            oc = o - np.asarray([0.0, 0.0, zc])
            b = np.dot(oc, d)
            c = np.dot(oc, oc) - R * R
            disc = b * b - c
            if disc < 0:
                return False, o, d
            sq = np.sqrt(disc)
            t = (-b - sq) if (d[2] > 0) == (R > 0) else (-b + sq)
            if t <= 0:
                return False, o, d
            p = o + t * d
        if p[0] ** 2 + p[1] ** 2 > ap * ap:
            return False, o, d
        if R != 0.0:
            zc = z + R
            n = (p - np.asarray([0.0, 0.0, zc])) / R
            if np.dot(n, d) > 0:
                n = -n
            eta_ratio = eta_prev / max(eta_elem, 1e-6)
            cos_i = -np.dot(n, d)
            sin2_t = eta_ratio ** 2 * (1 - cos_i ** 2)
            if sin2_t >= 1:
                return False, o, d
            cos_t = np.sqrt(1 - sin2_t)
            d = eta_ratio * d + (eta_ratio * cos_i - cos_t) * n
            d /= np.linalg.norm(d)
            eta_prev = eta_elem
        o = p
        z += thick
    return True, o, d


def realistic_generate_ray(cam: Camera, p_film, u_lens):
    """Device lens trace film->scene (reference TraceLensesFromFilm,
    cameras.cpp; static unrolled loop over elements). Returns
    (o_world, d_world, weight) — weight 0 for vignetted rays."""
    E = cam.lens_elements.shape[0]
    # film point from raster coords (film diag sets physical film size)
    aspect = cam.width / cam.height
    diag = cam.film_diag
    fh = diag / np.sqrt(1.0 + aspect * aspect)
    fw = aspect * fh
    x = (0.5 - p_film[..., 0] / cam.width) * fw
    y = (p_film[..., 1] / cam.height - 0.5) * fh
    o = jnp.stack([x, y, jnp.zeros_like(x)], -1)
    # sample a point on the rear element: inside the tabulated exit-pupil
    # bbox for this film radius (reference SampleExitPupil,
    # cameras.cpp:861-897), falling back to the full rear disk when no
    # tabulation is present
    r_rear = cam.lens_elements[0, 3]
    from .utils import sampling as sp
    if cam.exit_pupil is not None:
        n_zones = cam.exit_pupil.shape[0]
        r_film = jnp.sqrt(x * x + y * y)
        zone = jnp.clip((r_film / cam.film_r_max
                         * n_zones).astype(jnp.int32), 0, n_zones - 1)
        bb = cam.exit_pupil[zone]                     # (..., 4)
        px_p = bb[..., 0] + u_lens[..., 0] * (bb[..., 2] - bb[..., 0])
        py_p = bb[..., 1] + u_lens[..., 1] * (bb[..., 3] - bb[..., 1])
        area = (bb[..., 2] - bb[..., 0]) * (bb[..., 3] - bb[..., 1])
        # rotate the +x-axis pupil frame to the film point's azimuth
        inv_r = 1.0 / jnp.maximum(r_film, 1e-12)
        cos_p = jnp.where(r_film > 1e-9, x * inv_r, 1.0)
        sin_p = jnp.where(r_film > 1e-9, y * inv_r, 0.0)
        pl = jnp.stack([cos_p * px_p - sin_p * py_p,
                        sin_p * px_p + cos_p * py_p], -1)
        # pdf change vs the uniform rear-disk baseline the exposure
        # normalization assumes: scale by A_pupil / A_rear
        area_scale = area / (np.pi * r_rear * r_rear)
    else:
        pl = sp.sample_uniform_disk_concentric(u_lens) * r_rear
        area_scale = jnp.ones_like(x)
    p_rear = jnp.stack([pl[..., 0], pl[..., 1],
                        jnp.broadcast_to(cam.rear_z, x.shape)], -1)
    d = vm.normalize(p_rear - o)
    # Reference RealisticCamera::GenerateRay weights rays sampled on the
    # rear-element disk by cos^4(theta) * A / rearZ^2 (cameras.cpp
    # exit-pupil importance weight). The A_rear/z^2 factor is
    # ray-independent, so we fold it into exposure normalization (our film
    # has no physical sensor imaging-ratio chain) and keep the
    # ray-dependent natural vignetting falloff cos^4(theta) plus the
    # pupil-vs-disk area ratio that keeps the tabulated sampling unbiased
    # against that same normalization.
    cos_theta = jnp.abs(d[..., 2])
    ray_weight = cos_theta ** 4 * area_scale
    ok = jnp.ones(x.shape, bool)
    z = cam.rear_z
    eta_prev = jnp.ones(x.shape)
    for k in range(E):
        R = cam.lens_elements[k, 0]
        thick = cam.lens_elements[k, 1]
        eta_elem = cam.lens_elements[k, 2]
        ap = cam.lens_elements[k, 3]
        is_stop = R == 0.0
        # surface intersection
        t_flat = safe_div(z - o[..., 2], d[..., 2])
        zc = z + R
        oc = o - jnp.stack([jnp.zeros_like(x), jnp.zeros_like(x),
                            jnp.broadcast_to(zc, x.shape)], -1)
        b = vm.dot(oc, d)
        c = vm.dot(oc, oc) - R * R
        disc = b * b - c
        sq = jnp.sqrt(jnp.maximum(disc, 0.0))
        use_near = (d[..., 2] > 0) == (R > 0)
        t_sph = jnp.where(use_near, -b - sq, -b + sq)
        t = jnp.where(is_stop, t_flat, t_sph)
        ok = ok & jnp.where(is_stop, True, disc >= 0) & (t > 0)
        p = o + t[..., None] * d
        ok = ok & (sqr(p[..., 0]) + sqr(p[..., 1]) <= ap * ap)
        # refraction at curved interfaces
        n = (p - jnp.stack([jnp.zeros_like(x), jnp.zeros_like(x),
                            jnp.broadcast_to(zc, x.shape)], -1)) /             jnp.where(R == 0.0, 1.0, R)
        n = jnp.where(vm.dot(n, d)[..., None] > 0, -n, n)
        eta_ratio = safe_div(eta_prev, jnp.maximum(eta_elem, 1e-6))
        cos_i = -vm.dot(n, d)
        sin2_t = sqr(eta_ratio) * (1.0 - sqr(cos_i))
        tir = sin2_t >= 1.0
        cos_t = jnp.sqrt(jnp.maximum(1.0 - sin2_t, 0.0))
        d_refr = vm.normalize(eta_ratio[..., None] * d +
                              (eta_ratio * cos_i - cos_t)[..., None] * n)
        d = jnp.where(is_stop, d, jnp.where(tir[..., None], d, d_refr))
        ok = ok & (is_stop | ~tir)
        o = p
        eta_prev = jnp.where(is_stop, eta_prev,
                             jnp.broadcast_to(eta_elem, x.shape))
        z = z + thick
    # to world: camera looks down +z in lens space already
    m = cam.c2w_m
    o_w = _rotate(o, m[:3, :3].T) + m[:3, 3]
    d_w = vm.normalize(_rotate(d, m[:3, :3].T))
    return o_w, d_w, ok.astype(jnp.float32) * ray_weight


def camera_ray_differentials(cam: Camera):
    """Per-pixel differential scale for texture filtering: approximate
    dpdx spacing via one-pixel screen offsets (reference
    CameraBase::Approximate_dp_dxy). Returns scalar radians-per-pixel-ish
    spread used for ray cones."""
    if cam.kind == CAMERA_PERSPECTIVE:
        return float(2 * np.asarray(cam.tan_half_fov) *
                     (cam.screen_max[0] - cam.screen_min[0]) / 2 / cam.width)
    return 1.0 / cam.width


def pixel_cone_spread(cam: Camera):
    """Traced scalar: angular width of one pixel's ray cone — feeds texture
    MIP selection through the path integrator's cone state (the array
    substitution for dual differential rays, cameras.h:140). Works under
    jit (uses jnp on traced camera fields)."""
    if cam.kind == CAMERA_PERSPECTIVE and cam.tan_half_fov is not None:
        return 2.0 * cam.tan_half_fov * \
            (cam.screen_max[0] - cam.screen_min[0]) / 2.0 / cam.width
    return jnp.float32(1.0 / cam.width)


# ---------------------------------------------------------------------------
# Camera importance (reference cameras.cpp PerspectiveCamera::We / PDF_We /
# SampleWi) — the camera-as-sensor side of the path integral, needed by the
# light-transport family (LightPath / BDPT splats).

def _image_plane_area(cam: Camera):
    """Area of the film's image rectangle on the z=1 camera plane."""
    sx = (cam.screen_max[0] - cam.screen_min[0])
    sy = (cam.screen_max[1] - cam.screen_min[1])
    return jnp.abs(sx * sy) * cam.tan_half_fov * cam.tan_half_fov


def camera_we(cam: Camera, o_w, d_w):
    """Importance We of rays (o, d) arriving at the lens, plus the raster
    point they focus to. Perspective only.

    Returns dict(we (N,), p_raster (N, 2), valid (N,)).
    (reference PerspectiveCamera::We, cameras.cpp)"""
    m = cam.c2w_m
    fwd = m[:3, 2]                           # camera +z in world
    cos_theta = vm.dot(d_w, fwd)
    valid = cos_theta > 1e-6
    ct = jnp.maximum(cos_theta, 1e-6)
    lens_ok = cam.lens_radius > 0
    focus_t = jnp.where(lens_ok, cam.focal_distance, 1.0) / ct
    p_focus_w = o_w + focus_t[..., None] * d_w
    # world -> camera
    r = m[:3, :3]
    p_cam = _rotate(p_focus_w - m[:3, 3], r)      # R^T (inverse rotation)
    z = jnp.maximum(p_cam[..., 2], 1e-6)
    sx = p_cam[..., 0] / (z * cam.tan_half_fov)
    sy = p_cam[..., 1] / (z * cam.tan_half_fov)
    px = (sx - cam.screen_min[0]) / (cam.screen_max[0] - cam.screen_min[0]) \
        * cam.width
    py = (cam.screen_max[1] - sy) / (cam.screen_max[1] - cam.screen_min[1]) \
        * cam.height
    inside = (px >= 0) & (px < cam.width) & (py >= 0) & (py < cam.height)
    valid = valid & inside
    lens_area = jnp.where(lens_ok, PI * cam.lens_radius ** 2, 1.0)
    we = 1.0 / (_image_plane_area(cam) * lens_area * ct ** 4)
    return dict(we=jnp.where(valid, we, 0.0),
                p_raster=jnp.stack([px, py], -1), valid=valid)


def camera_sample_wi(cam: Camera, p_ref, u_lens):
    """Sample a lens point and the direction from p_ref toward it
    (reference PerspectiveCamera::SampleWi).

    Returns dict(wi (N,3) toward camera, we (N,), pdf (N,) solid angle at
    p_ref, p_raster (N,2), p_lens (N,3), valid (N,))."""
    from .utils import sampling as sp
    m = cam.c2w_m
    lens_ok = cam.lens_radius > 0
    p_l2 = cam.lens_radius * sp.sample_uniform_disk_concentric(u_lens)
    p_lens_cam = jnp.stack([p_l2[..., 0], p_l2[..., 1],
                            jnp.zeros_like(p_l2[..., 0])], -1)
    p_lens_w = _rotate(p_lens_cam, m[:3, :3].T) + m[:3, 3]
    fwd = m[:3, 2]
    wi = p_lens_w - p_ref
    dist = jnp.maximum(vm.length(wi), 1e-9)
    wi = wi / dist[..., None]
    lens_area = jnp.where(lens_ok, PI * cam.lens_radius ** 2, 1.0)
    cos_lens = jnp.abs(vm.dot(fwd, wi))
    pdf = dist * dist / (jnp.maximum(cos_lens, 1e-9) * lens_area)
    we = camera_we(cam, p_lens_w, -wi)
    return dict(wi=wi, we=we["we"], pdf=pdf, p_raster=we["p_raster"],
                p_lens=p_lens_w, valid=we["valid"])


def camera_pdf_we(cam: Camera, o_w, d_w):
    """(pdf_pos, pdf_dir) of GenerateRay producing ray (o, d)
    (reference PerspectiveCamera::PDF_We) — BDPT camera-vertex pdfs."""
    m = cam.c2w_m
    fwd = m[:3, 2]
    we = camera_we(cam, o_w, d_w)
    cos_theta = jnp.maximum(vm.dot(d_w, fwd), 1e-6)
    lens_ok = cam.lens_radius > 0
    lens_area = jnp.where(lens_ok, PI * cam.lens_radius ** 2, 1.0)
    pdf_pos = jnp.where(we["valid"], 1.0 / lens_area, 0.0)
    pdf_dir = jnp.where(we["valid"],
                        1.0 / (_image_plane_area(cam) * cos_theta ** 3), 0.0)
    return pdf_pos, pdf_dir
