"""Exact quadric shapes: disk, cylinder, transformed sphere/ellipsoid
(reference shapes.h Sphere:107 / Disk:404 / Cylinder:574 — analytic
intersections, not tessellations)."""
import pytest
import jax.numpy as jnp
import numpy as np

from pbrt_jax import scene_core as sc
from pbrt_jax.utils import transform as tfm


def _scene():
    b = sc.SceneBuilder()
    m = b.materials.add_diffuse((0.5, 0.5, 0.5))
    b.add_mesh([[900, 900, 900], [901, 900, 900], [900, 901, 900]],
               [[0, 1, 2]], m)
    # annulus at z=2, outer 1, inner 0.25
    b.add_disk(np.eye(4), 1.0, m, height=2.0, inner_radius=0.25)
    # cylinder along the y axis (rotated 90deg about x), radius 0.5
    b.add_cylinder(tfm.rotate(90, (1, 0, 0)).m, 0.5, -1.0, 1.0, m)
    # ellipsoid: unit sphere scaled (2,1,1), centered at x=5
    o2w = tfm.translate((5, 0, 0)).m @ tfm.scale(2, 1, 1).m
    b.add_quadric_sphere(o2w, 1.0, m)
    return b.build(light_sampler="uniform", force_bvh=False)


@pytest.mark.slow
def test_quadric_hits_exact():
    scene = _scene()
    o = jnp.asarray([[0., 0., -5.], [5., 0., -5.], [6.9, 0., -5.],
                     [7.1, 0., -5.], [0.6, 0., -5.], [0.1, 0., -5.]])
    d = jnp.asarray([[0., 0., 1.]] * 6)
    r = sc.intersect(scene, o, d, jnp.full((6,), 1e30))
    hit = np.asarray(r["hit"])
    t = np.asarray(r["t"])
    # axial ray hits the y-axis cylinder surface x^2+z^2=0.25 at z=-0.5
    assert hit[0] and abs(t[0] - 4.5) < 1e-4
    # ellipsoid: x half-axis 2 -> front face at z=-1 from x=5 axial ray
    assert hit[1] and abs(t[1] - 4.0) < 1e-4
    # x=6.9 is inside the 2-unit x half-axis; x=7.1 outside
    assert hit[2] and not hit[3]
    # x=0.6 misses the cylinder (|x|>0.5), hits the disk plane z=2
    assert hit[4] and abs(t[4] - 7.0) < 1e-4
    np.testing.assert_allclose(np.asarray(r["ng"])[4], [0, 0, 1], atol=1e-5)
    # x=0.1 passes through the disk's inner hole, hits the cylinder
    assert hit[5] and abs(t[5] - (5 - np.sqrt(0.25 - 0.01))) < 1e-3
    occ = np.asarray(sc.intersect_p(scene, o, d, jnp.full((6,), 10.0)))
    np.testing.assert_array_equal(occ, [True, True, True, False, True, True])


def test_quadric_normals_transformed():
    """Ellipsoid normals use the inverse-transpose transform: at the tip of
    the long axis the normal is +x even though the point map is squashed."""
    b = sc.SceneBuilder()
    m = b.materials.add_diffuse((0.5, 0.5, 0.5))
    b.add_mesh([[900, 900, 900], [901, 900, 900], [900, 901, 900]],
               [[0, 1, 2]], m)
    b.add_quadric_sphere(tfm.scale(2, 1, 1).m, 1.0, m)
    scene = b.build(light_sampler="uniform", force_bvh=False)
    o = jnp.asarray([[-5., 0., 0.], [0., -5., 0.6]])
    d = jnp.asarray([[1., 0., 0.], [0., 1., 0.]])
    r = sc.intersect(scene, o, d, jnp.full((2,), 1e30))
    ng = np.asarray(r["ng"])
    np.testing.assert_allclose(ng[0], [-1, 0, 0], atol=1e-5)
    # at (0, -y0, 0.6) on the ellipsoid, gradient of x^2/4+y^2+z^2 is
    # (0, 2y, 2z) -> normalize([0, -y0, 0.6]); y0 = sqrt(1-0.36)=0.8
    np.testing.assert_allclose(ng[1], [0, -0.8, 0.6], atol=1e-4)
