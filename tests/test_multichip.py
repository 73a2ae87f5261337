"""Multi-chip correctness: a pixel-sharded render over the 8-device CPU
mesh must EQUAL the single-device render (same sampler streams, same
wave decomposition — only the film reduction order differs, so fp
tolerance only). Proves parallel/mesh.py's shard_map path, not just
liveness (reference scale-out role: cpu/integrators.cpp:163
ParallelFor2D tiles; here DP over a jax.sharding.Mesh, SURVEY §2.9)."""
import numpy as np
import jax
import pytest

from pbrt_jax import scenes
from pbrt_jax import samplers as smp
from pbrt_jax.integrators import render as rdr
from pbrt_jax.integrators.path import PathOptions
from pbrt_jax.parallel import mesh as pmesh


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8-device mesh")
def test_sharded_render_equals_single_device():
    W = H = 24
    spp = 2
    scene, cam = scenes.make_cornell_box(width=W, height=H)
    sampler = smp.make_sampler("independent", spp=spp)
    opts = PathOptions(max_depth=3)

    img1, _ = rdr.render(scene, cam, spp=spp, sampler=sampler, opts=opts,
                         waves_per_dispatch=1)

    mesh = pmesh.make_mesh(jax.devices()[:8])
    img8, info = pmesh.render_multichip(scene, cam, spp=spp,
                                        sampler=sampler, opts=opts,
                                        mesh=mesh)
    assert info["n_devices"] == 8
    np.testing.assert_allclose(np.asarray(img8), np.asarray(img1),
                               rtol=2e-4, atol=2e-5)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8-device mesh")
def test_sharded_zsobol_depth4_equals_single_device():
    """Production sampler + depth: the zsobol per-lane streams must be a
    pure function of (pixel, sample index) for sharding to commute with
    rendering (VERDICT r4 #6 — the original evidence was one independent-
    sampler depth-3 config)."""
    W = H = 24
    spp = 2
    scene, cam = scenes.make_cornell_box(width=W, height=H)
    sampler = smp.make_sampler("zsobol", spp=spp, full_resolution=(W, H))
    opts = PathOptions(max_depth=4)

    img1, _ = rdr.render(scene, cam, spp=spp, sampler=sampler, opts=opts,
                         waves_per_dispatch=1)
    mesh = pmesh.make_mesh(jax.devices()[:8])
    img8, info = pmesh.render_multichip(scene, cam, spp=spp,
                                        sampler=sampler, opts=opts,
                                        mesh=mesh)
    assert info["n_devices"] == 8
    np.testing.assert_allclose(np.asarray(img8), np.asarray(img1),
                               rtol=2e-4, atol=2e-5)


def _mesh_scene(width, height):
    """Small BVH trianglemesh scene (icosphere + lit box) — the meshfield
    code-path class: BVH traversal + the compaction driver's per-depth
    shared ray sort (pbrt_jax/integrators/path.py::_run_compacted)."""
    from pbrt_jax import scene_core as sc
    from pbrt_jax import cameras as cam_mod
    from pbrt_jax.utils import color as pcolor
    from pbrt_jax.utils import transform as tfm

    b = sc.SceneBuilder()
    verts, faces, _n = scenes.make_sphere_mesh((0.0, 1.0, 0.0), 1.0,
                                               subdiv=2)
    grey = b.materials.add_diffuse((0.6, 0.55, 0.5))
    b.add_mesh(verts, faces, grey)
    white = b.materials.add_diffuse((0.73, 0.73, 0.73))
    s = 8.0
    scenes._quad(b, [(-s, 0, -s), (s, 0, -s), (s, 0, s), (-s, 0, s)], white)
    emit = pcolor.RGBIlluminantSpectrum((14.0, 12.0, 8.0), b.cs)
    scenes._quad(b, [(1.5, 4.0, 1.5), (1.5, 4.0, -1.5), (-1.5, 4.0, -1.5),
                     (-1.5, 4.0, 1.5)], white, emission=emit)
    scene = b.build(light_sampler="power", force_bvh=True)
    cam = cam_mod.make_camera(
        "perspective",
        camera_from_world=tfm.look_at((0, 2.5, -6), (0, 1, 0),
                                      (0, 1, 0)).inverse(),
        width=width, height=height, fov=40.0)
    return scene, cam


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8-device mesh")
def test_sharded_compacted_mesh_equals_single_device():
    """BVH mesh scene with lane compaction forced ON, sharded vs single:
    the compaction driver (per-depth argsort + device-side pow2 bucket
    lax.switch) must commute with pixel sharding (VERDICT r4 #6 asked for
    a meshfield-class BVH+compaction multi-chip case)."""
    W = H = 24
    spp = 2
    scene, cam = _mesh_scene(W, H)
    assert scene.traversal in ("bvh_xla", "bvh_cuda")
    sampler = smp.make_sampler("zsobol", spp=spp, full_resolution=(W, H))
    opts = PathOptions(max_depth=4, compaction=True, compaction_start=1)

    img1, _ = rdr.render(scene, cam, spp=spp, sampler=sampler, opts=opts,
                         waves_per_dispatch=1)
    mesh = pmesh.make_mesh(jax.devices()[:8])
    img8, info = pmesh.render_multichip(scene, cam, spp=spp,
                                        sampler=sampler, opts=opts,
                                        mesh=mesh)
    assert info["n_devices"] == 8
    np.testing.assert_allclose(np.asarray(img8), np.asarray(img1),
                               rtol=2e-4, atol=2e-5)
