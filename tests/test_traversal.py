"""Every traversal route of the scene dispatch against the brute-force
all-pairs oracle (ops/bvh.py brute_force_intersect_triangles).

Routes: "brute", "bvh_xla" (the XLA while-loop) and "bvh_cuda" with the
kernel replaced by its plain-JAX contract (ops/bvh_cuda.reference_call):
the wrapper, its packed layouts and the dispatch run here on the CPU; the
compiled kernel itself is compared on the GPU (test_bvh_cuda.py,
chip_smoke.py phase 6)."""
import jax.numpy as jnp
import numpy as np
import pytest

from pbrt_jax import scene_core as sc
from pbrt_jax import scenes
from pbrt_jax.ops import bvh as bvh_mod
from pbrt_jax.ops import bvh_cuda

ROUTES = ("brute", "bvh_xla", "bvh_cuda")


@pytest.fixture(autouse=True)
def _kernel_contract(monkeypatch):
    """Route the "bvh_cuda" wrapper through its plain-JAX contract."""
    monkeypatch.setattr(bvh_cuda, "ensure_registered", lambda: None)
    monkeypatch.setattr(bvh_cuda, "_ffi_call", bvh_cuda.reference_call)


def _soup(T, seed, degenerate=False):
    rng = np.random.default_rng(seed)
    p0 = rng.uniform(-2, 2, (T, 3)).astype(np.float32)
    p1 = (p0 + rng.uniform(-1, 1, (T, 3))).astype(np.float32)
    p2 = (p0 + rng.uniform(-1, 1, (T, 3))).astype(np.float32)
    if degenerate:
        # zero-area triangles: a repeated vertex and collinear vertices
        p1[::3] = p0[::3]
        p2[1::3] = 0.5 * (p0[1::3] + p1[1::3])
    return p0, p1, p2


def _deep(T=100):
    """Parallel triangles at exponentially growing x: the SAH build peels
    few off per level, so the tree is deeper than a balanced one."""
    x = (1.2 ** np.arange(T)).astype(np.float32)
    z = np.zeros(T, np.float32)
    p0 = np.stack([x, z - 1, z - 1], 1)
    p1 = np.stack([x, z + 1, z - 1], 1)
    p2 = np.stack([x, z, z + 1], 1)
    return p0, p1, p2


def _sphere():
    v, f, _ = scenes.make_sphere_mesh((0.2, -0.1, 0.3), 1.5, subdiv=3)
    v = np.asarray(v, np.float32)
    f = np.asarray(f)
    return v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]


SCENES = {
    "soup9": lambda: _soup(9, 3),
    "soup300": lambda: _soup(300, 7),
    "degenerate": lambda: _soup(120, 5, degenerate=True),
    "sphere": _sphere,
    "deep": _deep,
}


def _build(tris, route):
    p0, p1, p2 = tris
    b = sc.SceneBuilder()
    mat = b.materials.add_diffuse((0.5, 0.5, 0.5))
    verts = np.concatenate([p0, p1, p2])
    T = len(p0)
    idx = np.stack([np.arange(T), T + np.arange(T), 2 * T + np.arange(T)], 1)
    b.add_mesh(verts, idx, mat, normals=np.ones_like(verts))
    scene = b.build(force_bvh=route != "brute",
                    platform="gpu" if route == "bvh_cuda" else "cpu")
    assert scene.traversal == route
    return scene


def _rays(tris, n, seed=0):
    """n rays from a box around the triangles, one in four with a zero
    direction component and one in eight axis-aligned."""
    p0, p1, p2 = tris
    pts = np.concatenate([p0, p1, p2])
    lo, hi = pts.min(0) - 1, pts.max(0) + 1
    rng = np.random.default_rng(seed)
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    tgt = pts[rng.integers(0, len(pts), n)] + \
        rng.normal(scale=0.3, size=(n, 3)).astype(np.float32)
    d = tgt - o
    d[::4, 1] = 0.0
    d[::8, 0] = 0.0
    d[::8, 2] = 0.0
    d[::8, 1] = np.where(d[::8, 1] == 0, 1.0, d[::8, 1])
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d.astype(np.float32))


def _oracle(tris, o, d, tmax):
    p0, p1, p2 = (jnp.asarray(p) for p in tris)
    return bvh_mod.brute_force_intersect_triangles(p0, p1, p2, o, d, tmax)


def _assert_same_hits(ref, new):
    hit = np.asarray(ref["hit"])
    np.testing.assert_array_equal(hit, np.asarray(new["hit"]))
    np.testing.assert_array_equal(np.asarray(ref["prim"])[hit],
                                  np.asarray(new["prim"])[hit])
    np.testing.assert_allclose(np.asarray(ref["t"])[hit],
                               np.asarray(new["t"])[hit], rtol=1e-5, atol=1e-6)
    for k in ("b0", "b1", "b2"):
        np.testing.assert_allclose(np.asarray(ref[k])[hit],
                                   np.asarray(new[k])[hit], atol=1e-5)


@pytest.mark.parametrize("scene_name", sorted(SCENES))
@pytest.mark.parametrize("route", ROUTES)
def test_closest_hit_matches_brute_force(route, scene_name):
    tris = SCENES[scene_name]()
    scene = _build(tris, route)
    o, d = _rays(tris, 700)
    tmax = jnp.full((700,), 1e30, jnp.float32)
    ref = _oracle(tris, o, d, tmax)
    assert np.asarray(ref["hit"]).any()
    _assert_same_hits(ref, sc._tri_dispatch(scene, o, d, tmax))


@pytest.mark.parametrize("scene_name", ["soup300", "sphere", "deep"])
@pytest.mark.parametrize("route", ROUTES)
def test_any_hit_matches_brute_force(route, scene_name):
    tris = SCENES[scene_name]()
    scene = _build(tris, route)
    o, d = _rays(tris, 500, seed=11)
    tmax = jnp.asarray(np.random.default_rng(2).uniform(0.5, 6.0, 500),
                       jnp.float32)
    ref = _oracle(tris, o, d, tmax)
    occ = sc.intersect_p(scene, o, d, tmax)
    np.testing.assert_array_equal(np.asarray(ref["hit"]), np.asarray(occ))


@pytest.mark.parametrize("route", ROUTES)
def test_tmax_respected(route):
    tris = SCENES["soup300"]()
    scene = _build(tris, route)
    o, d = _rays(tris, 400, seed=5)
    r = sc._tri_dispatch(scene, o, d, jnp.full((400,), 0.5, jnp.float32))
    hit = np.asarray(r["hit"])
    assert np.all(np.asarray(r["t"])[hit] < 0.5)
    assert np.all(np.isinf(np.asarray(r["t"])[~hit]))


@pytest.mark.parametrize("n", [1, 127, 129])
def test_ray_counts_off_the_block_size(n):
    """Wave sizes that are not a multiple of the kernel's 128-thread block
    (the wrapper never pads the ray count)."""
    tris = SCENES["sphere"]()
    scene = _build(tris, "bvh_cuda")
    o, d = _rays(tris, n, seed=n)
    tmax = jnp.full((n,), 1e30, jnp.float32)
    r = sc._tri_dispatch(scene, o, d, tmax)
    assert all(np.asarray(v).shape == (n,) for v in r.values())
    _assert_same_hits(_oracle(tris, o, d, tmax), r)


@pytest.mark.parametrize("route", ROUTES)
def test_dense_grid_of_rays_against_quad(route):
    """Axis-aligned quad, grid of rays straight down -z (two zero
    direction components): analytic hit pattern."""
    v = np.asarray([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]],
                   np.float32)
    tris = (v[[0, 0]], v[[1, 2]], v[[2, 3]])
    scene = _build(tris, route)
    # the grid stays off the shared diagonal edge: hits exactly on an edge
    # depend on how XLA contracts the edge functions into FMAs
    g = np.linspace(-1.5, 1.5, 31).astype(np.float32)
    xx, yy = np.meshgrid(g + np.float32(0.013), g)
    o = np.stack([xx.ravel(), yy.ravel(), np.full(xx.size, 2.0, np.float32)],
                 1)
    d = np.tile(np.asarray([[0, 0, -1]], np.float32), (xx.size, 1))
    r = sc._tri_dispatch(scene, jnp.asarray(o), jnp.asarray(d),
                         jnp.full((xx.size,), 1e30, jnp.float32))
    inside = (np.abs(o[:, 0]) < 1 - 1e-4) & (np.abs(o[:, 1]) < 1 - 1e-4)
    outside = (np.abs(o[:, 0]) > 1 + 1e-4) | (np.abs(o[:, 1]) > 1 + 1e-4)
    hit = np.asarray(r["hit"])
    assert hit[inside].all() and not hit[outside].any()
    np.testing.assert_allclose(np.asarray(r["t"])[inside], 2.0, rtol=1e-6)


def test_deep_tree_is_deep():
    """The "deep" scene of the oracle tests really exercises a deep stack."""
    p0, p1, p2 = _deep()
    lo = np.minimum(np.minimum(p0, p1), p2)
    hi = np.maximum(np.maximum(p0, p1), p2)
    assert bvh_mod.bvh_max_depth(bvh_mod.build_bvh(lo, hi).nodes) >= 12
