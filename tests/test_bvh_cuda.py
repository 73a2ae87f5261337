"""The CUDA traversal kernel's wrapper (ops/bvh_cuda.py): packed layouts,
output shapes, the library build, and (on a GPU only) the compiled kernel
against the XLA loop."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pbrt_jax import scenes
from pbrt_jax.ops import bvh as bvh_mod
from pbrt_jax.ops import bvh_cuda


def _mesh(seed=0):
    v, f, _ = scenes.make_sphere_mesh((0.0, 0.0, 0.0), 1.0, subdiv=2)
    v = np.asarray(v, np.float32)
    f = np.asarray(f)
    p0, p1, p2 = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
    lo = np.minimum(np.minimum(p0, p1), p2)
    hi = np.maximum(np.maximum(p0, p1), p2)
    bvh = bvh_mod.build_bvh(lo, hi)
    tris = bvh_mod.pack_tri_geo(p0, p1, p2, order=bvh.prim_indices)
    return bvh, tris


def _rays(n, seed=0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    d = (rng.uniform(-0.5, 0.5, (n, 3)) - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


def test_pad_tris_appends_two_zero_columns():
    _, tris = _mesh()
    for t in (tris, jnp.asarray(tris)):
        p = bvh_cuda.pad_tris(t)
        assert p.shape == (tris.shape[0], bvh_cuda.TRI_COLS)
        np.testing.assert_array_equal(np.asarray(p)[:, :10], tris)
        assert not np.asarray(p)[:, 10:].any()
        np.testing.assert_array_equal(np.asarray(bvh_cuda.pad_tris(p)),
                                      np.asarray(p))


def test_pack_rays_layout():
    o, d = _rays(5)
    r = np.asarray(bvh_cuda.pack_rays(o, d, 7.0))
    assert r.shape == (5, 8) and r.dtype == np.float32
    np.testing.assert_array_equal(r[:, 0:3], np.asarray(o))
    np.testing.assert_array_equal(r[:, 3], 7.0)
    np.testing.assert_array_equal(r[:, 4:7], np.asarray(d))
    np.testing.assert_array_equal(r[:, 7], 0.0)


def test_node_and_triangle_columns_decode_as_integers():
    """The kernel decodes node columns 6-7 and triangle column 9 with
    round-to-nearest: they must hold exact small integers."""
    bvh, tris = _mesh()
    nodes = np.asarray(bvh.nodes)
    for col in (nodes[:, 6], nodes[:, 7], tris[:, 9]):
        assert np.all(col == np.round(col)) and np.all(np.abs(col) < 2 ** 24)
    meta = nodes[:, 7].astype(np.int64)
    leaf = (meta >> 2) > 0
    assert np.all((meta >> 2)[leaf] <= bvh_mod.MAX_LEAF_PRIMS)
    assert np.all(nodes[leaf, 6] + (meta >> 2)[leaf] <= len(tris))
    assert np.all(nodes[~leaf, 6] < len(nodes))
    np.testing.assert_array_equal(np.sort(tris[:, 9]), np.arange(len(tris)))


@pytest.mark.parametrize("any_hit", [False, True])
def test_reference_contract_matches_xla_loop(any_hit):
    """reference_call on the packed layouts == the XLA loop on the raw ones,
    with the kernel's output shapes."""
    bvh, tris = _mesh()
    o, d = _rays(300)
    tmax = jnp.full((300,), 2.5, jnp.float32)
    h4, prim = bvh_cuda.reference_call(
        jnp.asarray(bvh.nodes), bvh_cuda.pad_tris(jnp.asarray(tris)),
        bvh_cuda.pack_rays(o, d, tmax), any_hit)
    assert h4.shape == (300, 4) and h4.dtype == jnp.float32
    assert prim.shape == (300,) and prim.dtype == jnp.int32
    ref = bvh_mod.bvh_intersect_triangles(bvh, tris, o, d, tmax,
                                          any_hit=any_hit)
    np.testing.assert_array_equal(np.asarray(prim), np.asarray(ref["prim"]))
    np.testing.assert_array_equal(np.asarray(h4[:, 0]), np.asarray(ref["t"]))


def test_intersect_result_dict():
    bvh, tris = _mesh()
    o, d = _rays(64, seed=3)
    r = bvh_cuda.intersect(bvh.nodes, tris, o, d, 1e30,
                           call=bvh_cuda.reference_call)
    assert set(r) == {"hit", "t", "prim", "b0", "b1", "b2"}
    assert all(v.shape == (64,) for v in r.values())
    hit = np.asarray(r["hit"])
    assert hit.any() and np.all(np.asarray(r["prim"])[~hit] == -1)
    assert np.all(np.isinf(np.asarray(r["t"])[~hit]))
    b = np.stack([np.asarray(r[k])[hit] for k in ("b0", "b1", "b2")])
    np.testing.assert_allclose(b.sum(0), 1.0, atol=1e-5)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(bvh_cuda, "_BUILD", tmp_path)
    monkeypatch.setattr(bvh_cuda, "find_nvcc", lambda: None)
    with pytest.raises(bvh_cuda.BuildError, match="nvcc not found"):
        bvh_cuda.library_path()


def test_failed_compile_raises(monkeypatch, tmp_path):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: no sm_90a here' >&2\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setattr(bvh_cuda, "_BUILD", tmp_path / "build")
    monkeypatch.setenv("NVCC", str(fake))
    with pytest.raises(bvh_cuda.BuildError, match="no sm_90a here"):
        bvh_cuda.library_path()


@pytest.mark.gpu
def test_kernel_matches_xla_loop_on_gpu():
    """The compiled kernel against the XLA loop on the card (closest and
    any hit); the full-width comparison is chip_smoke.py phase 6."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    bvh, tris = _mesh()
    o, d = _rays(10_000, seed=7)
    for any_hit in (False, True):
        tmax = jnp.full((10_000,), 2.0 if any_hit else 1e30, jnp.float32)
        with jax.default_matmul_precision("highest"):
            ref = bvh_mod.bvh_intersect_triangles(bvh, tris, o, d, tmax,
                                                  any_hit=any_hit)
        got = bvh_cuda.intersect(bvh.nodes, tris, o, d, tmax,
                                 any_hit=any_hit)
        assert np.mean(np.asarray(got["hit"]) == np.asarray(ref["hit"])) \
            >= 0.9999
