"""Route selection, the compile-cache helper, the pytree dataclasses and
chip_smoke.py's behaviour off the GPU (including a four-virtual-device
rehearsal of its `--cards 4` comparison)."""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from pbrt_jax import scene_core as sc
from pbrt_jax.ops import bvh_cuda
from pbrt_jax.utils import compile_cache
from pbrt_jax.utils import struct

ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("kw,route", [
    (dict(n_tri=32), "brute"),
    (dict(n_tri=20_000), "bvh_xla"),
    (dict(n_tri=20_000, platform="gpu"), "bvh_cuda"),
    (dict(n_tri=32, force_bvh=True, platform="gpu"), "bvh_cuda"),
    (dict(n_tri=20_000, force_bvh=False, platform="gpu"), "brute"),
    (dict(n_tri=20_000, has_instances=True, platform="gpu"), "tlas"),
    (dict(n_tri=20_000, accelerator="kdtree", platform="gpu"), "kdtree"),
])
def test_select_traversal(kw, route):
    assert sc.select_traversal(**kw) == route
    assert route in sc.TRAVERSALS


def test_crossover_is_the_brute_force_cap():
    cap = sc.BRUTE_FORCE_MAX_TRIS
    assert sc.select_traversal(cap) == "brute"
    assert sc.select_traversal(cap + 1) == "bvh_xla"


def _quad_builder():
    b = sc.SceneBuilder()
    m = b.materials.add_diffuse((0.5, 0.5, 0.5))
    b.add_mesh(np.asarray([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]],
                          np.float32), [[0, 1, 2], [0, 2, 3]], m)
    return b


def test_gpu_build_failure_raises(monkeypatch, tmp_path):
    """A scene routed to the kernel builds it at scene build; a failed
    build raises instead of falling back to the XLA loop."""
    monkeypatch.setattr(bvh_cuda, "_BUILD", tmp_path)
    monkeypatch.setattr(bvh_cuda, "find_nvcc", lambda: None)
    monkeypatch.setattr(bvh_cuda, "_registered", False)
    with pytest.raises(bvh_cuda.BuildError):
        _quad_builder().build(force_bvh=True, platform="gpu")


def test_cpu_build_never_touches_the_kernel(monkeypatch):
    def boom():
        raise AssertionError("kernel build on a CPU scene")
    monkeypatch.setattr(bvh_cuda, "ensure_registered", boom)
    scene = _quad_builder().build(force_bvh=True, platform="cpu")
    assert scene.traversal == "bvh_xla"
    assert scene.tri_geo_bvh.shape[1] == 10


def test_cache_dir_env_var_is_honoured(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.setup_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_cache_dir_default_is_in_the_checkout(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        got = compile_cache.setup_compile_cache()
        assert got == str(ROOT / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == got
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    ignored = (ROOT / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored


@struct.dataclass
class _Pair:
    a: object
    n: int = struct.field(pytree_node=False, default=3)


def test_struct_dataclass_is_a_pytree_with_static_fields():
    p = _Pair(a=np.float32(2.0))
    leaves, treedef = jax.tree_util.tree_flatten(p)
    assert leaves == [np.float32(2.0)]
    q = jax.tree_util.tree_unflatten(treedef, [5.0])
    assert q.a == 5.0 and q.n == 3
    assert jax.jit(lambda p: p.a * p.n)(p) == 6.0


def test_struct_replace_and_frozen():
    p = _Pair(a=1.0)
    q = p.replace(n=4)
    assert (q.a, q.n, p.n) == (1.0, 4, 3)
    with pytest.raises(Exception):
        p.a = 2.0


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_gpu(where, tmp_path):
    """No GPU, or the script without the repo: non-zero, no result line."""
    cwd = ROOT
    if where == "alone":
        shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "needs 1 GPU device(s)" in r.stderr
    assert '"ok": true' not in r.stdout


def test_chip_smoke_four_card_rehearsal():
    """chip_smoke.py --cards 4's comparison on four virtual CPU devices:
    `--chips 4` through the CLI equals the one-device CLI render, and the
    pixel ids and film sit on four distinct devices."""
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 (virtual) devices")
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    rec = chip_smoke.phase_sharded(
        "cornell", 4, overrides=("--spp", "2", "--resolution", "16x16",
                                 "--maxdepth", "2"), golden=False)
    assert rec["ok"], rec
    assert rec["equal_to_one_card"] and rec["on_distinct_devices"]
    assert len(set(rec["film_devices"])) == 4
