"""Pin the compaction auto-default: "auto" resolves OFF on every traversal
route. On the H100 (700 W) forcing it ON measured slower end to end with
the CUDA traversal kernel: meshfield 104-112M vs 140-149M paths/s,
killeroo 40-42M vs 44-45M (PERF.md); True still forces it on."""
import types

import pytest

from pbrt_jax import scene_core as sc
from pbrt_jax.integrators import path as path_mod


def _scene(route):
    return types.SimpleNamespace(traversal=route)


def test_auto_off_for_brute_force():
    opts = path_mod.PathOptions(compaction="auto")
    assert path_mod._resolve_compaction(_scene("brute"), opts) is False


@pytest.mark.parametrize("route", sc.TRAVERSALS)
def test_auto_off_for_every_route(route):
    opts = path_mod.PathOptions(compaction="auto")
    assert path_mod._resolve_compaction(_scene(route), opts) is False


def test_explicit_override_wins():
    assert path_mod._resolve_compaction(
        _scene("bvh_cuda"), path_mod.PathOptions(compaction=False)) is False
    assert path_mod._resolve_compaction(
        _scene("brute"), path_mod.PathOptions(compaction=True)) is True


def test_cornell_resolves_off():
    """The flagship bench scene itself must resolve to OFF."""
    from pbrt_jax import scenes
    scene, _ = scenes.make_cornell_box(width=8, height=8)
    assert path_mod._resolve_compaction(
        scene, path_mod.PathOptions(compaction="auto")) is False
