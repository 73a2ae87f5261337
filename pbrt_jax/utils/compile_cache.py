"""Where JAX keeps its persistent compilation cache.

If JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and nothing here
changes it. Otherwise the cache lives at one fixed directory inside the
checkout, `<repo>/.jax_cache` (git-ignored), so every entry point of the
repo (CLI, tests, chip_smoke.py, bench.py, tools/golden.py) shares it.
"""
from __future__ import annotations

import os
from pathlib import Path

REPO_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def setup_compile_cache() -> str:
    """Point JAX's compilation cache at the chosen directory; returns it."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    jax.config.update("jax_compilation_cache_dir", str(REPO_CACHE_DIR))
    return str(REPO_CACHE_DIR)
