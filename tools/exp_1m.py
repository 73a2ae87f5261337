#!/usr/bin/env python3
"""Million-triangle traversal benchmark: a seeded ~1M-triangle heightfield
terrain in one flat BVH, traced through the scene's traversal route
(scene_core.select_traversal: the CUDA kernel on a GPU) with raster-,
camera- and bounce-class rays.

    python tools/exp_1m.py [--n 708]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def make_terrain(n=708):
    """(V, F): ~1M-tri sine-displaced heightfield over [0,10]^2."""
    import numpy as np
    xs = np.linspace(0, 10, n)
    X, Z = np.meshgrid(xs, xs, indexing="ij")
    Y = (0.6 * np.sin(1.7 * X) * np.cos(1.3 * Z)
         + 0.25 * np.sin(4.1 * X + 1.0) * np.sin(3.7 * Z)
         + 0.08 * np.sin(11.0 * X) * np.cos(9.0 * Z))
    V = np.stack([X, Y, Z], -1).reshape(-1, 3).astype(np.float32)
    idx = np.arange(n * n).reshape(n, n)
    a = idx[:-1, :-1].reshape(-1)
    b = idx[1:, :-1].reshape(-1)
    c = idx[1:, 1:].reshape(-1)
    d = idx[:-1, 1:].reshape(-1)
    import numpy as np2
    F = np2.concatenate([np2.stack([a, b, c], -1),
                         np2.stack([a, c, d], -1)]).astype(np2.int32)
    return V, F


def gen_rays(V, kind, N, seed=5):
    import numpy as np
    rng = np.random.default_rng(seed)
    if kind == "raster":
        # honest production pattern: a pinhole camera raster (what the
        # wave actually shoots — pixel-tile-coherent blocks), not the
        # one-eye/random-target cone of "camera" below
        w = int(np.sqrt(N))
        eye = np.asarray([5.0, 7.0, -4.0], np.float32)
        look = np.asarray([5.0, 0.0, 5.0], np.float32)
        fwd = look - eye
        fwd /= np.linalg.norm(fwd)
        right = np.cross(fwd, [0, 1, 0]).astype(np.float32)
        right /= np.linalg.norm(right)
        up = np.cross(right, fwd)
        ys, xs = np.meshgrid(np.arange(w), np.arange(w), indexing="ij")
        u = (xs.reshape(-1)[:N] + 0.5) / w - 0.5
        v = (ys.reshape(-1)[:N] + 0.5) / w - 0.5
        d = fwd[None] + 1.2 * u[:, None] * right[None] \
            + 1.2 * v[:, None] * up[None]
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        return np.broadcast_to(eye, (N, 3)).copy(), d.astype(np.float32)
    if kind == "camera":
        eye = np.asarray([5.0, 6.0, -3.0], np.float32)
        tx = rng.uniform(0, 10, N)
        tz = rng.uniform(0, 10, N)
        tgt = np.stack([tx, np.zeros(N), tz], -1).astype(np.float32)
        d = tgt - eye
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        return np.broadcast_to(eye, (N, 3)).copy(), d.astype(np.float32)
    # bounce: origins on the surface, cosine-up directions
    ids = rng.integers(0, len(V), N)
    p = V[ids] + np.asarray([0, 1e-3, 0], np.float32)
    u = rng.random((N, 2)).astype(np.float32)
    r = np.sqrt(u[:, 0])
    ph = 2 * np.pi * u[:, 1]
    d = np.stack([r * np.cos(ph),
                  np.sqrt(np.maximum(1 - u[:, 0], 0)),
                  r * np.sin(ph)], -1).astype(np.float32)
    return p.astype(np.float32), d


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=708)
    args = ap.parse_args()
    import numpy as np
    import jax
    import jax.numpy as jnp
    from pbrt_jax import scene_core as sc
    from pbrt_jax.utils.compile_cache import setup_compile_cache
    setup_compile_cache()

    print("backend:", jax.default_backend(), flush=True)
    V, F = make_terrain(args.n)
    print(f"tris: {len(F)}", flush=True)
    t0 = time.time()
    b = sc.SceneBuilder()
    b.add_mesh(V, F, b.materials.add_diffuse((0.5, 0.5, 0.5)))
    scene = b.build()
    print(f"scene build: {time.time()-t0:.1f}s, route {scene.traversal}",
          flush=True)

    N = 1 << 20
    for kind in ("raster", "camera", "bounce"):
        o, d = gen_rays(V, kind, N)
        oj, dj = jnp.asarray(o), jnp.asarray(d)
        tm = jnp.full((N,), 1e30, jnp.float32)
        fn = jax.jit(lambda o, d, tm: sc.intersect(scene, o, d, tm)["t"])
        out = fn(oj, dj, tm)
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        reps = 3
        for _ in range(reps):
            out = fn(oj, dj, tm)
        jax.block_until_ready(out)
        ms = (time.perf_counter() - t0) / reps * 1e3
        hitfrac = float(jnp.mean(jnp.isfinite(out)))
        print(f"1M-tri closest ({kind}): {ms:8.2f} ms "
              f"{N/ms/1e3:.2f} Mray/s (hit {hitfrac:.2f})", flush=True)


if __name__ == "__main__":
    main()
