"""Per-ray BVH traversal on NVIDIA GPUs: a CUDA kernel (bvh_traverse.cu)
called through jax.ffi.

The kernel gives each ray its own thread and stack and runs the algorithm
of ops/bvh.py `bvh_intersect_triangles` to that ray's own end, where the
XLA while-loop steps the whole wave until its deepest ray finishes. It
reads the BVH node rows as ops/bvh.py packs them and the leaf-ordered
triangle rows padded from 10 to 12 columns (three aligned float4 loads).

The library is compiled with nvcc for sm_90a from the source beside this
file into `_build/` at first use. A failed build raises BuildError; there
is no fallback. `reference_call` is the same contract in plain JAX (the
XLA loop on the packed layouts), so the wrapper is testable without a GPU.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp

_SRC = Path(__file__).resolve().with_name("bvh_traverse.cu")
_BUILD = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC")
TRI_COLS = 12
_TARGETS = {False: "pbrt_bvh_closest_hit", True: "pbrt_bvh_any_hit"}
_SYMBOLS = {False: "BvhClosestHit", True: "BvhAnyHit"}
_registered = False


class BuildError(RuntimeError):
    """The CUDA traversal library could not be built or loaded."""


def find_nvcc() -> str | None:
    """$NVCC, else nvcc on PATH, else the CUDA toolkit's default path."""
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).is_file():
            return cand
    return None


def library_path() -> Path:
    """Build (if not already built) and return the kernel library. The file
    name carries a hash of the source and flags, so an edit rebuilds."""
    key = hashlib.sha256(_SRC.read_bytes() + " ".join(NVCC_FLAGS).encode())
    so = _BUILD / f"libbvh_traverse_{key.hexdigest()[:16]}.so"
    if so.exists():
        return so
    nvcc = find_nvcc()
    if nvcc is None:
        raise BuildError("nvcc not found: set NVCC or install the CUDA "
                         "toolkit to build the GPU traversal kernel")
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-I", jax.ffi.include_dir(), "-o", str(tmp),
           str(_SRC)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=600)
    except OSError as e:
        raise BuildError(f"could not run {nvcc}: {e}") from e
    if proc.returncode != 0:
        raise BuildError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    tmp.rename(so)
    return so


def ensure_registered():
    """Build the library and register its two FFI targets (once)."""
    global _registered
    if _registered:
        return
    try:
        lib = ctypes.cdll.LoadLibrary(str(library_path()))
    except OSError as e:
        raise BuildError(f"could not load the traversal library: {e}") from e
    for any_hit, name in _TARGETS.items():
        jax.ffi.register_ffi_target(
            name, jax.ffi.pycapsule(getattr(lib, _SYMBOLS[any_hit])),
            platform="CUDA")
    _registered = True


def pad_tris(tri_geo_ordered):
    """(T, 10) leaf-ordered triangle rows -> (T, 12) f32: two zero columns,
    so each row is three aligned float4 loads. Rows 12 wide pass as is."""
    t = jnp.asarray(tri_geo_ordered, jnp.float32)
    return jnp.pad(t, ((0, 0), (0, TRI_COLS - t.shape[1])))


def pack_rays(o, d, t_max):
    """(N, 3), (N, 3), (N,) or scalar -> (N, 8) rows [o, t_max, d, 0]."""
    n = o.shape[0]
    tm = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (n,))
    return jnp.concatenate([o.astype(jnp.float32), tm[:, None],
                            d.astype(jnp.float32),
                            jnp.zeros((n, 1), jnp.float32)], axis=1)


def _ffi_call(nodes, tris, rays, any_hit):
    n = rays.shape[0]
    call = jax.ffi.ffi_call(
        _TARGETS[bool(any_hit)],
        (jax.ShapeDtypeStruct((n, 4), jnp.float32),
         jax.ShapeDtypeStruct((n,), jnp.int32)))
    return call(nodes, tris, rays)


def reference_call(nodes, tris, rays, any_hit):
    """The kernel's contract in plain JAX: the ops/bvh.py XLA loop run on
    the packed layouts. Returns ((N, 4) [t, b0, b1, b2], (N,) prim)."""
    from . import bvh as bvh_mod
    r = bvh_mod.bvh_intersect_triangles(
        bvh_mod.BVH(nodes=nodes,
                    prim_indices=jnp.zeros((0,), jnp.int32)), tris[:, :10],
        rays[:, 0:3], rays[:, 4:7], rays[:, 3], any_hit=any_hit)
    return (jnp.stack([r["t"], r["b0"], r["b1"], r["b2"]], axis=1),
            r["prim"])


def intersect(nodes, tri_geo_ordered, o, d, t_max, any_hit=False,
              call=None):
    """Closest-hit (or any-hit) query, same result dict as
    ops/bvh.py bvh_intersect_triangles: hit, t (inf on a miss), prim
    (original triangle index, -1 on a miss), b0, b1, b2.

    call: the (nodes, tris, rays, any_hit) -> (hit4, prim) implementation;
    the CUDA kernel by default, `reference_call` in CPU tests."""
    if call is None:
        ensure_registered()
        call = _ffi_call
    rays = pack_rays(o, d, t_max)
    tris = pad_tris(tri_geo_ordered)
    h4, prim = call(jnp.asarray(nodes, jnp.float32), tris, rays,
                    bool(any_hit))
    hit = prim >= 0
    return dict(hit=hit, t=jnp.where(hit, h4[:, 0], jnp.inf), prim=prim,
                b0=h4[:, 1], b1=h4[:, 2], b2=h4[:, 3])
