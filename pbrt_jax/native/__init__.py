"""Native (C++) runtime components, loaded via ctypes with pure-Python
fallbacks: the SAH BVH builder and the .pbrt tokenizer (the reference's
C++ runtime pieces that sit outside the XLA compute path)."""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np

_DIR = Path(__file__).resolve().parent
_BUILD = _DIR / "_build"
_lib = None
_tried = False


def _compile() -> Path | None:
    _BUILD.mkdir(exist_ok=True)
    so = _BUILD / "libpbrt_native.so"
    srcs = [_DIR / "bvh_builder.cpp", _DIR / "tokenizer.cpp"]
    newest = max(s.stat().st_mtime for s in srcs)
    if so.exists() and so.stat().st_mtime > newest:
        return so
    # link to a temp path + rename: a process that already dlopen'd the old
    # library keeps its mapping (the old inode) instead of seeing the file
    # rewritten underneath it
    tmp = so.with_suffix(".so.tmp")
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC",
           "-o", str(tmp)] + [str(s) for s in srcs]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        tmp.rename(so)
        return so
    except Exception as e:  # pragma: no cover - toolchain missing
        print(f"pbrt_jax: native build failed ({e}); using Python fallbacks",
              file=sys.stderr)
        return None


def get_lib():
    global _lib, _tried
    if _lib is None and not _tried:
        _tried = True
        so = _compile()
        if so is not None:
            lib = ctypes.CDLL(str(so))
            lib.build_bvh.restype = ctypes.c_int
            lib.build_bvh.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
                ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
            lib.tokenize.restype = ctypes.c_long
            lib.tokenize.argtypes = [
                ctypes.c_char_p, ctypes.c_long, ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_double), ctypes.c_long]
            _lib = lib
    return _lib


def build_bvh_native(prim_lo: np.ndarray, prim_hi: np.ndarray, max_leaf=4):
    """Returns (packed_nodes (M,8) f32, order (P,) i32) or None if no lib."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(prim_lo)
    lo = np.ascontiguousarray(prim_lo, np.float32)
    hi = np.ascontiguousarray(prim_hi, np.float32)
    nodes = np.zeros((2 * n + 2, 8), np.float32)
    order = np.zeros(n, np.int32)
    n_nodes = ctypes.c_int(0)
    rc = lib.build_bvh(
        lo.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        hi.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n, max_leaf,
        nodes.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        order.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        ctypes.byref(n_nodes))
    if rc != 0:
        return None
    return nodes[:n_nodes.value].copy(), order


def tokenize_native(text: bytes, with_offsets=False):
    """Returns the parser's token list (str | float), or with_offsets=True
    the pair (tokens, byte_offsets) for FileLoc diagnostics. None if the
    native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(text)
    max_tokens = max(n // 2 + 16, 64)
    types = np.zeros(max_tokens, np.int32)
    offsets = np.zeros(max_tokens, np.int64)
    lengths = np.zeros(max_tokens, np.int32)
    numbers = np.zeros(max_tokens, np.float64)
    count = lib.tokenize(
        text, n,
        types.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        numbers.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        max_tokens)
    if count < 0:
        return None
    out = []
    for i in range(count):
        t = types[i]
        if t == 4:
            out.append(float(numbers[i]))
        elif t == 1:
            out.append('"' + text[offsets[i]:offsets[i] + lengths[i]].decode() + '"')
        elif t == 2:
            out.append("[")
        elif t == 3:
            out.append("]")
        else:
            out.append(text[offsets[i]:offsets[i] + lengths[i]].decode())
    if with_offsets:
        return out, offsets[:count].tolist()
    return out
