"""Host-side task parallelism.

Role model: the reference's CPU execution engine (util/parallel.h:263-440 —
``ThreadPool``, ``ParallelFor``, ``RunAsync`` futures) and its uses during
scene build: parallel ``Import`` parsing (parser.cpp:771-808), async
texture/media creation (scene.cpp:767-806), and parallel BVH construction
(aggregates.cpp:363-379).

The device compute path needs none of this (XLA owns the device), but the
HOST side — tokenizing included files, reading PLY meshes, running the
native C++ SAH builder per instance prototype — is ordinary blocking I/O
and GIL-releasing native code, which a shared thread pool overlaps."""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

_POOL = None


def pool() -> ThreadPoolExecutor:
    """Shared process-wide pool (reference: the singleton ThreadPool created
    by ParallelInit, parallel.cpp:49)."""
    global _POOL
    if _POOL is None:
        _POOL = ThreadPoolExecutor(
            max_workers=max(os.cpu_count() or 1, 2),
            thread_name_prefix="pbrt-host")
    return _POOL


def run_async(fn, *args, **kwargs):
    """Submit a job; returns a Future (reference RunAsync, parallel.h:440)."""
    return pool().submit(fn, *args, **kwargs)


def parallel_map(fn, items):
    """Map over items on the pool, preserving order (ParallelFor role).
    Falls back to serial for 0/1 items."""
    items = list(items)
    if len(items) <= 1:
        return [fn(x) for x in items]
    return list(pool().map(fn, items))
