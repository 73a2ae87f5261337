"""Crash-context reporting.

Role model: the reference's ``CheckCallbackScope`` (util/check.h:~100):
subsystems register context callbacks; on a fatal error the handlers run
and their output is printed with the failure, including the
``--debugstart`` hint that lets a crashing render resume near the failing
work item (wavefront/integrator.cpp:287-292).
"""
from __future__ import annotations

import sys
import traceback

_CALLBACKS = []      # list of (name, fn) -> str
_INSTALLED = False


class CheckCallbackScope:
    """Register a crash-context callback for the dynamic extent of a scope.

    with CheckCallbackScope("render", lambda: f"wave {wave}/{n}"): ...
    """

    def __init__(self, name, fn):
        self.entry = (name, fn)

    def __enter__(self):
        _CALLBACKS.append(self.entry)
        return self

    def __exit__(self, *exc):
        try:
            _CALLBACKS.remove(self.entry)
        except ValueError:
            pass
        return False


def crash_context() -> str:
    """Render all registered context callbacks (newest first)."""
    lines = []
    for name, fn in reversed(_CALLBACKS):
        try:
            lines.append(f"  [{name}] {fn()}")
        except Exception as e:  # a context callback must never crash the crash
            lines.append(f"  [{name}] <context callback failed: {e}>")
    return "\n".join(lines)


def install_crash_handler():
    """Install an excepthook that prints the registered crash context before
    the traceback (plus faulthandler for hard faults)."""
    global _INSTALLED
    if _INSTALLED:
        return
    _INSTALLED = True
    try:
        import faulthandler
        faulthandler.enable()
    except Exception:
        pass
    prev = sys.excepthook

    def hook(exc_type, exc, tb):
        ctx = crash_context()
        if ctx:
            print("pbrt_jax crash context:", file=sys.stderr)
            print(ctx, file=sys.stderr)
        prev(exc_type, exc, tb)

    sys.excepthook = hook
