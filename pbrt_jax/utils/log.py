"""Leveled logging (reference util/log.{h,cpp}: LOG_VERBOSE / LOG_ERROR /
LOG_FATAL macros with a --log-level flag and elapsed-time prefixes).

Build: a plain host-side logger — device code cannot log; anything
worth reporting from a wave comes back as arrays and is logged here.
"""
from __future__ import annotations

import os
import sys
import time

LOG_FATAL = 0
LOG_ERROR = 1
LOG_WARNING = 2
LOG_INFO = 3
LOG_VERBOSE = 4

_LEVEL_NAMES = {LOG_FATAL: "FATAL", LOG_ERROR: "ERROR", LOG_WARNING: "WARN",
                LOG_INFO: "INFO", LOG_VERBOSE: "VERBOSE"}
_NAME_LEVELS = {v.lower(): k for k, v in _LEVEL_NAMES.items()}
_NAME_LEVELS.update(warning=LOG_WARNING, information=LOG_INFO)

_state = {
    "level": LOG_WARNING,
    "t0": time.time(),
    "file": None,  # optional open file handle (--log-file)
}


def set_log_level(level):
    """level: int or name ('error', 'warning', 'info', 'verbose')."""
    if isinstance(level, str):
        level = _NAME_LEVELS[level.lower()]
    _state["level"] = int(level)


def get_log_level() -> int:
    return _state["level"]


def set_log_file(path):
    if _state["file"]:
        _state["file"].close()
    _state["file"] = open(path, "a") if path else None


def _emit(level, msg):
    if level > _state["level"]:
        return
    dt = time.time() - _state["t0"]
    line = f"[ {dt:9.3f}s {_LEVEL_NAMES[level]:7s} ] {msg}"
    out = _state["file"] or sys.stderr
    print(line, file=out, flush=True)


def verbose(msg, *args):
    _emit(LOG_VERBOSE, msg % args if args else msg)


def info(msg, *args):
    _emit(LOG_INFO, msg % args if args else msg)


def warning(msg, *args):
    _emit(LOG_WARNING, msg % args if args else msg)


def error(msg, *args):
    _emit(LOG_ERROR, msg % args if args else msg)


def fatal(msg, *args):
    """Log and abort (reference LOG_FATAL semantics)."""
    _emit(LOG_FATAL, msg % args if args else msg)
    raise SystemExit(1)


# honor PBRT_LOG_LEVEL for ad-hoc debugging without plumbing flags
if os.environ.get("PBRT_LOG_LEVEL"):
    try:
        set_log_level(os.environ["PBRT_LOG_LEVEL"])
    except KeyError:
        pass
